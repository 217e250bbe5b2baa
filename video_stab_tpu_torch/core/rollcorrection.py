"""Roll correction — port of ``video_stab_tpu/core/rollcorrection.py``.

Per frame: quarter-scale gray -> Canny -> Hough lines in the acceptance
band around horizontal -> mean line angle -> exponential smoothing with a
per-frame change clamp and decay toward zero. The angle is an explicit
``RollState`` (a 0-d device tensor), so nothing reads it back per frame.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from video_stab_tpu_torch.core.params import RollCorrectionParams
from video_stab_tpu_torch.ops.canny import canny_edges
from video_stab_tpu_torch.ops.color import bgr_to_gray
from video_stab_tpu_torch.ops.hough import hough_lines
from video_stab_tpu_torch.ops.resize import resize_bilinear


class RollState(NamedTuple):
    smoothed_angle: torch.Tensor   # float32 degrees, 0-d


def roll_state_init(device: torch.device) -> RollState:
    return RollState(smoothed_angle=torch.zeros((), dtype=torch.float32,
                                                device=device))


def estimate_roll_angle(params: RollCorrectionParams, state: RollState,
                        frame_f32: torch.Tensor) -> RollState:
    """Angle estimation + smoothing. ``frame_f32`` is the (H, W, 3) BGR
    float frame or its (H, W) gray. Returns the updated state; the caller
    rotates by ``state.smoothed_angle``."""
    h, w = frame_f32.shape[:2]
    sh = max(int(h * params.scale_factor), 1)
    sw = max(int(w * params.scale_factor), 1)
    gray = frame_f32 if frame_f32.dim() == 2 else bgr_to_gray(frame_f32)
    gray = resize_bilinear(gray, sh, sw)
    edges = canny_edges(gray, params.canny_threshold_low,
                        params.canny_threshold_high)
    lines, _votes, mask = hough_lines(
        edges, rho=params.hough_rho,
        theta=math.radians(params.hough_theta_deg),
        threshold=params.hough_threshold,
        max_lines=params.max_lines,
        theta_range=(math.radians(90.0 + params.angle_filter_min),
                     math.radians(90.0 + params.angle_filter_max)))

    # theta -> degrees around horizontal.
    angles = lines[:, 1] * (180.0 / math.pi) - 90.0
    keep = mask & (angles >= params.angle_filter_min) & \
        (angles <= params.angle_filter_max)
    count = keep.to(torch.float32).sum()
    detected = torch.where(keep, angles, torch.zeros_like(angles)).sum() \
        / torch.clamp(count, min=1.0)

    prev = state.smoothed_angle
    new_angle = params.angle_smoothing_alpha * detected + \
        (1.0 - params.angle_smoothing_alpha) * prev
    diff = new_angle - prev
    clamp = params.max_angle_change
    if clamp > 0.0:
        diff = torch.clamp(diff, -clamp, clamp)
    smoothed = torch.where(count > 0, prev + diff, prev * params.angle_decay)
    return RollState(smoothed_angle=smoothed.to(torch.float32))
