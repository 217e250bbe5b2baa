"""Roll correction — port of ``video_stab_tpu/core/rollcorrection.py``.

Per frame: quarter-scale gray -> Canny -> Hough lines in the acceptance
band around horizontal -> mean line angle -> exponential smoothing with a
per-frame change clamp and decay toward zero. The angle is an explicit
``RollState`` (a 0-d device tensor), so nothing reads it back per frame.
``roll_correct_step`` then rotates the frame by it through K1.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from video_stab_tpu_torch import pick_device
from video_stab_tpu_torch.core.params import RollCorrectionParams
from video_stab_tpu_torch.kernels.warp import warp_affine_u8
from video_stab_tpu_torch.ops.canny import canny_edges
from video_stab_tpu_torch.ops.color import bgr_to_gray
from video_stab_tpu_torch.ops.hough import hough_lines
from video_stab_tpu_torch.ops.resize import resize_bilinear
from video_stab_tpu_torch.ops.warp import BORDER_REPLICATE, rotation_matrix_2d
from video_stab_tpu_torch.utils import hostcopy


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


def roll_correct_step(params: RollCorrectionParams, state: RollState,
                      frame_u8: torch.Tensor
                      ) -> tuple[RollState, torch.Tensor]:
    """Estimate the roll angle of a (H, W, 3) u8 frame and rotate the frame
    about its centre by it (K1, BORDER_REPLICATE), u8 out.

    K1 is exact for any angle; the JAX package's tiled warp is exact
    inside its envelope (the acceptance band, at most 15 deg) and clamps
    beyond it, so the two agree wherever the JAX warp is exact."""
    state = estimate_roll_angle(params, state, bgr_to_gray(frame_u8.float()))
    h, w = frame_u8.shape[:2]
    rot = rotation_matrix_2d(w / 2.0, h / 2.0, state.smoothed_angle)
    return state, warp_affine_u8(frame_u8, rot, border_mode=BORDER_REPLICATE)


class RollCorrection:
    """Streaming wrapper: ``auto_correct_roll(frame)`` mirrors the
    reference's static API with the angle as per-instance state.

    ``device``: where frames are processed (None: CUDA, raising without a
    card)."""

    def __init__(self, params: Optional[RollCorrectionParams] = None, *,
                 device=None, **kw):
        if params is None:
            params = RollCorrectionParams(**kw)
        elif kw:
            raise ValueError("pass either params or keyword overrides")
        self.params = params
        self.device = pick_device(True) if device is None \
            else torch.device(device)
        self._state = roll_state_init(self.device)

    @property
    def smoothed_angle(self) -> float:
        """The smoothed angle in degrees (a host read)."""
        return float(self._state.smoothed_angle)

    def auto_correct_roll(self, frame) -> np.ndarray:
        self._state, out = roll_correct_step(
            self.params, self._state, hostcopy.to_device(frame, self.device))
        return hostcopy.to_host(out)

    def reset(self) -> None:
        self._state = roll_state_init(self.device)
