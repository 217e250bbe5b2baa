"""Motion-intent classification and correction scaling.

Counterpart of ``video_stab_tpu/motion/intent.py`` (analyzeMotionIntent,
calculateAdaptiveStabilizationStrength and the per-intent correction
scaling at emission), as pure functions over the transform ring; for N
streams (the multi-stream step, ``parallel/``) over N rings (N, RING, 3)
with every other argument and result gaining a leading N.
"""

from __future__ import annotations

import enum
import math

import torch

from video_stab_tpu_torch.motion.filters import ring_get


class MotionIntent(enum.IntEnum):
    NORMAL = 0
    DELIBERATE_PAN = 1
    SHAKE_REMOVAL = 2
    FOLLOW_ACTION = 3


def _variance(vals: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    count = torch.clamp(w.sum(dim=-1), min=1.0)
    mean = (vals * w).sum(dim=-1) / count
    return (((vals - mean[..., None]) ** 2) * w).sum(dim=-1) / count


def _consistency(vals: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """1 / (1 + var/mean^2), clamped to [0,1]; 0 for mean == 0."""
    count = torch.clamp(w.sum(dim=-1), min=1.0)
    mean = (vals * w).sum(dim=-1) / count
    var = _variance(vals, w)
    nonzero = mean != 0.0
    safe = torch.where(nonzero, mean * mean, torch.ones_like(mean))
    c = 1.0 / (1.0 + var / safe)
    return torch.where(nonzero, torch.clamp(c, 0.0, 1.0),
                       torch.zeros_like(c))


def analyze_motion_intent(trans_ring: torch.Tensor,
                          n_transforms: torch.Tensor, motion: torch.Tensor,
                          frame_index: torch.Tensor) -> torch.Tensor:
    """Classify the emitted frame's motion; an int32 MotionIntent code.

    trans_ring: (RING, 3) raw transforms; n_transforms its length; motion:
    (3,) the emitted frame's raw transform; frame_index: emitted index."""
    mag = torch.sqrt(motion[..., 0] ** 2 + motion[..., 1] ** 2)
    ang_vel = torch.abs(motion[..., 2]) * 180.0 / math.pi * 30.0

    window = 15
    offs = torch.arange(window, device=trans_ring.device)
    start = torch.clamp(frame_index - window, min=0)
    idx = start[..., None] + offs
    valid = (idx < frame_index[..., None]) & (idx < n_transforms[..., None])
    t = ring_get(trans_ring, idx.clamp(min=0))               # (15, 3)
    w = valid.to(trans_ring.dtype)
    mags = torch.sqrt(t[..., 0] ** 2 + t[..., 1] ** 2)
    dirs = torch.atan2(t[..., 1], t[..., 0])

    any_recent = w.sum(dim=-1) > 0
    dir_var = _variance(dirs, w)
    mag_cons = _consistency(mags, w)

    is_pan = (dir_var < 0.5) & (mag_cons > 0.7) & (mag > 5.0)
    is_shake = (mag < 3.0) & (mag_cons < 0.3) & (ang_vel > 10.0)
    is_follow = (mag > 3.0) & (mag < 15.0) & (dir_var > 0.5)

    def code(c):
        return torch.full((), int(c), dtype=torch.int32,
                          device=trans_ring.device)

    intent = torch.where(
        is_pan, code(MotionIntent.DELIBERATE_PAN),
        torch.where(is_shake, code(MotionIntent.SHAKE_REMOVAL),
                    torch.where(is_follow, code(MotionIntent.FOLLOW_ACTION),
                                code(MotionIntent.NORMAL))))
    enabled = (n_transforms >= 15) & any_recent
    return torch.where(enabled, intent, code(MotionIntent.NORMAL))


def intent_correction_scale(intent: torch.Tensor, motion: torch.Tensor,
                            frame_index: torch.Tensor) -> torch.Tensor:
    """The diff multiplier applied at emission: PAN 0.5, SHAKE 1.0, FOLLOW
    0.8, NORMAL 0.7; 1.0 when frame_index == 0."""
    del motion
    dev = intent.device

    def f(v):
        return torch.full((), v, dtype=torch.float32, device=dev)

    scale = torch.where(
        intent == MotionIntent.DELIBERATE_PAN, f(0.5),
        torch.where(intent == MotionIntent.SHAKE_REMOVAL, f(1.0),
                    torch.where(intent == MotionIntent.FOLLOW_ACTION, f(0.8),
                                f(0.7))))
    return torch.where(frame_index > 0, scale, f(1.0))
