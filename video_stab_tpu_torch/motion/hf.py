"""Drone high-frequency vibration suppression chain — port of
``video_stab_tpu/motion/hf.py``.

Applied to each raw similarity transform (dx, dy, da), in the reference's
order: dead-zone freeze -> micro-shake suppression -> rotation low-pass ->
translation-history update. The state is an explicit tuple of device
tensors; every decision is a ``torch.where`` on 0-d tensors, so the chain
reads nothing back from the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

HF_HISTORY = 10  # sliding window of the translation history


class HFState(NamedTuple):
    trans_history: torch.Tensor       # (HF_HISTORY, 2) ring of translations
    n_history: torch.Tensor           # int32 count of pushes
    median_translation: torch.Tensor  # (2,) current median reference
    rotation_lp: torch.Tensor         # f32 low-pass filtered rotation
    in_dead_zone: torch.Tensor        # bool
    freeze_counter: torch.Tensor      # int32
    motion_accumulator: torch.Tensor  # f32


def hf_init(device) -> HFState:
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return HFState(trans_history=z(HF_HISTORY, 2),
                   n_history=z(dtype=torch.int32),
                   median_translation=z(2),
                   rotation_lp=z(),
                   in_dead_zone=z(dtype=torch.bool),
                   freeze_counter=z(dtype=torch.int32),
                   motion_accumulator=z())


def _hf_magnitude(t: torch.Tensor) -> torch.Tensor:
    """sqrt(dx^2 + dy^2 + 100 da^2)."""
    return torch.sqrt(t[0] ** 2 + t[1] ** 2 + t[2] ** 2 * 100.0)


def _median_even_avg(vals: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Median of the first n entries of ``vals`` (K, ...), along dim 0:
    sorted[mid] for odd n, (sorted[mid-1] + sorted[mid]) / 2 for even n."""
    k = vals.shape[0]
    live = torch.arange(k, device=vals.device) < n
    live = live.reshape(k, *([1] * (vals.dim() - 1)))
    s = torch.sort(torch.where(live, vals, torch.inf), dim=0).values
    mid = torch.div(n, 2, rounding_mode="floor").to(torch.int64)
    lo = s.index_select(0, (mid - 1).clamp(0, k - 1).reshape(1))[0]
    hi = s.index_select(0, mid.clamp(0, k - 1).reshape(1))[0]
    return torch.where(torch.remainder(n, 2) == 0, 0.5 * (lo + hi), hi)


def hf_apply(state: HFState, raw: torch.Tensor, *,
             dead_zone_threshold: float, freeze_duration: int,
             accumulator_decay: float, shake_px: float,
             rot_lp_alpha: float, horizon_lock: bool,
             ) -> tuple[HFState, torch.Tensor]:
    """Run the whole chain on one raw (dx, dy, da) transform."""
    # 1. Dead-zone freeze.
    mag = _hf_magnitude(raw)
    accum = torch.maximum(state.motion_accumulator * accumulator_decay, mag)
    accum = torch.clamp(torch.clamp(accum, max=dead_zone_threshold * 5.0),
                        0.0, 100.0)

    entering = (~state.in_dead_zone) & (mag < dead_zone_threshold)
    in_dz = state.in_dead_zone | entering
    counter = torch.where(entering,
                          torch.full_like(state.freeze_counter,
                                          freeze_duration),
                          state.freeze_counter)
    counter_after = counter - 1
    exiting = in_dz & ((counter_after <= 0)
                       | (mag > dead_zone_threshold * 1.5)
                       | (accum > dead_zone_threshold * 1.2))
    stay_frozen = in_dz & ~exiting
    t = torch.where(stay_frozen, torch.zeros_like(raw), raw)

    zero_i = torch.zeros_like(counter)
    new_counter = torch.where(exiting, zero_i,
                              torch.where(in_dz, counter_after, counter))
    new_accum = torch.where(exiting, torch.zeros_like(accum), accum)

    # 2. Micro-shake suppression against the history's median.
    n_live = torch.clamp(state.n_history, max=HF_HISTORY)
    median = torch.where(state.n_history >= 5,
                         _median_even_avg(state.trans_history, n_live),
                         state.median_translation)
    dev = t[:2] - median
    dev_mag = torch.sqrt(dev[0] ** 2 + dev[1] ** 2)
    one = torch.ones_like(dev_mag)
    residual_scale = torch.where(
        dev_mag < shake_px, 0.01 * one,
        torch.where(dev_mag < shake_px * 2.0, 0.05 * one, one))
    suppressed_xy = torch.where(residual_scale < 1.0,
                                median + dev * residual_scale, t[:2])

    # 3. Rotation low-pass under the horizon lock.
    if horizon_lock:
        rot_lp = (1.0 - rot_lp_alpha) * state.rotation_lp \
            + rot_lp_alpha * t[2]
        rot = rot_lp
    else:
        rot_lp = state.rotation_lp
        rot = t[2]
    t = torch.cat([suppressed_xy, rot.reshape(1)])

    # 4. Translation history update.
    slot = torch.remainder(state.n_history, HF_HISTORY).to(torch.int64)
    hist = state.trans_history.index_copy(0, slot.reshape(1),
                                          t[:2].reshape(1, 2))
    return HFState(trans_history=hist,
                   n_history=state.n_history + 1,
                   median_translation=median,
                   rotation_lp=rot_lp,
                   in_dead_zone=stay_frozen,
                   freeze_counter=new_counter,
                   motion_accumulator=new_accum), t
