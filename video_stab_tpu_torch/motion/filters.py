"""Incremental O(window) trajectory filters over ring buffers.

Counterpart of the slice's part of ``video_stab_tpu/motion/filters.py``:
the ring ops, the box-filter emission and the adaptive radius. Absolute
index i lives at slot i % RING. Indices are 0-d device tensors and every
read and write is an ``index_select``/``index_copy``, so no step reads a
device value on the host. The gaussian, kalman and butterworth emitters
are not ported yet.
"""

from __future__ import annotations

import torch


def ring_push(ring: torch.Tensor, n: torch.Tensor, value: torch.Tensor
              ) -> torch.Tensor:
    """A copy of ring with ``value`` stored for absolute index n."""
    slot = torch.remainder(n, ring.shape[0]).to(torch.int64).reshape(1)
    return ring.index_copy(0, slot, value.reshape(1, *ring.shape[1:])
                           .to(ring.dtype))


def ring_get(ring: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Entries at absolute indices idx (any shape; caller guarantees
    idx >= n - RING)."""
    slots = torch.remainder(idx, ring.shape[0]).to(torch.int64)
    return ring.index_select(0, slots.reshape(-1)).reshape(
        *slots.shape, *ring.shape[1:])


def box_filter_emit(ring: torch.Tensor, n_path: torch.Tensor,
                    emit_idx: torch.Tensor, radius: torch.Tensor,
                    r_max: int) -> torch.Tensor:
    """Emitted value of the reference box filter at ``emit_idx``: the mean
    over [e - r, e + r] clamped to the path; identity when n <= r."""
    offs = torch.arange(-r_max, r_max + 1, device=ring.device)
    idx = emit_idx + offs
    valid = (offs.abs() <= radius) & (idx >= 0) & (idx <= n_path - 1)
    vals = ring_get(ring, idx.clamp(min=0))                   # (W, C)
    w = valid.to(ring.dtype)[:, None]
    mean = (vals * w).sum(dim=0) / torch.clamp(w.sum(), min=1.0)
    return torch.where(n_path <= radius, ring_get(ring, emit_idx), mean)


def adaptive_radius(ring: torch.Tensor, n_path: torch.Tensor,
                    default_radius: int) -> torch.Tensor:
    """calculateAdaptiveRadius: variance of the last <= 20 path samples,
    rotation variance scaled by 1000, radius = int(clamp(2*sqrt(var), 5,
    25)); ``default_radius`` when fewer than 10 samples.

    A 3-channel ring holds (dx, dy, da). A 9-channel ring holds the
    row-major sl(3) log-homography: translation is read from [2] and [5],
    rotation from the antisymmetric part of the upper 2x2, (l01 - l10)/2."""
    window = 20
    offs = torch.arange(window, device=ring.device)
    start = torch.clamp(n_path - window, min=0)
    idx = start + offs
    valid = idx <= n_path - 1
    vals = ring_get(ring, idx.clamp(min=0))                   # (20, 3)
    w = valid.to(ring.dtype)[:, None]
    count = torch.clamp(w.sum(), min=1.0)
    mean = (vals * w).sum(dim=0) / count
    var = (((vals - mean) ** 2) * w).sum(dim=0) / count
    if ring.shape[1] == 9:
        rot = (vals[:, 1] - vals[:, 3]) * 0.5
        rot_mean = (rot * w[:, 0]).sum() / count
        rot_var = (((rot - rot_mean) ** 2) * w[:, 0]).sum() / count
        total = torch.sqrt(var[2] + var[5] + rot_var * 1000.0)
    else:
        total = torch.sqrt(var[0] + var[1] + var[2] * 1000.0)
    rad = torch.clamp(total * 2.0, 5.0, 25.0).to(torch.int32)
    return torch.where(n_path < 10,
                       torch.full_like(rad, default_radius), rad)
