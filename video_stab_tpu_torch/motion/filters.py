"""Incremental O(window) trajectory filters over ring buffers.

Counterpart of ``video_stab_tpu/motion/filters.py``: the ring ops, the
box and gaussian emissions, the kalman step, the butterworth cascade and
the adaptive radius, each channel-generic (C = 3 for the similarity path,
9 for the log-homography path). Absolute index i lives at slot i % RING.
Indices are 0-d device tensors and every read and write is an
``index_select``/``index_copy``, so no step reads a device value on the
host. The gaussian kernel is built on the host once per (sigma, device)
and kept on the device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
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


@functools.lru_cache(maxsize=64)
def _gaussian_kernel_on(sigma: float, device: torch.device) -> torch.Tensor:
    ksize = max(3, int(math.ceil(6 * sigma)))
    if ksize % 2 == 0:
        ksize += 1
    # float32 throughout, as the JAX package computes it.
    xs = np.arange(ksize, dtype=np.float32) - np.float32(ksize // 2)
    k = np.exp(-(xs * xs) / np.float32(2.0 * sigma * sigma))
    k = (k / k.sum(dtype=np.float32)).astype(np.float32)
    return torch.from_numpy(k).to(device)


def gaussian_kernel(sigma: float, device="cpu") -> torch.Tensor:
    """The reference's gaussian kernel: ksize = max(3, ceil(6 sigma)), made
    odd; exp(-x^2 / (2 sigma^2)) normalized to sum 1. Built on the host and
    cached on ``device`` per (sigma, device); treat it as read-only."""
    return _gaussian_kernel_on(float(sigma), torch.device(device))


def gaussian_filter_emit(ring: torch.Tensor, n_path: torch.Tensor,
                         emit_idx: torch.Tensor, kernel: torch.Tensor
                         ) -> torch.Tensor:
    """Emitted value of the reference gaussian smoother at ``emit_idx``:
    reflect-101 on the left (path[-m] -> path[m]) and reflect-with-edge on
    the right (path[n-1+m] -> path[n-m])."""
    ksize = kernel.shape[0]
    offs = torch.arange(ksize, device=ring.device) - ksize // 2
    idx = emit_idx + offs
    idx = torch.where(idx < 0, -idx, idx)
    idx = torch.where(idx > n_path - 1, 2 * n_path - 1 - idx, idx)
    vals = ring_get(ring, idx.clamp(min=0))                   # (K, C)
    return (vals * kernel[:, None]).sum(dim=0)


def kalman_init(z0: torch.Tensor) -> dict:
    """Per-axis 2-state (position, velocity) filter state for C axes from
    the first path sample z0 (C,): x (2, C), p (2, 2, C) zero."""
    return {"x": torch.stack([z0, torch.zeros_like(z0)]),
            "p": z0.new_zeros((2, 2, z0.shape[0]))}


def kalman_step(state: dict, z: torch.Tensor, q: float = 0.01,
                r: float = 0.1) -> tuple[dict, torch.Tensor]:
    """One predict (F = [[1, 1], [0, 1]]) and correct (H = [1, 0]) step;
    returns the new state and the filtered positions (C,)."""
    x, p = state["x"], state["p"]
    xp0 = x[0] + x[1]
    p00 = p[0, 0] + p[1, 0] + p[0, 1] + p[1, 1] + q
    p01 = p[0, 1] + p[1, 1]
    p10 = p[1, 0] + p[1, 1]
    p11 = p[1, 1] + q
    s = p00 + r
    k0 = p00 / s
    k1 = p10 / s
    innov = z - xp0
    xn = torch.stack([xp0 + k0 * innov, x[1] + k1 * innov])
    pn = torch.stack([torch.stack([(1.0 - k0) * p00, (1.0 - k0) * p01]),
                      torch.stack([p10 - k1 * p00, p11 - k1 * p01])])
    return {"x": xn, "p": pn}, xn[0]


def jitter_frequency_cutoff(jitter_frequency: str) -> float:
    """mapJitterFrequencyToCutoff: the ``jitter_frequency`` parameter's
    normalized butterworth cutoff, shared by the streaming emission and the
    offline whole-path smoother."""
    return {"low": 0.05, "medium": 0.1, "high": 0.25,
            "adaptive": 0.15}.get(jitter_frequency, 0.1)


def butterworth_cascade(state: torch.Tensor, z: torch.Tensor, cutoff: float,
                        order: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``order`` chained first-order IIRs y = a x + (1 - a) y_prev, a =
    cutoff / (cutoff + 1). state: (order, C) previous outputs per stage; z:
    (C,) the new sample. Returns (new state, the last stage's output)."""
    alpha = cutoff / (cutoff + 1.0)
    outs = []
    x = z
    for o in range(order):
        x = alpha * x + (1.0 - alpha) * state[o]
        outs.append(x)
    return torch.stack(outs), x


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
