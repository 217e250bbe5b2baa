"""Frame-to-frame motion estimation over masked fixed-capacity point sets.

Counterpart of ``video_stab_tpu/motion/estimate.py:estimate_similarity_ransac``:
RANSAC over 4-DOF similarity models, every hypothesis scored in parallel,
then a closed-form least-squares refit on the best inlier set.

The hypotheses' draws cannot be JAX's (``jax.random.randint`` on the
stream key has no torch counterpart). By default they come from a
``torch.Generator`` on the points' device; a caller that must reproduce the
JAX package's estimates passes JAX's own draws as ``draws``.

N streams estimate at once on (N, P, 2) point sets with (N, K, 2) draws
(the multi-stream step, ``parallel/``): every op then runs once for the
batch. Each stream draws from its own generator, as a single stream with
that generator would (``ransac_draws_streams``): N small ``torch.rand``
launches a step, since a torch generator draws for one tensor at a time.

The legacy stabilizer's deterministic solver (``remove_outliers_median``,
``estimate_rigid_closed_form``) is here too, bit for bit with the JAX
package's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _similarity_from_two(p1, p2, q1, q2):
    """Exact similarity from two correspondences via complex ratio
    (batched over the leading axis)."""
    dp = p2 - p1
    dq = q2 - q1
    denom = dp[..., 0] * dp[..., 0] + dp[..., 1] * dp[..., 1]
    ok = denom > 1e-6
    safe = torch.where(ok, denom, torch.ones_like(denom))
    a = (dq[..., 0] * dp[..., 0] + dq[..., 1] * dp[..., 1]) / safe
    b = (dq[..., 1] * dp[..., 0] - dq[..., 0] * dp[..., 1]) / safe
    tx = q1[..., 0] - (a * p1[..., 0] - b * p1[..., 1])
    ty = q1[..., 1] - (b * p1[..., 0] + a * p1[..., 1])
    return torch.stack([a, b, tx, ty], dim=-1), ok


def _similarity_lsq(prev: torch.Tensor, curr: torch.Tensor, w: torch.Tensor):
    """Weighted least-squares similarity fit (global optimum for 4-DOF),
    batched over the leading axes of (..., P, 2) points."""
    n = w.sum(dim=-1)
    ok = n >= 2.0
    safe_n = torch.where(ok, n, torch.ones_like(n))[..., None]
    pm = (prev * w[..., None]).sum(dim=-2) / safe_n
    qm = (curr * w[..., None]).sum(dim=-2) / safe_n
    pc = (prev - pm[..., None, :]) * w[..., None]
    qc = curr - qm[..., None, :]
    dot = (pc[..., 0] * qc[..., 0] + pc[..., 1] * qc[..., 1]).sum(dim=-1)
    cross = (pc[..., 0] * qc[..., 1] - pc[..., 1] * qc[..., 0]).sum(dim=-1)
    norm = ((prev - pm[..., None, :]) ** 2 * w[..., None]).sum(dim=(-2, -1))
    big = norm > 1e-9
    safe_norm = torch.where(big, norm, torch.ones_like(norm))
    a = torch.where(big, dot / safe_norm, torch.ones_like(dot))
    b = torch.where(big, cross / safe_norm, torch.zeros_like(cross))
    tx = qm[..., 0] - (a * pm[..., 0] - b * pm[..., 1])
    ty = qm[..., 1] - (b * pm[..., 0] + a * pm[..., 1])
    return torch.stack([a, b, tx, ty], dim=-1), ok


def _params_to_matrix(theta: torch.Tensor) -> torch.Tensor:
    a, b, tx, ty = theta.unbind(dim=-1)
    return torch.stack([torch.stack([a, -b, tx], dim=-1),
                        torch.stack([b, a, ty], dim=-1)], dim=-2)


def ransac_draws(generator: torch.Generator, n_hypotheses: int,
                 n_valid: torch.Tensor, width: int = 2) -> torch.Tensor:
    """(K, width) uniform draws in [0, max(n_valid, 1)) on the generator's
    device: floor(U * max(n_valid, 1)), no host read. ``width`` is the
    minimal sample: 2 points for the similarity model, 4 for the
    homography model."""
    u = torch.rand((n_hypotheses, width), generator=generator,
                   device=n_valid.device)
    hi = torch.clamp(n_valid, min=1).to(torch.float32)
    return torch.floor(u * hi).to(torch.int64).clamp(max=hi.to(torch.int64) - 1)


def ransac_draws_streams(generators, n_hypotheses: int, n_valid: torch.Tensor,
                         width: int = 2) -> torch.Tensor:
    """(N, K, width) draws for N streams, stream i's from ``generators[i]``
    with its ``n_valid[i]``: exactly what ``ransac_draws`` gives a single
    stream with that generator. One ``torch.rand`` per stream (a
    generator draws for one tensor at a time), then one floor for all."""
    u = torch.stack([torch.rand((n_hypotheses, width), generator=g,
                                device=n_valid.device) for g in generators])
    hi = torch.clamp(n_valid, min=1).to(torch.float32)[:, None, None]
    return torch.floor(u * hi).to(torch.int64).clamp(max=hi.to(torch.int64) - 1)


def estimate_similarity_ransac(
    prev: torch.Tensor, curr: torch.Tensor, mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    threshold: float = 5.0, n_hypotheses: int = 500,
    draws: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RANSAC 4-DOF similarity estimate (estimateAffinePartial2D semantics).

    Args:
      prev/curr: (N, 2) float32 point sets, (x, y).
      mask: (N,) bool validity.
      generator: the stream's generator for the hypotheses' draws.
      draws: optional (K, 2) int64 draws in [0, max(n_valid, 1)) to use
        instead — JAX's ``jax.random.randint(key, (K, 2), 0,
        max(n_valid, 1))``, for parity with the JAX package.

    Every argument may carry a leading stream axis S, as every result then
    does: (S, N, 2) points, (S, N) masks, (S, K, 2) draws (``generator``
    a sequence of S generators).

    Returns:
      m: (2, 3) float32 transform (identity when under 4 valid points).
      ok: scalar bool — estimate valid.
      inliers: (N,) bool inlier mask of the final model.
    """
    n_valid = mask.to(torch.int32).sum(dim=-1)
    # Compact valid indices to the front so uniform sampling hits valid points.
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    if draws is None:
        if generator is None:
            raise ValueError("pass a generator or the draws")
        draws = ransac_draws(generator, n_hypotheses, n_valid) \
            if mask.dim() == 1 else \
            ransac_draws_streams(generator, n_hypotheses, n_valid)
    st = mask.dim() - 1                           # stream axes
    draws = draws.to(device=order.device, dtype=torch.int64)
    samples = _take(order, draws, st)             # (..., K, 2)
    i, j = samples[..., 0], samples[..., 1]
    theta, ok = _similarity_from_two(_take(prev, i, st), _take(prev, j, st),
                                     _take(curr, i, st), _take(curr, j, st))
    ok = ok & (i != j)
    px, py = prev[..., None, :, 0], prev[..., None, :, 1]
    a, b = theta[..., 0:1], theta[..., 1:2]
    rx = a * px - b * py + theta[..., 2:3]
    ry = b * px + a * py + theta[..., 3:4]
    err2 = (rx - curr[..., None, :, 0]) ** 2 + (ry - curr[..., None, :, 1]) ** 2
    inl = mask[..., None, :] & (err2 < threshold * threshold)
    scores = torch.where(ok, inl.to(torch.int32).sum(dim=-1),
                         torch.full_like(n_valid[..., None], -1))
    # First maximum, as jnp.argmax.
    best = torch.argmax(scores, dim=-1, keepdim=True)
    best_inliers = _take(inl, best, st)[..., 0, :]

    theta, fit_ok = _similarity_lsq(prev, curr, best_inliers.to(torch.float32))
    enough = (n_valid >= 4) & (_take(scores, best, st)[..., 0] >= 2) & fit_ok
    eye = torch.eye(2, 3, dtype=torch.float32, device=prev.device)
    m = torch.where(enough[..., None, None], _params_to_matrix(theta), eye)
    return m, enough, best_inliers & enough[..., None]


def _take(x: torch.Tensor, idx: torch.Tensor, s: int) -> torch.Tensor:
    """``x[idx]`` along the axis after ``s`` stream axes, per stream: x
    (*S, P, *F) and int64 idx (*S, *I) -> (*S, *I, *F). With no stream
    axis a plain index."""
    if s == 0:
        return x[idx]
    feat = x.shape[s + 1:]
    flat = idx.reshape(*idx.shape[:s], -1)
    g = flat.reshape(*flat.shape, *([1] * len(feat))).expand(*flat.shape,
                                                             *feat)
    return x.gather(s, g).reshape(*idx.shape, *feat)


# The legacy solver below reproduces the JAX package's float32 results bit
# for bit, so its sums and products follow what XLA compiles on the CPU:
# a sum over more than 32 values is a sum of windows of 32 (zero-padded
# evenly at both ends to a multiple of 32), each window and then the
# windows' sums added in index order; ``a * b + c * d`` is one fused
# multiply-add, fma(a, b, c * d). A last sum of 17 to 32 values is the
# exception: XLA's code generator vectorizes it into partial sums, so
# there the result can differ from the JAX package's by a few ulp. The
# legacy path's sums run over ``max_corners`` points (200 by default:
# seven windows), inside the exact range.
_SUM_WINDOW = 32


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 in XLA's CPU order (see above): every add is one
    float32 add in a fixed order, so CPU and CUDA agree bit for bit."""
    n = x.shape[0]
    while n > _SUM_WINDOW:
        m = -(-n // _SUM_WINDOW)
        pad = m * _SUM_WINDOW - n
        zeros = x.new_zeros((pad,) + tuple(x.shape[1:]))
        x = torch.cat([zeros[:pad // 2], x, zeros[pad // 2:]]).reshape(
            (m, _SUM_WINDOW) + tuple(x.shape[1:]))
        acc = x[:, 0]
        for k in range(1, _SUM_WINDOW):
            acc = acc + x[:, k]
        x, n = acc, m
    acc = x[0]
    for k in range(1, n):
        acc = acc + x[k]
    return acc


def fma(a, b, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding: the product of two float32
    values is exact in float64, so the sum rounds once more (to float32).
    ``a`` or ``b`` may be a Python float, taken as float32."""
    def f64(v):
        if isinstance(v, torch.Tensor):
            return v.double()
        return float(np.float32(v))
    return (f64(a) * f64(b) + c.double()).to(torch.float32)


def estimate_rigid_closed_form(prev: torch.Tensor, curr: torch.Tensor,
                               mask: torch.Tensor) -> torch.Tensor:
    """Legacy closed-form rigid solve (Stabilizer_legacy.cpp:323-358):
    centroid translation + atan2(sum cross, sum dot) rotation.

    Returns (dx, dy, da); zeros when under 3 valid points."""
    w = mask.to(torch.float32)
    n = ordered_sum(w)
    ok = n >= 3.0
    safe_n = torch.where(n > 0, n, torch.ones_like(n))
    pm = ordered_sum(prev * w[:, None]) / safe_n
    qm = ordered_sum(curr * w[:, None]) / safe_n
    dx = qm[0] - pm[0]
    dy = qm[1] - pm[1]
    pc = prev - pm
    qc = curr - qm
    num = ordered_sum(w * fma(pc[:, 0], qc[:, 1], -(pc[:, 1] * qc[:, 0])))
    den = ordered_sum(w * fma(pc[:, 0], qc[:, 0], pc[:, 1] * qc[:, 1]))
    da = torch.where(den.abs() > 1e-6, torch.atan2(num, den),
                     torch.zeros_like(num))
    out = torch.stack([dx, dy, da])
    return torch.where(ok, out, torch.zeros_like(out))


def _masked_median_upper(vals: torch.Tensor, mask: torch.Tensor
                         ) -> torch.Tensor:
    """C++ nth_element median: sorted[n_valid // 2] (upper-mid for even n)
    over the values with masked entries set to +inf
    (Stabilizer_legacy.cpp:301-304)."""
    big = torch.where(mask, vals, torch.full_like(vals, float("inf")))
    s = torch.sort(big).values
    n_valid = mask.to(torch.int64).sum()
    idx = torch.clamp(n_valid // 2, 0, vals.shape[0] - 1)
    return s.index_select(0, idx.view(1))[0]


def remove_outliers_median(prev: torch.Tensor, curr: torch.Tensor,
                           mask: torch.Tensor, threshold: float = 15.0,
                           min_keep: int = 10) -> torch.Tensor:
    """Legacy median-motion outlier rejection (Stabilizer_legacy.cpp:
    283-321): the refined validity mask, or the original one when fewer
    than ``min_keep`` points survive (legacy:317)."""
    motions = curr - prev
    mdx = motions[:, 0] - _masked_median_upper(motions[:, 0], mask)
    mdy = motions[:, 1] - _masked_median_upper(motions[:, 1], mask)
    dist = torch.sqrt(fma(mdx, mdx, mdy * mdy))
    kept = mask & (dist <= threshold)
    return torch.where(kept.to(torch.int32).sum() >= min_keep, kept, mask)
