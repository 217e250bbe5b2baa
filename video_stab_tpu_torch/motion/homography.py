"""Homography estimation and log-homography trajectory smoothing.

Counterpart of ``video_stab_tpu/motion/homography.py``: an 8-DOF RANSAC
(every 4-point hypothesis solved and scored at once), a Hartley-normalized
least-squares refit, and the sl(3) log / exp maps in which inter-frame
homographies add (the log-homography model of arxiv 2011.08144).

PyTorch counterparts of the JAX linear algebra:

- the 500 hypotheses' 8x8 DLT systems: ``torch.linalg.lu_factor_ex`` and
  ``lu_solve``, batched; ``_ex`` skips the error check, so no host read;
- the refit's smallest right singular vector: ``torch.linalg.eigh`` of
  the 9x9 normal matrix, as ``jnp.linalg.eigh`` there;
- ``jsl.expm``: ``torch.linalg.matrix_exp``;
- the 3x3 determinant: a closed form by torch ops (``ops/warp.py``).

On a CUDA tensor ``eigh`` reads its solver's status on the host (1 read
per call) and ``matrix_exp`` picks its degree from the norms on the host
(6 reads per call): 7 device->host reads per streaming frame. They are
counted in ``chip_smoke.py`` and written down in PERF.md.

The products are ``torch.matmul``, as the JAX package leaves them to XLA.
TF32 stays off (the package turns it off at import).

N streams estimate at once on (N, P, 2) point sets (the multi-stream step,
``parallel/``): the 500 hypotheses of every stream are one batch of LU
solves, and ``eigh`` and ``matrix_exp`` take the (N, 9, 9) and (N, 3, 3)
batches in one call each, so the host reads per step stay those of one
stream.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from video_stab_tpu_torch.motion.estimate import (_take, ransac_draws,
                                                  ransac_draws_streams)
from video_stab_tpu_torch.ops.warp import det3


def _dlt_4pt(p: torch.Tensor, q: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact homographies from 4 correspondences: the 8x8 DLT systems.

    p, q: (..., 4, 2). Returns (..., 3, 3) H with H[2, 2] = 1 and an ok
    flag (|det| > 1e-8 and a finite LU), batched over the leading axes."""
    x, y = p[..., 0], p[..., 1]
    u, v = q[..., 0], q[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -u * x, -u * y], dim=-1)
    r2 = torch.stack([z, z, z, x, y, o, -v * x, -v * y], dim=-1)
    batch = x.shape[:-1]
    a = torch.stack([r1, r2], dim=-2).reshape(*batch, 8, 8)
    b = q.reshape(*batch, 8, 1)
    # One LU serves the degeneracy check (|prod diag U| is the pivoted
    # LU's |det|) and the solve, as in the JAX package.
    lu, piv, _info = torch.linalg.lu_factor_ex(a)
    absdet = torch.diagonal(lu, dim1=-2, dim2=-1).prod(dim=-1).abs()
    finite = torch.isfinite(lu)
    det_ok = (absdet > 1e-8) & finite.all(dim=-1).all(dim=-1)
    h8 = torch.linalg.lu_solve(torch.where(finite, lu, torch.zeros_like(lu)),
                               piv, b)[..., 0]
    h8 = torch.where(det_ok[..., None], h8, torch.zeros_like(h8))
    h = torch.cat([h8, torch.ones_like(h8[..., :1])], dim=-1)
    return h.reshape(*batch, 3, 3), det_ok


def _project(h: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., K, 3, 3) H to (..., N, 2) points: (..., K, N, 2), the
    leading axes of both broadcast."""
    x, y = pts[..., None, :, 0], pts[..., None, :, 1]

    def row(i):
        return (h[..., i, 0:1] * x + h[..., i, 1:2] * y) + h[..., i, 2:3]

    d = row(2)
    d = torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
    return torch.stack([row(0) / d, row(1) / d], dim=-1)


def estimate_homography_ransac(
    prev: torch.Tensor, curr: torch.Tensor, mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    threshold: float = 5.0, n_hypotheses: int = 500,
    draws: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """8-DOF RANSAC homography (cv::findHomography(RANSAC) semantics).

    prev/curr: (N, 2) masked point sets; mask: (N,) bool. The hypotheses'
    draws come from ``generator`` unless ``draws`` ((K, 4) int64 in
    [0, max(n_valid, 1)), e.g. the JAX package's own) are given. Returns
    (H (3, 3), ok, inliers); the identity when under 8 valid points.
    Every argument and result may carry a leading stream axis S
    (``generator`` then a sequence of S generators)."""
    st = mask.dim() - 1                           # stream axes
    n_valid = mask.to(torch.int32).sum(dim=-1)
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    if draws is None:
        if generator is None:
            raise ValueError("pass a generator or the draws")
        draws = ransac_draws(generator, n_hypotheses, n_valid, width=4) \
            if st == 0 else \
            ransac_draws_streams(generator, n_hypotheses, n_valid, width=4)
    samples = _take(order, draws.to(device=order.device, dtype=torch.int64),
                    st)
    h, ok = _dlt_4pt(_take(prev, samples, st),
                     _take(curr, samples, st))      # (..., K, 3, 3)
    s0, s1, s2, s3 = samples.unbind(dim=-1)
    distinct = (s0 != s1) & (s0 != s2) & (s0 != s3) & (s1 != s2) \
        & (s1 != s3) & (s2 != s3)
    err2 = ((_project(h, prev) - curr[..., None, :, :]) ** 2).sum(dim=-1)
    inl = mask[..., None, :] & (err2 < threshold * threshold)   # (..., K, N)
    scores = torch.where(ok & distinct, inl.to(torch.int32).sum(dim=-1),
                         torch.full_like(n_valid[..., None], -1))
    # First maximum, as jnp.argmax.
    best = torch.argmax(scores, dim=-1, keepdim=True)
    best_inl = _take(inl, best, st)[..., 0, :]

    # Least-squares refit on the best inlier set: Hartley-normalized DLT,
    # smallest eigenvector of the weighted 9x9 normal matrix.
    w = best_inl.to(torch.float32)
    n_w = torch.clamp(w.sum(dim=-1), min=1.0)

    def norm_transform(pts):
        mean = (pts * w[..., None]).sum(dim=-2) / n_w[..., None]
        d = torch.sqrt(((pts - mean[..., None, :]) ** 2).sum(dim=-1))
        scale = math.sqrt(2.0) / torch.clamp((d * w).sum(dim=-1) / n_w,
                                             min=1e-6)
        return mean, scale, (pts - mean[..., None, :]) * scale[..., None,
                                                                None]

    mp, sp, pn = norm_transform(prev)
    mq, sq, qn = norm_transform(curr)
    x, y = pn[..., 0], pn[..., 1]
    uu, vv = qn[..., 0], qn[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -uu * x, -uu * y, -uu], dim=-1)
    r2 = torch.stack([z, z, z, x, y, o, -vv * x, -vv * y, -vv], dim=-1)
    a = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)  # (2N, 9)
    hn = _smallest_eigenvector(a.transpose(-1, -2) @ a).reshape(
        *a.shape[:-2], 3, 3)
    zero = torch.zeros_like(sp)
    one = torch.ones_like(sp)

    def mat3(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    t_p = mat3([[sp, zero, -sp * mp[..., 0]],
                [zero, sp, -sp * mp[..., 1]],
                [zero, zero, one]])
    t_q_inv = mat3([[1.0 / sq, zero, mq[..., 0]],
                    [zero, 1.0 / sq, mq[..., 1]],
                    [zero, zero, one]])
    h = t_q_inv @ hn @ t_p
    h22 = h[..., 2:3, 2:3]
    h = h / torch.where(h22.abs() > 1e-9, h22, torch.full_like(h22, 1e-9))

    enough = (n_valid >= 8) & (_take(scores, best, st)[..., 0] >= 4)
    eye = torch.eye(3, dtype=torch.float32, device=prev.device)
    return torch.where(enough[..., None, None], h, eye), enough, \
        best_inl & enough[..., None]


def _smallest_eigenvector(m: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., n, n)
    matrices (sign arbitrary; ``eigh`` sorts its eigenvalues ascending):
    one ``eigh`` call for the whole batch."""
    return torch.linalg.eigh(m)[1][..., :, 0]


def _normalize_sl3(h: torch.Tensor) -> torch.Tensor:
    """Scale (..., 3, 3) H so det = 1 (the SL(3) representative)."""
    det = det3(h)
    s = torch.sign(det) * det.abs() ** (1.0 / 3.0)
    s = torch.where(s.abs() > 1e-9, s, torch.full_like(s, 1e-9))
    return h / s[..., None, None]


def log_homography(h: torch.Tensor, n_terms: int = 12) -> torch.Tensor:
    """Matrix log of near-identity (..., 3, 3) homographies via the Mercator
    series log(I+X) = X - X^2/2 + X^3/3 - ... (inter-frame warps are
    small)."""
    h = _normalize_sl3(h)
    x = h - torch.eye(3, dtype=h.dtype, device=h.device)
    term = x
    out = torch.zeros_like(x)
    for k in range(1, n_terms + 1):
        out = out + ((-1.0) ** (k + 1)) / k * term
        term = term @ x
    return out


def exp_homography(l: torch.Tensor) -> torch.Tensor:
    """Matrix exponential sl(3) -> SL(3) of (..., 3, 3) logs."""
    return torch.linalg.matrix_exp(l)


def smooth_homography_path(logs: torch.Tensor,
                           smoother: Callable[[torch.Tensor], torch.Tensor]
                           ) -> torch.Tensor:
    """logs: (T, 3, 3) per-frame log-homographies (forward motion
    convention). Returns (T, 3, 3) correcting homographies
    exp(raw + smoothed_path - path), the log-space analog of the affine
    correction."""
    t = logs.shape[0]
    flat = logs.reshape(t, 9)
    path = torch.cumsum(flat, dim=0)
    corr = flat + (smoother(path) - path)
    return exp_homography(corr.reshape(t, 3, 3))
