"""L1-optimal camera path smoothing (offline) — port of
``video_stab_tpu/motion/l1path.py``.

The smoother of "Auto-Directed Video Stabilization with Robust L1 Optimal
Camera Paths" (Grundmann et al.) as revisited by "Cinematic-L1 Video
Stabilization with a Log-Homography Model" (arxiv.org/pdf/2011.08144):
minimize the L1 norms of the path's first, second and third differences,
so the smoothed path is piecewise constant / linear / parabolic, subject
to staying within a crop box of the original.

Solved by ADMM with split variables z_k = D_k p; the p-update's SPD system
(I + rho * sum D_k^T D_k) p = rhs is solved matrix-free by a fixed number
of CG steps. Everything is tensor ops on the path's device with static
iteration counts, and nothing is read back on the host: in eager PyTorch
that is n_admm x n_cg CG steps of some tens of small launches each.
"""

from __future__ import annotations

import torch

# Weights from the L1 stabilization literature (w1:w2:w3 = 10:1:100).
W1, W2, W3 = 10.0, 1.0, 100.0


def _d1(p):
    return p[1:] - p[:-1]


def _d1t(z, n):
    out = z.new_zeros((n,) + z.shape[1:])
    out[:-1] -= z
    out[1:] += z
    return out


def _d2(p):
    return p[2:] - 2.0 * p[1:-1] + p[:-2]


def _d2t(z, n):
    out = z.new_zeros((n,) + z.shape[1:])
    out[:-2] += z
    out[1:-1] += -2.0 * z
    out[2:] += z
    return out


def _d3(p):
    return p[3:] - 3.0 * p[2:-1] + 3.0 * p[1:-2] - p[:-3]


def _d3t(z, n):
    out = z.new_zeros((n,) + z.shape[1:])
    out[:-3] -= z
    out[1:-2] += 3.0 * z
    out[2:-1] += -3.0 * z
    out[3:] += z
    return out


def _soft(x, t):
    return torch.sign(x) * torch.clamp(x.abs() - t, min=0.0)


def l1_smooth_path(path: torch.Tensor, bound=20.0, rho: float = 1.0,
                   n_admm: int = 60, n_cg: int = 25) -> torch.Tensor:
    """Smooth a (T, C) camera path with L1-optimal differences.

    path: (T, C) cumulative trajectory (T >= 4). bound: a scalar or a (C,)
    tensor, the box constraint |smoothed - path| <= bound (the crop margin
    in pixels / radians). Returns the (T, C) smoothed path."""
    n = path.shape[0]
    bound = torch.as_tensor(bound, dtype=path.dtype,
                            device=path.device).expand(path.shape[1:])
    lo, hi = path - bound, path + bound

    def a_op(p):
        """(I + rho * (D1'D1 + D2'D2 + D3'D3)) p, matrix-free."""
        out = p + rho * _d1t(_d1(p), n)
        out = out + rho * _d2t(_d2(p), n)
        return out + rho * _d3t(_d3(p), n)

    def cg_solve(b, x):
        r = b - a_op(x)
        d = r
        rs = (r * r).sum()
        for _ in range(n_cg):
            ad = a_op(d)
            alpha = rs / torch.clamp((d * ad).sum(), min=1e-12)
            x = x + alpha * d
            r = r - alpha * ad
            rs_new = (r * r).sum()
            d = r + (rs_new / torch.clamp(rs, min=1e-12)) * d
            rs = rs_new
        return x

    p = path
    z1, z2, z3 = _d1(p), _d2(p), _d3(p)
    u1, u2, u3 = (torch.zeros_like(z) for z in (z1, z2, z3))
    for _ in range(n_admm):
        rhs = path + rho * (_d1t(z1 - u1, n) + _d2t(z2 - u2, n)
                            + _d3t(z3 - u3, n))
        p = cg_solve(rhs, p)
        p = torch.minimum(torch.maximum(p, lo), hi)   # crop-box constraint
        d1, d2, d3 = _d1(p), _d2(p), _d3(p)
        z1 = _soft(d1 + u1, W1 / rho)
        z2 = _soft(d2 + u2, W2 / rho)
        z3 = _soft(d3 + u3, W3 / rho)
        u1 = u1 + d1 - z1
        u2 = u2 + d2 - z2
        u3 = u3 + d3 - z3
    return p
