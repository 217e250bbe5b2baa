"""Hough line transform with a fixed-capacity line list — port of
``video_stab_tpu/ops/hough.py``.

The (rho, theta) accumulator is an int32 scatter-add over every pixel,
weighted by the edge mask: integer atomics, so their order cannot change a
count. The JAX package's one-hot matmuls and staged edge capacities are TPU
workarounds with the same counts. Peaks are the same 4-neighbour local
maxima, margin bins of a ``theta_range`` window are masked the same way,
and the top ``max_lines`` by votes take ties in index order, as
``lax.top_k`` does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from video_stab_tpu_torch.ops.features import top_candidates


def hough_lines(edges: torch.Tensor, rho: float = 1.0,
                theta: float = math.pi / 180.0, threshold: int = 100,
                max_lines: int = 256,
                theta_range: Optional[tuple] = None,
                impl: str = "auto", max_edges: int = 16384,
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Detect lines in a binary edge map.

    Args:
      edges: (H, W) edge map; any value > 0 counts as an edge pixel.
      theta_range: optional (lo, hi) radians — the accumulator covers only
        thetas in [lo, hi] plus a one-bin margin whose peaks are masked out.
      impl, max_edges: accepted and ignored (TPU layout knobs).

    Returns:
      lines: (max_lines, 2) float32 rows of (rho, theta), vote-descending.
      votes: (max_lines,) float32 accumulator votes.
      mask:  (max_lines,) bool — True where votes > threshold.
    """
    del impl, max_edges
    dev = edges.device
    h, w = edges.shape
    n_theta_full = int(round(math.pi / theta))
    if theta_range is not None:
        t0 = max(0, int(math.floor(float(theta_range[0]) / theta)) - 1)
        t1 = min(n_theta_full - 1,
                 int(math.ceil(float(theta_range[1]) / theta)) + 1)
    else:
        t0, t1 = 0, n_theta_full - 1
    n_theta = t1 - t0 + 1
    n_rho = int(round(((w + h) * 2 + 1) / rho))
    center = (n_rho - 1) // 2
    n_bins = -(-n_rho // 128) * 128     # the JAX clip bound, n_hi * 128

    # float32 tables computed as hough.py does: (i + t0) * theta, cos, sin.
    thetas = (torch.arange(n_theta, dtype=torch.float32, device=dev)
              + float(t0)) * theta
    cos_t = torch.cos(thetas) / rho
    sin_t = torch.sin(thetas) / rho

    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    weight = (edges > 0).to(torch.int32).reshape(1, -1).expand(n_theta, -1)
    ridx = torch.round(xs[None] * cos_t[:, None, None]
                       + ys[None] * sin_t[:, None, None]).to(torch.int64)
    ridx = (ridx + center).clamp(0, n_bins - 1).reshape(n_theta, -1)
    acc = torch.zeros((n_theta, n_bins), dtype=torch.int32, device=dev)
    acc.scatter_add_(1, ridx, weight)
    acc = acc[:, :n_rho].to(torch.float32).T          # (n_rho, n_theta)

    # 4-neighbour local maxima (OpenCV's > left/up, >= right/down).
    up = F.pad(acc[:-1, :], (0, 0, 1, 0))
    down = F.pad(acc[1:, :], (0, 0, 0, 1))
    left = F.pad(acc[:, :-1], (1, 0, 0, 0))
    right = F.pad(acc[:, 1:], (0, 1, 0, 0))
    is_peak = (acc > up) & (acc >= down) & (acc > left) & (acc >= right)
    peak_votes = torch.where(is_peak, acc, torch.zeros_like(acc))
    if theta_range is not None:
        # Margin-bin peaks must not take line slots. float32 like the JAX
        # comparison of an int32 column times a Python float.
        tcol = (torch.arange(n_theta, device=dev) + t0).to(torch.float32) \
            * theta
        lo = torch.full((), float(theta_range[0]) - 1e-9,
                        dtype=torch.float32, device=dev)
        hi = torch.full((), float(theta_range[1]) + 1e-9,
                        dtype=torch.float32, device=dev)
        in_range = (tcol >= lo) & (tcol <= hi)
        peak_votes = torch.where(in_range[None, :], peak_votes,
                                 torch.zeros_like(peak_votes))

    k = min(max_lines, n_rho * n_theta)
    votes, idx = top_candidates(peak_votes.reshape(-1), k)
    r_idx = torch.div(idx, n_theta, rounding_mode="floor")
    t_idx = idx % n_theta
    line_rho = (r_idx - center).to(torch.float32) * rho
    line_theta = (t_idx + t0).to(torch.float32) * theta
    lines = torch.stack([line_rho, line_theta], dim=-1)
    mask = votes > threshold
    if k < max_lines:
        pad = max_lines - k
        lines = F.pad(lines, (0, 0, 0, pad))
        votes = F.pad(votes, (0, pad))
        mask = torch.cat([mask, torch.zeros(pad, dtype=torch.bool,
                                            device=dev)])
    return lines, votes, mask
