"""Canny edge detection — port of ``video_stab_tpu/ops/canny.py``.

L1 gradient magnitude from a 3x3 Sobel, non-max suppression along the
4-way quantized gradient direction, and hysteresis as a fixed number of
passes of dilate(strong) & weak (16 by default), so no step depends on the
data's shape.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from video_stab_tpu_torch.ops.filters import sobel


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """v[y, x] = x[y + dy, x + dx], 0 outside the image."""
    h, w = x.shape
    p = F.pad(x[None, None], (1, 1, 1, 1))[0, 0]
    return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def canny_edges(gray: torch.Tensor, threshold_low: float = 50.0,
                threshold_high: float = 150.0, hysteresis_iters: int = 16,
                l2_gradient: bool = False) -> torch.Tensor:
    """Binary edge map (0/255 float32) of a (H, W) u8-domain gray image."""
    gx, gy = sobel(gray)
    if l2_gradient:
        mag = torch.sqrt(gx * gx + gy * gy)
    else:
        mag = torch.abs(gx) + torch.abs(gy)

    ax, ay = torch.abs(gx), torch.abs(gy)
    tan225 = 0.4142135623730951   # tan(22.5 deg)
    tan675 = 2.414213562373095    # tan(67.5 deg)
    horiz = ay <= ax * tan225
    vert = ay >= ax * tan675
    same_sign = (gx * gy) >= 0

    m_l, m_r = _shift(mag, 0, -1), _shift(mag, 0, 1)
    m_u, m_d = _shift(mag, -1, 0), _shift(mag, 1, 0)
    m_ul, m_dr = _shift(mag, -1, -1), _shift(mag, 1, 1)
    m_ur, m_dl = _shift(mag, -1, 1), _shift(mag, 1, -1)

    n1 = torch.where(horiz, m_l, torch.where(vert, m_u,
                     torch.where(same_sign, m_ul, m_ur)))
    n2 = torch.where(horiz, m_r, torch.where(vert, m_d,
                     torch.where(same_sign, m_dr, m_dl)))
    is_max = (mag >= n1) & (mag > n2)

    strong = (is_max & (mag > threshold_high)).to(gray.dtype)
    weak = (is_max & (mag > threshold_low)).to(gray.dtype)
    edges = strong[None, None]
    for _ in range(hysteresis_iters):
        # 3x3 binary dilation (the centre is in the window, so the pool's
        # implicit -inf border acts as the JAX version's zero border).
        edges = F.max_pool2d(edges, 3, stride=1, padding=1) * weak
    edges = edges[0, 0]
    return torch.where(edges > 0, 255.0, 0.0).to(gray.dtype)
