"""Separable filtering (Sobel and Scharr derivatives) and CLAHE.

Counterpart of the ported part of ``video_stab_tpu/ops/filters.py``. The
JAX package applies each 1-D filter as a dense banded (n, n) matmul, a
layout choice for the TPU's matrix unit; here each is a 1-D correlation
over a reflect-101 padded copy (``F.pad(mode="reflect")`` is reflect-101),
and every stage pads its own input, as the banded operators do.

Taps are summed left to right, each product rounded to float32 first —
the order the corner-response kernel (csrc/features.cu) uses, so kernel
and plain version agree bit for bit.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def reflect_101_index(i: int, n: int) -> int:
    """BORDER_REFLECT_101 of an integer index (-1 -> 1, n -> n-2)."""
    if n == 1:
        return 0
    period = 2 * (n - 1)
    i %= period
    return period - i if i >= n else i


def correlate_1d(x: torch.Tensor, kernel: Sequence[float], dim: int
                 ) -> torch.Tensor:
    """Centered 1-D correlation of x along ``dim``, reflect-101 border."""
    dim = dim % x.dim()
    n = x.shape[dim]
    p = len(kernel) // 2
    xt = x.movedim(dim, -1)
    lead = xt.shape[:-1]
    if p < n:
        xp = F.pad(xt.reshape(1, -1, n), (p, p), mode="reflect").reshape(
            *lead, n + 2 * p)
    else:
        # F.pad reflects less than one length only: a short axis (a
        # one-pixel frame reflects onto itself) is gathered by index.
        xp = xt[..., [reflect_101_index(i, n) for i in range(-p, n + p)]]
    out = None
    for t, k in enumerate(kernel):
        term = xp[..., t:t + n] * k
        out = term if out is None else out + term
    return out.movedim(-1, dim)


def sep_filter2d(img: torch.Tensor, kh: Sequence[float],
                 kw: Sequence[float]) -> torch.Tensor:
    """Separable filter over the last two dims of (..., H, W): ``kh`` along
    H first, then ``kw`` along W."""
    return correlate_1d(correlate_1d(img, kh, -2), kw, -1)


def sobel(img: torch.Tensor, aperture: int = 3
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sobel dx, dy (aperture 3 only), reflect-101 border; raw OpenCV-scaled
    responses (smooth [1,2,1], diff [-1,0,1])."""
    if aperture != 3:
        raise ValueError("only aperture 3 supported")
    smooth = (1.0, 2.0, 1.0)
    diff = (-1.0, 0.0, 1.0)
    return sep_filter2d(img, smooth, diff), sep_filter2d(img, diff, smooth)


def scharr_derivs(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Unit-gradient Scharr derivatives ([3,10,3]/16 smooth, [-1,0,1]/2
    diff), the derivative filter inside pyramidal LK."""
    smooth = (3.0 / 16, 10.0 / 16, 3.0 / 16)
    diff = (-0.5, 0.0, 0.5)
    return sep_filter2d(img, smooth, diff), sep_filter2d(img, diff, smooth)


def clahe(img: torch.Tensor, clip_limit: float = 2.0, tile_grid: int = 8
          ) -> torch.Tensor:
    """cv::CLAHE on a single-channel u8-domain float image (H, W): per-tile
    clipped histogram -> LUT, bilinear blend of the four surrounding tiles'
    LUTs. The image is padded (reflect-101, bottom and right) so that H and
    W divide the tile grid. Every step is a tensor op on ``img``'s device;
    nothing is read back."""
    h, w = img.shape
    ty = tx = tile_grid
    th = -(-h // ty)
    tw = -(-w // tx)
    ph, pw = th * ty, tw * tx
    x = img
    if (ph, pw) != (h, w):
        x = F.pad(x[None, None], (0, pw - w, 0, ph - h), mode="reflect")[0, 0]
    dev = img.device
    vals = torch.clamp(x, 0.0, 255.0).to(torch.int64)
    tile_row = torch.arange(ph, device=dev) // th
    tile_col = torch.arange(pw, device=dev) // tw
    tile_id = tile_row[:, None] * tx + tile_col[None, :]
    flat_bin = (tile_id * 256 + vals).reshape(-1)
    hist = torch.zeros(ty * tx * 256, dtype=torch.float32, device=dev)
    hist = hist.index_add_(0, flat_bin, torch.ones_like(flat_bin,
                                                        dtype=torch.float32))
    hist = hist.reshape(ty * tx, 256)

    # Integer clip and redistribution as cv::CLAHE's calcLut: the excess is
    # spread as batch = clipped // 256 to every bin and the residual to bins
    # 0, s, 2s, ... with s = max(256 // residual, 1).
    tile_area = th * tw
    clip = max(int(clip_limit * tile_area / 256.0), 1)
    clipped = torch.clamp(hist - clip, min=0.0).sum(dim=1, keepdim=True)
    hist = torch.clamp(hist, max=float(clip))
    batch = torch.floor(clipped / 256.0)
    residual = clipped - batch * 256.0
    step = torch.clamp(torch.floor(256.0 / torch.clamp(residual, min=1.0)),
                       min=1.0)
    bins = torch.arange(256, dtype=torch.float32, device=dev)[None, :]
    res_inc = ((torch.remainder(bins, step) == 0)
               & (torch.floor(bins / step) < residual)).to(torch.float32)
    hist = hist + batch + res_inc
    cdf = torch.cumsum(hist, dim=1)
    luts = torch.clamp(torch.round(cdf * (255.0 / tile_area)), 0.0, 255.0)

    # Bilinear blend (txf = x / tw - 0.5, weights before the index clamp).
    ys = torch.arange(ph, dtype=torch.float32, device=dev) / th - 0.5
    xs = torch.arange(pw, dtype=torch.float32, device=dev) / tw - 0.5
    y0f = torch.floor(ys)
    x0f = torch.floor(xs)
    fy = (ys - y0f)[:, None]
    fx = (xs - x0f)[None, :]
    y0 = torch.clamp(y0f, 0, ty - 1).to(torch.int64)[:, None]
    x0 = torch.clamp(x0f, 0, tx - 1).to(torch.int64)[None, :]
    y1 = torch.clamp(y0f + 1, 0, ty - 1).to(torch.int64)[:, None]
    x1 = torch.clamp(x0f + 1, 0, tx - 1).to(torch.int64)[None, :]
    flat = luts.reshape(-1)

    def look(yt, xt):
        return flat[(yt * tx + xt) * 256 + vals]

    out = ((look(y0, x0) * (1 - fx) + look(y0, x1) * fx) * (1 - fy)
           + (look(y1, x0) * (1 - fx) + look(y1, x1) * fx) * fy)
    return out[:h, :w].to(img.dtype)
