"""Separable filtering, morphology, CLAHE and the enhancer's filters.

Counterpart of ``video_stab_tpu/ops/filters.py``. The
JAX package applies each 1-D filter as a dense banded (n, n) matmul, a
layout choice for the TPU's matrix unit; here each is a 1-D correlation
over a reflect-101 padded copy (``F.pad(mode="reflect")`` is reflect-101),
and every stage pads its own input, as the banded operators do.

Taps are summed left to right, each product rounded to float32 first —
the order the corner-response kernel (csrc/features.cu) uses, so kernel
and plain version agree bit for bit.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import numpy as np
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
    nothing is read back. N streams' (N, H, W) grays take the same ops
    once for the batch: each stream's bins and LUT reads offset into its
    own block of the histogram."""
    *lead, h, w = img.shape
    ty = tx = tile_grid
    th = -(-h // ty)
    tw = -(-w // tx)
    ph, pw = th * ty, tw * tx
    x = img
    if (ph, pw) != (h, w):
        x = F.pad(x.unsqueeze(-3), (0, pw - w, 0, ph - h),
                  mode="reflect").squeeze(-3)
    dev = img.device
    vals = torch.clamp(x, 0.0, 255.0).to(torch.int64)
    n_tiles = ty * tx
    if lead:
        # Stream i's histogram and LUTs are block i of n_tiles * 256 bins.
        streams = torch.arange(math.prod(lead), device=dev).reshape(
            *lead, 1, 1)
        vals = vals + streams * (n_tiles * 256)
    tile_row = torch.arange(ph, device=dev) // th
    tile_col = torch.arange(pw, device=dev) // tw
    tile_id = tile_row[:, None] * tx + tile_col[None, :]
    flat_bin = (tile_id * 256 + vals).reshape(-1)
    hist = torch.zeros(math.prod(lead) * n_tiles * 256, dtype=torch.float32,
                       device=dev)
    hist = hist.index_add_(0, flat_bin, torch.ones_like(flat_bin,
                                                        dtype=torch.float32))
    hist = hist.reshape(*lead, n_tiles, 256)

    # Integer clip and redistribution as cv::CLAHE's calcLut: the excess is
    # spread as batch = clipped // 256 to every bin and the residual to bins
    # 0, s, 2s, ... with s = max(256 // residual, 1).
    tile_area = th * tw
    clip = max(int(clip_limit * tile_area / 256.0), 1)
    clipped = torch.clamp(hist - clip, min=0.0).sum(dim=-1, keepdim=True)
    hist = torch.clamp(hist, max=float(clip))
    batch = torch.floor(clipped / 256.0)
    residual = clipped - batch * 256.0
    step = torch.clamp(torch.floor(256.0 / torch.clamp(residual, min=1.0)),
                       min=1.0)
    bins = torch.arange(256, dtype=torch.float32, device=dev)[None, :]
    res_inc = ((torch.remainder(bins, step) == 0)
               & (torch.floor(bins / step) < residual)).to(torch.float32)
    hist = hist + batch + res_inc
    cdf = torch.cumsum(hist, dim=-1)
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
    return out[..., :h, :w].to(img.dtype)


# ---------------------------------------------------------------------------
# Blurs, morphology, threshold and the enhancer's sharpen / denoise.
# ---------------------------------------------------------------------------

def _spatial_dims(img: torch.Tensor) -> tuple[int, int]:
    """The (H, W) dims of (..., H, W) or of (..., H, W, C) with C <= 4 —
    the JAX package's ``sep_filter2d`` rule for a trailing channel axis."""
    if img.dim() >= 3 and img.shape[-1] in (1, 2, 3, 4):
        return img.dim() - 3, img.dim() - 2
    return img.dim() - 2, img.dim() - 1


def sep_filter_image(img: torch.Tensor, kh: Sequence[float],
                     kw: Sequence[float]) -> torch.Tensor:
    """``sep_filter2d`` over an image's spatial dims, channels last when the
    last dim is <= 4 (the JAX package's ``sep_filter2d`` on such images)."""
    dh, dw = _spatial_dims(img)
    return correlate_1d(correlate_1d(img, kh, dh), kw, dw)


@functools.lru_cache(maxsize=64)
def gaussian_kernel_1d(sigma: float, ksize: Optional[int] = None
                       ) -> tuple[float, ...]:
    """cv::getGaussianKernel; with no ksize, GaussianBlur(Size(0, 0), sigma)
    on float input: ksize = round(sigma * 8 + 1) | 1."""
    if ksize is None or ksize <= 0:
        ksize = int(round(sigma * 4.0 * 2.0 + 1.0))
    if ksize % 2 == 0:
        ksize += 1
    xs = np.arange(ksize, dtype=np.float64) - ksize // 2
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    k /= k.sum()
    return tuple(float(v) for v in k)


def gaussian_blur(img: torch.Tensor, sigma: float,
                  ksize: Optional[int] = None) -> torch.Tensor:
    k = gaussian_kernel_1d(sigma, ksize)
    return sep_filter_image(img, k, k)


def box_blur(img: torch.Tensor, ksize: int) -> torch.Tensor:
    k = (1.0 / ksize,) * ksize
    return sep_filter_image(img, k, k)


@functools.lru_cache(maxsize=32)
def _ellipse_offsets(ksize: int) -> tuple[tuple[int, int], ...]:
    """Offsets of cv::getStructuringElement(MORPH_ELLIPSE, (k, k))."""
    r = ksize // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    offs = []
    for dy in range(-r, r + 1):
        dx_max = 0 if r == 0 else int(round(
            r * math.sqrt(max(0.0, 1.0 - dy * dy * inv_r2))))
        if abs(dy) == r:
            dx_max = 0
        offs.extend((dy, dx) for dx in range(-dx_max, dx_max + 1))
    return tuple(offs)


def _shift2d(img: torch.Tensor, dy: int, dx: int, fill: float
             ) -> torch.Tensor:
    """out[y, x] = img[y + dy, x + dx], ``fill`` where that is outside."""
    out = torch.roll(img, (-dy, -dx), dims=(0, 1))
    h, w = img.shape[:2]
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    valid = (ys + dy >= 0) & (ys + dy < h) & (xs + dx >= 0) & (xs + dx < w)
    return torch.where(valid, out, torch.full_like(out, fill))


def dilate(img: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """Grayscale dilation with an elliptical kernel; outside is -inf."""
    out = img
    for dy, dx in _ellipse_offsets(ksize):
        if (dy, dx) != (0, 0):
            out = torch.maximum(out, _shift2d(img, dy, dx, -math.inf))
    return out


def erode(img: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """Grayscale erosion with an elliptical kernel; outside is +inf."""
    out = img
    for dy, dx in _ellipse_offsets(ksize):
        if (dy, dx) != (0, 0):
            out = torch.minimum(out, _shift2d(img, dy, dx, math.inf))
    return out


def morph_close(img: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """MORPH_CLOSE = dilate then erode."""
    return erode(dilate(img, ksize), ksize)


def threshold_binary(img: torch.Tensor, thresh: float, maxval: float = 255.0,
                     inverse: bool = False) -> torch.Tensor:
    """cv::threshold THRESH_BINARY / THRESH_BINARY_INV."""
    mask = img > thresh
    if inverse:
        mask = ~mask
    return torch.where(mask, torch.full_like(img, maxval),
                       torch.zeros_like(img))


def unsharp_mask(img: torch.Tensor, sharpness: float, blur_sigma: float
                 ) -> torch.Tensor:
    """addWeighted(img, 1 + s, gaussian(img, sigma), -s, 0)."""
    blurred = gaussian_blur(img, blur_sigma)
    return img * (1.0 + sharpness) - blurred * sharpness


def bilateral_denoise(img: torch.Tensor, strength: float, radius: int = 3,
                      sigma_space: float = 2.0) -> torch.Tensor:
    """The JAX package's edge-preserving stand-in for
    cv::fastNlMeansDenoisingColored: a bilateral filter as (2r + 1)^2
    shifted passes, the range weight from the channel mean, the range sigma
    2.5 x ``strength``. Shifts wrap around the frame (``torch.roll``, as
    ``jnp.roll``), not reflect. Each pass is ~8 small launches, ~400 at the
    default radius."""
    if strength <= 0:
        return img
    sigma_color = 2.5 * strength
    h2 = 2.0 * sigma_color * sigma_color
    s2 = 2.0 * sigma_space * sigma_space
    has_c = img.dim() == 3
    acc = torch.zeros_like(img)
    wacc = torch.zeros(img.shape[:2], dtype=img.dtype, device=img.device)
    ref = img.mean(dim=-1) if has_c else img
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            shifted = torch.roll(img, (-dy, -dx), dims=(0, 1))
            diff = torch.roll(ref, (-dy, -dx), dims=(0, 1)) - ref
            w = torch.exp(-(diff * diff) / h2 - (dy * dy + dx * dx) / s2)
            acc = acc + shifted * (w[..., None] if has_c else w)
            wacc = wacc + w
    wacc = torch.where(wacc > 0, wacc, torch.ones_like(wacc))
    return acc / (wacc[..., None] if has_c else wacc)
