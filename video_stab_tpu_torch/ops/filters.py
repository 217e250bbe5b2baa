"""Separable filtering: Sobel and Scharr derivatives.

Counterpart of the slice's part of ``video_stab_tpu/ops/filters.py``. The
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
    xp = F.pad(xt.reshape(1, -1, n), (p, p), mode="reflect").reshape(
        *lead, n + 2 * p)
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
