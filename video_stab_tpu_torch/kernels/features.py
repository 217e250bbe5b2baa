"""K3: Shi-Tomasi corner response + 3x3 peak mask (csrc/features.cu).

Counterpart of ``video_stab_tpu/pallas/features.py:corner_response``, with
the semantics the JAX package's GFTT dispatches: ``min_eig_response``
(every stage reflect-101 on its own input) and ``resp >= _dilate3x3(resp)``
(neighbours wrap around the frame). Block size and aperture are 3.

Every function takes one (H, W) gray or N streams' (N, H, W) grays; K3
takes the N in one launch (the multi-stream step, ``parallel/``), and
``LAUNCHES`` counts launches, not frames.
"""

from __future__ import annotations

import torch

from video_stab_tpu_torch.kernels import _lib
from video_stab_tpu_torch.ops.filters import sep_filter2d, sobel

LAUNCHES = 0    # kernel launches since import (or the last reset)

# cv::cornerMinEigenVal's u8 normalization 1 / ((1 << (aperture-1)) *
# block_size * 255) at block = aperture = 3.
SCALE = 1.0 / (4 * 3 * 255.0)


def corner_response(gray: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(H, W) or (N, H, W) float32 u8-domain gray -> (resp float32, peak
    bool) of its shape. A CUDA tensor launches K3; a CPU tensor takes the
    plain version."""
    if gray.is_cuda:
        return corner_response_cuda(gray)
    if gray.device.type != "cpu":
        raise ValueError(f"corner_response: unsupported device {gray.device}")
    return corner_response_plain(gray)


def min_eig_response(gray: torch.Tensor, block_size: int = 3,
                     aperture: int = 3) -> torch.Tensor:
    """cv::cornerMinEigenVal: min eigenvalue of the structure tensor, with
    OpenCV's u8 normalization scale."""
    scale = 1.0 / ((1 << (aperture - 1)) * block_size * 255.0)
    gx, gy = sobel(gray, aperture)
    gx = gx * scale
    gy = gy * scale
    ones = tuple([1.0] * block_size)
    sxx = sep_filter2d(gx * gx, ones, ones)
    syy = sep_filter2d(gy * gy, ones, ones)
    sxy = sep_filter2d(gx * gy, ones, ones)
    half_tr = 0.5 * (sxx + syy)
    half_df = 0.5 * (sxx - syy)
    return half_tr - torch.sqrt(half_df * half_df + sxy * sxy)


def dilate3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 max over the last two dims, neighbours wrapping around the
    frame (jnp.roll)."""
    out = x
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if (dy, dx) != (0, 0):
                out = torch.maximum(out, torch.roll(x, (-dy, -dx), (-2, -1)))
    return out


def corner_response_plain(gray: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3 (any device)."""
    resp = min_eig_response(gray)
    return resp, resp >= dilate3x3(resp)


def corner_response_cuda(gray: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 on the current stream: one launch for all N frames, a
    warp per strip, for the response and the wrapped peak test."""
    global LAUNCHES
    _lib.require_cuda(gray, "corner_response gray", torch.float32, (2, 3))
    h, w = gray.shape[-2:]
    n = 1 if gray.dim() == 2 else gray.shape[0]
    resp = torch.empty(gray.shape, dtype=torch.float32, device=gray.device)
    peak = torch.empty(gray.shape, dtype=torch.bool, device=gray.device)
    if n == 0:
        return resp, peak
    rc = _lib.library().vs_corner_response_batched(
        gray.data_ptr(), n, h, w, SCALE, resp.data_ptr(), peak.data_ptr(),
        _lib.stream_handle(gray.device))
    _lib.check(rc, "corner_response")
    LAUNCHES += 1
    return resp, peak
