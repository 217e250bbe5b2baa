"""Color conversions with OpenCV value conventions (u8 domain, BGR order).

Counterpart of ``video_stab_tpu/ops/color.py`` for the slice's two
functions. Float tensors carry u8-scaled values ([0, 255]).
"""

from __future__ import annotations

import torch

# OpenCV ITU-R BT.601 luma weights (B, G, R order).
_GRAY_W = (0.114, 0.587, 0.299)


def saturate_u8(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, clamp to [0, 255], uint8 — what ``jnp.round``
    (and so the JAX package's ``saturate_u8``) computes. No-op for u8."""
    if x.dtype == torch.uint8:
        return x
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) BGR -> (..., H, W) gray, BT.601 weights like
    cv::COLOR_BGR2GRAY. Summed B, G, R in that order, each product rounded
    to float32 — the order the enhance kernel (csrc/enhance.cu) uses."""
    w0, w1, w2 = _GRAY_W
    return (bgr[..., 0] * w0 + bgr[..., 1] * w1) + bgr[..., 2] * w2
