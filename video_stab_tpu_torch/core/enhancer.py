"""Image enhancer — PyTorch port of ``video_stab_tpu/core/enhancer.py`` for
the pointwise subset: white balance, contrast/brightness and gamma. The
streaming path runs them as one pass of K4 (``enhance_frame_u8``);
``enhance_frame`` is the float-to-float chain the JAX package defines.
CLAHE, vibrance, unsharp masking and denoising raise
``NotImplementedError`` (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

from typing import Optional

import torch

from video_stab_tpu_torch.core.params import EnhancerParams
from video_stab_tpu_torch.kernels.enhance import (
    enhance_pointwise,
    enhance_u8,
    white_balance_scales,
)


def check_supported(params: EnhancerParams) -> None:
    todo = [name for name, on in (
        ("enable_clahe", params.enable_clahe),
        ("enable_vibrance", params.enable_vibrance),
        ("enable_unsharp", params.enable_unsharp and params.sharpness > 0.0),
        ("enable_denoise", params.enable_denoise
         and params.denoise_strength > 0.0)) if on]
    if todo:
        raise NotImplementedError(
            f"not ported to video_stab_tpu_torch yet: {', '.join(todo)} "
            "(ROADMAP queue 1 item 8)")


def enhance_frame(params: EnhancerParams, img: torch.Tensor) -> torch.Tensor:
    """The pointwise chain on an f32 u8-domain BGR frame (float out)."""
    check_supported(params)
    wb = white_balance_scales(img, params.wb_strength) \
        if params.enable_white_balance else None
    return enhance_pointwise(params, img, wb)


def enhance_frame_u8(params: EnhancerParams, frame_u8: torch.Tensor,
                     want_gray: bool = False
                     ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``saturate_u8(enhance_frame(params, frame))`` in one pass (K4 on
    CUDA), plus the gray of the unsaturated result when ``want_gray``."""
    check_supported(params)
    return enhance_u8(params, frame_u8, want_gray)
