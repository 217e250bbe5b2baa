"""Image enhancer — PyTorch port of ``video_stab_tpu/core/enhancer.py``.

The chain, in the JAX package's order: white balance, contrast/brightness,
CLAHE on Lab-L, vibrance in HSV, unsharp masking, bilateral denoising,
gamma. ``enhance_frame_u8`` is the streaming route from a u8 frame to a u8
frame: with the pointwise stages only, one pass of K4; with any of the four
filters on, K4's head mode (u8 -> f32: white balance, contrast/brightness),
the filters as PyTorch ops in float, then K4's tail mode (gamma, the
saturation to u8 and the gray of the unsaturated frame). ``enhance_frame``
is the float-to-float chain on a CPU tensor, the plain reference of that
route.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from video_stab_tpu_torch import pick_device
from video_stab_tpu_torch.core.params import EnhancerParams
from video_stab_tpu_torch.kernels.enhance import (
    enhance_head,
    enhance_pointwise,
    enhance_tail,
    enhance_u8,
    white_balance_scales,
)
from video_stab_tpu_torch.ops.color import (
    bgr_to_hsv,
    bgr_to_lab,
    hsv_to_bgr,
    lab_to_bgr,
)
from video_stab_tpu_torch.ops.filters import (
    bilateral_denoise,
    clahe,
    unsharp_mask,
)
from video_stab_tpu_torch.utils import hostcopy


def vibrance(img: torch.Tensor, strength: float) -> torch.Tensor:
    """HSV saturation boost s += a * (255 - s), clipped."""
    hsv = bgr_to_hsv(img)
    s = torch.clamp(hsv[..., 1] + strength * (255.0 - hsv[..., 1]),
                    0.0, 255.0)
    return hsv_to_bgr(torch.stack([hsv[..., 0], s, hsv[..., 2]], dim=-1))


def clahe_lab(img: torch.Tensor, clip_limit: float, tile_grid: int
              ) -> torch.Tensor:
    """CLAHE on the Lab L channel."""
    lab = bgr_to_lab(img)
    l_eq = clahe(lab[..., 0], clip_limit=clip_limit, tile_grid=tile_grid)
    return lab_to_bgr(torch.stack([l_eq, lab[..., 1], lab[..., 2]], dim=-1))


def has_filters(params: EnhancerParams) -> bool:
    """Whether a stage between the pointwise ones runs (CLAHE, vibrance,
    unsharp masking, denoising), which takes the head/tail route."""
    return (params.enable_clahe or params.enable_vibrance
            or (params.enable_unsharp and params.sharpness > 0.0)
            or (params.enable_denoise and params.denoise_strength > 0.0))


def _filters(params: EnhancerParams, x: torch.Tensor) -> torch.Tensor:
    """The stages between contrast/brightness and gamma, on a float frame."""
    if params.enable_clahe:
        x = clahe_lab(x, params.clahe_clip_limit, params.clahe_tile_grid_size)
    if params.enable_vibrance:
        x = vibrance(x, params.vibrance_strength)
    if params.enable_unsharp and params.sharpness > 0.0:
        x = unsharp_mask(x, params.sharpness, params.blur_sigma)
    if params.enable_denoise and params.denoise_strength > 0.0:
        x = bilateral_denoise(x, params.denoise_strength)
    return x


def enhance_frame(params: EnhancerParams, img: torch.Tensor) -> torch.Tensor:
    """The full chain on an f32 u8-domain BGR frame (float out), all plain
    PyTorch: the reference the K4 route is held to. CPU tensors only — on
    the card the route is ``enhance_frame_u8``."""
    if img.is_cuda:
        raise ValueError("enhance_frame is the plain float chain: on CUDA "
                         "use enhance_frame_u8 (K4)")
    wb = white_balance_scales(img, params.wb_strength) \
        if params.enable_white_balance else None
    x = enhance_pointwise(dataclasses.replace(params, gamma=1.0), img, wb)
    x = _filters(params, x)
    return enhance_pointwise(
        dataclasses.replace(params, contrast=1.0, brightness=0.0), x, None)


def enhance_frame_u8(params: EnhancerParams, frame_u8: torch.Tensor,
                     want_gray: bool = False
                     ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``saturate_u8(enhance_frame(params, frame))``, plus the gray of the
    unsaturated result when ``want_gray``: one K4 pass for the pointwise
    stages alone, else K4 head -> the filters -> K4 tail."""
    if not has_filters(params):
        return enhance_u8(params, frame_u8, want_gray)
    x = _filters(params, enhance_head(params, frame_u8))
    return enhance_tail(params, x, want_gray)


class Enhancer:
    """vs::Enhancer::enhanceImage: u8 frames in, u8 frames out.

    ``device``: where frames are processed (None: CUDA, raising without a
    card). ``EnhancerParams.use_cuda`` is ignored, as the JAX package
    ignores it: it does not pick the device."""

    def __init__(self, params: Optional[EnhancerParams] = None, *,
                 device=None, **kw):
        if params is None:
            params = EnhancerParams(**kw)
        elif kw:
            raise ValueError("pass either params or keyword overrides")
        self.params = params
        self.device = pick_device(True) if device is None \
            else torch.device(device)

    def enhance(self, frame) -> np.ndarray:
        return _enhance_np(self.params, frame, self.device)

    @staticmethod
    def enhance_image(frame, params: EnhancerParams, device=None
                      ) -> np.ndarray:
        """Mirror of the reference's static API."""
        dev = pick_device(True) if device is None else torch.device(device)
        return _enhance_np(params, frame, dev)


def _enhance_np(params: EnhancerParams, frame, device: torch.device
                ) -> np.ndarray:
    out, _ = enhance_frame_u8(params, hostcopy.to_device(frame, device))
    return hostcopy.to_host(out)


__all__ = ["Enhancer", "clahe_lab", "enhance_frame", "enhance_frame_u8",
           "has_filters", "vibrance"]
