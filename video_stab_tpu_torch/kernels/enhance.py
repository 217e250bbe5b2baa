"""K4: the enhancer's pointwise pass, u8 -> u8 (csrc/enhance.cu).

Counterpart of ``video_stab_tpu/pallas/enhance.py:enhance_pointwise``,
fused with the frame's u8 -> f32 cast before it and the ``saturate_u8``
after it. It can also return the BT.601 gray of the enhanced (unsaturated)
frame, which the fused chain's roll estimate and analysis resize read.

The kernel evaluates the pointwise stages once per u8 value and channel,
into a table, and looks every pixel up in it.
"""

from __future__ import annotations

from typing import Optional

import torch

from video_stab_tpu_torch.kernels import _lib
from video_stab_tpu_torch.ops.color import bgr_to_gray, saturate_u8

LAUNCHES = 0    # kernel launches since import (or the last reset)


def _stages(params) -> tuple[bool, bool]:
    """Which of contrast/brightness and gamma run — the conditions of
    ``enhance_frame``."""
    return (params.contrast != 1.0 or params.brightness != 0.0,
            abs(params.gamma - 1.0) > 1e-3)


def white_balance_scales(frame: torch.Tensor, strength: float
                         ) -> torch.Tensor:
    """(3,) gray-world scales of a (H, W, 3) frame (whiteBalanceCPU): a
    reduction on the frame's device, before the pointwise pass."""
    means = frame.float().mean(dim=(0, 1))
    gray = means.mean()
    scales = gray / (means + 1e-6)
    return 1.0 + strength * (scales - 1.0)


def enhance_u8(params, frame_u8: torch.Tensor, want_gray: bool = False
               ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Enhance a (H, W, 3) u8 BGR frame with ``params`` (an EnhancerParams
    with CLAHE, vibrance, unsharp and denoise off). Returns (u8 frame,
    float32 gray of the unsaturated result or None). A CUDA tensor launches
    K4; a CPU tensor takes the plain version."""
    wb = white_balance_scales(frame_u8, params.wb_strength) \
        if params.enable_white_balance else None
    if frame_u8.is_cuda:
        return enhance_u8_cuda(params, frame_u8, wb, want_gray)
    if frame_u8.device.type != "cpu":
        raise ValueError(f"enhance_u8: unsupported device {frame_u8.device}")
    return enhance_u8_plain(params, frame_u8, wb, want_gray)


def enhance_pointwise(params, x: torch.Tensor, wb: Optional[torch.Tensor]
                      ) -> torch.Tensor:
    """The pointwise stages on a float32 u8-domain (H, W, 3) frame, in
    ``enhance_frame``'s order: white-balance scales ``wb`` (or None),
    contrast/brightness, gamma."""
    do_cb, do_gamma = _stages(params)
    if wb is not None:
        x = x * wb
    if do_cb:
        x = torch.clamp(x * params.contrast + params.brightness, 0.0, 255.0)
    if do_gamma:
        # A tensor divisor keeps this a true division on CUDA too (a CPU
        # scalar divisor becomes a multiply by its reciprocal there).
        denom = torch.full((), 255.0, device=x.device)
        x = torch.pow(torch.clamp(x, 0.0, 255.0) / denom, params.gamma) \
            * 255.0
    return x


def enhance_u8_plain(params, frame_u8: torch.Tensor,
                     wb: Optional[torch.Tensor], want_gray: bool = False
                     ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of K4 (any device)."""
    x = enhance_pointwise(params, frame_u8.float(), wb)
    return saturate_u8(x), (bgr_to_gray(x) if want_gray else None)


def enhance_u8_cuda(params, frame_u8: torch.Tensor,
                    wb: Optional[torch.Tensor], want_gray: bool = False
                    ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch K4 on the current stream."""
    global LAUNCHES
    _lib.require_cuda(frame_u8, "enhance_u8 frame", torch.uint8, (3,))
    if frame_u8.shape[2] != 3:
        raise ValueError(f"enhance_u8: expected (H, W, 3), got "
                         f"{tuple(frame_u8.shape)}")
    if wb is not None:
        _lib.require_cuda(wb, "enhance_u8 wb", torch.float32, (1,))
    do_cb, do_gamma = _stages(params)
    h, w, _ = frame_u8.shape
    out = torch.empty_like(frame_u8)
    gray = torch.empty((h, w), dtype=torch.float32, device=frame_u8.device) \
        if want_gray else None
    rc = _lib.library().vs_enhance_u8(
        frame_u8.data_ptr(), out.data_ptr(),
        gray.data_ptr() if gray is not None else None, h * w,
        wb.data_ptr() if wb is not None else None, int(do_cb),
        float(params.contrast), float(params.brightness), int(do_gamma),
        float(params.gamma), _lib.stream_handle(frame_u8.device))
    _lib.check(rc, "enhance_u8")
    LAUNCHES += 1
    return out, gray
