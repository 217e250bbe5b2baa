"""K4: the enhancer's pointwise pass, u8 -> u8 (csrc/enhance.cu).

Counterpart of ``video_stab_tpu/pallas/enhance.py:enhance_pointwise``,
fused with the frame's u8 -> f32 cast before it and the ``saturate_u8``
after it. It can also return the BT.601 gray of the enhanced (unsaturated)
frame, which the fused chain's roll estimate and analysis resize read.

The kernel evaluates the pointwise stages once per u8 value and channel,
into a table, and looks every pixel up in it.

Two more modes of K4 serve the enhancer when CLAHE, vibrance, unsharp
masking or denoising run between the pointwise stages: ``enhance_head``
(u8 -> f32: white balance and contrast/brightness) and ``enhance_tail``
(f32 -> u8: gamma and ``saturate_u8``, plus the gray of the unsaturated
result). ``LAUNCHES``, ``HEAD_LAUNCHES`` and ``TAIL_LAUNCHES`` count the
three modes' launches. The tail divides by 255 with a product and one FMA
correction, not the IEEE divide; ``chip_smoke.py`` holds it to
``enhance_tail_plain``, a true division, bit for bit over every float32
in [0, 255].
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from video_stab_tpu_torch.kernels import _lib
from video_stab_tpu_torch.ops.color import bgr_to_gray, saturate_u8

LAUNCHES = 0        # u8 -> u8 launches since import (or the last reset)
HEAD_LAUNCHES = 0   # head-mode launches
TAIL_LAUNCHES = 0   # tail-mode launches


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
    _check_frame(frame_u8, "enhance_u8 frame", torch.uint8, wb)
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


def enhance_head(params, frame_u8: torch.Tensor) -> torch.Tensor:
    """White balance and contrast/brightness of a (H, W, 3) u8 frame, as
    float32 (gamma and saturation are the tail's). A CUDA tensor launches
    K4's head mode; a CPU tensor takes the plain version."""
    wb = white_balance_scales(frame_u8, params.wb_strength) \
        if params.enable_white_balance else None
    if frame_u8.is_cuda:
        return enhance_head_cuda(params, frame_u8, wb)
    if frame_u8.device.type != "cpu":
        raise ValueError(f"enhance_head: unsupported device {frame_u8.device}")
    return enhance_head_plain(params, frame_u8, wb)


def enhance_head_plain(params, frame_u8: torch.Tensor,
                       wb: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of K4's head mode (any device): the pointwise
    stages with gamma off."""
    return enhance_pointwise(dataclasses.replace(params, gamma=1.0),
                             frame_u8.float(), wb)


def enhance_head_cuda(params, frame_u8: torch.Tensor,
                      wb: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch K4's head mode on the current stream."""
    global HEAD_LAUNCHES
    _check_frame(frame_u8, "enhance_head frame", torch.uint8, wb)
    h, w, _ = frame_u8.shape
    out = torch.empty((h, w, 3), dtype=torch.float32, device=frame_u8.device)
    do_cb, _ = _stages(params)
    rc = _lib.library().vs_enhance_head(
        frame_u8.data_ptr(), out.data_ptr(), h * w,
        wb.data_ptr() if wb is not None else None, int(do_cb),
        float(params.contrast), float(params.brightness),
        _lib.stream_handle(frame_u8.device))
    _lib.check(rc, "enhance_head")
    HEAD_LAUNCHES += 1
    return out


def enhance_tail(params, x: torch.Tensor, want_gray: bool = False
                 ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Gamma (when on) and ``saturate_u8`` of a float32 (H, W, 3) frame,
    plus the gray of the unsaturated result when ``want_gray``. A CUDA
    tensor launches K4's tail mode; a CPU tensor takes the plain version."""
    if x.is_cuda:
        return enhance_tail_cuda(params, x, want_gray)
    if x.device.type != "cpu":
        raise ValueError(f"enhance_tail: unsupported device {x.device}")
    return enhance_tail_plain(params, x, want_gray)


def enhance_tail_plain(params, x: torch.Tensor, want_gray: bool = False
                       ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of K4's tail mode (any device): the pointwise
    stages with contrast/brightness off and no white balance."""
    x = enhance_pointwise(
        dataclasses.replace(params, contrast=1.0, brightness=0.0), x, None)
    return saturate_u8(x), (bgr_to_gray(x) if want_gray else None)


def enhance_tail_cuda(params, x: torch.Tensor, want_gray: bool = False
                      ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch K4's tail mode on the current stream."""
    global TAIL_LAUNCHES
    _check_frame(x, "enhance_tail frame", torch.float32, None)
    h, w, _ = x.shape
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=x.device)
    gray = torch.empty((h, w), dtype=torch.float32, device=x.device) \
        if want_gray else None
    _, do_gamma = _stages(params)
    rc = _lib.library().vs_enhance_tail(
        x.data_ptr(), out.data_ptr(),
        gray.data_ptr() if gray is not None else None, h * w, int(do_gamma),
        float(params.gamma), _lib.stream_handle(x.device))
    _lib.check(rc, "enhance_tail")
    TAIL_LAUNCHES += 1
    return out, gray


def _check_frame(frame: torch.Tensor, name: str, dtype: torch.dtype,
                 wb: Optional[torch.Tensor]) -> None:
    _lib.require_cuda(frame, name, dtype, (3,))
    if frame.shape[2] != 3:
        raise ValueError(f"{name}: expected (H, W, 3), got "
                         f"{tuple(frame.shape)}")
    if wb is not None:
        _lib.require_cuda(wb, f"{name} wb", torch.float32, (1,))
