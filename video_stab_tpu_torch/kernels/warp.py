"""K1: the affine warp and K2: the projective warp, u8 HWC -> u8 HWC
(csrc/warp.cu).

Counterparts of ``video_stab_tpu/pallas/warp.py:warp_affine_u8`` and
``warp_homography_u8``. The kernels read the inverse matrix from device
memory, so a frame's matrix never crosses to the host. The TPU kernel's
envelope, tier ladder and tile pick have no counterpart: the CUDA kernels
are exact bilinear for any affine or projective map, where the JAX path
clamps outside its static envelope. K2 computes what the JAX CPU path
(``ops/warp.py:warp_perspective``) computes, rounded and clipped to u8.
Both are one kernel template (border mode, channels and map kind chosen
per launch); in the 3-channel affine kernel, where a warp's row of output
maps inside the source, it reads the taps without index maps
(``tests/test_torch_warp_tiles.py`` holds that rule against the per-pixel
coordinates).

``warp_affine_u8_batched`` / ``warp_homography_u8_batched`` warp N
streams' queued frames in one launch, each stream's frame read in place
from the (N, Q, H, W, C) frame ring at a device slot table (the
multi-stream emit, ``parallel/``).

``LAUNCHES`` counts K1 launches, ``HOMOGRAPHY_LAUNCHES`` K2 launches, one
per launch whatever its number of streams.
"""

from __future__ import annotations

from typing import Optional

import torch

from video_stab_tpu_torch.kernels import _lib
from video_stab_tpu_torch.ops.warp import (
    BORDER_CONSTANT,
    affine_coords,
    invert_affine,
    invert_homography,
    perspective_coords,
    sample_bilinear,
)

LAUNCHES = 0               # K1 launches since import (or the last reset)
HOMOGRAPHY_LAUNCHES = 0    # K2 launches since import (or the last reset)


def warp_affine_u8(img: torch.Tensor, m: torch.Tensor,
                   out_h: Optional[int] = None, out_w: Optional[int] = None,
                   border_mode: int = BORDER_CONSTANT,
                   border_value: float = 0.0,
                   inverse_map: bool = False) -> torch.Tensor:
    """Affine warp of a u8 (H, W) or (H, W, C) image, C in {1, 3}:
    dst(x, y) = src(M^-1 (x, y)), bilinear, rounded half to even.

    m: (2, 3) forward map (the inverse when ``inverse_map``), a float
    tensor on img's device; the inverse is taken by torch ops there. A CUDA
    image launches K1; a CPU image takes the plain version."""
    out_h = out_h if out_h is not None else img.shape[0]
    out_w = out_w if out_w is not None else img.shape[1]
    m = m.to(torch.float32)
    minv = (m if inverse_map else invert_affine(m)).reshape(6)
    if img.is_cuda:
        return warp_affine_u8_cuda(img, minv, out_h, out_w, border_mode,
                                   border_value)
    if img.device.type != "cpu":
        raise ValueError(f"warp_affine_u8: unsupported device {img.device}")
    return warp_affine_u8_plain(img, minv, out_h, out_w, border_mode,
                                border_value)


def warp_affine_u8_plain(img: torch.Tensor, minv: torch.Tensor, out_h: int,
                         out_w: int, border_mode: int = BORDER_CONSTANT,
                         border_value: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of K1 (any device): the exact gather warp of
    ``ops/warp.py`` with the same float32 arithmetic, then round half to
    even and clip. minv: the (6,) inverse map."""
    sx, sy = affine_coords(minv.reshape(2, 3), out_h, out_w)
    out = sample_bilinear(img, sx, sy, border_mode, border_value)
    return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)


def _launch(fn_name: str, n_minv: int, img: torch.Tensor,
            minv: torch.Tensor, out_h: int, out_w: int, border_mode: int,
            border_value: float) -> torch.Tensor:
    """Check the inputs, allocate the output and launch one warp kernel on
    the current stream."""
    name = fn_name.removeprefix("vs_")
    _lib.require_cuda(img, f"{name} img", torch.uint8, (2, 3))
    _lib.require_cuda(minv, f"{name} minv", torch.float32, (1,))
    ch = 1 if img.dim() == 2 else img.shape[2]
    if ch not in (1, 3) or minv.numel() != n_minv \
            or minv.device != img.device:
        raise ValueError(f"{name}: bad shapes img {tuple(img.shape)} "
                         f"minv {tuple(minv.shape)} on {minv.device}")
    if border_mode not in range(5):
        raise ValueError(f"{name}: unknown border mode {border_mode}")
    h, w = img.shape[:2]
    shape = (out_h, out_w) if img.dim() == 2 else (out_h, out_w, ch)
    out = torch.empty(shape, dtype=torch.uint8, device=img.device)
    rc = getattr(_lib.library(), fn_name)(
        img.data_ptr(), h, w, ch, out.data_ptr(), out_h, out_w,
        minv.data_ptr(), border_mode, float(border_value),
        _lib.stream_handle(img.device))
    _lib.check(rc, name)
    return out


def warp_affine_u8_cuda(img: torch.Tensor, minv: torch.Tensor, out_h: int,
                        out_w: int, border_mode: int = BORDER_CONSTANT,
                        border_value: float = 0.0) -> torch.Tensor:
    """Launch K1 on the current stream. minv: (6,) float32 inverse map on
    img's device."""
    global LAUNCHES
    out = _launch("vs_warp_affine_u8", 6, img, minv, out_h, out_w,
                  border_mode, border_value)
    LAUNCHES += 1
    return out


def warp_homography_u8(img: torch.Tensor, h_mat: torch.Tensor,
                       out_h: Optional[int] = None,
                       out_w: Optional[int] = None,
                       border_mode: int = BORDER_CONSTANT,
                       border_value: float = 0.0,
                       inverse_map: bool = False) -> torch.Tensor:
    """Projective warp of a u8 (H, W) or (H, W, C) image, C in {1, 3}:
    dst(x, y) = src(H^-1 (x, y)), bilinear, rounded half to even.

    h_mat: (3, 3) forward homography (the inverse when ``inverse_map``), a
    float tensor on img's device; the inverse is taken by torch ops there
    (adjugate / determinant, no host read). A CUDA image launches K2; a CPU
    image takes the plain version."""
    out_h = out_h if out_h is not None else img.shape[0]
    out_w = out_w if out_w is not None else img.shape[1]
    h_mat = h_mat.to(torch.float32)
    hinv = (h_mat if inverse_map else invert_homography(h_mat)).reshape(9)
    if img.is_cuda:
        return warp_homography_u8_cuda(img, hinv.contiguous(), out_h, out_w,
                                       border_mode, border_value)
    if img.device.type != "cpu":
        raise ValueError(f"warp_homography_u8: unsupported device "
                         f"{img.device}")
    return warp_homography_u8_plain(img, hinv, out_h, out_w, border_mode,
                                    border_value)


def warp_homography_u8_plain(img: torch.Tensor, hinv: torch.Tensor,
                             out_h: int, out_w: int,
                             border_mode: int = BORDER_CONSTANT,
                             border_value: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of K2 (any device): the gather warp of
    ``ops/warp.py:warp_perspective`` with the same float32 arithmetic, then
    round half to even and clip. hinv: the (9,) row-major inverse map."""
    sx, sy = perspective_coords(hinv.reshape(3, 3), out_h, out_w)
    out = sample_bilinear(img, sx, sy, border_mode, border_value)
    return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)


def warp_homography_u8_cuda(img: torch.Tensor, hinv: torch.Tensor,
                            out_h: int, out_w: int,
                            border_mode: int = BORDER_CONSTANT,
                            border_value: float = 0.0) -> torch.Tensor:
    """Launch K2 on the current stream. hinv: (9,) float32 row-major inverse
    homography on img's device."""
    global HOMOGRAPHY_LAUNCHES
    out = _launch("vs_warp_homography_u8", 9, img, hinv, out_h, out_w,
                  border_mode, border_value)
    HOMOGRAPHY_LAUNCHES += 1
    return out


def _ring_frames(ring: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Stream b's frame ``ring[b, slots[b]]`` of an (N, Q, H, W[, C]) ring,
    gathered by torch ops on the ring's device (no host read)."""
    q = ring.shape[1]
    flat = torch.arange(ring.shape[0], device=ring.device) * q \
        + slots.to(device=ring.device, dtype=torch.int64)
    return ring.reshape(-1, *ring.shape[2:]).index_select(0, flat)


def warp_affine_u8_batched(ring: torch.Tensor, slots: torch.Tensor,
                           m: torch.Tensor, out_h: Optional[int] = None,
                           out_w: Optional[int] = None,
                           border_mode: int = BORDER_CONSTANT,
                           border_value: float = 0.0,
                           inverse_map: bool = False) -> torch.Tensor:
    """K1 for N streams: stream b's output is ``warp_affine_u8(ring[b,
    slots[b]], m[b])``. ring: (N, Q, H, W[, C]) u8; slots: (N,) int32 ring
    slots on the ring's device; m: (N, 2, 3) forward maps (the inverses
    when ``inverse_map``). Returns (N, out_h, out_w[, C]) u8. A CUDA ring
    launches K1 once for all N; a CPU ring takes the plain version."""
    out_h = out_h if out_h is not None else ring.shape[2]
    out_w = out_w if out_w is not None else ring.shape[3]
    m = m.to(torch.float32)
    minv = (m if inverse_map else invert_affine(m)).reshape(-1, 6)
    if ring.is_cuda:
        return warp_affine_u8_batched_cuda(ring, slots, minv.contiguous(),
                                           out_h, out_w, border_mode,
                                           border_value)
    if ring.device.type != "cpu":
        raise ValueError(f"warp_affine_u8_batched: unsupported device "
                         f"{ring.device}")
    return warp_affine_u8_batched_plain(ring, slots, minv, out_h, out_w,
                                        border_mode, border_value)


def warp_affine_u8_batched_plain(ring: torch.Tensor, slots: torch.Tensor,
                                 minv: torch.Tensor, out_h: int, out_w: int,
                                 border_mode: int = BORDER_CONSTANT,
                                 border_value: float = 0.0) -> torch.Tensor:
    """Plain version of the batched K1 (any device): the single plain
    version per stream, stacked. minv: (N, 6)."""
    frames = _ring_frames(ring, slots)
    return torch.stack([warp_affine_u8_plain(f, mi, out_h, out_w,
                                             border_mode, border_value)
                        for f, mi in zip(frames, minv)])


def _launch_batched(fn_name: str, n_minv: int, ring: torch.Tensor,
                    slots: torch.Tensor, minv: torch.Tensor, out_h: int,
                    out_w: int, border_mode: int,
                    border_value: float) -> torch.Tensor:
    """Check the inputs, allocate the (N, out_h, out_w[, C]) output and
    launch one batched warp kernel on the current stream."""
    name = fn_name.removeprefix("vs_")
    _lib.require_cuda(ring, f"{name} ring", torch.uint8, (4, 5))
    _lib.require_cuda(slots, f"{name} slots", torch.int32, (1,))
    _lib.require_cuda(minv, f"{name} minv", torch.float32, (2,))
    n, q, h, w = ring.shape[:4]
    ch = 1 if ring.dim() == 4 else ring.shape[4]
    if ch not in (1, 3) or tuple(minv.shape) != (n, n_minv) \
            or slots.shape[0] != n or slots.device != ring.device \
            or minv.device != ring.device:
        raise ValueError(f"{name}: bad shapes ring {tuple(ring.shape)} "
                         f"slots {tuple(slots.shape)} minv "
                         f"{tuple(minv.shape)}")
    if border_mode not in range(5):
        raise ValueError(f"{name}: unknown border mode {border_mode}")
    shape = (n, out_h, out_w) if ring.dim() == 4 else (n, out_h, out_w, ch)
    out = torch.empty(shape, dtype=torch.uint8, device=ring.device)
    rc = getattr(_lib.library(), fn_name)(
        ring.data_ptr(), n, q, slots.data_ptr(), h, w, ch, out.data_ptr(),
        out_h, out_w, minv.data_ptr(), border_mode, float(border_value),
        _lib.stream_handle(ring.device))
    _lib.check(rc, name)
    return out


def warp_affine_u8_batched_cuda(ring: torch.Tensor, slots: torch.Tensor,
                                minv: torch.Tensor, out_h: int, out_w: int,
                                border_mode: int = BORDER_CONSTANT,
                                border_value: float = 0.0) -> torch.Tensor:
    """Launch K1 once for N streams on the current stream. minv: (N, 6)
    float32 inverse maps on the ring's device."""
    global LAUNCHES
    out = _launch_batched("vs_warp_affine_u8_batched", 6, ring, slots, minv,
                          out_h, out_w, border_mode, border_value)
    LAUNCHES += 1
    return out


def warp_homography_u8_batched(ring: torch.Tensor, slots: torch.Tensor,
                               h_mat: torch.Tensor,
                               out_h: Optional[int] = None,
                               out_w: Optional[int] = None,
                               border_mode: int = BORDER_CONSTANT,
                               border_value: float = 0.0,
                               inverse_map: bool = False) -> torch.Tensor:
    """K2 for N streams, as ``warp_affine_u8_batched`` with (N, 3, 3)
    homographies. A CUDA ring launches K2 once for all N; a CPU ring takes
    the plain version."""
    out_h = out_h if out_h is not None else ring.shape[2]
    out_w = out_w if out_w is not None else ring.shape[3]
    h_mat = h_mat.to(torch.float32)
    hinv = (h_mat if inverse_map else invert_homography(h_mat)).reshape(-1, 9)
    if ring.is_cuda:
        return warp_homography_u8_batched_cuda(ring, slots, hinv.contiguous(),
                                               out_h, out_w, border_mode,
                                               border_value)
    if ring.device.type != "cpu":
        raise ValueError(f"warp_homography_u8_batched: unsupported device "
                         f"{ring.device}")
    return warp_homography_u8_batched_plain(ring, slots, hinv, out_h, out_w,
                                            border_mode, border_value)


def warp_homography_u8_batched_plain(ring: torch.Tensor, slots: torch.Tensor,
                                     hinv: torch.Tensor, out_h: int,
                                     out_w: int,
                                     border_mode: int = BORDER_CONSTANT,
                                     border_value: float = 0.0
                                     ) -> torch.Tensor:
    """Plain version of the batched K2 (any device): the single plain
    version per stream, stacked. hinv: (N, 9)."""
    frames = _ring_frames(ring, slots)
    return torch.stack([warp_homography_u8_plain(f, hi, out_h, out_w,
                                                 border_mode, border_value)
                        for f, hi in zip(frames, hinv)])


def warp_homography_u8_batched_cuda(ring: torch.Tensor, slots: torch.Tensor,
                                    hinv: torch.Tensor, out_h: int,
                                    out_w: int,
                                    border_mode: int = BORDER_CONSTANT,
                                    border_value: float = 0.0
                                    ) -> torch.Tensor:
    """Launch K2 once for N streams on the current stream. hinv: (N, 9)
    float32 row-major inverse homographies on the ring's device."""
    global HOMOGRAPHY_LAUNCHES
    out = _launch_batched("vs_warp_homography_u8_batched", 9, ring, slots,
                          hinv, out_h, out_w, border_mode, border_value)
    HOMOGRAPHY_LAUNCHES += 1
    return out
