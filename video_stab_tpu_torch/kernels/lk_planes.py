"""K9: the planes LK's ladder reads, one launch a pyramid level
(csrc/lk_planes.cu).

``lk_planes_cuda`` computes exactly ``ops/lk.py:lk_planes_plain(prev,
curr, max_level)`` for (H, W) or (N, H, W) float32 grays on the card: per
level l = 0 .. max_level the prev stack ``bf16([prev_l, scharr_x(prev_l),
scharr_y(prev_l)])`` as (..., 3, Hl, Wl) and the curr plane
``bf16(curr_l)`` as (..., Hl, Wl), each level after the first the
``pyr_down`` of the one before. A launch handles one level of both grays
and every stream; below the top level it also writes the unrounded level
to a scratch buffer that the next launch reads, so a call is
``max_level + 1`` launches and no host read.

Exactness: ``pyr_down`` uses the plain version's own operator table
(``ops/resize.py:_taps_on("pyr", ...)``), products rounded to float32 and
summed in tap order; Scharr is ``sep_filter2d``'s order, H then W,
reflect-101, the zero middle tap included; the rounding is to bfloat16,
nearest even. So every plane equals the plain version's bit for bit.

``PLANES_LAUNCHES`` counts K9 launches; each is also counted as
``lk_planes_kernel`` by ``utils.telemetry.count``.
"""

from __future__ import annotations

import torch

from video_stab_tpu_torch.kernels import _lib
from video_stab_tpu_torch.kernels.lk import MAX_LEVEL
from video_stab_tpu_torch.ops.resize import _taps_on
from video_stab_tpu_torch.utils import telemetry

PLANES_LAUNCHES = 0   # K9 launches since import (or the last reset)

_INT32_MAX = 2 ** 31 - 1


def lk_planes_cuda(prev_gray: torch.Tensor, curr_gray: torch.Tensor,
                   max_level: int
                   ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Launch K9 on the current stream, once a level: the planes of
    ``lk_planes_plain``. Raises on grays that are not contiguous, non-empty
    CUDA float32 (H, W) or (N, H, W) tensors of one shape on one device,
    and on a ``max_level`` outside [0, MAX_LEVEL] (K6 takes 1 to
    MAX_LEVEL + 1 levels)."""
    global PLANES_LAUNCHES
    if int(max_level) != max_level or not 0 <= max_level <= MAX_LEVEL:
        raise ValueError(f"lk_planes: max_level {max_level}; K9 takes 0 to "
                         f"{MAX_LEVEL} ({MAX_LEVEL + 1} levels)")
    _lib.require_cuda(prev_gray, "lk_planes prev gray", torch.float32, (2, 3))
    _lib.require_cuda(curr_gray, "lk_planes curr gray", torch.float32, (2, 3))
    if prev_gray.shape != curr_gray.shape or prev_gray.numel() == 0:
        raise ValueError(f"lk_planes: grays {tuple(prev_gray.shape)} and "
                         f"{tuple(curr_gray.shape)}; K9 takes two non-empty "
                         f"grays of one shape")
    if prev_gray.device != curr_gray.device:
        raise ValueError("lk_planes: grays on different devices")
    if prev_gray.numel() > _INT32_MAX:
        raise ValueError(f"lk_planes: {tuple(prev_gray.shape)} too large")
    dev = prev_gray.device
    lead = tuple(prev_gray.shape[:-2])
    n = lead[0] if lead else 1
    hs, ws = prev_gray.shape[-2:]
    lib = _lib.library()
    stream = _lib.stream_handle(dev)
    # The pointers a launch reads: the grays, then the scratch buffer the
    # launch before wrote (``scratches`` holds each until the call returns,
    # after every launch that reads it is queued).
    src = (prev_gray.data_ptr(), curr_gray.data_ptr())
    scratches = []
    prev_planes, curr_planes = [], []
    for level in range(int(max_level) + 1):
        down = level > 0
        hl, wl = ((hs + 1) // 2, (ws + 1) // 2) if down else (hs, ws)
        p_out = torch.empty((*lead, 3, hl, wl), dtype=torch.float32,
                            device=dev)
        c_out = torch.empty((*lead, hl, wl), dtype=torch.float32, device=dev)
        nxt = (None, None)
        if down and level < max_level:
            scratches.append(torch.empty((2, n, hl, wl), dtype=torch.float32,
                                         device=dev))
            base = scratches[-1].data_ptr()
            nxt = (base, base + 4 * n * hl * wl)
        tables = (None, None, 0, None, None, 0)
        if down:
            idx_h, w_h = _taps_on("pyr", hs, hl, dev)
            idx_w, w_w = _taps_on("pyr", ws, wl, dev)
            tables = (idx_h.data_ptr(), w_h.data_ptr(), idx_h.shape[0],
                      idx_w.data_ptr(), w_w.data_ptr(), idx_w.shape[0])
        rc = lib.vs_lk_planes(src[0], src[1], n, hs, ws, hl, wl, int(down),
                              *tables, p_out.data_ptr(), c_out.data_ptr(),
                              nxt[0], nxt[1], stream)
        _lib.check(rc, "lk_planes")
        PLANES_LAUNCHES += 1
        telemetry.count("lk_planes_kernel")
        prev_planes.append(p_out)
        curr_planes.append(c_out)
        if down:
            src = nxt
        hs, ws = hl, wl
    return prev_planes, curr_planes
