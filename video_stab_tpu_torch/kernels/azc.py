"""K7: auto zoom-crop's shrink loop in one launch, and K8: its content
mask in one launch (csrc/azc.cu).

``interior_rect_cuda`` finds the largest interior rectangle of a content
mask by iterative border shrinking, the loop of
``video_stab_tpu/core/autozoomcrop.py:interior_rect`` (a
``jax.lax.while_loop`` there), from the flat prefix table ``cum`` that
``core/autozoomcrop.py:interior_rect`` builds: per-row prefix sums of
the holes (h rows of w + 1) followed by per-column ones (w columns of
h + 1).

The loop: the rect starts at the first and last rows and columns that
hold content. An iteration counts the holes on the rect's four edges,
cl, ct, cr, cb (each edge clamped into the frame), as differences of two
table entries, and stops when no edge has a hole or the rect is empty
(x0 >= x1 or y0 >= y1). Else one edge moves inward by one, the one that
``_shrink``'s decision tree (checkInteriorExterior's) picks: top when
ct > cb, cl, cr; bottom when ct <= cb and cb > cl, cr; left when
cl >= cr, cb, ct; right when cl < cr and cr >= ct, cb. The tie rule:
where none of the four holds, every edge that has a hole moves. So each
iteration makes progress and the loop ends within h + w iterations, or
after ``max_iters``.

Exactness: every count, comparison and move is integer arithmetic on
the same table entries as the plain loop in ``core/autozoomcrop.py``
(``_edge_holes``, ``_shrink``), and the starting rect reads a row's (or
a column's) content from its hole total (fewer holes than its length),
which is the plain version's ``any``. So K7's rect equals the plain
loop's, and the JAX package's, bit for bit, for any ``max_iters``.

One launch, no host read: the loop runs on the card in one block (warp 0
iterates; the whole block finds the starting rect), and the rect stays
there. ``RECT_KERNEL_LAUNCHES`` counts K7 launches; each is also counted
as ``azc_rect_kernel`` by ``utils.telemetry.count``.

K8, ``content_mask_cuda``: the mask the loop's prefix table is built
from, ``morph_close(threshold_binary(bgr_to_gray(frame), thresh, 255),
ksize)`` of a float32 (H, W, 3) BGR frame (the plain version is
``core/autozoomcrop.py:content_mask_plain``), bit for bit: the gray's
products rounded to float32 and summed B, G, R, the threshold a float32
compare, the close's max and min exact on a 0 / 255 mask. The ellipse of
``ops/filters.py:_ellipse_offsets(ksize)`` is one run of dx per row dy,
passed to the kernel as its half-widths (``ellipse_half_widths``). Odd
ksize up to ``MASK_MAX_KSIZE``; every shipped config uses 5.
``MASK_KERNEL_LAUNCHES`` counts K8 launches; each is also counted as
``azc_mask_kernel`` by ``utils.telemetry.count``.
"""

from __future__ import annotations

import torch

from video_stab_tpu_torch.kernels import _lib
from video_stab_tpu_torch.ops.filters import _ellipse_offsets
from video_stab_tpu_torch.utils import telemetry

RECT_KERNEL_LAUNCHES = 0   # K7 launches since import (or the last reset)
MASK_KERNEL_LAUNCHES = 0   # K8 launches since import (or the last reset)
MASK_MAX_KSIZE = 15        # K8's largest ellipse (csrc/azc.cu: kMaskMaxR 7)

_INT32_MAX = 2 ** 31 - 1


def table_size(h: int, w: int) -> int:
    """Entries of the prefix table of an (h, w) mask."""
    return h * (w + 1) + w * (h + 1)


def interior_rect_cuda(cum: torch.Tensor, h: int, w: int, max_iters: int
                       ) -> torch.Tensor:
    """Launch K7 on the current stream: the (4,) int32 rect [x0, y0, x1,
    y1] (inclusive corners) on ``cum``'s device, after at most
    ``max_iters`` moves. Raises on a table that is not a contiguous CUDA
    int32 vector of ``table_size(h, w)`` entries."""
    global RECT_KERNEL_LAUNCHES
    _lib.require_cuda(cum, "interior_rect table", torch.int32, (1,))
    if h <= 0 or w <= 0 or cum.numel() != table_size(h, w):
        raise ValueError(f"interior_rect: a table of {cum.numel()} entries "
                         f"for a ({h}, {w}) mask (needs {table_size(h, w)})")
    if cum.numel() > _INT32_MAX:
        raise ValueError(f"interior_rect: ({h}, {w}) mask too large")
    if not -_INT32_MAX <= max_iters <= _INT32_MAX:
        raise ValueError(f"interior_rect: max_iters {max_iters} is not an "
                         f"int32")
    rect = torch.empty(4, dtype=torch.int32, device=cum.device)
    rc = _lib.library().vs_interior_rect(
        cum.data_ptr(), h, w, max_iters, rect.data_ptr(),
        _lib.stream_handle(cum.device))
    _lib.check(rc, "interior_rect")
    RECT_KERNEL_LAUNCHES += 1
    telemetry.count("azc_rect_kernel")
    return rect


def ellipse_half_widths(ksize: int) -> tuple[int, ...]:
    """The half-width of each row dy = -r .. r of the ellipse of
    ``_ellipse_offsets(ksize)``: the row's offsets are dx = -hw .. hw."""
    r = ksize // 2
    offs = _ellipse_offsets(ksize)
    return tuple(max(dx for ody, dx in offs if ody == dy)
                 for dy in range(-r, r + 1))


def content_mask_cuda(frame: torch.Tensor, thresh: float, ksize: int
                      ) -> torch.Tensor:
    """Launch K8 on the current stream: the (H, W) float32 0 / 255 content
    mask of the float32 (H, W, 3) BGR ``frame``, on its device. Raises on a
    frame that is not a contiguous CUDA float32 (H, W, 3) tensor, and on a
    ``ksize`` that is not odd in [1, MASK_MAX_KSIZE]."""
    global MASK_KERNEL_LAUNCHES
    if (int(ksize) != ksize or ksize % 2 == 0
            or not 1 <= ksize <= MASK_MAX_KSIZE):
        raise ValueError(f"content mask: ksize {ksize} is not odd in "
                         f"[1, {MASK_MAX_KSIZE}]")
    _lib.require_cuda(frame, "content mask frame", torch.float32, (3,))
    h, w, c = frame.shape
    if c != 3 or h == 0 or w == 0:
        raise ValueError(f"content mask: expected a non-empty (H, W, 3) "
                         f"frame, got {tuple(frame.shape)}")
    if max(h, w) > _INT32_MAX:
        raise ValueError(f"content mask: ({h}, {w}) frame too large")
    hw_bits = 0
    for row, hw in enumerate(ellipse_half_widths(int(ksize))):
        hw_bits |= hw << (4 * row)
    out = torch.empty((h, w), dtype=torch.float32, device=frame.device)
    rc = _lib.library().vs_content_mask(
        frame.data_ptr(), h, w, float(thresh), int(ksize) // 2, hw_bits,
        out.data_ptr(), _lib.stream_handle(frame.device))
    _lib.check(rc, "content_mask")
    MASK_KERNEL_LAUNCHES += 1
    telemetry.count("azc_mask_kernel")
    return out
