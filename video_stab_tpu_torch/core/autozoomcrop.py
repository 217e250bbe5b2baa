"""Auto zoom-crop — port of ``video_stab_tpu/core/autozoomcrop.py``.

Removes the black corners a roll rotation leaves: a content mask
(gray, threshold, morphological close), the largest interior rectangle by
iterative border shrinking, re-centred to the frame's aspect ratio, then
the crop and the resize as one axis-aligned resample
(``ops/resize.py:resample_axis_aligned``), output size static.

``interior_rect`` is a ``jax.lax.while_loop`` of up to h + w iterations in
the JAX package. On the card it is one launch of K7 (``kernels/azc.py``,
``csrc/azc.cu``), which runs the whole loop there and reads nothing back
(``kernels.azc.RECT_KERNEL_LAUNCHES`` and the telemetry counter
``azc_rect_kernel`` count its launches). On the CPU it runs as the plain
version, ``interior_rect_plain``: chunks of ``RECT_CHUNK`` masked
iterations, where an iteration moves the rectangle only while the loop's
condition holds, and a finished rectangle stays put, so any number of
extra iterations leaves the JAX result. After each chunk the host reads
one "still shrinking" flag (``RECT_READS`` and the telemetry counter
``azc_rect_reads`` count those reads of the plain version, each inside a
``vstab.azc_read`` span).

The content mask, ``content_mask``, is on the card one launch of K8
(``kernels/azc.py``, ``csrc/azc.cu``; ``kernels.azc.MASK_KERNEL_LAUNCHES``
and the telemetry counter ``azc_mask_kernel``), and on the CPU the plain
composition, ``content_mask_plain``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from video_stab_tpu_torch import pick_device
from video_stab_tpu_torch.core.params import AutoZoomCropParams
from video_stab_tpu_torch.kernels import azc as kazc
from video_stab_tpu_torch.ops.color import bgr_to_gray, saturate_u8
from video_stab_tpu_torch.ops.filters import morph_close, threshold_binary
from video_stab_tpu_torch.ops.resize import resample_axis_aligned
from video_stab_tpu_torch.utils import hostcopy, telemetry

RECT_CHUNK = 32   # masked shrink iterations between two host reads
RECT_READS = 0    # host reads the plain version has made since import


def _edge_holes(cum: torch.Tensor, rect: torch.Tensor, h: int, w: int
                ) -> torch.Tensor:
    """Holes on the rect's four edges, in rect order (left, top, right,
    bottom): from the flat table ``cum`` of per-row prefix sums (h rows of
    w + 1) followed by per-column ones (w columns of h + 1). Integers, so
    exactly the JAX package's masked float sums."""
    x0, y0 = rect[0].clamp(0, w - 1), rect[1].clamp(0, h - 1)
    x1, y1 = rect[2].clamp(0, w - 1), rect[3].clamp(0, h - 1)
    col = h * (w + 1)
    idx = torch.stack([
        col + x0 * (h + 1) + y1 + 1, col + x0 * (h + 1) + y0,      # left
        y0 * (w + 1) + x1 + 1, y0 * (w + 1) + x0,                  # top
        col + x1 * (h + 1) + y1 + 1, col + x1 * (h + 1) + y0,      # right
        y1 * (w + 1) + x1 + 1, y1 * (w + 1) + x0])                 # bottom
    v = cum[idx.to(torch.int64)]
    return v[0::2] - v[1::2]


def _shrink(cum: torch.Tensor, rect: torch.Tensor, h: int, w: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One masked iteration of the shrink loop (checkInteriorExterior):
    -> (the new rect, whether the loop's condition held)."""
    cl, ct, cr, cb = _edge_holes(cum, rect, h, w)
    total = cl + ct + cr + cb
    go = (total > 0) & (rect[0] < rect[2]) & (rect[1] < rect[3])
    top = (ct > cb) & (ct > cl) & (ct > cr)
    bottom = ~(ct > cb) & (cb > cl) & (cb > cr)
    left = (cl >= cr) & (cl >= cb) & (cl >= ct)
    right = ~(cl >= cr) & (cr >= ct) & (cr >= cb)
    # Guarantee progress when the counts tie everywhere.
    tie = ~(top | bottom | left | right) & (total > 0)
    move = torch.stack([left | (tie & (cl > 0)), top | (tie & (ct > 0)),
                        right | (tie & (cr > 0)), bottom | (tie & (cb > 0))])
    # +1 for x0 and y0, -1 for x1 and y1 (by arithmetic: a tensor from a
    # list would be a host-to-device copy, which waits for the stream).
    sign = 1 - 2 * (torch.arange(4, dtype=torch.int32, device=rect.device)
                    >= 2).to(torch.int32)
    return rect + torch.where(go & move, sign, torch.zeros_like(sign)), go


def _prefix_table(content: torch.Tensor) -> torch.Tensor:
    """The flat int32 table of hole counts that the shrink loop reads:
    per-row prefix sums (h rows of w + 1, each from 0), then per-column
    ones (w columns of h + 1)."""
    h, w = content.shape
    dev = content.device
    holes = (~content).to(torch.int32)
    zero_col = torch.zeros((h, 1), dtype=torch.int32, device=dev)
    zero_row = torch.zeros((w, 1), dtype=torch.int32, device=dev)
    return torch.cat([
        torch.cat([zero_col, holes.cumsum(1, dtype=torch.int32)], 1)
        .reshape(-1),
        torch.cat([zero_row, holes.t().cumsum(1, dtype=torch.int32)], 1)
        .reshape(-1)])


def interior_rect(mask: torch.Tensor, max_iters: Optional[int] = None,
                  ) -> torch.Tensor:
    """Largest interior rectangle of a binary content mask (H, W) float
    (0 / > 0) by iterative border shrinking: (4,) int32 [x0, y0, x1, y1],
    inclusive corners, on the mask's device, after at most ``max_iters``
    moves (None: h + w, the whole loop). A CUDA mask: one launch of K7, no
    host read. Else the plain version, ``interior_rect_plain``."""
    if not mask.is_cuda:
        return interior_rect_plain(mask, max_iters)
    h, w = mask.shape
    return kazc.interior_rect_cuda(_prefix_table(mask > 0), h, w,
                                   h + w if max_iters is None else max_iters)


def interior_rect_plain(mask: torch.Tensor, max_iters: Optional[int] = None,
                        ) -> torch.Tensor:
    """Plain PyTorch version of ``interior_rect`` (any device): chunks of
    ``RECT_CHUNK`` masked iterations, one host read after each."""
    global RECT_READS
    h, w = mask.shape
    dev = mask.device
    content = mask > 0
    any_row, any_col = content.any(dim=1), content.any(dim=0)
    ys = torch.arange(h, dtype=torch.int32, device=dev)
    xs = torch.arange(w, dtype=torch.int32, device=dev)
    rect = torch.stack([
        torch.where(any_col, xs, torch.full_like(xs, w)).min(),
        torch.where(any_row, ys, torch.full_like(ys, h)).min(),
        torch.where(any_col, xs, torch.full_like(xs, -1)).max(),
        torch.where(any_row, ys, torch.full_like(ys, -1)).max()])
    cum = _prefix_table(content)
    if max_iters is None:
        max_iters = h + w
    done = 0
    while done < max_iters:
        for _ in range(min(RECT_CHUNK, max_iters - done)):
            rect, _go = _shrink(cum, rect, h, w)
        done += RECT_CHUNK
        RECT_READS += 1
        telemetry.count("azc_rect_reads")
        with telemetry.trace("vstab.azc_read"):
            shrinking = bool(_shrink(cum, rect, h, w)[1])
        if not shrinking:
            break
    return rect


def content_mask(frame: torch.Tensor, thresh: float, ksize: int
                 ) -> torch.Tensor:
    """The content mask of a float32 (H, W, 3) BGR frame: (H, W) float32,
    255 where the gray's threshold at ``thresh``, closed by the ``ksize``
    ellipse, is set, else 0. A CUDA frame: one launch of K8. Else the
    plain version, ``content_mask_plain``."""
    if not frame.is_cuda:
        return content_mask_plain(frame, thresh, ksize)
    return kazc.content_mask_cuda(frame.contiguous(), thresh, ksize)


def content_mask_plain(frame: torch.Tensor, thresh: float, ksize: int
                       ) -> torch.Tensor:
    """Plain PyTorch version of ``content_mask`` (any device)."""
    return morph_close(threshold_binary(bgr_to_gray(frame), thresh, 255.0),
                       ksize)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d with d on x's device: a true division on CUDA too (a CPU
    scalar divisor becomes a multiply by its reciprocal there)."""
    return x / torch.full((), float(d), device=x.device)


def auto_zoom_crop_f32(params: AutoZoomCropParams, frame: torch.Tensor,
                       keep_input_size: Optional[bool] = None
                       ) -> torch.Tensor:
    """Auto zoom-crop of one float32 (H, W, 3) frame, float out: (H, W, 3)
    with ``keep_input_size``, else (out_height, out_width, 3)."""
    h, w = frame.shape[:2]
    if keep_input_size is None:
        keep_input_size = params.keep_input_size
    content = content_mask(frame, params.content_threshold,
                           params.morph_kernel)
    rect = interior_rect(content)
    x0 = rect[0].to(torch.float32)
    y0 = rect[1].to(torch.float32)
    rw = torch.clamp((rect[2] - rect[0]).to(torch.float32), min=1.0)
    rh = torch.clamp((rect[3] - rect[1]).to(torch.float32), min=1.0)

    # Re-centre to the original aspect ratio.
    new_w = rh * (w / h)
    nx0 = (x0 + rw * 0.5) - new_w * 0.5
    nx0 = torch.minimum(torch.clamp(nx0, min=0.0),
                        torch.clamp(w - new_w, min=0.0))
    new_w = torch.clamp(new_w, max=float(w))

    out_h = h if keep_input_size else params.out_height
    out_w = w if keep_input_size else params.out_width
    out = resample_axis_aligned(frame, y0, _div(rh, out_h), nx0,
                                _div(new_w, out_w), out_h, out_w)
    # No content: the frame resized whole (the reference returns it).
    fallback = resample_axis_aligned(
        frame, 0.0, float(np.float32(h / out_h)), 0.0,
        float(np.float32(w / out_w)), out_h, out_w)
    return torch.where((content > 0).any(), out, fallback)


def auto_zoom_crop_step(params: AutoZoomCropParams, frame_u8: torch.Tensor
                        ) -> torch.Tensor:
    """Auto zoom-crop of one u8 frame, u8 out."""
    return saturate_u8(auto_zoom_crop_f32(params, frame_u8.float()))


class AutoZoomCrop:
    """vs::AutoZoomCrop: ``auto_zoom_crop(frame)`` on u8 frames.

    ``device``: where frames are processed (None: CUDA, raising without a
    card)."""

    def __init__(self, params: Optional[AutoZoomCropParams] = None, *,
                 device=None, **kw):
        if params is None:
            params = AutoZoomCropParams(**kw)
        elif kw:
            raise ValueError("pass either params or keyword overrides")
        self.params = params
        self.device = pick_device(True) if device is None \
            else torch.device(device)

    def auto_zoom_crop(self, frame) -> np.ndarray:
        return _azc_np(self.params, frame, self.device)

    @staticmethod
    def apply(frame, params: Optional[AutoZoomCropParams] = None,
              device=None) -> np.ndarray:
        dev = pick_device(True) if device is None else torch.device(device)
        return _azc_np(params or AutoZoomCropParams(), frame, dev)


def _azc_np(params: AutoZoomCropParams, frame, device: torch.device
            ) -> np.ndarray:
    return hostcopy.to_host(auto_zoom_crop_step(
        params, hostcopy.to_device(frame, device)))


__all__ = ["AutoZoomCrop", "auto_zoom_crop_f32", "auto_zoom_crop_step",
           "content_mask", "content_mask_plain", "interior_rect",
           "interior_rect_plain"]
