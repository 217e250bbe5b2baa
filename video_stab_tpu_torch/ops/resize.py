"""Bilinear resize and image pyramids.

Counterpart of ``video_stab_tpu/ops/resize.py``. The JAX package applies
each 1-D resampling as a dense (n_out, n_in) matmul, which is how a TPU's
matrix unit wants it. Here the same operator matrices are built once on the
host and applied as gathers of their few nonzero taps per output row, in
ascending source order — the order a matmul accumulates in, so the values
agree with the JAX package to float32 rounding.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from video_stab_tpu_torch.ops.filters import reflect_101_index


@functools.lru_cache(maxsize=128)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear interpolation matrix, OpenCV half-pixel
    centers (the JAX package's ``_resize_weights``)."""
    scale = n_in / n_out
    x = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    x0 = np.floor(x)
    frac = x - x0
    i0 = np.clip(x0.astype(np.int64), 0, n_in - 1)
    i1 = np.clip(x0.astype(np.int64) + 1, 0, n_in - 1)
    w = np.zeros((n_out, n_in), dtype=np.float32)
    rows = np.arange(n_out)
    np.add.at(w, (rows, i0), (1.0 - frac).astype(np.float32))
    np.add.at(w, (rows, i1), frac.astype(np.float32))
    return w


# cv::pyrDown 5-tap kernel (1 4 6 4 1)/16.
_PYR_K = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0


@functools.lru_cache(maxsize=128)
def _pyr_down_weights(n_in: int) -> np.ndarray:
    """(ceil(n/2), n_in) operator: 5-tap Gaussian, reflect-101 border,
    2x decimation (the JAX package's ``_pyr_down_weights``)."""
    n_out = (n_in + 1) // 2
    w = np.zeros((n_out, n_in), dtype=np.float32)
    for o in range(n_out):
        for t in range(-2, 3):
            w[o, reflect_101_index(2 * o + t, n_in)] += _PYR_K[t + 2]
    return w


@functools.lru_cache(maxsize=128)
def _taps(kind: str, n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """The operator's nonzero taps, ascending per row, padded with
    zero-weight taps at index 0: (n_out, k) int64 indices and f32 weights."""
    mat = _resize_weights(n_in, n_out) if kind == "resize" \
        else _pyr_down_weights(n_in)
    k = int((mat != 0).sum(axis=1).max())
    idx = np.zeros((n_out, k), np.int64)
    wts = np.zeros((n_out, k), np.float32)
    for o in range(n_out):
        nz = np.nonzero(mat[o])[0]
        idx[o, :len(nz)] = nz
        wts[o, :len(nz)] = mat[o, nz]
    return idx, wts


@functools.lru_cache(maxsize=256)
def _taps_on(kind: str, n_in: int, n_out: int, device: torch.device
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``_taps`` copied to ``device`` once (a per-call host->device copy
    from pageable memory would synchronize the stream)."""
    idx, wts = _taps(kind, n_in, n_out)
    return (torch.from_numpy(idx.T.copy()).to(device),       # (k, n_out)
            torch.from_numpy(wts.T.copy()).to(device))


def _apply(x: torch.Tensor, kind: str, n_out: int, dim: int) -> torch.Tensor:
    """Apply the operator along ``dim`` of x."""
    idx, wts = _taps_on(kind, x.shape[dim], n_out, x.device)
    shape = [1] * x.dim()
    shape[dim] = n_out
    out = None
    for t in range(idx.shape[0]):
        term = x.index_select(dim, idx[t]) * wts[t].view(shape)
        out = term if out is None else out + term
    return out


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of (..., H, W) or (..., H, W, C), C <= 4, to
    (out_h, out_w) — cv2.resize INTER_LINEAR float semantics."""
    has_channels = img.dim() >= 3 and img.shape[-1] in (1, 2, 3, 4)
    hd, wd = (-3, -2) if has_channels else (-2, -1)
    if (img.shape[hd], img.shape[wd]) == (out_h, out_w):
        return img
    x = img if img.dtype == torch.float32 else img.float()
    x = _apply(x, "resize", out_h, x.dim() + hd)
    return _apply(x, "resize", out_w, x.dim() + wd)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown: 5x5 Gaussian blur + 2x decimation of (..., H, W)."""
    x = _apply(img, "pyr", (img.shape[-2] + 1) // 2, img.dim() - 2)
    return _apply(x, "pyr", (img.shape[-1] + 1) // 2, img.dim() - 1)


def build_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """[img, pyrDown(img), ...] with ``levels + 1`` entries (OpenCV maxLevel)."""
    pyr = [img]
    for _ in range(levels):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def _two_taps(start: torch.Tensor, step: torch.Tensor, n_out: int,
              n_in: int, device: torch.device):
    """The two nonzero tent taps of each output row of the axis-aligned map
    src = start + o * step: (i0, i1) clamped indices and (w0, w1) weights,
    max(0, 1 - |src - i|) as the JAX package computes them, 0 for a tap
    outside [0, n_in)."""
    src = start + torch.arange(n_out, dtype=torch.float32,
                               device=device) * step
    i0 = torch.floor(src)
    ws, idx = [], []
    for i in (i0, i0 + 1.0):
        w = torch.clamp(1.0 - (src - i).abs(), min=0.0)
        inside = (i >= 0) & (i <= n_in - 1)
        ws.append(torch.where(inside, w, torch.zeros_like(w)))
        idx.append(torch.clamp(i, 0, n_in - 1).to(torch.int64))
    return idx, ws


def resample_axis_aligned(img: torch.Tensor, y0, sy, x0, sx,
                          out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear sampling of (H, W[, C]) at src = (x0 + x * sx, y0 + y * sy)
    with offsets and scales that may be device tensors (auto zoom-crop's
    data-dependent rect). Zero outside the image (BORDER_CONSTANT 0).

    The JAX package applies two dense (out, in) tent matrices, ~19 GFLOP a
    call at 1080p; only two taps of a row are nonzero and the others add
    exact zeros, so here each axis is a two-tap gather, rows first, then
    columns, as the einsums order them: the same values to float32
    rounding."""
    dev = img.device

    def scalar(v) -> torch.Tensor:
        # A Python number is filled on the device: a host-to-device copy of
        # it would wait for the stream.
        if isinstance(v, torch.Tensor):
            return v.to(torch.float32)
        return torch.full((), float(v), dtype=torch.float32, device=dev)

    x = img.float()
    (r0, r1), (a0, a1) = _two_taps(scalar(y0), scalar(sy), out_h,
                                   x.shape[0], dev)
    tail = (1,) * (x.dim() - 1)
    x = x.index_select(0, r0) * a0.view(-1, *tail) \
        + x.index_select(0, r1) * a1.view(-1, *tail)
    (c0, c1), (b0, b1) = _two_taps(scalar(x0), scalar(sx), out_w,
                                   x.shape[1], dev)
    tail = (1,) * (x.dim() - 2)
    return x.index_select(1, c0) * b0.view(1, -1, *tail) \
        + x.index_select(1, c1) * b1.view(1, -1, *tail)
