"""K5a / K5b: the trajectory box filters (csrc/traj.cu).

Counterparts of ``video_stab_tpu/pallas/traj.py``:

- ``box_filter_convolve`` (K5a): the reference's boxFilterConvolveCUDA.
  The path is padded with r copies of its upper median before it (and the
  median after it); out[i] = mean(padded[i .. i+r-1]), the mean of the r
  samples ending at i - 1. No production caller; kept 1:1 with the JAX
  package's kernel set.
- ``box_filter_centered`` (K5b): the window [i-r, i+r] clamped to the path
  and normalized by its true count, the identity when n <= r. The offline
  stabilizer's box smoother (``offline.py``).

Both are ONE launch over a (N,) or (N, C) float32 path: a block stages its
tile of rows and the window's halo in shared memory, the pad written into
the halo slots outside the path, and each thread sums one output's window
from there. The pad is a kernel argument: zero for K5b; for K5a a second
kernel of the same source computes each channel's upper median itself (by
rank counting, one block per channel holding that channel's whole path)
when the path has at most ``MEDIAN_MAX_ROWS`` rows, and above that the
wrapper sorts the path first (``torch.sort``, its own launches) and
passes the medians to the tiled kernel. The kernels and
the plain versions below add the window's samples in the same order and
normalize in the same expression order as the JAX kernel compiled by XLA
(which multiplies by the window's float32 reciprocal where the source
divides by it), so all three agree bit for bit.

``CONVOLVE_LAUNCHES`` counts K5a launches, ``CENTERED_LAUNCHES`` K5b
launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from video_stab_tpu_torch.kernels import _lib

CONVOLVE_LAUNCHES = 0   # K5a launches since import (or the last reset)
CENTERED_LAUNCHES = 0   # K5b launches since import (or the last reset)

THREADS = 96                # threads of a tile's block, one output each
MEDIAN_MAX_ROWS = 2048      # longest path whose median the kernel ranks
SMEM_MAX = 227 * 1024       # what a block on the H100 can be given


def _as_2d(path: torch.Tensor) -> torch.Tensor:
    if path.dim() not in (1, 2):
        raise ValueError(f"expected a (N,) or (N, C) path, got shape "
                         f"{tuple(path.shape)}")
    return path[:, None] if path.dim() == 1 else path


def _median_upper(p2: torch.Tensor) -> torch.Tensor:
    """Per-channel upper median, std::nth_element's (the JAX _median_upper):
    (C,) on p2's device."""
    return torch.sort(p2, dim=0).values[p2.shape[0] // 2]


def launch_config(n: int, c: int, window: int, median: bool
                  ) -> tuple[int, int, int, int]:
    """(blocks, threads, tile_rows, shared-memory bytes) of the launch for
    an (n, c) path. Tiled: a block of (c, ``THREADS // c``) threads owns
    that many rows and stages them with the window's halo. Median mode: one
    block per channel owns the channel's path, its sort keys (n rounded up
    to 4) and its median."""
    if median:
        n4 = (n + 3) // 4 * 4
        threads = min(1024, max(64, (n + 31) // 32 * 32))
        return c, threads, n, 4 * (n4 + 4 + n + window - 1)
    tile_rows = max(1, THREADS // c)
    floats = (tile_rows + window - 1) * c
    return -(-n // tile_rows), c * tile_rows, tile_rows, 4 * floats


def median_in_kernel(n: int) -> bool:
    """Whether K5a's launch computes the median pad itself for a path of n
    rows."""
    return n <= MEDIAN_MAX_ROWS


def _box_window_plain(p2: torch.Tensor, offset: int, window: int,
                      pad: torch.Tensor, r_centered: Optional[int]
                      ) -> torch.Tensor:
    """Plain PyTorch version of the windowed-sum kernel: padded = pad[:offset]
    ++ path ++ pad, out[i] = sum(padded[i .. i+window-1]) * (1 / window),
    summed in order; for the centered filter ``((out * window) / count)``.
    (1 / window in double rounds to the same float32 as the float32
    reciprocal for every window up to 2000.)"""
    n, c = p2.shape
    tail = max(window - 1 - offset, 0)
    padded = torch.cat([pad.expand(offset, c), p2, pad.expand(tail, c)])
    acc = torch.zeros_like(p2)
    for k in range(window):
        acc = acc + padded[k:k + n]
    out = acc * (1.0 / window)
    if r_centered is not None:
        r = r_centered
        idx = torch.arange(n, device=p2.device)
        count = (torch.clamp(idx + r, max=n - 1) - torch.clamp(idx - r, min=0)
                 + 1).to(p2.dtype)
        out = out * float(window) / count[:, None]
    return out


def _box_window_cuda(p2: torch.Tensor, offset: int, window: int,
                     pad: Optional[torch.Tensor], median: bool,
                     r_centered: Optional[int]) -> torch.Tensor:
    """Launch the windowed-sum kernel on the current stream. ``pad``: (C,)
    medians, or None for a zero pad or with ``median`` (the kernel's own)."""
    _lib.require_cuda(p2, "box filter path", torch.float32, (2,))
    n, c = p2.shape
    if n * c >= 2 ** 31 - 4 * c * window:
        raise ValueError(f"box filter: path {tuple(p2.shape)} too large")
    if pad is not None:
        _lib.require_cuda(pad, "box filter pad", torch.float32, (1,))
        if pad.numel() != c or pad.device != p2.device:
            raise ValueError(f"box filter: pad {tuple(pad.shape)} on "
                             f"{pad.device} for a path of {c} channels on "
                             f"{p2.device}")
    blocks, threads, tile_rows, smem = launch_config(n, c, window, median)
    if smem > SMEM_MAX or threads > 1024:
        raise ValueError(f"box filter: window {window} x {c} channels needs "
                         f"{smem} bytes of shared memory and {threads} "
                         f"threads a block (at most {SMEM_MAX} and 1024)")
    out = torch.empty_like(p2)
    rc = _lib.library().vs_box_window(
        p2.data_ptr(), n, c, offset, window,
        None if pad is None else pad.data_ptr(), int(median),
        int(r_centered is not None), r_centered or 0, blocks, threads,
        tile_rows, smem, out.data_ptr(), _lib.stream_handle(p2.device))
    _lib.check(rc, "box_window")
    return out


def _convolve_args(path: torch.Tensor, r: int):
    p2 = _as_2d(path).contiguous()
    return p2, r, r, _median_upper(p2).contiguous(), None


def _centered_args(path: torch.Tensor, r: int):
    p2 = _as_2d(path).contiguous()
    pad = torch.zeros(p2.shape[1], dtype=p2.dtype, device=p2.device)
    return p2, r, 2 * r + 1, pad, r


def _shaped(out: torch.Tensor, path: torch.Tensor) -> torch.Tensor:
    return out[:, 0] if path.dim() == 1 else out


def box_filter_convolve(path: torch.Tensor, r: int) -> torch.Tensor:
    """K5a: boxFilterConvolveCUDA semantics over a (N,) or (N, C) float32
    path. A CUDA path launches the kernel; a CPU path takes the plain
    version."""
    if path.is_cuda:
        return box_filter_convolve_cuda(path, r)
    if path.device.type != "cpu":
        raise ValueError(f"box_filter_convolve: unsupported device "
                         f"{path.device}")
    return box_filter_convolve_plain(path, r)


def box_filter_convolve_plain(path: torch.Tensor, r: int) -> torch.Tensor:
    """Plain PyTorch version of K5a (any device)."""
    if r <= 0:
        return path
    return _shaped(_box_window_plain(*_convolve_args(path, r)), path)


def box_filter_convolve_cuda(path: torch.Tensor, r: int) -> torch.Tensor:
    """Launch K5a on the current stream: one launch, the median pad
    computed inside it, for a path of at most ``MEDIAN_MAX_ROWS`` = 2048
    rows (any C: a block per channel ranks its n samples against each
    other, n^2 comparisons, ~30 us of one SM at 2048). A longer path is
    sorted on the device first (``torch.sort``: launches of its own before
    the kernel's one)."""
    global CONVOLVE_LAUNCHES
    if r <= 0:
        return path
    p2 = _as_2d(path).contiguous()
    if median_in_kernel(p2.shape[0]):
        out = _box_window_cuda(p2, r, r, None, True, None)
    else:
        out = _box_window_cuda(p2, r, r, _median_upper(p2).contiguous(),
                               False, None)
    CONVOLVE_LAUNCHES += 1
    return _shaped(out, path)


def box_filter_centered(path: torch.Tensor, r: int) -> torch.Tensor:
    """K5b: centered, count-normalized box filter over a (N,) or (N, C)
    float32 path: window [i-r, i+r] clamped to the path; the identity when
    n <= r. A CUDA path launches the kernel; a CPU path takes the plain
    version."""
    if path.is_cuda:
        return box_filter_centered_cuda(path, r)
    if path.device.type != "cpu":
        raise ValueError(f"box_filter_centered: unsupported device "
                         f"{path.device}")
    return box_filter_centered_plain(path, r)


def box_filter_centered_plain(path: torch.Tensor, r: int) -> torch.Tensor:
    """Plain PyTorch version of K5b (any device)."""
    if r <= 0 or path.shape[0] <= r:
        return path
    return _shaped(_box_window_plain(*_centered_args(path, r)), path)


def box_filter_centered_cuda(path: torch.Tensor, r: int) -> torch.Tensor:
    """Launch K5b on the current stream (no launch when n <= r, where the
    filter is the identity)."""
    global CENTERED_LAUNCHES
    if r <= 0 or path.shape[0] <= r:
        return path
    out = _box_window_cuda(_as_2d(path).contiguous(), r, 2 * r + 1, None,
                           False, r)
    CENTERED_LAUNCHES += 1
    return _shaped(out, path)
