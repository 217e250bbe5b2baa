"""Every frame's copy between the host and the card.

The per-frame wrappers (``Stabilizer``, ``ProcessingChain``,
``MultiStreamStabilizer``, ``LegacyStabilizer``, ``Enhancer``,
``RollCorrection``, ``AutoZoomCrop``) upload and download their frames
here and nowhere else. On a CUDA device both directions go through
page-locked blocks of torch's caching host allocator, so each copy is one
DMA at the link's rate:

- ``to_device`` copies the caller's frame (numpy or a CPU tensor, any
  strides) into a pinned staging block with one host copy and starts the
  upload without waiting for it. The allocator records the copy's event on
  the block and hands the block out again only after the DMA has read it,
  so the caller may overwrite its frame as soon as the call returns.
- ``to_host`` copies into a pinned block of its own and returns a numpy
  view of it. The array owns the block through the tensor it views: every
  call returns a fresh array that nothing else writes, and the block goes
  back to the allocator's cache (same size, no new ``cudaHostAlloc``) when
  the caller drops the array.
- ``start_to_host`` starts that copy on the device's side stream, after
  the work queued so far, and returns at once; ``Download.numpy()`` waits
  for the copy's event. A fresh block a call, as ``to_host``'s, so a
  caller may keep every frame it is handed (``ProcessingChain``'s
  pipelined mode).

On any other device they are exactly ``.to(device)`` and
``.cpu().numpy()``. Counters (``telemetry.count``): ``pinned_uploads``,
``pinned_downloads`` (both downloads), ``pinned_bytes`` (both
directions), and ``pageable_copies``, a copy on a CUDA device taken
through pageable memory because no pinned block could be had.

Not copied here: ``offline.py``'s whole clip, which stays pageable on
purpose (a pinned block of 240 frames of 1080p, ~1.5 GB, would stay in
the host cache for the life of the process), state serialisation
(``core/state.py``, ``utils/checkpoint.py``,
``MultiStreamStabilizer.load_state_dict``) and the tracker's detection
outputs: none of them is a frame.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from video_stab_tpu_torch.utils import telemetry

# One copy stream a CUDA device, made on first use.
_side_streams: dict = {}


def _pinned(shape, dtype: torch.dtype):
    """A page-locked host tensor, or None (counted) where none can be had."""
    try:
        return torch.empty(shape, dtype=dtype, pin_memory=True)
    except RuntimeError:
        telemetry.count("pageable_copies")
        return None


def to_device(x, device: torch.device) -> torch.Tensor:
    """``x`` (numpy or a tensor, any strides) as a uint8 tensor on
    ``device``; the caller may reuse ``x`` as soon as this returns."""
    if isinstance(x, torch.Tensor):
        if device.type != "cuda" or x.is_cuda:
            return x.to(device=device, dtype=torch.uint8)
        src = x
    elif device.type != "cuda":
        return torch.from_numpy(
            np.ascontiguousarray(x, dtype=np.uint8)).to(device)
    else:
        # torch.from_numpy takes any non-negative strides: the one host
        # copy below reads the caller's layout directly.
        a = np.asarray(x)
        if a.dtype != np.uint8 or min(a.strides, default=0) < 0:
            a = np.ascontiguousarray(a, dtype=np.uint8)
        src = torch.from_numpy(a)
    staging = _pinned(src.shape, torch.uint8)
    if staging is None:
        return src.to(device=device, dtype=torch.uint8)
    staging.copy_(src)
    telemetry.count("pinned_uploads")
    telemetry.count("pinned_bytes", staging.nbytes)
    return staging.to(device, non_blocking=True)


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array, once the work that writes it has ended; on
    a CUDA device an array of its own in page-locked memory."""
    if t.device.type != "cuda":
        return t.cpu().numpy()
    host = _pinned(t.shape, t.dtype)
    if host is None:
        return t.cpu().numpy()
    # A blocking copy: the DMA into the page-locked block, then the
    # stream's synchronize inside copy_, which torch's sync debug mode
    # attributes to this line (a Stream.synchronize() call would be
    # attributed to torch's own file).
    host.copy_(t)
    telemetry.count("pinned_downloads")
    telemetry.count("pinned_bytes", host.nbytes)
    return host.numpy()


class Download(NamedTuple):
    """A device frame on its way to the host; ``numpy()`` waits for it.
    Made from ``tensor`` alone (no copy started), ``numpy()`` is
    ``to_host(tensor)``."""

    tensor: torch.Tensor
    host: Optional[torch.Tensor] = None
    copied: Optional[torch.cuda.Event] = None

    def numpy(self) -> np.ndarray:
        if self.host is None:
            return to_host(self.tensor)
        self.copied.synchronize()
        return self.host.numpy()


def start_to_host(t: torch.Tensor) -> Download:
    """Start ``t``'s copy into a page-locked block of its own on the
    device's side stream, after the work queued so far."""
    if t.device.type != "cuda":
        return Download(t)
    host = _pinned(t.shape, t.dtype)
    if host is None:
        return Download(t)
    side = _side_streams.get(t.device)
    if side is None:
        side = _side_streams[t.device] = torch.cuda.Stream(t.device)
    side.wait_stream(torch.cuda.current_stream(t.device))
    with torch.cuda.stream(side):
        host.copy_(t, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
    # The allocator may reuse t's memory only after the copy.
    t.record_stream(side)
    telemetry.count("pinned_downloads")
    telemetry.count("pinned_bytes", host.nbytes)
    return Download(t, host, copied)
