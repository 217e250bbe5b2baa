"""Multi-stream batched serving on one card — PyTorch port of
``video_stab_tpu/parallel/multistream.py``.

N independent streams (one per camera) advance in lockstep, one tick per
synchronized grab. The JAX package vmaps the single-stream step over a
leading stream axis and shards it over a device mesh; here the stream axis
is written out (``core/stabilizer.py`` ``batched_*_fn``): every stage of a
tick runs once for all N streams, so the corner response (K3), the LK
ladder (K6) and the emit warp (K1, or K2 for the homography model) are one
launch a tick each, not N; in upstream's drone mode conditional CLAHE, the
``motion_prediction`` prior, the HF chain and crop-and-zoom are each one
set of ops a tick for the N streams. One card holds all N streams: there
is no mesh.

The wrapper reads nothing back from the device in steady state: per-stream
readiness comes from host counters that mirror the device's, and the
re-detect tick is one host integer for the batch (the JAX package's
unbatched tick). The GFTT selection's convergence flag (once per
``NMS_ROUNDS_PER_SYNC`` rounds for the whole batch, ``ops/features.py``)
and, with the homography model, ``eigh`` and ``matrix_exp`` on (N, ...)
batches are the step's host reads, as many as one stream's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from video_stab_tpu_torch import pick_device
from video_stab_tpu_torch.core.params import ModeParams, StabilizerParams
from video_stab_tpu_torch.core.stabilizer import (
    batched_emit_gated_fn,
    batched_init_step_fn,
    batched_step_metrics_fn,
    check_supported_batched,
)
from video_stab_tpu_torch.core.state import (
    StabilizerState,
    _generator,
    batched_state_from_numpy,
    batched_state_to_numpy,
    stabilizer_state_init,
)
from video_stab_tpu_torch.models.deepstab import resolve_deepstab_weights
from video_stab_tpu_torch.motion.hf import HFState
from video_stab_tpu_torch.utils import hostcopy, telemetry

# RANSAC draws for a tick given the (N,) valid-point counts, or None:
# (N, K, 2) for the similarity model, (N, K, 4) for the homography model.
BatchedRansacDraws = Optional[Callable[[torch.Tensor], torch.Tensor]]


def batched_state_init(params: StabilizerParams, n_streams: int,
                       height: int, width: int,
                       device: Optional[torch.device] = None
                       ) -> StabilizerState:
    """The state of n_streams (height, width) streams on ``device`` (None:
    the card, through ``pick_device``, which raises without one; callers
    that want the CPU pass it): every tensor of a single stream's initial
    state with a leading N, the (N, Q, H, W, 3) frame ring allocated once,
    stream i's generator seeded with ``params.seed + i`` and, with deep
    stabilization, one network shared by the streams (the JAX package
    replicates its weights per stream)."""
    device = pick_device(True) if device is None else torch.device(device)
    one = stabilizer_state_init(params, height, width, device)

    def stack(t: torch.Tensor) -> torch.Tensor:
        return t.unsqueeze(0).expand(n_streams, *t.shape).clone()

    fields = {}
    for name in StabilizerState._fields:
        v = getattr(one, name)
        if name == "key":
            fields[name] = tuple(_generator(params.seed + i, device)
                                 for i in range(n_streams))
        elif name == "deepstab":
            fields[name] = resolve_deepstab_weights(params, device) \
                if params.deep_stabilization else ()
        elif name == "frame_ring":
            fields[name] = torch.zeros((n_streams,) + tuple(v.shape),
                                       dtype=v.dtype, device=device)
        elif name == "hf":
            fields[name] = HFState(*(stack(t) for t in v))
        else:
            fields[name] = stack(v)
    return StabilizerState(**fields)


def as_device_frames(frames, device: torch.device) -> torch.Tensor:
    """(N, H, W, 3) uint8 frames (numpy or a tensor) as a contiguous tensor
    on ``device``, uploaded by ``hostcopy.to_device``."""
    t = hostcopy.to_device(frames, device)
    if t.dim() != 4 or t.shape[-1] != 3:
        raise ValueError(f"expected (N, H, W, 3) frames, got "
                         f"{tuple(t.shape)}")
    return t.contiguous()


class MultiStreamStabilizer:
    """Batch-of-streams stabilizer: push (N, H, W, 3) uint8, get (N, H, W,
    3) stabilized frames once the shared look-ahead has filled.

    All N streams advance in lockstep (one synchronized grab per camera per
    tick); ``last_valid`` says which streams' outputs of the last tick are
    real frames (a freshly reset stream re-warms on its own). The device is
    picked once, from ``mode.use_cuda`` (default ``ModeParams()``: CUDA,
    raising without one). ``ransac_draws``: an optional callable given a
    tick's (N,) valid-point counts (a device tensor) that returns the
    (N, K, width) RANSAC draws of that tick, the hook through which parity
    tests feed the JAX package's own draws; without it stream i draws from
    its own generator (seed ``params.seed + i``), exactly what a single
    ``Stabilizer`` with that seed draws.

    Every ``StabilizerParams`` that ``check_supported_batched`` accepts
    runs; a host loop over single-stream steps is not a fallback."""

    def __init__(self, params: StabilizerParams, n_streams: int, *,
                 mode: Optional[ModeParams] = None,
                 ransac_draws: BatchedRansacDraws = None):
        check_supported_batched(params)
        self.params = params
        self.n_streams = n_streams
        self.device = pick_device((mode or ModeParams()).use_cuda)
        self.ransac_draws = ransac_draws
        self._state: Optional[StabilizerState] = None
        self._shape: Optional[tuple] = None
        # Host mirrors of each stream's (n_frames, emit_idx): the gate on
        # the device holds its cursors to exactly these values.
        self._frames_in = np.zeros(n_streams, np.int64)
        self._emitted = np.zeros(n_streams, np.int64)
        self.last_valid: Optional[np.ndarray] = None
        self.last_metrics: dict = {}
        self.last_out_device: Optional[torch.Tensor] = None

    def _ensure_state(self, frames: torch.Tensor) -> None:
        n, h, w = frames.shape[:3]
        if n != self.n_streams:
            raise ValueError(f"expected {self.n_streams} streams, got {n}")
        if self._state is None:
            self._state = batched_state_init(self.params, n, h, w,
                                             self.device)
            self._shape = (h, w)
        elif self._shape != (h, w):
            raise ValueError("frame size changed; call clean()")

    def stabilize_batch_device(self, frames) -> Optional[torch.Tensor]:
        """One tick for all N streams: (N, H, W, 3) uint8 in (numpy or a
        tensor), the (N, H, W, 3) device tensor out, or None while no
        stream is ready. No device->host read of its own (the GFTT NMS flag
        and the homography model's ``eigh`` / ``matrix_exp`` aside)."""
        with telemetry.trace("vstab.upload"):
            frames = as_device_frames(frames, self.device)
        with telemetry.trace("vstab.step"):
            self._ensure_state(frames)
            if not self._frames_in.any():
                self._state = batched_init_step_fn(self.params, self._state,
                                                   frames)
                self._frames_in[:] = 1
                return None
            self._state, out, _ready, self.last_metrics = \
                batched_step_metrics_fn(self.params, self._state, frames,
                                        int(self._frames_in.max()),
                                        ransac_draws=self.ransac_draws)
            self._frames_in += 1
            ready = (self._frames_in - self._emitted) >= \
                self.params.effective_radius
            self._emitted += ready
            self.last_valid = ready
            self.last_out_device = out
            if not ready.any():
                return None       # the whole batch is still warming up
            return out

    def stabilize_batch(self, frames) -> Optional[np.ndarray]:
        """``stabilize_batch_device`` with the output as numpy."""
        with telemetry.trace("vstab.tick"):
            out = self.stabilize_batch_device(frames)
            if out is None:
                return None
            with telemetry.trace("vstab.download"):
                return hostcopy.to_host(out)

    def flush_batch(self) -> Optional[np.ndarray]:
        """Drain one tick: the gate on the device releases only the streams
        whose queue still holds >= effective_radius frames, so the drain
        stops there (per stream; a single stream drains fully with
        ``Stabilizer.flush``)."""
        if self._state is None:
            return None
        ready = (self._frames_in - self._emitted) >= \
            self.params.effective_radius
        if not ready.any():
            return None
        self._state, out, _r = batched_emit_gated_fn(self.params,
                                                     self._state)
        self._emitted += ready
        self.last_valid = ready
        with telemetry.trace("vstab.download"):
            return hostcopy.to_host(out)

    def reset_stream(self, i: int) -> None:
        """Recycle slot i for a new stream (camera reconnect or swap): its
        slices of the state, its slots of the frame ring among them, are
        written in place with a fresh stream's values and its generator is
        re-seeded with ``params.seed + i``; the other streams are
        untouched. The fresh stream re-warms its own look-ahead while the
        batch keeps stepping, and re-detects on the batch's ticks. In drone
        mode its HF state and starvation counter start afresh, and the
        prior's inputs (its previous gray and points) are zero."""
        if self._state is None:
            return
        # Without a padded emit and the canvas (which the batched step
        # refuses) no field but the frame ring depends on the frame size,
        # so a 1 x 1 state is the fresh stream's.
        fresh = stabilizer_state_init(
            dataclasses.replace(self.params, seed=self.params.seed + i),
            1, 1, self.device)
        with torch.no_grad():
            for name in StabilizerState._fields:
                cur = getattr(self._state, name)
                if name == "key":
                    cur[i].manual_seed(self.params.seed + i)
                elif name == "frame_ring":
                    cur[i].zero_()
                elif name == "hf":
                    for t, f in zip(cur, getattr(fresh, name)):
                        t[i].copy_(f)
                elif isinstance(cur, torch.Tensor):
                    cur[i].copy_(getattr(fresh, name))
        self._frames_in[i] = 0
        self._emitted[i] = 0

    def state_dict(self) -> Optional[dict]:
        """The batched state as numpy arrays under the JAX package's field
        names (``core.state.batched_state_to_numpy``)."""
        return None if self._state is None else \
            batched_state_to_numpy(self._state)

    def load_state_dict(self, state, height: int, width: int) -> None:
        """Resume all streams from a batched numpy state tree: this class's
        ``state_dict()`` or the JAX package's batched state
        (``core.state.batched_state_from_numpy``). The host counters
        follow each stream's ``n_frames`` and ``emit_idx``."""
        st = batched_state_from_numpy(state, self.device)
        if st.n_frames.shape[0] != self.n_streams:
            raise ValueError(f"expected {self.n_streams} streams, got "
                             f"{st.n_frames.shape[0]}")
        if self.params.deep_stabilization and \
                not isinstance(st.deepstab, torch.nn.Module):
            st = st._replace(deepstab=resolve_deepstab_weights(
                self.params, self.device))
        self._state = st
        self._shape = (height, width)
        self._frames_in = st.n_frames.cpu().numpy().astype(np.int64)
        self._emitted = st.emit_idx.cpu().numpy().astype(np.int64)

    def clean(self) -> None:
        """Reset all streams."""
        self._state = None
        self._shape = None
        self._frames_in[:] = 0
        self._emitted[:] = 0
        self.last_valid = None
        self.last_metrics = {}
        self.last_out_device = None


def serve_remote_streams(server, stabilizer: MultiStreamStabilizer,
                         stream_ids: Sequence[int], n_ticks: int,
                         on_output=None, read_timeout: float = 2.0) -> dict:
    """The serving host's main loop: a frame server's fan-in coupled to the
    batched step. ``server`` is any object with ``read_batch(ids,
    timeout=)`` returning the lockstep (N, H, W, 3) batch, or None while
    not every stream has fed (``io.remote.RemoteFrameServer`` is one).

    Each tick one ``stabilize_batch`` call advances all N streams, and
    ``on_output(stream_id, frame)`` fires for every stream the warm-up gate
    released (``stabilizer.last_valid``). Returns counters: {"ticks",
    "emitted" (per-stream np array), "stalled_ticks" (read_batch returns
    before every stream fed)}."""
    ids = list(stream_ids)
    emitted = np.zeros(len(ids), np.int64)
    stalled = 0
    ticks = 0
    while ticks < n_ticks:
        batch = server.read_batch(ids, timeout=read_timeout)
        if batch is None:              # not every stream has fed yet
            stalled += 1
            if stalled > n_ticks + 100:
                break
            continue
        out = stabilizer.stabilize_batch(batch)
        ticks += 1
        if out is None:
            continue
        valid = stabilizer.last_valid
        for k, sid in enumerate(ids):
            if valid is not None and valid[k]:
                emitted[k] += 1
                if on_output is not None:
                    on_output(sid, out[k])
    return {"ticks": ticks, "emitted": emitted, "stalled_ticks": stalled}
