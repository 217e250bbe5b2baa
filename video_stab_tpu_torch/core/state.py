"""Streaming state of the stabilizer, field for field with
``video_stab_tpu/core/state.py``.

All fields are tensors on the stream's device, ``hf`` a tuple of them (the
drone high-frequency chain's ``motion.hf.HFState``), except ``key``: the
stream's ``torch.Generator`` (the JAX package's PRNG key), seeded from
``params.seed``. It draws RANSAC's hypotheses; JAX's own draws cannot be
reproduced by it, so callers that need the JAX package's estimates inject
those draws instead (``Stabilizer(ransac_draws=...)``).

``state_from_numpy`` / ``state_to_numpy`` convert between this state and
the JAX package's ``StabilizerState`` as a tree of numpy arrays (what its
``Stabilizer.state_dict()`` returns). The port's own tree has two entries
more, ``key_state`` and ``key_device``: the generator's position in its
stream and the kind of device it belongs to, so that a saved stream
resumes its draws where it left off.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from video_stab_tpu_torch.motion.hf import HFState, hf_init

# Ring capacity for path/transform histories (state.py PATH_RING).
PATH_RING = 128


class StabilizerState(NamedTuple):
    """Full streaming state of one stabilized stream."""

    prev_gray: torch.Tensor        # (Ha, Wa) f32 previous analysis gray
    prev_pts: torch.Tensor         # (N, 2) f32 tracked feature slots
    prev_mask: torch.Tensor        # (N,) bool feature slot validity
    trans_ring: torch.Tensor       # (PATH_RING, C) raw per-frame transforms
    path_ring: torch.Tensor        # (PATH_RING, C) cumulative path
    n_path: torch.Tensor           # int32 transforms pushed
    frame_ring: torch.Tensor       # (Q, H, W, 3) uint8 look-ahead queue
    n_frames: torch.Tensor         # int32 frames pushed (incl. first)
    emit_idx: torch.Tensor         # int32 next frame index to emit
    aux_roll_ring: torch.Tensor    # (Q,) f32 degrees (fused-chain roll)
    kalman_x: torch.Tensor         # (2, C) f32
    kalman_p: torch.Tensor         # (2, 2, C) f32
    butter_state: torch.Tensor     # (4, C) f32
    hf: HFState                    # drone high-frequency chain state
    fade_history: torch.Tensor     # (1, 1, 3) f32 (fade border not ported)
    fade_count: torch.Tensor       # int32
    canvas: torch.Tensor           # (1, 1, 3) f32 (virtual canvas not ported)
    canvas_weight: torch.Tensor    # (1, 1) f32
    canvas_scale: torch.Tensor     # f32 scalar
    starvation_counter: torch.Tensor  # int32
    envelope_exceeded: torch.Tensor   # int32
    key: torch.Generator           # the stream's RANSAC generator
    deepstab: Any = ()


def motion_channels(params) -> int:
    """Trajectory channel count C: 3 for the similarity model (dx, dy, da),
    9 for the homography model (the flattened sl(3) log-homography)."""
    return 9 if params.motion_model == "homography" else 3


def _generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def stabilizer_state_init(params, height: int, width: int,
                          device: torch.device) -> StabilizerState:
    """Allocate the state for a (height, width) BGR stream on ``device``."""
    ha, wa = params.analysis_height, params.analysis_width
    n = params.max_corners
    q = params.effective_radius + 1
    c = motion_channels(params)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def i32():
        return torch.zeros((), dtype=torch.int32, device=device)

    return StabilizerState(
        prev_gray=zeros(ha, wa),
        prev_pts=zeros(n, 2),
        prev_mask=zeros(n, dtype=torch.bool),
        trans_ring=zeros(PATH_RING, c),
        path_ring=zeros(PATH_RING, c),
        n_path=i32(),
        frame_ring=zeros(q, height, width, 3, dtype=torch.uint8),
        n_frames=i32(),
        emit_idx=i32(),
        aux_roll_ring=zeros(q),
        kalman_x=zeros(2, c),
        kalman_p=zeros(2, 2, c),
        butter_state=zeros(4, c),
        hf=hf_init(device),
        fade_history=zeros(1, 1, 3),
        fade_count=i32(),
        canvas=zeros(1, 1, 3),
        canvas_weight=zeros(1, 1),
        canvas_scale=zeros(),
        starvation_counter=i32(),
        envelope_exceeded=i32(),
        key=_generator(params.seed, device),
        deepstab=(),
    )


def _key_seed(key: Any) -> int:
    """A generator seed from a JAX PRNG key's uint32 words."""
    words = np.asarray(key).astype(np.uint64).reshape(-1)
    seed = 0
    for wd in words:
        seed = (seed << 32) | int(wd)
    return seed & ((1 << 63) - 1)


def _field(np_state: Any, name: str) -> Any:
    return np_state.get(name) if isinstance(np_state, dict) \
        else getattr(np_state, name, None)


def _tensor(value: Any, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(value)).to(device)


def state_from_numpy(np_state: Any, device: torch.device) -> StabilizerState:
    """The port's state from a tree of numpy arrays: the JAX package's
    ``StabilizerState`` (``video_stab_tpu`` ``Stabilizer.state_dict()``) or
    this package's ``state_to_numpy`` dict (or an object with its entries
    as attributes).

    The key becomes a torch.Generator. A tree of this package carries the
    generator's state (``key_state``), restored when it was saved on the
    same kind of device, so the stream continues its own draws. A JAX key
    seeds a fresh generator from its words; its draws are not JAX's, so a
    caller continuing a stream with the JAX package's estimates injects
    JAX's draws (from the same key chain). ``hf`` (a tuple or a dict of
    the HFState fields), ``kalman_x`` / ``kalman_p`` / ``butter_state`` are
    carried; the fade and canvas buffers are not (not ported)."""
    device = torch.device(device)
    fields = {}
    for name in StabilizerState._fields:
        value = _field(np_state, name)
        if name == "deepstab":
            fields[name] = ()
        elif name == "hf":
            if isinstance(value, dict):
                value = [value[f] for f in HFState._fields]
            fields[name] = HFState(*(_tensor(v, device) for v in value))
        elif name == "key":
            gen = _generator(_key_seed(value), device)
            saved = _field(np_state, "key_state")
            if saved is not None and \
                    str(_field(np_state, "key_device")) == device.type:
                gen.set_state(torch.from_numpy(
                    np.array(saved, dtype=np.uint8)))
            fields[name] = gen
        elif name in ("fade_history", "canvas", "canvas_weight"):
            shape = {"fade_history": (1, 1, 3), "canvas": (1, 1, 3),
                     "canvas_weight": (1, 1)}[name]
            fields[name] = torch.zeros(shape, dtype=torch.float32,
                                       device=device)
        else:
            fields[name] = _tensor(value, device)
    return StabilizerState(**fields)


def state_to_numpy(state: StabilizerState) -> dict:
    """The port's state as a dict of numpy arrays with the JAX package's
    field names. ``key`` is the generator's initial seed as a
    ``jax.random.PRNGKey``-shaped uint32 pair; ``key_state`` (uint8) is the
    generator's ``get_state()``, its position in its stream, and
    ``key_device`` the device type it belongs to (a CPU and a CUDA
    generator's states do not interchange); ``hf`` is a tuple of arrays in
    HFState's field order; ``deepstab`` is empty."""
    out = {}
    for name in StabilizerState._fields:
        v = getattr(state, name)
        if name == "key":
            seed = v.initial_seed()
            out[name] = np.asarray([(seed >> 32) & 0xFFFFFFFF,
                                    seed & 0xFFFFFFFF], np.uint32)
            out["key_state"] = v.get_state().cpu().numpy().copy()
            out["key_device"] = v.device.type
        elif name == "hf":
            out[name] = HFState(*(t.detach().cpu().numpy() for t in v))
        elif isinstance(v, torch.Tensor):
            out[name] = v.detach().cpu().numpy()
        else:
            out[name] = v
    return out
