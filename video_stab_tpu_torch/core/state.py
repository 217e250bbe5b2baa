"""Streaming state of the stabilizer, field for field with
``video_stab_tpu/core/state.py``.

All fields are tensors on the stream's device, ``hf`` a tuple of them (the
drone high-frequency chain's ``motion.hf.HFState``), except ``key``: the
stream's ``torch.Generator`` (the JAX package's PRNG key), seeded from
``params.seed``. It draws RANSAC's hypotheses; JAX's own draws cannot be
reproduced by it, so callers that need the JAX package's estimates inject
those draws instead (``Stabilizer(ransac_draws=...)``).

With ``enable_virtual_canvas`` the canvas and its weight are
(Hc, Wc, 3) and (Hc, Wc) float32 buffers (``core.canvas.canvas_init_value``)
(2160x3840 for a 1080p stream at the defaults); otherwise (1, 1, 3) and
(1, 1). With ``deep_stabilization`` the wrappers put the network
(``models.deepstab.DeepStabNet``) in ``deepstab``.

``state_from_numpy`` / ``state_to_numpy`` convert between this state and
the JAX package's ``StabilizerState`` as a tree of numpy arrays (what its
``Stabilizer.state_dict()`` returns). The port's own tree has two entries
more, ``key_state`` and ``key_device``: the generator's position in its
stream and the kind of device it belongs to, so that a saved stream
resumes its draws where it left off.

N streams served in lockstep (``parallel/multistream.py``) keep one
``StabilizerState`` whose tensors have a leading N, the (N, Q, H, W, 3)
frame ring among them, whose ``key`` is a tuple of N generators (stream i
seeded from ``params.seed + i``) and whose ``deepstab`` is one network
shared by the streams. ``batched_state_from_numpy`` /
``batched_state_to_numpy`` convert it from and to the JAX package's
batched tree (every leaf stacked, ``key`` (N, 2) uint32).

``LegacyState`` is the legacy deterministic stabilizer's state
(``core/legacy.py``), field for field with the JAX package's.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, NamedTuple

import numpy as np
import torch

from video_stab_tpu_torch.core.canvas import canvas_init_value
from video_stab_tpu_torch.models.deepstab import DeepStabNet, deepstab_from_flax
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
    fade_history: torch.Tensor     # (H + 2b, W + 2b, 3) f32 with the fade
                                   # border, else (1, 1, 3)
    fade_count: torch.Tensor       # int32
    canvas: torch.Tensor           # (Hc, Wc, 3) f32 virtual canvas, else (1, 1, 3)
    canvas_weight: torch.Tensor    # (Hc, Wc) f32, else (1, 1)
    canvas_scale: torch.Tensor     # f32 active canvas scale (0: undecided)
    starvation_counter: torch.Tensor  # int32
    envelope_exceeded: torch.Tensor   # int32
    key: torch.Generator           # the stream's RANSAC generator
    deepstab: Any = ()             # DeepStabNet with deep_stabilization


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
    b = params.border_pad
    if params.border_type == "fade" and b > 0 and not params.crop_n_zoom:
        fade_shape = (height + 2 * b, width + 2 * b, 3)
    else:
        fade_shape = (1, 1, 3)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def i32():
        return torch.zeros((), dtype=torch.int32, device=device)

    if params.enable_virtual_canvas:
        canvas, canvas_weight = canvas_init_value(params, height, width,
                                                  device)
    else:
        canvas, canvas_weight = zeros(1, 1, 3), zeros(1, 1)

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
        fade_history=zeros(*fade_shape),
        fade_count=i32(),
        canvas=canvas,
        canvas_weight=canvas_weight,
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
    the HFState fields), ``kalman_x`` / ``kalman_p`` / ``butter_state`` and
    the fade border's ``fade_history`` / ``fade_count`` and the virtual
    canvas's ``canvas`` / ``canvas_weight`` / ``canvas_scale`` are carried.
    ``deepstab``, the JAX package's flax parameter tree or this package's
    ``state_dict`` of the network as numpy, becomes a ``DeepStabNet``."""
    device = torch.device(device)
    fields = {}
    for name in StabilizerState._fields:
        value = _field(np_state, name)
        if name == "deepstab":
            fields[name] = _deepstab_from_tree(value, device)
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
    HFState's field order; ``deepstab`` is the network's ``state_dict`` as
    numpy arrays (empty without deep stabilization)."""
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
        elif name == "deepstab":
            out[name] = {} if isinstance(v, tuple) else {
                k: t.detach().cpu().numpy() for k, t in v.state_dict().items()}
        elif isinstance(v, torch.Tensor):
            out[name] = v.detach().cpu().numpy()
        else:
            out[name] = v
    return out


def batched_state_from_numpy(np_state: Any, device: torch.device
                             ) -> StabilizerState:
    """The batched state of N streams from a tree of numpy arrays: the JAX
    package's batched ``StabilizerState`` (every leaf with a leading N,
    ``key`` (N, 2) uint32, the deep network's flax parameters stacked per
    stream) or this package's ``batched_state_to_numpy`` dict. Stream i's
    generator is seeded from key[i] and, from a tree of this package saved
    on the same kind of device, set to its saved position
    (``key_state[i]``)."""
    device = torch.device(device)
    fields = {}
    for name in StabilizerState._fields:
        value = _field(np_state, name)
        if name == "deepstab":
            if value is not None and len(value) and "params" in value:
                value = _first_of_stack(value)      # JAX: stacked per stream
            fields[name] = _deepstab_from_tree(value, device)
        elif name == "hf":
            if isinstance(value, dict):
                value = [value[f] for f in HFState._fields]
            fields[name] = HFState(*(_tensor(v, device) for v in value))
        elif name == "key":
            keys = np.asarray(value)
            saved = _field(np_state, "key_state")
            same = saved is not None and \
                str(_field(np_state, "key_device")) == device.type
            gens = []
            for i in range(keys.shape[0]):
                gen = _generator(_key_seed(keys[i]), device)
                if same:
                    gen.set_state(torch.from_numpy(
                        np.array(saved[i], dtype=np.uint8)))
                gens.append(gen)
            fields[name] = tuple(gens)
        else:
            fields[name] = _tensor(value, device).contiguous()
    return StabilizerState(**fields)


def batched_state_to_numpy(state: StabilizerState) -> dict:
    """The batched state as a dict of numpy arrays with the JAX package's
    field names, each with a leading N: ``key`` (N, 2) uint32 from each
    generator's initial seed, ``key_state`` (N, S) uint8 the generators'
    positions, ``key_device`` their device type; ``deepstab`` the shared
    network's ``state_dict`` (empty without deep stabilization)."""
    out = {}
    for name in StabilizerState._fields:
        v = getattr(state, name)
        if name == "key":
            seeds = [g.initial_seed() for g in v]
            out[name] = np.asarray([[(sd >> 32) & 0xFFFFFFFF,
                                     sd & 0xFFFFFFFF] for sd in seeds],
                                   np.uint32)
            out["key_state"] = np.stack(
                [g.get_state().cpu().numpy() for g in v])
            out["key_device"] = v[0].device.type if v else "cpu"
        elif name == "hf":
            out[name] = HFState(*(t.detach().cpu().numpy() for t in v))
        elif name == "deepstab":
            out[name] = {} if isinstance(v, tuple) else {
                k: t.detach().cpu().numpy() for k, t in v.state_dict().items()}
        else:
            out[name] = v.detach().cpu().numpy()
    return out


def _first_of_stack(tree: Any) -> Any:
    """Every array leaf of a nested dict at index 0 of its leading axis."""
    if isinstance(tree, Mapping):
        return {k: _first_of_stack(v) for k, v in tree.items()}
    return np.asarray(tree)[0]


def _deepstab_from_tree(tree: Any, device: torch.device) -> Any:
    """The deep-stabilization network of a numpy state tree: () when the
    tree holds none, else a DeepStabNet from the JAX package's flax tree
    ({"params": ...}) or from this package's state_dict."""
    if tree is None or len(tree) == 0:
        return ()
    if "params" in tree:
        return deepstab_from_flax(tree).to(device)
    net = DeepStabNet()
    net.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in tree.items()})
    return net.eval().requires_grad_(False).to(device)


class LegacyState(NamedTuple):
    """Streaming state of the legacy deterministic path
    (src/Stabilizer_legacy.cpp)."""

    prev_gray: torch.Tensor        # (H, W) f32 full-resolution grayscale
    prev_pts: torch.Tensor         # (N, 2) f32
    prev_mask: torch.Tensor        # (N,) bool
    trans_ring: torch.Tensor       # (PATH_RING, 3)
    path_ring: torch.Tensor        # (PATH_RING, 3)
    n_path: torch.Tensor           # int32
    frame_ring: torch.Tensor       # (Q, H, W, 3) uint8
    n_frames: torch.Tensor         # int32
    emit_idx: torch.Tensor         # int32
    frames_since_detect: torch.Tensor  # int32 (legacy:276-280)


def legacy_state_init(params, height: int, width: int,
                      device: torch.device) -> LegacyState:
    """Allocate the legacy state for a (height, width) stream on
    ``device``."""
    n = params.max_corners
    q = params.effective_radius + 1

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return LegacyState(
        prev_gray=zeros(height, width),
        prev_pts=zeros(n, 2),
        prev_mask=zeros(n, dtype=torch.bool),
        trans_ring=zeros(PATH_RING, 3),
        path_ring=zeros(PATH_RING, 3),
        n_path=zeros(dtype=torch.int32),
        frame_ring=zeros(q, height, width, 3, dtype=torch.uint8),
        n_frames=zeros(dtype=torch.int32),
        emit_idx=zeros(dtype=torch.int32),
        frames_since_detect=zeros(dtype=torch.int32),
    )
