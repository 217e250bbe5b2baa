"""Upstream's drone mode (``configs/drone_hf.yaml``) in the port's batched
multi-stream step, on the CPU: conditional CLAHE, the ``motion_prediction``
prior, the HF chain and crop-and-zoom once a tick for N streams, each
stream's decisions its own.

Held:

- streams that part ways: a 3-stream batch whose streams 0 and 2 see
  starved frames (``drone_frames.py``: too few corners, so their
  starvation counters pass 2 and CLAHE is selected) and stream 1 a calm
  textured scene (never starved; its transforms stay under the dead zone's
  threshold, so its HF chain freezes while the others' do not): after
  every tick each stream's counter, HF state, transform and frame equal
  its own single-stream ``Stabilizer(seed + i)``'s (transforms within
  1e-5, frames within 1 on >= 99.9 % of pixels, as
  ``test_torch_multistream_variants.py``);
- the batch against the JAX package's ``MultiStreamStabilizer`` with 2
  streams fed the JAX key chains' draws: the readiness, transforms within
  2e-2 and frames within 1 on >= 99.5 % of pixels. The bound is the
  single-stream port's own: its CLAHE is within one grey level of the JAX
  package's on < 1 % of pixels (``test_torch_drone.py``), which moves LK
  at this 256 x 192 analysis by up to 0.0171 px in stream 0's run of the
  port's single-stream ``Stabilizer`` against the JAX package's (0.0036
  with CLAHE off), and the batch equals the single streams within 1e-5;
- ``reset_stream(1)`` mid-run: slot 1 is a fresh stream's state field for
  field (HF state, starvation counter, the prior's previous gray and
  points), the other slots are what they were, and they go on equal to
  their single-stream runs;
- the spans and counters: one ``vstab.clahe`` and ``vstab.hf`` inside
  ``vstab.step``, one ``vstab.prior`` inside ``vstab.lk`` and one
  ``vstab.crop_zoom`` inside ``vstab.emit`` a tick, the counters
  ``clahe_runs``, ``hf_steps``, ``prior_steps`` and
  ``crop_zoom_resamples`` N a tick; a single stream writes ``vstab.prior``
  inside ``vstab.lk`` and counts ``prior_steps`` once a frame.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from drone_frames import starved_pool  # noqa: E402
from test_torch_drone import _parent, _spans  # noqa: E402
from test_torch_multistream import (  # noqa: E402
    JaxStreamDraws,
    _assert_same_run,
    _drive,
    _streams,
)
from test_torch_multistream_variants import DRONE  # noqa: E402
from test_torch_stabilizer import CPU, SMALL, _close_frames  # noqa: E402
from video_stab_tpu.core.params import StabilizerParams as JParams  # noqa: E402
from video_stab_tpu.parallel.multistream import (  # noqa: E402
    MultiStreamStabilizer as JMulti,
)
from video_stab_tpu_torch.core.params import StabilizerParams  # noqa: E402
from video_stab_tpu_torch.core.stabilizer import Stabilizer  # noqa: E402
from video_stab_tpu_torch.core.state import (  # noqa: E402
    StabilizerState,
    stabilizer_state_init,
)
from video_stab_tpu_torch.motion.hf import HFState  # noqa: E402
from video_stab_tpu_torch.parallel import MultiStreamStabilizer  # noqa: E402
from video_stab_tpu_torch.utils import telemetry  # noqa: E402

# The divergence batch: 180 x 320 frames analysed at their own size (the
# prior's 45 x 80 grays are the smallest it measures at), 64 corners, so
# a textured frame tracks more than the 40 points under which it starves.
H, W = 180, 320
PARTED = {**DRONE, "smoothing_radius": 5, "max_corners": 64,
          "ransac_hypotheses": 32, "analysis_width": W,
          "analysis_height": H}
PARTED_TICKS = 16


def _calm_textured(n, h, w, seed=3):
    """(n, h, w, 3) u8 frames of a blurred random world seen through +-1 px
    of jitter: many corners, and motions under the HF dead zone's 3 px."""
    rng = np.random.default_rng(seed)
    k = np.exp(-0.5 * (np.arange(-6, 7) / 2.0) ** 2)
    k /= k.sum()
    world = rng.random((h + 8, w + 8))
    world = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1,
                                world)
    world = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0,
                                world)
    world = (world - world.min()) / np.ptp(world) * 255.0
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        dy, dx = rng.integers(-1, 2, 2)
        out[i] = world[4 + dy:4 + dy + h, 4 + dx:4 + dx + w, None].astype(
            np.uint8)
    return out


def _hf_equal(got, want, i):
    for name in HFState._fields:
        a = getattr(got, name)[i].numpy()
        b = getattr(want, name).numpy()
        if a.dtype == np.float32:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def _step_both(ms, singles, batch):
    """One tick of the batch and of each single stream: the per-stream
    checks against the singles, and the batch's (starvation counters
    before the tick, HF dead-zone flags after it)."""
    before = ms._state.starvation_counter.clone() \
        if ms._state is not None else None
    out = ms.stabilize_batch(batch)
    so = [s.stabilize(batch[i]) for i, s in enumerate(singles)]
    assert (out is None) == all(o is None for o in so)
    st = ms._state
    for i, s in enumerate(singles):
        assert int(st.starvation_counter[i]) == \
            int(s._state.starvation_counter)
        _hf_equal(st.hf, s._state.hf, i)
        if s.last_metrics:
            np.testing.assert_allclose(
                ms.last_metrics["transform"][i].numpy(),
                s.last_metrics["transform"].numpy(), atol=1e-5, rtol=0)
        if out is not None:
            assert _close_frames(out[i], so[i]) >= 0.999, i
    return before, st.hf.in_dead_zone.clone()


def test_streams_that_part_ways_each_equal_their_single_stream():
    starved = starved_pool(PARTED_TICKS, H, W)[:, 0]
    batches = np.ascontiguousarray(np.stack(
        [starved, _calm_textured(PARTED_TICKS, H, W),
         np.ascontiguousarray(starved[:, :, ::-1])], axis=1))
    p = StabilizerParams(**{**SMALL, **PARTED})
    ms = MultiStreamStabilizer(p, 3, mode=CPU)
    singles = [Stabilizer(dataclasses.replace(p, seed=p.seed + i), mode=CPU)
               for i in range(3)]
    selected, frozen = [], []
    for b in batches:
        counters, dz = _step_both(ms, singles, b)
        if counters is not None:
            selected.append((counters > 2).numpy())
            frozen.append(dz.numpy())
    selected, frozen = np.array(selected), np.array(frozen)
    # CLAHE is selected for the starved streams, never for the textured.
    assert selected[:, 0].any() and selected[:, 2].any()
    assert not selected[:, 1].any()
    # The calm stream's HF chain freezes on ticks where a starved one's
    # does not.
    assert (frozen[:, 1] & ~frozen[:, 0]).any()


def test_batched_drone_matches_jax(jittered_clip):
    frames, _ = jittered_clip
    batches = _streams(frames[:14], n=2)
    kw = {**SMALL, **DRONE}
    jp = JParams(**kw)
    j_run = _drive(JMulti(jp, n_streams=2), batches)
    draws = JaxStreamDraws.from_seed(jp.seed, 2, jp.ransac_hypotheses)
    port = MultiStreamStabilizer(StabilizerParams(**kw), 2, mode=CPU,
                                 ransac_draws=draws)
    p_run = _drive(port, batches)
    assert sum(o is not None for o, _, _ in p_run[0]) >= 8
    _assert_same_run(p_run, j_run, tr_tol=2e-2)


def test_reset_stream_gives_a_fresh_drone_stream(jittered_clip):
    frames, _ = jittered_clip
    batches = _streams(frames[:14])
    p = StabilizerParams(**{**SMALL, **DRONE})
    ms = MultiStreamStabilizer(p, 3, mode=CPU)
    singles = [Stabilizer(dataclasses.replace(p, seed=p.seed + i), mode=CPU)
               for i in range(3)]
    for b in batches[:8]:
        _step_both(ms, singles, b)
    st = ms._state
    assert st.starvation_counter[1] > 0 and st.hf.n_history[1] > 0
    kept = {name: [t.clone() for t in getattr(st, name)] if name == "hf"
            else getattr(st, name).clone()
            for name in StabilizerState._fields
            if name not in ("key", "deepstab")}
    ms.reset_stream(1)
    fresh = stabilizer_state_init(dataclasses.replace(p, seed=p.seed + 1),
                                  96, 128, torch.device("cpu"))
    st = ms._state
    for name, old in kept.items():
        got = list(getattr(st, name)) if name == "hf" \
            else [getattr(st, name)]
        want = list(getattr(fresh, name)) if name == "hf" \
            else [getattr(fresh, name)]
        olds = old if name == "hf" else [old]
        for g, w, o in zip(got, want, olds):
            assert torch.equal(g[1], w), name
            assert torch.equal(g[0], o[0]) and torch.equal(g[2], o[2]), name
    # The others go on as their single streams; slot 1 re-warms.
    del singles[1]
    for t, b in enumerate(batches[8:]):
        out = ms.stabilize_batch(b)
        for i, s in zip((0, 2), singles):
            o = s.stabilize(b[i])
            np.testing.assert_allclose(
                ms.last_metrics["transform"][i].numpy(),
                s.last_metrics["transform"].numpy(), atol=1e-5, rtol=0)
            _hf_equal(ms._state.hf, s._state.hf, i)
            assert _close_frames(out[i], o) >= 0.999
        assert bool(ms.last_valid[1]) == (t >= p.effective_radius - 1)


PARENTS = {"vstab.clahe": "vstab.step", "vstab.hf": "vstab.step",
           "vstab.prior": "vstab.lk", "vstab.crop_zoom": "vstab.emit"}
COUNTERS = ("clahe_runs", "hf_steps", "prior_steps", "crop_zoom_resamples")


@pytest.mark.parametrize("n_streams", [1, 3])
def test_drone_spans_once_a_tick_and_counters_per_stream(jittered_clip,
                                                         tmp_path,
                                                         n_streams):
    """n_streams 1: the single-stream ``Stabilizer``; 3: the batch."""
    frames, _ = jittered_clip
    ticks = 7
    batches = _streams(frames[:ticks], n=3)[:, :n_streams]
    p = StabilizerParams(**{**SMALL, **DRONE})
    if n_streams == 1:
        stab = Stabilizer(p, mode=CPU)
        calls = [lambda b=b: stab.stabilize(b[0]) for b in batches]
    else:
        ms = MultiStreamStabilizer(p, n_streams, mode=CPU)
        calls = [lambda b=b: ms.stabilize_batch(b) for b in batches]
    before = [telemetry.counters().get(k, 0) for k in COUNTERS]
    spans = _spans(lambda: [c() for c in calls], tmp_path)
    counted = [telemetry.counters().get(k, 0) - b
               for k, b in zip(COUNTERS, before)]
    names = [n for n, _, _ in spans]
    # The first tick only detects; every later one analyzes and emits.
    for name in PARENTS:
        assert names.count(name) == ticks - 1, name
    assert counted == [(ticks - 1) * n_streams] * len(COUNTERS)
    for i, name in enumerate(names):
        if name in PARENTS:
            assert _parent(spans, i) == PARENTS[name], name
