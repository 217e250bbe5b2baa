"""The port's MultiStreamStabilizer against the JAX package's, on the CPU.

Both serve the same lockstep streams with the same StabilizerParams (one
similarity parameter set for most cases, so that JAX compiles its batched
programs once): the JAX package without a mesh, the port on the CPU. Each
of the port's streams is fed the JAX package's own RANSAC draws, stream i
from the key chain of ``PRNGKey(seed + i)`` (a torch generator cannot
reproduce them). Held, as in the single-stream tests: identical per-stream
readiness, per-stream transforms within 1e-3, emitted u8 frames within 1
on >= 99.5 % of pixels. Also: stream i of the batch against the port's own
single-stream ``Stabilizer(seed = seed + i)``, a JAX batched state carried
into the port, the serving loop over the port's own frame server on
loopback, the parameters ``check_supported_batched`` refuses and those it
takes, and the plain versions' calls per tick (each stage once for all N
streams).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from video_stab_tpu.core.params import StabilizerParams as JParams  # noqa: E402
from video_stab_tpu.parallel.multistream import (  # noqa: E402
    MultiStreamStabilizer as JMulti,
)
from video_stab_tpu_torch.core.params import StabilizerParams  # noqa: E402
from video_stab_tpu_torch.core.stabilizer import (  # noqa: E402
    Stabilizer,
    check_supported_batched,
)
from video_stab_tpu_torch.core.state import (  # noqa: E402
    StabilizerState,
    stabilizer_state_init,
)
from video_stab_tpu_torch.parallel import (  # noqa: E402
    MultiStreamStabilizer,
    batched_state_init,
    serve_remote_streams,
)

from test_torch_stabilizer import CPU, SMALL, JaxDraws, _close_frames  # noqa: E402

N = 3
BF16_BOUND = 2e-2     # test_torch_deepstab.py's bound on the network
TICKS = 18
RESET_AT = 9          # reset_stream(1) before this tick
RESET = 1


class JaxStreamDraws:
    """Per-stream JaxDraws: stream i's key chain from PRNGKey(seed + i); the
    hook gets the (N,) valid counts and returns (N, K, width)."""

    def __init__(self, keys, k, width=2):
        self.streams = [JaxDraws(key, k, width) for key in keys]

    @classmethod
    def from_seed(cls, seed, n, k, width=2):
        return cls([jax.random.PRNGKey(seed + i) for i in range(n)], k, width)

    def reset(self, i, seed):
        self.streams[i].key = jax.random.PRNGKey(seed + i)

    def __call__(self, n_valid):
        return torch.stack([s(v) for s, v in zip(self.streams, n_valid)])


def _streams(frames, n=N):
    """n lockstep streams from one clip: stream i is the clip rolled by 2i
    frames and mirrored when i is odd."""
    clip = np.stack(frames)
    out = []
    for i in range(n):
        c = np.roll(clip, 2 * i, axis=0)
        out.append(c[:, :, ::-1] if i % 2 else c)
    return np.ascontiguousarray(np.stack(out, axis=1))    # (T, N, H, W, 3)


def _drive(ms, batches, reset=None, on_reset=None, state_at=None):
    """Run the batches (resetting stream ``reset`` before tick RESET_AT),
    then flush: per tick (out, last_valid, transforms), the flushed
    batches, and the numpy state after tick ``state_at``."""
    ticks, flushed, state = [], [], None
    for t, b in enumerate(batches):
        if reset is not None and t == RESET_AT:
            ms.reset_stream(reset)
            if on_reset is not None:
                on_reset()
        out = ms.stabilize_batch(b)
        tr = ms.last_metrics.get("transform") if ms.last_metrics else None
        ticks.append((None if out is None else np.asarray(out),
                      None if ms.last_valid is None
                      else np.array(ms.last_valid),
                      None if tr is None else np.asarray(tr)))
        if t == state_at:
            state = ms.state_dict() if isinstance(ms, MultiStreamStabilizer) \
                else jax.tree_util.tree_map(np.asarray, ms._state)
    while (o := ms.flush_batch()) is not None:
        flushed.append((np.asarray(o), np.array(ms.last_valid)))
    return ticks, flushed, state


def _assert_same_run(port, jax_run, tr_tol=1e-3, frac=0.995):
    (p_ticks, p_fl, _), (j_ticks, j_fl, _) = port, jax_run
    assert len(p_ticks) == len(j_ticks)
    for (po, pv, pt), (jo, jv, jt) in zip(p_ticks, j_ticks):
        assert (po is None) == (jo is None)
        if jv is not None:
            np.testing.assert_array_equal(pv, jv)
        if jt is not None:
            np.testing.assert_allclose(pt, jt, atol=tr_tol, rtol=0)
        if po is not None:
            for i in range(po.shape[0]):
                if jv[i]:
                    assert _close_frames(po[i], jo[i]) >= frac, i
    assert len(p_fl) == len(j_fl)
    for (po, pv), (jo, jv) in zip(p_fl, j_fl):
        np.testing.assert_array_equal(pv, jv)
        for i in np.flatnonzero(jv):
            assert _close_frames(po[i], jo[i]) >= frac, i


@pytest.fixture(scope="module")
def batches(jittered_clip):
    frames, _ = jittered_clip
    return _streams(frames[:TICKS])


@pytest.fixture(scope="module")
def similarity_runs(batches):
    """The JAX and the port's batched runs with SMALL, stream RESET reset
    mid-run, then drained; the JAX state after tick 11 beside them."""
    jp = JParams(**SMALL)
    j_run = _drive(JMulti(jp, n_streams=N), batches, reset=RESET,
                   state_at=11)
    draws = JaxStreamDraws.from_seed(jp.seed, N, jp.ransac_hypotheses)
    port = MultiStreamStabilizer(StabilizerParams(**SMALL), N, mode=CPU,
                                 ransac_draws=draws)
    p_run = _drive(port, batches, reset=RESET,
                   on_reset=lambda: draws.reset(RESET, jp.seed))
    return p_run, j_run


def test_batched_matches_jax(similarity_runs):
    _assert_same_run(*similarity_runs)


def test_warmup_and_emit_count(similarity_runs):
    """Every stream emits from the tick its queue holds effective_radius
    frames: the init tick and the next effective_radius - 2 emit
    nothing."""
    (ticks, _, _), _ = similarity_runs
    r = StabilizerParams(**SMALL).effective_radius
    outs = [o is not None for o, _, _ in ticks[:RESET_AT]]
    assert outs == [False] * (r - 1) + [True] * (RESET_AT - r + 1)
    for o, _, _ in ticks:
        assert o is None or o.shape == (N, 96, 128, 3)


def test_reset_stream_rewarms_in_isolation(similarity_runs):
    """After reset_stream the reset stream is not valid for
    effective_radius - 1 ticks while the others never stop; it analyzes
    its first tick against a zero gray with no point (not ok, zero
    transform)."""
    (ticks, _, _), _ = similarity_runs
    r = StabilizerParams(**SMALL).effective_radius
    after = [v for _, v, _ in ticks[RESET_AT:]]
    others = [i for i in range(N) if i != RESET]
    assert all(v[others].all() for v in after)
    assert [bool(v[RESET]) for v in after[:r]] == [False] * (r - 1) + [True]
    np.testing.assert_array_equal(ticks[RESET_AT][2][RESET], 0.0)


def test_flush_batch_matches_jax(similarity_runs):
    """flush_batch releases only the streams whose queue still holds
    effective_radius frames. In lockstep serving none does after a step
    (both drains end at once); with stream 0's emit cursor set back by one
    in the JAX state of tick 11, both release stream 0 alone, with the same
    frame, then stop."""
    import jax.numpy as jnp

    (_, p_fl, _), (_, j_fl, j_state) = similarity_runs
    assert p_fl == [] and j_fl == []
    emit_idx = np.array(j_state.emit_idx)
    emit_idx[0] -= 1
    state = j_state._replace(emit_idx=emit_idx)
    jms = JMulti(JParams(**SMALL), n_streams=N)
    jms._state = jax.tree_util.tree_map(jnp.asarray, state)
    jms._shape = (96, 128)
    jms._frames_in = np.array(state.n_frames, np.int64)
    jms._emitted = np.array(state.emit_idx, np.int64)
    port = MultiStreamStabilizer(StabilizerParams(**SMALL), N, mode=CPU)
    port.load_state_dict(state, 96, 128)
    jo, po = jms.flush_batch(), port.flush_batch()
    np.testing.assert_array_equal(port.last_valid, jms.last_valid)
    assert list(port.last_valid) == [True] + [False] * (N - 1)
    assert _close_frames(po[0], jo[0]) >= 0.995
    assert jms.flush_batch() is None and port.flush_batch() is None


def test_batch_stream_equals_single_stream(batches):
    """Stream i of the port's batch, drawing from its own generator, is the
    port's single-stream Stabilizer with seed + i: the same readiness,
    transforms, tracked points and frames."""
    p = StabilizerParams(**SMALL)
    ms = MultiStreamStabilizer(p, N, mode=CPU)
    singles = [Stabilizer(dataclasses.replace(p, seed=p.seed + i), mode=CPU)
               for i in range(N)]
    for b in batches:
        out = ms.stabilize_batch(b)
        so = [s.stabilize(b[i]) for i, s in enumerate(singles)]
        assert (out is None) == all(o is None for o in so)
        for i, s in enumerate(singles):
            np.testing.assert_array_equal(
                ms._state.prev_mask[i].numpy(), s._state.prev_mask.numpy())
            np.testing.assert_allclose(ms._state.prev_pts[i].numpy(),
                                       s._state.prev_pts.numpy(), atol=1e-5)
            if s.last_metrics:
                np.testing.assert_allclose(
                    ms.last_metrics["transform"][i].numpy(),
                    s.last_metrics["transform"].numpy(), atol=1e-5, rtol=0)
            if out is not None:
                assert _close_frames(out[i], so[i]) >= 0.999


def test_redetect_phase_matches_jax(batches):
    """The shared re-detect tick fires on the same analyze steps as the
    JAX package's batched step (an off-by-one would re-detect on the first
    analyze step): the tracked point sets agree after every tick."""
    jp = JParams(**SMALL)
    jms = JMulti(jp, n_streams=N)
    draws = JaxStreamDraws.from_seed(jp.seed, N, jp.ransac_hypotheses)
    ms = MultiStreamStabilizer(StabilizerParams(**SMALL), N, mode=CPU,
                               ransac_draws=draws)
    for b in batches[:6]:
        jms.stabilize_batch(b)
        ms.stabilize_batch(b)
        jm = np.asarray(jms._state.prev_mask)
        pm = ms._state.prev_mask.numpy()
        np.testing.assert_array_equal(pm, jm)
        assert pm.any(axis=1).all()
        np.testing.assert_allclose(ms._state.prev_pts.numpy()[pm],
                                   np.asarray(jms._state.prev_pts)[pm],
                                   atol=1e-2)


def test_jax_batched_state_continues_like_jax(batches, similarity_runs):
    """The port resumes the JAX package's batched state (after tick 11,
    before the reset stream has re-warmed) and steps on like JAX."""
    _, (j_ticks, _, j_state) = similarity_runs
    jp = JParams(**SMALL)
    draws = JaxStreamDraws([np.asarray(k) for k in j_state.key],
                           jp.ransac_hypotheses)
    port = MultiStreamStabilizer(StabilizerParams(**SMALL), N, mode=CPU,
                                 ransac_draws=draws)
    port.load_state_dict(j_state, 96, 128)
    carried = port.state_dict()
    for name in ("prev_gray", "prev_pts", "prev_mask", "trans_ring",
                 "path_ring", "n_path", "frame_ring", "n_frames",
                 "emit_idx"):
        np.testing.assert_array_equal(carried[name],
                                      np.asarray(getattr(j_state, name)),
                                      err_msg=name)
    for t in range(12, 17):
        out = port.stabilize_batch(batches[t])
        jo, jv, jt = j_ticks[t]
        assert (out is None) == (jo is None)
        np.testing.assert_array_equal(port.last_valid, jv)
        np.testing.assert_allclose(port.last_metrics["transform"].numpy(),
                                   jt, atol=1e-3, rtol=0)
        for i in np.flatnonzero(jv):
            assert _close_frames(out[i], jo[i]) >= 0.995


def test_homography_batched_matches_jax(batches):
    kw = dict(SMALL, motion_model="homography")
    jp = JParams(**kw)
    j_run = _drive(JMulti(jp, n_streams=N), batches[:12])
    draws = JaxStreamDraws.from_seed(jp.seed, N, jp.ransac_hypotheses,
                                     width=4)
    port = MultiStreamStabilizer(StabilizerParams(**kw), N, mode=CPU,
                                 ransac_draws=draws)
    _assert_same_run(_drive(port, batches[:12]), j_run)


def test_deep_stabilization_with_reset_matches_jax(batches):
    """The network on the N gray pairs in one pass, one shared network;
    stream 1 reset mid-run. Tolerances of the single-stream deep tests
    (bfloat16 convolutions in both packages)."""
    kw = dict(SMALL, deep_stabilization=True)
    short = batches[:12]
    j_run = _drive(JMulti(JParams(**kw), n_streams=2), short[:, :2],
                   reset=1)
    port = MultiStreamStabilizer(StabilizerParams(**kw), 2, mode=CPU)
    _assert_same_run(_drive(port, short[:, :2], reset=1), j_run,
                     tr_tol=BF16_BOUND, frac=0.98)


def test_serve_remote_streams_over_the_jax_frame_server():
    """The serving loop over the port's own RemoteFrameServer and
    RemoteFrameSink (JPEG over TCP on loopback, a port the OS picks): one
    batched step per tick, and every stream emits after the shared
    warm-up."""
    import socket

    from video_stab_tpu_torch.io.remote import (RemoteFrameServer,
                                                RemoteFrameSink)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port_no = s.getsockname()[1]
    srv = RemoteFrameServer(port=port_no, queue_size=16).start()
    sinks = []
    try:
        rng = np.random.default_rng(3)
        n, p = 4, StabilizerParams(**SMALL)
        sinks = [RemoteFrameSink("127.0.0.1", port_no, stream_id=i,
                                 quality=90) for i in range(n)]
        n_ticks = p.effective_radius + 3
        for _ in range(n_ticks + 2):
            for s in sinks:
                s.write(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8))
        ms = MultiStreamStabilizer(p, n, mode=CPU)
        got = {}

        def on_output(sid, frame):
            got[sid] = got.get(sid, 0) + 1
            assert frame.shape == (48, 64, 3)

        stats = serve_remote_streams(srv, ms, list(range(n)), n_ticks,
                                     on_output=on_output)
        assert stats["ticks"] == n_ticks
        assert sorted(got) == list(range(n)), got
        assert (stats["emitted"] >= 2).all(), stats
    finally:
        for s in sinks:
            s.close()
        srv.stop()


def test_each_stage_runs_once_per_tick_for_all_streams(batches,
                                                       monkeypatch):
    """The plain versions of K3, K6 and K1 are called once a tick for the
    whole batch (K3 on re-detect ticks only), not once per stream."""
    from video_stab_tpu_torch.kernels import features as kf
    from video_stab_tpu_torch.kernels import lk as klk
    from video_stab_tpu_torch.kernels import warp as kw

    calls = {"k3": 0, "k6": 0, "k1": 0}

    def spy(key, fn, batched_arg):
        def wrapped(*a, **k):
            if batched_arg(a):
                calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(kf, "corner_response_plain", spy(
        "k3", kf.corner_response_plain, lambda a: a[0].dim() == 3))
    monkeypatch.setattr(klk, "lk_levels_plain", spy(
        "k6", klk.lk_levels_plain, lambda a: a[2].dim() == 3))
    monkeypatch.setattr(kw, "warp_affine_u8_batched_plain", spy(
        "k1", kw.warp_affine_u8_batched_plain, lambda a: True))
    p = StabilizerParams(**SMALL)
    ms = MultiStreamStabilizer(p, N, mode=CPU)
    ms.stabilize_batch(batches[0])                  # init: GFTT only
    assert calls == {"k3": 1, "k6": 0, "k1": 0}
    for t in range(1, 5):
        before = dict(calls)
        ms.stabilize_batch(batches[t])
        assert calls["k6"] - before["k6"] == 1
        assert calls["k1"] - before["k1"] == 1
        assert calls["k3"] - before["k3"] == \
            (1 if t % p.redetect_interval == 0 else 0)


@pytest.mark.parametrize("field,value", [
    ("enable_virtual_canvas", True),
    ("border_type", "fade"),
    ("border_size", 8),
    ("feature_detector", "orb"),
    ("feature_detector", "fast"),
    ("feature_detector", "brisk"),
    ("aux_rotation_deg", 3.0),
])
def test_check_supported_batched_refuses(field, value):
    p = StabilizerParams(**{**SMALL, field: value})
    with pytest.raises(NotImplementedError, match=field) as exc:
        check_supported_batched(p)
    assert "ROADMAP queue 1 item 11b" in str(exc.value)
    with pytest.raises(NotImplementedError):
        MultiStreamStabilizer(p, 2, mode=CPU)


@pytest.mark.parametrize("kw", [
    {"border_type": "reflect"},
    {"crop_n_zoom": True, "border_size": 8},
    {"crop_n_zoom": True, "border_size": 30, "border_type": "reflect_101"},
    {"crop_n_zoom": True, "border_size": 8, "border_type": "fade"},
    {"drone_high_freq_mode": True},
    {"motion_prediction": True},
])
def test_check_supported_batched_takes_the_drone_mode(kw):
    """Upstream's drone mode and crop-and-zoom with every border type (the
    border's size is the crop; its type is unused), and a border type
    with no border, which pads nothing."""
    p = StabilizerParams(**{**SMALL, **kw})
    check_supported_batched(p)
    MultiStreamStabilizer(p, 2, mode=CPU)


def test_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="use_cuda"):
        MultiStreamStabilizer(StabilizerParams(**SMALL), 2)


def test_batched_state_init_takes_the_card_unless_asked_for_the_cpu(
        monkeypatch):
    """With no device, ``batched_state_init`` takes the card through
    ``pick_device`` and raises without one; with ``device="cpu"`` each
    field is the single stream's initial state with a leading N, and
    stream i's generator is seeded with seed + i."""
    p = StabilizerParams(**SMALL)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="use_cuda"):
        batched_state_init(p, 2, 48, 64)
    state = batched_state_init(p, 2, 48, 64, device="cpu")
    one = stabilizer_state_init(p, 48, 64, torch.device("cpu"))
    for name in StabilizerState._fields:
        got, want = getattr(state, name), getattr(one, name)
        if name == "key":
            assert [g.initial_seed() for g in got] == [p.seed, p.seed + 1]
            continue
        if name == "deepstab":
            assert got == ()
            continue
        pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
        for g, w in pairs:
            assert g.device.type == "cpu", name
            assert g.shape == (2,) + tuple(w.shape), name
            assert torch.equal(g, w.unsqueeze(0).expand_as(g)) or \
                name == "frame_ring", name
    assert not state.frame_ring.any()
