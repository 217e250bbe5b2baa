"""The PyTorch port's application (``io/runner.py:StabilizerApp``) on the
CPU, against the JAX package's, and its lifecycle.

Held:
- ``_process_frame`` of both apps on the same 24 frames, fused (one
  ``ProcessingChain``) and unfused (``Enhancer`` -> ``RollCorrection`` ->
  ``Stabilizer``), with the JAX package's RANSAC draws injected by swapping
  in the port's chain / stabilizer built with ``ransac_draws=``: the same
  warm-up frames and, on the emitted ones, >= 99.5 % of pixels within 1
  (``tests/test_torch_chain.py``'s tolerance);
- passthrough <-> processing through ``switch_*`` and through a rewritten
  YAML file (``ConfigWatcher``), with the chain rebuilt and dropped; a
  reload whose rebuild raises leaving the running config whole;
- ``stop()`` draining exactly the chain's queued frames into the sink;
- the threaded graph delivering frames with the tracker on;
- ``use_cuda: true`` without a card raising; ``packet_mode=True``
  building the compressed-domain graph;
- stream-state checkpoints crossing between the packages both ways.
"""

import dataclasses
import logging
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from video_stab_tpu.core import params as jparams  # noqa: E402
from video_stab_tpu.core import state as jstate  # noqa: E402
from video_stab_tpu.io import runner as jrunner  # noqa: E402
from video_stab_tpu.io import sinks as jsinks  # noqa: E402
from video_stab_tpu.utils import checkpoint as jckpt  # noqa: E402
from video_stab_tpu.utils import config as jconfig  # noqa: E402
from video_stab_tpu_torch.core import params as tparams  # noqa: E402
from video_stab_tpu_torch.core import state as tstate  # noqa: E402
from video_stab_tpu_torch.core.chain import ProcessingChain  # noqa: E402
from video_stab_tpu_torch.core.stabilizer import Stabilizer  # noqa: E402
from video_stab_tpu_torch.io import runner as trunner  # noqa: E402
from video_stab_tpu_torch.io import sinks as tsinks  # noqa: E402
from video_stab_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from video_stab_tpu_torch.utils import config as tconfig  # noqa: E402

H, W = 192, 256
N = 24


class JaxDraws:
    """RANSAC draws from the JAX package's stream key chain (see
    test_torch_stabilizer.py)."""

    def __init__(self, key, n_hypotheses):
        self.key = jnp.asarray(key)
        self.k = n_hypotheses

    def __call__(self, n_valid):
        self.key, sub = jax.random.split(self.key)
        d = jax.random.randint(sub, (self.k, 2), 0, max(int(n_valid), 1))
        return torch.from_numpy(np.array(d, np.int64))


def _frames():
    """A jittering window over a smooth random world with a ~2 deg tilted
    horizon composited in, so the roll stage engages."""
    rng = np.random.default_rng(0)
    pad = 32
    world = rng.random((H + 2 * pad, W + 2 * pad)).astype(np.float32)
    kern = np.exp(-0.5 * (np.arange(-6, 7) / 2.0) ** 2)
    kern /= kern.sum()
    world = np.apply_along_axis(
        lambda r: np.convolve(r, kern, mode="same"), 1, world)
    world = np.apply_along_axis(
        lambda c: np.convolve(c, kern, mode="same"), 0, world)
    world -= world.min()
    world /= max(world.max(), 1e-6)
    world = (world * 255.0).astype(np.uint8)
    yy = np.arange(H, dtype=np.float32)[:, None, None]
    xx = np.arange(W, dtype=np.float32)[None, :, None]
    sky = yy < (H / 2.0 + np.tan(np.radians(2.0)) * (xx - W / 2.0))
    out = []
    for _ in range(N):
        dx, dy = rng.integers(-6, 7, 2)
        f = world[pad + dy:pad + dy + H, pad + dx:pad + dx + W]
        f = np.stack([f, np.roll(f, 1, 0), 255 - f], axis=-1)
        out.append(np.clip(f * 0.75 + sky * 60.0, 0, 255).astype(np.uint8))
    return out


def _config(cm, pm, **mode):
    """An AppConfig of package ``cm`` (config module) over params module
    ``pm``: enhance -> roll -> stabilize at a small analysis size."""
    m = dict(enhancer_enabled=True, roll_correction_enabled=True,
             stabilizer_enabled=True)
    m.update(mode)
    return cm.AppConfig(
        video_source=f"synthetic:{W}x{H}",
        mode=pm.ModeParams(**m),
        enhancer=pm.EnhancerParams(brightness=5.0, contrast=1.1, gamma=0.9),
        roll_correction=pm.RollCorrectionParams(hough_threshold=30),
        stabilizer=pm.StabilizerParams(
            smoothing_radius=5, analysis_width=64, analysis_height=48,
            max_corners=32, ransac_hypotheses=32))


def _port_config(**mode):
    return _config(tconfig, tparams, use_cuda=False, **mode)


def _close(a, b):
    return (np.abs(a.astype(np.int64) - b.astype(np.int64)) <= 1).mean()


def _run(app, frames):
    return [app._process_frame(f) for f in frames]


@pytest.fixture(scope="module")
def clip():
    return _frames()


@pytest.fixture(scope="module", params=["fused", "unfused"])
def jax_route(request, clip):
    """The JAX app's _process_frame over the clip, one route per param."""
    fused = request.param == "fused"
    app = jrunner.StabilizerApp(_config(jconfig, jparams),
                                sink=jsinks.NullSink(), fused=fused)
    outs = _run(app, clip)
    return fused, outs, app.metrics.snapshot()


def _port_app(fused):
    app = trunner.StabilizerApp(_port_config(), sink=tsinks.NullSink(),
                                fused=fused)
    cfg = app.cfg
    draws = JaxDraws(jax.random.PRNGKey(cfg.stabilizer.seed),
                     cfg.stabilizer.ransac_hypotheses)
    if fused:
        app.chain = ProcessingChain(cfg.mode, cfg.enhancer,
                                    cfg.roll_correction, cfg.stabilizer,
                                    azc=cfg.auto_zoom_crop,
                                    fuse_roll=cfg.roll_fusion,
                                    ransac_draws=draws)
    else:
        app.stabilizer = Stabilizer(cfg.stabilizer, mode=cfg.mode,
                                    ransac_draws=draws)
    return app


def test_process_frame_matches_jax(jax_route, clip):
    fused, j_outs, j_snap = jax_route
    app = _port_app(fused)
    assert (app.chain is not None) == fused
    assert app.device == torch.device("cpu")
    t_outs = _run(app, clip)
    assert [o is None for o in t_outs] == [o is None for o in j_outs]
    emitted = [(a, b) for a, b in zip(t_outs, j_outs) if b is not None]
    assert len(emitted) == N - 4
    for a, b in emitted:
        assert a.shape == b.shape and a.dtype == np.uint8
        assert _close(a, np.asarray(b)) >= 0.995
    snap = app.metrics.snapshot()
    assert snap["counters"] == j_snap["counters"]
    assert sorted(snap["gauges"]) == sorted(j_snap["gauges"])
    stages = {"fused_chain"} if fused else {"enhance", "roll", "stabilize"}
    assert set(snap["stages"]) == stages == set(j_snap["stages"])


def test_stop_drains_the_chain_into_the_sink(clip):
    sink = []
    app = trunner.StabilizerApp(_port_config(),
                                sink=tsinks.CallbackSink(sink.append))
    twin = ProcessingChain(app.cfg.mode, app.cfg.enhancer,
                           app.cfg.roll_correction, app.cfg.stabilizer,
                           azc=app.cfg.auto_zoom_crop)
    for f in clip[:12]:
        app._process_frame(f)
        twin.process(f)
    queued = app.chain._frames_in - app.chain._emitted
    assert queued == app.cfg.stabilizer.effective_radius - 1
    app.stop()
    assert len(sink) == queued
    for got in sink:
        np.testing.assert_array_equal(got, twin.flush())
    assert twin.flush() is None


def _write(cfg, path):
    tconfig.save_config(cfg, path)
    t = time.time() + 10 * (1 + _write.count)
    _write.count += 1
    os.utime(path, (t, t))     # a distinct mtime even on coarse clocks


_write.count = 0


def test_passthrough_processing_switching(tmp_path):
    path = str(tmp_path / "app.yaml")
    off = _port_config(enhancer_enabled=False, roll_correction_enabled=False,
                       stabilizer_enabled=False)
    _write(off, path)
    app = trunner.run_app(path, sink=tsinks.NullSink())
    out = app.graph.pipeline("output")
    assert out.listen_to == "source" and app.chain is None
    app.switch_processing()
    assert out.listen_to == "processed"
    app.switch_passthrough()
    assert out.listen_to == "source"
    for cycle in range(2):
        _write(dataclasses.replace(off, mode=dataclasses.replace(
            off.mode, stabilizer_enabled=True)), path)
        assert app.watcher.check_once()
        assert out.listen_to == "processed"
        assert app.chain is not None
        assert app.chain.params.stabilizer.smoothing_radius == 5
        _write(off, path)
        assert app.watcher.check_once()
        assert out.listen_to == "source" and app.chain is None
        assert app.metrics.counters["config_reloads"] == 2 * (cycle + 1)
    app.stop()


def test_failed_reload_keeps_the_running_config(tmp_path, monkeypatch):
    """A reload whose rebuild raises leaves the config, the device, the
    chain and the route as they were, and the watcher logs it."""
    path = str(tmp_path / "app.yaml")
    cfg = _port_config()
    _write(cfg, path)
    app = trunner.run_app(path, sink=tsinks.NullSink())
    before = (app.cfg, app.device, app.chain)
    out = app.graph.pipeline("output")
    assert out.listen_to == "processed"

    def broken(*args, **kwargs):
        raise RuntimeError("rebuild failed")

    monkeypatch.setattr(trunner, "ProcessingChain", broken)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    app.watcher.log.addHandler(handler)
    try:
        _write(dataclasses.replace(cfg, stabilizer=dataclasses.replace(
            cfg.stabilizer, smoothing_radius=9)), path)
        assert not app.watcher.check_once()
    finally:
        app.watcher.log.removeHandler(handler)
    assert (app.cfg, app.device, app.chain) == before
    assert app.cfg.stabilizer.smoothing_radius == 5
    assert out.listen_to == "processed"
    assert "config_reloads" not in app.metrics.counters
    assert [r.exc_info[1].args for r in records] == [("rebuild failed",)]
    app.stop()


def test_keys_switch_the_output(tmp_path):
    cfg = _port_config(roll_correction_enabled=False,
                       stabilizer_enabled=False)
    app = trunner.StabilizerApp(cfg, fused=False)
    assert app.graph.pipeline("output").listen_to == "processed"
    app.keyboard = trunner.KeyboardController(
        app.switch_passthrough, app.switch_processing, app.print_status,
        app._stop.set)
    app.keyboard.handle_key("p")
    assert app.graph.pipeline("output").listen_to == "source"
    app.keyboard.handle_key("r")
    assert app.graph.pipeline("output").listen_to == "processed"
    app.keyboard.handle_key("q")
    assert app._stop.is_set()


def test_threaded_graph_with_tracker_delivers():
    cfg = dataclasses.replace(
        _port_config(tracker_enabled=True),
        video_source="synthetic:128x96",
        tracker=tconfig.TrackerParams(processing_width=96,
                                      processing_height=64,
                                      confidence_threshold=0.99))
    cfg = dataclasses.replace(cfg, stabilizer=dataclasses.replace(
        cfg.stabilizer, analysis_width=128, analysis_height=96))
    sink = tsinks.NullSink()
    app = trunner.StabilizerApp(cfg, sink=sink)
    app.start()
    deadline = time.monotonic() + 60.0
    while sink.count < 3 and time.monotonic() < deadline:
        time.sleep(0.1)
    app.stop()
    assert sink.count >= 3, sink.count
    assert app._tracker._frame_count >= 1
    assert "track" in app.metrics.timer.summary()


def test_use_cuda_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="use_cuda"):
        trunner.StabilizerApp(_config(tconfig, tparams),
                              sink=tsinks.NullSink())
    repo = os.path.join(os.path.dirname(__file__), os.pardir)
    with pytest.raises(RuntimeError, match="use_cuda"):
        trunner.run_app(os.path.join(repo, "configs", "selftest.yaml"))
    # The override pins the CPU for the config and for every reload.
    path = str(tmp_path / "app.yaml")
    _write(_config(tconfig, tparams), path)
    app = trunner.run_app(path, sink=tsinks.NullSink(), use_cuda=False)
    assert app.device == torch.device("cpu")
    _write(_config(tconfig, tparams, stabilizer_enabled=False), path)
    assert app.watcher.check_once()
    assert app.device == torch.device("cpu")
    assert app.chain.params.mode.use_cuda is False
    app.stop()


def test_packet_mode_builds_the_packet_graph(tmp_path):
    """packet_mode=True on an Annex-B source: access units ride the
    lossless source_pkt / processed_pkt channels, processing is routed
    from the start (the stabilizer is on), the chain delivers I420 to the
    encoder bridge, and no decoder exists before a unit arrives."""
    from video_stab_tpu_torch.io import codec as tcodec
    from video_stab_tpu_torch.io.packets import PacketFileSink, PacketSource

    if not tcodec.available():
        pytest.skip("native codec layer unavailable")
    src = str(tmp_path / "in.h264")
    enc = tcodec.VideoEncoder(W, H, 30, bitrate_bps=400_000)
    with open(src, "wb") as f:
        for frame in _frames()[:4]:
            f.write(enc.encode(frame))
        f.write(enc.flush())
    enc.close()
    cfg = dataclasses.replace(_port_config(), video_source=src,
                              output_source=str(tmp_path / "out.h264"))
    app = trunner.StabilizerApp(cfg, packet_mode=True)
    try:
        assert app.packet_mode
        assert isinstance(app.source, PacketSource)
        assert isinstance(app.sink, PacketFileSink)
        assert app.graph.channel("source_pkt").depth == 256
        assert app.graph.channel("processed_pkt").depth == 256
        assert app.graph.pipeline("output").listen_to == "processed_pkt"
        assert app.chain.params.output_format == "i420"
        assert not app.decoder_constructed
    finally:
        app.stop()


SMALL = dict(smoothing_radius=4, analysis_width=64, analysis_height=48,
             max_corners=32, ransac_hypotheses=32)


def _jax_stream(clip, n):
    from video_stab_tpu.core.stabilizer import Stabilizer as JStabilizer
    js = JStabilizer(jparams.StabilizerParams(**SMALL))
    for f in clip[:n]:
        js.stabilize(f)
    return js


def _leaves_equal(got, want):
    gl, gdef = jax.tree_util.tree_flatten(got)
    wl, wdef = jax.tree_util.tree_flatten(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_from_jax_loads_into_the_port(clip, tmp_path):
    js = _jax_stream(clip, 8)
    path = str(tmp_path / "jax.npz")
    jckpt.save_state(js._state, path)
    template = tstate.stabilizer_state_init(
        tparams.StabilizerParams(**SMALL), H, W, "cpu")
    got = tckpt.load_state(path, template)
    want = tstate.state_from_numpy(js.state_dict(), "cpu")
    for name in tstate.StabilizerState._fields:
        a, b = getattr(got, name), getattr(want, name)
        if name == "key":
            assert a.initial_seed() == b.initial_seed()
        elif name != "deepstab":
            _leaves_equal(a, b)


def test_checkpoint_from_the_port_loads_into_jax(clip, tmp_path):
    st = Stabilizer(tparams.StabilizerParams(**SMALL),
                    mode=tparams.ModeParams(use_cuda=False))
    for f in clip[:8]:
        st.stabilize(f)
    path = str(tmp_path / "port.npz")
    tckpt.save_state(st._state, path)
    template = jstate.stabilizer_state_init(
        jparams.StabilizerParams(**SMALL), H, W)
    got = jckpt.load_state(path, template)
    want = tstate.state_to_numpy(st._state)
    for name in tstate.StabilizerState._fields:
        if name != "deepstab":
            _leaves_equal(getattr(got, name), want[name])


def test_checkpoint_resumes_the_port_stream(clip, tmp_path):
    """A port stream saved and loaded continues bit for bit, its RANSAC
    draws included."""
    mode = tparams.ModeParams(use_cuda=False)
    params = tparams.StabilizerParams(**SMALL)
    a = Stabilizer(params, mode=mode)
    for f in clip[:10]:
        a.stabilize(f)
    path = str(tmp_path / "s.npz")
    tckpt.save_state(a._state, path)
    b = Stabilizer(params, mode=mode)
    b._state = tckpt.load_state(
        path, tstate.stabilizer_state_init(params, H, W, "cpu"))
    b._shape, b._frames_in, b._emitted = a._shape, a._frames_in, a._emitted
    for f in clip[10:16]:
        np.testing.assert_array_equal(b.stabilize(f), a.stabilize(f))
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_state(path, tstate.stabilizer_state_init(
            params, H // 2, W, "cpu"))
