"""The PyTorch port's host runtime (``io/sources.py``, ``io/channels.py``,
``io/control.py``, ``io/sinks.py``) against the JAX package's: the
streaming tests of ``tests/test_io.py`` (fake frame sources, the stream
graph's routing and hot switch, delivery during a hand-over, lossless
channels, the TCP receiver, the REST update and endpoints, the sinks'
bitrate heuristics and MJPEG preview, keyboard dispatch) run once per
package. Servers bind ports the OS picks, so parallel workers never
collide. ``open_sink`` dispatches the encoder targets (``.h264``,
``.264``, ``.mp4``, ``.mkv``, ``.mov``, ``rtsp://``) as the JAX package
does.
"""

import json
import os
import socket
import time
import types
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")

from video_stab_tpu.io import channels as jchannels  # noqa: E402
from video_stab_tpu.io import control as jcontrol  # noqa: E402
from video_stab_tpu.io import rtsp as jrtsp  # noqa: E402
from video_stab_tpu.io import sinks as jsinks  # noqa: E402
from video_stab_tpu.io import sources as jsources  # noqa: E402
from video_stab_tpu.utils import config as jconfig  # noqa: E402
from video_stab_tpu_torch.io import channels as tchannels  # noqa: E402
from video_stab_tpu_torch.io import control as tcontrol  # noqa: E402
from video_stab_tpu_torch.io import rtsp as trtsp  # noqa: E402
from video_stab_tpu_torch.io import sinks as tsinks  # noqa: E402
from video_stab_tpu_torch.io import sources as tsources  # noqa: E402
from video_stab_tpu_torch.utils import config as tconfig  # noqa: E402

PACKAGES = {
    "jax": types.SimpleNamespace(sources=jsources, channels=jchannels,
                                 control=jcontrol, sinks=jsinks,
                                 config=jconfig, rtsp=jrtsp),
    "torch": types.SimpleNamespace(sources=tsources, channels=tchannels,
                                   control=tcontrol, sinks=tsinks,
                                   config=tconfig, rtsp=trtsp),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _src(pkg, **kw):
    params = pkg.sources.SourceParams(source="s",
                                      queue_size=kw.pop("queue_size", 5))
    return pkg.sources.SyntheticSource(params, **kw)


class _ListSink:
    def __init__(self):
        self.got = []

    def write(self, item):
        self.got.append(item)

    def close(self):
        pass


def test_synthetic_reads(pkg):
    src = _src(pkg, height=32, width=40, n_frames=5).start()
    frames = [src.read(timeout=1.0) for _ in range(5)]
    src.stop()
    assert all(f is not None and f.shape == (32, 40, 3) for f in frames)


def test_fault_injection_and_reconnect(pkg):
    src = _src(pkg, height=16, width=20, n_frames=0, fail_after=3,
               fail_count=12).start()
    got = 0
    deadline = time.monotonic() + 8.0
    while got < 6 and time.monotonic() < deadline:
        if src.read(timeout=0.5) is not None:
            got += 1
    stats = src.stats
    src.stop()
    assert got >= 6, (got, stats)
    assert stats["reconnects"] >= 1, stats


def test_bounded_queue_drops(pkg):
    src = _src(pkg, queue_size=2, height=16, width=20, n_frames=50).start()
    time.sleep(1.0)
    stats = src.stats
    src.stop()
    assert stats["frames_dropped"] > 0


def test_open_source_dispatch(pkg):
    src = pkg.sources.open_source("synthetic:40x24")
    assert isinstance(src, pkg.sources.SyntheticSource)
    assert (src.height, src.width) == (24, 40)
    assert isinstance(pkg.sources.open_source("clip.avi"),
                      pkg.sources.OpenCVSource)


def test_routing_and_hot_switch(pkg):
    g = pkg.channels.StreamGraph()
    src = _src(pkg, height=16, width=20, n_frames=0)
    sink = pkg.sinks.NullSink()
    seen = {"processed": 0}

    def proc(frame):
        seen["processed"] += 1
        return frame * 0

    g.add_pipeline("source", source=src.start(), publish_to="source")
    g.add_pipeline("processing", listen_to="source", processor=proc,
                   publish_to="processed")
    out = g.add_pipeline("output", listen_to="processed", sink=sink)
    g.start()
    time.sleep(0.5)
    assert sink.count > 0 and seen["processed"] > 0
    g.set_listen_to("output", "source")
    assert out.listen_to == "source"
    c0 = sink.count
    time.sleep(0.3)
    assert sink.count > c0
    assert [p["name"] for p in g.pipeline_list()] == \
        ["source", "processing", "output"]
    g.stop()


def test_switch_delivers_units_published_during_handover(pkg):
    g = pkg.channels.StreamGraph()
    sink = _ListSink()
    g.channel("a")
    g.channel("b")
    g.add_pipeline("output", listen_to="a", sink=sink)
    g.start()
    time.sleep(0.3)
    g.set_listen_to("output", "b")
    g.channel("b").publish("idr-unit")
    deadline = time.time() + 3.0
    while not sink.got and time.time() < deadline:
        time.sleep(0.02)
    g.stop()
    assert sink.got == ["idr-unit"]


def test_channel_bridge(pkg):
    g = pkg.channels.StreamGraph()
    br = pkg.channels.ChannelBridge(g, "a", "b")
    g.channel("a").publish(np.ones((4, 4, 3), np.uint8))
    f = br.read(timeout=0.5)
    assert f is not None
    br.push_frame(f * 3)
    out, _ = g.channel("b").subscribe(0, timeout=0.5)
    assert out[0, 0, 0] == 3
    assert br.frames_in == 1 and br.frames_out == 1
    assert br.is_healthy()
    br.stop()
    assert not br.is_healthy()


def test_listen_to_switch_joins_live(pkg):
    g = pkg.channels.StreamGraph()
    sink = _ListSink()
    g.channel("a").depth = 256
    g.channel("b").depth = 256
    for i in range(50):
        g.channel("a").publish(("a", i))
    for i in range(5):
        g.channel("b").publish(("b-stale", i))
    p = g.add_pipeline("out", listen_to="a", sink=sink)
    p.start()
    deadline = time.time() + 5
    while len(sink.got) < 50 and time.time() < deadline:
        time.sleep(0.01)
    assert len(sink.got) == 50
    p.listen_to = "b"
    time.sleep(0.8)
    n_before = len(sink.got)
    for i in range(7):
        g.channel("b").publish(("b-live", i))
    deadline = time.time() + 5
    while len(sink.got) < n_before + 7 and time.time() < deadline:
        time.sleep(0.01)
    p.stop()
    assert sink.got[n_before:] == [("b-live", i) for i in range(7)]


def test_lossless_channel_in_order(pkg):
    ch = pkg.channels.Channel("pkt", depth=64)
    for i in range(50):
        ch.publish(i)
    seq, got = 0, []
    while True:
        item, seq2 = ch.subscribe(seq, timeout=0.01)
        if item is None:
            break
        got.append(item)
        seq = seq2
    assert got == list(range(50))


def test_latest_only_and_overflow(pkg):
    ch = pkg.channels.Channel("frames")
    for i in range(10):
        ch.publish(i)
    assert ch.subscribe(0, timeout=0.01)[0] == 9
    ch = pkg.channels.Channel("pkt", depth=4)
    for i in range(10):
        ch.publish(i)
    item, seq = ch.subscribe(0, timeout=0.01)
    assert item == 6
    assert ch.subscribe(seq, timeout=0.01)[0] == 7


def test_tcp_receiver(pkg):
    tcp = pkg.control.TcpReceiver(0).start()
    port = tcp._sock.getsockname()[1]
    s = socket.create_connection(("127.0.0.1", port))
    try:
        s.sendall(b"10 20\n30 40\nbad line\n")
        deadline = time.time() + 3.0
        while tcp._latest != (30, 40) and time.time() < deadline:
            time.sleep(0.02)      # peek: the exchange below consumes it
        assert tcp.try_get_latest() == (30, 40)
        assert tcp.try_get_latest() is None
    finally:
        s.close()
        tcp.stop()
    assert pkg.control.TcpReciever is pkg.control.TcpReceiver


def test_rest_update_and_backup(pkg, tmp_path):
    path = str(tmp_path / "c.yaml")
    pkg.config.save_config(pkg.config.AppConfig(), path)
    res = pkg.control.apply_rest_update(path, {"smoothingRadius": 21,
                                               "gamma": 0.8, "nope": 1})
    assert res["applied"] == {"smoothingRadius": 21, "gamma": 0.8}
    assert "nope" in res["ignored"]
    assert os.path.exists(path + ".backup")
    cfg = pkg.config.load_config(path)
    assert cfg.stabilizer.smoothing_radius == 21
    assert abs(cfg.enhancer.gamma - 0.8) < 1e-6


def test_rest_server_endpoints(pkg, tmp_path):
    path = str(tmp_path / "c.yaml")
    pkg.config.save_config(pkg.config.AppConfig(), path)
    srv = pkg.control.ConfigRestServer(path, port=0).start()
    url = f"http://127.0.0.1:{srv._server.server_address[1]}"
    try:
        health = json.load(urllib.request.urlopen(url + "/health"))
        assert health == {"status": "healthy"}
        req = urllib.request.Request(
            url + "/stabilization",
            data=json.dumps({"horizonLock": True}).encode())
        assert json.load(urllib.request.urlopen(req))["status"] == "ok"
        assert pkg.config.load_config(path).stabilizer.horizon_lock is True
    finally:
        srv.stop()


def test_bitrate_heuristics(pkg):
    s = pkg.sinks
    assert s.bitrate_kbps_server(1920, 1080, 30) == \
        max(2000, int(1920 * 1080 * 30 / 500))
    assert s.bitrate_bps_app(640, 360, 30) == 2_000_000
    assert s.bitrate_bps_app(3840, 2160, 60) == 8_000_000


def test_mjpeg_server_serves_frames(pkg):
    srv = pkg.sinks.MJPEGServer(port=0).start()
    try:
        srv.push_frame(np.full((32, 40, 3), 128, np.uint8))
        url = (f"http://127.0.0.1:{srv._server.server_address[1]}"
               f"{srv.mount}")
        data = urllib.request.urlopen(url, timeout=2.0).read(200)
        assert b"vstabframe" in data and b"image/jpeg" in data
    finally:
        srv.close()


def test_file_and_null_sinks(pkg, tmp_path):
    s = pkg.sinks
    assert isinstance(s.open_sink(""), s.NullSink)
    assert isinstance(s.open_sink("null"), s.NullSink)
    path = str(tmp_path / "o.avi")
    sink = s.open_sink(path, fps=10.0)
    assert isinstance(sink, s.FileSink)
    for i in range(3):
        sink.write(np.full((48, 64, 3), 40 * i, np.uint8))
    sink.close()
    assert sink.frames_written == 3 and os.path.getsize(path) > 0
    got = []
    s.CallbackSink(got.append).write(1)
    assert got == [1]


def test_keyboard_dispatch(pkg):
    hits = []
    kc = pkg.control.KeyboardController(lambda: hits.append("p"),
                                        lambda: hits.append("r"),
                                        lambda: hits.append("s"),
                                        lambda: hits.append("q"))
    for k in ["p", "r", "s", "q", "\x1b", "x"]:
        kc.handle_key(k)
    assert hits == ["p", "r", "s", "q", "q"]


@pytest.mark.parametrize("target,kind", [
    ("out.h264", "H264FileSink"), ("out.264", "H264FileSink"),
    ("out.mp4", "ContainerSink"), ("out.MKV", "ContainerSink"),
    ("out.mov", "ContainerSink"), ("rtsp://127.0.0.1:{port}/live",
                                   "RTSPServer")])
def test_open_sink_dispatches_encoder_targets(pkg, target, kind, tmp_path):
    """The encoder targets go to the native codec layer's sinks: Annex-B
    files to H264FileSink, containers to ContainerSink, rtsp:// to a
    started RTSPServer on the URL's port and mount."""
    if target.startswith("rtsp://"):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        target = target.format(port=port)
        cls = pkg.rtsp.RTSPServer
    else:
        target = str(tmp_path / target)
        cls = getattr(pkg.sinks, kind)
    sink = pkg.sinks.open_sink(target, fps=25.0)
    try:
        assert type(sink) is cls
        if kind == "RTSPServer":
            assert (sink.port, sink.mount, sink.fps) == (port, "/live", 25)
            assert sink.url == target
        else:
            assert (sink.path, sink.fps) == (target, 25.0)
    finally:
        sink.close()
