"""The port's compressed-domain packet graph (``io/packets.py``, the
packet branch of ``io/runner.py`` and the daemon of ``io/daemon.py``)
against the JAX package's: every case of ``tests/test_packets.py`` runs
once per package through the ``pkg`` fixture — byte-identical H.264 relay
with no decode (GstdManager.cpp:155-180), access-unit grouping, the
decoder bridge and the hot switch at the next IDR, RTSP ingest over TCP
and UDP with loss and reorder handling, H.265 over RTSP, container demux
and remux, SPS dimensions, the app's packet graph and the graph daemon.
The port's app runs on the CPU (``use_cuda=False``) with the small
stabilizer of the JAX cases. Servers bind ports the OS picks, so parallel
workers never collide. Then the port's repair of a reference defect:
packet-mode processing at a frame height the I420 layout cannot hold
(H % 4 != 0) runs the chain in BGR instead of raising.
"""

import os
import socket
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from video_stab_tpu.core import params as jparams  # noqa: E402
from video_stab_tpu.io import codec as jcodec  # noqa: E402
from video_stab_tpu.io import daemon as jdaemon  # noqa: E402
from video_stab_tpu.io import packets as jpackets  # noqa: E402
from video_stab_tpu.io import rtsp as jrtsp  # noqa: E402
from video_stab_tpu.io import runner as jrunner  # noqa: E402
from video_stab_tpu.utils import config as jconfig  # noqa: E402
from video_stab_tpu_torch.core import params as tparams  # noqa: E402
from video_stab_tpu_torch.io import codec as tcodec  # noqa: E402
from video_stab_tpu_torch.io import daemon as tdaemon  # noqa: E402
from video_stab_tpu_torch.io import packets as tpackets  # noqa: E402
from video_stab_tpu_torch.io import rtsp as trtsp  # noqa: E402
from video_stab_tpu_torch.io import runner as trunner  # noqa: E402
from video_stab_tpu_torch.utils import config as tconfig  # noqa: E402

vcodec = tcodec     # the fixtures' encoder: the same inputs for both


class _CpuApp(trunner.StabilizerApp):
    """The port's app on the CPU, as the JAX cases run theirs."""

    def __init__(self, *args, **kw):
        kw.setdefault("use_cuda", False)
        super().__init__(*args, **kw)


PACKAGES = {
    "jax": types.SimpleNamespace(
        codec=jcodec, packets=jpackets, rtsp=jrtsp, runner=jrunner,
        daemon=jdaemon, params=jparams, config=jconfig),
    "torch": types.SimpleNamespace(
        codec=tcodec, packets=tpackets, rtsp=trtsp,
        runner=types.SimpleNamespace(StabilizerApp=_CpuApp),
        daemon=tdaemon, params=tparams, config=tconfig),
}

pytestmark = pytest.mark.skipif(
    not (jcodec.available() and tcodec.available()),
    reason="native codec layer unavailable")


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def free_port() -> int:
    """A TCP port the OS picks and releases (a server binds it next)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def h264_file(tmp_path_factory):
    """A real H.264 elementary stream written by the native encoder."""
    path = str(tmp_path_factory.mktemp("pkt") / "src.h264")
    enc = vcodec.VideoEncoder(320, 240, 30, bitrate_bps=800_000)
    yy, xx = np.mgrid[0:240, 0:320]
    with open(path, "wb") as f:
        for i in range(48):
            base = ((yy + xx + 4 * i) % 256).astype(np.uint8)
            frame = np.stack([base, base, 255 - base], -1)
            f.write(enc.encode(frame))
        f.write(enc.flush())
    enc.close()
    return path


class TestPassthrough:
    def test_byte_identical_relay_no_decode(self, pkg, h264_file, tmp_path):
        """Passthrough relays the bitstream byte-for-byte and constructs
        no decoder (the reference's whole point: ~0 processing cost)."""
        PacketFileSink = pkg.packets.PacketFileSink
        PacketRelay = pkg.packets.PacketRelay
        PacketSource = pkg.packets.PacketSource
        out_path = str(tmp_path / "relay.h264")
        src = PacketSource(h264_file)
        sink = PacketFileSink(out_path)
        relay = PacketRelay(src, sinks=[sink]).start()
        relay.join()
        sink.close()
        src.stop()
        with open(h264_file, "rb") as a, open(out_path, "rb") as b:
            assert a.read() == b.read()
        assert relay.units_relayed == 48      # one AU per encoded frame

    def test_access_unit_grouping(self, pkg, h264_file):
        """One access unit per coded picture: the unit's first VCL NAL has
        first_mb_in_slice==0, follow-on slices (x264 sliced-threads) stay
        in the same unit, non-VCL NALs (SPS/PPS/SEI) attach forward."""
        VCL_TYPES = pkg.packets.VCL_TYPES
        PacketSource = pkg.packets.PacketSource
        _starts_new_picture = pkg.packets._starts_new_picture
        src = PacketSource(h264_file)
        aus = []
        while True:
            au = src.read()
            if au is None:
                break
            aus.append(au)
        src.stop()
        assert len(aus) == 48
        for au in aus:
            vcl = [n for n in au if pkg.codec.nal_type(n) in VCL_TYPES]
            assert len(vcl) >= 1
            assert _starts_new_picture(vcl[0])
            assert not any(_starts_new_picture(n) for n in vcl[1:])
        # SPS/PPS precede the first IDR inside the first unit
        types0 = [pkg.codec.nal_type(n) for n in aus[0]]
        assert 7 in types0 and 8 in types0 and 5 in types0

    def test_decoder_bridge_lazy_and_switch(self, pkg, h264_file, tmp_path):
        """Mode switch: passthrough first (no decoder), then the SAME
        packet feed is routed into the decoder bridge — the listen-to
        switch of GstdManager.cpp:324-327 in the packet domain."""
        PacketDecoderBridge = pkg.packets.PacketDecoderBridge
        PacketFileSink = pkg.packets.PacketFileSink
        PacketSource = pkg.packets.PacketSource
        src = PacketSource(h264_file)
        bridge = PacketDecoderBridge()
        sink = PacketFileSink(str(tmp_path / "tail.h264"))
        frames = []
        mode = "passthrough"
        i = 0
        while True:
            au = src.read()
            if au is None:
                break
            if mode == "passthrough":
                sink.write(au)
                assert not bridge.decoder_constructed
            else:
                frames += bridge.decode_unit(au)
            i += 1
            if i == 24:
                mode = "processing"   # the hot switch
        frames += bridge.flush()
        src.stop()
        sink.close()
        bridge.close()
        assert sink.units_written == 24
        # Decoding mid-stream picks up from the next IDR; with gop=30 the
        # switch at AU 24 recovers at AU 30 -> 18 frames.
        assert len(frames) >= 12, len(frames)
        assert frames[0].shape == (240, 320, 3)

    def test_chunk_boundaries_robust(self, pkg, h264_file):
        """Access units parse identically for any read granularity."""
        PacketSource = pkg.packets.PacketSource
        def read_all(chunk):
            src = PacketSource(h264_file, chunk_size=chunk)
            units = []
            while True:
                au = src.read()
                if au is None:
                    break
                units.append(b"".join(au))
            src.stop()
            return units
        assert read_all(7) == read_all(1 << 20)


class TestRTSPPacketRelay:
    def test_rtsp_passthrough_to_cv2(self, pkg, h264_file):
        """Compressed passthrough all the way to a real client: file ->
        PacketRelay -> RTSPServer.push_packet (no re-encode) -> cv2/ffmpeg
        decodes. The full GstdManager passthrough graph."""
        import threading
        import time

        import cv2

        PacketRelay = pkg.packets.PacketRelay
        PacketSource = pkg.packets.PacketSource
        RTSPServer = pkg.rtsp.RTSPServer
        server = RTSPServer(port=free_port(), mount="/pass", fps=30).start()
        stop = threading.Event()

        def loop_relay():
            while not stop.is_set():
                src = PacketSource(h264_file, realtime_fps=60)
                relay = PacketRelay(src, sinks=[server]).start()
                relay.join()
                src.stop()

        class _SinkAdapter:   # RTSPServer.write is push_frame; use packets
            def write(self, au):
                server.push_packet(au)

        def loop_relay2():
            while not stop.is_set():
                src = PacketSource(h264_file, realtime_fps=60)
                relay = PacketRelay(src, sinks=[_SinkAdapter()]).start()
                relay.join()
                src.stop()

        t = threading.Thread(target=loop_relay2, daemon=True)
        t.start()
        try:
            os.environ["OPENCV_FFMPEG_CAPTURE_OPTIONS"] = \
                "rtsp_transport;tcp"
            cap = cv2.VideoCapture(server.url, cv2.CAP_FFMPEG)
            assert cap.isOpened()
            got = 0
            deadline = time.time() + 20
            while got < 5 and time.time() < deadline:
                ok, frame = cap.read()
                if ok:
                    assert frame.shape == (240, 320, 3)
                    got += 1
            cap.release()
            assert got >= 5, f"only {got} frames"
        finally:
            stop.set()
            t.join(timeout=5)
            server.close()
            os.environ.pop("OPENCV_FFMPEG_CAPTURE_OPTIONS", None)


class TestUdpRtpTransport:
    """UDP unicast RTP (VERDICT r3 #7): server SETUP client_port/
    server_port + client-side datagram depacketization with
    drop-to-next-IDR loss handling."""

    def test_udp_packet_roundtrip_byte_identical(self, pkg, h264_file):
        import time

        PacketSource = pkg.packets.PacketSource
        RtspPacketSource = pkg.packets.RtspPacketSource
        RTSPServer = pkg.rtsp.RTSPServer

        srv = RTSPServer(port=free_port(), mount="/udp", fps=30).start()
        src = RtspPacketSource(srv.url, transport="udp").start()
        time.sleep(0.3)
        feed = PacketSource(h264_file)
        sent = []
        while (au := feed.read()) is not None:
            srv.push_packet(au)
            sent.append(au)
            time.sleep(0.005)       # pace: loopback UDP buffers are finite
        feed.stop()
        got = []
        while (au := src.read(timeout=2.0)) is not None:
            got.append(au)
        assert src.units_dropped == 0
        src.stop()
        srv.close()

        def strip(n):
            for sc in (b"\x00\x00\x00\x01", b"\x00\x00\x01"):
                if n.startswith(sc):
                    return n[len(sc):]
            return n

        # Keyframes exceed the 1400-byte UDP payload cap, so this also
        # proves FU-A fragmentation + reassembly over datagrams.
        assert any(len(strip(n)) > 1400 for au in sent for n in au)
        sent_p = [strip(n) for au in sent for n in au]
        recv_p = [strip(n) for au in got for n in au]
        assert recv_p == sent_p

    def test_udp_loss_resyncs_at_idr(self, pkg, h264_file):
        """A sequence gap (simulated loss) must drop the broken unit and
        hold emission until the next IDR — never hand the decoder a
        mid-GOP slice after loss."""
        PacketSource = pkg.packets.PacketSource
        RtspPacketSource = pkg.packets.RtspPacketSource
        packetize_h264 = pkg.rtsp.packetize_h264

        feed = PacketSource(h264_file)
        aus = []
        while (au := feed.read()) is not None:
            aus.append(au)
        feed.stop()
        assert len(aus) >= 10

        src = RtspPacketSource("rtsp://unused/", transport="udp")
        on_packet, finish = src._make_depacketizer()
        seq = 0
        for i, au in enumerate(aus):
            packets, seq = packetize_h264(au, 90000 * i, seq, 7,
                                          max_payload=1400)
            if i == 3:
                packets = packets[:-1]   # lose the unit's tail packet
                seq += 0                 # (seq already advanced by pack)
            for p in packets:
                on_packet(p)
        finish()
        got = []
        while (au := src._queue.get_nowait()) is not None:
            got.append(au)
        assert src.units_dropped >= 1

        def has_idr(au):
            return any(pkg.codec.nal_type(n) == 5 for n in au)

        def strip(n):
            for sc in (b"\x00\x00\x00\x01", b"\x00\x00\x01"):
                if n.startswith(sc):
                    return n[len(sc):]
            return n

        def payloads(units):
            return [[strip(n) for n in au] for au in units]

        # Units 0..2 arrive; unit 3 is dropped; 4+ are held until the next
        # IDR — emission must resume exactly there, skipping every mid-GOP
        # unit after the loss.
        next_idr = next(i for i in range(4, len(aus)) if has_idr(aus[i]))
        assert payloads(got) == payloads(aus[:3] + aus[next_idr:]), (
            len(got), next_idr, len(aus))

    def test_udp_reorder_costs_one_resync_not_a_cascade(self, pkg, h264_file):
        """A reordered packet pair is ONE gap event, not a cascade: the
        late packet must be ignored (stale) without rewinding expect_seq —
        a rewind would declare a fresh false gap for every in-flight
        packet that follows, multiplying the drop-to-next-IDR cost."""
        PacketSource = pkg.packets.PacketSource
        RtspPacketSource = pkg.packets.RtspPacketSource
        packetize_h264 = pkg.rtsp.packetize_h264

        feed = PacketSource(h264_file)
        aus = []
        while (au := feed.read()) is not None:
            aus.append(au)
        feed.stop()

        src = RtspPacketSource("rtsp://unused/", transport="udp")
        on_packet, finish = src._make_depacketizer()
        seq = 0
        for i, au in enumerate(aus):
            # Small payload cap forces >=3 FU fragments per unit so a
            # WITHIN-unit adjacent swap exists.
            packets, seq = packetize_h264(au, 90000 * i, seq, 7,
                                          max_payload=200)
            if i == 3:
                assert len(packets) >= 3
                packets[1], packets[2] = packets[2], packets[1]
            for p in packets:
                on_packet(p)
        finish()
        got = []
        while (au := src._queue.get_nowait()) is not None:
            got.append(au)

        # Exactly one unit lost (the one under assembly at the swap) —
        # the pre-fix rewind counted 3+ and could eat later units too.
        assert src.units_dropped == 1

        def has_idr(au):
            return any(pkg.codec.nal_type(n) == 5 for n in au)

        def strip(n):
            for sc in (b"\x00\x00\x00\x01", b"\x00\x00\x01"):
                if n.startswith(sc):
                    return n[len(sc):]
            return n

        def payloads(units):
            return [[strip(n) for n in au] for au in units]

        next_idr = next(i for i in range(4, len(aus)) if has_idr(aus[i]))
        assert payloads(got) == payloads(aus[:3] + aus[next_idr:])

    def test_udp_teardown_unregisters_session(self, pkg, h264_file):
        """TEARDOWN must remove the session server-side: a UDP session has
        no send-failure self-heal (sendto to a vacated port succeeds
        forever), so a missed unregister streams to a ghost client for
        the server's whole lifetime."""
        import time

        RtspPacketSource = pkg.packets.RtspPacketSource
        RTSPServer = pkg.rtsp.RTSPServer

        srv = RTSPServer(port=free_port(), mount="/udp", fps=30).start()
        try:
            src = RtspPacketSource(srv.url, transport="udp").start()
            deadline = time.time() + 5.0
            while srv.n_clients != 1 and time.time() < deadline:
                time.sleep(0.05)
            assert srv.n_clients == 1
            src.stop()              # sends TEARDOWN
            deadline = time.time() + 5.0
            while srv.n_clients != 0 and time.time() < deadline:
                time.sleep(0.05)
            assert srv.n_clients == 0
        finally:
            srv.close()

    def test_hevc_endpoints_require_hevc_encoder(self, pkg, monkeypatch):
        """The packet route must not be selected for .h265 endpoints when
        only libx264 opens — switch_processing() would die mid-run where
        the frame graph works (review finding, io/runner.py)."""
        from types import SimpleNamespace

        vc = pkg.codec
        StabilizerApp = pkg.runner.StabilizerApp

        stub = SimpleNamespace(cfg=SimpleNamespace(
            video_source="cam.h265", output_source="out.h265"))
        decide = StabilizerApp._decide_packet_mode

        monkeypatch.setattr(vc, "available",
                            lambda codec="libx264": codec == "libx264")
        assert decide(stub, None, None) is False
        monkeypatch.setattr(vc, "available", lambda codec="libx264": True)
        assert decide(stub, None, None) is True
        # H.264 endpoints stay gated on libx264 alone.
        stub264 = SimpleNamespace(cfg=SimpleNamespace(
            video_source="cam.h264", output_source="out.h264"))
        monkeypatch.setattr(vc, "available",
                            lambda codec="libx264": codec == "libx264")
        assert decide(stub264, None, None) is True


class TestPacketHardening:
    """Regressions from the io-layer adversarial review: double starts,
    stall-vs-EOF classification, and container codec gating."""

    def test_packet_source_start_is_idempotent(self, pkg, h264_file):
        """The runner's packet-graph builder starts the source early (for
        the SDP/container codec); StabilizerApp.start() starts it again —
        the second start must be a no-op, not a handle leak/reopen."""
        PacketSource = pkg.packets.PacketSource

        src = PacketSource(h264_file)
        src.start()
        handle = src._file
        src.start()
        assert src._file is handle
        au = src.read()
        assert au
        src.stop()

    def test_relay_survives_transient_stall(self, pkg):
        """A live source returning None on a read timeout (camera pause)
        must not terminate the relay — only eof=True may."""
        import time

        PacketRelay = pkg.packets.PacketRelay

        class StallingSource:
            def __init__(self, n_units):
                self._left = n_units
                self._calls = 0
                self.eof = False

            def read(self):
                self._calls += 1
                if self._calls in (1, 3):    # transient stalls
                    return None
                if self._left > 0:
                    self._left -= 1
                    return [b"\x00\x00\x00\x01\x65unit"]
                self.eof = True
                return None

        got = []
        relay = PacketRelay(StallingSource(4),
                            on_unit=lambda au: got.append(au)).start()
        relay.join(timeout=5.0)
        assert len(got) == 4
        assert relay.units_relayed == 4
        # And a source without an eof attribute keeps file semantics
        # (None == EOF, relay ends).
        class BareSource:
            def read(self):
                return None

        relay2 = PacketRelay(BareSource()).start()
        relay2.join(timeout=2.0)
        assert not relay2._thread.is_alive()

    def test_container_codec_gates_packet_mode(self, pkg, monkeypatch):
        """Auto packet mode must check the INNER codec of a container —
        the packet graph only speaks H.264/HEVC; a VP9/MPEG-4 .mp4 takes
        the frame graph (cv2 decodes it fine) instead of relaying
        undecodable bytes under an H264 announcement."""
        from types import SimpleNamespace

        vc = pkg.codec
        StabilizerApp = pkg.runner.StabilizerApp

        decide = StabilizerApp._decide_packet_mode
        monkeypatch.setattr(vc, "available", lambda codec="libx264": True)

        def demuxer_reporting(name):
            class FakeDemuxer:
                def __init__(self, path):
                    self.codec_name = name

                def close(self):
                    pass
            return FakeDemuxer

        stub = SimpleNamespace(cfg=SimpleNamespace(
            video_source="clip.mp4", output_source="out.mp4"))
        monkeypatch.setattr(vc, "ContainerDemuxer",
                            demuxer_reporting("mpeg4"))
        assert decide(stub, None, None) is False
        monkeypatch.setattr(vc, "ContainerDemuxer",
                            demuxer_reporting("h264"))
        assert decide(stub, None, None) is True
        # An HEVC-in-mp4 source needs the HEVC encoder too.
        monkeypatch.setattr(vc, "ContainerDemuxer",
                            demuxer_reporting("hevc"))
        monkeypatch.setattr(vc, "available",
                            lambda codec="libx264": codec == "libx264")
        assert decide(stub, None, None) is False

    def test_rtsp_source_socket_survives_stall(self, pkg, h264_file):
        """After start() the control socket must be BLOCKING with TCP
        keepalive armed (a media stall longer than the connect timeout
        must not raise mid-loop and read as EOF), and a read timeout on a
        quiet-but-alive session reports a stall (eof False), not EOF."""
        import socket as socket_mod
        import threading
        import time

        PacketRelay = pkg.packets.PacketRelay
        PacketSource = pkg.packets.PacketSource
        RtspPacketSource = pkg.packets.RtspPacketSource
        RTSPServer = pkg.rtsp.RTSPServer

        server = RTSPServer(port=free_port(), mount="/stall",
                            fps=30).start()

        class _Push:
            def write(self, au):
                server.push_packet(au)

        stop = threading.Event()

        def feed():
            while not stop.is_set():
                src = PacketSource(h264_file, realtime_fps=120)
                PacketRelay(src, sinks=[_Push()]).start().join(10.0)
                src.stop()

        t = threading.Thread(target=feed, daemon=True)
        t.start()
        client = None
        try:
            time.sleep(0.3)               # let parameter sets reach the SDP
            client = RtspPacketSource(server.url)
            client.start()
            assert client.start() is client           # idempotent
            assert client._sock.gettimeout() is None  # blocking loop socket
            assert client._sock.getsockopt(socket_mod.SOL_SOCKET,
                                           socket_mod.SO_KEEPALIVE) == 1
            deadline = time.time() + 10
            got = 0
            while got < 3 and time.time() < deadline:
                if client.read(timeout=1.0):
                    got += 1
            assert got >= 3
            # Quiet-but-alive: stop feeding, session stays up — a read
            # timeout is a stall, not end-of-stream.
            stop.set()
            t.join(timeout=12)
            while client.read(timeout=0.3):
                pass                      # drain what is queued
            assert client.read(timeout=0.3) is None
            assert client.eof is False
        finally:
            stop.set()
            if client is not None:
                client.stop()
            server.close()


class TestAppPacketGraph:
    """Compressed passthrough INSIDE the managed app graph (VERDICT r2 #1):
    StabilizerApp routes access units through lossless packet channels; the
    passthrough output is byte-identical with NO decoder constructed, and a
    mid-stream switch to processing attaches the decoder at the next IDR."""

    def _app(self, pkg, h264_file, out_path, **mode_kw):
        ModeParams = pkg.params.ModeParams
        StabilizerApp = pkg.runner.StabilizerApp
        AppConfig = pkg.config.AppConfig

        import dataclasses

        cfg = AppConfig(video_source=h264_file, output_source=out_path,
                        mode=ModeParams(**mode_kw))
        cfg.stabilizer = dataclasses.replace(
            cfg.stabilizer, smoothing_radius=5, analysis_width=128,
            analysis_height=96, ransac_hypotheses=64, max_corners=64)
        return StabilizerApp(cfg)

    def test_app_passthrough_byte_identical_no_decoder(self, pkg, h264_file,
                                                       tmp_path):
        import time

        out_path = str(tmp_path / "app_pass.h264")
        app = self._app(pkg, h264_file, out_path)    # all toggles off
        assert app.packet_mode
        app.graph.start()
        deadline = time.time() + 30
        src_units = None
        while time.time() < deadline:
            if app.sink.units_written and \
                    app.sink.units_written == app.source.units_read \
                    and app.graph.pipeline("source").frames_processed \
                    == app.sink.units_written and app.source._eof:
                break
            time.sleep(0.1)
        app.stop()
        assert app.sink.units_written >= 48
        assert not app.decoder_constructed
        with open(h264_file, "rb") as f:
            original = f.read()
        with open(out_path, "rb") as f:
            relayed = f.read()
        assert relayed == original

    def test_reload_disable_tracker_drops_instance_and_goes_i420(
            self, pkg, h264_file, tmp_path):
        """Hot reload that turns the tracker OFF must drop the tracker
        instance in the same swap that flips the packet chain to i420
        output: the overlay gate keys on `_tracker is not None`, so a
        stale instance would run detection on (and draw into) planar YUV
        frames — corrupted output with no error raised."""
        import dataclasses

        app = self._app(pkg, h264_file, str(tmp_path / "out.h264"),
                        stabilizer_enabled=True, tracker_enabled=True)
        assert app._tracker is not None
        assert app.chain.params.output_format != "i420"   # overlay needs BGR
        new_cfg = dataclasses.replace(
            app.cfg, mode=dataclasses.replace(app.cfg.mode,
                                              tracker_enabled=False))
        app._on_config_change(new_cfg)
        assert app._tracker is None
        assert app.chain.params.output_format == "i420"
        # And re-enabling brings the tracker back with BGR frames.
        app._on_config_change(dataclasses.replace(
            new_cfg, mode=dataclasses.replace(new_cfg.mode,
                                              tracker_enabled=True)))
        assert app._tracker is not None
        assert app.chain.params.output_format != "i420"
        app.stop()

    @pytest.fixture()
    def h264_gop12_small(self, tmp_path):
        """Small frames (96x128 — warm XLA cache shapes) with a SHORT gop:
        mid-stream processing switches need periodic IDRs to attach at
        (live cameras keyint; the module fixture's single leading IDR
        can't exercise the resync)."""
        path = str(tmp_path / "gop12.h264")
        enc = vcodec.VideoEncoder(128, 96, 30, bitrate_bps=400_000,
                                  gop=12)
        yy, xx = np.mgrid[0:96, 0:128]
        with open(path, "wb") as f:
            for i in range(60):
                base = ((yy + xx + 4 * i) % 256).astype(np.uint8)
                f.write(enc.encode(np.stack([base, base, 255 - base], -1)))
            f.write(enc.flush())
        enc.close()
        return path

    def test_app_hot_switch_to_processing_at_idr(self, pkg, h264_gop12_small,
                                                 tmp_path):
        """Start in passthrough, flip to processing mid-stream (the
        keyboard/config switch): the decoder attaches lazily, decoding
        resumes at the next IDR, and the output tail is re-encoded
        (decodable) processed video."""
        import time

        vcodec = pkg.codec
        PacketSource = pkg.packets.PacketSource

        out_path = str(tmp_path / "app_switch.h264")
        app = self._app(pkg, h264_gop12_small, out_path,
                        stabilizer_enabled=True)
        assert app.packet_mode
        # Force initial passthrough despite the toggle (the reference's
        # keyboard 'p'), then flip to processing mid-stream.
        app.switch_passthrough()
        app.graph.start()
        deadline = time.time() + 20
        while app.sink.units_written < 10 and time.time() < deadline:
            time.sleep(0.05)
        assert not app.decoder_constructed     # still pure relay
        app.switch_processing()
        deadline = time.time() + 240
        while time.time() < deadline:
            if app.source._eof and app._pkt_encoder.units_out and \
                    app.graph.pipeline("processing").frames_processed:
                time.sleep(1.0)     # let the tail drain
                break
            time.sleep(0.1)
        app.stop()
        assert app.decoder_constructed         # attached by the switch
        assert app._pkt_encoder.units_out > 0
        # The output must hold the relayed prefix + a decodable tail.
        dec = pkg.codec.VideoDecoder()
        frames = 0
        src = PacketSource(out_path)
        while (au := src.read()) is not None:
            frames += len(dec.decode(b"".join(au)))
        frames += len(dec.flush())
        dec.close()
        assert frames >= 15, frames

    @pytest.fixture()
    def hevc_gop12_small(self, tmp_path):
        """HEVC twin of h264_gop12_small: short-gop elementary stream for
        mid-stream processing switches on an H.265 camera."""
        path = str(tmp_path / "gop12.h265")
        enc = vcodec.VideoEncoder(128, 96, 30, bitrate_bps=400_000,
                                  codec="libx265", gop=12)
        yy, xx = np.mgrid[0:96, 0:128]
        with open(path, "wb") as f:
            for i in range(60):
                base = ((yy + xx + 4 * i) % 256).astype(np.uint8)
                f.write(enc.encode(np.stack([base, base, 255 - base], -1)))
            f.write(enc.flush())
        enc.close()
        return path

    def test_app_hevc_processing_reencodes_hevc(self, pkg, hevc_gop12_small,
                                                tmp_path):
        """An HEVC source relayed through the packet graph must stay HEVC
        after switch_processing(): the re-encode branch emits the codec the
        sink announces (ADVICE r3 — PacketEncoderBridge used to pin H.264,
        handing HEVC clients undecodable NALs)."""
        import time

        vcodec2 = pkg.codec
        PacketSource = pkg.packets.PacketSource

        out_path = str(tmp_path / "app_hevc.h265")
        app = self._app(pkg, hevc_gop12_small, out_path,
                        stabilizer_enabled=True)
        assert app.packet_mode
        assert app._pkt_encoder.codec == "libx265"
        app.switch_passthrough()
        app.graph.start()
        deadline = time.time() + 20
        while app.sink.units_written < 10 and time.time() < deadline:
            time.sleep(0.05)
        assert not app.decoder_constructed
        app.switch_processing()
        deadline = time.time() + 240
        while time.time() < deadline:
            if app.source._eof and app._pkt_encoder.units_out and \
                    app.graph.pipeline("processing").frames_processed:
                time.sleep(1.0)
                break
            time.sleep(0.1)
        app.stop()
        assert app.decoder_constructed
        assert app._pkt_encoder.units_out > 0
        # The WHOLE output (relayed prefix + re-encoded tail) must decode
        # as one HEVC stream — an H.264 tail would fail here.
        open_packet_source = pkg.packets.open_packet_source
        dec = pkg.codec.VideoDecoder("hevc")
        frames = 0
        src = open_packet_source(out_path)
        assert src.codec_name == "hevc"
        while (au := src.read()) is not None:
            frames += len(dec.decode(b"".join(au)))
        frames += len(dec.flush())
        dec.close()
        assert frames >= 15, frames

    def test_rtsp_packet_source_in_app(self, pkg, h264_file, tmp_path):
        """Live compressed ingest: RTSPServer serves the file's packets; the
        app ingests rtsp:// at the PACKET level (no decoder) and relays
        byte-identical NAL payloads to its .h264 output."""
        import threading
        import time

        PacketSource = pkg.packets.PacketSource
        RTSPServer = pkg.rtsp.RTSPServer

        server = RTSPServer(port=free_port(), mount="/live",
                            fps=30).start()
        out_path = str(tmp_path / "app_live.h264")
        ModeParams = pkg.params.ModeParams
        StabilizerApp = pkg.runner.StabilizerApp
        AppConfig = pkg.config.AppConfig

        cfg = AppConfig(video_source=server.url,
                        output_source=out_path, mode=ModeParams())
        app = StabilizerApp(cfg)
        assert app.packet_mode
        RtspPacketSource = pkg.packets.RtspPacketSource
        assert isinstance(app.source, RtspPacketSource)
        app.graph.start()
        time.sleep(0.5)              # client joins before units flow

        stop = threading.Event()
        sent = []

        def feed():
            src = PacketSource(h264_file, realtime_fps=120)
            while not stop.is_set():
                au = src.read()
                if au is None:
                    break
                server.push_packet(au)
                sent.append(au)
            src.stop()

        t = threading.Thread(target=feed, daemon=True)
        t.start()
        deadline = time.time() + 30
        while app.sink.units_written < 40 and time.time() < deadline:
            time.sleep(0.1)
        stop.set()
        t.join(timeout=5)
        time.sleep(0.3)
        app.stop()
        server.close()
        assert not app.decoder_constructed
        assert app.sink.units_written >= 40

        def strip(n):
            for sc in (b"\x00\x00\x00\x01", b"\x00\x00\x01"):
                if n.startswith(sc):
                    return n[len(sc):]
            return n

        sent_payloads = [strip(n) for au in sent for n in au]
        out_payloads = []
        src = PacketSource(out_path)
        while (au := src.read()) is not None:
            out_payloads.extend(strip(n) for n in au)
        src.stop()
        # Byte-identical NAL payloads, in order, over the received window
        # (the client may join after the first units; no re-encode ever).
        assert len(out_payloads) >= 40
        joined_sent = b"|".join(sent_payloads)
        joined_out = b"|".join(out_payloads)
        assert joined_out in joined_sent


class TestDaemonPacketGraph:
    """Packet channel type in the out-of-process GraphDaemon (the gstd
    counterpart): a .h264 -> .h264 relay through the daemon is
    byte-identical and never decodes."""

    def test_daemon_packet_relay_byte_identical(self, pkg, h264_file,
                                                tmp_path):
        import time

        GraphDaemonClient = pkg.daemon.GraphDaemonClient

        out_path = str(tmp_path / "daemon_relay.h264")
        d = GraphDaemonClient(source=h264_file, output=out_path,
                              port=free_port())
        assert d.initialize()
        try:
            assert d.create_pipelines()
            assert d.start()
            deadline = time.time() + 30
            done = False
            while time.time() < deadline:
                pl = {p["name"]: p for p in d.pipeline_list()}
                if pl.get("output", {}).get("frames_processed", 0) >= 48:
                    done = True
                    break
                time.sleep(0.2)
            assert done, d.pipeline_list()
        finally:
            d.stop()
        time.sleep(0.2)
        with open(h264_file, "rb") as a, open(out_path, "rb") as b:
            assert a.read() == b.read()


class TestContainerPacketSource:
    """Compressed ingest from CONTAINER files (native libavformat demux +
    mp4toannexb, io/codec.ContainerDemuxer): the reference's own configs
    use .m4v sources, relayed compressed by its qtdemux stage."""

    @pytest.fixture(scope="class")
    def mp4_file(self, tmp_path_factory):
        import ctypes

        path = str(tmp_path_factory.mktemp("mp4") / "src.mp4")
        lib = vcodec._load()
        h = lib.vs_mux_open(path.encode(), 128, 96, 30.0, 400_000,
                            b"libx264", 1, 10)
        assert h
        yy, xx = np.mgrid[0:96, 0:128]
        for i in range(30):
            base = ((yy + xx + 4 * i) % 256).astype(np.uint8)
            f = np.ascontiguousarray(np.stack([base, base, 255 - base], -1))
            assert lib.vs_mux_write(h, f.ctypes.data_as(ctypes.c_char_p)) \
                == 0
        assert lib.vs_mux_close(h) == 0
        return path

    def test_demux_to_decodable_annexb_no_decode_on_relay(self, pkg, mp4_file,
                                                          tmp_path):
        ContainerPacketSource = pkg.packets.ContainerPacketSource
        PacketDecoderBridge = pkg.packets.PacketDecoderBridge
        PacketFileSink = pkg.packets.PacketFileSink
        PacketSource = pkg.packets.PacketSource
        src = ContainerPacketSource(mp4_file)
        sink = PacketFileSink(str(tmp_path / "from_mp4.h264"))
        n = 0
        while (au := src.read()) is not None:
            sink.write(au)
            n += 1
        assert src.codec_name == "h264"
        src.stop()
        sink.close()
        assert n == 30
        # The relayed Annex-B stream decodes to all 30 frames.
        dec = pkg.codec.VideoDecoder()
        frames = 0
        rd = PacketSource(str(tmp_path / "from_mp4.h264"))
        while (au := rd.read()) is not None:
            frames += len(dec.decode(b"".join(au)))
        frames += len(dec.flush())
        dec.close()
        rd.stop()
        assert frames == 30

    def test_app_ingests_mp4_compressed(self, pkg, mp4_file, tmp_path):
        """StabilizerApp auto-selects the packet graph for an mp4 source:
        relays compressed (no decoder) to a .h264 output."""
        import time

        ModeParams = pkg.params.ModeParams
        ContainerPacketSource = pkg.packets.ContainerPacketSource
        StabilizerApp = pkg.runner.StabilizerApp
        AppConfig = pkg.config.AppConfig

        out_path = str(tmp_path / "from_mp4_app.h264")
        cfg = AppConfig(video_source=mp4_file, output_source=out_path,
                        mode=ModeParams())
        app = StabilizerApp(cfg)
        assert app.packet_mode
        assert isinstance(app.source, ContainerPacketSource)
        app.graph.start()
        deadline = time.time() + 30
        while time.time() < deadline:
            if app.sink.units_written >= 30 and app.source._eof:
                break
            time.sleep(0.1)
        app.stop()
        assert app.sink.units_written == 30
        assert not app.decoder_constructed


class TestH265Rtsp:
    """RFC 7798 HEVC over the RTSP pair (server packetizer + client
    depacketizer) — the JetsonEncoder's second codec served and ingested
    at the packet level."""

    @pytest.fixture(scope="class")
    def h265_aus(self):
        if not vcodec.available("libx265"):
            pytest.skip("libx265 unavailable")
        enc = vcodec.VideoEncoder(128, 96, 30, bitrate_bps=400_000,
                                  codec="libx265")
        data = b""
        yy, xx = np.mgrid[0:96, 0:128]
        for i in range(20):
            base = ((yy + xx + 4 * i) % 256).astype(np.uint8)
            data += enc.encode(np.stack([base, base, 255 - base], -1))
        data += enc.flush()
        enc.close()
        # HEVC AU grouping: one AU per frame isn't guaranteed by the H.264
        # grouper; split on IRAP/first-slice via the 2-byte header. For the
        # relay test, packet-per-picture granularity is not required —
        # chunk NALs by picture boundaries using first_slice flag.
        nals = vcodec.split_nal_units(data)

        def hevc_type(n):
            raw = n[4:] if n[:4] == b"\x00\x00\x00\x01" else n[3:]
            return (raw[0] >> 1) & 0x3F

        def first_slice(n):
            raw = n[4:] if n[:4] == b"\x00\x00\x00\x01" else n[3:]
            return len(raw) > 2 and (raw[2] & 0x80) != 0

        aus, cur, has_vcl = [], [], False
        for n in nals:
            t = hevc_type(n)
            vcl = t <= 31
            if vcl and has_vcl and first_slice(n):
                aus.append(cur)
                cur, has_vcl = [], False
            cur.append(n)
            has_vcl = has_vcl or vcl
        if cur:
            aus.append(cur)
        assert len(aus) == 20
        return aus

    def test_h265_packet_roundtrip_byte_identical(self, pkg, h265_aus):
        import time

        RtspPacketSource = pkg.packets.RtspPacketSource
        RTSPServer = pkg.rtsp.RTSPServer

        srv = RTSPServer(port=free_port(), mount="/hevc", fps=30,
                         codec="h265").start()
        src = RtspPacketSource(srv.url).start()
        time.sleep(0.3)
        assert src.codec_name == "hevc"     # from the SDP rtpmap
        for au in h265_aus:
            srv.push_packet(au)
            time.sleep(0.01)
        got = []
        while (au := src.read(timeout=2.0)) is not None:
            got.append(au)
        src.stop()
        srv.close()

        def strip(n):
            for sc in (b"\x00\x00\x00\x01", b"\x00\x00\x01"):
                if n.startswith(sc):
                    return n[len(sc):]
            return n

        sent = [strip(n) for au in h265_aus for n in au]
        recv = [strip(n) for au in got for n in au]
        assert recv == sent

    def test_h265_rtsp_to_ffmpeg_client(self, pkg, h265_aus):
        """A real ffmpeg/cv2 client decodes our RFC 7798 stream."""
        import threading
        import time

        import cv2

        RTSPServer = pkg.rtsp.RTSPServer

        srv = RTSPServer(port=free_port(), mount="/hevc2", fps=30,
                         codec="h265").start()
        stop = threading.Event()

        def feed():
            while not stop.is_set():
                for au in h265_aus:
                    if stop.is_set():
                        return
                    srv.push_packet(au)
                    time.sleep(1 / 60)

        t = threading.Thread(target=feed, daemon=True)
        t.start()
        try:
            os.environ["OPENCV_FFMPEG_CAPTURE_OPTIONS"] = \
                "rtsp_transport;tcp"
            cap = cv2.VideoCapture(srv.url, cv2.CAP_FFMPEG)
            assert cap.isOpened()
            got = 0
            deadline = time.time() + 20
            while got < 5 and time.time() < deadline:
                ok, frame = cap.read()
                if ok:
                    assert frame.shape == (96, 128, 3)
                    got += 1
            cap.release()
            assert got >= 5, f"only {got} frames"
        finally:
            stop.set()
            t.join(timeout=5)
            srv.close()
            os.environ.pop("OPENCV_FFMPEG_CAPTURE_OPTIONS", None)


class TestContainerPacketSink:
    """Packet-level container OUTPUT: Annex-B access units remuxed into
    mp4 WITHOUT re-encode (native vs_muxp_*); payload bytes preserved."""

    def test_h264_to_mp4_remux_byte_identical(self, pkg, h264_file, tmp_path):
        ContainerPacketSink = pkg.packets.ContainerPacketSink
        ContainerPacketSource = pkg.packets.ContainerPacketSource
        PacketSource = pkg.packets.PacketSource
        out_path = str(tmp_path / "remux.mp4")
        src = PacketSource(h264_file)
        sink = ContainerPacketSink(out_path, fps=30)
        sent = []
        while (au := src.read()) is not None:
            sink.write(au)
            sent.append(au)
        src.stop()
        sink.close()
        assert sink.units_written == 48
        rd = ContainerPacketSource(out_path)
        back = []
        while (au := rd.read()) is not None:
            back.append(au)
        rd.stop()

        def strip(n):
            for sc in (b"\x00\x00\x00\x01", b"\x00\x00\x01"):
                if n.startswith(sc):
                    return n[len(sc):]
            return n

        assert [strip(n) for au in back for n in au] == \
            [strip(n) for au in sent for n in au]

    def test_remux_preserves_container_timestamps(self, pkg, h264_file,
                                                  tmp_path):
        """AccessUnit carries the container's pts/dts (seconds) and the
        remuxer writes them through (vs_muxp_write_ts) — B-frame streams
        keep presentation order. Validated by remuxing at a DIFFERENT
        nominal fps: the original timestamps must survive instead of
        being restamped to the new rate's decode counter."""
        ContainerPacketSink = pkg.packets.ContainerPacketSink
        ContainerPacketSource = pkg.packets.ContainerPacketSource
        PacketSource = pkg.packets.PacketSource
        mp4_a = str(tmp_path / "a.mp4")
        src = PacketSource(h264_file)
        sink = ContainerPacketSink(mp4_a, fps=30)
        while (au := src.read()) is not None:
            sink.write(au)
        src.stop()
        sink.close()

        rd = ContainerPacketSource(mp4_a)
        aus = []
        while (au := rd.read()) is not None:
            aus.append(au)
        rd.stop()
        pts_in = [au.pts for au in aus]
        assert all(p is not None for p in pts_in)
        assert pts_in[:4] == sorted(pts_in[:4])      # 1/30-step times

        mp4_b = str(tmp_path / "b.mp4")
        sink2 = ContainerPacketSink(mp4_b, fps=60)   # WRONG nominal rate
        for au in aus:
            sink2.write(au)
        sink2.close()
        rd2 = ContainerPacketSource(mp4_b)
        pts_out = []
        while (au := rd2.read()) is not None:
            pts_out.append(au.pts)
        rd2.stop()
        assert len(pts_out) == len(pts_in)
        for a, b in zip(pts_in, pts_out):
            assert abs(a - b) < 1e-3, (a, b)         # NOT 1/60 restamped

    def test_app_mp4_to_mp4_compressed_passthrough(self, pkg, h264_file,
                                                   tmp_path):
        """Full mp4 -> mp4 remux through the managed app graph: demux +
        remux, never a decoder."""
        import ctypes
        import time

        ModeParams = pkg.params.ModeParams
        ContainerPacketSink = pkg.packets.ContainerPacketSink
        ContainerPacketSource = pkg.packets.ContainerPacketSource
        PacketSource = pkg.packets.PacketSource
        StabilizerApp = pkg.runner.StabilizerApp
        AppConfig = pkg.config.AppConfig

        # build an mp4 source from the h264 fixture via the packet sink
        mp4_src = str(tmp_path / "src.mp4")
        src = PacketSource(h264_file)
        sink = ContainerPacketSink(mp4_src, fps=30)
        while (au := src.read()) is not None:
            sink.write(au)
        src.stop()
        sink.close()

        out_path = str(tmp_path / "out.mp4")
        cfg = AppConfig(video_source=mp4_src, output_source=out_path,
                        mode=ModeParams())
        app = StabilizerApp(cfg)
        assert app.packet_mode
        app.graph.start()
        deadline = time.time() + 30
        while time.time() < deadline:
            if app.source._eof and app.sink.units_written >= 48:
                break
            time.sleep(0.1)
        app.stop()
        assert app.sink.units_written == 48
        assert not app.decoder_constructed
        rd = ContainerPacketSource(out_path)
        n = 0
        while rd.read() is not None:
            n += 1
        rd.stop()
        assert n == 48


class TestSpsDimensions:
    """SPS dimension parser (packet remux needs container dims with no
    decoder): H.264 incl. frame cropping, HEVC incl. conformance window."""

    @pytest.mark.parametrize("w,h", [(128, 96), (1920, 1080), (1280, 722),
                                     (204, 116)])
    def test_h264(self, pkg, w, h):
        sps_dimensions = pkg.packets.sps_dimensions
        enc = pkg.codec.VideoEncoder(w, h, 30, bitrate_bps=300_000)
        data = enc.encode(np.zeros((h, w, 3), np.uint8)) + enc.flush()
        enc.close()
        sps = next(n for n in pkg.codec.split_nal_units(data)
                   if pkg.codec.nal_type(n) == 7)
        assert sps_dimensions(sps) == (w, h)

    def test_hevc(self, pkg):
        if not pkg.codec.available("libx265"):
            pytest.skip("libx265 unavailable")
        sps_dimensions = pkg.packets.sps_dimensions
        enc = pkg.codec.VideoEncoder(320, 180, 30, bitrate_bps=300_000,
                                  codec="libx265")
        data = enc.encode(np.zeros((180, 320, 3), np.uint8)) + enc.flush()
        enc.close()
        sps = next(n for n in pkg.codec.split_nal_units(data)
                   if len(n) > 4 and ((n[4] >> 1) & 0x3F) == 33)
        assert sps_dimensions(sps, hevc=True) == (320, 180)


class TestH265ElementaryStream:
    """Raw .h265 Annex-B files group correctly (HEVC slice semantics) and
    relay byte-identically through the app's packet graph."""

    def test_h265_file_grouping_and_app_relay(self, pkg, tmp_path):
        import time

        if not pkg.codec.available("libx265"):
            pytest.skip("libx265 unavailable")
        path = str(tmp_path / "src.h265")
        enc = pkg.codec.VideoEncoder(128, 96, 30, bitrate_bps=400_000,
                                  codec="libx265")
        yy, xx = np.mgrid[0:96, 0:128]
        with open(path, "wb") as f:
            for i in range(24):
                base = ((yy + xx + 4 * i) % 256).astype(np.uint8)
                f.write(enc.encode(np.stack([base, base, 255 - base], -1)))
            f.write(enc.flush())
        enc.close()

        open_packet_source = pkg.packets.open_packet_source
        src = open_packet_source(path)
        assert src.codec_name == "hevc"
        aus = []
        while (au := src.read()) is not None:
            aus.append(au)
        src.stop()
        assert len(aus) == 24       # one access unit per coded picture

        ModeParams = pkg.params.ModeParams
        StabilizerApp = pkg.runner.StabilizerApp
        AppConfig = pkg.config.AppConfig

        out_path = str(tmp_path / "out.h265")
        cfg = AppConfig(video_source=path, output_source=out_path,
                        mode=ModeParams())
        app = StabilizerApp(cfg, packet_mode=True)
        app.graph.start()
        deadline = time.time() + 20
        while time.time() < deadline:
            if app.source._eof and app.sink.units_written >= 24:
                break
            time.sleep(0.1)
        app.stop()
        assert not app.decoder_constructed
        with open(path, "rb") as a, open(out_path, "rb") as b:
            assert a.read() == b.read()



class TestPacketI420Fit:
    def test_processing_at_height_not_multiple_of_4_runs_bgr(self, pkg,
                                                             tmp_path):
        """bgr_to_i420 needs H % 4 == 0; the packet graph folds it into
        the chain whenever no tracker draws. At 128x90 the port's chain
        delivers BGR (the encoder's encode_frame route) and every decoded
        frame is processed and re-encoded; the JAX package switches to
        I420 unchecked (the reference defect the port repairs)."""
        import dataclasses

        if pkg is PACKAGES["jax"]:
            pytest.skip("the JAX package switches the packet chain to I420 "
                        "without checking H % 4, the reference defect the "
                        "port repairs")
        h, w = 90, 128
        path = str(tmp_path / "h90.h264")
        enc = vcodec.VideoEncoder(w, h, 30, bitrate_bps=400_000, gop=12)
        yy, xx = np.mgrid[0:h, 0:w]
        with open(path, "wb") as f:
            for i in range(24):
                base = ((yy + xx + 4 * i) % 256).astype(np.uint8)
                f.write(enc.encode(np.stack([base, base, 255 - base], -1)))
            f.write(enc.flush())
        enc.close()
        cfg = pkg.config.AppConfig(
            video_source=path, output_source=str(tmp_path / "out.h264"),
            mode=pkg.params.ModeParams(stabilizer_enabled=True))
        cfg.stabilizer = dataclasses.replace(
            cfg.stabilizer, smoothing_radius=5, analysis_width=128,
            analysis_height=96, ransac_hypotheses=64, max_corners=64)
        app = pkg.runner.StabilizerApp(cfg)
        assert app.packet_mode and app._pkt_active
        # Nothing decoded yet: the chain is set to I420 as in the JAX app.
        assert app.chain.params.output_format == "i420"
        src = pkg.packets.PacketSource(path)
        out = b""
        n_units = 0
        while (au := src.read()) is not None:
            n_units += 1
            out += b"".join(app._process_packet(au) or [])
        src.stop()
        assert app.chain.params.output_format == "bgr"
        assert app.metrics.snapshot()["counters"]["frames_out"] == \
            n_units - (cfg.stabilizer.effective_radius - 1) - 1
        dec = pkg.codec.VideoDecoder()
        frames = dec.decode(out) + dec.flush()
        dec.close()
        app.stop()
        assert len(frames) == app._pkt_encoder.units_out > 0
        assert all(fr.shape == (h, w, 3) for fr in frames)

    def test_i420_chain_swapped_in_after_the_first_frame_goes_bgr(
            self, pkg, tmp_path):
        """A reload that built its chain before the first decode (the
        frame size still unknown: I420) and swaps it in after the decoder
        has seen a 128x90 frame: the port fits the swapped-in chain at the
        next frame, so it delivers BGR and nothing raises."""
        import dataclasses

        if pkg is PACKAGES["jax"]:
            pytest.skip("the JAX package switches the packet chain to I420 "
                        "without checking H % 4, the reference defect the "
                        "port repairs")
        h, w = 90, 128
        path = str(tmp_path / "h90.h264")
        enc = vcodec.VideoEncoder(w, h, 30, bitrate_bps=400_000, gop=6)
        yy, xx = np.mgrid[0:h, 0:w]
        with open(path, "wb") as f:
            for i in range(16):
                base = ((yy + xx + 4 * i) % 256).astype(np.uint8)
                f.write(enc.encode(np.stack([base, base, 255 - base], -1)))
            f.write(enc.flush())
        enc.close()
        cfg = pkg.config.AppConfig(
            video_source=path, output_source=str(tmp_path / "out.h264"),
            mode=pkg.params.ModeParams(stabilizer_enabled=True))
        cfg.stabilizer = dataclasses.replace(
            cfg.stabilizer, smoothing_radius=3, analysis_width=128,
            analysis_height=96, ransac_hypotheses=64, max_corners=64)
        app = pkg.runner.StabilizerApp(cfg)
        src = pkg.packets.PacketSource(path)
        units = []
        while (au := src.read()) is not None:
            units.append(au)
        src.stop()
        for au in units[:4]:
            app._process_packet(au)
        assert app._pkt_frame_hw == (h, w)
        assert app.chain.params.output_format == "bgr"
        with app._lock:     # what the racing reload swaps in
            app.chain = app.chain.with_output_format("i420")
        for au in units[4:]:
            app._process_packet(au)
        app.stop()
        assert app.chain.params.output_format == "bgr"
        assert app.chain._frames_in == len(units) - 4 - 1
