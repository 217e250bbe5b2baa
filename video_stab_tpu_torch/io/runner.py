"""The orchestrator — counterpart of the reference's application layer
(examples/vsg.cpp); port of ``video_stab_tpu/io/runner.py`` over this
package's chain, stages and tracker.

Wires the stream graph the way vsg.cpp wires its in-process pipelines:

  source:      FrameSource -> "source" channel
  processing:  "source" -> enhance -> roll-correct -> stabilize -> track
               -> "processed" channel
  output:      listen-to {"source" | "processed"} -> sink

plus: YAML config + mtime hot reload with the chain rebuilt and seamless
passthrough<->processing switching, TCP click-to-track coordinates, the
optional REST config API, structured metrics.

The device is picked once per config from ``mode.use_cuda``
(``pick_device``: CUDA, raising without a card; no fallback), and every
stage, the fused ``ProcessingChain`` or the separate ``Enhancer`` /
``RollCorrection`` / ``AutoZoomCrop`` / ``Stabilizer``, and the tracker's
detector run on it. ``use_cuda`` pins it across reloads (the CLI's
``--device``).

Packet (compressed-domain) mode is the production passthrough: H.264 /
HEVC access units ride lossless channels and are relayed byte-identically
with no decoder, and processing decodes on the host (``io/codec.py``),
runs the chain on the device and re-encodes. The chain then delivers
planar I420 straight to the encoder when the frame size allows it
(H % 4 == 0 and W % 2 == 0), else BGR.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np

from video_stab_tpu_torch import pick_device
from video_stab_tpu_torch.core.autozoomcrop import AutoZoomCrop
from video_stab_tpu_torch.core.chain import ProcessingChain
from video_stab_tpu_torch.core.enhancer import Enhancer
from video_stab_tpu_torch.core.rollcorrection import RollCorrection
from video_stab_tpu_torch.core.stabilizer import Stabilizer
from video_stab_tpu_torch.io.channels import StreamGraph
from video_stab_tpu_torch.io.control import (ConfigRestServer,
                                             KeyboardController, TcpReceiver)
from video_stab_tpu_torch.io.sinks import FrameSink, open_sink
from video_stab_tpu_torch.io.sources import SourceParams, open_source
from video_stab_tpu_torch.models.tracker import ObjectTracker
from video_stab_tpu_torch.utils.config import (AppConfig, ConfigWatcher,
                                               load_config)
from video_stab_tpu_torch.utils.telemetry import Metrics, get_logger


class StabilizerApp:
    """`vstab run config.yaml` — the vsg.cpp main loop as a library object.

    ``use_cuda``: None lets each config's ``mode.use_cuda`` pick the device;
    True / False override it, for this config and every reload."""

    def __init__(self, config: AppConfig, config_path: Optional[str] = None,
                 sink: Optional[FrameSink] = None,
                 enable_tcp: bool = False, tcp_port: int = 5000,
                 enable_rest: bool = False, rest_port: int = 5001,
                 max_frames: int = 0, fused: bool = True,
                 packet_mode: Optional[bool] = None,
                 use_cuda: Optional[bool] = None):
        self._use_cuda = use_cuda
        self.cfg = self._pinned(config)
        self.device = pick_device(self.cfg.mode.use_cuda)
        self.fused = fused
        self.config_path = config_path
        self.metrics = Metrics()
        self.log = get_logger("App", True)
        self.max_frames = max_frames
        self._lock = threading.Lock()     # config snapshot mutex (vsg:1253)
        self._stop = threading.Event()

        (self.chain, self.enhancer, self.roll, self.azc,
         self.stabilizer) = self._make_processors(self.cfg)

        self.graph = StreamGraph()
        self.packet_mode = self._decide_packet_mode(packet_mode, sink)
        if self.packet_mode:
            self._build_packet_graph()
        else:
            self._build_frame_graph(sink)

        self.tcp: Optional[TcpReceiver] = \
            TcpReceiver(tcp_port).start() if enable_tcp else None
        self.rest: Optional[ConfigRestServer] = None
        if enable_rest and config_path:
            self.rest = ConfigRestServer(config_path, rest_port).start()
        self.watcher: Optional[ConfigWatcher] = None
        if config_path:
            self.watcher = ConfigWatcher(config_path, self._on_config_change)

        self._frames_out = 0
        self._tracker: Optional[ObjectTracker] = None
        if self.cfg.mode.tracker_enabled:
            self._tracker = ObjectTracker(self.cfg.tracker,
                                          device=self.device)

    def _pinned(self, cfg: AppConfig) -> AppConfig:
        """``cfg`` with the device override applied to its mode."""
        if self._use_cuda is None or cfg.mode.use_cuda == self._use_cuda:
            return cfg
        return dataclasses.replace(cfg, mode=dataclasses.replace(
            cfg.mode, use_cuda=self._use_cuda))

    # -- graph construction -------------------------------------------------
    def _decide_packet_mode(self, packet_mode: Optional[bool],
                            sink) -> bool:
        """Packet (compressed-domain) mode: the production passthrough path
        relays H.264 access units byte-identically with NO decoder, exactly
        like the reference's gstd/interpipe graph (GstdManager.cpp:155-229;
        passthrough adds 10-20 ms vs 50-100 ms for decode+re-encode,
        README_GSTD_INTERPIPE.md:157-158). Auto-on when both endpoints are
        packet-capable: source is an Annex-B .h264 file or an rtsp:// URL,
        output is .h264 / rtsp:// / null, and the native codec is present
        (processing mode needs the decoder+encoder)."""
        if packet_mode is not None:
            return packet_mode
        if sink is not None:
            return False
        from video_stab_tpu_torch.io.codec import available
        src = self.cfg.video_source
        out = self.cfg.output_source
        container_codec = None
        src_ok = (src.endswith((".h264", ".264", ".h265", ".265", ".hevc"))
                  or src.startswith("rtsp://"))
        if not src_ok and src.endswith((".mp4", ".m4v", ".mkv", ".mov")):
            # A container is only packet-capable when its video stream is
            # H.264/HEVC — the packet graph speaks nothing else (the demux
            # BSF falls back to "null" for other codecs and the relay
            # would ship undecodable bytes under an H264 announcement).
            # One header-only demux open answers this; anything else
            # (VP9/AV1/MPEG-4...) takes the frame graph, which cv2
            # decodes fine.
            try:
                from video_stab_tpu_torch.io.codec import ContainerDemuxer
                d = ContainerDemuxer(src)
                container_codec = d.codec_name
                src_ok = container_codec in ("h264", "hevc", "h265")
                d.close()
            except Exception:
                src_ok = False
        if not src_ok:
            return False
        out_ok = (not out or out == "null"
                  or out.endswith((".h264", ".264", ".h265", ".265", ".hevc",
                                   ".mp4", ".m4v", ".mkv", ".mov"))
                  or out.startswith("rtsp://"))
        enc_ok = available("libx264")
        if src.endswith((".h265", ".265", ".hevc")) \
                or container_codec in ("hevc", "h265") \
                or out.endswith((".h265", ".265", ".hevc")):
            # An HEVC stream stays HEVC through processing (the sink's
            # rtpmap/mux and the encoder bridge are codec-threaded), so
            # the packet route additionally needs the HEVC encoder; a
            # libx264-only build would die mid-run at switch_processing()
            # where the frame graph works fine.
            enc_ok = enc_ok and available("libx265")
        return src_ok and out_ok and enc_ok

    def _build_frame_graph(self, sink) -> None:
        """Decoded-frame graph (the vsg.cpp appsink/appsrc route)."""
        self.source = open_source(
            self.cfg.video_source,
            SourceParams(source=self.cfg.video_source,
                         **{k: getattr(self.cfg.camera, k)
                            for k in ("threaded_queue_mode", "colorspace",
                                      "logging", "queue_size")}))
        self.sink = sink if sink is not None else open_sink(
            self.cfg.output_source)
        self.graph.add_pipeline("source", source=self.source,
                                publish_to="source")
        self.graph.add_pipeline("processing", listen_to="source",
                                processor=self._process_frame,
                                publish_to="processed")
        self.graph.add_pipeline("output",
                                listen_to=self._initial_route(),
                                sink=self.sink)

    def _build_packet_graph(self) -> None:
        """Compressed-domain graph: access units ride lossless channels; the
        output pipeline's listen-to flips between the byte-identical
        "source_pkt" relay and the decoded->processed->re-encoded
        "processed_pkt" stream (GstdManager.cpp:155-229, 324-327;
        vsg.cpp:418-525)."""
        from video_stab_tpu_torch.io.packets import (PacketDecoderBridge,
                                                     PacketEncoderBridge,
                                                     open_packet_sink,
                                                     open_packet_source)
        src = self.cfg.video_source
        fps = int(getattr(self.cfg.camera, "fps", 30) or 30)
        # File sources are paced at the stream rate: the graph models a
        # LIVE relay (hot mode switches happen mid-stream, not after an
        # instant drain of the whole file). Container ingest stays
        # compressed too (native demux + mp4toannexb — the reference's
        # qtdemux stage).
        self.source = open_packet_source(src, realtime_fps=fps)
        # The sink must speak the SOURCE's codec (an HEVC camera relayed
        # through an H264-announcing RTSP sink would hand every client an
        # undecodable stream); codec_name is known once the source is up
        # (SDP rtpmap / container codec id / extension).
        if hasattr(self.source, "start"):
            self.source.start()
        src_codec = getattr(self.source, "codec_name", "") or "h264"
        sink_codec = "h265" if src_codec in ("hevc", "h265") else "h264"
        self.sink = open_packet_sink(
            self.cfg.output_source, fps=fps, codec=sink_codec)
        self._pkt_decoder = PacketDecoderBridge()
        # The re-encode branch must emit the codec the sink announces —
        # processed HEVC stays HEVC end to end (ADVICE r3).
        self._pkt_encoder = PacketEncoderBridge(fps=fps, codec=sink_codec)
        self._pkt_wait_idr = True
        self._pkt_active = self._initial_route() == "processed"
        self._pkt_frame_hw = None     # (H, W) once a frame was decoded
        # Lossless ordered channels (Channel depth > 1): dropping an access
        # unit would break the decode chain and byte-identity.
        self.graph.channel("source_pkt").depth = 256
        self.graph.channel("processed_pkt").depth = 256
        self.graph.add_pipeline("source", source=self.source,
                                publish_to="source_pkt")
        self.graph.add_pipeline("processing", listen_to="source_pkt",
                                processor=self._process_packet,
                                publish_to="processed_pkt")
        self.graph.add_pipeline(
            "output",
            listen_to="processed_pkt" if self._pkt_active else "source_pkt",
            sink=self.sink)
        self.chain = self._packet_chain(self.chain, self.cfg)

    def _packet_chain(self, chain, cfg: AppConfig):
        """The chain the packet graph runs for ``cfg``: its only consumer
        is the encoder bridge, so the BT.601 I420 conversion folds into
        the device chain (half the device->host payload, no host swscale
        pass — native/codec.cpp vs_enc_encode_yuv). BGR is kept when a
        tracker overlay must draw on the decoded frames, and when the
        decoded frame size is known and I420 cannot hold it
        (``bgr_to_i420`` needs H % 4 == 0 and W % 2 == 0)."""
        if (not self.packet_mode or chain is None
                or cfg.mode.tracker_enabled):
            return chain
        hw = self._pkt_frame_hw
        if hw is not None and (hw[0] % 4 or hw[1] % 2):
            return chain
        return chain.with_output_format("i420")

    def _fit_packet_frame(self, frame: np.ndarray) -> None:
        """Note the decoded frame size; a chain set to I420 goes back to
        BGR when the size cannot be held in I420 (such a chain has run no
        frame: ``bgr_to_i420`` would have raised). Checked on every frame,
        so an I420 chain that a reload built before the first decode and
        swapped in after it is fitted too."""
        hw = tuple(frame.shape[:2])
        with self._lock:
            self._pkt_frame_hw = hw
            chain = self.chain
            if (chain is not None and chain.params.output_format == "i420"
                    and (hw[0] % 4 or hw[1] % 2)):
                self.log.info("frame %dx%d does not fit I420; the chain "
                              "delivers BGR", hw[1], hw[0])
                self.chain = chain.with_output_format("bgr")

    @property
    def decoder_constructed(self) -> bool:
        """True once the packet graph has EVER instantiated its decoder —
        stays False over a pure passthrough run (the reference's no-decoder
        guarantee for passthrough mode). Sticky across stop() so it can be
        asserted post-run."""
        return self.packet_mode and self._pkt_decoder.ever_constructed

    def _process_packet(self, au):
        """Processing branch of the packet graph. In passthrough it drops
        units WITHOUT decoding (the decoder is never constructed); when
        processing is switched on mid-stream it waits for the next IDR,
        attaches the decoder, runs the frame chain, and re-encodes."""
        if not self._pkt_active:
            self._pkt_wait_idr = True
            return None
        from video_stab_tpu_torch.io.codec import is_irap
        src_codec = getattr(self.source, "codec_name", "") or "h264"
        is_hevc = src_codec in ("hevc", "h265")
        if is_hevc and not self._pkt_decoder.decoder_constructed:
            self._pkt_decoder.codec = "hevc"
        if self._pkt_wait_idr:
            if not any(is_irap(n, src_codec) for n in au):
                return None         # resume at the next gop boundary
            self._pkt_wait_idr = False
        out_nals = []
        for frame in self._pkt_decoder.decode_unit(au):
            self._fit_packet_frame(frame)
            out = self._process_frame(frame)
            if out is None:
                continue
            # Dispatch on the frame's own layout — device-emitted planar
            # I420 is 2-D (H*3/2, W), BGR is 3-D. Keying on the array
            # (not self.chain) keeps this consistent with whatever chain
            # produced it even if a hot reload swaps the chain between
            # this read and _process_frame's snapshot.
            if out.ndim == 2:
                # Planar I420 goes straight into libx264 (no host
                # swscale; half the D2H payload).
                nals = self._pkt_encoder.encode_frame_yuv(
                    np.ascontiguousarray(out))
            else:
                nals = self._pkt_encoder.encode_frame(
                    np.ascontiguousarray(out[:, :, :3]))
            if nals:
                out_nals.extend(nals)
        return out_nals or None

    # -- config / processors ----------------------------------------------
    def _make_processors(self, cfg: AppConfig) -> tuple:
        """(chain, enhancer, roll, azc, stabilizer) for ``cfg``, each on
        the device its ``mode`` picks; the app's attributes are left as
        they are."""
        m = cfg.mode
        if self.fused and (m.enhancer_enabled or m.roll_correction_enabled or
                           m.stabilizer_enabled):
            # One fused chain for the device-side stages (core/chain.py):
            # one host<->device round trip per frame, on mode's device.
            # azc runs INSIDE the fused chain (paired with roll correction,
            # roll-correction-file.cpp:61-68, gated by auto_zoom_crop.enabled).
            return (ProcessingChain(
                m, cfg.enhancer, cfg.roll_correction, cfg.stabilizer,
                azc=cfg.auto_zoom_crop, fuse_roll=cfg.roll_fusion),
                None, None, None, None)
        dev = pick_device(m.use_cuda)
        enhancer = Enhancer(cfg.enhancer, device=dev) \
            if m.enhancer_enabled else None
        roll = RollCorrection(cfg.roll_correction, device=dev) \
            if m.roll_correction_enabled else None
        azc = AutoZoomCrop(cfg.auto_zoom_crop, device=dev) \
            if (m.roll_correction_enabled and
                cfg.auto_zoom_crop.enabled) else None
        stabilizer = Stabilizer(cfg.stabilizer, mode=m) \
            if m.stabilizer_enabled else None
        return None, enhancer, roll, azc, stabilizer

    def _initial_route(self) -> str:
        """Passthrough iff every processing toggle is off
        (vsg.cpp:1228-1233, 1321-1327)."""
        m = self.cfg.mode
        processing = (m.enhancer_enabled or m.roll_correction_enabled or
                      m.stabilizer_enabled or m.tracker_enabled)
        return "processed" if processing else "source"

    def _on_config_change(self, new_cfg: AppConfig):
        """Hot reload: swap params + rebuild the chain + switch mode
        (vsg.cpp:1346-1415). The new device, processors and tracker are
        built first and swapped in together under the lock, so a rebuild
        that raises leaves the app running its old config whole. The old
        chain is dropped at the swap; a frame in flight finishes on the
        snapshot it took."""
        self.log.info("config changed; reloading")
        new_cfg = self._pinned(new_cfg)
        device = pick_device(new_cfg.mode.use_cuda)
        chain, *stages = self._make_processors(new_cfg)
        procs = (self._packet_chain(chain, new_cfg), *stages)
        old_tracker = tracker = self._tracker
        if tracker is not None and (not new_cfg.mode.tracker_enabled
                                    or tracker.device != device):
            tracker = None
        if new_cfg.mode.tracker_enabled and tracker is None:
            tracker = ObjectTracker(new_cfg.tracker, device=device)
        with self._lock:
            self.cfg, self.device, self._tracker = new_cfg, device, tracker
            (self.chain, self.enhancer, self.roll, self.azc,
             self.stabilizer) = procs
        if old_tracker is not None and old_tracker is not tracker:
            old_tracker.release()          # join its async thread
        if self._initial_route() == "processed":
            self.switch_processing()
        else:
            self.switch_passthrough()
        self.metrics.inc("config_reloads")

    # -- per-frame chain (vsg.cpp:1246-1313) -------------------------------
    def _process_frame(self, frame):
        with self._lock:                      # snapshot under mutex
            chain = self.chain
            enhancer, roll, azc = self.enhancer, self.roll, self.azc
            stab, tracker = self.stabilizer, self._tracker
        t = self.metrics.timer
        if chain is not None:
            with t.stage("fused_chain"):
                out = chain.process(frame)
            if out is None:
                self.metrics.inc("warmup_frames")
                return None
            frame = out
            if tracker is not None:
                with t.stage("track"):
                    dets = tracker.process_frame(frame)
                    sel = self.tcp.try_get_latest() if self.tcp else None
                    frame = tracker.draw_detections(
                        frame, dets, *(sel or (-1, -1)))
            self.metrics.inc("frames_out")
            self._frames_out += 1
            return frame
        if enhancer is not None:
            with t.stage("enhance"):
                frame = enhancer.enhance(frame)
        if roll is not None:
            with t.stage("roll"):
                frame = roll.auto_correct_roll(frame)
            if azc is not None:
                # Remove the rotation's borders (roll-correction-file.cpp:
                # 61-68); config-gated by auto_zoom_crop.enabled.
                with t.stage("auto_zoom_crop"):
                    frame = azc.auto_zoom_crop(frame)
        if stab is not None:
            with t.stage("stabilize"):
                out = stab.stabilize(frame)
            if out is None:
                self.metrics.inc("warmup_frames")
                return None
            frame = out
            met = stab.last_metrics
            # The metrics stay on the device; read them at reporting
            # cadence only (the reference prints every 30 frames).
            if met and self._frames_out % 30 == 0:
                self.metrics.set("n_tracked", float(met.get("n_tracked", 0)))
                self.metrics.set("n_inliers", float(met.get("n_inliers", 0)))
        if tracker is not None:
            with t.stage("track"):
                dets = tracker.process_frame(frame)
                sel = self.tcp.try_get_latest() if self.tcp else None
                if sel:
                    frame = tracker.draw_detections(frame, dets, *sel)
                else:
                    frame = tracker.draw_detections(frame, dets)
        self.metrics.inc("frames_out")
        self._frames_out += 1
        return frame

    # -- interactive controls (vsg.cpp:1426-1451) ---------------------------
    def switch_passthrough(self):
        if self.packet_mode:
            self._pkt_active = False
            self.graph.set_listen_to("output", "source_pkt")
        else:
            self.graph.set_listen_to("output", "source")

    def switch_processing(self):
        if self.packet_mode:
            self._pkt_wait_idr = True     # decoder attaches at the next IDR
            # Point the output at the processed channel BEFORE activating
            # the re-encode branch: the listen_to setter captures the join
            # cursor at call time, so ordering this first guarantees the
            # branch's first emitted unit (SPS/PPS+IDR) is delivered even
            # if it publishes before the output thread's next iteration.
            self.graph.set_listen_to("output", "processed_pkt")
            self._pkt_active = True
        else:
            self.graph.set_listen_to("output", "processed")

    def print_status(self):
        import json
        print(json.dumps({"pipelines": self.graph.pipeline_list(),
                          "metrics": self.metrics.snapshot()},
                         indent=2, default=str))

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self.source.start()
        self.graph.start()
        if self.watcher:
            self.watcher.start()
        self.keyboard = KeyboardController(
            self.switch_passthrough, self.switch_processing,
            self.print_status, self._stop.set).start()
        return self

    def run(self, duration: float = 0.0):
        """Block until duration (s) elapses, max_frames reached, or stop()."""
        self.start()
        t0 = time.monotonic()
        try:
            while not self._stop.is_set():
                if duration and time.monotonic() - t0 >= duration:
                    break
                if self.max_frames and self._frames_out >= self.max_frames:
                    break
                time.sleep(0.05)
        finally:
            self.stop()

    def stop(self):
        self._stop.set()
        if getattr(self, "keyboard", None):
            self.keyboard.stop()
        if self.watcher:
            self.watcher.stop()
        if self.tcp:
            self.tcp.stop()
        if self.rest:
            self.rest.stop()
        if self.chain is not None and not self.packet_mode:
            # Packet sinks take access units, and the packet graph is a
            # live relay (no end-of-file drain).
            # Drain the stabilizer's look-ahead queue into the sink before
            # the graph closes it — a finite stream otherwise loses its
            # last effective_radius frames (Stabilizer.cpp:394-400 flush).
            # Pipeline worker threads stop first so the drain's writes
            # can't interleave with the output pipeline's.
            for p_ in self.graph._pipelines.values():
                p_.stop()
            try:
                while (o := self.chain.flush()) is not None:
                    self.sink.write(o)
                    self._frames_out += 1
            except Exception:  # noqa: BLE001
                self.log.exception("end-of-stream drain failed")
        self.graph.stop()
        if self.packet_mode:
            self._pkt_decoder.close()
            self._pkt_encoder.close()
        if self._tracker is not None:
            self._tracker.release()


def run_app(config_path: str, **kw) -> StabilizerApp:
    cfg = load_config(config_path)
    return StabilizerApp(cfg, config_path=config_path, **kw)


__all__ = ["StabilizerApp", "run_app"]
