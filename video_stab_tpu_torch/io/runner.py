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

The JAX package's packet (compressed-domain) graph stands on its native
codec layer, which the port has not taken yet (ROADMAP queue 1 item 13b):
``packet_mode=True`` raises ``NotImplementedError``, and the automatic
choice takes the frame graph.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

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

PACKET_MODE_ITEM = ("packet mode (the compressed-domain graph) needs the "
                    "native codec layer, which is not ported yet: ROADMAP "
                    "queue 1 item 13b")
_PACKET_SOURCES = (".h264", ".264", ".h265", ".265", ".hevc", ".mp4",
                   ".m4v", ".mkv", ".mov")


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
        """Packet mode is the JAX package's compressed-domain graph; here
        asking for it raises, and the automatic choice takes the frame
        graph, saying so where the JAX package might have chosen packets
        (a compressed file or rtsp:// source without an explicit sink)."""
        if packet_mode:
            raise NotImplementedError(PACKET_MODE_ITEM)
        src = self.cfg.video_source
        if packet_mode is None and sink is None and (
                src.endswith(_PACKET_SOURCES) or src.startswith("rtsp://")):
            self.log.info("%s; running the decoded-frame graph",
                          PACKET_MODE_ITEM)
        return False

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
        procs = self._make_processors(new_cfg)
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
            self.metrics.fps.tick()
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
        self.metrics.fps.tick()
        self.metrics.inc("frames_out")
        self._frames_out += 1
        return frame

    # -- interactive controls (vsg.cpp:1426-1451) ---------------------------
    def switch_passthrough(self):
        self.graph.set_listen_to("output", "source")

    def switch_processing(self):
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
        if self.chain is not None:
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
        if self._tracker is not None:
            self._tracker.release()


def run_app(config_path: str, **kw) -> StabilizerApp:
    cfg = load_config(config_path)
    return StabilizerApp(cfg, config_path=config_path, **kw)


__all__ = ["PACKET_MODE_ITEM", "StabilizerApp", "run_app"]
