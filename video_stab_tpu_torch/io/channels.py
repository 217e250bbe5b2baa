"""Named-channel stream graph with hot-switchable routing; port of
``video_stab_tpu/io/channels.py``.

The interpipe/gstd analog (SURVEY.md §2 #8/#9): the reference wires
independent GStreamer pipelines through named interpipe pub/sub elements and
switches the output pipeline's ``listen-to`` property at runtime for
seamless passthrough <-> processing mode changes (GstdManager.cpp:155-229,
324-327; vsg.cpp:418-525).

Here: ``Channel`` is a latest-only pub/sub slot keyed by name inside a
``StreamGraph``; ``Pipeline``s are worker threads that pull from an input
channel (or a FrameSource), run a processor, and publish to an output
channel; ``set_listen_to`` re-points a pipeline's input atomically."""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

from video_stab_tpu_torch.io.sinks import FrameSink
from video_stab_tpu_torch.io.sources import FrameSource
from video_stab_tpu_torch.utils.telemetry import get_logger


class Channel:
    """Pub/sub slot (the interpipesink/src pair).

    depth=1 (default): latest-only — late subscribers skip straight to the
    newest frame (raw-frame channels, where freshness beats completeness).
    depth>1: lossless ordered ring of the last `depth` items — REQUIRED for
    packet (compressed-domain) channels, where dropping an access unit
    breaks the decode chain and byte-identity (P-frames reference their
    predecessors; the reference's interpipe elements queue for the same
    reason)."""

    def __init__(self, name: str, depth: int = 1):
        self.name = name
        self.depth = depth
        self._cond = threading.Condition()
        self._items: Dict[int, object] = {}     # seq -> item (depth newest)
        self._seq = 0

    def publish(self, frame) -> None:
        with self._cond:
            self._seq += 1
            self._items[self._seq] = frame
            if len(self._items) > self.depth:
                del self._items[self._seq - self.depth]
            self._cond.notify_all()

    def subscribe(self, last_seq: int, timeout: float = 0.5):
        """Block until an item newer than last_seq arrives. Returns
        (item, seq) — the OLDEST retained item newer than last_seq (in-order
        delivery; with depth=1 that is simply the latest) — or
        (None, last_seq) on timeout."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._seq <= last_seq:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None, last_seq
                self._cond.wait(remaining)
            seq = max(last_seq + 1, self._seq - len(self._items) + 1)
            while seq not in self._items:       # overwritten: skip forward
                seq += 1
            return self._items[seq], seq


class Pipeline:
    """One worker: input (channel name or FrameSource) -> processor ->
    output channel / sink."""

    def __init__(self, graph: "StreamGraph", name: str,
                 listen_to: Optional[str] = None,
                 source: Optional[FrameSource] = None,
                 processor: Optional[Callable[[np.ndarray],
                                              Optional[np.ndarray]]] = None,
                 publish_to: Optional[str] = None,
                 sink: Optional[FrameSink] = None):
        self.graph = graph
        self.name = name
        self._listen_to = listen_to
        self._join_seq: Optional[int] = None    # cursor captured at switch
        self.source = source
        self.processor = processor
        self.publish_to = publish_to
        self.sink = sink
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.frames_processed = 0

    @property
    def listen_to(self) -> Optional[str]:
        with self._lock:
            return self._listen_to

    @listen_to.setter
    def listen_to(self, channel_name: str) -> None:
        with self._lock:
            if channel_name == self._listen_to:
                return
            self._listen_to = channel_name
            # Capture the join cursor NOW, not when the worker thread
            # notices the switch: a unit published to the new channel
            # between this call and the worker's next loop iteration must
            # be delivered — in the packet graph that first unit is
            # exactly the SPS/PPS+IDR the freshly-activated re-encode
            # branch emits, and skipping it leaves downstream decoders
            # with reference-less P frames for a whole GOP.
            self._join_seq = (self.graph.channel(channel_name)._seq
                              if channel_name is not None else None)

    def _next_frame(self, last_seq: int):
        if self.source is not None:
            item = self.source.read()
            if item is None:
                time.sleep(0.005)       # EOF / transient gap: don't spin
            return item, last_seq
        name = self.listen_to
        if name is None:
            time.sleep(0.01)
            return None, last_seq
        return self.graph.channel(name).subscribe(last_seq)

    def _run(self):
        last_seq = 0
        listened = self.listen_to
        while not self._stop.is_set():
            # Hot listen-to switch: sequence numbers are PER CHANNEL, so
            # a carried-over cursor would stall until the new channel
            # catches up to the old one's count (or replay its whole
            # retained ring). Join the new channel at its head AS OF the
            # switch request (_join_seq, captured by the setter) — the
            # interpipe listen-to semantic (GstdManager.cpp 324-327: the
            # output pipeline picks up the new producer's next buffer),
            # without dropping units published during the handover.
            name = self.listen_to
            if name != listened:
                listened = name
                if name is not None:
                    with self._lock:
                        js = self._join_seq
                    last_seq = js if js is not None \
                        else self.graph.channel(name)._seq
            frame, last_seq = self._next_frame(last_seq)
            if frame is None:
                continue
            out = self.processor(frame) if self.processor else frame
            if out is None:
                continue
            if self.publish_to:
                self.graph.channel(self.publish_to).publish(out)
            if self.sink is not None:
                self.sink.write(out)
            self.frames_processed += 1

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"pipeline-{self.name}")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)


class StreamGraph:
    """The in-process GstdManager: named channels + named pipelines +
    hot-switchable routing (GstdManager.cpp:155-229; switching 324-327)."""

    def __init__(self, logging: bool = False):
        self.log = get_logger("StreamGraph", logging)
        self._channels: Dict[str, Channel] = {}
        self._pipelines: Dict[str, Pipeline] = {}

    def channel(self, name: str) -> Channel:
        if name not in self._channels:
            self._channels[name] = Channel(name)
        return self._channels[name]

    def add_pipeline(self, name: str, **kw) -> Pipeline:
        p = Pipeline(self, name, **kw)
        self._pipelines[name] = p
        return p

    def pipeline(self, name: str) -> Pipeline:
        return self._pipelines[name]

    def set_listen_to(self, pipeline_name: str, channel_name: str) -> None:
        """The seamless mode switch (GstdManager::switchMode, 324-327)."""
        self.log.info("switching %s -> listen-to %s", pipeline_name,
                      channel_name)
        self._pipelines[pipeline_name].listen_to = channel_name

    def pipeline_list(self) -> list:
        """gst-client pipeline_list equivalent."""
        return [
            {"name": p.name, "listen_to": p.listen_to,
             "publish_to": p.publish_to,
             "frames_processed": p.frames_processed}
            for p in self._pipelines.values()
        ]

    def start(self):
        for p in self._pipelines.values():
            p.start()
        return self

    def stop(self):
        for p in self._pipelines.values():
            p.stop()
        for p in self._pipelines.values():
            if p.source is not None:
                p.source.stop()
            if p.sink is not None:
                p.sink.close()


class ChannelBridge:
    """Bidirectional frame bridge — the vs::CamCapInterpipe counterpart
    (src/CamCapInterpipe.cpp: interpipesrc->appsink input + appsrc->
    interpipesink output, include/video/CamCapInterpipe.h:37-46's
    read()/pushFrame() surface). Attach to a StreamGraph's named channels:
    ``read()`` pulls the next frame from ``listen_to``; ``push_frame()``
    publishes into ``publish_to``."""

    def __init__(self, graph: "StreamGraph", listen_to: str,
                 publish_to: str):
        self.graph = graph
        self.listen_to = listen_to
        self.publish_to = publish_to
        self._last_seq = 0
        self._running = True
        self.frames_in = 0
        self.frames_out = 0

    def read(self, timeout: float = 0.5) -> Optional[np.ndarray]:
        frame, self._last_seq = self.graph.channel(
            self.listen_to).subscribe(self._last_seq, timeout)
        if frame is not None:
            self.frames_in += 1
        return frame

    def push_frame(self, frame: np.ndarray) -> None:
        self.graph.channel(self.publish_to).publish(frame)
        self.frames_out += 1

    # reference API aliases (CamCapInterpipe.h:37-46)
    write = push_frame

    def is_healthy(self) -> bool:
        return self._running

    def stop(self) -> None:
        self._running = False


__all__ = ["Channel", "ChannelBridge", "Pipeline", "StreamGraph"]
