"""Frame sources — the vs::CamCap counterpart (src/CamCap.cpp,
include/video/CamCap.h:24-77); port of ``video_stab_tpu/io/sources.py``.

Same contract as the reference: source-string dispatch (numeric index ->
camera, rtsp:// -> network stream, path -> file; CamCap.cpp:22-77), a
threaded bounded-queue producer (155-256), auto-reconnect after 5
consecutive failures with 1 s backoff (169-206), blocking ``read()`` with
timeout (258-320), and ``is_healthy()`` (383-385). Decode is OpenCV
VideoCapture on the host (the NVDEC GStreamer strings become whatever
backend cv2 carries); the device never sees any of this machinery — frames
cross to the card once, inside the stabilizer step.

``SyntheticSource`` is the fault-injectable fake used by streaming tests
(SURVEY.md §4c: integration tests with a fake frame source).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

from video_stab_tpu_torch.utils.telemetry import get_logger

MAX_CONSECUTIVE_FAILURES = 5     # CamCap.cpp:169
RECONNECT_BACKOFF_S = 1.0        # CamCap.cpp:196


@dataclasses.dataclass(frozen=True)
class SourceParams:
    """CamCap::Parameters (CamCap.h:24-35)."""

    source: str = "0"
    threaded_queue_mode: bool = True
    colorspace: str = ""          # "" = BGR passthrough; "gray", "rgb"
    logging: bool = False
    time_delay: float = 0.0       # seconds to sleep after open
    thread_timeout: float = 0.5   # read() timeout in seconds
    queue_size: int = 5


class FrameSource:
    """Threaded bounded-queue frame producer with reconnect supervision."""

    def __init__(self, params: SourceParams):
        self.params = params
        self.log = get_logger("FrameSource", params.logging)
        self._queue: deque = deque(maxlen=max(params.queue_size, 1))
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._healthy = False
        self._frames_read = 0
        self._frames_dropped = 0
        self._reconnects = 0
        self._thread: Optional[threading.Thread] = None

    # -- backend hooks (override per source kind) --------------------------
    def _open(self) -> bool:
        raise NotImplementedError

    def _grab(self) -> Optional[np.ndarray]:
        raise NotImplementedError

    def _close(self) -> None:
        pass

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "FrameSource":
        if not self.params.threaded_queue_mode:
            ok = self._open()
            self._healthy = ok
            if self.params.time_delay:
                time.sleep(self.params.time_delay)
            return self
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        failures = 0
        opened = self._open()
        self._healthy = opened
        if self.params.time_delay:
            time.sleep(self.params.time_delay)
        while not self._stop.is_set():
            if not opened:
                self._reconnects += 1
                self.log.info("reconnecting (attempt %d)", self._reconnects)
                time.sleep(RECONNECT_BACKOFF_S)
                self._close()
                opened = self._open()
                self._healthy = opened
                failures = 0
                continue
            frame = self._grab()
            if frame is None:
                failures += 1
                if failures >= MAX_CONSECUTIVE_FAILURES:   # CamCap.cpp:169-206
                    self.log.info("too many failures, rebuilding capture")
                    opened = False
                    self._healthy = False
                continue
            failures = 0
            frame = self._convert(frame)
            with self._cond:
                if len(self._queue) == self._queue.maxlen:
                    self._frames_dropped += 1
                self._queue.append(frame)
                self._frames_read += 1
                self._cond.notify_all()

    def _convert(self, frame: np.ndarray) -> np.ndarray:
        cs = self.params.colorspace.lower()
        if not cs or cs == "bgr":
            return frame
        import cv2
        if cs == "gray":
            g = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            return np.repeat(g[:, :, None], 3, axis=2)
        if cs == "rgb":
            return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        return frame

    def read(self, timeout: Optional[float] = None) -> Optional[np.ndarray]:
        """Blocking read with timeout (CamCap.cpp:258-320)."""
        if not self.params.threaded_queue_mode:
            frame = self._grab()
            return self._convert(frame) if frame is not None else None
        timeout = self.params.thread_timeout if timeout is None else timeout
        deadline = time.monotonic() + timeout
        with self._cond:
            while not self._queue:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stop.is_set():
                    return None
                self._cond.wait(remaining)
            return self._queue.popleft()

    def is_healthy(self) -> bool:
        return self._healthy

    @property
    def stats(self) -> dict:
        return {"frames_read": self._frames_read,
                "frames_dropped": self._frames_dropped,
                "reconnects": self._reconnects}

    def stop(self):
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread:
            self._thread.join(timeout=2.0)
        self._close()


class OpenCVSource(FrameSource):
    """cv2.VideoCapture-backed source: camera index, file path, or URL."""

    def __init__(self, params: SourceParams):
        super().__init__(params)
        self._cap = None
        self._loop_file = False

    def _open(self) -> bool:
        import cv2
        cv2.setNumThreads(0)
        src = self.params.source
        target = int(src) if src.isdigit() else src
        self._cap = cv2.VideoCapture(target)
        return bool(self._cap.isOpened())

    def _grab(self) -> Optional[np.ndarray]:
        if self._cap is None:
            return None
        ok, frame = self._cap.read()
        return frame if ok else None

    def _close(self):
        if self._cap is not None:
            self._cap.release()
            self._cap = None


class SyntheticSource(FrameSource):
    """Deterministic synthetic jittered-window source with fault injection:
    set ``fail_after`` to make _grab return None for ``fail_count`` frames
    (exercises the reconnect supervisor without hardware)."""

    def __init__(self, params: SourceParams = SourceParams(),
                 height: int = 96, width: int = 128, n_frames: int = 0,
                 jitter: float = 2.0, seed: int = 0,
                 fail_after: int = -1, fail_count: int = 0,
                 frame_fn: Optional[Callable[[int], np.ndarray]] = None):
        super().__init__(params)
        self.height, self.width = height, width
        self.n_frames = n_frames      # 0 = infinite
        self.jitter = jitter
        self._fail_after = fail_after
        self._fail_count = fail_count
        self._i = 0
        self._frame_fn = frame_fn
        rng = np.random.default_rng(seed)
        big = rng.random((height + 64, width + 64)).astype(np.float32)
        try:
            import cv2
            big = cv2.GaussianBlur(big, (0, 0), 2.0)
        except Exception:
            pass
        big -= big.min()
        big /= max(float(big.max()), 1e-6)
        self._world = (big * 255.0).astype(np.float32)
        self._rng = rng

    def _open(self) -> bool:
        return True

    def _grab(self) -> Optional[np.ndarray]:
        if self.n_frames and self._i >= self.n_frames:
            return None
        if self._fail_after >= 0 and \
                self._fail_after <= self._i < self._fail_after + self._fail_count:
            self._i += 1
            return None
        i = self._i
        self._i += 1
        if self._frame_fn is not None:
            return self._frame_fn(i)
        dx, dy = self._rng.normal(0.0, self.jitter, 2)
        x0 = int(np.clip(32 + dx, 0, 64))
        y0 = int(np.clip(32 + dy, 0, 64))
        f = self._world[y0:y0 + self.height, x0:x0 + self.width]
        return np.repeat(f[:, :, None], 3, axis=2).astype(np.uint8)


def open_source(source: str, params: Optional[SourceParams] = None,
                **kw) -> FrameSource:
    """Source-string dispatch (CamCap.cpp:22-77): "synthetic[:WxH]" |
    numeric camera index | rtsp/http URL | file path."""
    params = params or SourceParams(source=source, **kw)
    if source.startswith("synthetic"):
        parts = source.split(":")
        h, w = 96, 128
        if len(parts) > 1 and "x" in parts[1]:
            w, h = (int(v) for v in parts[1].split("x"))
        return SyntheticSource(params, height=h, width=w)
    return OpenCVSource(params)


__all__ = ["FrameSource", "OpenCVSource", "SourceParams", "SyntheticSource",
           "open_source"]
