"""Frame sinks — port of ``video_stab_tpu/io/sinks.py``.

Counterparts of the reference's output plumbing:
- FileSink      <- the file-out path of the examples (cv2.VideoWriter).
- MJPEGServer   <- a zero-dependency HTTP preview sink (every browser/VLC
                   plays it).
- CallbackSink / NullSink for tests.

The JAX package's encoder sinks (``H264FileSink`` for ``.h264`` /
``.264``, ``ContainerSink`` for ``.mp4`` / ``.mkv`` / ``.mov`` and the
``rtsp://`` server) stand on its native codec layer, which the port has
not taken yet (ROADMAP queue 1 item 13b): ``open_sink`` raises
``NotImplementedError`` for those targets rather than writing another
format.
"""

from __future__ import annotations

import dataclasses
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

from video_stab_tpu_torch.utils.telemetry import get_logger


def bitrate_kbps_server(width: int, height: int, fps: int) -> int:
    """RTSPServer heuristic: max(2000, w*h*fps/500) kbps (RTSPServer.cpp:80)."""
    return max(2000, int(width * height * fps / 500))


def bitrate_bps_app(width: int, height: int, fps: int) -> int:
    """App heuristic: clamp(w*h*fps*0.1, 2 Mbps, 8 Mbps) (vsg.cpp:415, 1238)."""
    return int(min(max(width * height * fps * 0.1, 2e6), 8e6))


@dataclasses.dataclass(frozen=True)
class EncoderParams:
    """JetsonEncoder-equivalent knobs (examples/JetsonEncoder.cpp:22-116)."""

    codec: str = "mp4v"        # fourcc; "avc1"/"mp4v"/"XVID"/"MJPG"
    fps: float = 30.0
    bitrate_bps: int = 0       # 0 = auto heuristic (informational for cv2)


class FrameSink:
    def write(self, frame: np.ndarray) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class NullSink(FrameSink):
    def __init__(self):
        self.count = 0

    def write(self, frame):
        self.count += 1


class CallbackSink(FrameSink):
    def __init__(self, fn: Callable[[np.ndarray], None]):
        self.fn = fn

    def write(self, frame):
        self.fn(frame)


class FileSink(FrameSink):
    """cv2.VideoWriter file writer (.avi and the other cv2 targets)."""

    def __init__(self, path: str, params: EncoderParams = EncoderParams()):
        self.path = path
        self.params = params
        self._writer = None
        self.frames_written = 0

    def write(self, frame: np.ndarray) -> None:
        import cv2
        if self._writer is None:
            h, w = frame.shape[:2]
            fourcc = cv2.VideoWriter_fourcc(*self.params.codec)
            self._writer = cv2.VideoWriter(
                self.path, fourcc, self.params.fps, (w, h))
            if not self._writer.isOpened():
                raise IOError(f"cannot open video writer for {self.path}")
        self._writer.write(frame)
        self.frames_written += 1

    def close(self) -> None:
        if self._writer is not None:
            self._writer.release()
            self._writer = None


class MJPEGServer(FrameSink):
    """Multipart-MJPEG HTTP streaming server with RTSPServer's API shape:
    construct with (port, mount), ``push_frame(frame)``, shared stream for
    any number of clients (RTSPServer.h:16-22, shared factory
    RTSPServer.cpp:95)."""

    BOUNDARY = b"--vstabframe"

    def __init__(self, port: int = 8554, mount: str = "/stream",
                 fps: int = 30, quality: int = 80, logging: bool = False):
        self.port = port
        self.mount = mount
        self.fps = fps
        self.quality = quality
        self.log = get_logger("MJPEGServer", logging)
        self._latest_jpeg: Optional[bytes] = None
        self._cond = threading.Condition()
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.clients = 0

    # -- sink API ----------------------------------------------------------
    def push_frame(self, frame: np.ndarray) -> None:
        import cv2
        ok, buf = cv2.imencode(
            ".jpg", frame, [cv2.IMWRITE_JPEG_QUALITY, self.quality])
        if not ok:
            return
        with self._cond:
            self._latest_jpeg = buf.tobytes()
            self._cond.notify_all()

    write = push_frame

    # -- server ------------------------------------------------------------
    def start(self) -> "MJPEGServer":
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet
                pass

            def do_GET(self):
                if self.path not in (outer.mount, "/"):
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=vstabframe")
                self.end_headers()
                outer.clients += 1
                try:
                    last = None
                    while True:
                        with outer._cond:
                            outer._cond.wait(timeout=1.0)
                            jpeg = outer._latest_jpeg
                        if jpeg is None or jpeg is last:
                            continue
                        last = jpeg
                        self.wfile.write(outer.BOUNDARY + b"\r\n")
                        self.wfile.write(b"Content-Type: image/jpeg\r\n")
                        self.wfile.write(
                            f"Content-Length: {len(jpeg)}\r\n\r\n".encode())
                        self.wfile.write(jpeg + b"\r\n")
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass
                finally:
                    outer.clients -= 1

        self._server = ThreadingHTTPServer(("0.0.0.0", self.port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        self.log.info("serving MJPEG on :%d%s", self.port, self.mount)
        return self

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}{self.mount}"

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


ENCODER_SINKS_ITEM = ("the native codec layer's encoder sinks (.h264, "
                      ".264, .mp4, .mkv, .mov and rtsp://) are not ported "
                      "yet: ROADMAP queue 1 item 13b")


def open_sink(target: str, fps: float = 30.0) -> FrameSink:
    """Sink dispatch (the output half of CamCap's source dispatch,
    CamCap.cpp:22-77):

    - "" / "null"            -> NullSink
    - "mjpeg://:PORT/mount"  -> MJPEGServer (HTTP preview)
    - "rtsp://...", "*.h264", "*.264", "*.mp4", "*.mkv", "*.mov"
                             -> NotImplementedError (ROADMAP item 13b)
    - anything else          -> FileSink (cv2 writer, e.g. .avi)
    """
    if not target or target == "null":
        return NullSink()
    if target.startswith("rtsp://"):
        raise NotImplementedError(f"{target}: {ENCODER_SINKS_ITEM}")
    if target.startswith("mjpeg://"):
        rest = target[len("mjpeg://"):]
        host_port, _, mount = rest.partition("/")
        port = int(host_port.rsplit(":", 1)[-1]) if ":" in host_port \
            else int(host_port or 8554)
        return MJPEGServer(port=port, mount="/" + (mount or "stream")).start()
    if target.endswith(".h264") or target.endswith(".264") or \
            target.rsplit(".", 1)[-1].lower() in ("mp4", "mkv", "mov"):
        raise NotImplementedError(f"{target}: {ENCODER_SINKS_ITEM}")
    return FileSink(target, EncoderParams(fps=fps))


__all__ = ["CallbackSink", "EncoderParams", "FileSink", "FrameSink",
           "MJPEGServer", "NullSink", "bitrate_bps_app",
           "bitrate_kbps_server", "open_sink"]
