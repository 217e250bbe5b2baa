"""Frame sinks + host codec layer — port of ``video_stab_tpu/io/sinks.py``.

Counterparts of the reference's output plumbing:
- H264FileSink  <- examples/JetsonEncoder.cpp (V4L2 HW H.264/H.265 with CBR
                   rate control) — native libx264 encode (io/codec.py) with
                   a *honored* bitrate and the reference's heuristics
                   (RTSPServer.cpp:80, vsg.cpp:415, 1238).
- ContainerSink <- the MP4-out path of the examples: native encode + in-C
                   libavformat muxing (.mp4 / .mkv / .mov).
- FileSink      <- the cv2.VideoWriter path (.avi and the other cv2
                   targets).
- MJPEGServer   <- a zero-dependency HTTP preview sink (every browser/VLC
                   plays it). The real RTSP/H.264 server lives in
                   io/rtsp.py (src/RTSPServer.cpp counterpart).
- CallbackSink / NullSink for tests.
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


class H264FileSink(FrameSink):
    """Annex-B H.264 elementary-stream writer with honored CBR bitrate.

    The JetsonEncoder counterpart (examples/JetsonEncoder.cpp:129-194:
    encodeFrame(cv::Mat) -> bitstream bytes; CBR config 22-116). Output is
    a raw .h264 byte stream — playable/decodable everywhere (ffplay, VLC,
    cv2.VideoCapture) and byte-relayable through the packet-domain channels.

    ``bitrate_bps=0`` applies the reference app heuristic
    clamp(w*h*fps*0.1, 2, 8 Mbps) (vsg.cpp:415, 1238).
    """

    def __init__(self, path: str, fps: float = 30.0, bitrate_bps: int = 0,
                 codec: str = "libx264", zerolatency: bool = True):
        self.path = path
        self.fps = fps
        self.bitrate_bps = bitrate_bps
        self.codec = codec
        self.zerolatency = zerolatency
        self._encoder = None
        self._file = None
        self.frames_written = 0

    def write(self, frame: np.ndarray) -> None:
        from video_stab_tpu_torch.io.codec import VideoEncoder
        if self._encoder is None:
            h, w = frame.shape[:2]
            bps = self.bitrate_bps or bitrate_bps_app(w, h, int(self.fps))
            self._encoder = VideoEncoder(
                w, h, self.fps, bitrate_bps=bps, codec=self.codec,
                zerolatency=self.zerolatency)
            self._file = open(self.path, "wb")
        self._file.write(self._encoder.encode(frame))
        self.frames_written += 1

    def measured_bitrate_bps(self) -> float:
        return self._encoder.measured_bitrate_bps() if self._encoder else 0.0

    def close(self) -> None:
        if self._encoder is not None:
            self._file.write(self._encoder.flush())
            self._encoder.close()
            self._encoder = None
        if self._file is not None:
            self._file.close()
            self._file = None


class ContainerSink(FrameSink):
    """H.264-in-MP4/MKV writer with honored CBR bitrate (native encode +
    in-C libavformat muxing). Where the native codec layer is missing,
    the first ``write`` raises with its build's message: unlike the JAX
    package, the port writes no cv2 file in its place."""

    def __init__(self, path: str, fps: float = 30.0, bitrate_bps: int = 0,
                 codec: str = "libx264"):
        self.path = path
        self.fps = fps
        self.bitrate_bps = bitrate_bps
        self.codec = codec
        self._writer = None
        self.frames_written = 0

    def write(self, frame: np.ndarray) -> None:
        if self._writer is None:
            from video_stab_tpu_torch.io.codec import ContainerWriter
            h, w = frame.shape[:2]
            bps = self.bitrate_bps or bitrate_bps_app(w, h, int(self.fps))
            self._writer = ContainerWriter(
                self.path, w, h, self.fps, bitrate_bps=bps, codec=self.codec)
        self._writer.write(frame)
        self.frames_written += 1

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
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


def open_sink(target: str, fps: float = 30.0) -> FrameSink:
    """Sink dispatch (the output half of CamCap's source dispatch,
    CamCap.cpp:22-77):

    - "" / "null"            -> NullSink
    - "rtsp://[host]:PORT/m" -> RTSPServer (native H.264, io/rtsp.py)
    - "mjpeg://:PORT/mount"  -> MJPEGServer (HTTP preview)
    - "*.h264", "*.264"      -> H264FileSink (native CBR encode)
    - "*.mp4", "*.mkv", "*.mov"
                             -> ContainerSink (native encode + mux)
    - anything else          -> FileSink (cv2 writer, e.g. .avi)
    """
    if not target or target == "null":
        return NullSink()
    if target.startswith("rtsp://"):
        from video_stab_tpu_torch.io.rtsp import RTSPServer
        rest = target[len("rtsp://"):]
        host_port, _, mount = rest.partition("/")
        port = int(host_port.rsplit(":", 1)[-1]) if ":" in host_port \
            else 8554
        return RTSPServer(port=port, mount="/" + (mount or "stream"),
                          fps=int(fps)).start()
    if target.startswith("mjpeg://"):
        rest = target[len("mjpeg://"):]
        host_port, _, mount = rest.partition("/")
        port = int(host_port.rsplit(":", 1)[-1]) if ":" in host_port \
            else int(host_port or 8554)
        return MJPEGServer(port=port, mount="/" + (mount or "stream")).start()
    if target.endswith(".h264") or target.endswith(".264"):
        return H264FileSink(target, fps=fps)
    if target.rsplit(".", 1)[-1].lower() in ("mp4", "mkv", "mov"):
        return ContainerSink(target, fps=fps)
    return FileSink(target, EncoderParams(fps=fps))


__all__ = ["CallbackSink", "ContainerSink", "EncoderParams", "FileSink",
           "FrameSink", "H264FileSink", "MJPEGServer", "NullSink",
           "bitrate_bps_app", "bitrate_kbps_server", "open_sink"]
