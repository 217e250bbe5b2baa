"""Network frame routing — the multi-host ingest fan-in layer; port of
``video_stab_tpu/io/remote.py``.

SURVEY.md §5 ('Distributed communication backend'): the reference's
inter-pipeline transport is interpipe in-process or RTSP over the network;
here INGEST scales across hosts and fans frames into the serving host over
the network, with the card's batched streams fed from one process
(``parallel.serve_remote_streams``).

Protocol: length-prefixed JPEG frames over TCP —
  [u32 magic][u32 stream_id][u64 stamp][u32 len][len bytes JPEG]
JPEG keeps a 1080p stream around 1-4 MB/s (raw would be 190 MB/s), so one
NIC fans in dozens of cameras. Sender = RemoteFrameSink (attach as any
sink); receiver = RemoteFrameServer exposing per-stream FrameSource-like
``read(stream_id)`` plus ``read_batch`` for the MultiStreamStabilizer.
"""

from __future__ import annotations

import socket
import struct
import threading
from collections import deque
from typing import Dict, Optional

import numpy as np

from video_stab_tpu_torch.io.sinks import FrameSink
from video_stab_tpu_torch.utils.telemetry import get_logger

MAGIC = 0x56535442  # "VSTB"
_HDR = struct.Struct("!IIQI")


class RemoteFrameSink(FrameSink):
    """Sends frames to a RemoteFrameServer (ingest-host side)."""

    def __init__(self, host: str, port: int, stream_id: int = 0,
                 quality: int = 85, connect_timeout: float = 5.0):
        self.stream_id = stream_id
        self.quality = quality
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout)
        self._stamp = 0
        self.frames_sent = 0

    def write(self, frame: np.ndarray) -> None:
        import cv2
        ok, buf = cv2.imencode(".jpg", frame,
                               [cv2.IMWRITE_JPEG_QUALITY, self.quality])
        if not ok:
            return
        payload = buf.tobytes()
        self._sock.sendall(_HDR.pack(MAGIC, self.stream_id, self._stamp,
                                     len(payload)) + payload)
        self._stamp += 1
        self.frames_sent += 1

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class RemoteFrameServer:
    """Receives frames from N ingest hosts (serving-host side).

    Per-stream latest-only bounded queues (the CamCap queue semantics over
    the network); ``read_batch`` assembles the (N, H, W, 3) batch for
    MultiStreamStabilizer, repeating a stream's last frame when it stalls
    (the lockstep serving contract)."""

    def __init__(self, port: int, queue_size: int = 4, logging: bool = False):
        self.port = port
        self.log = get_logger("RemoteFrameServer", logging)
        self._queues: Dict[int, deque] = {}
        self._last: Dict[int, np.ndarray] = {}
        self._cond = threading.Condition()
        self._queue_size = queue_size
        self._stop = threading.Event()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("0.0.0.0", port))
        self._srv.listen(16)
        self._srv.settimeout(0.5)
        self._threads = []
        self._accept_thread: Optional[threading.Thread] = None
        self.frames_received = 0
        self.frames_dropped = 0

    def start(self) -> "RemoteFrameServer":
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        return self

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, addr = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._conn_loop, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _recv_exact(self, conn, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            try:
                chunk = conn.recv(n - len(buf))
            except socket.timeout:
                if self._stop.is_set():
                    return None
                continue
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return buf

    def _conn_loop(self, conn):
        import cv2
        conn.settimeout(0.5)
        with conn:
            while not self._stop.is_set():
                hdr = self._recv_exact(conn, _HDR.size)
                if hdr is None:
                    return
                magic, sid, stamp, ln = _HDR.unpack(hdr)
                if magic != MAGIC or ln > 64 * 1024 * 1024:
                    self.log.info("bad frame header; closing")
                    return
                payload = self._recv_exact(conn, ln)
                if payload is None:
                    return
                frame = cv2.imdecode(
                    np.frombuffer(payload, np.uint8), cv2.IMREAD_COLOR)
                if frame is None:
                    continue
                with self._cond:
                    q = self._queues.setdefault(
                        sid, deque(maxlen=self._queue_size))
                    if len(q) == q.maxlen:
                        self.frames_dropped += 1
                    q.append(frame)
                    self._last[sid] = frame
                    self.frames_received += 1
                    self._cond.notify_all()

    # -- consumer API -------------------------------------------------------
    @property
    def stream_ids(self):
        with self._cond:
            return sorted(self._queues)

    def read(self, stream_id: int, timeout: float = 0.5
             ) -> Optional[np.ndarray]:
        import time as _t
        deadline = _t.monotonic() + timeout
        with self._cond:
            while True:
                q = self._queues.get(stream_id)
                if q:
                    return q.popleft()
                remaining = deadline - _t.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(remaining)

    def read_batch(self, stream_ids, timeout: float = 0.5
                   ) -> Optional[np.ndarray]:
        """Latest frame per stream; stalled streams repeat their last frame.
        None until every stream has delivered at least one frame."""
        frames = []
        for sid in stream_ids:
            f = self.read(sid, timeout=timeout)
            if f is None:
                f = self._last.get(sid)
            if f is None:
                return None
            frames.append(f)
        return np.stack(frames)

    def stop(self):
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
