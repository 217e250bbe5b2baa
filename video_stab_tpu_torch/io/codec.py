"""Host codec layer: native H.264/H.265 encode + decode (ctypes over
``native/codec.cpp`` -> system libavcodec/libx264); port of
``video_stab_tpu/io/codec.py`` on the port's native loader (``native``:
built into ``build/torch_native/`` at first use, under a lock).

This is the host counterpart of the reference's encoder stack:
- examples/JetsonEncoder.cpp:22-116 (V4L2 HW encoder with CBR rate control)
  -> :class:`VideoEncoder` with a *honored* ``bitrate_bps`` (VBV/CBR).
- src/RTSPServer.cpp:79-92 (x264enc zerolatency launch string)
  -> ``zerolatency=True`` default.
- src/GstdManager.cpp:155-180 (compressed-domain relay, no decode)
  -> :class:`VideoDecoder` + :func:`split_nal_units` let callers stay in the
  packet domain and only decode when the processing path needs pixels.

All entry points degrade gracefully: :func:`available` is False when the
native library (or ffmpeg dev stack) is absent, and callers fall back to the
cv2 writer path.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from video_stab_tpu_torch import native


def _bind(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.vs_enc_open.restype = c.c_void_p
    lib.vs_enc_open.argtypes = [c.c_int, c.c_int, c.c_double, c.c_int64,
                                c.c_char_p, c.c_int, c.c_int]
    lib.vs_enc_encode.restype = c.c_int
    lib.vs_enc_encode.argtypes = [c.c_void_p, c.c_char_p, c.c_int,
                                  c.c_char_p, c.c_int, c.POINTER(c.c_int)]
    lib.vs_enc_encode_yuv.restype = c.c_int
    lib.vs_enc_encode_yuv.argtypes = [c.c_void_p, c.c_char_p, c.c_int,
                                      c.c_char_p, c.c_int,
                                      c.POINTER(c.c_int)]
    lib.vs_enc_flush.restype = c.c_int
    lib.vs_enc_flush.argtypes = [c.c_void_p, c.c_char_p, c.c_int,
                                 c.POINTER(c.c_int)]
    lib.vs_enc_bytes_out.restype = c.c_int64
    lib.vs_enc_bytes_out.argtypes = [c.c_void_p]
    lib.vs_enc_close.argtypes = [c.c_void_p]
    lib.vs_dec_open.restype = c.c_void_p
    lib.vs_dec_open.argtypes = [c.c_char_p]
    lib.vs_dec_decode.restype = c.c_int
    lib.vs_dec_decode.argtypes = [c.c_void_p, c.c_char_p, c.c_int,
                                  c.c_int, c.c_char_p, c.c_int64,
                                  c.POINTER(c.c_int), c.POINTER(c.c_int)]
    lib.vs_dec_close.argtypes = [c.c_void_p]
    lib.vs_annexb_scan.restype = c.c_int
    lib.vs_annexb_scan.argtypes = [c.c_char_p, c.c_int64,
                                   c.POINTER(c.c_int64), c.c_int]
    lib.vs_mux_open.restype = c.c_void_p
    lib.vs_mux_open.argtypes = [c.c_char_p, c.c_int, c.c_int, c.c_double,
                                c.c_int64, c.c_char_p, c.c_int, c.c_int]
    lib.vs_mux_write.restype = c.c_int
    lib.vs_mux_write.argtypes = [c.c_void_p, c.c_char_p]
    lib.vs_mux_write_yuv.restype = c.c_int
    lib.vs_mux_write_yuv.argtypes = [c.c_void_p, c.c_char_p]
    lib.vs_mux_bytes_out.restype = c.c_int64
    lib.vs_mux_bytes_out.argtypes = [c.c_void_p]
    lib.vs_mux_close.restype = c.c_int
    lib.vs_mux_close.argtypes = [c.c_void_p]
    lib.vs_muxp_open.restype = c.c_void_p
    lib.vs_muxp_open.argtypes = [c.c_char_p, c.c_int, c.c_int,
                                 c.c_double, c.c_char_p, c.c_char_p,
                                 c.c_int]
    lib.vs_muxp_write.restype = c.c_int
    lib.vs_muxp_write.argtypes = [c.c_void_p, c.c_char_p, c.c_int,
                                  c.c_int]
    lib.vs_muxp_write_ts.restype = c.c_int
    lib.vs_muxp_write_ts.argtypes = [c.c_void_p, c.c_char_p, c.c_int,
                                     c.c_int, c.c_double, c.c_double]
    lib.vs_muxp_close.restype = c.c_int
    lib.vs_muxp_close.argtypes = [c.c_void_p]
    lib.vs_demux_open.restype = c.c_void_p
    lib.vs_demux_open.argtypes = [c.c_char_p, c.c_char_p, c.c_int]
    lib.vs_demux_read.restype = c.c_int
    lib.vs_demux_read.argtypes = [c.c_void_p, c.c_char_p, c.c_int]
    lib.vs_demux_read2.restype = c.c_int
    lib.vs_demux_read2.argtypes = [
        c.c_void_p, c.c_char_p, c.c_int, c.POINTER(c.c_double),
        c.POINTER(c.c_double), c.POINTER(c.c_int)]
    lib.vs_demux_close.argtypes = [c.c_void_p]


def _load() -> Optional[ctypes.CDLL]:
    """The codec library (``native/codec.cpp``), built at first use."""
    return native.load("vstab_codec", _bind)


def _require() -> ctypes.CDLL:
    """The codec library; raises with its build's message when missing."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native codec library unavailable: "
                           f"{native.build_error('vstab_codec')}")
    return lib


def available(codec: str = "libx264") -> bool:
    """True when the native codec layer loads and `codec` opens."""
    lib = _load()
    if lib is None:
        return False
    h = lib.vs_enc_open(64, 64, 30.0, 0, codec.encode(), 1, 0)
    if not h:
        return False
    lib.vs_enc_close(h)
    return True


class VideoEncoder:
    """Streaming encoder: BGR frames in, Annex-B bytes out.

    ``bitrate_bps > 0`` enables VBV-constrained CBR — the measured output
    bitrate tracks the request (the contract JetsonEncoder.cpp:76-84 gets
    from V4L2_MPEG_VIDEO_BITRATE_MODE_CBR). ``zerolatency`` disables
    B-frames/lookahead so every frame in yields bytes out immediately
    (RTSPServer.cpp:85 x264enc tune=zerolatency).
    """

    def __init__(self, width: int, height: int, fps: float = 30.0,
                 bitrate_bps: int = 0, codec: str = "libx264",
                 zerolatency: bool = True, gop: int = 0):
        lib = _require()
        self._lib = lib
        self._h = lib.vs_enc_open(width, height, float(fps),
                                  int(bitrate_bps), codec.encode(),
                                  int(zerolatency), int(gop))
        if not self._h:
            raise RuntimeError(f"cannot open encoder {codec!r}")
        self.width, self.height = width, height
        self.fps = fps
        self.bitrate_bps = bitrate_bps
        self.frames_in = 0
        self.last_was_key = False
        # Worst case bound: raw frame + headers (keyframes under heavy
        # motion stay far below raw size).
        self._cap = width * height * 3 + (1 << 16)
        self._buf = ctypes.create_string_buffer(self._cap)

    def encode(self, frame_bgr: np.ndarray,
               force_key: bool = False) -> bytes:
        """Encode one HxWx3 uint8 BGR frame; returns 0+ Annex-B NAL bytes.

        ``force_key`` makes this frame an IDR (instant join for a new
        streaming client). Sets ``self.last_was_key``.
        """
        frame_bgr = np.ascontiguousarray(frame_bgr, dtype=np.uint8)
        assert frame_bgr.shape == (self.height, self.width, 3), frame_bgr.shape
        key = ctypes.c_int(0)
        n = self._lib.vs_enc_encode(
            self._h, frame_bgr.ctypes.data_as(ctypes.c_char_p),
            int(force_key), self._buf, self._cap, ctypes.byref(key))
        if n < 0:
            raise RuntimeError(f"encode failed ({n})")
        self.frames_in += 1
        self.last_was_key = bool(key.value)
        # string_at copies exactly n bytes; .raw[:n] would materialize the
        # ENTIRE raw-frame-sized buffer per call on this hot path.
        return ctypes.string_at(self._buf, n)

    def encode_yuv(self, frame_i420: np.ndarray,
                   force_key: bool = False) -> bytes:
        """Encode one planar I420 frame: (H*3/2, W) u8 (ops.color.bgr_to_i420
        layout) or any contiguous H*W*3/2-byte buffer. Skips the BGR->YUV
        swscale pass entirely — the half-size payload the device emits in
        i420 output mode goes straight into libx264."""
        frame_i420 = np.ascontiguousarray(frame_i420, dtype=np.uint8)
        expect = self.height * self.width * 3 // 2
        assert frame_i420.size == expect, (frame_i420.shape, expect)
        key = ctypes.c_int(0)
        n = self._lib.vs_enc_encode_yuv(
            self._h, frame_i420.ctypes.data_as(ctypes.c_char_p),
            int(force_key), self._buf, self._cap, ctypes.byref(key))
        if n < 0:
            raise RuntimeError(f"encode failed ({n})")
        self.frames_in += 1
        self.last_was_key = bool(key.value)
        return ctypes.string_at(self._buf, n)   # n bytes, not the whole cap

    def flush(self) -> bytes:
        """Drain buffered packets at end of stream."""
        out = b""
        while True:
            key = ctypes.c_int(0)
            n = self._lib.vs_enc_flush(self._h, self._buf, self._cap,
                                       ctypes.byref(key))
            if n < 0:
                raise RuntimeError(f"flush failed ({n})")
            if n == 0:
                return out
            out += ctypes.string_at(self._buf, n)

    @property
    def bytes_out(self) -> int:
        return int(self._lib.vs_enc_bytes_out(self._h))

    def measured_bitrate_bps(self) -> float:
        """Average output bitrate so far (bits/sec at the nominal fps)."""
        if self.frames_in == 0:
            return 0.0
        return self.bytes_out * 8.0 * self.fps / self.frames_in

    def close(self) -> None:
        if self._h:
            self._lib.vs_enc_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class VideoDecoder:
    """Streaming Annex-B decoder: bytes in, BGR frames out.

    Feed arbitrary byte chunks (packet boundaries not required — an in-C
    av_parser splits them); collect frames as they decode. ``flush()`` at
    EOF returns the tail.
    """

    _MAX_W, _MAX_H = 4096, 2304

    def __init__(self, codec: str = "h264"):
        lib = _require()
        self._lib = lib
        self._h = lib.vs_dec_open(codec.encode())
        if not self._h:
            raise RuntimeError(f"cannot open decoder {codec!r}")
        self._cap = self._MAX_W * self._MAX_H * 3
        self._buf = ctypes.create_string_buffer(self._cap)

    def _pull(self, data: bytes, eof: bool) -> List[np.ndarray]:
        frames = []
        chunk = data
        while True:
            w = ctypes.c_int(0)
            h = ctypes.c_int(0)
            r = self._lib.vs_dec_decode(
                self._h, chunk, len(chunk), int(eof), self._buf, self._cap,
                ctypes.byref(w), ctypes.byref(h))
            if r < 0:
                raise RuntimeError(f"decode failed ({r})")
            if r == 0:
                return frames
            # Zero-copy view of the first w*h*3 bytes; only the final
            # .copy() moves frame-sized data (.raw would copy the whole
            # 4096x2304x3 capacity — ~28 MB — per decoded frame).
            arr = np.frombuffer(self._buf, dtype=np.uint8,
                                count=w.value * h.value * 3)
            frames.append(arr.reshape(h.value, w.value, 3).copy())
            chunk = b""  # input consumed; drain the internal queue

    def decode(self, data: bytes) -> List[np.ndarray]:
        return self._pull(data, eof=False)

    def flush(self) -> List[np.ndarray]:
        return self._pull(b"", eof=True)

    def close(self) -> None:
        if self._h:
            self._lib.vs_dec_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class ContainerWriter:
    """H.264-in-MP4/MKV writer: native encode (honored CBR bitrate) + in-C
    libavformat muxing. The proper-container half of the JetsonEncoder
    role; containers get extradata-style headers (global_header) while the
    streaming encoder keeps in-band SPS/PPS."""

    def __init__(self, path: str, width: int, height: int, fps: float = 30.0,
                 bitrate_bps: int = 0, codec: str = "libx264",
                 zerolatency: bool = False, gop: int = 0):
        lib = _require()
        self._lib = lib
        self._h = lib.vs_mux_open(path.encode(), width, height, float(fps),
                                  int(bitrate_bps), codec.encode(),
                                  int(zerolatency), int(gop))
        if not self._h:
            raise RuntimeError(f"cannot open container writer for {path!r}")
        self.path = path
        self.width, self.height, self.fps = width, height, fps
        self.frames_written = 0

    def write(self, frame_bgr: np.ndarray) -> None:
        frame_bgr = np.ascontiguousarray(frame_bgr, dtype=np.uint8)
        assert frame_bgr.shape == (self.height, self.width, 3)
        rc = self._lib.vs_mux_write(
            self._h, frame_bgr.ctypes.data_as(ctypes.c_char_p))
        if rc != 0:
            raise RuntimeError(f"mux write failed ({rc})")
        self.frames_written += 1

    def write_yuv(self, frame_i420: np.ndarray) -> None:
        """Encode + mux one planar I420 frame (see VideoEncoder.encode_yuv)."""
        frame_i420 = np.ascontiguousarray(frame_i420, dtype=np.uint8)
        assert frame_i420.size == self.height * self.width * 3 // 2
        rc = self._lib.vs_mux_write_yuv(
            self._h, frame_i420.ctypes.data_as(ctypes.c_char_p))
        if rc != 0:
            raise RuntimeError(f"mux write failed ({rc})")
        self.frames_written += 1

    @property
    def bytes_out(self) -> int:
        return int(self._lib.vs_mux_bytes_out(self._h))

    def close(self) -> None:
        if self._h:
            rc = self._lib.vs_mux_close(self._h)
            self._h = None
            if rc != 0:
                raise RuntimeError(f"mux close failed ({rc})")

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def split_nal_units(data: bytes, max_nals: int = 4096) -> List[bytes]:
    """Split an Annex-B byte stream into NAL units (start codes included).

    The packet-domain primitive for compressed passthrough
    (GstdManager.cpp:155-180 relays H.264 NALs without decoding).
    """
    lib = _load()
    if lib is None:  # pure-Python fallback
        offs, i = [], 0
        while True:
            j = data.find(b"\x00\x00\x01", i)
            if j < 0:
                break
            start = j - 1 if j > 0 and data[j - 1] == 0 else j
            offs.append(start)
            i = j + 3
        return [data[a:b] for a, b in zip(offs, offs[1:] + [len(data)])]
    arr = (ctypes.c_int64 * max_nals)()
    n = lib.vs_annexb_scan(data, len(data), arr, max_nals)
    offs = [arr[i] for i in range(n)]
    return [data[a:b] for a, b in zip(offs, offs[1:] + [len(data)])]


def nal_type(nal: bytes) -> Optional[int]:
    """H.264 nal_unit_type of an Annex-B NAL (5=IDR, 7=SPS, 8=PPS...)."""
    i = 3 if nal[:3] == b"\x00\x00\x01" else (
        4 if nal[:4] == b"\x00\x00\x00\x01" else None)
    if i is None or len(nal) <= i:
        return None
    return nal[i] & 0x1F


def strip_start_code(nal: bytes) -> bytes:
    """Annex-B NAL payload (3- or 4-byte start code removed, if any)."""
    if nal[:4] == b"\x00\x00\x00\x01":
        return nal[4:]
    if nal[:3] == b"\x00\x00\x01":
        return nal[3:]
    return nal


def hevc_nal_type(nal: bytes) -> int:
    """HEVC nal_unit_type ((first header byte >> 1) & 0x3F), -1 if empty."""
    raw = strip_start_code(nal)
    return (raw[0] >> 1) & 0x3F if raw else -1


def is_irap(nal: bytes, codec: str = "h264") -> bool:
    """Random-access point: H.264 IDR (type 5) or HEVC IRAP (BLA/IDR/CRA,
    types 16..21). The single classifier behind every drop-to-next-IDR
    resync and mid-stream processing switch (kept in one place so a
    refinement — e.g. excluding CRA as a resume point — can't silently
    miss a copy)."""
    if codec in ("hevc", "h265"):
        return 16 <= hevc_nal_type(nal) <= 21
    return nal_type(nal) == 5


def is_param_set(nal: bytes, codec: str = "h264") -> bool:
    """Parameter set: H.264 SPS/PPS (7, 8) or HEVC VPS/SPS/PPS (32..34)."""
    if codec in ("hevc", "h265"):
        return hevc_nal_type(nal) in (32, 33, 34)
    return nal_type(nal) in (7, 8)


class ContainerDemuxer:
    """MP4/MKV/MOV/M4V -> Annex-B H.264/HEVC packets, NO decode — the
    qtdemux->h264parse stage of the reference's compressed ingest
    (GstdManager.cpp:155-180 reads RTSP, its configs also name .m4v
    container sources). One read() = one video packet (Annex-B bytes, one
    access unit's worth in decode order), None at EOF."""

    def __init__(self, path: str, max_packet: int = 1 << 22):
        lib = _require()
        self._lib = lib
        name_buf = ctypes.create_string_buffer(32)
        self._h = lib.vs_demux_open(path.encode(), name_buf, 32)
        if not self._h:
            raise RuntimeError(f"cannot demux {path!r}")
        self.codec_name = name_buf.value.decode()
        self._buf = ctypes.create_string_buffer(max_packet)
        self.packets_read = 0

    def read(self) -> Optional[bytes]:
        pkt = self.read_packet()
        return pkt[0] if pkt else None

    def read_packet(self) -> Optional[tuple]:
        """Next packet as (annexb_bytes, pts_seconds|None, dts_seconds|None,
        container_keyframe_flag); None at EOF. An oversize packet grows
        the buffer and retries (the native side retains it) rather than
        silently truncating the stream."""
        if self._h is None:
            return None
        import ctypes as c
        pts = c.c_double(-1e18)
        dts = c.c_double(-1e18)
        key = c.c_int(0)
        while True:
            # sizeof() reads the capacity without materializing the buffer
            # (len(.raw) would copy it wholesale on every packet).
            cap = ctypes.sizeof(self._buf)
            n = self._lib.vs_demux_read2(
                self._h, self._buf, cap,
                c.byref(pts), c.byref(dts), c.byref(key))
            if n != -2:
                break
            if cap >= (1 << 28):
                raise RuntimeError(
                    "demuxed packet exceeds 256 MB buffer cap")
            self._buf = ctypes.create_string_buffer(cap * 2)
        if n <= 0:
            return None
        self.packets_read += 1
        return (ctypes.string_at(self._buf, n),
                pts.value if pts.value > -1e17 else None,
                dts.value if dts.value > -1e17 else None,
                bool(key.value))

    def close(self) -> None:
        if self._h is not None:
            self._lib.vs_demux_close(self._h)
            self._h = None
