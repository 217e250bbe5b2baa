"""Compressed-domain (packet-level) streaming: H.264 passthrough without
decode.

The reference's passthrough mode never touches pixels — GstdManager relays
H.264 via interpipe (GstdManager.cpp:155-180: rtspsrc->depay->parse->
interpipesink, and the output pipeline rtspclientsink), which is why
passthrough adds only 10-20 ms (README_GSTD_INTERPIPE.md:157) while
processing mode pays decode + re-encode (~50-100 ms, :158).

This module is that packet domain (port of ``video_stab_tpu/io/packets.py``):

- :class:`PacketSource` — reads an Annex-B H.264 elementary stream (file or
  socket) and yields access units (lists of NAL units, bytes), no decode.
- :class:`PacketFileSink` — byte-identical packet writer (the relay sink).
- :class:`PacketDecoderBridge` — packet channel -> native decoder -> BGR
  frames; the GstdManager *processing* pipeline's decoder stage
  (GstdManager.cpp:182-211), attached only while processing mode is active.

Packets ride the same named-channel StreamGraph as frames (io/channels.py),
so the listen-to switch (GstdManager.cpp:324-327) works identically: the
output pipeline re-points between the compressed "source_pkt" channel
(passthrough) and the re-encoded "processed" channel.
"""

from __future__ import annotations

import queue
import socket
import threading
import time
from typing import Callable, Iterator, List, Optional

import numpy as np

from video_stab_tpu_torch.io.codec import (VideoDecoder, hevc_nal_type,
                                           is_param_set, nal_type,
                                           split_nal_units)
from video_stab_tpu_torch.io.codec import is_irap as codec_is_irap
from video_stab_tpu_torch.utils.telemetry import get_logger

VCL_TYPES = {1, 2, 3, 4, 5}       # H.264 coded-slice NAL unit types


def _hdr_offset(nal: bytes) -> int:
    return 3 if nal[:3] == b"\x00\x00\x01" else 4


def _is_vcl(nal: bytes, codec: str = "h264") -> bool:
    if codec in ("hevc", "h265"):
        i = _hdr_offset(nal)
        return i < len(nal) and ((nal[i] >> 1) & 0x3F) <= 31
    return nal_type(nal) in VCL_TYPES


def _starts_new_picture(nal: bytes, codec: str = "h264") -> bool:
    """True when a VCL NAL begins a new coded picture.

    H.264: the slice header's first field, first_mb_in_slice (ue(v)), is 0
    — encoded as a leading '1' bit (multi-slice pictures have first_mb > 0
    for follow-on slices). HEVC: first_slice_segment_in_pic_flag is the
    first BIT after the 2-byte NAL header."""
    i = _hdr_offset(nal)
    off = i + 2 if codec in ("hevc", "h265") else i + 1
    if len(nal) <= off:
        return True
    return (nal[off] & 0x80) != 0


def group_access_units(nals: List[bytes],
                       codec: str = "h264") -> Iterator[List[bytes]]:
    """Group a NAL sequence into access units (one coded picture each):
    non-VCL NALs (VPS/SPS/PPS/SEI/AUD) attach to the NEXT picture; a VCL
    NAL whose first-slice flag is set starts a new picture; additional
    slices of the same picture (sliced-threads encoders) stay in the same
    unit. codec: "h264" | "h265"."""
    pending: List[bytes] = []
    has_vcl = False
    for nal in nals:
        if _is_vcl(nal, codec) and has_vcl \
                and _starts_new_picture(nal, codec):
            yield pending
            pending = []
            has_vcl = False
        pending.append(nal)
        if _is_vcl(nal, codec):
            has_vcl = True
    if pending:
        yield pending


class AccessUnit(list):
    """One access unit — a list of Annex-B NAL byte strings — optionally
    carrying the container's presentation/decode timestamps in seconds.
    ContainerPacketSource sets them; ContainerPacketSink preserves them so
    B-frame streams remux with correct presentation order. Everything in
    between (channels, relays, file sinks) treats it as a plain
    list[bytes] and is unaffected."""

    def __init__(self, nals=(), pts: Optional[float] = None,
                 dts: Optional[float] = None):
        super().__init__(nals)
        self.pts = pts
        self.dts = dts


class PacketSource:
    """Access-unit reader over an Annex-B H.264 byte stream.

    File variant of the reference's compressed ingest (rtspsrc->depay->
    h264parse, GstdManager.cpp:155-180): no decoder is ever constructed.
    ``read()`` returns one access unit (list of NAL bytes) or None at EOF.
    """

    def __init__(self, path: str, chunk_size: int = 1 << 16,
                 realtime_fps: float = 0.0, codec: str = "h264"):
        self.path = path
        self.chunk_size = chunk_size
        self.codec = codec                  # "h264" | "h265" (AU grouping)
        self.realtime_fps = realtime_fps    # 0 -> as fast as possible
        self._file = None
        self._buf = b""
        self._pending: List[bytes] = []     # open (unclosed) access unit
        self._pending_vcl = False
        self._aus: List[List[bytes]] = []
        self._eof = False
        self.units_read = 0

    def start(self) -> "PacketSource":
        if self._file is None:      # idempotent: the runner's packet graph
            self._file = open(self.path, "rb")  # builder starts it early
        return self

    @property
    def codec_name(self) -> str:
        return "hevc" if self.codec in ("hevc", "h265") else "h264"

    def _push_nal(self, nal: bytes) -> None:
        """Incremental AU grouping across arbitrary chunk boundaries."""
        is_vcl = _is_vcl(nal, self.codec)
        if is_vcl and self._pending_vcl \
                and _starts_new_picture(nal, self.codec):
            self._aus.append(self._pending)
            self._pending = []
            self._pending_vcl = False
        self._pending.append(nal)
        self._pending_vcl = self._pending_vcl or is_vcl

    def _fill(self) -> None:
        while not self._aus and not self._eof:
            chunk = self._file.read(self.chunk_size)
            if not chunk:
                self._eof = True
                if self._buf:
                    for nal in split_nal_units(self._buf):
                        self._push_nal(nal)
                    self._buf = b""
                if self._pending:
                    self._aus.append(self._pending)
                    self._pending = []
                return
            self._buf += chunk
            nals = split_nal_units(self._buf)
            if len(nals) > 1:
                # Keep the (possibly incomplete) last NAL buffered.
                for nal in nals[:-1]:
                    self._push_nal(nal)
                self._buf = nals[-1]

    def read(self) -> Optional[List[bytes]]:
        if self._file is None:
            self.start()
        self._fill()
        if not self._aus:
            return None
        if self.realtime_fps > 0:
            time.sleep(1.0 / self.realtime_fps)
        self.units_read += 1
        return self._aus.pop(0)

    @property
    def eof(self) -> bool:
        """True once read() has returned None for end-of-stream (files
        never stall, so None always means EOF here; the property exists
        for surface parity with the live RTSP source)."""
        return self._eof and not self._aus

    def stop(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


class ContainerPacketSource:
    """Access units from a CONTAINER file (mp4/mkv/mov/m4v) without decode:
    native libavformat demux + mp4toannexb (io/codec.ContainerDemuxer) —
    the reference's own configs name .m4v sources ("config (another
    copy).yaml":2), which its qtdemux GStreamer stage relays compressed.
    Same read()/stop() surface as :class:`PacketSource`."""

    def __init__(self, path: str, realtime_fps: float = 0.0):
        self.path = path
        self.realtime_fps = realtime_fps
        self._demux = None
        self._pending: List[AccessUnit] = []
        self._pending_open: List[bytes] = []
        self._pending_vcl = False
        self._open_ts: tuple = (None, None)
        self._eof = False
        self.units_read = 0

    def start(self) -> "ContainerPacketSource":
        from video_stab_tpu_torch.io.codec import ContainerDemuxer
        if self._demux is None:     # idempotent: the runner's packet graph
            self._demux = ContainerDemuxer(self.path)  # builder starts it
        return self

    @property
    def codec_name(self) -> str:
        return self._demux.codec_name if self._demux else ""

    def read(self) -> Optional[List[bytes]]:
        if self._demux is None:
            self.start()
        while not self._pending and not self._eof:
            pkt = self._demux.read_packet()
            if pkt is None:
                self._eof = True
                if self._pending_open:
                    self._pending.append(AccessUnit(self._pending_open,
                                                    *self._open_ts))
                    self._pending_open = []
                break
            data, pts, dts, _key = pkt
            # One demuxed packet is one coded picture; group via the same
            # slice-header logic for robustness (multi-slice packets stay
            # one unit; parameter sets from the BSF attach forward). Each
            # unit carries the timestamps of the packet that STARTED it —
            # preserved through remux so B-frame streams keep their
            # presentation order.
            codec = "h265" if self.codec_name == "hevc" else "h264"
            for nal in split_nal_units(data):
                is_vcl = _is_vcl(nal, codec)
                if is_vcl and self._pending_vcl \
                        and _starts_new_picture(nal, codec):
                    self._pending.append(AccessUnit(self._pending_open,
                                                    *self._open_ts))
                    self._pending_open = []
                    self._pending_vcl = False
                if not self._pending_open:
                    self._open_ts = (pts, dts)
                self._pending_open.append(nal)
                self._pending_vcl = self._pending_vcl or is_vcl
        if not self._pending:
            return None
        if self.realtime_fps > 0:
            time.sleep(1.0 / self.realtime_fps)
        self.units_read += 1
        return self._pending.pop(0)

    @property
    def eof(self) -> bool:
        """Surface parity with PacketSource/RtspPacketSource.eof."""
        return self._eof and not self._pending

    def stop(self) -> None:
        if self._demux is not None:
            self._demux.close()
            self._demux = None


def _bind_udp_pair(max_tries: int = 64):
    """Bind an (RTP, RTCP) UDP socket pair on consecutive even/odd ports
    (RFC 3550 §11). Returns (rtp_sock, rtcp_sock, rtp_port)."""
    for _ in range(max_tries):
        rtp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            rtp.bind(("0.0.0.0", 0))
            port = rtp.getsockname()[1]
            if port % 2:                # need the even port of a pair
                rtp.close()
                continue
            rtcp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                rtcp.bind(("0.0.0.0", port + 1))
            except OSError:
                rtp.close()
                rtcp.close()
                continue
            return rtp, rtcp, port
        except OSError:
            rtp.close()
    raise OSError("could not bind an RTP/RTCP UDP port pair")


class RtspPacketSource:
    """Live RTSP/RTP *client* at the packet level — the rtspsrc->
    rtph264depay->h264parse head of the reference's compressed ingest
    (GstdManager.cpp:155-180): DESCRIBE/SETUP/PLAY over RTSP/1.0 with
    TCP-interleaved transport, RFC 6184 depacketization (single-NAL, FU-A,
    STAP-A), access units grouped on the RTP marker bit. No decoder is ever
    constructed, so a live camera can take the byte-identical passthrough
    path.

    Same ``read() -> access unit | None`` surface as :class:`PacketSource`.
    """

    def __init__(self, url: str, queue_size: int = 256,
                 timeout: float = 10.0, logging: bool = False,
                 transport: str = "tcp"):
        self.url = url
        self.timeout = timeout
        self.transport = transport      # "tcp" (interleaved) | "udp"
        self.log = get_logger("RtspPacketSource", logging)
        self._sock = None
        self._file = None
        self._udp_sock = None           # RTP receive socket (udp mode)
        self._udp_rtcp_sock = None
        self._cseq = 0
        self._session: Optional[str] = None
        self._sprop_nals: List[bytes] = []      # SPS/PPS from the SDP
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._wlock = threading.Lock()
        self.codec_name = "h264"        # from the SDP rtpmap (h264 | hevc)
        self.units_read = 0
        self.units_dropped = 0          # overflow drops (see emit_au)
        self.eof = False                # set when read() consumes the
                                        # receive loop's EOF sentinel
        self._drop_resync = False       # held until the next IDR after one

    # -- RTSP control ------------------------------------------------------
    def _request(self, method: str, url: str, extra: dict = {}) -> dict:
        self._cseq += 1
        lines = [f"{method} {url} RTSP/1.0", f"CSeq: {self._cseq}",
                 "User-Agent: vstab"]
        if self._session:
            lines.append(f"Session: {self._session}")
        lines += [f"{k}: {v}" for k, v in extra.items()]
        with self._wlock:
            self._sock.sendall(("\r\n".join(lines) + "\r\n\r\n").encode())
        # Replies arrive in order on the control channel before PLAY.
        status = self._file.readline().decode("latin1", "replace")
        if "200" not in status:
            raise ConnectionError(f"RTSP {method}: {status.strip()}")
        headers = {}
        while True:
            line = self._file.readline()
            if not line or line in (b"\r\n", b"\n"):
                break
            k, _, v = line.decode("latin1").partition(":")
            headers[k.strip().lower()] = v.strip()
        body = b""
        n = int(headers.get("content-length", 0))
        if n:
            body = self._file.read(n)
        headers["_body"] = body
        return headers

    def _connect(self) -> None:
        import socket as socket_mod
        from urllib.parse import urlparse

        u = urlparse(self.url)
        host, port = u.hostname or "127.0.0.1", u.port or 554
        self._sock = socket_mod.create_connection((host, port),
                                                  timeout=self.timeout)
        self._file = self._sock.makefile("rb")
        self._request("OPTIONS", self.url)
        desc = self._request("DESCRIBE", self.url,
                             {"Accept": "application/sdp"})
        sdp = desc["_body"].decode("latin1", "replace")
        control = "track0"
        # SDP is SECTIONED: session-level lines, then one m=... block per
        # media stream. Track which section we are in and take a=control
        # (and codec attributes) from the VIDEO section only — a
        # multi-track camera's audio control would otherwise win, and a
        # video control URL merely CONTAINING the word "video" must not
        # be skipped.
        section = "session"
        for line in sdp.splitlines():
            line = line.strip()
            if line.startswith("m="):
                section = "video" if line.startswith("m=video") else "other"
                continue
            if section == "other":
                continue
            if line.startswith("a=rtpmap:") and "H265" in line.upper():
                self.codec_name = "hevc"
            if line.startswith("a=control:") and section == "video":
                c = line[len("a=control:"):]
                if c != "*":
                    control = c
            for key in ("sprop-parameter-sets=", "sprop-vps=",
                        "sprop-sps=", "sprop-pps="):
                if key in line:
                    import base64
                    props = line.split(key)[1].split(";")[0].split()[0]
                    for b64 in props.split(","):
                        try:
                            self._sprop_nals.append(
                                b"\x00\x00\x00\x01"
                                + base64.b64decode(b64))
                        except Exception:
                            pass
        setup_url = control if control.startswith("rtsp://") \
            else self.url.rstrip("/") + "/" + control
        if self.transport == "udp":
            # Bind an RTP/RTCP port pair (even/odd, RFC 3550 convention);
            # control stays on the TCP connection.
            rtp, rtcp, port = _bind_udp_pair()
            self._udp_sock, self._udp_rtcp_sock = rtp, rtcp
            resp = self._request(
                "SETUP", setup_url,
                {"Transport": f"RTP/AVP;unicast;"
                              f"client_port={port}-{port + 1}"})
            # Hole-punch toward server_port so stateful firewalls/NAT open
            # the return path (what rtspsrc/ffmpeg do).
            tr = resp.get("transport", "")
            if "server_port=" in tr:
                try:
                    sp = int(tr.split("server_port=")[1]
                             .split(";")[0].split("-")[0])
                    shost = u.hostname or "127.0.0.1"
                    rtp.sendto(b"\x00", (shost, sp))
                except (ValueError, OSError):
                    pass
        else:
            resp = self._request(
                "SETUP", setup_url,
                {"Transport": "RTP/AVP/TCP;unicast;interleaved=0-1"})
        self._session = resp.get("session", "").split(";")[0]
        self._request("PLAY", self.url, {"Range": "npt=0.000-"})

    # -- RTP depacketization (RFC 6184 / 7798) ------------------------------
    def _make_depacketizer(self):
        """Shared RTP-packet -> access-unit state machine for both
        transports. Returns (on_packet, finish): on_packet takes one full
        RTP packet (header included) and may enqueue completed access
        units; finish flushes and posts the EOF sentinel. UDP loss
        (sequence gap) drops the partial unit and holds emission until the
        next IDR — the packet graph's resume-at-IDR contract."""
        au: List[bytes] = []
        fu_buf: Optional[bytearray] = None
        sprop_pending = list(self._sprop_nals)
        expect_seq: Optional[int] = None

        def is_irap(n):
            return codec_is_irap(n, self.codec_name)

        def emit_au():
            nonlocal au, sprop_pending
            if not au:
                return

            def is_ps(n):
                return is_param_set(n, self.codec_name)

            # After an overflow drop the decode chain is broken mid-GOP:
            # hold further units until the next IDR/IRAP so the consumer
            # resumes on a clean random-access point (the packet graph's
            # own resync contract) instead of feeding undecodable slices.
            if self._drop_resync:
                if not any(is_irap(n) for n in au):
                    au = []
                    return
                self._drop_resync = False
            if sprop_pending and not any(is_ps(n) for n in au):
                au = sprop_pending + au     # out-of-band VPS/SPS/PPS, once
            sprop_pending = []
            try:
                self._queue.put(au, timeout=1.0)
            except queue.Full:
                self.units_dropped += 1
                self._drop_resync = True
                self.log.warning(
                    "packet queue full; dropped access unit #%d — holding "
                    "until the next IDR (consumer too slow / stalled)",
                    self.units_dropped)
            au = []

        def on_packet(payload: bytes) -> None:
            nonlocal au, fu_buf, expect_seq
            if len(payload) < 13:
                return
            v_p_x_cc = payload[0]
            if (v_p_x_cc >> 6) != 2:            # not RTP v2 (e.g. RTCP)
                return
            marker = bool(payload[1] & 0x80)
            seq = int.from_bytes(payload[2:4], "big")
            if expect_seq is not None and seq != expect_seq:
                if (seq - expect_seq) & 0xFFFF > 0x8000:
                    # Late/duplicate packet (behind expect_seq mod 2^16):
                    # its absence was already handled as a gap when its
                    # successor arrived. Ignore it WITHOUT rewinding
                    # expect_seq — resetting expectations backwards would
                    # declare a fresh false gap (and an IDR-resync) for
                    # every subsequent in-flight packet, turning one
                    # reordered pair into several lost GOPs.
                    return
                # Genuine forward gap (UDP loss): the unit under assembly
                # is broken — drop it and hold until the next IDR.
                au = []
                fu_buf = None
                self.units_dropped += 1
                self._drop_resync = True
            expect_seq = (seq + 1) & 0xFFFF
            cc = v_p_x_cc & 0x0F
            off = 12 + 4 * cc
            if v_p_x_cc & 0x10:     # extension header
                if len(payload) < off + 4:
                    return
                ext_len = int.from_bytes(payload[off + 2:off + 4], "big")
                off += 4 + 4 * ext_len
            data = payload[off:]
            if not data:
                return
            if self.codec_name == "hevc":    # RFC 7798
                ntype = (data[0] >> 1) & 0x3F
                if ntype == 48:             # AP aggregation
                    p = 2
                    while p + 2 <= len(data):
                        sz = int.from_bytes(data[p:p + 2], "big")
                        p += 2
                        if sz == 0 or p + sz > len(data):
                            break
                        au.append(b"\x00\x00\x00\x01"
                                  + data[p:p + sz])
                        p += sz
                elif ntype == 49 and len(data) >= 3:    # FU
                    fu_header = data[2]
                    if fu_header & 0x80:    # start
                        h0 = (data[0] & 0x81) | ((fu_header & 0x3F) << 1)
                        fu_buf = bytearray(
                            b"\x00\x00\x00\x01"
                            + bytes([h0, data[1]]))
                    if fu_buf is not None:
                        fu_buf += data[3:]
                        if fu_header & 0x40:
                            au.append(bytes(fu_buf))
                            fu_buf = None
                elif ntype < 48:            # single NAL unit
                    au.append(b"\x00\x00\x00\x01" + data)
            else:                            # RFC 6184 H.264
                ntype = data[0] & 0x1F
                if 1 <= ntype <= 23:        # single NAL unit
                    au.append(b"\x00\x00\x00\x01" + data)
                elif ntype == 24:           # STAP-A aggregation
                    p = 1
                    while p + 2 <= len(data):
                        sz = int.from_bytes(data[p:p + 2], "big")
                        p += 2
                        if sz == 0 or p + sz > len(data):
                            break
                        au.append(b"\x00\x00\x00\x01"
                                  + data[p:p + sz])
                        p += sz
                elif ntype == 28 and len(data) >= 2:   # FU-A
                    fu_header = data[1]
                    if fu_header & 0x80:    # start
                        nal_hdr = (data[0] & 0xE0) | (fu_header & 0x1F)
                        fu_buf = bytearray(
                            b"\x00\x00\x00\x01" + bytes([nal_hdr]))
                    if fu_buf is not None:
                        fu_buf += data[2:]
                        if fu_header & 0x40:    # end
                            au.append(bytes(fu_buf))
                            fu_buf = None
            if marker:
                emit_au()

        def finish() -> None:
            emit_au()
            self._queue.put(None)       # EOF sentinel

        return on_packet, finish

    def _rtp_loop(self) -> None:
        """TCP-interleaved receive loop (RFC 2326 §10.12)."""
        on_packet, finish = self._make_depacketizer()
        try:
            while not self._stop_evt.is_set():
                first = self._file.read(1)
                if not first:
                    break
                if first != b"$":
                    # Interleaved RTSP reply (keepalive response): consume
                    # the text head; any Content-Length body too.
                    line = first + self._file.readline()
                    headers = {}
                    while True:
                        ln = self._file.readline()
                        if not ln or ln in (b"\r\n", b"\n"):
                            break
                        k, _, v = ln.decode("latin1").partition(":")
                        headers[k.strip().lower()] = v.strip()
                    n = int(headers.get("content-length", 0) or 0)
                    if n:
                        self._file.read(n)
                    continue
                hdr = self._file.read(3)
                if len(hdr) < 3:
                    break
                channel, ln = hdr[0], int.from_bytes(hdr[1:3], "big")
                payload = self._file.read(ln)
                if len(payload) < ln or channel != 0:
                    continue            # RTCP (ch 1) or short read
                on_packet(payload)
        except OSError:
            pass
        finally:
            finish()

    def _udp_loop(self) -> None:
        """UDP unicast receive loop (the reference stack's default
        transport — rtspsrc/gst-rtsp-server, src/RTSPServer.cpp:79-92).
        Each datagram is one whole RTP packet; loss shows up as sequence
        gaps handled by the depacketizer (drop-to-next-IDR). Also drains
        the interleaved TCP control channel so keepalive replies don't
        stall the server."""
        on_packet, finish = self._make_depacketizer()

        def control_drain():
            try:
                while not self._stop_evt.is_set():
                    if not self._file.read(1):
                        break
            except OSError:
                pass

        threading.Thread(target=control_drain, daemon=True,
                         name="rtsp-control-drain").start()
        self._udp_sock.settimeout(0.5)
        try:
            while not self._stop_evt.is_set():
                try:
                    payload, _addr = self._udp_sock.recvfrom(65536)
                except socket.timeout:
                    continue
                on_packet(payload)
        except OSError:
            pass
        finally:
            finish()

    def _keepalive_loop(self) -> None:
        """Periodic GET_PARAMETER (RFC 2326 keepalive): real servers tear
        down sessions after ~60 s of control-channel silence. Replies
        arrive on the interleaved channel and are consumed by _rtp_loop."""
        while not self._stop_evt.wait(15.0):
            try:
                self._cseq += 1
                msg = (f"GET_PARAMETER {self.url} RTSP/1.0\r\n"
                       f"CSeq: {self._cseq}\r\n"
                       f"Session: {self._session}\r\n\r\n")
                with self._wlock:
                    self._sock.sendall(msg.encode())
            except OSError:
                return

    # -- PacketSource surface ----------------------------------------------
    def start(self) -> "RtspPacketSource":
        if self._thread is not None:    # idempotent: the runner's packet
            return self                 # graph builder starts the source
        self._connect()                 # early for the SDP codec
        # The handshake ran under the connect timeout; the receive loops
        # must NOT inherit it — a media stall longer than the timeout
        # between keepalive replies would raise mid-loop and read as EOF
        # (and a timeout mid-payload would desync the interleaved framing).
        # Block indefinitely and let the kernel's TCP keepalive detect a
        # dead peer (~60 s); stop() closes the socket to unblock.
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        for opt, val in (("TCP_KEEPIDLE", 30), ("TCP_KEEPINTVL", 10),
                         ("TCP_KEEPCNT", 3)):
            if hasattr(socket, opt):
                self._sock.setsockopt(socket.IPPROTO_TCP,
                                      getattr(socket, opt), val)
        loop = self._udp_loop if self.transport == "udp" else self._rtp_loop
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="rtsp-packet-source")
        self._thread.start()
        threading.Thread(target=self._keepalive_loop, daemon=True,
                         name="rtsp-keepalive").start()
        return self

    def read(self, timeout: float = 5.0) -> Optional[List[bytes]]:
        """One access unit, or None on EOF *or* a transient stall — check
        ``eof`` to distinguish (PacketRelay does; a live camera pausing
        longer than the queue timeout must not read as end-of-stream)."""
        if self._thread is None:
            self.start()
        try:
            au = self._queue.get(timeout=timeout)
        except queue.Empty:
            return None                 # transient: eof stays False
        if au is None:
            self.eof = True             # the receive loop's EOF sentinel
            return None
        self.units_read += 1
        return au

    def stop(self) -> None:
        self._stop_evt.set()
        try:
            if self._sock is not None:
                if self._session:
                    try:
                        self._cseq += 1
                        with self._wlock:
                            self._sock.sendall(
                                (f"TEARDOWN {self.url} RTSP/1.0\r\n"
                                 f"CSeq: {self._cseq}\r\n"
                                 f"Session: {self._session}\r\n\r\n"
                                 ).encode())
                    except OSError:
                        pass
                self._sock.close()
        except OSError:
            pass
        for s in (self._udp_sock, self._udp_rtcp_sock):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


class PacketEncoderBridge:
    """Frame -> packet bridge: re-encodes processed BGR frames into
    access units (the appsrc->x264enc->interpipesink 'processed-out'
    pipeline, examples/vsg.cpp:487-497). Lazy like the decoder bridge.

    ``codec`` must match what the downstream sink announces (SDP rtpmap /
    container codec id): an HEVC-announcing sink fed H.264 NALs hands
    every client an undecodable stream. Accepts 'h264'/'h265'/'hevc' or a
    libavcodec encoder name."""

    _CODEC_LIB = {"h264": "libx264", "h265": "libx265", "hevc": "libx265"}

    def __init__(self, fps: int = 30, bitrate_kbps: int = 0,
                 codec: str = "h264"):
        self.fps = fps
        self.bitrate_kbps = bitrate_kbps
        self.codec = self._CODEC_LIB.get(codec, codec)
        self._encoder = None
        self.units_out = 0

    def _ensure_encoder(self, w: int, h: int):
        """Lazy shared init for the BGR and YUV entry points — one place
        for the bitrate fallback / codec mapping so the two paths can't
        drift."""
        if self._encoder is None:
            from video_stab_tpu_torch.io.codec import VideoEncoder
            from video_stab_tpu_torch.io.sinks import bitrate_bps_app
            bps = (self.bitrate_kbps * 1000 or
                   bitrate_bps_app(w, h, self.fps))
            self._encoder = VideoEncoder(w, h, self.fps, bitrate_bps=bps,
                                         codec=self.codec, zerolatency=True)
        return self._encoder

    def encode_frame(self, frame: np.ndarray) -> Optional[List[bytes]]:
        h, w = frame.shape[:2]
        data = self._ensure_encoder(w, h).encode(frame)
        if not data:
            return None
        self.units_out += 1
        return split_nal_units(data)

    def encode_frame_yuv(self, i420: np.ndarray) -> Optional[List[bytes]]:
        """Encode a device-emitted planar I420 buffer ((H*3/2, W) u8,
        ops.color.bgr_to_i420 layout) with NO host colorspace pass — the
        packet graph's sink for ChainParams.output_format="i420"
        (native/codec.cpp vs_enc_encode_yuv)."""
        h = i420.shape[0] * 2 // 3
        w = i420.shape[1]
        data = self._ensure_encoder(w, h).encode_yuv(i420)
        if not data:
            return None
        self.units_out += 1
        return split_nal_units(data)

    def close(self) -> None:
        if self._encoder is not None:
            self._encoder.close()
            self._encoder = None


class _BitReader:
    """MSB-first bit reader over an RBSP (emulation-prevention removed)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def ue(self) -> int:                # Exp-Golomb
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 31:
                raise ValueError("bad exp-golomb")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)


def _rbsp(nal_payload: bytes) -> bytes:
    """Strip emulation-prevention bytes (00 00 03 -> 00 00)."""
    out = bytearray()
    i = 0
    while i < len(nal_payload):
        if i + 2 < len(nal_payload) and nal_payload[i:i + 3] == \
                b"\x00\x00\x03":
            out += b"\x00\x00"
            i += 3
        else:
            out.append(nal_payload[i])
            i += 1
    return bytes(out)


def sps_dimensions(sps_nal: bytes, hevc: bool = False):
    """(width, height) from an H.264 or HEVC SPS NAL (Annex-B or raw) —
    what the packet remuxer needs for container headers without ever
    constructing a decoder. Returns None on parse failure."""
    raw = sps_nal
    for sc in (b"\x00\x00\x00\x01", b"\x00\x00\x01"):
        if raw.startswith(sc):
            raw = raw[len(sc):]
            break
    try:
        if hevc:
            r = _BitReader(_rbsp(raw[2:]))      # 2-byte NAL header
            r.u(4)                              # sps_video_parameter_set_id
            max_sub = r.u(3)
            r.u(1)                              # temporal_id_nesting
            # profile_tier_level(1, max_sub)
            r.u(96)                             # general profile/level
            # sub-layer flags are INTERLEAVED per layer (H.265 7.3.3:
            # profile_present[i], level_present[i] in one loop).
            flags = [(r.u(1), r.u(1)) for _ in range(max_sub)]
            if max_sub > 0:
                r.u((8 - max_sub) * 2)
            for pf, lf in flags:
                if pf:
                    r.u(88)
                if lf:
                    r.u(8)
            r.ue()                              # sps_seq_parameter_set_id
            chroma = r.ue()
            if chroma == 3:
                r.u(1)
            w = r.ue()                          # pic_width_in_luma_samples
            h = r.ue()
            if r.u(1):                          # conformance_window_flag
                lo, ro, to, bo = r.ue(), r.ue(), r.ue(), r.ue()
                sub_x = 2 if chroma in (1, 2) else 1
                sub_y = 2 if chroma == 1 else 1
                w -= (lo + ro) * sub_x
                h -= (to + bo) * sub_y
            return int(w), int(h)
        r = _BitReader(_rbsp(raw[1:]))          # 1-byte NAL header
        profile = r.u(8)
        r.u(16)                                 # constraints + level
        r.ue()                                  # seq_parameter_set_id
        chroma = 1
        if profile in (100, 110, 122, 244, 44, 83, 86, 118, 128, 138,
                       139, 134, 135):
            chroma = r.ue()
            if chroma == 3:
                r.u(1)
            r.ue()                              # bit_depth_luma_minus8
            r.ue()                              # bit_depth_chroma_minus8
            r.u(1)                              # qpprime
            if r.u(1):                          # seq_scaling_matrix
                for i in range(8 if chroma != 3 else 12):
                    if r.u(1):
                        size = 16 if i < 6 else 64
                        last, nxt = 8, 8
                        for _ in range(size):
                            if nxt != 0:
                                nxt = (last + r.se() + 256) % 256
                            last = last if nxt == 0 else nxt
        r.ue()                                  # log2_max_frame_num_minus4
        poc_type = r.ue()
        if poc_type == 0:
            r.ue()
        elif poc_type == 1:
            r.u(1)
            r.se()
            r.se()
            for _ in range(r.ue()):
                r.se()
        r.ue()                                  # max_num_ref_frames
        r.u(1)                                  # gaps_in_frame_num
        w_mbs = r.ue() + 1
        h_map = r.ue() + 1
        frame_mbs_only = r.u(1)
        if not frame_mbs_only:
            r.u(1)
        r.u(1)                                  # direct_8x8
        w = w_mbs * 16
        h = h_map * 16 * (1 if frame_mbs_only else 2)
        if r.u(1):                              # frame_cropping
            lo, ro, to, bo = r.ue(), r.ue(), r.ue(), r.ue()
            sub_x = 2 if chroma in (1, 2) else 1
            sub_y = (2 if chroma == 1 else 1) \
                * (1 if frame_mbs_only else 2)
            w -= (lo + ro) * sub_x
            h -= (to + bo) * sub_y
        return int(w), int(h)
    except (IndexError, ValueError):
        return None


class ContainerPacketSink:
    """Pre-encoded access units -> MP4/MKV container WITHOUT re-encode
    (native vs_muxp_*, the reference's qtmux stage): compressed-domain
    passthrough can terminate in a proper container. Lazily opened at the
    first access unit carrying parameter sets (SPS/PPS[/VPS] become the
    stream extradata); per-unit keyframe flags from IDR/IRAP NALs."""

    def __init__(self, path: str, width: int = 0, height: int = 0,
                 fps: float = 30.0, codec: str = "auto"):
        self.path = path
        self.width, self.height = width, height
        self.fps = fps
        self.codec = codec
        self._h = None
        self._lib = None
        self.units_written = 0

    def _open(self, au: List[bytes]) -> bool:
        # NAL classification comes from io/codec (hevc_nal_type /
        # is_param_set / is_irap) — the single classifier the rest of the
        # packet graph uses, so a refinement there can't miss this sink.
        from video_stab_tpu_torch.io import codec as vc
        lib = vc._load()
        if lib is None:
            raise RuntimeError("native codec library unavailable")
        if self.codec == "auto":
            # H.264 SPS (type 7) and HEVC SPS (type 33) bytes are disjoint.
            if any(nal_type(n) == 7 for n in au):
                self.codec = "h264"
            elif any(hevc_nal_type(n) == 33 for n in au):
                self.codec = "hevc"
            else:
                return False    # wait for a parameter-set-bearing unit
        ps = [n for n in au if is_param_set(n, self.codec)]
        if not ps:
            return False        # wait for a unit with parameter sets
        extra = b"".join(ps)
        if self.width <= 0 or self.height <= 0:
            # Container headers need dimensions; parse them from the SPS
            # (still no decoder).
            hevc = self.codec in ("hevc", "h265")
            sps = next((n for n in ps
                        if (hevc_nal_type(n) == 33 if hevc
                            else nal_type(n) == 7)), None)
            dims = sps_dimensions(sps, hevc=hevc) if sps else None
            if dims:
                self.width, self.height = dims
        self._h = lib.vs_muxp_open(
            self.path.encode(), self.width, self.height, float(self.fps),
            self.codec.encode(), extra, len(extra))
        if not self._h:
            raise RuntimeError(f"cannot open packet muxer {self.path!r}")
        self._lib = lib
        return True

    def write(self, au: List[bytes]) -> None:
        if self._h is None and not self._open(au):
            return
        blob = b"".join(au)
        key = any(codec_is_irap(n, self.codec) for n in au)
        pts = getattr(au, "pts", None)
        if pts is not None:
            # Preserve container timestamps (AccessUnit from a demuxed
            # source): correct presentation order for B-frame streams,
            # where decode-order counters would judder playback.
            dts = getattr(au, "dts", None)
            rc = self._lib.vs_muxp_write_ts(
                self._h, blob, len(blob), int(key), float(pts),
                float(dts) if dts is not None else -1e18)
        else:
            rc = self._lib.vs_muxp_write(self._h, blob, len(blob),
                                         int(key))
        if rc == 0:
            self.units_written += 1

    def close(self) -> None:
        if self._h is not None:
            self._lib.vs_muxp_close(self._h)
            self._h = None


def open_packet_source(source: str, realtime_fps: float = 0.0):
    """Packet-source dispatch (the compressed half of CamCap's source
    dispatch, CamCap.cpp:22-77): rtsp:// -> RtspPacketSource;
    mp4/m4v/mkv/mov -> ContainerPacketSource (native demux); anything else
    -> Annex-B PacketSource."""
    if source.startswith("rtsp://"):
        return RtspPacketSource(source)
    if source.endswith((".mp4", ".m4v", ".mkv", ".mov")):
        return ContainerPacketSource(source, realtime_fps=realtime_fps)
    codec = "h265" if source.endswith((".h265", ".265", ".hevc")) \
        else "h264"
    return PacketSource(source, realtime_fps=realtime_fps, codec=codec)


class RtspPacketSinkAdapter:
    """write(au) adapter over RTSPServer.push_packet — the compressed tail
    of the output pipeline (interpipesrc->rtspclientsink,
    GstdManager.cpp:213-229)."""

    def __init__(self, server):
        self.server = server

    def write(self, au: List[bytes]) -> None:
        self.server.push_packet(au)

    def close(self) -> None:
        self.server.close()


def open_packet_sink(target: str, fps: float = 30.0,
                     codec: str = "h264"):
    """Packet-sink dispatch: '*.h264' -> PacketFileSink; 'rtsp://...' ->
    RTSPServer relaying pre-encoded units; mp4/mkv/mov -> remuxing
    ContainerPacketSink (no re-encode); '' -> counting null sink."""
    if not target or target == "null":
        class _Null:
            units = 0

            def write(self, au):
                self.units += 1

            def close(self):
                pass
        return _Null()
    if target.startswith("rtsp://"):
        from video_stab_tpu_torch.io.rtsp import RTSPServer
        rest = target[len("rtsp://"):]
        host_port, _, mount = rest.partition("/")
        host = host_port.rsplit(":", 1)[0] if ":" in host_port else host_port
        if host not in ("", "localhost", "127.0.0.1", "0.0.0.0", "::1"):
            # The reference tail is rtspclientsink (a PUSH client to an
            # external server, GstdManager.cpp:213-229); this framework
            # SERVES the stream itself. A remote hostname here would
            # silently bind locally — warn loudly (ADVICE r3).
            get_logger("PacketSink", True).warning(
                "rtsp sink target host %r is not local; serving LOCALLY "
                "on port %s — point clients at this machine, not %r",
                host, host_port.rsplit(":", 1)[-1] if ":" in host_port
                else 8554, host)
        port = int(host_port.rsplit(":", 1)[-1]) if ":" in host_port \
            else 8554
        server = RTSPServer(port=port, mount="/" + (mount or "stream"),
                            fps=int(fps), codec=codec).start()
        return RtspPacketSinkAdapter(server)
    if target.endswith((".mp4", ".m4v", ".mkv", ".mov")):
        return ContainerPacketSink(target, fps=fps, codec="auto")
    return PacketFileSink(target)


class PacketFileSink:
    """Byte-identical Annex-B writer — the passthrough relay's tail."""

    def __init__(self, path: str):
        self.path = path
        self._file = None
        self.units_written = 0

    def write(self, au: List[bytes]) -> None:
        if self._file is None:
            self._file = open(self.path, "wb")
        for nal in au:
            self._file.write(nal)
        self.units_written += 1

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


class PacketDecoderBridge:
    """Packet -> pixel bridge: feeds access units to the native decoder and
    emits BGR frames (the nvv4l2decoder stage of the processing pipeline,
    GstdManager.cpp:182-211). Constructed lazily — passthrough mode never
    instantiates a decoder."""

    def __init__(self, codec: str = "h264"):
        self.codec = codec
        self._decoder: Optional[VideoDecoder] = None
        self.frames_out = 0
        self.ever_constructed = False   # survives close() — observability

    def decode_unit(self, au: List[bytes]) -> List[np.ndarray]:
        if self._decoder is None:
            self._decoder = VideoDecoder(self.codec)
            self.ever_constructed = True
        frames = self._decoder.decode(b"".join(au))
        self.frames_out += len(frames)
        return frames

    def flush(self) -> List[np.ndarray]:
        if self._decoder is None:
            return []
        frames = self._decoder.flush()
        self.frames_out += len(frames)
        return frames

    @property
    def decoder_constructed(self) -> bool:
        return self._decoder is not None

    def close(self) -> None:
        if self._decoder is not None:
            self._decoder.close()
            self._decoder = None


class PacketRelay:
    """The passthrough pipeline: PacketSource -> sinks, byte-identical, no
    decode — GstdManager's passthrough + output pipelines collapsed into a
    thread. Sinks: anything with write(au) (PacketFileSink, RTSPServer via
    push_packet, a StreamGraph channel publish).
    """

    def __init__(self, source: PacketSource,
                 sinks: Optional[List] = None,
                 on_unit: Optional[Callable[[List[bytes]], None]] = None):
        self.source = source
        self.sinks = sinks or []
        self.on_unit = on_unit
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.units_relayed = 0
        self.log = get_logger("PacketRelay", False)

    def _run(self):
        while not self._stop.is_set():
            au = self.source.read()
            if au is None:
                # A live RTSP source also returns None on a transient
                # read-timeout stall — only a source reporting EOF ends
                # the relay (a camera pausing >5 s must not kill it).
                if getattr(self.source, "eof", True):
                    break
                continue
            for s in self.sinks:
                s.write(au)
            if self.on_unit is not None:
                self.on_unit(au)
            self.units_relayed += 1

    def start(self) -> "PacketRelay":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="packet-relay")
        self._thread.start()
        return self

    def join(self, timeout: float = 30.0) -> None:
        if self._thread:
            self._thread.join(timeout)

    def stop(self) -> None:
        self._stop.set()
        self.join(2.0)
