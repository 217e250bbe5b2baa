"""Stream-graph daemon — the GStreamer Daemon (gstd) counterpart; port of
``video_stab_tpu/io/daemon.py`` (the child process runs this package's
graph, never the JAX package's).

The reference's gstd mode runs pipelines in an EXTERNAL daemon process and
controls them with `system("gst-client ...")` string commands
(src/GstdManager.cpp:275-306): kill/start the daemon (32-44), create named
pipelines (155-229), switch the output pipeline's listen-to for seamless
mode changes (324-327), `pipeline_list` debugging.

Here: ``GraphDaemon`` runs a StreamGraph in a subprocess serving
newline-delimited JSON-RPC over TCP; ``GraphDaemonClient`` mirrors
vs::GstdManager's API (initialize/start/switch_mode/is_healthy/stop +
pipeline_list). Process isolation buys the same things gstd does: the
capture/serve plumbing survives a crash of the processing client, and
multiple clients can share one ingest daemon.
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys
import threading
import time
from typing import Optional

from video_stab_tpu_torch.utils.telemetry import get_logger

_SERVER_CODE = r"""
import json, socket, sys, threading
sys.path.insert(0, {repo_path!r})
import cv2
cv2.setNumThreads(0)
from video_stab_tpu_torch.io.channels import StreamGraph
from video_stab_tpu_torch.io.sources import SourceParams, open_source
from video_stab_tpu_torch.io.sinks import open_sink

graph = StreamGraph()
started = False

def _is_packet(target):
    return target.endswith((".h264", ".264"))

def handle(req):
    global started
    cmd = req.get("cmd")
    if cmd == "ping":
        return {{"ok": True}}
    if cmd == "pipeline_create":
        name = req["name"]
        packet = bool(req.get("packet"))
        kw = {{}}
        if req.get("source"):
            src = req["source"]
            if packet or _is_packet(src):
                # Compressed-domain ingest: relay access units, no decode
                # (GstdManager.cpp:155-180). The dispatcher picks the
                # right reader per container/codec (an .mp4 routed to the
                # Annex-B scanner would silently yield nothing).
                from video_stab_tpu_torch.io.packets import open_packet_source
                kw["source"] = open_packet_source(src, realtime_fps=30)
            else:
                kw["source"] = open_source(src, SourceParams(source=src))
        if req.get("listen_to"):
            kw["listen_to"] = req["listen_to"]
        if req.get("publish_to"):
            kw["publish_to"] = req["publish_to"]
            if packet:
                # Packet channels must be lossless-ordered (an access unit
                # dropped breaks the decode chain and byte-identity).
                graph.channel(req["publish_to"]).depth = 256
        if req.get("sink"):
            out = req["sink"]
            if packet or _is_packet(out):
                from video_stab_tpu_torch.io.packets import open_packet_sink
                kw["sink"] = open_packet_sink(out)
            else:
                kw["sink"] = open_sink(out)
        graph.add_pipeline(name, **kw)
        return {{"ok": True}}
    if cmd == "pipeline_play":
        for p in graph._pipelines.values():
            if p.source is not None and p._thread is None:
                p.source.start()
        graph.start()
        started = True
        return {{"ok": True}}
    if cmd == "set_listen_to":
        graph.set_listen_to(req["pipeline"], req["channel"])
        return {{"ok": True}}
    if cmd == "pipeline_list":
        return {{"ok": True, "pipelines": graph.pipeline_list()}}
    if cmd == "stop":
        graph.stop()
        return {{"ok": True, "bye": True}}
    return {{"ok": False, "error": "unknown cmd"}}

srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
srv.bind(("127.0.0.1", {port}))
srv.listen(4)
print("READY", flush=True)
alive = True
while alive:
    conn, _ = srv.accept()
    f = conn.makefile("rw")
    for line in f:
        try:
            resp = handle(json.loads(line))
        except Exception as e:
            resp = {{"ok": False, "error": str(e)}}
        f.write(json.dumps(resp) + "\n")
        f.flush()
        if resp.get("bye"):
            alive = False
            break
    conn.close()
srv.close()
"""


class GraphDaemonClient:
    """vs::GstdManager-equivalent control surface over the daemon."""

    def __init__(self, source: str, output: str = "null",
                 port: int = 5910, logging: bool = False,
                 repo_path: Optional[str] = None):
        self.source = source
        self.output = output
        self.port = port
        self.log = get_logger("GraphDaemon", logging)
        self._proc: Optional[subprocess.Popen] = None
        self._sock: Optional[socket.socket] = None
        self._file = None
        self._lock = threading.Lock()
        import video_stab_tpu_torch
        import os
        self._repo = repo_path or os.path.dirname(
            os.path.dirname(os.path.abspath(video_stab_tpu_torch.__file__)))

    # -- daemon lifecycle (GstdManager::initialize, 32-44) -----------------
    def initialize(self, timeout: float = 15.0) -> bool:
        code = _SERVER_CODE.format(repo_path=self._repo, port=self.port)
        self._proc = subprocess.Popen(
            [sys.executable, "-c", code],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        line = self._proc.stdout.readline()
        if "READY" not in line:
            return False
        self._sock = socket.create_connection(("127.0.0.1", self.port),
                                              timeout=timeout)
        self._file = self._sock.makefile("rw")
        return self._call({"cmd": "ping"}).get("ok", False)

    def _call(self, req: dict) -> dict:
        with self._lock:
            self._file.write(json.dumps(req) + "\n")
            self._file.flush()
            line = self._file.readline()
            return json.loads(line) if line else {"ok": False}

    # -- pipeline construction (GstdManager::createPipelines, 155-229) -----
    def create_pipelines(self) -> bool:
        # Packet (compressed-domain) graph when both endpoints speak H.264
        # elementary streams — the gstd passthrough that never decodes.
        packet = (self.source.endswith((".h264", ".264", ".mp4", ".m4v",
                                        ".mkv", ".mov"))
                  or self.source.startswith("rtsp://")) and (
                  self.output.endswith((".h264", ".264")))
        ok = True
        # 1. passthrough: source -> "source" channel
        ok &= self._call({"cmd": "pipeline_create", "name": "capture",
                          "source": self.source, "packet": packet,
                          "publish_to": "source"})["ok"]
        # 2. passthrough relay channel (interpipe passthrough analog)
        ok &= self._call({"cmd": "pipeline_create", "name": "passthrough",
                          "listen_to": "source", "packet": packet,
                          "publish_to": "passthrough_out"})["ok"]
        # 3. processing input bridge: clients consume "source" directly
        # 4. output: switchable listen-to -> sink
        ok &= self._call({"cmd": "pipeline_create", "name": "output",
                          "listen_to": "passthrough_out", "packet": packet,
                          "sink": self.output})["ok"]
        return bool(ok)

    def start(self) -> bool:
        return self._call({"cmd": "pipeline_play"})["ok"]

    # -- seamless mode switch (GstdManager::switchMode, 324-327) -----------
    def switch_mode(self, processing: bool) -> bool:
        channel = "processed" if processing else "passthrough_out"
        return self._call({"cmd": "set_listen_to", "pipeline": "output",
                           "channel": channel})["ok"]

    def pipeline_list(self) -> list:
        return self._call({"cmd": "pipeline_list"}).get("pipelines", [])

    def is_healthy(self) -> bool:
        if self._proc is None or self._proc.poll() is not None:
            return False
        try:
            return self._call({"cmd": "ping"}).get("ok", False)
        except Exception:
            return False

    def stop(self) -> None:
        try:
            if self._file is not None:
                self._call({"cmd": "stop"})
        except Exception:
            pass
        if self._sock is not None:
            self._sock.close()
            self._sock = None
        if self._proc is not None:
            try:
                self._proc.wait(timeout=3.0)
            except subprocess.TimeoutExpired:
                self._proc.terminate()
            self._proc = None
