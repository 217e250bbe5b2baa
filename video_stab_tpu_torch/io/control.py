"""Control plane: TCP coordinate channel + REST config API; port of
``video_stab_tpu/io/control.py``.

- TcpReceiver <- src/TcpReciever.cpp [sic] (include/video/TcpReciever.h:33):
  newline-delimited "x y" pairs on a TCP port, latest pair readable via an
  atomic exchange ``try_get_latest()``. Used to click-select the tracked
  object (vsg.cpp:1292-1306).
- ConfigRestServer <- examples/stabilizer_api.py (Flask): POST /stabilization
  maps camelCase JSON fields to YAML keys and rewrites config.yaml in place
  (with a .backup), relying on the apps' hot reload; GET /health. Flask is
  replaced by http.server (stdlib).
"""

from __future__ import annotations

import json
import shutil
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from video_stab_tpu_torch.utils.telemetry import get_logger


class TcpReceiver:
    """TCP "x y" coordinate listener (TcpReciever.cpp:74-105)."""

    def __init__(self, port: int, logging: bool = False):
        self.port = port
        self.log = get_logger("TcpReceiver", logging)
        self._latest: Optional[Tuple[int, int]] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "TcpReceiver":
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", self.port))
        self._sock.listen(1)
        self._sock.settimeout(0.5)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.settimeout(0.5)
            buf = b""
            with conn:
                while not self._stop.is_set():
                    try:
                        data = conn.recv(256)
                    except socket.timeout:
                        continue
                    except OSError:
                        break
                    if not data:
                        break
                    buf += data
                    while b"\n" in buf:
                        line, _, buf = buf.partition(b"\n")
                        parts = line.split()
                        if len(parts) == 2:
                            try:
                                xy = (int(parts[0]), int(parts[1]))
                            except ValueError:
                                continue
                            with self._lock:
                                self._latest = xy
                            self.log.info("coords %s", xy)

    def try_get_latest(self) -> Optional[Tuple[int, int]]:
        """Atomic exchange: returns the pair once, then None
        (TcpReciever.cpp:63-71)."""
        with self._lock:
            xy, self._latest = self._latest, None
            return xy

    def stop(self):
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if self._thread:
            self._thread.join(timeout=2.0)


# camelCase JSON field -> (yaml section, key). Mirrors the mappings dict in
# examples/stabilizer_api.py.
REST_MAPPINGS = {
    "smoothingRadius": ("stabilizer", "smoothing_radius"),
    "borderType": ("stabilizer", "border_type"),
    "borderSize": ("stabilizer", "border_size"),
    "cropNZoom": ("stabilizer", "crop_n_zoom"),
    "smoothingMethod": ("stabilizer", "smoothing_method"),
    "gaussianSigma": ("stabilizer", "gaussian_sigma"),
    "maxCorners": ("stabilizer", "max_corners"),
    "qualityLevel": ("stabilizer", "quality_level"),
    "minDistance": ("stabilizer", "min_distance"),
    "horizonLock": ("stabilizer", "horizon_lock"),
    "adaptiveSmoothing": ("stabilizer", "adaptive_smoothing"),
    "droneHighFreqMode": ("stabilizer", "drone_high_freq_mode"),
    "stabilizationEnabled": ("mode", "stabilizer_enabled"),
    "enhancerEnabled": ("mode", "enhancer_enabled"),
    "rollCorrectionEnabled": ("mode", "roll_correction_enabled"),
    "trackerEnabled": ("mode", "tracker_enabled"),
    "brightness": ("enhancer", "brightness"),
    "contrast": ("enhancer", "contrast"),
    "gamma": ("enhancer", "gamma"),
    "enableClahe": ("enhancer", "enable_clahe"),
    "enableWhiteBalance": ("enhancer", "enable_white_balance"),
    "enableVibrance": ("enhancer", "enable_vibrance"),
    "enableUnsharp": ("enhancer", "enable_unsharp"),
    "sharpness": ("enhancer", "sharpness"),
    "angleSmoothingAlpha": ("roll_correction", "angle_smoothing_alpha"),
    "angleDecay": ("roll_correction", "angle_decay"),
    "videoSource": (None, "video_source"),
}


def apply_rest_update(config_path: str, updates: dict,
                      backup: bool = True) -> dict:
    """Rewrite config.yaml in place per the REST mappings, with backup
    (stabilizer_api.py backup_config + regex rewrite; here a parse+dump
    round-trip through the typed schema)."""
    from video_stab_tpu_torch.utils.config import load_config, save_config
    import dataclasses as dc

    if backup:
        shutil.copyfile(config_path, config_path + ".backup")
    cfg = load_config(config_path)
    applied, ignored = {}, {}
    for key, value in updates.items():
        if key not in REST_MAPPINGS:
            ignored[key] = value
            continue
        section, field = REST_MAPPINGS[key]
        if section is None:
            setattr(cfg, field, value)   # top-level scalar (video_source)
        else:
            params = getattr(cfg, section)
            coerced = type(getattr(params, field))(value)
            setattr(cfg, section, dc.replace(params, **{field: coerced}))
        applied[key] = value
    save_config(cfg, config_path)
    return {"applied": applied, "ignored": ignored}


class ConfigRestServer:
    """stabilizer_api.py equivalent on http.server."""

    def __init__(self, config_path: str, port: int = 5001,
                 logging: bool = False):
        self.config_path = config_path
        self.port = port
        self.log = get_logger("ConfigRestServer", logging)
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ConfigRestServer":
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code: int, obj: dict):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    self._reply(200, {"status": "healthy"})
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/stabilization":
                    self._reply(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    updates = json.loads(self.rfile.read(n) or b"{}")
                    result = apply_rest_update(outer.config_path, updates)
                    self._reply(200, {"status": "ok", **result})
                except Exception as e:  # noqa: BLE001
                    self._reply(500, {"error": str(e)})

        self._server = ThreadingHTTPServer(("0.0.0.0", self.port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        self.log.info("REST config API on :%d", self.port)
        return self

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


# Alias preserving the reference's (misspelled) class name for API parity.
TcpReciever = TcpReceiver


class KeyboardController:
    """Interactive runtime controls — the reference's keyboard handler
    (examples/vsg.cpp:1426-1451): p = passthrough, r = processing,
    s = status, q/ESC = quit. Reads raw single keys from a TTY stdin on a
    daemon thread; a no-op when stdin is not a terminal (services, tests).
    """

    def __init__(self, on_passthrough, on_processing, on_status, on_quit):
        import sys
        self._cb = {"p": on_passthrough, "r": on_processing,
                    "s": on_status, "q": on_quit, "\x1b": on_quit}
        self._stop = threading.Event()
        self._thread = None
        self._tty = False
        try:
            self._tty = sys.stdin.isatty()
        except Exception:
            pass

    def start(self) -> "KeyboardController":
        if not self._tty:
            return self
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="keyboard")
        self._thread.start()
        return self

    def _run(self):
        import select
        import sys
        import termios
        import tty
        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        try:
            tty.setcbreak(fd)
            while not self._stop.is_set():
                ready, _, _ = select.select([fd], [], [], 0.2)
                if not ready:
                    continue
                key = sys.stdin.read(1)
                cb = self._cb.get(key)
                if cb is not None:
                    cb()
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)

    def handle_key(self, key: str) -> bool:
        """Dispatch one key programmatically (testable without a TTY)."""
        cb = self._cb.get(key)
        if cb is None:
            return False
        cb()
        return True

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)


__all__ = ["ConfigRestServer", "KeyboardController", "REST_MAPPINGS",
           "TcpReceiver", "TcpReciever", "apply_rest_update"]
