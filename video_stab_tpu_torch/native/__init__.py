"""The port's native host library: ctypes bindings and its build.

Port of ``video_stab_tpu/native/__init__.py``. Two shared libraries are
built from the C++ sources of this directory, which are byte-identical
copies of the JAX package's (``tests/test_torch_native.py`` holds them so):

- ``vstab_host`` (``frame_ring.cpp``): FrameRing (lock-free SPSC frame
  transport), PacingClock and a C++ TcpReceiver — the host plumbing the
  reference gets from GStreamer / pthreads.
- ``vstab_codec`` (``codec.cpp``): H.264 / H.265 encode and decode, MP4 /
  MKV muxing and demuxing over the system's libavcodec / libavformat /
  libswscale (bound in ``io/codec.py``).

Each library is compiled by ``g++`` with the flags of the JAX package's
Makefile into ``build/torch_native/`` at the root of the checkout, at
first use and never at import. Its file name carries a hash of its source
and flags, so an edited source is rebuilt and a built one reused. Builds
from several processes at once (test workers, the app's threads) do not
race: each takes an ``fcntl.flock`` on the library's lock file, looks
again for the library, compiles to a temporary name and renames the
result into place. A build that fails is remembered for the process
(:func:`build_error` holds the compiler's message), so a host without a
toolchain does not retry it on every probe; every consumer has a
pure-Python fallback or says that the library is missing.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
            "-shared")
# name -> (source, link flags)
LIBRARIES = {
    "vstab_host": ("frame_ring.cpp", ()),
    "vstab_codec": ("codec.cpp", ("-lavcodec", "-lavformat", "-lavutil",
                                  "-lswscale")),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_errors: Dict[str, str] = {}


def build_dir() -> Path:
    """``build/torch_native/`` at the root of the checkout."""
    return NATIVE_DIR.parent.parent / "build" / "torch_native"


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def library_file(out_dir: Path, stem: str, key, sources) -> Path:
    """``out_dir/lib<stem>_<hash>.so``: the hash covers ``key`` (the
    compiler and its flags) and the sources' bytes. The port's CUDA
    kernels (``kernels/_lib.py``) are named by the same rule."""
    h = hashlib.sha256(" ".join(key).encode())
    for source in sources:
        h.update(Path(source).read_bytes())
    return out_dir / f"lib{stem}_{h.hexdigest()[:16]}.so"


def build_locked(lib: Path, lock: str,
                 compile_to: Callable[[Path], None]) -> Path:
    """``lib``, made by ``compile_to(tmp)`` unless it exists.

    Under an exclusive ``flock`` on ``<lock>.lock`` beside it: a process
    that waited for another's build finds the library and compiles
    nothing. ``compile_to`` writes ``<lib>.<pid>.tmp`` or raises; the file
    is renamed into place when it succeeds and removed when it fails.
    Each build appends one line to ``builds.log``. The port's CUDA kernels
    (``kernels/_lib.py``) build through here too."""
    if lib.exists():
        return lib
    out = lib.parent
    out.mkdir(parents=True, exist_ok=True)
    with open(out / f"{lock}.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        try:
            compile_to(tmp)
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise
        os.replace(tmp, lib)
        with open(out / "builds.log", "a") as log:
            log.write(f"{lib.name} pid={os.getpid()}\n")
    return lib


def library_path(name: str) -> Path:
    """Where ``name``'s library lives once built (a hash of its source and
    flags in the file name)."""
    source, ldflags = LIBRARIES[name]
    return library_file(build_dir(), name, (_cxx(), *CXXFLAGS, *ldflags),
                        (NATIVE_DIR / source,))


def build(name: str) -> Path:
    """Compile ``name`` with ``g++`` unless its library exists; return its
    path (:func:`build_locked`). Raises ``RuntimeError`` with the
    compiler's output when it fails."""
    source, ldflags = LIBRARIES[name]

    def compile_to(tmp: Path) -> None:
        cmd = [_cxx(), *CXXFLAGS, "-o", str(tmp),
               str(NATIVE_DIR / source), *ldflags]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300, check=False)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)}\n{proc.stderr}")

    return build_locked(library_path(name), name, compile_to)


def load(name: str, bind: Callable[[ctypes.CDLL], None]
         ) -> Optional[ctypes.CDLL]:
    """``name``'s library, built at first call and given its signatures by
    ``bind``; None when it cannot be built or loaded (then
    :func:`build_error` says why)."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        if name in _errors:
            return None
        try:
            lib = ctypes.CDLL(str(build(name)))
        except (RuntimeError, OSError) as e:
            _errors[name] = str(e)
            return None
        bind(lib)
        _loaded[name] = lib
        return lib


def build_error(name: str) -> Optional[str]:
    """The compiler's or loader's message of ``name``'s failed build."""
    return _errors.get(name)


def _bind_host(lib: ctypes.CDLL) -> None:
    lib.vstab_ring_create.restype = ctypes.c_void_p
    lib.vstab_ring_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
    lib.vstab_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.vstab_ring_push.restype = ctypes.c_int
    lib.vstab_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int64]
    lib.vstab_ring_pop.restype = ctypes.c_int
    lib.vstab_ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.c_int]
    lib.vstab_ring_size.restype = ctypes.c_size_t
    lib.vstab_ring_size.argtypes = [ctypes.c_void_p]
    lib.vstab_ring_pushed.restype = ctypes.c_uint64
    lib.vstab_ring_pushed.argtypes = [ctypes.c_void_p]
    lib.vstab_ring_dropped.restype = ctypes.c_uint64
    lib.vstab_ring_dropped.argtypes = [ctypes.c_void_p]
    lib.vstab_pace_create.restype = ctypes.c_void_p
    lib.vstab_pace_create.argtypes = [ctypes.c_double]
    lib.vstab_pace_destroy.argtypes = [ctypes.c_void_p]
    lib.vstab_pace_wait.restype = ctypes.c_int64
    lib.vstab_pace_wait.argtypes = [ctypes.c_void_p]
    lib.vstab_tcp_create.restype = ctypes.c_void_p
    lib.vstab_tcp_create.argtypes = [ctypes.c_int]
    lib.vstab_tcp_destroy.argtypes = [ctypes.c_void_p]
    lib.vstab_tcp_try_get_latest.restype = ctypes.c_int
    lib.vstab_tcp_try_get_latest.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]


def _load() -> Optional[ctypes.CDLL]:
    return load("vstab_host", _bind_host)


def available() -> bool:
    return _load() is not None


class FrameRing:
    """Lock-free SPSC frame transport over one preallocated native slab."""

    def __init__(self, frame_shape: Tuple[int, ...], capacity: int = 8,
                 dtype=np.uint8):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.frame_shape = tuple(frame_shape)
        self.dtype = np.dtype(dtype)
        self.frame_bytes = int(np.prod(frame_shape)) * self.dtype.itemsize
        self._h = lib.vstab_ring_create(self.frame_bytes, capacity)

    def push(self, frame: np.ndarray, stamp: int = 0) -> bool:
        """Returns False when an old frame was dropped to make room."""
        buf = np.ascontiguousarray(frame, dtype=self.dtype)
        assert buf.nbytes == self.frame_bytes, (buf.shape, self.frame_shape)
        r = self._lib.vstab_ring_push(
            self._h, buf.ctypes.data_as(ctypes.c_char_p), stamp)
        return r == 1

    def pop(self, timeout_ms: int = 100
            ) -> Optional[Tuple[np.ndarray, int]]:
        out = np.empty(self.frame_shape, self.dtype)
        stamp = ctypes.c_int64(0)
        r = self._lib.vstab_ring_pop(
            self._h, out.ctypes.data_as(ctypes.c_char_p),
            ctypes.byref(stamp), timeout_ms)
        if r == 0:
            return None
        return out, int(stamp.value)

    def __len__(self) -> int:
        return int(self._lib.vstab_ring_size(self._h))

    @property
    def stats(self) -> dict:
        return {"pushed": int(self._lib.vstab_ring_pushed(self._h)),
                "dropped": int(self._lib.vstab_ring_dropped(self._h))}

    def close(self):
        if self._h:
            self._lib.vstab_ring_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PacingClock:
    """Frame-rate pacing: wait() sleeps to the next frame deadline."""

    def __init__(self, fps: float):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.vstab_pace_create(fps)

    def wait(self) -> int:
        """Returns lateness in microseconds (<=0 means on schedule)."""
        return int(self._lib.vstab_pace_wait(self._h))

    def close(self):
        if self._h:
            self._lib.vstab_pace_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeTcpReceiver:
    """C++ TcpReceiver (TcpReciever.cpp counterpart)."""

    def __init__(self, port: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.vstab_tcp_create(port)
        if not self._h:
            raise OSError(f"cannot bind port {port}")

    def try_get_latest(self) -> Optional[Tuple[int, int]]:
        x = ctypes.c_int(0)
        y = ctypes.c_int(0)
        if self._lib.vstab_tcp_try_get_latest(self._h, ctypes.byref(x),
                                              ctypes.byref(y)):
            return int(x.value), int(y.value)
        return None

    def stop(self):
        if self._h:
            self._lib.vstab_tcp_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


__all__ = ["available", "build", "build_dir", "build_error", "build_locked",
           "load", "library_file", "library_path", "FrameRing",
           "PacingClock", "NativeTcpReceiver"]
