"""Build and load the port's CUDA kernels.

All sources under ``csrc/`` are compiled by ONE ``nvcc -shared`` call for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``. No source includes PyTorch's headers, which keeps the build to
seconds; tensors cross as ``data_ptr()`` integers and the launch goes on
PyTorch's current stream. The library's file name carries a hash of the
sources and flags, so an edited source is rebuilt and a built one is
reused. The build runs at first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("warp.cu", "features.cu", "enhance.cu")
# --fmad=false: no multiply-add contraction anywhere, so every kernel's
# float32 arithmetic is the same as its plain PyTorch version's.
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # src, h, w, c, dst, oh, ow, minv, mode, border_value, stream
    "vs_warp_affine_u8": (_P, _I, _I, _I, _P, _I, _I, _P, _I, _F, _P),
    # gray, h, w, scale, resp, peak, stream
    "vs_corner_response": (_P, _I, _I, _F, _P, _P, _P),
    # src, dst, gray, n_pix, wb, do_cb, contrast, brightness, do_gamma,
    # gamma, stream
    "vs_enhance_u8": (_P, _P, _P, ctypes.c_longlong, _P, _I, _F, _F, _I, _F,
                      _P),
}

_lock = threading.Lock()
_library = None


def build_dir() -> Path:
    """``build/torch_kernels/`` at the root of the checkout."""
    return CSRC.parent.parent / "build" / "torch_kernels"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from source at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources unless a library for them exists; return its path.
    The compiler's output (with ptxas's register and spill report) is kept
    beside the library as ``<name>.log``."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"libvstab_torch_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    lib.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _library = lib
        return _library


def stream_handle(device: torch.device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def require_cuda(t: torch.Tensor, name: str, dtype: torch.dtype,
                 ndim: tuple[int, ...]) -> None:
    """The checks every wrapper makes before passing a pointer."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() not in ndim:
        raise ValueError(f"{name}: expected {ndim}-d, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
