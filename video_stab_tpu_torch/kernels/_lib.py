"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled for ``sm_90a`` by its own
``nvcc -c``, all started together, and the objects are linked by one
``nvcc -shared`` into a library with a plain C interface, loaded with
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
SOURCES = ("warp.cu", "features.cu", "enhance.cu", "traj.cu", "lk.cu")
# --fmad=false: no multiply-add contraction anywhere, so every kernel's
# float32 arithmetic is the same as its plain PyTorch version's.
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # src, h, w, c, dst, oh, ow, minv, mode, border_value, stream
    "vs_warp_affine_u8": (_P, _I, _I, _I, _P, _I, _I, _P, _I, _F, _P),
    "vs_warp_homography_u8": (_P, _I, _I, _I, _P, _I, _I, _P, _I, _F, _P),
    # gray, h, w, scale, resp, peak, stream
    "vs_corner_response": (_P, _I, _I, _F, _P, _P, _P),
    # src, dst, gray, n_pix, wb, do_cb, contrast, brightness, do_gamma,
    # gamma, stream
    "vs_enhance_u8": (_P, _P, _P, ctypes.c_longlong, _P, _I, _F, _F, _I, _F,
                      _P),
    # x, n, c, offset, window, pad, median, centered, r, blocks, threads,
    # tile_rows, smem_bytes, out, stream
    "vs_box_window": (_P, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I,
                      _P, _P),
    # planes, sizes, n_levels, prev_pts, mask, init_pts, n, win, iters,
    # eps2, min_eig_thresh, out_pts, status, err, steps, stream
    "vs_lk_track": (_P, _P, _I, _P, _P, _P, _I, _I, _I, _F, _F, _P, _P, _P,
                    _P, _P),
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
    The compilers' output (with ptxas's register and spill report) is kept
    beside the library as ``<name>.log``."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"libvstab_torch_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    stem = f"{lib.stem}.{os.getpid()}"
    objs = [out_dir / f"{stem}.{Path(s).stem}.o" for s in SOURCES]
    cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
            for s, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    tmp = lib.with_name(f"{stem}.tmp")
    link = [_nvcc(), "-gencode=arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(tmp), *map(str, objs)]
    log = [" ".join(c) + "\n" + o for c, o in zip(cmds, outs)]
    failed = [c for c, p in zip(cmds, procs) if p.returncode != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True,
                              check=False)
        log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(link)
    lib.with_suffix(".log").write_text("\n".join(log))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed: {' '.join(failed[0])}\n"
                           + "\n".join(log))
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
