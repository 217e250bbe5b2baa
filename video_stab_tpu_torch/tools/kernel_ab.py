"""Time K1 / K2, K3, K4's head and tail, K5a / K5b and K6 against another
version of their source, in one process on one card, and count where K3's
and K6's clock cycles go.

    git show <commit>:video_stab_tpu_torch/csrc/lk.cu > build/old_lk.cu
    git show <commit>:video_stab_tpu_torch/csrc/features.cu \\
        > build/old_features.cu
    python3 -m video_stab_tpu_torch.tools.kernel_ab \\
        --old-lk build/old_lk.cu --old-features build/old_features.cu \\
        --old-features-launches 2 --cycles
    git show <commit>:video_stab_tpu_torch/csrc/traj.cu > build/old_traj.cu
    python3 -m video_stab_tpu_torch.tools.kernel_ab --old-traj build/old_traj.cu

Each ``--old-*`` source is built beside the checkout's library with every
kernel and ``vs_*`` name given the suffix ``_old``, checked against the
plain version as ``chip_smoke.py`` checks the checkout's kernel, and timed
with it in turns (old, new, new, old) by ``chip_smoke.device_us``
(``torch.profiler`` device time per launch over 64 launches) at the main
path's shapes: K6 at 540x960, 3 levels, 200 GFTT corners, eps 0.03 (and
once at eps 1e-6, where most points run their whole step budget); K3 at
540x960. An old ``vs_lk_track`` may lack the ``steps`` argument.

``--old-warp`` takes another warp.cu and times its single-frame K1 and K2
launches against the checkout's at the 1080p emit (16 frames cycled,
cold in L2), in turns, after checking both bit for bit against each
other.

``--old-enhance`` takes another enhance.cu and holds its K4 head and tail
modes to the checkout's, bit for bit (the tail's u8 and gray), then times
them in turns at 1080x1920x3, (37, 53) and (64, 96): the head with and
without white balance, the tail at gamma 0.9, 1.0 and 1.2 (16 inputs
cycled; at 1080p also on uniform values in [-20, 280]), with torch's own
u8 -> f32 and f32 -> u8 conversions at 1080p beside them::

    git show <commit>:video_stab_tpu_torch/csrc/enhance.cu \\
        > build/old_enhance.cu
    python3 -m video_stab_tpu_torch.tools.kernel_ab \\
        --old-enhance build/old_enhance.cu

``--old-traj`` takes the one-thread-per-output traj.cu (``vs_box_window(x,
n, c, offset, window, pad, centered, r, out, stream)``) and calls it as its
wrapper did: K5b with a ``torch.zeros`` pad, K5a after a ``torch.sort`` and
an index for the median pad. Old and new are checked bit for bit against
the plain versions and timed in turns at (240, 3), (240, 9) and (18000, 3):
the kernel's device time, the whole call's device time (every kernel it
launches), the call's time between CUDA events with the host's work, and
its kernel launches; beside them the launch floor, an empty kernel with
the new launch's grid, block and shared memory (``chip_smoke.py``).

``--cycles`` builds the checkout's lk.cu and features.cu once more with
``-DVS_CYCLES`` (suffix ``_cycles``), which makes each K6 block count its
``clock64()`` cycles per phase (set-up, templates with G and the inverse,
the Newton rounds, the err window, total) with its steps and restaged
patches, and each K3 warp the cycles it spent requesting its rows and
walking them; the counters of one launch are printed as medians and, for
K6, for the five slowest points.

Prints the card's name and power limit first. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from video_stab_tpu_torch.kernels import _lib  # noqa: E402
from video_stab_tpu_torch.kernels import features as kfeat  # noqa: E402
from video_stab_tpu_torch.kernels import lk as klk  # noqa: E402
from video_stab_tpu_torch.kernels import traj as ktraj  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build_variant(source: Path, suffix: str, defines=()) -> tuple:
    """Compile ``source`` with its kernel and ``vs_*`` names suffixed into a
    library of its own; return (library, kernel names, source text)."""
    text = source.read_text()
    names = set(re.findall(r"\b(\w+_kernel)\b", text))
    names |= set(re.findall(r"\b(vs_[a-z_]+)\b", text)) - {"vs_cycles"}
    renamed = re.sub(r"\b(" + "|".join(sorted(names)) + r")\b",
                     lambda m: m.group(1) + suffix, text)
    out_dir = _lib.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{source.stem}{suffix}.cu"
    src.write_text(renamed)
    lib = src.with_suffix(".so")
    cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, *defines, "-shared", "-o",
           str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  {source.name}{suffix}: {line.strip()}")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stderr}")
    kernels = sorted(n + suffix for n in names if n.endswith("_kernel"))
    return ctypes.CDLL(str(lib)), kernels, text


def corner_call(lib, suffix, gray):
    fn = getattr(lib, "vs_corner_response" + suffix)
    fn.argtypes = [_P, _I, _I, _F, _P, _P, _P]
    h, w = gray.shape
    resp = torch.empty((h, w), dtype=torch.float32, device=gray.device)
    peak = torch.empty((h, w), dtype=torch.bool, device=gray.device)

    def call(_i=0):
        rc = fn(gray.data_ptr(), h, w, kfeat.SCALE, resp.data_ptr(),
                peak.data_ptr(), _lib.stream_handle(gray.device))
        _lib.check(rc, "corner_response" + suffix)
        return resp, peak
    return call


def lk_call(lib, suffix, text, planes, pts, mask, win, iters, eps):
    fn = getattr(lib, "vs_lk_track" + suffix)
    has_steps = "void* steps" in text
    fn.argtypes = [_P, _P, _I, _P, _P, _P, _I, _I, _I, _F, _F, _P, _P, _P,
                   *([_P] if has_steps else []), _P]
    ptrs, sizes = [], []
    for stk, cur in zip(*planes):
        ptrs += [stk.data_ptr(), cur.data_ptr()]
        sizes += list(cur.shape)
    ptr_arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    size_arr = (ctypes.c_int * len(sizes))(*sizes)
    n, dev = pts.shape[0], pts.device
    out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    status = torch.empty(n, dtype=torch.bool, device=dev)
    err = torch.empty(n, dtype=torch.float32, device=dev)

    def call(_i=0):
        rc = fn(ctypes.cast(ptr_arr, _P), ctypes.cast(size_arr, _P),
                len(sizes) // 2, pts.data_ptr(), mask.data_ptr(), None, n,
                win, iters, eps * eps, 1e-4, out.data_ptr(),
                status.data_ptr(), err.data_ptr(),
                *([None] if has_steps else []), _lib.stream_handle(dev))
        _lib.check(rc, "lk_track" + suffix)
        return out, status, err
    return call


def old_traj_calls(lib, suffix):
    """The old wrappers over the old kernel: (centered(path, r),
    convolve(path, r))."""
    fn = getattr(lib, "vs_box_window" + suffix)
    fn.argtypes = [_P, _I, _I, _I, _I, _P, _I, _I, _P, _P]

    def launch(p2, offset, window, pad, centered, r):
        out = torch.empty_like(p2)
        rc = fn(p2.data_ptr(), p2.shape[0], p2.shape[1], offset, window,
                pad.data_ptr(), centered, r, out.data_ptr(),
                _lib.stream_handle(p2.device))
        _lib.check(rc, "box_window" + suffix)
        return out

    def centered(path, r):
        p2 = path.contiguous()
        pad = torch.zeros(p2.shape[1], dtype=p2.dtype, device=p2.device)
        return launch(p2, r, 2 * r + 1, pad, 1, r)

    def convolve(path, r):
        p2 = path.contiguous()
        pad = torch.sort(p2, dim=0).values[p2.shape[0] // 2].contiguous()
        return launch(p2, r, r, pad, 0, 0)
    return centered, convolve


def traj_ab(lib, kernels, dev):
    """K5a / K5b, old against new in turns, at chip_smoke's phase-3
    shapes."""
    old_centered, old_convolve = old_traj_calls(lib, "_old")
    launch_floor = cs.load_launch_floor(cs.start_launch_floor_build())
    rng = np.random.default_rng(7)
    for n, c in ((240, 3), (240, 9), (18000, 3)):
        path = torch.from_numpy(np.cumsum(rng.normal(0, 1, (n, c)), axis=0)
                                .astype(np.float32)).to(dev)
        for name, r, old, new, plain in (
                ("K5b", 15, old_centered, ktraj.box_filter_centered_cuda,
                 ktraj.box_filter_centered_plain),
                ("K5a", 8, old_convolve, ktraj.box_filter_convolve_cuda,
                 ktraj.box_filter_convolve_plain)):
            label = f"{name} ({n}, {c}) r={r}"
            want = plain(path, r)
            for which, fn in (("old", old), ("new", new)):
                got = fn(path, r)
                torch.cuda.synchronize()
                print(f"{label} {which}: bit-exact against the plain "
                      f"version {bool(torch.equal(got, want))}")
                assert torch.equal(got, want), (label, which)
            window = 2 * r + 1 if name == "K5b" else r
            median = name == "K5a" and ktraj.median_in_kernel(n)
            blocks, threads, _, smem = ktraj.launch_config(n, c, window,
                                                           median)
            floor = cs.device_us(
                torch, lambda i: launch_floor(blocks, threads, smem),
                ["launch_floor_kernel"])
            print(f"{label}: launch floor {floor:.3f} us ({blocks} blocks x "
                  f"{threads} threads, {smem} B shared)")
            turns = (("old", old, kernels), ("new", new,
                                             ["box_window_kernel(",
                                              "box_median_kernel("]))
            for which, fn, symbols in (turns[0], turns[1], turns[1],
                                       turns[0]):
                def call(_i=0, fn=fn):
                    return fn(path, r)
                print(f"{label} {which}: kernel "
                      f"{cs.device_us(torch, call, symbols):.3f} us, whole "
                      f"call on the device "
                      f"{cs.device_us(torch, call, None):.3f} us, call "
                      f"{cs.call_ms(torch, call):.4f} ms, "
                      f"{cs.launches_of(torch, call)} kernel launches")


def warp_ab(lib, dev):
    """K1 and K2's single-frame launch at the 1080p emit: another warp.cu
    (its ``vs_warp_*_u8`` entries keep their names: the renaming skips
    names with digits, and the library is loaded on its own) against the
    checkout's, bit for bit, then in turns."""
    from video_stab_tpu_torch.kernels import warp as kwarp
    from video_stab_tpu_torch.ops.warp import invert_affine

    frame = torch.from_numpy(cs.make_frames(1080, 1920, 1, seed=1)[0]).to(dev)
    cold = [torch.roll(frame, 17 * k, dims=1).contiguous()
            for k in range(cs.N_COLD)]
    a = np.radians(0.3)
    m = torch.tensor([[np.cos(a), -np.sin(a), 3.2],
                      [np.sin(a), np.cos(a), -1.7]], dtype=torch.float32)
    hm = torch.tensor([[1.0, 0.002, 3.0], [-0.002, 1.0, -2.0],
                       [1e-6, 2e-6, 1.0]], dtype=torch.float32)
    h, w = frame.shape[:2]
    for label, name, minv, new in (
            ("K1", "vs_warp_affine_u8", invert_affine(m).reshape(6),
             kwarp.warp_affine_u8_cuda),
            ("K2", "vs_warp_homography_u8", torch.linalg.inv(hm).reshape(9),
             kwarp.warp_homography_u8_cuda)):
        minv = minv.contiguous().to(dev)
        fn = getattr(lib, name)
        fn.argtypes = [_P, _I, _I, _I, _P, _I, _I, _P, _I, _F, _P]
        out = torch.empty_like(frame)

        def old(i=0, fn=fn, minv=minv, out=out, name=name):
            _lib.check(fn(cold[i % cs.N_COLD].data_ptr(), h, w, 3,
                          out.data_ptr(), h, w, minv.data_ptr(), 0, 0.0,
                          _lib.stream_handle(dev)), name + "_old")
            return out

        def new_call(i=0, new=new, minv=minv):
            return new(cold[i % cs.N_COLD], minv, h, w, 0)
        same = torch.equal(old().clone(), new_call())
        print(f"{label} 1080p emit: old and new bit for bit {same}")
        assert same, label
        in_turns(f"{label} 1080p emit", ("old", old, ["warp_tile_kernel_old"],
                                          1),
                 ("new", new_call, ["warp_tile_kernel<"], 1))


ENHANCE_SHAPES = ((1080, 1920), (37, 53), (64, 96))
ENHANCE_GAMMAS = (0.9, 1.0, 1.2)


def enhance_ab(lib, dev):
    """K4's head and tail modes: another enhance.cu (its ``vs_enhance_head``
    and ``vs_enhance_tail`` renamed ``*_old``) against the checkout's, bit
    for bit, then in turns, at 1080x1920x3, (37, 53) and (64, 96): the
    head with and without white balance, the tail (gray on) at gamma 0.9,
    1.0 and 1.2 on the head's output through the unsharp mask, and at
    1080p on uniform values in [-20, 280] too; 16 inputs cycled (cold in
    L2 at 1080p). At 1080p also ``yardsticks``."""
    from video_stab_tpu_torch.core.params import EnhancerParams
    from video_stab_tpu_torch.kernels import enhance as kenh
    from video_stab_tpu_torch.ops.filters import unsharp_mask

    head_fn = lib.vs_enhance_head_old
    head_fn.argtypes = [_P, _P, ctypes.c_longlong, _P, _I, _F, _F, _P]
    tail_fn = lib.vs_enhance_tail_old
    tail_fn.argtypes = [_P, _P, _P, ctypes.c_longlong, _I, _F, _P]
    for h, w in ENHANCE_SHAPES:
        frame = torch.from_numpy(cs.make_frames(h, w, 1, seed=1)[0]).to(dev)
        frames = [torch.roll(frame, 17 * k, dims=1).contiguous()
                  for k in range(cs.N_COLD)]
        for wb in (False, True):
            ep = EnhancerParams(brightness=5.0, contrast=1.1,
                                enable_white_balance=wb, wb_strength=0.5)
            scales = kenh.white_balance_scales(frame, 0.5) if wb else None

            def old_head(i=0, ep=ep, scales=scales):
                src = frames[i % cs.N_COLD]
                out = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
                _lib.check(head_fn(src.data_ptr(), out.data_ptr(), h * w,
                                   scales.data_ptr() if wb else None, 1,
                                   ep.contrast, ep.brightness,
                                   _lib.stream_handle(dev)), "head_old")
                return out

            def new_head(i=0, ep=ep, scales=scales):
                return kenh.enhance_head_cuda(ep, frames[i % cs.N_COLD],
                                              scales)
            label = f"K4 head {h}x{w}x3 wb={wb}"
            same = torch.equal(old_head(), new_head())
            print(f"{label}: old and new bit for bit {same}")
            assert same, label
            in_turns(label, ("old", old_head, ["enhance_head_kernel_old"], 1),
                     ("new", new_head, ["enhance_head_kernel("], 1))
        head = kenh.enhance_head_cuda(EnhancerParams(brightness=5.0,
                                                     contrast=1.1), frame,
                                      None)
        x = unsharp_mask(head, 2.0, 1.0).contiguous()
        inputs = {"": x}
        if (h, w) == ENHANCE_SHAPES[0]:
            # Clipped values in most warps: powf's special cases diverge.
            inputs[" uniform [-20, 280]"] = torch.from_numpy(
                np.random.default_rng(5).uniform(-20.0, 280.0, (h, w, 3))
                .astype(np.float32)).to(dev)
            yardsticks(frames, [torch.roll(x, 17 * k, dims=1).contiguous()
                                for k in range(cs.N_COLD)])
        for (name, x), gamma in itertools.product(inputs.items(),
                                                  ENHANCE_GAMMAS):
            xs = [torch.roll(x, 17 * k, dims=1).contiguous()
                  for k in range(cs.N_COLD)]
            ep = EnhancerParams(gamma=gamma)
            do_gamma = int(abs(gamma - 1.0) > 1e-3)

            def old_tail(i=0, gamma=gamma, do_gamma=do_gamma, xs=xs):
                src = xs[i % cs.N_COLD]
                out = torch.empty((h, w, 3), dtype=torch.uint8, device=dev)
                gray = torch.empty((h, w), dtype=torch.float32, device=dev)
                _lib.check(tail_fn(src.data_ptr(), out.data_ptr(),
                                   gray.data_ptr(), h * w, do_gamma, gamma,
                                   _lib.stream_handle(dev)), "tail_old")
                return out, gray

            def new_tail(i=0, ep=ep, xs=xs):
                return kenh.enhance_tail_cuda(ep, xs[i % cs.N_COLD], True)
            label = f"K4 tail {h}x{w}x3{name} gamma={gamma}"
            (a, ga), (b, gb) = old_tail(), new_tail()
            same = torch.equal(a, b) and torch.equal(ga, gb)
            print(f"{label}: old and new bit for bit (u8 and gray) {same}")
            assert same, label
            in_turns(label, ("old", old_tail, ["enhance_tail_kernel_old"], 1),
                     ("new", new_tail, ["enhance_tail_kernel<"], 1))


def yardsticks(frames, xs):
    """Torch's own conversions at 1080p, the same bytes as K4's head
    (u8 -> f32) and as the tail's u8 without gray (f32 -> u8): what the
    card gives a one-call pass over those bytes."""
    for label, fn in (
            ("u8 -> f32 .float() (the head's bytes)",
             lambda i: frames[i % cs.N_COLD].float()),
            ("f32 -> u8 .to(torch.uint8) (the tail's bytes without gray)",
             lambda i: xs[i % cs.N_COLD].to(torch.uint8))):
        print(f"yardstick {label}: device "
              f"{cs.device_us(torch, fn, None):.3f} us")


# Traces per turn: the profiler now and then drops a trace's kernel
# records, and ``device_us`` traces again; a turn still unmeasured after
# these many fails the run.
TURN_ATTEMPTS = 8


def in_turns(label, old, new):
    """(name, fn, symbols, launches per call) of the old and the new
    kernel, timed old, new, new, old."""
    for name, fn, symbols, per_call in (old, new, new, old):
        us = cs.device_us(torch, fn, symbols, per_call,
                          attempts=TURN_ATTEMPTS)
        print(f"{label} {name}: device {us:.3f} us")


def lk_cycles(lib, n_points):
    buf = np.zeros((4096, 8), np.int64)
    fn = lib.vs_lk_cycles_cycles
    fn.argtypes = [_P]
    _lib.check(fn(buf.ctypes.data), "lk cycles")
    c = buf[:n_points]
    names = ["set-up", "templates", "newton", "err", "total", "steps",
             "patches staged again"]
    for k, name in enumerate(names):
        print(f"  K6 cycles, {name}: min {c[:, k].min()}, median "
              f"{np.median(c[:, k]):.0f}, max {c[:, k].max()}")
    per_step = c[:, 2] / np.maximum(c[:, 5], 1)
    print(f"  K6 newton cycles per step (a point's rounds' set-up "
          f"included): median {np.median(per_step):.0f}")
    for row in c[np.argsort(c[:, 4])[-5:]]:
        print("  K6 slowest points: " + ", ".join(
            f"{name} {v}" for name, v in zip(names, row)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-lk", type=Path)
    ap.add_argument("--old-features", type=Path)
    ap.add_argument("--old-traj", type=Path)
    ap.add_argument("--old-warp", type=Path)
    ap.add_argument("--old-enhance", type=Path)
    ap.add_argument("--old-features-launches", type=int, default=1,
                    help="kernel launches per call of the old K3")
    ap.add_argument("--cycles", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {cs.nvidia_smi()}")
    dev = torch.device("cuda", 0)
    _lib.library()
    sp, _, _, pts, mask, planes = cs.lk_inputs(torch, dev)
    geometry = (planes, pts, mask, sp.lk_window, sp.lk_iters)
    frame = torch.from_numpy(cs.make_frames(1080, 1920, 1, seed=1)[0]).to(dev)
    gray = cs.corner_input(torch, frame)

    def new_lk(eps):
        return lambda _i=0: klk.lk_levels_cuda(*planes, pts, mask, None,
                                               sp.lk_window, sp.lk_iters,
                                               eps, 1e-4)

    if args.old_traj:
        lib, kernels, _ = build_variant(args.old_traj, "_old")
        traj_ab(lib, kernels, dev)
    if args.old_warp:
        lib, _, _ = build_variant(args.old_warp, "_old")
        warp_ab(lib, dev)
    if args.old_enhance:
        lib, _, _ = build_variant(args.old_enhance, "_old")
        enhance_ab(lib, dev)
    if args.old_lk:
        lib, kernels, text = build_variant(args.old_lk, "_old")
        for eps in (0.03, 1e-6):
            old = lk_call(lib, "_old", text, *geometry, eps)
            want = klk.lk_levels_plain(*planes, pts, mask, None,
                                       sp.lk_window, sp.lk_iters, eps, 1e-4)
            cs.lk_agreement("old", [t.clone() for t in old()], want, eps)
            cs.lk_agreement("new", new_lk(eps)(), want, eps)
            in_turns(f"K6 eps={eps}", ("old", old, kernels, 1),
                     ("new", new_lk(eps), ["lk_track_kernel<"], 1))
    if args.old_features:
        lib, kernels, text = build_variant(args.old_features, "_old")
        old = corner_call(lib, "_old", gray)
        want = kfeat.corner_response_plain(gray)
        for name, got in (("old", old()), ("new",
                                            kfeat.corner_response_cuda(gray))):
            torch.cuda.synchronize()
            print(f"K3 {name}: max|resp - plain| "
                  f"{float((got[0] - want[0]).abs().max()):.3e}, "
                  f"{int((got[1] != want[1]).sum())} peak-mask differences")
        in_turns("K3", ("old", old, kernels, args.old_features_launches),
                 ("new", lambda _i=0: kfeat.corner_response_cuda(gray),
                  ["corner_strip_kernel("], 1))
    if args.cycles:
        lib, _, text = build_variant(_lib.CSRC / "lk.cu", "_cycles",
                                     ("-DVS_CYCLES",))
        for eps in (0.03, 1e-6):
            counted = lk_call(lib, "_cycles", text, *geometry, eps)
            for _ in range(3):
                counted()
            torch.cuda.synchronize()
            print(f"K6 eps={eps}, cycles of one launch over "
                  f"{pts.shape[0]} points:")
            lk_cycles(lib, pts.shape[0])
        lib, _, text = build_variant(_lib.CSRC / "features.cu", "_cycles",
                                     ("-DVS_CYCLES",))
        counted = corner_call(lib, "_cycles", gray)
        for _ in range(3):
            counted()
        torch.cuda.synchronize()
        buf = np.zeros((4096, 2), np.int64)
        lib.vs_corner_cycles_cycles.argtypes = [_P]
        _lib.check(lib.vs_corner_cycles_cycles(buf.ctypes.data), "K3 cycles")
        c = buf[buf[:, 1] > 0]
        print(f"K3 cycles of one launch over {len(c)} warps: requesting the "
              f"rows median {np.median(c[:, 0]):.0f}, the walk median "
              f"{np.median(c[:, 1]):.0f}, max {c[:, 1].max()}; a warp in "
              f"all median {np.median(c.sum(1)):.0f}, max {c.sum(1).max()}")
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    print(f"SM clock now, max: {clocks}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
