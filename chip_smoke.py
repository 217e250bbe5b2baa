#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure is an uncaught exception and a nonzero exit):

1. Environment: torch and CUDA versions, the card's name and power limit.
   Without a CUDA device the script exits 1 before printing any result.
2. Build: the hand-written kernels (video_stab_tpu_torch/csrc/, five
   sources, one nvcc each, started together) are compiled from the
   checkout's sources into build/torch_kernels/, and beside them, started
   at the same time, the empty kernel of csrc/launch_floor.cu, which only
   this script and tools/kernel_ab.py load.
3. Kernels against their plain PyTorch versions on the card, at the shapes
   the main paths give them: K1, K2, K4 and K5 bit for bit, K3 within
   1e-5, K6 (the LK Newton ladder: 540x960 analysis gray of a real frame
   pair, 3 levels, 200 GFTT corners) at the tolerance of the plain version
   against JAX (identical status; tracked positions within max(1e-3, eps)
   and >= 95 % within 1e-3 px; err within 1e-2 where positions agree; at
   eps = 0.03 and 1e-6), with the Newton steps each point ran against the
   plain version's count. Then, per kernel and shape: ``device_us``, the
   kernel's own time
   from ``torch.profiler`` (self CUDA time of its symbols over 64 launches,
   per launch; the emit warps and the enhancer cycle through 16 distinct
   1080p frames, so their input is cold in L2 as on the path);
   ``call_ms``, the wrapper's time per call over 64 back-to-back calls
   between CUDA events (host work included); the plain version's device
   time (every kernel it launches) and call time the same two ways;
   ``bound_us``, the larger of the bytes (each input read once, each
   output written once) over 3.35 TB/s and the float32 operations over
   67 TFLOP/s, with ``bound_share`` = bound / device time; for K5b its
   one-call yardstick, ``avg_pool1d``, timed the same two ways; for K5a
   and K5b, which one launch bounds, at (240, 3), (240, 9) and (18000, 3):
   ``launch_floor_us``, the device time of an empty kernel with the same
   grid, block and shared memory by the same profiler reading, with
   ``floor_share``, and the kernel launches of one call (K5a with the
   median ranked in its launch: 1); and for
   K6, which the latency of one point's dependent Newton steps bounds,
   ``latency_floor_us`` (the most steps a point ran times a stated
   per-step floor in cycles, plus the templates, at the SM clock
   ``nvidia-smi`` reads while K6 runs) with ``floor_share``.
4. The paths, each with the kernels' launch counters zeroed just before it
   and read just after (each kernel of the path must be > 0):
   a. ``ProcessingChain`` with exactly the ``__graft_entry__.entry()``
      parameters at 1920x1080 over 64 frames of textured content with a
      ~2 deg tilted horizon and per-frame jitter, then ``flush()``; output
      frames, the roll angle and the queue drain are checked (K1, K3, K4,
      K6);
   b. the streaming homography ``Stabilizer`` (smoothing_radius=15) at
      1920x1080 over 64 frames, then ``flush()`` (K2, K3, K6); its host
      reads per steady-state frame are counted with torch's sync debug
      mode;
   c. offline ``stabilize_clip`` at 1920x1080 over 32 frames, similarity +
      box (K1, K5b, K3, K6) and homography + box (K2, K5b, K3, K6);
   d. the streaming ``Stabilizer`` (smoothing_radius=15) at 1920x1080 over
      48 frames with each of the gaussian, kalman and butterworth
      smoothers and with ``drone_high_freq_mode`` (the HF chain and the
      conditional CLAHE), then ``flush()`` (K1, K3, K6): ms/frame over 16
      steady-state frames and the host reads of 8 more, which must all be
      the GFTT NMS's (the new branches add none).
5. Steady-state ms/frame of the chain, the bare ``Stabilizer`` and the
   homography ``Stabilizer`` at 1080p (CUDA events); offline frames/s of
   both models over 240 frames at 1080p with the analysis, smoothing and
   warp stages timed apart, with box and with the gaussian, kalman,
   butterworth and l1 smoothers (similarity; kalman for the homography
   model too), counters zeroed around each, and the l1 solve alone on a
   (240, 3) path: its ms and its kernel launches; where the time goes with LK's Newton ladder
   through its plain version and through K6, in turns (plain, kernel,
   kernel, plain) on each streaming path and offline: ms/frame, LK's
   ms/frame, kernel launches per frame and the device's busy share from
   ``torch.profiler``; and the CUDA runs against the CPU (plain) runs on a
   small input: the chain, the homography ``Stabilizer``, offline
   ``stabilize_clip`` of both models, and one streaming and one offline
   run of each new smoother (and the drone mode), all fed the same RANSAC
   draws.

Then one ``{"kernels": [...]}`` line: per kernel the phase-3 numbers, the
launches of each phase-4 path and its launches per frame. Its ``ms``,
``plain_ms`` and ``library_ms`` are device times, so they compare with one
another; ``call_ms``, ``plain_call_ms`` and ``library_call_ms`` are the
same calls' times with the host's work. The line before
last is the card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import json
import subprocess
import sys
import time

import numpy as np

N_FRAMES = 64
TIMED_FRAMES = 60
OFFLINE_SLICE_FRAMES = 32
OFFLINE_TIMED_FRAMES = 240
SEED = 0


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def start_launch_floor_build():
    """Start the nvcc of csrc/launch_floor.cu (the empty kernel behind
    ``launch_floor_us``) into a library of its own -> (process, path)."""
    from video_stab_tpu_torch.kernels import _lib
    out_dir = _lib.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "liblaunch_floor.so"
    cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o", str(lib),
           str(_lib.CSRC / "launch_floor.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def load_launch_floor(build):
    """Wait for the build; -> launch(blocks, threads, smem_bytes), which
    launches the empty kernel on PyTorch's current stream."""
    import ctypes

    import torch

    from video_stab_tpu_torch.kernels import _lib
    proc, path = build
    out = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on launch_floor.cu:\n{out}")
    fn = ctypes.CDLL(str(path)).vs_launch_floor
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(blocks: int, threads: int, smem_bytes: int) -> None:
        _lib.check(fn(blocks, threads, smem_bytes,
                      torch.cuda.current_stream().cuda_stream),
                   "launch_floor")
    return launch


def launches_of(torch, fn) -> int:
    """Kernel launches of one fn() call: the host's ``*LaunchKernel*`` calls
    in a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return kernel_counts(prof)[0]


def make_frames(h: int, w: int, n: int, seed: int = SEED) -> np.ndarray:
    """(n, h, w, 3) u8: a smooth random world seen through a jittering
    window (bench.py's _make_pool), with a ~2 deg tilted horizon edge
    composited in so the roll stage engages."""
    rng = np.random.default_rng(seed)
    pad = 32
    world = rng.random((h + 2 * pad, w + 2 * pad)).astype(np.float32)
    kern = np.exp(-0.5 * (np.arange(-6, 7) / 2.0) ** 2).astype(np.float32)
    kern /= kern.sum()
    world = np.apply_along_axis(
        lambda r: np.convolve(r, kern, mode="same"), 1, world)
    world = np.apply_along_axis(
        lambda c: np.convolve(c, kern, mode="same"), 0, world)
    world -= world.min()
    world /= max(world.max(), 1e-6)
    world = (world * 255.0).astype(np.uint8)
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    sky = (yy < (h / 2.0 + np.tan(np.radians(2.0)) * (xx - w / 2.0)))
    sky = (sky * 60.0).astype(np.float32)[:, :, None]
    frames = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        dx, dy = rng.integers(-8, 9, 2)
        f = world[pad + dy:pad + dy + h, pad + dx:pad + dx + w]
        bgr = np.stack([f, np.roll(f, 1, 0), 255 - f], axis=-1)
        frames[i] = np.clip(bgr * 0.75 + sky, 0, 255).astype(np.uint8)
    return frames


# The yardsticks of phase 3: the H100 SXM data sheet's rates (at 700 W).
HBM_BYTES_PER_S = 3.35e12        # device memory
F32_FLOPS_PER_S = 67e12          # float32 outside the tensor cores
N_CALLS = 64                     # calls per device-time and call-time sample
N_COLD = 16                      # distinct 1080p inputs cycled (> 50 MB L2)


def bound_us(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes (each
    input read once, each output written once) over the memory rate and
    the float32 operations over the peak rate, with which of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e6
    t_ops = flops / F32_FLOPS_PER_S * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_us(torch, fn, symbols, per_call: int = 1, n: int = N_CALLS,
              attempts: int = 3) -> float:
    """Device time per call from torch.profiler: the self CUDA time of the
    kernels whose names hold one of ``symbols`` over fn(0) .. fn(n - 1),
    divided by the number of such kernels the profiler recorded, times
    ``per_call`` (kernels per call). With ``symbols`` None: every kernel's
    time, divided by n. The profiler may drop a trace's kernel records, so
    a trace with no device time for them, or with fewer than half of the
    launches, is taken again; after ``attempts`` such traces it fails."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                fn(i)
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for ev in prof.key_averages():
            if "CUDA" not in str(ev.device_type):
                continue
            if symbols is None or any(s in ev.key for s in symbols):
                total += ev.self_device_time_total
                count += ev.count
        if total > 0.0 and (symbols is None or 2 * count >= per_call * n):
            return total / n if symbols is None else total / count * per_call
        print(f"profiler: {count} kernels, {total} us of device time for "
              f"{symbols} over {n} calls; tracing again")
    raise RuntimeError(f"profiler: no complete trace of {symbols} in "
                       f"{attempts} attempts")


def call_ms(torch, fn, n: int = N_CALLS) -> float:
    """ms per call of fn(i), n back-to-back calls between two CUDA events
    (host work included: this is the wrapper's time, not the kernel's)."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def timing(torch, label, kernel, plain, symbols, nbytes, flops,
           per_call: int = 1) -> dict:
    """Phase 3's numbers for one kernel at one shape, printed on one line."""
    dev = device_us(torch, kernel, symbols, per_call)
    row = dict(device_us=dev, call_ms=call_ms(torch, kernel),
               plain_device_us=device_us(torch, plain, None, n=16),
               plain_call_ms=call_ms(torch, plain, n=16))
    row["bound_us"], row["bound_by"] = bound_us(nbytes, flops)
    row["bound_share"] = row["bound_us"] / dev
    print(f"{label}: device {dev:.3f} us, plain {row['plain_device_us']:.3f}"
          f" us; wrapper call {row['call_ms']:.4f} ms, plain "
          f"{row['plain_call_ms']:.4f} ms; bound {row['bound_us']:.3f} us "
          f"({row['bound_by']}), bound_share {row['bound_share']:.3f}")
    return row


# float32 operations per output element, for the operation bound:
# coordinates (two rounded 3-term maps, K2 a third and two divides) and
# fractions per pixel, 9 per channel for the blend; K3's two Sobel
# stencils, three products, their 3x3 sums and the eigenvalue per pixel;
# K4's stages per value and the gray per pixel; K5's window sum per value.
WARP_FLOPS = {False: lambda c: 10 + 9 * c, True: lambda c: 15 + 9 * c}
CORNER_FLOPS = 55
ENHANCE_FLOPS_PER_VALUE, GRAY_FLOPS = 8, 5
WARP_LIBRARY = ("none: grid_sample needs affine_grid, float NCHW and a "
                "separate round, so it is not one call")


def corner_input(torch, frame):
    """K3's input at the main path's shape: a 1080p frame's mean gray at
    540x960, float32."""
    gray = frame.float().mean(dim=2)
    return torch.nn.functional.interpolate(
        gray[None, None], size=(540, 960), mode="bilinear",
        align_corners=False)[0, 0].contiguous()


def check_kernels(torch, dev, launch_floor) -> dict:
    """Phase 3: each kernel against its plain version at the path's shapes,
    then its device time, wrapper time, bound and yardstick."""
    from video_stab_tpu_torch.core.params import EnhancerParams
    from video_stab_tpu_torch.kernels import enhance as kenh
    from video_stab_tpu_torch.kernels import features as kfeat
    from video_stab_tpu_torch.kernels import warp as kwarp
    from video_stab_tpu_torch.ops.warp import (BORDER_CONSTANT,
                                               BORDER_REPLICATE,
                                               affine_coords, invert_affine,
                                               rotation_matrix_2d,
                                               sample_bilinear)

    results = {}
    frame = torch.from_numpy(make_frames(1080, 1920, 1, seed=1)[0]).to(dev)
    # The emit warp and the enhancer read a frame that is cold in L2: their
    # timed calls cycle through N_COLD distinct frames.
    cold = [torch.roll(frame, 17 * k, dims=1).contiguous()
            for k in range(N_COLD)]

    def rigid(ang_deg, tx, ty):
        a = np.radians(ang_deg)
        return torch.tensor([[np.cos(a), -np.sin(a), tx],
                             [np.sin(a), np.cos(a), ty]],
                            dtype=torch.float32).to(dev)

    def row3(m):
        return torch.cat([m, torch.tensor([[0.0, 0.0, 1.0]]).to(dev)])

    roll = rotation_matrix_2d(960.0, 540.0,
                              torch.tensor(2.0).to(dev))
    gray540 = corner_input(torch, frame)
    gray540_u8 = torch.clamp(torch.round(gray540), 0, 255).to(
        torch.uint8).contiguous()
    a_roll = rotation_matrix_2d(480.0, 270.0, torch.tensor(2.0).to(dev))
    warp_cases = [
        ("emit 1080x1920x3 constant", frame,
         rigid(0.3, 3.2, -1.7), BORDER_CONSTANT),
        ("emit+2deg roll 1080x1920x3 constant", frame,
         (row3(rigid(0.3, 3.2, -1.7)) @ row3(roll))[:2], BORDER_CONSTANT),
        ("analysis gray 540x960x1 replicate", gray540_u8[:, :, None]
         .contiguous(), a_roll, BORDER_REPLICATE),
    ]
    err_k1 = 0
    k1 = {"max_abs_err": 0.0, "cases": {}}
    for name, img, m, mode in warp_cases:
        h, w = img.shape[:2]
        ch = img.shape[2]
        minv = invert_affine(m).reshape(6).contiguous()
        got = kwarp.warp_affine_u8_cuda(img, minv, h, w, mode)
        want = kwarp.warp_affine_u8_plain(img, minv, h, w, mode)
        torch.cuda.synchronize()
        d = (got.int() - want.int()).abs()
        sx, sy = affine_coords(minv.reshape(2, 3), h, w)
        v = sample_bilinear(img, sx, sy, mode)
        ties = (v - torch.floor(v) - 0.5).abs() < 1e-3
        bad = int(((d > 0) & ~ties.reshape(d.shape)).sum())
        err = int(d.max())
        print(f"K1 {name}: max|kernel-plain| {err}, "
              f"{int((d > 0).sum())} differing px, {bad} away from a .5 tie")
        assert err == 0 and torch.equal(got, want), name
        err_k1 = max(err_k1, err)
        srcs = cold if name.startswith("emit") else [img]
        k1["cases"][name] = timing(
            torch, f"K1 {name}",
            lambda i: kwarp.warp_affine_u8_cuda(srcs[i % len(srcs)], minv,
                                                h, w, mode),
            lambda i: kwarp.warp_affine_u8_plain(srcs[i % len(srcs)], minv,
                                                 h, w, mode),
            ["warp_tile_kernel"], 2 * h * w * ch,
            h * w * WARP_FLOPS[False](ch))
    # The row's numbers are the chain's emit warp (with the roll).
    k1.update(k1["cases"]["emit+2deg roll 1080x1920x3 constant"])
    k1["max_abs_err"] = float(err_k1)
    k1["library"] = WARP_LIBRARY
    results["warp_affine_u8"] = k1

    resp, peak = kfeat.corner_response_cuda(gray540)
    p_resp, p_peak = kfeat.corner_response_plain(gray540)
    torch.cuda.synchronize()
    err_k3 = float((resp - p_resp).abs().max())
    n_peak = int((peak != p_peak).sum())
    print(f"K3 corner_response 540x960: max|resp diff| {err_k3:.3e}, "
          f"{n_peak} peak-mask differences")
    assert err_k3 <= 1e-5 and n_peak == 0
    k3 = timing(torch, "K3 corner_response 540x960",
                lambda i: kfeat.corner_response_cuda(gray540),
                lambda i: kfeat.corner_response_plain(gray540),
                ["corner_strip_kernel"], 540 * 960 * (4 + 4 + 1),
                540 * 960 * CORNER_FLOPS)
    k3.update(max_abs_err=err_k3, library="none: no single call computes "
              "the min-eigenvalue response")
    results["corner_response"] = k3

    ep = EnhancerParams(brightness=5.0, contrast=1.1, gamma=0.9)
    out, g = kenh.enhance_u8_cuda(ep, frame, None, want_gray=True)
    p_out, p_g = kenh.enhance_u8_plain(ep, frame, None, want_gray=True)
    torch.cuda.synchronize()
    d = (out.int() - p_out.int()).abs()
    same = float((d == 0).float().mean())
    err_g = float((g - p_g).abs().max())
    print(f"K4 enhance_u8 1080x1920x3: max|u8 diff| {int(d.max())}, "
          f"{same * 100:.4f}% identical, max|gray diff| {err_g:.3e}")
    assert int(d.max()) <= 1 and same >= 0.999 and err_g <= 1e-3
    assert torch.equal(out, p_out) and torch.equal(g, p_g)
    n_px = 1080 * 1920
    k4 = timing(torch, "K4 enhance_u8 1080x1920x3 with gray",
                lambda i: kenh.enhance_u8_cuda(ep, cold[i % N_COLD], None,
                                               True),
                lambda i: kenh.enhance_u8_plain(ep, cold[i % N_COLD], None,
                                                True),
                ["enhance_table_kernel"], n_px * (3 + 3 + 4),
                n_px * (3 * ENHANCE_FLOPS_PER_VALUE + GRAY_FLOPS))
    k4.update(max_abs_err=float(d.max()),
              library="none: the pointwise chain is several calls")
    results["enhance_u8"] = k4
    results.update(check_new_kernels(torch, dev, frame, cold, launch_floor))
    results.update(check_lk(torch, dev))
    return results


def check_new_kernels(torch, dev, frame, cold, launch_floor) -> dict:
    """Phase 3, K2 / K5a / K5b: bit for bit against the plain versions;
    K5b also against its one-call yardstick, ``avg_pool1d``; K5a and K5b
    against ``launch_floor_us``, an empty kernel with their launch
    configuration."""
    import torch.nn.functional as F

    from video_stab_tpu_torch.kernels import traj as ktraj
    from video_stab_tpu_torch.kernels import warp as kwarp
    from video_stab_tpu_torch.ops.warp import invert_homography

    results = {}
    ang = np.radians(0.4)
    h_stab = torch.tensor([[np.cos(ang), -np.sin(ang), 2.1],
                           [np.sin(ang), np.cos(ang), -1.3],
                           [3e-5, -2e-5, 1.0]], dtype=torch.float32).to(dev)
    hinv = invert_homography(h_stab).reshape(9).contiguous()
    got = kwarp.warp_homography_u8_cuda(frame, hinv, 1080, 1920)
    want = kwarp.warp_homography_u8_plain(frame, hinv, 1080, 1920)
    torch.cuda.synchronize()
    d = (got.int() - want.int()).abs()
    err = int(d.max())
    print(f"K2 warp_homography_u8 1080x1920x3 constant: max|kernel-plain| "
          f"{err}, {int((d > 0).sum())} differing px")
    assert err == 0 and torch.equal(got, want)
    k2 = timing(torch, "K2 warp_homography_u8 1080x1920x3",
                lambda i: kwarp.warp_homography_u8_cuda(cold[i % N_COLD],
                                                        hinv, 1080, 1920),
                lambda i: kwarp.warp_homography_u8_plain(cold[i % N_COLD],
                                                         hinv, 1080, 1920),
                ["warp_tile_kernel"], 2 * 1080 * 1920 * 3,
                1080 * 1920 * WARP_FLOPS[True](3))
    k2.update(max_abs_err=float(err), library=WARP_LIBRARY)
    results["warp_homography_u8"] = k2

    rng = np.random.default_rng(7)

    def path(c, n=240):
        return torch.from_numpy(np.cumsum(rng.normal(0, 1, (n, c)), axis=0)
                                .astype(np.float32)).to(dev)

    centered = ("box_filter_centered", ktraj.box_filter_centered_cuda,
                ktraj.box_filter_centered_plain)
    convolve = ("box_filter_convolve", ktraj.box_filter_convolve_cuda,
                ktraj.box_filter_convolve_plain)
    # Each row's headline numbers are its first shape's; (18000, 3) is a
    # ten-minute clip's path, above K5a's in-kernel median limit.
    k5 = [(*centered, path(3), 15), (*centered, path(9), 15),
          (*convolve, path(3), 8), (*convolve, path(9), 8),
          (*centered, path(3, 18000), 15), (*convolve, path(3, 18000), 8)]
    ktraj.CONVOLVE_LAUNCHES = 0
    for name, cuda_fn, plain_fn, p, r in k5:
        got, want = cuda_fn(p, r), plain_fn(p, r)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        shape = f"({p.shape[0]}, {p.shape[1]}) r={r}"
        print(f"{name} {shape}: max|kernel-plain| {err:.3e}, "
              f"bit-exact {bool(torch.equal(got, want))}")
        assert torch.equal(got, want), name
        window = 2 * r + 1 if name == "box_filter_centered" else r
        t = timing(torch, f"{name} {shape}", lambda i: cuda_fn(p, r),
                   lambda i: plain_fn(p, r),
                   ["box_window_kernel", "box_median_kernel"],
                   4 * (2 * p.numel() + p.shape[1]), p.numel() * (window + 3))
        t["shape"] = shape
        # The launch floor: an empty kernel with this launch's grid, block
        # and shared memory, read by the same device_us.
        median = name == "box_filter_convolve" and \
            ktraj.median_in_kernel(p.shape[0])
        blocks, threads, _, smem = ktraj.launch_config(
            p.shape[0], p.shape[1], window, median)
        t["launch_floor_us"] = device_us(
            torch, lambda i: launch_floor(blocks, threads, smem),
            ["launch_floor_kernel"])
        t["floor_share"] = t["launch_floor_us"] / t["device_us"]
        t["launch"] = {"blocks": blocks, "threads": threads,
                       "smem_bytes": smem, "median_in_kernel": median}
        before = ktraj.CONVOLVE_LAUNCHES
        t["launches_per_call"] = launches_of(torch, lambda: cuda_fn(p, r))
        if name == "box_filter_convolve":
            assert ktraj.CONVOLVE_LAUNCHES == before + 2, name
        print(f"{name} {shape}: launch floor {t['launch_floor_us']:.3f} us "
              f"({blocks} blocks x {threads} threads, {smem} B shared), "
              f"floor_share {t['floor_share']:.3f}; kernel launches per "
              f"call {t['launches_per_call']}"
              + (" (median ranked in the kernel)" if median else ""))
        assert t["launches_per_call"] == 1 or not (
            median or name == "box_filter_centered"), t
        row = results.setdefault(name, dict(t, max_abs_err=err, shapes=[]))
        row["shapes"].append(t)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if name == "box_filter_centered" and p.shape[1] == 3:
            # The yardstick: one PyTorch call with the same centered,
            # count-normalized mean; the port never calls it.
            def pool(i, p=p, r=r):
                return F.avg_pool1d(p.t()[None], 2 * r + 1, stride=1,
                                    padding=r, count_include_pad=False)
            lib_err = float((pool(0)[0].t() - got).abs().max())
            row["library"] = "torch.nn.functional.avg_pool1d"
            row["library_device_us"] = device_us(torch, pool, None)
            row["library_call_ms"] = call_ms(torch, pool)
            row["library_max_abs_diff"] = lib_err
            print(f"{name} {shape}: avg_pool1d device "
                  f"{row['library_device_us']:.3f} us, call "
                  f"{row['library_call_ms']:.4f} ms; max|avg_pool1d - "
                  f"kernel| {lib_err:.3e}")
    results["box_filter_convolve"]["library"] = \
        "none: the median pad needs a sort"
    # K5a has no production caller: its launch count is phase 3's.
    results["box_filter_convolve"]["phase3_launches"] = \
        ktraj.CONVOLVE_LAUNCHES
    return results


# K6's float32 operations per window pixel: three bilinear blends (9 each)
# and G's three products and sums per template pixel and level; per Newton
# step the blend, the residual and b's two products and sums.
LK_TEMPLATE_FLOPS, LK_STEP_FLOPS = 33, 14

# K6's latency yardstick. A point's Newton steps are a dependent chain, so
# the launch cannot end before its slowest point has run its steps one
# after the other. Assumed latencies in SM cycles (Hopper: a shared-memory
# read ~30, a dependent float32 operation ~4, a warp shuffle ~24, a block
# barrier ~20, a read that hits L2 ~270). One step: the window offsets
# from the position (8 dependent operations), one slab read, the blend
# (4), the residual, product and sum (3), a 5-level shuffle tree (shuffle
# + add each), the partials' exchange (barrier + read) and their 3 adds,
# the 2x2 solve (2) and the move (1). One template: an L2 read, a staged
# read, the blend (4), G's product and sum (2), the tree, the exchange and
# its adds, and the inverse (a square root and two divides, ~60).
LK_CYCLES = dict(smem=30, op=4, shuffle=24, barrier=20, l2=270)
LK_TREE_CYCLES = 5 * (LK_CYCLES["shuffle"] + LK_CYCLES["op"])
LK_EXCHANGE_CYCLES = (LK_CYCLES["barrier"] + LK_CYCLES["smem"]
                      + 3 * LK_CYCLES["op"])
LK_STEP_FLOOR_CYCLES = (LK_CYCLES["smem"] + (8 + 4 + 3 + 2 + 1)
                        * LK_CYCLES["op"] + LK_TREE_CYCLES
                        + LK_EXCHANGE_CYCLES)
LK_TEMPLATE_FLOOR_CYCLES = (LK_CYCLES["l2"] + LK_CYCLES["smem"]
                            + (4 + 2) * LK_CYCLES["op"] + LK_TREE_CYCLES
                            + LK_EXCHANGE_CYCLES + 60)


def sm_clock_mhz(torch, fn, seconds: float = 1.0) -> float:
    """The SM clock ``nvidia-smi`` reads while another thread calls fn(i)
    back to back (an idle card reads a lower clock)."""
    import threading
    stop = threading.Event()

    def load():
        i = 0
        while not stop.is_set():
            fn(i)
            i += 1

    worker = threading.Thread(target=load)
    worker.start()
    try:
        time.sleep(seconds / 2)
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits"], capture_output=True, text=True, timeout=60,
            check=True)
    finally:
        stop.set()
        worker.join()
        torch.cuda.synchronize()
    return float(proc.stdout.strip().splitlines()[0])


def lk_steps_report(label, got_steps, want_steps, got, want, budget) -> dict:
    """K6's Newton steps per point against the plain version's count: the
    distribution, and how many points whose positions agree within 1e-3 px
    ran another number of steps (one step apart happens at the eps freeze,
    where |d|^2 sits at eps^2; it is reported, not failed)."""
    k = got_steps.cpu().numpy().astype(int)
    p = want_steps.cpu().numpy().astype(int)
    same_pos = ((got[0] - want[0]).abs().max(dim=1).values < 1e-3) \
        .cpu().numpy()
    diff = np.abs(k - p)[same_pos]
    row = {"min": int(k.min()), "median": float(np.median(k)),
           "p90": float(np.percentile(k, 90)), "max": int(k.max()),
           "mean": float(k.mean()), "budget": budget,
           "share_full_budget": float((k == budget).mean()),
           "equal_to_plain": int((diff == 0).sum()),
           "one_step_apart": int((diff == 1).sum()),
           "further_apart": int((diff > 1).sum()),
           "points_compared": int(same_pos.sum())}
    print(f"K6 {label}: Newton steps per point min {row['min']}, median "
          f"{row['median']:.1f}, p90 {row['p90']:.1f}, max {row['max']} of a "
          f"budget of {budget} ({row['share_full_budget'] * 100:.1f}% of "
          f"points ran it all); against the plain count over "
          f"{row['points_compared']} points with equal positions: "
          f"{row['equal_to_plain']} equal, {row['one_step_apart']} one step "
          f"apart, {row['further_apart']} further")
    assert k.min() >= 0 and k.max() <= budget, (k.min(), k.max(), budget)
    return row


def lk_agreement(label, got, want, eps) -> dict:
    """K6 against the plain version at the plain version's tolerance
    against JAX (tests/test_torch_ops.py::test_lk_track); a status flip
    (lvl_ok at the min-eig threshold) is reported and fails."""
    status = want[1].cpu().numpy()
    flips = int((got[1].cpu().numpy() != status).sum())
    d = (got[0] - want[0]).abs().max(dim=1).values.cpu().numpy()
    same = d < 1e-3
    err_d = (got[2] - want[2]).abs().cpu().numpy()[same]
    row = {"tracked": int(status.sum()), "status_flips": flips,
           "max_abs_err": float(d[status].max()),
           "within_1e-3": float(same[status].mean()),
           "err_max_abs_diff": float(err_d.max()) if err_d.size else 0.0}
    print(f"K6 {label} eps={eps}: {row['tracked']} of {len(status)} points "
          f"tracked, {flips} status flips; tracked positions max|kernel-"
          f"plain| {row['max_abs_err']:.3e} px, "
          f"{row['within_1e-3'] * 100:.2f}% within 1e-3 px; err max diff "
          f"{row['err_max_abs_diff']:.3e}")
    assert flips == 0, label
    assert row["max_abs_err"] <= max(1e-3, eps), label
    assert row["within_1e-3"] >= 0.95 and row["err_max_abs_diff"] <= 1e-2
    return row


def lk_inputs(torch, dev):
    """K6's inputs at the main path's shape: a 1080p frame pair as 540x960
    analysis gray, the re-detect's 200 GFTT corners, the planes of 3
    levels. -> (params, prev, curr, pts, mask, (prev_planes, curr_planes))"""
    from video_stab_tpu_torch.core.params import StabilizerParams
    from video_stab_tpu_torch.core.stabilizer import (_analysis_gray,
                                                      _detect_features)
    from video_stab_tpu_torch.ops.lk import lk_planes

    sp = StabilizerParams()
    pair = torch.from_numpy(make_frames(1080, 1920, 2, seed=5)).to(dev)
    prev, curr = (_analysis_gray(sp, f.float()) for f in pair)
    pts, mask = _detect_features(sp, prev, redetect=True)
    assert int(mask.sum()) == sp.max_corners, int(mask.sum())
    return sp, prev, curr, pts, mask, lk_planes(prev, curr, sp.lk_levels)


def check_lk(torch, dev) -> dict:
    """Phase 3, K6: the LK Newton ladder at the main path's shape (3
    levels, 200 points) against lk_levels_plain on the same planes."""
    from video_stab_tpu_torch.kernels import lk as klk

    sp, prev, curr, pts, mask, planes = lk_inputs(torch, dev)
    args = (pts, mask, None, sp.lk_window, sp.lk_iters)
    label = (f"lk_track {prev.shape[0]}x{prev.shape[1]} "
             f"{sp.lk_levels + 1} levels {int(mask.sum())} points")
    rows = {}
    steps = {}
    levels = sp.lk_levels + 1
    # The step budget: lk_iters rounded up to whole rounds at each level
    # (4 rounds at the top level, 2 below).
    budget = (4 * -(-sp.lk_iters // 4)
              + (levels - 1) * 2 * -(-sp.lk_iters // 2))
    for eps in (1e-6, 0.03):
        k_steps, p_steps = (torch.empty(pts.shape[0], dtype=torch.int32,
                                        device=dev) for _ in range(2))
        got = klk.lk_levels_cuda(*planes, *args, eps, 1e-4, steps=k_steps)
        want = klk.lk_levels_plain(*planes, *args, eps, 1e-4, steps=p_steps)
        torch.cuda.synchronize()
        rows[eps] = lk_agreement(label, got, want, eps)
        steps[eps] = lk_steps_report(f"{label} eps={eps}", k_steps, p_steps,
                                     got, want, budget)
    n, win2 = pts.shape[0], (sp.lk_window + 1) ** 2
    npix = sp.lk_window ** 2
    # Bytes: per point and level the template's footprint in the three
    # prev planes and one search window's in curr; points, mask, outputs.
    nbytes = n * (levels * 4 * win2 * 4 + 8 + 1 + 8 + 1 + 4)
    # Operations: the templates and the Newton steps this run's points ran.
    flops = npix * (n * levels * LK_TEMPLATE_FLOPS
                    + steps[0.03]["mean"] * n * LK_STEP_FLOPS)
    k6 = timing(torch, f"K6 {label}",
                lambda i: klk.lk_levels_cuda(*planes, *args, 0.03, 1e-4),
                lambda i: klk.lk_levels_plain(*planes, *args, 0.03, 1e-4),
                ["lk_track_kernel"], nbytes, flops)
    # The second yardstick, one that can be approached: the slowest point's
    # dependent steps and the templates, at the clock the card runs K6 at.
    clock = sm_clock_mhz(
        torch, lambda i: klk.lk_levels_cuda(*planes, *args, 0.03, 1e-4))
    floor_cycles = (steps[0.03]["max"] * LK_STEP_FLOOR_CYCLES
                    + levels * LK_TEMPLATE_FLOOR_CYCLES)
    k6["sm_clock_mhz"] = clock
    k6["latency_floor_us"] = floor_cycles / clock
    k6["floor_share"] = k6["latency_floor_us"] / k6["device_us"]
    k6["step_floor_cycles"] = LK_STEP_FLOOR_CYCLES
    k6["template_floor_cycles"] = LK_TEMPLATE_FLOOR_CYCLES
    print(f"K6 {label}: latency floor {k6['latency_floor_us']:.3f} us "
          f"({steps[0.03]['max']} steps x {LK_STEP_FLOOR_CYCLES} cycles + "
          f"{levels} templates x {LK_TEMPLATE_FLOOR_CYCLES} cycles at "
          f"{clock:.0f} MHz), floor_share {k6['floor_share']:.3f}")
    k6.update(rows[0.03], shape=label, eps_1e_6=rows[1e-6],
              steps=steps[0.03], steps_eps_1e_6=steps[1e-6],
              library="none: no PyTorch call computes LK",
              lk_track_launches=lk_track_launches(torch, prev, curr, pts,
                                                  mask))
    return {"lk_track": k6}


def lk_track_launches(torch, prev, curr, pts, mask) -> dict:
    """Kernel launches of one ``lk_track`` call (pyramids, Scharr, bfloat16
    casts and the ladder) with the ladder through K6 and through its plain
    version, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from video_stab_tpu_torch.kernels import lk as klk
    from video_stab_tpu_torch.ops import lk as tlk

    counts = {}
    for name, ladder in (("kernel", klk.lk_levels),
                         ("plain", klk.lk_levels_plain)):
        tlk.lk_levels = ladder
        try:
            tlk.lk_track(prev, curr, pts, mask)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                tlk.lk_track(prev, curr, pts, mask)
                torch.cuda.synchronize()
        finally:
            tlk.lk_levels = klk.lk_levels
        launches, records, _ = kernel_counts(prof)
        counts[name] = {"launches": launches, "kernel_records": records}
    print(f"lk_track launches per call: K6 route {counts['kernel']}, plain "
          f"route {counts['plain']}")
    return counts


def entry_params():
    from video_stab_tpu_torch.core.params import (EnhancerParams, ModeParams,
                                                  RollCorrectionParams,
                                                  StabilizerParams)
    return dict(
        mode=ModeParams(enhancer_enabled=True, roll_correction_enabled=True,
                        stabilizer_enabled=True),
        enhancer=EnhancerParams(brightness=5.0, contrast=1.1, gamma=0.9),
        roll=RollCorrectionParams(),
        stabilizer=StabilizerParams(smoothing_radius=15))


def run_slice(torch, dev, pool) -> dict:
    """Phase 4: the entry() chain at 1080p, counters zeroed around it."""
    from video_stab_tpu_torch.core.chain import ProcessingChain
    from video_stab_tpu_torch.ops import features as tfeat

    chain = ProcessingChain(**entry_params())
    radius = chain.params.stabilizer.effective_radius
    zero_counts()
    syncs0 = tfeat.NMS_SYNCS
    outs = []
    for i in range(N_FRAMES):
        out = chain.process_device(pool[i])
        if out is not None:
            outs.append((i, out))
    torch.cuda.synchronize()
    launches = {name: n for name, n in read_counts().items()
                if name in ("warp_affine_u8", "corner_response",
                            "enhance_u8", "lk_track")}
    nms_syncs = tfeat.NMS_SYNCS - syncs0
    print(f"slice: launches during the main path {launches}")
    print(f"slice: NMS host reads {nms_syncs} over {N_FRAMES} frames "
          f"({N_FRAMES // 2 + 1} GFTT runs)")
    assert all(n > 0 for n in launches.values()), launches

    assert outs and outs[0][0] == radius - 1, [i for i, _ in outs[:3]]
    assert len(outs) == N_FRAMES - radius + 1, len(outs)
    for _, out in outs:
        assert out.shape == (1080, 1920, 3) and out.dtype == torch.uint8
    angle = float(chain.state.roll.smoothed_angle)
    print(f"slice: smoothed roll angle after {N_FRAMES} frames {angle:.6f} deg")
    assert np.isfinite(angle) and abs(angle) > 0.1, angle
    last = outs[-1][1].float()
    print(f"slice: last emitted frame mean {float(last.mean()):.3f}, "
          f"std {float(last.std()):.3f}")
    assert float(last.std()) > 5.0
    flushed = 0
    while True:
        f = chain.flush()
        if f is None:
            break
        assert f.shape == (1080, 1920, 3) and f.dtype == np.uint8
        flushed += 1
    assert flushed == N_FRAMES - len(outs), (flushed, len(outs))
    print(f"slice: {len(outs)} frames emitted in stream, {flushed} by flush()")
    return launches


def kernel_modules():
    from video_stab_tpu_torch.kernels import enhance as kenh
    from video_stab_tpu_torch.kernels import features as kfeat
    from video_stab_tpu_torch.kernels import lk as klk
    from video_stab_tpu_torch.kernels import traj as ktraj
    from video_stab_tpu_torch.kernels import warp as kwarp
    return {"warp_affine_u8": (kwarp, "LAUNCHES"),
            "warp_homography_u8": (kwarp, "HOMOGRAPHY_LAUNCHES"),
            "corner_response": (kfeat, "LAUNCHES"),
            "enhance_u8": (kenh, "LAUNCHES"),
            "box_filter_convolve": (ktraj, "CONVOLVE_LAUNCHES"),
            "box_filter_centered": (ktraj, "CENTERED_LAUNCHES"),
            "lk_track": (klk, "LAUNCHES")}


def zero_counts() -> None:
    for mod, attr in kernel_modules().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in kernel_modules().items()}


def homography_params(**kw):
    from video_stab_tpu_torch.core.params import StabilizerParams
    return StabilizerParams(smoothing_radius=15, motion_model="homography",
                            **kw)


def run_homography_stream(torch, dev, pool) -> dict:
    """Phase 4b: the streaming homography Stabilizer at 1080p, counters
    zeroed around it; then the host reads of 8 steady-state frames."""
    from video_stab_tpu_torch.core.params import ModeParams
    from video_stab_tpu_torch.core.stabilizer import Stabilizer

    stab = Stabilizer(homography_params(), mode=ModeParams())
    radius = stab.params.effective_radius
    zero_counts()
    outs = []
    for i in range(N_FRAMES):
        out = stab.stabilize_device(pool[i])
        if out is not None:
            outs.append(out)
    flushed = []
    while (f := stab.flush()) is not None:
        flushed.append(f)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"homography stream: launches {launches}")
    assert launches["warp_homography_u8"] > 0 and \
        launches["corner_response"] > 0 and launches["lk_track"] > 0, \
        launches
    assert len(outs) == N_FRAMES - radius + 1, len(outs)
    assert len(flushed) == radius - 1, len(flushed)
    for out in outs:
        assert out.shape == pool.shape[1:] and out.dtype == torch.uint8
    for f in flushed:
        assert f.shape == pool.shape[1:] and f.dtype == np.uint8
    st = stab.state_dict()
    n = int(st["n_path"])
    ring = st["path_ring"][:n]
    assert ring.shape == (n, 9) and np.isfinite(ring).all(), ring.shape
    print(f"homography stream: {len(outs)} frames emitted in stream, "
          f"{len(flushed)} by flush(); last log-path |max| "
          f"{float(np.abs(ring[-1]).max()):.4f}; envelope_exceeded "
          f"{int(st['envelope_exceeded'])}")

    # Host reads per steady-state frame: torch's sync debug mode warns on
    # every synchronizing call; the library's own counters say which.
    stab = Stabilizer(homography_params(), mode=ModeParams())
    for i in range(24):
        stab.stabilize_device(pool[i])
    by_line, n_syncs, nms = count_syncs(
        torch, "homography stream", stab.stabilize_device, pool[24:32])
    # The package's reads: the NMS flag (ops/features.py) and the eigh /
    # matrix_exp of motion/homography.py, nothing else.
    n_feat = sum(n for k, n in by_line.items() if k.startswith("ops/features"))
    n_hom = sum(n for k, n in by_line.items()
                if k.startswith("motion/homography"))
    assert n_feat == nms and n_feat + n_hom == n_syncs, by_line
    return launches


def count_syncs(torch, label, step, frames):
    """The synchronizing calls of step(frame) over ``frames``, by torch's
    sync debug mode -> (the package's, by file:line; their number; the
    GFTT NMS reads the library counted itself)."""
    import warnings

    from video_stab_tpu_torch.ops import features as tfeat

    torch.cuda.synchronize()
    nms0 = tfeat.NMS_SYNCS
    n_win = len(frames)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for f in frames:
                step(f)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # A warning is attributed to the Python line that called the op: the
    # path's are the package's lines; others (torch's own frames) are
    # printed below.
    syncs = [w for w in caught if "synchroniz" in str(w.message)
             and "video_stab_tpu_torch" in w.filename]
    nms = tfeat.NMS_SYNCS - nms0
    by_line = collections.Counter(
        f"{w.filename.split('video_stab_tpu_torch/')[-1]}:{w.lineno}"
        for w in syncs)
    print(f"{label}: {len(syncs)} synchronizing calls over "
          f"{n_win} steady-state frames ({len(syncs) / n_win:.2f}/frame); "
          f"the GFTT NMS reads counted by the library: {nms}")
    for where, n in sorted(by_line.items()):
        print(f"  {n} at video_stab_tpu_torch/{where}")
    for w in caught:
        if "synchroniz" in str(w.message) and \
                "video_stab_tpu_torch" not in w.filename:
            print(f"  other synchronizing call at {w.filename}:{w.lineno}")
    return by_line, len(syncs), nms


SMOOTHER_FRAMES, SMOOTHER_WARM, SMOOTHER_TIMED = 48, 24, 16
STREAM_SMOOTHERS = {
    "gaussian": dict(smoothing_method="gaussian"),
    "kalman": dict(smoothing_method="kalman"),
    "butterworth": dict(smoothing_method="butterworth"),
    "drone": dict(drone_high_freq_mode=True),
}


def run_smoother_streams(torch, dev, pool) -> dict:
    """Phase 4d: the streaming Stabilizer at 1080p with each of the other
    smoothers and with the drone high-frequency mode, counters zeroed
    around each: SMOOTHER_WARM frames, SMOOTHER_TIMED timed by CUDA events,
    the rest under the sync debug mode, then flush()."""
    from video_stab_tpu_torch.core.params import ModeParams, StabilizerParams
    from video_stab_tpu_torch.core.stabilizer import Stabilizer

    by_path = {}
    for name, kw in STREAM_SMOOTHERS.items():
        label = f"stream {name}"
        stab = Stabilizer(StabilizerParams(smoothing_radius=15, **kw),
                          mode=ModeParams())
        radius = stab.params.effective_radius
        zero_counts()
        outs = [stab.stabilize_device(pool[i]) for i in range(SMOOTHER_WARM)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        timed_to = SMOOTHER_WARM + SMOOTHER_TIMED
        outs += [stab.stabilize_device(pool[i])
                 for i in range(SMOOTHER_WARM, timed_to)]
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / SMOOTHER_TIMED
        window = pool[timed_to:SMOOTHER_FRAMES]
        by_line, n_syncs, nms = count_syncs(
            torch, label, lambda f: outs.append(stab.stabilize_device(f)),
            window)
        flushed = []
        while (f := stab.flush()) is not None:
            flushed.append(f)
        torch.cuda.synchronize()
        launches = read_counts()
        print(f"{label} 1080p: {ms:.3f} ms/frame over {SMOOTHER_TIMED} "
              f"steady-state frames (CUDA events); launches {launches}")
        assert launches["warp_affine_u8"] > 0 and \
            launches["corner_response"] > 0 and launches["lk_track"] > 0, \
            launches
        # The new branches read nothing back: every synchronizing call of
        # the package is the GFTT NMS's.
        n_feat = sum(n for k, n in by_line.items()
                     if k.startswith("ops/features"))
        assert n_feat == nms == n_syncs, (label, by_line)
        outs = [o for o in outs if o is not None]
        assert len(outs) == SMOOTHER_FRAMES - radius + 1, len(outs)
        assert len(flushed) == radius - 1, len(flushed)
        for out in outs:
            assert out.shape == pool.shape[1:] and out.dtype == torch.uint8
        st = stab.state_dict()
        for key in ("kalman_x", "kalman_p", "butter_state", "path_ring"):
            assert np.isfinite(st[key]).all(), (label, key)
        assert all(np.isfinite(np.asarray(v, np.float64)).all()
                   for v in st["hf"]), label
        std = float(outs[-1].float().std())
        print(f"{label}: {len(outs)} frames emitted in stream, "
              f"{len(flushed)} by flush(); last frame std {std:.3f}; hf "
              f"pushes {int(st['hf'].n_history)}, starvation counter "
              f"{int(st['starvation_counter'])}, envelope_exceeded "
              f"{int(st['envelope_exceeded'])}")
        assert std > 5.0
        assert int(st["hf"].n_history) == \
            (SMOOTHER_FRAMES - 1 if name == "drone" else 0)
        by_path[label] = launches
    return by_path


def run_offline(torch, dev, pool) -> dict:
    """Phase 4c: offline stabilize_clip at 1080p, both models, counters
    zeroed around each run; the launches of each run by its label."""
    from video_stab_tpu_torch.core.params import StabilizerParams
    from video_stab_tpu_torch.offline import stabilize_clip_device

    clip = pool[:OFFLINE_SLICE_FRAMES]
    by_model = {}
    for label, params, needed in (
            ("similarity+box", StabilizerParams(smoothing_radius=15),
             ("warp_affine_u8", "box_filter_centered", "corner_response",
              "lk_track")),
            ("homography+box", homography_params(),
             ("warp_homography_u8", "box_filter_centered",
              "corner_response", "lk_track"))):
        zero_counts()
        out = stabilize_clip_device(clip, params, device=dev)
        torch.cuda.synchronize()
        launches = read_counts()
        print(f"offline {label} {OFFLINE_SLICE_FRAMES} frames: launches "
              f"{launches}")
        assert all(launches[k] > 0 for k in needed), launches
        assert out.shape == clip.shape and out.dtype == torch.uint8
        std = float(out[-1].float().std())
        print(f"offline {label}: output {tuple(out.shape)}, last frame std "
              f"{std:.3f}")
        assert std > 5.0
        by_model[f"offline {label}"] = launches
    return by_model


def steady_state(torch, dev, pool) -> None:
    """Phase 5a: ms/frame of the chain and of the bare stabilizer."""
    from video_stab_tpu_torch.core.chain import ProcessingChain
    from video_stab_tpu_torch.core.params import ModeParams, StabilizerParams
    from video_stab_tpu_torch.core.stabilizer import Stabilizer

    def timed(step, label):
        for i in range(N_FRAMES):            # warm-up: fill the queue
            step(pool[i % len(pool)])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for i in range(TIMED_FRAMES):
            out = step(pool[i % len(pool)])
            assert out is not None
        end.record()
        end.synchronize()
        host_s = time.perf_counter() - t0
        ms = start.elapsed_time(end) / TIMED_FRAMES
        print(f"{label} 1080p: {ms:.3f} ms/frame ({1000.0 / ms:.2f} fps) "
              f"CUDA-event timed over {TIMED_FRAMES} steady-state frames; "
              f"host clock {host_s * 1000.0 / TIMED_FRAMES:.3f} ms/frame")

    chain = ProcessingChain(**entry_params())
    timed(chain.process_device, "chain (entry() params)")
    stab = Stabilizer(StabilizerParams(smoothing_radius=15),
                      mode=ModeParams())
    timed(stab.stabilize_device, "bare Stabilizer(smoothing_radius=15)")
    stab = Stabilizer(homography_params(), mode=ModeParams())
    timed(stab.stabilize_device,
          "homography Stabilizer(smoothing_radius=15)")


def offline_throughput(torch, dev) -> dict:
    """Phase 5b: offline frames/s over 240 frames at 1080p, the clip
    already on the card; stage times from CUDA events; both models with
    box, the similarity model with each other smoother and the homography
    model with kalman (the 9-channel case), counters zeroed around each
    run. Returns the launches of the new smoothers' runs by label."""
    from video_stab_tpu_torch.core.params import StabilizerParams
    from video_stab_tpu_torch.offline import stabilize_clip_device

    clip = torch.from_numpy(make_frames(1080, 1920, OFFLINE_TIMED_FRAMES,
                                        seed=4)).to(dev)

    def similarity(method):
        return StabilizerParams(smoothing_radius=15, smoothing_method=method)

    by_path = {}
    for label, params in (
            ("similarity+box", similarity("box")),
            ("homography+box", homography_params()),
            ("similarity+gaussian", similarity("gaussian")),
            ("similarity+kalman", similarity("kalman")),
            ("similarity+butterworth", similarity("butterworth")),
            ("similarity+l1", similarity("l1")),
            ("homography+kalman",
             homography_params(smoothing_method="kalman"))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        stages = {}
        t0 = time.perf_counter()
        out = stabilize_clip_device(clip, params, device=dev,
                                    stage_ms=stages)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        assert out.shape == clip.shape and out.dtype == torch.uint8
        std = float(out[-1].float().std())
        ms = sum(stages.values())
        print(f"offline {label} 1080p x {OFFLINE_TIMED_FRAMES}: "
              f"{OFFLINE_TIMED_FRAMES * 1000.0 / ms:.2f} frames/s "
              f"(CUDA events {ms:.1f} ms: analyze {stages['analyze']:.1f}, "
              f"smooth {stages['smooth']:.3f}, warp {stages['warp']:.1f}); "
              f"host clock {wall * 1000.0:.1f} ms; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; last "
              f"frame std {std:.3f}")
        assert std > 5.0, label
        if not label.endswith("+box"):
            warp = "warp_homography_u8" if label.startswith("homography") \
                else "warp_affine_u8"
            assert launches[warp] > 0 and launches["corner_response"] > 0 \
                and launches["lk_track"] > 0, (label, launches)
            assert launches["box_filter_centered"] == 0, (label, launches)
            print(f"offline {label}: launches {launches}")
            by_path[f"offline {label} x {OFFLINE_TIMED_FRAMES}"] = launches
        del out
    del clip
    l1_solve(torch, dev)
    return by_path


def l1_solve(torch, dev) -> None:
    """The l1 solve alone on a (240, 3) random-walk path of a clip's size
    (pixels, pixels, radians): its time between CUDA events and its kernel
    launches from the profiler."""
    from video_stab_tpu_torch.motion.l1path import l1_smooth_path

    rng = np.random.default_rng(9)
    steps = rng.normal(0, 1, (OFFLINE_TIMED_FRAMES, 3)) * [3.0, 3.0, 0.003]
    path = torch.from_numpy(np.cumsum(steps, axis=0).astype(np.float32)) \
        .to(dev)
    bound = torch.tensor([20.0, 20.0, 0.05]).to(dev)
    ms = call_ms(torch, lambda i: l1_smooth_path(path, bound), n=2)
    launches = launches_of(torch, lambda: l1_smooth_path(path, bound))
    out = l1_smooth_path(path, bound)
    moved = float((out - path).abs().max())
    assert bool(torch.isfinite(out).all()) and 0.0 < moved <= 20.0 + 1e-3
    print(f"l1 solve ({path.shape[0]}, 3), 60 x 25 iterations: {ms:.1f} ms "
          f"a solve (CUDA events over 2 after 3 of warm-up), {launches} "
          f"kernel launches; the path moved by at most {moved:.3f}")


LK_ROUTES = ("plain", "kernel", "kernel", "plain")


def kernel_counts(prof) -> tuple[int, int, float]:
    """From a torch.profiler trace: the host's kernel-launch calls (every
    CUDA API call whose name holds ``LaunchKernel``), the device's
    kernel records (not copies or fills) and their device time in us."""
    launches = records = 0
    busy_us = 0.0
    for ev in prof.key_averages():
        if "LaunchKernel" in ev.key:
            launches += ev.count
        elif "CUDA" in str(ev.device_type) and \
                not ev.key.startswith(("Memcpy", "Memset")):
            records += ev.count
            busy_us += ev.self_device_time_total
    return launches, records, busy_us
ROUTE_WARM, ROUTE_TIMED, ROUTE_PROFILED = 40, 30, 8
ROUTE_OFFLINE_FRAMES = 48


def lk_routes(torch, dev, pool) -> dict:
    """Phase 5c: where the time goes with LK's Newton ladder through the
    plain version and through K6, in turns in this call. Per streaming
    path: ms/frame (CUDA events over ROUTE_TIMED frames after ROUTE_WARM),
    LK's ms/frame (CUDA events around each ``lk_track`` call), then over
    ROUTE_PROFILED frames under ``torch.profiler``: kernel launches per
    frame (the host's ``cudaLaunchKernel`` calls; the device's kernel
    records beside them, which the profiler may drop), and the device's
    busy share (the kernels' device time per frame over the frame's
    CUDA-event time above; the profiler slows the host, so not over the
    profiled window). Offline: the analysis stage over ROUTE_OFFLINE_FRAMES 1080p
    frames of each model. The route is switched by pointing
    ``ops/lk.py``'s ``lk_levels`` at the plain version for the plain turns;
    the package has no such switch."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from video_stab_tpu_torch import offline as toff
    from video_stab_tpu_torch.core import stabilizer as tstab
    from video_stab_tpu_torch.core.chain import ProcessingChain
    from video_stab_tpu_torch.core.params import ModeParams, StabilizerParams
    from video_stab_tpu_torch.core.stabilizer import Stabilizer
    from video_stab_tpu_torch.kernels import lk as klk
    from video_stab_tpu_torch.ops import lk as tlk

    lk_events = []
    real_track = tlk.lk_track

    def timed_track(*a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_track(*a, **k)
        end.record()
        lk_events.append((start, end))
        return out

    @contextlib.contextmanager
    def route(name):
        tlk.lk_levels = klk.lk_levels_plain if name == "plain" \
            else klk.lk_levels
        tstab.lk_track = toff.lk_track = timed_track
        try:
            yield
        finally:
            tlk.lk_levels = klk.lk_levels
            tstab.lk_track = toff.lk_track = real_track

    def lk_ms() -> float:
        torch.cuda.synchronize()
        ms = sum(s.elapsed_time(e) for s, e in lk_events)
        lk_events.clear()
        return ms

    paths = {
        "chain": lambda: ProcessingChain(**entry_params()).process_device,
        "stabilizer": lambda: Stabilizer(
            StabilizerParams(smoothing_radius=15),
            mode=ModeParams()).stabilize_device,
        "homography stabilizer": lambda: Stabilizer(
            homography_params(), mode=ModeParams()).stabilize_device,
    }
    results = {}
    for path, make in paths.items():
        for turn, name in enumerate(LK_ROUTES):
            with route(name):
                step = make()
                for i in range(ROUTE_WARM):
                    step(pool[i % len(pool)])
                lk_ms()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for i in range(ROUTE_TIMED):
                    assert step(pool[(ROUTE_WARM + i) % len(pool)]) \
                        is not None
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end) / ROUTE_TIMED
                lk = lk_ms() / ROUTE_TIMED
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    for i in range(ROUTE_PROFILED):
                        step(pool[i % len(pool)])
                    torch.cuda.synchronize()
                    wall_us = (time.perf_counter() - t0) * 1e6
                lk_ms()
            launches, records, busy_us = kernel_counts(prof)
            dev_ms = busy_us / 1000.0 / ROUTE_PROFILED
            row = {"ms_per_frame": ms, "lk_ms_per_frame": lk,
                   "lk_share": lk / ms,
                   "launches_per_frame": launches / ROUTE_PROFILED,
                   "kernel_records_per_frame": records / ROUTE_PROFILED,
                   "device_ms_per_frame": dev_ms,
                   "device_busy_share": dev_ms / ms,
                   "profiled_ms_per_frame": wall_us / 1000.0
                   / ROUTE_PROFILED}
            results.setdefault(path, {}).setdefault(name, []).append(row)
            print(f"route {path} turn {turn} LK {name}: {ms:.3f} ms/frame, "
                  f"LK {lk:.3f} ms/frame ({row['lk_share'] * 100:.1f}%); "
                  f"profiled: {row['launches_per_frame']:.1f} launches/frame"
                  f" ({row['kernel_records_per_frame']:.1f} kernel records),"
                  f" device {dev_ms:.3f} ms/frame, busy "
                  f"{row['device_busy_share'] * 100:.2f}% of the timed "
                  f"frame")

    from video_stab_tpu_torch.offline import stabilize_clip_device
    clip = pool[:ROUTE_OFFLINE_FRAMES]
    for label, params in (("offline similarity+box",
                           StabilizerParams(smoothing_radius=15)),
                          ("offline homography+box", homography_params())):
        for turn, name in enumerate(LK_ROUTES):
            with route(name):
                stages = {}
                stabilize_clip_device(clip, params, device=dev,
                                      stage_ms=stages)
                lk = lk_ms()
            row = {"analyze_ms_per_frame": stages["analyze"] / len(clip),
                   "lk_ms_per_frame": lk / (len(clip) - 1),
                   "frames_per_s": len(clip) * 1000.0
                   / sum(stages.values())}
            results.setdefault(label, {}).setdefault(name, []).append(row)
            print(f"route {label} {len(clip)} frames turn {turn} LK {name}: "
                  f"analyze {row['analyze_ms_per_frame']:.3f} ms/frame, LK "
                  f"{row['lk_ms_per_frame']:.3f} ms/frame, "
                  f"{row['frames_per_s']:.2f} frames/s")
    return results


def small_reference(torch, dev) -> None:
    """Phase 5b: the CUDA chain (kernels) against the CPU chain (plain
    versions) on a small input, both fed the same RANSAC draws."""
    from video_stab_tpu_torch.core.chain import ProcessingChain
    from video_stab_tpu_torch.core.params import (ModeParams,
                                                  RollCorrectionParams,
                                                  StabilizerParams)

    h, w = 288, 512
    frames = make_frames(h, w, 24, seed=2)
    sp = StabilizerParams(smoothing_radius=5, analysis_width=128,
                          analysis_height=72, max_corners=64,
                          ransac_hypotheses=64)
    rng = np.random.default_rng(3)
    draws = rng.random((len(frames), sp.ransac_hypotheses, 2))
    outs = {}
    angles = {}
    for use_cuda in (False, True):
        k = iter(range(len(frames)))

        def inject(n_valid, _k=k):
            hi = max(int(n_valid), 1)
            return torch.from_numpy(
                np.minimum(np.floor(draws[next(_k)] * hi), hi - 1)
                .astype(np.int64))

        p = entry_params()
        p["mode"] = ModeParams(use_cuda=use_cuda, enhancer_enabled=True,
                               roll_correction_enabled=True,
                               stabilizer_enabled=True)
        p["roll"] = RollCorrectionParams(hough_threshold=40)
        p["stabilizer"] = sp
        chain = ProcessingChain(**p, ransac_draws=inject)
        got = [chain.process(f) for f in frames]
        got = [g for g in got if g is not None]
        while (f := chain.flush()) is not None:
            got.append(f)
        outs[use_cuda] = np.stack(got)
        angles[use_cuda] = float(chain.state.roll.smoothed_angle)
    d = np.abs(outs[True].astype(int) - outs[False].astype(int))
    same = float((d <= 1).mean())
    print(f"small input {h}x{w}: CUDA vs CPU chain: {len(outs[True])} "
          f"frames, {same * 100:.4f}% of px within 1, max diff {d.max()}, "
          f"roll angle {angles[True]:.6f} vs {angles[False]:.6f}")
    assert same >= 0.995 and abs(angles[True] - angles[False]) < 1e-3
    small_reference_homography(torch, frames, sp)
    small_reference_offline(torch, frames, sp)
    small_reference_smoothers(torch, frames, sp)


def injected_draws(torch, n_steps: int, k: int, width: int, seed: int):
    """A fresh draws hook: step i's (k, width) draws from one numpy table,
    the same for the CUDA and the CPU run."""
    u = np.random.default_rng(seed).random((n_steps, k, width))
    steps = iter(range(n_steps))

    def inject(n_valid):
        hi = max(int(n_valid), 1)
        return torch.from_numpy(np.minimum(np.floor(u[next(steps)] * hi),
                                           hi - 1).astype(np.int64))
    return inject


def compare_small(label: str, a: np.ndarray, b: np.ndarray) -> None:
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a.astype(int) - b.astype(int))
    same = float((d <= 1).mean())
    print(f"{label}: {len(a)} frames, {same * 100:.4f}% of px within 1, "
          f"max diff {d.max()}")
    assert same >= 0.995, label


def small_reference_homography(torch, frames, sp) -> None:
    """The homography Stabilizer on the card against the CPU, fed the same
    (K, 4) draws."""
    import dataclasses

    from video_stab_tpu_torch.core.params import ModeParams
    from video_stab_tpu_torch.core.stabilizer import Stabilizer

    p = dataclasses.replace(sp, motion_model="homography")
    outs = {}
    for use_cuda in (False, True):
        stab = Stabilizer(p, mode=ModeParams(use_cuda=use_cuda),
                          ransac_draws=injected_draws(
                              torch, len(frames), p.ransac_hypotheses, 4, 5))
        got = [o for o in (stab.stabilize(f) for f in frames)
               if o is not None]
        while (f := stab.flush()) is not None:
            got.append(f)
        outs[use_cuda] = np.stack(got)
    compare_small(f"small input {frames.shape[1]}x{frames.shape[2]}: CUDA "
                  "vs CPU homography Stabilizer", outs[True], outs[False])


def small_reference_offline(torch, frames, sp) -> None:
    """Offline stabilize_clip on the card against the CPU, both models, fed
    the same draws."""
    import dataclasses

    from video_stab_tpu_torch.offline import stabilize_clip

    for model, width in (("similarity", 2), ("homography", 4)):
        p = dataclasses.replace(sp, motion_model=model)
        outs = {dev: stabilize_clip(frames, p, device=dev,
                                    ransac_draws=injected_draws(
                                        torch, len(frames),
                                        p.ransac_hypotheses, width, 6))
                for dev in ("cpu", "cuda")}
        compare_small(f"small input {frames.shape[1]}x{frames.shape[2]}: "
                      f"CUDA vs CPU offline {model}+box", outs["cuda"],
                      outs["cpu"])


def small_reference_smoothers(torch, frames, sp) -> None:
    """One streaming and one offline run of each new smoother (and of the
    drone mode, streaming) on the card against the CPU, fed the same
    draws."""
    import dataclasses

    from video_stab_tpu_torch.core.params import ModeParams
    from video_stab_tpu_torch.core.stabilizer import Stabilizer
    from video_stab_tpu_torch.offline import stabilize_clip

    size = f"small input {frames.shape[1]}x{frames.shape[2]}"
    for name, kw in STREAM_SMOOTHERS.items():
        p = dataclasses.replace(sp, **kw)
        if name == "drone":
            # Enough corners that the stream is never starved (>= 40
            # tracked): the frame on which the conditional CLAHE switches
            # on tracks an equalized frame against a plain one, and its
            # few, poor matches leave RANSAC to float32 rounding.
            p = dataclasses.replace(p, analysis_width=256,
                                    analysis_height=144, max_corners=128,
                                    min_distance=8.0)
        outs = {}
        starved = {}
        for use_cuda in (False, True):
            stab = Stabilizer(p, mode=ModeParams(use_cuda=use_cuda),
                              ransac_draws=injected_draws(
                                  torch, len(frames), p.ransac_hypotheses,
                                  2, 7))
            got = [o for o in (stab.stabilize(f) for f in frames)
                   if o is not None]
            while (f := stab.flush()) is not None:
                got.append(f)
            outs[use_cuda] = np.stack(got)
            starved[use_cuda] = int(stab.state_dict()["starvation_counter"])
        compare_small(f"{size}: CUDA vs CPU Stabilizer, {name} (starvation "
                      f"counter {starved[True]} / {starved[False]})",
                      outs[True], outs[False])
    for method in ("gaussian", "kalman", "butterworth", "l1"):
        p = dataclasses.replace(sp, smoothing_method=method)
        outs = {dev: stabilize_clip(frames, p, device=dev,
                                    ransac_draws=injected_draws(
                                        torch, len(frames),
                                        p.ransac_hypotheses, 2, 8))
                for dev in ("cpu", "cuda")}
        compare_small(f"{size}: CUDA vs CPU offline similarity+{method}",
                      outs["cuda"], outs["cpu"])


def main() -> int:
    import torch
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    print(f"card: {smi}")
    import video_stab_tpu_torch  # noqa: F401 (TF32 off)
    from video_stab_tpu_torch.kernels import _lib

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    floor_build = start_launch_floor_build()
    lib_path = _lib.build()
    _lib.library()
    launch_floor = load_launch_floor(floor_build)
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line.lower():
            print(f"  ptxas: {line.strip()}")

    kernels = check_kernels(torch, dev, launch_floor)

    pool = torch.from_numpy(make_frames(1080, 1920, N_FRAMES)).to(dev)
    by_path = {"chain": run_slice(torch, dev, pool),
               "homography stream": run_homography_stream(torch, dev, pool),
               **run_offline(torch, dev, pool),
               **run_smoother_streams(torch, dev, pool)}
    frames = {"chain": N_FRAMES, "homography stream": N_FRAMES,
              "offline similarity+box": OFFLINE_SLICE_FRAMES,
              "offline homography+box": OFFLINE_SLICE_FRAMES,
              **{f"stream {name}": SMOOTHER_FRAMES
                 for name in STREAM_SMOOTHERS}}
    steady_state(torch, dev, pool)
    routes = lk_routes(torch, dev, pool)
    del pool
    offline = offline_throughput(torch, dev)
    by_path.update(offline)
    frames.update({label: OFFLINE_TIMED_FRAMES for label in offline})
    small_reference(torch, dev)

    meta = {
        "warp_affine_u8": ("video_stab_tpu_torch/csrc/warp.cu",
                           "video_stab_tpu/pallas/warp.py:112"),
        "warp_homography_u8": ("video_stab_tpu_torch/csrc/warp.cu",
                               "video_stab_tpu/pallas/warp.py:424"),
        "corner_response": ("video_stab_tpu_torch/csrc/features.cu",
                            "video_stab_tpu/pallas/features.py:43"),
        "enhance_u8": ("video_stab_tpu_torch/csrc/enhance.cu",
                       "video_stab_tpu/pallas/enhance.py:28"),
        "box_filter_convolve": ("video_stab_tpu_torch/csrc/traj.cu",
                                "video_stab_tpu/pallas/traj.py:55"),
        "box_filter_centered": ("video_stab_tpu_torch/csrc/traj.cu",
                                "video_stab_tpu/pallas/traj.py:94"),
        # K6d, the Newton loop; the gather probes K6a-K6c in "also_replaces"
        "lk_track": ("video_stab_tpu_torch/csrc/lk.cu",
                     "tools/lk_inkernel_probe.py:332"),
    }
    rows = []
    for name, (src, rep) in meta.items():
        k = kernels[name]
        paths = {p: c[name] for p, c in by_path.items() if c.get(name)}
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": rep, "launches": sum(paths.values()),
               "launches_by_path": paths,
               "launches_per_frame": {p: n / frames[p]
                                      for p, n in paths.items()},
               "max_abs_err": k["max_abs_err"],
               "ms": k["device_us"] / 1000.0,
               "plain_ms": k["plain_device_us"] / 1000.0,
               "bound_ms": k["bound_us"] / 1000.0,
               "bound_by": k["bound_by"],
               "library_ms": (k["library_device_us"] / 1000.0
                              if "library_device_us" in k else None),
               "device_us": k["device_us"], "call_ms": k["call_ms"],
               "plain_call_ms": k["plain_call_ms"],
               "library_call_ms": k.get("library_call_ms"),
               "bound_us": k["bound_us"], "bound_share": k["bound_share"],
               "library": k["library"],
               "library_device_us": k.get("library_device_us")}
        for extra in ("cases", "shapes", "library_max_abs_diff", "shape",
                      "tracked", "status_flips", "within_1e-3",
                      "err_max_abs_diff", "eps_1e_6", "lk_track_launches",
                      "steps", "steps_eps_1e_6", "latency_floor_us",
                      "floor_share", "sm_clock_mhz", "step_floor_cycles",
                      "template_floor_cycles", "launch_floor_us", "launch",
                      "launches_per_call"):
            if extra in k:
                row[extra] = k[extra]
        if name == "lk_track":
            row["also_replaces"] = ["tools/lk_kernel_proto.py:33",
                                    "tools/lk_inkernel_probe.py:107",
                                    "tools/lk_inkernel_probe.py:63",
                                    "tools/lk_inkernel_probe.py:282"]
        if name == "box_filter_convolve":
            # No production caller: the launches are phase 3's.
            row["launches"] = k["phase3_launches"]
            row["launches_by_path"] = {"phase 3 (no production caller)":
                                       row["launches"]}
            row["launches_per_frame"] = {}
        rows.append(row)
        assert row["launches"] > 0, row
    print(json.dumps({"lk_routes": routes}))
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
