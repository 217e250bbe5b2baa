#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure is an uncaught exception and a nonzero exit):

1. Environment: torch and CUDA versions, the card's name and power limit.
   Without a CUDA device the script exits 1 before printing any result.
2. Build: the hand-written kernels (video_stab_tpu_torch/csrc/, four
   sources, one nvcc each, started together) are compiled from the
   checkout's sources into build/torch_kernels/.
3. Kernels against their plain PyTorch versions on the card, at the shapes
   the main paths give them: K1, K2, K4 and K5 bit for bit, K3 within
   1e-5. Then, per kernel and shape: ``device_us``, the kernel's own time
   from ``torch.profiler`` (self CUDA time of its symbols over 64 launches,
   per launch; the emit warps and the enhancer cycle through 16 distinct
   1080p frames, so their input is cold in L2 as on the path);
   ``call_ms``, the wrapper's time per call over 64 back-to-back calls
   between CUDA events (host work included); the plain version's device
   time (every kernel it launches) and call time the same two ways;
   ``bound_us``, the larger of the bytes (each input read once, each
   output written once) over 3.35 TB/s and the float32 operations over
   67 TFLOP/s, with ``bound_share`` = bound / device time; and for K5b its
   one-call yardstick, ``avg_pool1d``, timed the same two ways.
4. The paths, each with the kernels' launch counters zeroed just before it
   and read just after (each kernel of the path must be > 0):
   a. ``ProcessingChain`` with exactly the ``__graft_entry__.entry()``
      parameters at 1920x1080 over 64 frames of textured content with a
      ~2 deg tilted horizon and per-frame jitter, then ``flush()``; output
      frames, the roll angle and the queue drain are checked (K1, K3, K4);
   b. the streaming homography ``Stabilizer`` (smoothing_radius=15) at
      1920x1080 over 64 frames, then ``flush()`` (K2, K3); its host reads
      per steady-state frame are counted with torch's sync debug mode;
   c. offline ``stabilize_clip`` at 1920x1080 over 32 frames, similarity +
      box (K1, K5b, K3) and homography + box (K2, K5b, K3).
5. Steady-state ms/frame of the chain, the bare ``Stabilizer`` and the
   homography ``Stabilizer`` at 1080p (CUDA events); offline frames/s of
   both models over 240 frames at 1080p with the analysis, smoothing and
   warp stages timed apart; and the CUDA runs against the CPU (plain) runs
   on a small input: the chain, the homography ``Stabilizer`` and offline
   ``stabilize_clip`` of both models, all fed the same RANSAC draws.

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


def check_kernels(torch, dev) -> dict:
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
    gray = frame.float().mean(dim=2)
    gray540 = torch.nn.functional.interpolate(
        gray[None, None], size=(540, 960), mode="bilinear",
        align_corners=False)[0, 0].contiguous()
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
                ["min_eig_kernel", "peak_kernel"], 540 * 960 * (4 + 4 + 1),
                540 * 960 * CORNER_FLOPS, per_call=2)
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
    results.update(check_new_kernels(torch, dev, frame, cold))
    return results


def check_new_kernels(torch, dev, frame, cold) -> dict:
    """Phase 3, K2 / K5a / K5b: bit for bit against the plain versions;
    K5b also against its one-call yardstick, ``avg_pool1d``."""
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

    def path(c):
        return torch.from_numpy(np.cumsum(rng.normal(0, 1, (240, c)), axis=0)
                                .astype(np.float32)).to(dev)

    k5 = [("box_filter_centered", ktraj.box_filter_centered_cuda,
           ktraj.box_filter_centered_plain, path(3), 15),
          ("box_filter_centered", ktraj.box_filter_centered_cuda,
           ktraj.box_filter_centered_plain, path(9), 15),
          ("box_filter_convolve", ktraj.box_filter_convolve_cuda,
           ktraj.box_filter_convolve_plain, path(3), 8)]
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
                   lambda i: plain_fn(p, r), ["box_window_kernel"],
                   4 * (2 * p.numel() + p.shape[1]), p.numel() * (window + 3))
        t["shape"] = shape
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
                            "enhance_u8")}
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
    from video_stab_tpu_torch.kernels import traj as ktraj
    from video_stab_tpu_torch.kernels import warp as kwarp
    return {"warp_affine_u8": (kwarp, "LAUNCHES"),
            "warp_homography_u8": (kwarp, "HOMOGRAPHY_LAUNCHES"),
            "corner_response": (kfeat, "LAUNCHES"),
            "enhance_u8": (kenh, "LAUNCHES"),
            "box_filter_convolve": (ktraj, "CONVOLVE_LAUNCHES"),
            "box_filter_centered": (ktraj, "CENTERED_LAUNCHES")}


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
    import warnings

    from video_stab_tpu_torch.core.params import ModeParams
    from video_stab_tpu_torch.core.stabilizer import Stabilizer
    from video_stab_tpu_torch.ops import features as tfeat

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
        launches["corner_response"] > 0, launches
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
    torch.cuda.synchronize()
    nms0 = tfeat.NMS_SYNCS
    n_win = 8
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(24, 24 + n_win):
                stab.stabilize_device(pool[i])
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
    print(f"homography stream: {len(syncs)} synchronizing calls over "
          f"{n_win} steady-state frames ({len(syncs) / n_win:.2f}/frame); "
          f"the GFTT NMS reads counted by the library: {nms}")
    for where, n in sorted(by_line.items()):
        print(f"  {n} at video_stab_tpu_torch/{where}")
    for w in caught:
        if "synchroniz" in str(w.message) and \
                "video_stab_tpu_torch" not in w.filename:
            print(f"  other synchronizing call at {w.filename}:{w.lineno}")
    # The package's reads: the NMS flag (ops/features.py) and the eigh /
    # matrix_exp of motion/homography.py, nothing else.
    n_feat = sum(n for k, n in by_line.items() if k.startswith("ops/features"))
    n_hom = sum(n for k, n in by_line.items()
                if k.startswith("motion/homography"))
    assert n_feat == nms and n_feat + n_hom == len(syncs), by_line
    return launches


def run_offline(torch, dev, pool) -> dict:
    """Phase 4c: offline stabilize_clip at 1080p, both models, counters
    zeroed around each run; the launches of each run by its label."""
    from video_stab_tpu_torch.core.params import StabilizerParams
    from video_stab_tpu_torch.offline import stabilize_clip_device

    clip = pool[:OFFLINE_SLICE_FRAMES]
    by_model = {}
    for label, params, needed in (
            ("similarity+box", StabilizerParams(smoothing_radius=15),
             ("warp_affine_u8", "box_filter_centered", "corner_response")),
            ("homography+box", homography_params(),
             ("warp_homography_u8", "box_filter_centered",
              "corner_response"))):
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


def offline_throughput(torch, dev) -> None:
    """Phase 5b: offline frames/s over 240 frames at 1080p, both models,
    the clip already on the card; stage times from CUDA events."""
    from video_stab_tpu_torch.core.params import StabilizerParams
    from video_stab_tpu_torch.offline import stabilize_clip_device

    clip = torch.from_numpy(make_frames(1080, 1920, OFFLINE_TIMED_FRAMES,
                                        seed=4)).to(dev)
    for label, params in (("similarity+box",
                           StabilizerParams(smoothing_radius=15)),
                          ("homography+box", homography_params())):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stages = {}
        t0 = time.perf_counter()
        out = stabilize_clip_device(clip, params, device=dev,
                                    stage_ms=stages)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert out.shape == clip.shape
        ms = sum(stages.values())
        print(f"offline {label} 1080p x {OFFLINE_TIMED_FRAMES}: "
              f"{OFFLINE_TIMED_FRAMES * 1000.0 / ms:.2f} frames/s "
              f"(CUDA events {ms:.1f} ms: analyze {stages['analyze']:.1f}, "
              f"smooth {stages['smooth']:.3f}, warp {stages['warp']:.1f}); "
              f"host clock {wall * 1000.0:.1f} ms; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del out


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
    lib_path = _lib.build()
    _lib.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line.lower():
            print(f"  ptxas: {line.strip()}")

    kernels = check_kernels(torch, dev)

    pool = torch.from_numpy(make_frames(1080, 1920, N_FRAMES)).to(dev)
    by_path = {"chain": run_slice(torch, dev, pool),
               "homography stream": run_homography_stream(torch, dev, pool),
               **run_offline(torch, dev, pool)}
    frames = {"chain": N_FRAMES, "homography stream": N_FRAMES,
              "offline similarity+box": OFFLINE_SLICE_FRAMES,
              "offline homography+box": OFFLINE_SLICE_FRAMES}
    steady_state(torch, dev, pool)
    del pool
    offline_throughput(torch, dev)
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
        for extra in ("cases", "shapes", "library_max_abs_diff"):
            if extra in k:
                row[extra] = k[extra]
        if name == "box_filter_convolve":
            # No production caller: the launches are phase 3's.
            row["launches"] = k["phase3_launches"]
            row["launches_by_path"] = {"phase 3 (no production caller)":
                                       row["launches"]}
            row["launches_per_frame"] = {}
        rows.append(row)
        assert row["launches"] > 0, row
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
