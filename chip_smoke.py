#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure is an uncaught exception and a nonzero exit):

1. Environment: torch and CUDA versions, the card's name and power limit.
   Without a CUDA device the script exits 1 before printing any result.
2. Build: the hand-written kernels (video_stab_tpu_torch/csrc/, seven
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
   1080p frames, so their input is cold in L2 as on the path; where five
   traces in a row drop the kernel's records, CUDA events over the 64
   calls queued behind a spin on the card, and a line that says so);
   ``call_ms``, the wrapper's time per call over 64 back-to-back calls
   between CUDA events (host work included); the plain version's device
   time (every kernel it launches) and call time the same two ways;
   ``bound_us``, the larger of the bytes (each input read once, each
   output written once) over 3.35 TB/s and the operations, counted as
   instructions, over the issue rate (132 SMs x 128 lanes x 1.98 GHz,
   ~33.4e12 a second), with ``bound_share`` = bound / device time; for K5b its
   one-call yardstick, ``avg_pool1d``, timed the same two ways; for K5a
   and K5b, which one launch bounds, at (240, 3), (240, 9) and (18000, 3):
   ``launch_floor_us``, the device time of an empty kernel with the same
   grid, block and shared memory by the same profiler reading, with
   ``floor_share``, and the kernel launches of one call (K5a with the
   median ranked in its launch: 1); and for
   K6, which the latency of one point's dependent Newton steps bounds,
   ``latency_floor_us`` (the most steps a point ran times a stated
   per-step floor in cycles, plus the templates, at the SM clock
   ``nvidia-smi`` reads while K6 runs) with ``floor_share``. K4's head
   (u8 -> f32) and tail (f32 -> u8 + gray) modes are checked bit for bit
   and timed the same way at 1080x1920x3, each with its registers and
   spills (``nvcc -Xptxas -v``); the tail also with its vector loop's
   instructions per value (``cuobjdump -sass``, ``sass_loop``) and the
   ``issue_floor_us`` they give at the SM clock read while it runs (a
   reading of the kernel's code, not its bound, which counts the
   function's own operations), its time with gamma off and with no gray,
   and ``sweep_tail``: the tail against its plain version, a true
   division, over every float32 in [0, 255] and 1e6 values in [-1e4,
   1e4], for gamma 0.9 and 1.2 (any difference fails). K1-K4, the head
   and the tail included, must stay bound by bytes. The
   legacy stabilizer's shapes are held and
   timed the same way: K6 over 4 levels of a real 1080p pair's
   full-resolution gray (200 GFTT corners at min_distance 30, win 21, 30
   iterations, eps 0.01) and K3 at 1080x1920 (``legacy_shape`` in their
   rows). The stream axis of the multi-stream step at N = 8: K1 and K2
   emitting from an (8, 16, 1080, 1920, 3) ring at per-stream slots, K3 on
   (8, 540, 960), K6 on 8 x 200 points over 8 pyramids, each in one launch
   against its batched plain version and against 8 single-stream launches
   of the same kernel (bit for bit; K6: identical status, positions, err
   and steps, each stream at the plain tolerance), with its device time at
   N = 8 beside one stream's and its bound at N = 8 (``multistream`` in
   their rows). K7 (auto zoom-crop's shrink loop) at 1080x1920 on a mask
   with no holes and on the frame rotated by 20 and 60 deg: bit for bit
   against its plain version (the chunked loop, on the card), the moves
   each runs, its time from a prefix table warm in L2 (as the cumsums
   leave it on the path) and ``latency_floor_us``, one L2 read a move.
   K8 (auto zoom-crop's content mask) at 1080x1920x3, ksize 5, threshold
   10: bit for bit against its plain version (gray, threshold, close, on
   the card) on the pool's frames (no black) and on frames turned 20 and
   60 deg with black corners, timed over cold frames. K9 (LK's planes:
   both pyramids, the Scharr pair, the bfloat16 rounding, one launch a
   level) bit for bit against its plain version (on the card) at 540x960
   with 3 levels for one stream and for 8, and at 1080x1920 with 4
   levels; timed at 540x960 for N = 1 and N = 8.
4. The paths, each with the kernels' launch counters zeroed just before it
   and read just after (each kernel of the path must be > 0):
   a. ``ProcessingChain`` with exactly the ``__graft_entry__.entry()``
      parameters at 1920x1080 over 64 frames of textured content with a
      ~2 deg tilted horizon and per-frame jitter, then ``flush()``; output
      frames, the roll angle and the queue drain are checked (K1, K3, K4,
      K6, K9), and the GFTT NMS's host reads and rounds printed (the
      ``nms_reads`` and ``nms_rounds`` counters of
      ``utils.telemetry.counters()``);
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
      the GFTT NMS's (the new branches add none);
   e. (run first) ``ProcessingChain`` with each of the four shipped
      configs (``configs/*.yaml``, built inline by ``shipped_configs``), a
      wide-band run (+-70 deg roll, auto zoom-crop, the full enhancer,
      I420, pipelined) and the homography chain with roll, 56 frames each
      at 1080p: ms/frame over 16 steady-state frames, the host reads of 8
      more attributed to the GFTT NMS and ``interior_rect`` (none on the
      card since K7), and K6's
      ``steps=`` on those frames with the motion prior and without it (the
      ``{"configs": ...}`` line);
   f. the stabilizer's variants at 1080p, 56 frames each: the streaming
      ``Stabilizer`` with ``enable_virtual_canvas`` (the defaults: adaptive
      scale, a 2160x3840 canvas), with the FAST, ORB and BRISK detectors,
      with ``deep_stabilization`` (the bundled weights), and
      ``LegacyStabilizer()`` at its defaults: ms/frame over 16
      steady-state frames, the host reads of 8 more attributed to the GFTT
      NMS and the legacy re-detect flag, K1 / K3 / K6 launches per frame
      (> 0 where the path runs the kernel) and the peak device memory of
      each run (the ``{"variants": ...}`` line);
   g. (run after phase 3) multi-stream serving, bench.py's
      ``fps_8x1080p_aggregate`` configuration: 8 lockstep 1080p streams of
      ``make_frames`` content (a jitter seed each, on the card),
      ``StabilizerParams(smoothing_radius=15)``, ``MultiStreamStabilizer``
      against 8 single-stream ``Stabilizer``s stepped in a host loop, in
      turns (batched, looped, looped, batched): 16 warm-up ticks, ms/tick
      and aggregate frames/s over 40 (CUDA events), launches and device ms
      per tick and the busy share over 8 more (``torch.profiler``), K1 /
      K2 / K3 / K6 launches per tick (the batched route must launch K6 and
      the warp once a tick and K3 on the re-detect ticks), host reads over
      8 more (sync debug mode), peak memory; then ``reset_stream(3)`` and
      the ticks until stream 3 emits again while the others never stop;
      then the batched homography route (the ``{"multistream": ...}``
      line);
   h. (run after 5b) the application, ``video_stab_tpu_torch/io/runner.py``:
      ``StabilizerApp`` on ``configs/selftest.yaml`` (the port's
      ``load_config``) with a 1080p synthetic source and the tracker on
      (the seeded untrained detector at 640x384), through the threaded
      frame graph into a ``CallbackSink`` until 96 frames came out: frames
      out, warm-up frames, the p50 ms of the ``fused_chain`` and ``track``
      stages, the detector's mean ms, the app's frames/s (over the last
      120 frames the sink received), peak memory and
      K1 / K3 / K4 head / K4 tail / K6 launches per output frame; hot
      reload from ``configs/default.yaml`` (every toggle off: the output
      listens to "source", no kernel launches) to the stabilizer on and
      back, three times, by rewriting the YAML file (each cycle's peak
      memory may not grow over the first's by more than one chain's frame
      ring); ``_process_frame`` with the ``entry()`` parameters against a
      ``ProcessingChain`` on 32 frames, bit for bit, and ``stop()``
      draining exactly the queued frames; the CenterNet detector with the
      bundled weights on the card against the CPU at 640x384 (float32:
      within 1e-4 and identical valid detections; bfloat16: within 2e-2
      of each head's largest magnitude) and its bfloat16 device ms per
      frame; the CLI in subprocesses (``selftest``, ``stabilize`` and
      ``offline --method box`` on a 640x360 .avi), each exit 0, and the
      offline call in process for K5b's launches (the ``{"app": ...}``
      line);
   i. (run last) the codec layer and the packet graph (``io/codec.py``,
      ``io/packets.py``, ``io/rtsp.py``, the packet branch of
      ``io/runner.py``; the codec runs on the host, built by g++ from
      ``video_stab_tpu_torch/native/`` into ``build/torch_native/``):
      first one line of what the machine has (``g++ --version``, the
      libavcodec headers, ``native.available()``,
      ``io.codec.available("libx264")``); where the machine lacks g++,
      the libavcodec headers or libavcodec's shared library,
      ``{"packets": {"available": false, "missing": [...], "reason":
      ...}}`` with the compiler's first error line, and nothing more of
      this phase; where it has them all, a codec that does not build or a
      libx264 that does not open fails the phase. Else a
      128-frame 1080p Annex-B clip of ``make_frames`` content (the port's
      ``VideoEncoder``, an IDR every 12 frames), then (a) passthrough,
      every toggle off, .h264 out: byte-identical, no decoder, no kernel
      launch; (b) the ``entry()`` parameters, processing from the start:
      the chain in I420, the output decoded back by the port's
      ``VideoDecoder`` to 1080p frames, as many as went in less the
      chain's queue, K1 / K3 / K4 / K6 launches per output frame, and the
      p50 host ms per frame of decode (``decode_unit``), ``fused_chain``
      and encode (``encode_frame_yuv``), wrapped by this script; (c)
      ``configs/rtsp_serving.yaml`` (the port's ``load_config``) with the
      clip as camera and an RTSP server on a free local port, an
      in-process ``RtspPacketSource`` + ``VideoDecoder`` client, started
      in passthrough and switched to processing: >= 48 decodable 1080p
      frames, K1 / K3 / K6 launches; (d) ``vstab-torch stabilize in.mp4
      out.mp4 --device cuda`` in a subprocess on a 640x360 MP4 from the
      port's ``ContainerWriter``: exit 0, H.264 out (the ``{"packets":
      ...}`` line).
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
   draws. Phase 5b also runs the drone config and the wide-band run on
   the card against the CPU, and each variant of phase 4f (the legacy
   stabilizer and the deep network at their own tolerances), and the
   batched multi-stream route (4 streams of 288x512, similarity within 1
   on >= 99.9 % of pixels, homography on >= 99.5 %).

Then one ``{"kernels": [...]}`` line: per kernel the phase-3 numbers, the
launches of each phase-4 path and its launches per frame (per tick of 8
frames on the multi-stream runs; K1, K2, K3 and K6 also carry their
``multistream`` numbers at N = 8 and their launches per tick; the app
runs of phase 4h count per output frame, per chain step over the reload
cycles, and K5b per frame of the CLI's offline clip; the packet runs of
phase 4i per output frame). Its ``ms``,
``plain_ms`` and ``library_ms`` are device times, so they compare with one
another; ``call_ms``, ``plain_call_ms`` and ``library_call_ms`` are the
same calls' times with the host's work. The line before
last is the card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import json
import os
import re
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
SM_COUNT, LANES_PER_SM = 132, 128
BOOST_CLOCK_HZ = 1.98e9          # the H100 SXM's top SM clock
# One instruction a lane and clock on every SM: ~33.4e12 a second. (The
# data sheet's 67 TFLOP/s of float32 counts an FMA as two operations; a
# count of instructions goes over the issue rate.)
ISSUE_PER_S = SM_COUNT * LANES_PER_SM * BOOST_CLOCK_HZ
N_CALLS = 64                     # calls per device-time and call-time sample
N_COLD = 16                      # distinct 1080p inputs cycled (> 50 MB L2)


def bound_us(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes (each
    input read once, each output written once) over the memory rate and
    the operations (counted as instructions, one a lane) over the issue
    rate, 132 SMs x 128 lanes x 1.98 GHz = ISSUE_PER_S, ~33.4e12 a
    second; with which of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e6
    t_ops = ops / ISSUE_PER_S * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def issue_floor_us(instructions: float, sm_clock_mhz: float) -> float:
    """The time ``instructions`` (one a lane) take at one a lane and clock
    on every SM, at the SM clock read while the kernel runs."""
    return instructions / (SM_COUNT * LANES_PER_SM * sm_clock_mhz * 1e6) \
        * 1e6


def queued_us(torch, fn, n: int = N_CALLS) -> float:
    """Device time per call of fn(0) .. fn(n - 1) between two CUDA events,
    the calls queued behind a ~50 ms spin on the card so that they run
    back to back, without the host's launch gaps. It holds every kernel of
    a call, so it is an upper bound on the time of some of them."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(BOOST_CLOCK_HZ * 0.05))
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / n


def device_us(torch, fn, symbols, per_call: int = 1, n: int = N_CALLS,
              attempts: int = 5) -> float:
    """Device time per call from torch.profiler: the self CUDA time of the
    kernels whose names hold one of ``symbols`` over fn(0) .. fn(n - 1),
    divided by the number of such kernels the profiler recorded, times
    ``per_call`` (kernels per call). With ``symbols`` None: every kernel's
    time, divided by n. The profiler may drop a trace's kernel records, so
    a trace with no device time for them, or with fewer than half of the
    launches, is taken again; after ``attempts`` such traces the time is
    taken with CUDA events instead (``queued_us``: every kernel of a call,
    so at least the named kernels' time) and the run says so."""
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
    us = queued_us(torch, fn, n)
    print(f"profiler: no complete trace of {symbols} in {attempts} "
          f"attempts; CUDA events over {n} queued calls: {us:.3f} us a call")
    return us


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
    results.update(check_enhance_modes(torch, frame, cold, ep))
    results.update(check_new_kernels(torch, dev, frame, cold, launch_floor))
    results.update(check_lk(torch, dev))
    results.update(check_interior_rect(torch, dev))
    results.update(check_content_mask(torch, dev, cold))
    results.update(check_lk_planes(torch, dev))
    return results


def azc_masks_1080p() -> dict:
    """K7's content masks at 1080x1920: one with no holes (what the
    restream cell's pool gives), and the frame rotated by 20 and 60 deg
    about its centre (a pixel is content where its centre maps back inside
    the frame)."""
    h, w = 1080, 1920
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    dx, dy = xx - (w - 1) / 2.0, yy - (h - 1) / 2.0
    out = {"no holes": np.full((h, w), 255.0, np.float32)}
    for deg in (20.0, 60.0):
        a = np.radians(deg)
        sx = np.cos(a) * dx + np.sin(a) * dy + (w - 1) / 2.0
        sy = -np.sin(a) * dx + np.cos(a) * dy + (h - 1) / 2.0
        inside = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
        out[f"rotated {deg:g} deg"] = np.where(inside, 255.0, 0.0).astype(
            np.float32)
    return out


def check_interior_rect(torch, dev) -> dict:
    """Phase 3, K7: the shrink loop on the card against its plain version
    (the chunked loop, run on the card) bit for bit, on the masks of
    ``azc_masks_1080p``, with the moves each runs (the fewest max_iters
    whose rect is the whole loop's); timed from the prefix table built
    once, which stays in L2 as on the path, where the cumsums have just
    written it. The plain version's times over 2 calls (thousands of
    launches each). The row's headline numbers are the no-holes mask's."""
    from video_stab_tpu_torch.core import autozoomcrop as tazc
    from video_stab_tpu_torch.kernels import azc as kazc

    cases = {}
    for name, m in azc_masks_1080p().items():
        h, w = m.shape
        md = torch.from_numpy(m).to(dev)
        cum = tazc._prefix_table(md > 0)

        def k7(i, cum=cum, h=h, w=w):
            return kazc.interior_rect_cuda(cum, h, w, h + w)

        def plain(i, md=md):
            return tazc.interior_rect_plain(md)

        got, want = k7(0), plain(0)
        assert torch.equal(got, want), (name, got, want)
        lo, hi = 0, h + w          # the fewest moves that give the rect
        while lo < hi:
            mid = (lo + hi) // 2
            if torch.equal(kazc.interior_rect_cuda(cum, h, w, mid), got):
                hi = mid
            else:
                lo = mid + 1
        moves = lo
        assert torch.equal(tazc.interior_rect_plain(md, moves), got), name
        t = dict(device_us=device_us(torch, k7, ["interior_rect_kernel"]),
                 call_ms=call_ms(torch, k7),
                 plain_device_us=device_us(torch, plain, None, n=2),
                 plain_call_ms=call_ms(torch, plain, n=2), moves=moves,
                 rect=got.tolist())
        # Bytes: the hole totals of every row and column, eight entries a
        # move and one more round where the loop stops, the rect.
        t["bound_us"], t["bound_by"] = bound_us(
            4 * (h + w + 8 * (moves + 1) + 4), 0)
        t["bound_share"] = t["bound_us"] / t["device_us"]
        # One dependent L2 read a round: the starting rect's and each
        # iteration's (moves + 1 of them).
        t["latency_floor_us"] = ((moves + 2) * LK_CYCLES["l2"]
                                 / BOOST_CLOCK_HZ * 1e6)
        t["floor_share"] = t["latency_floor_us"] / t["device_us"]
        t["us_per_move"] = t["device_us"] / max(moves, 1)
        print(f"K7 interior_rect 1080x1920 {name}: rect {t['rect']} after "
              f"{moves} moves, kernel = plain; device {t['device_us']:.3f} "
              f"us ({t['us_per_move']:.3f} us a move), plain "
              f"{t['plain_device_us']:.3f} us; wrapper call "
              f"{t['call_ms']:.4f} ms, plain {t['plain_call_ms']:.4f} ms; "
              f"latency floor {t['latency_floor_us']:.3f} us "
              f"(floor_share {t['floor_share']:.3f}); bound "
              f"{t['bound_us']:.4f} us ({t['bound_by']})")
        cases[name] = t
    row = dict(cases["no holes"], cases=cases, max_abs_err=0.0,
               library="none: no PyTorch call runs the shrink loop")
    return {"interior_rect": row}


# K8's own operations per pixel: the gray and the threshold's compare (the
# close is a few integer operations a 32-pixel word).
MASK_FLOPS = GRAY_FLOPS + 1


def check_content_mask(torch, dev, cold) -> dict:
    """Phase 3, K8: the content mask on the card against its plain version
    (on the card) bit for bit at 1080x1920, ksize 5, threshold 10, on the
    pool's frames (``cold``, no black) and on frames turned 20 and 60 deg
    about the centre with black corners (``azc_masks_1080p``); timed over
    the N_COLD pool frames in float32 (398 MB, past the 50 MB L2)."""
    from video_stab_tpu_torch.core import autozoomcrop as tazc
    from video_stab_tpu_torch.kernels import azc as kazc

    thresh, ksize = 10.0, 5
    frames = [c.float() for c in cold]
    turned = [frames[0] * torch.from_numpy(m / 255.0).to(dev)[..., None]
              for m in list(azc_masks_1080p().values())[1:]]
    for f in [frames[0], frames[1]] + turned:
        got = kazc.content_mask_cuda(f, thresh, ksize)
        want = tazc.content_mask_plain(f, thresh, ksize)
        assert torch.equal(got, want), int((got != want).sum())
    holes = [int((kazc.content_mask_cuda(f, thresh, ksize) == 0).sum())
             for f in turned]
    n_px = 1080 * 1920
    row = timing(torch, "K8 content_mask 1080x1920x3 ksize 5",
                 lambda i: kazc.content_mask_cuda(frames[i % N_COLD],
                                                  thresh, ksize),
                 lambda i: tazc.content_mask_plain(frames[i % N_COLD],
                                                   thresh, ksize),
                 ["content_mask_kernel"], n_px * (12 + 4),
                 n_px * MASK_FLOPS)
    print(f"K8 content_mask: kernel = plain on 2 pool frames and 2 turned "
          f"ones ({holes} pixels outside the content)")
    row.update(max_abs_err=0.0, turned_holes=holes,
               library="none: no PyTorch call computes the close")
    return {"content_mask": row}


# K9's own operations per output pixel of a level: pyr_down's H pass (two
# source rows' worth of 5 products and 4 sums a level column) and W pass
# (5 and 4), Scharr's four 3-tap passes (prev only), the rounding.
K9_DOWN_FLOPS, K9_SCHARR_FLOPS, K9_ROUND_FLOPS = 27, 20, 1


def k9_work(n: int, h: int, w: int, max_level: int) -> tuple[int, int]:
    """(bytes, operations) of one K9 call on n streams of (h, w) grays:
    per level both sources read once, 3 + 1 planes written, below the top
    level the unrounded level to scratch."""
    nbytes = flops = 0
    hs, ws = h, w
    for level in range(max_level + 1):
        hl, wl = ((hs + 1) // 2, (ws + 1) // 2) if level else (hs, ws)
        px = n * hl * wl
        nbytes += 4 * (2 * n * hs * ws + 4 * px
                       + (2 * px if 0 < level < max_level else 0))
        down = K9_DOWN_FLOPS if level else 0
        flops += px * (2 * down + K9_SCHARR_FLOPS + 4 * K9_ROUND_FLOPS)
        hs, ws = hl, wl
    return nbytes, flops


def check_lk_planes(torch, dev) -> dict:
    """Phase 3, K9: LK's planes on the card against ``lk_planes_plain`` (on
    the card) bit for bit at the main path's 540x960 with 3 levels, for one
    stream (a real frame pair's analysis grays) and for 8 (multicam's
    batch), and at the legacy stabilizer's 1080x1920 with 4 levels; timed
    at 540x960 for N = 1 and N = 8 (3 launches a call)."""
    from video_stab_tpu_torch.core.params import StabilizerParams
    from video_stab_tpu_torch.core.stabilizer import _analysis_gray
    from video_stab_tpu_torch.kernels import lk_planes as klp
    from video_stab_tpu_torch.ops.color import bgr_to_gray
    from video_stab_tpu_torch.ops.lk import lk_planes_plain

    sp = StabilizerParams()
    levels = sp.lk_levels
    pair = torch.from_numpy(make_frames(1080, 1920, 2, seed=5)).to(dev)
    prev, curr = (_analysis_gray(sp, f.float()) for f in pair)
    prev8 = torch.stack([torch.roll(prev, 29 * k, dims=1)
                         for k in range(8)]).contiguous()
    curr8 = torch.stack([torch.roll(curr, 29 * k, dims=1)
                         for k in range(8)]).contiguous()
    full = [bgr_to_gray(f.float()).contiguous() for f in pair]
    for p, c, lv in ((prev, curr, levels), (prev8, curr8, levels),
                     (full[0], full[1], 3)):
        launches = klp.PLANES_LAUNCHES
        got = klp.lk_planes_cuda(p, c, lv)
        assert klp.PLANES_LAUNCHES == launches + lv + 1
        want = lk_planes_plain(p, c, lv)
        for g, x in zip(got[0] + got[1], want[0] + want[1]):
            assert torch.equal(g, x), int((g != x).sum())
    h, w = prev.shape
    cases = {}
    for n, (p, c) in ((1, (prev, curr)), (8, (prev8, curr8))):
        nbytes, flops = k9_work(n, h, w, levels)
        label = f"K9 lk_planes {h}x{w} {levels + 1} levels N={n}"
        cases[f"N={n}"] = timing(
            torch, label, lambda i, p=p, c=c: klp.lk_planes_cuda(p, c, levels),
            lambda i, p=p, c=c: lk_planes_plain(p, c, levels),
            ["lk_planes_kernel"], nbytes, flops, per_call=levels + 1)
    print(f"K9 lk_planes: kernel = plain at {h}x{w} ({levels + 1} levels, "
          f"N = 1 and 8) and at 1080x1920 (4 levels), every plane")
    row = dict(cases["N=1"], cases=cases, max_abs_err=0.0,
               launches_per_call=levels + 1,
               library="none: no PyTorch call builds the pyramids, the "
                       "Scharr pair and the rounding")
    return {"lk_planes": row}


# K4's head mode: the table's stages per value (the table is built per
# block). Its tail mode: the function's own operations per value, as its
# plain version states them, each counted once: the clamp (2), the
# divide, pow, the product with 255, then saturate_u8's clamp (2), rint
# and the cast; and the gray per pixel. The kernel's machine code runs
# more (CUDA's accurate powf, the staging, the loop): its vector loop's
# instructions (``sass_loop``) give ``issue_floor_us``, a reading of the
# kernel, not a bound of the function.
HEAD_FLOPS_PER_VALUE, TAIL_FLOPS_PER_VALUE = 3, 9
TAIL_VALUES_PER_LANE_STEP = 12   # a lane's values per vector-loop step


def ptxas_usage(log_text: str, kernel: str) -> dict:
    """Registers, shared memory, stack and spills of each entry function
    whose name holds ``kernel`` (each template instance, by its mangled
    name), from ``nvcc -Xptxas -v`` output."""
    usage, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            continue
        if name is None:
            continue
        u = usage.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            u.update(stack_bytes=int(m[1]), spill_store_bytes=int(m[2]),
                     spill_load_bytes=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            u["registers"] = int(m[1])
            m = re.search(r"(\d+) bytes smem", line)
            u["static_smem_bytes"] = int(m[1]) if m else 0
            name = None
    return usage


def sass_of(lib_path) -> str:
    """``cuobjdump -sass`` of the built library."""
    from video_stab_tpu_torch.kernels import _lib
    from pathlib import Path
    tool = Path(_lib._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout


def sass_loop(sass: str, kernel: str) -> dict:
    """The largest loop of the functions whose names hold ``kernel`` (every
    template instance): the instructions from the target of a predicated
    backward branch (the loop's back edge; the unconditional jumps back
    from out-of-line code, such as a divergent ``__syncwarp``'s, are not
    loops) to the branch, each counted once (NOPs left out): every
    branch's code, powf's special cases included. With the count of each
    MUFU kind, of global and shared loads and stores, and of calls (a call
    leaves the loop for a subroutine, such as the IEEE divide's slow path,
    whose instructions are not counted), and the loop's addresses."""
    best = None
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        if kernel not in func.split()[0]:
            continue
        inst = []
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func):
            inst.append((int(m.group(1), 16), m.group(2).strip()))
        for addr, text in inst:
            b = re.match(r"@!?U?P[T0-9]+\s+BRA(?:\.\w+)*\s+(?:`\()?"
                         r"0x([0-9a-f]+)", text)
            if not b or int(b.group(1), 16) >= addr:
                continue
            head = int(b.group(1), 16)
            loop = [re.sub(r"^@!?U?P[T0-9]+\s+", "", t)
                    for a, t in inst if head <= a <= addr]
            loop = [t for t in loop if not t.startswith("NOP")]
            if best is None or len(loop) > len(best[0]):
                best = (loop, head, addr)
    if best is None:
        raise RuntimeError(f"cuobjdump: no loop in a function named like "
                           f"{kernel}")
    loop, head, end = best

    def count(prefix):
        return sum(t.split()[0].startswith(prefix) for t in loop)
    return {"instructions": len(loop), "from": hex(head), "to": hex(end),
            "mufu": {k: count(f"MUFU.{k}") for k in
                     sorted({t.split()[0][5:] for t in loop
                             if t.startswith("MUFU.")})},
            "global_loads": count("LDG"), "global_stores": count("STG"),
            "shared_loads": count("LDS"), "shared_stores": count("STS"),
            "calls": count("CALL")}


# The float32 bits of 255.0: the tail's sweep covers [0, 255].
F32_BITS_255 = 0x437F0000
SWEEP_CHUNK_PX = 1 << 23          # pixels (3 values each) per chunk
SWEEP_GAMMAS = (0.9, 1.2)
SWEEP_RANDOM = 1_000_000          # seeded values in [-1e4, 1e4]


def sweep_tail(torch, dev) -> dict:
    """Phase 3, the tail's divide: for gamma 0.9 and 1.2, the tail kernel
    against ``enhance_tail_plain`` (a true division; u8 and gray, bit for
    bit) over every float32 in [0, 255], in chunks of 2^23 pixels, and
    over 1e6 seeded values in [-1e4, 1e4]. Any difference fails."""
    import dataclasses

    from video_stab_tpu_torch.core.params import EnhancerParams
    from video_stab_tpu_torch.kernels import enhance as kenh

    out = {}
    n_all = F32_BITS_255 + 1
    rng = np.random.default_rng(SEED)
    extra = torch.from_numpy(rng.uniform(-1e4, 1e4, SWEEP_RANDOM)
                             .astype(np.float32)).to(dev)
    for gamma in SWEEP_GAMMAS:
        ep = dataclasses.replace(EnhancerParams(), gamma=gamma)
        t0 = time.perf_counter()
        compared, differ = 0, 0
        step = 3 * SWEEP_CHUNK_PX
        for lo in [*range(0, n_all, step), None]:
            if lo is None:
                x = extra
            else:
                x = torch.arange(lo, min(lo + step, n_all),
                                 dtype=torch.int32, device=dev) \
                    .view(torch.float32)
            pad = -x.numel() % 3
            x = torch.cat([x, x.new_zeros(pad)]).view(1, -1, 3)
            got, g = kenh.enhance_tail_cuda(ep, x, want_gray=True)
            want, wg = kenh.enhance_tail_plain(ep, x, want_gray=True)
            differ += int((got != want).sum()) + int((g != wg).sum())
            compared += x.numel()
        torch.cuda.synchronize()
        row = dict(tail_values_compared=compared,
                   tail_values_and_grays_differ=differ,
                   seconds=time.perf_counter() - t0)
        print(f"K4 tail sweep, gamma {gamma}: the tail against its plain "
              f"version over {compared} values (every float32 in [0, 255] "
              f"and {SWEEP_RANDOM} in [-1e4, 1e4]), u8 and gray: {differ} "
              f"differ ({row['seconds']:.1f} s)")
        assert differ == 0
        out[str(gamma)] = row
    return out


def check_enhance_modes(torch, frame, cold, ep) -> dict:
    """Phase 3, K4's head and tail modes at 1080x1920x3 against their plain
    versions, bit for bit, then timed. The tail's input is the head's
    output through the unsharp mask, values outside [0, 255] included, as
    on the selftest config's path. Beside the times: each mode's registers
    and spills (ptxas), the tail's instructions per value in its vector
    loop (cuobjdump), its issue floor at the SM clock read while it runs,
    and the tail timed with gamma off and with no gray."""
    import dataclasses

    from video_stab_tpu_torch.kernels import _lib
    from video_stab_tpu_torch.kernels import enhance as kenh
    from video_stab_tpu_torch.ops.filters import unsharp_mask

    results = {}
    n_px = 1080 * 1920
    lib_path = _lib.build()
    log = lib_path.with_suffix(".log").read_text()
    head = kenh.enhance_head_cuda(ep, frame, None)
    p_head = kenh.enhance_head_plain(ep, frame, None)
    torch.cuda.synchronize()
    err_h = float((head - p_head).abs().max())
    print(f"K4 head 1080x1920x3: max|f32 diff| {err_h:.3e}, "
          f"{int((head != p_head).sum())} values differ")
    assert torch.equal(head, p_head)
    row = timing(torch, "K4 head 1080x1920x3",
                 lambda i: kenh.enhance_head_cuda(ep, cold[i % N_COLD], None),
                 lambda i: kenh.enhance_head_plain(ep, cold[i % N_COLD],
                                                   None),
                 ["enhance_head_kernel"], n_px * (3 + 12),
                 n_px * 3 * HEAD_FLOPS_PER_VALUE)
    row.update(max_abs_err=err_h, library="none: the pointwise chain is "
               "several calls", ptxas=ptxas_usage(log, "enhance_head_kernel"))
    print(f"K4 head: ptxas {row['ptxas']}")
    results["enhance_head"] = row

    x = unsharp_mask(head, 2.0, 1.0).contiguous()
    cold_x = [torch.roll(x, 17 * k, dims=1).contiguous()
              for k in range(N_COLD)]
    out, g = kenh.enhance_tail_cuda(ep, x, want_gray=True)
    p_out, p_g = kenh.enhance_tail_plain(ep, x, want_gray=True)
    torch.cuda.synchronize()
    d = (out.int() - p_out.int()).abs()
    err_g = float((g - p_g).abs().max())
    print(f"K4 tail 1080x1920x3: max|u8 diff| {int(d.max())}, "
          f"{int((d > 0).sum())} values differ; max|gray diff| "
          f"{err_g:.3e}, {int((g != p_g).sum())} grays differ")
    assert torch.equal(out, p_out) and torch.equal(g, p_g)
    loop = sass_loop(sass_of(lib_path), "enhance_tail_kernel")
    sweep = sweep_tail(torch, frame.device)
    per_value = loop["instructions"] / TAIL_VALUES_PER_LANE_STEP
    print(f"K4 tail: vector loop {loop} for {TAIL_VALUES_PER_LANE_STEP} "
          f"values a lane: {per_value:.2f} instructions a value")
    row = timing(torch, "K4 tail 1080x1920x3 with gray",
                 lambda i: kenh.enhance_tail_cuda(ep, cold_x[i % N_COLD],
                                                  True),
                 lambda i: kenh.enhance_tail_plain(ep, cold_x[i % N_COLD],
                                                   True),
                 ["enhance_tail_kernel"], n_px * (12 + 3 + 4),
                 n_px * (3 * TAIL_FLOPS_PER_VALUE + GRAY_FLOPS))
    no_gamma = dataclasses.replace(ep, gamma=1.0)
    ways = {
        "gamma off": device_us(torch, lambda i: kenh.enhance_tail_cuda(
            no_gamma, cold_x[i % N_COLD], True), ["enhance_tail_kernel"]),
        "no gray": device_us(torch, lambda i: kenh.enhance_tail_cuda(
            ep, cold_x[i % N_COLD], False), ["enhance_tail_kernel"])}
    clock = sm_clock_mhz(torch, lambda i: kenh.enhance_tail_cuda(
        ep, cold_x[i % N_COLD], True))
    floor = issue_floor_us(n_px * 3 * per_value, clock)
    row.update(max_abs_err=float(d.max()), values_differ=int((d > 0).sum()),
               library="none: the pointwise chain is several calls",
               ptxas=ptxas_usage(log, "enhance_tail_kernel"), sass_loop=loop,
               instructions_per_value=per_value, sm_clock_mhz=clock,
               issue_floor_us=floor, device_us_gamma_off=ways["gamma off"],
               device_us_no_gray=ways["no gray"], sweep=sweep)
    print(f"K4 tail: ptxas {row['ptxas']}; its loop's issue floor "
          f"{floor:.3f} us at the SM clock {clock:.0f} MHz (a reading of "
          f"the kernel, not its bound); gamma off "
          f"{ways['gamma off']:.3f} us, no gray {ways['no gray']:.3f} us")
    results["enhance_tail"] = row
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
        # The same empty kernel read by device_us's stand-in, so that the
        # stand-in runs, and shows its excess, in every run.
        t["launch_floor_queued_us"] = queued_us(
            torch, lambda i: launch_floor(blocks, threads, smem))
        t["floor_share"] = t["launch_floor_us"] / t["device_us"]
        t["launch"] = {"blocks": blocks, "threads": threads,
                       "smem_bytes": smem, "median_in_kernel": median}
        before = ktraj.CONVOLVE_LAUNCHES
        t["launches_per_call"] = launches_of(torch, lambda: cuda_fn(p, r))
        if name == "box_filter_convolve":
            assert ktraj.CONVOLVE_LAUNCHES == before + 2, name
        print(f"{name} {shape}: launch floor {t['launch_floor_us']:.3f} us "
              f"(queued: {t['launch_floor_queued_us']:.3f} us) "
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
    sp, prev, curr, pts, mask, planes = lk_inputs(torch, dev)
    label = (f"lk_track {prev.shape[0]}x{prev.shape[1]} "
             f"{sp.lk_levels + 1} levels {int(mask.sum())} points")
    k6 = lk_case(torch, label, planes, pts, mask, sp.lk_window, sp.lk_iters,
                 (1e-6, 0.03))
    k6.update(library="none: no PyTorch call computes LK",
              lk_track_launches=lk_track_launches(torch, prev, curr, pts,
                                                  mask))
    return {"lk_track": k6}


def lk_case(torch, label, planes, pts, mask, win, iters, eps_list) -> dict:
    """K6 against lk_levels_plain on the same planes at each eps of
    ``eps_list`` (the agreement and the ``steps=`` report), then timed, its
    bound and its latency floor at the last eps."""
    from video_stab_tpu_torch.kernels import lk as klk

    args = (pts, mask, None, win, iters)
    rows = {}
    steps = {}
    levels = len(planes[0])
    eps = eps_list[-1]
    # The step budget: iters rounded up to whole rounds at each level (4
    # rounds at the top level, 2 below).
    budget = 4 * -(-iters // 4) + (levels - 1) * 2 * -(-iters // 2)
    for e in eps_list:
        k_steps, p_steps = (torch.empty(pts.shape[0], dtype=torch.int32,
                                        device=pts.device) for _ in range(2))
        got = klk.lk_levels_cuda(*planes, *args, e, 1e-4, steps=k_steps)
        want = klk.lk_levels_plain(*planes, *args, e, 1e-4, steps=p_steps)
        torch.cuda.synchronize()
        rows[e] = lk_agreement(label, got, want, e)
        steps[e] = lk_steps_report(f"{label} eps={e}", k_steps, p_steps,
                                   got, want, budget)
    n, win2 = pts.shape[0], (win + 1) ** 2
    npix = win ** 2
    # Bytes: per point and level the template's footprint in the three
    # prev planes and one search window's in curr; points, mask, outputs.
    nbytes = n * (levels * 4 * win2 * 4 + 8 + 1 + 8 + 1 + 4)
    # Operations: the templates and the Newton steps this run's points ran.
    flops = npix * (n * levels * LK_TEMPLATE_FLOPS
                    + steps[eps]["mean"] * n * LK_STEP_FLOPS)
    k6 = timing(torch, f"K6 {label}",
                lambda i: klk.lk_levels_cuda(*planes, *args, eps, 1e-4),
                lambda i: klk.lk_levels_plain(*planes, *args, eps, 1e-4),
                ["lk_track_kernel"], nbytes, flops)
    # The second yardstick, one that can be approached: the slowest point's
    # dependent steps and the templates, at the clock the card runs K6 at.
    clock = sm_clock_mhz(
        torch, lambda i: klk.lk_levels_cuda(*planes, *args, eps, 1e-4))
    floor_cycles = (steps[eps]["max"] * LK_STEP_FLOOR_CYCLES
                    + levels * LK_TEMPLATE_FLOOR_CYCLES)
    k6["sm_clock_mhz"] = clock
    k6["latency_floor_us"] = floor_cycles / clock
    k6["floor_share"] = k6["latency_floor_us"] / k6["device_us"]
    k6["step_floor_cycles"] = LK_STEP_FLOOR_CYCLES
    k6["template_floor_cycles"] = LK_TEMPLATE_FLOOR_CYCLES
    print(f"K6 {label}: latency floor {k6['latency_floor_us']:.3f} us "
          f"({steps[eps]['max']} steps x {LK_STEP_FLOOR_CYCLES} cycles + "
          f"{levels} templates x {LK_TEMPLATE_FLOOR_CYCLES} cycles at "
          f"{clock:.0f} MHz), floor_share {k6['floor_share']:.3f}")
    k6.update(rows[eps], shape=label, steps=steps[eps])
    if 1e-6 in rows and eps != 1e-6:
        k6.update(eps_1e_6=rows[1e-6], steps_eps_1e_6=steps[1e-6])
    return k6


def check_legacy_shapes(torch, dev) -> dict:
    """Phase 3, the legacy stabilizer's shapes: K6 over 4 levels of a real
    1080p frame pair's full-resolution gray (200 GFTT corners at
    min_distance 30, win 21, 30 iterations, eps 0.01), and K3 at 1080x1920,
    each against its plain version at the 540x960 tolerance, timed, with
    its bound (and K6's latency floor). -> {kernel name: row}"""
    from video_stab_tpu_torch.core.params import LegacyStabilizerParams
    from video_stab_tpu_torch.kernels import features as kfeat
    from video_stab_tpu_torch.ops.color import bgr_to_gray
    from video_stab_tpu_torch.ops.features import good_features_to_track
    from video_stab_tpu_torch.ops.lk import lk_planes

    lp = LegacyStabilizerParams()
    pair = torch.from_numpy(make_frames(1080, 1920, 2, seed=5)).to(dev)
    prev, curr = (bgr_to_gray(f.float()) for f in pair)
    pts, mask = good_features_to_track(
        prev, max_corners=lp.max_corners, quality_level=lp.quality_level,
        min_distance=lp.min_distance, block_size=lp.block_size)
    assert int(mask.sum()) == lp.max_corners, int(mask.sum())
    planes = lk_planes(prev, curr, lp.lk_levels)
    label = (f"lk_track legacy 1080x1920 {lp.lk_levels + 1} levels "
             f"{int(mask.sum())} points win {lp.lk_window} iters "
             f"{lp.lk_iters}")
    k6 = lk_case(torch, label, planes, pts, mask, lp.lk_window, lp.lk_iters,
                 (lp.lk_eps,))

    resp, peak = kfeat.corner_response_cuda(prev)
    p_resp, p_peak = kfeat.corner_response_plain(prev)
    torch.cuda.synchronize()
    err = float((resp - p_resp).abs().max())
    n_peak = int((peak != p_peak).sum())
    print(f"K3 corner_response 1080x1920: max|resp diff| {err:.3e}, "
          f"{n_peak} peak-mask differences")
    assert err <= 1e-5 and n_peak == 0
    h, w = prev.shape
    k3 = timing(torch, "K3 corner_response 1080x1920",
                lambda i: kfeat.corner_response_cuda(prev),
                lambda i: kfeat.corner_response_plain(prev),
                ["corner_strip_kernel"], h * w * (4 + 4 + 1),
                h * w * CORNER_FLOPS)
    k3.update(max_abs_err=err, shape="corner_response 1080x1920")
    return {"lk_track": k6, "corner_response": k3}


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


def shipped_configs() -> dict:
    """The four configs the repo ships (``configs/*.yaml``), built inline
    with the port's params: each field that differs from its default.
    ``tests/test_torch_configs.py`` holds them to the YAML files field for
    field. Each YAML leaves ``roll_fusion`` at True and ``auto_zoom_crop``
    disabled."""
    from video_stab_tpu_torch.core.params import (AutoZoomCropParams,
                                                  EnhancerParams, ModeParams,
                                                  RollCorrectionParams,
                                                  StabilizerParams)

    def config(mode=None, enhancer=None, stabilizer=None):
        return dict(mode=ModeParams(**(mode or {})),
                    enhancer=EnhancerParams(**(enhancer or {})),
                    roll=RollCorrectionParams(),
                    stabilizer=StabilizerParams(**stabilizer),
                    azc=AutoZoomCropParams(), fuse_roll=True)
    return {
        "default": config(stabilizer=dict(motion_prediction=True)),
        "drone_hf": config(
            mode=dict(stabilizer_enabled=True),
            stabilizer=dict(
                smoothing_radius=15, max_corners=300, min_distance=10.0,
                border_type="reflect_101", border_size=30, crop_n_zoom=True,
                smoothing_method="gaussian", gaussian_sigma=15.0,
                motion_prediction=True, horizon_lock=True,
                drone_high_freq_mode=True, hf_shake_px=0.8,
                hf_rot_lp_alpha=0.1, hf_dead_zone_threshold=3.0,
                hf_freeze_duration=30, hf_motion_accumulator_decay=0.85)),
        "rtsp_serving": config(mode=dict(stabilizer_enabled=True),
                               stabilizer=dict(motion_prediction=True)),
        "selftest": config(
            mode=dict(enhancer_enabled=True, stabilizer_enabled=True),
            enhancer=dict(brightness=1.5, contrast=1.1, enable_unsharp=True,
                          sharpness=2.0, gamma=1.2),
            stabilizer=dict(smoothing_radius=15, motion_prediction=True,
                            analysis_width=640, analysis_height=360)),
    }


def wide_band_config() -> dict:
    """The fifth run: the reference's wide roll band (+-70 deg) with auto
    zoom-crop, the full enhancer (CLAHE, vibrance, unsharp masking and
    denoising around the pointwise stages), on top of the rtsp_serving
    stabilizer; delivered as I420, pipelined."""
    from video_stab_tpu_torch.core.params import (AutoZoomCropParams,
                                                  EnhancerParams, ModeParams,
                                                  RollCorrectionParams,
                                                  StabilizerParams)
    return dict(
        mode=ModeParams(enhancer_enabled=True, roll_correction_enabled=True,
                        stabilizer_enabled=True),
        enhancer=EnhancerParams(brightness=5.0, contrast=1.1, gamma=0.9,
                                enable_clahe=True, enable_vibrance=True,
                                enable_unsharp=True, sharpness=1.0,
                                enable_denoise=True, denoise_strength=5.0),
        roll=RollCorrectionParams(angle_filter_min=-70.0,
                                  angle_filter_max=70.0),
        stabilizer=StabilizerParams(motion_prediction=True),
        azc=AutoZoomCropParams(enabled=True), fuse_roll=True)


def run_slice(torch, dev, pool) -> dict:
    """Phase 4: the entry() chain at 1080p, counters zeroed around it."""
    from video_stab_tpu_torch.core.chain import ProcessingChain
    from video_stab_tpu_torch.ops.features import NMS_ROUNDS_PER_SYNC
    from video_stab_tpu_torch.utils import telemetry

    chain = ProcessingChain(**entry_params())
    radius = chain.params.stabilizer.effective_radius
    zero_counts()
    counts0 = telemetry.counters()
    syncs0 = counts0.get("nms_reads", 0)
    outs = []
    for i in range(N_FRAMES):
        out = chain.process_device(pool[i])
        if out is not None:
            outs.append((i, out))
    torch.cuda.synchronize()
    launches = {name: n for name, n in read_counts().items()
                if name in ("warp_affine_u8", "corner_response",
                            "enhance_u8", "lk_track", "lk_planes")}
    counts = telemetry.counters()
    nms_syncs = counts.get("nms_reads", 0) - syncs0
    nms_rounds = counts.get("nms_rounds", 0) - counts0.get("nms_rounds", 0)
    print(f"slice: launches during the main path {launches}")
    print(f"slice: NMS host reads {nms_syncs} over {N_FRAMES} frames "
          f"({N_FRAMES // 2 + 1} GFTT runs)")
    print(f"slice: NMS rounds {nms_rounds} over {N_FRAMES} frames "
          f"({NMS_ROUNDS_PER_SYNC} a host read)")
    assert nms_rounds == NMS_ROUNDS_PER_SYNC * nms_syncs, \
        (nms_rounds, nms_syncs)
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
    from video_stab_tpu_torch.kernels import azc as kazc
    from video_stab_tpu_torch.kernels import enhance as kenh
    from video_stab_tpu_torch.kernels import features as kfeat
    from video_stab_tpu_torch.kernels import lk as klk
    from video_stab_tpu_torch.kernels import lk_planes as klp
    from video_stab_tpu_torch.kernels import traj as ktraj
    from video_stab_tpu_torch.kernels import warp as kwarp
    return {"warp_affine_u8": (kwarp, "LAUNCHES"),
            "warp_homography_u8": (kwarp, "HOMOGRAPHY_LAUNCHES"),
            "corner_response": (kfeat, "LAUNCHES"),
            "enhance_u8": (kenh, "LAUNCHES"),
            "enhance_head": (kenh, "HEAD_LAUNCHES"),
            "enhance_tail": (kenh, "TAIL_LAUNCHES"),
            "box_filter_convolve": (ktraj, "CONVOLVE_LAUNCHES"),
            "box_filter_centered": (ktraj, "CENTERED_LAUNCHES"),
            "lk_track": (klk, "LAUNCHES"),
            "interior_rect": (kazc, "RECT_KERNEL_LAUNCHES"),
            "content_mask": (kazc, "MASK_KERNEL_LAUNCHES"),
            "lk_planes": (klp, "PLANES_LAUNCHES")}


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

    from video_stab_tpu_torch.utils import telemetry

    torch.cuda.synchronize()
    nms0 = telemetry.counters().get("nms_reads", 0)
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
    nms = telemetry.counters().get("nms_reads", 0) - nms0
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


# Phase 4f: the stabilizer's variants at 1080p with the default smoothing
# radius (30: a 31-frame queue), 56 frames a run as in phase 4e.
VARIANT_FRAMES, VARIANT_WARM, VARIANT_TIMED = 56, 32, 16
VARIANTS = {
    "canvas": dict(enable_virtual_canvas=True),
    "fast": dict(feature_detector="fast"),
    "orb": dict(feature_detector="orb"),
    "brisk": dict(feature_detector="brisk"),
    "deep": dict(deep_stabilization=True),
    "legacy": None,                  # LegacyStabilizer() at its defaults
}
# The kernels each variant's path runs: FAST and BRISK detect without K3;
# deep stabilization's network replaces LK (it still re-detects with GFTT).
VARIANT_KERNELS = {
    "canvas": ("warp_affine_u8", "corner_response", "lk_track"),
    "fast": ("warp_affine_u8", "lk_track"),
    "orb": ("warp_affine_u8", "corner_response", "lk_track"),
    "brisk": ("warp_affine_u8", "lk_track"),
    "deep": ("warp_affine_u8", "corner_response"),
    "legacy": ("warp_affine_u8", "corner_response", "lk_track"),
}


def run_variants(torch, dev, pool) -> tuple[dict, dict]:
    """Phase 4f: the streaming Stabilizer with the virtual canvas (the
    defaults: adaptive scale), with the FAST, ORB and BRISK detectors and
    with deep stabilization (the bundled weights), and LegacyStabilizer()
    at 1080p, counters zeroed around each run: ms/frame over VARIANT_TIMED
    steady-state frames (CUDA events), the host reads of CONFIG_READS more
    (attributed to the GFTT NMS and the legacy re-detect flag, which their
    libraries count), then ``flush()``; the canvas run's peak device
    memory. -> (launches by run, numbers by run)"""
    from video_stab_tpu_torch.core.canvas import canvas_shape
    from video_stab_tpu_torch.core.legacy import LegacyStabilizer
    from video_stab_tpu_torch.core.params import ModeParams, StabilizerParams
    from video_stab_tpu_torch.core.stabilizer import Stabilizer
    from video_stab_tpu_torch.models.deepstab import DeepStabNet
    from video_stab_tpu_torch.utils import telemetry

    by_run, numbers = {}, {}
    for name, kw in VARIANTS.items():
        label = f"variant {name}"
        if kw is None:
            stab = LegacyStabilizer(mode=ModeParams())
        else:
            stab = Stabilizer(StabilizerParams(**kw), mode=ModeParams())
        radius = stab.params.effective_radius
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_counts()
        outs = [stab.stabilize_device(pool[i]) for i in range(VARIANT_WARM)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        timed_to = VARIANT_WARM + VARIANT_TIMED
        start.record()
        outs += [stab.stabilize_device(pool[i])
                 for i in range(VARIANT_WARM, timed_to)]
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / VARIANT_TIMED
        flags0 = telemetry.counters().get("legacy_redetect_reads", 0)
        by_line, n_syncs, nms = count_syncs(
            torch, label, lambda f: outs.append(stab.stabilize_device(f)),
            pool[timed_to:VARIANT_FRAMES])
        flags = telemetry.counters().get("legacy_redetect_reads", 0) - flags0
        flushed = []
        while (f := stab.flush()) is not None:
            flushed.append(f)
        torch.cuda.synchronize()
        peak_mb = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        launches = read_counts()
        n_in = VARIANT_FRAMES
        per_frame = {k: launches[k] / n_in for k in
                     ("warp_affine_u8", "corner_response", "lk_track")}
        print(f"{label} 1080p: {ms:.3f} ms/frame over {VARIANT_TIMED} "
              f"steady-state frames (CUDA events); host reads over "
              f"{CONFIG_READS} frames: {n_syncs} ({nms} GFTT NMS, {flags} "
              f"legacy re-detect flag); K1 / K3 / K6 launches per frame "
              f"{per_frame}; peak device memory above the start "
              f"{peak_mb:.1f} MiB")
        assert all(launches[k] > 0 for k in VARIANT_KERNELS[name]), \
            (label, launches)
        # Every read of the package is the GFTT NMS's or the legacy
        # re-detect flag's; the canvas, the detectors and the network read
        # nothing back.
        by_file = collections.Counter()
        for where, n in by_line.items():
            by_file[where.split(":")[0]] += n
        assert by_file["ops/features.py"] == nms, (label, by_line, nms)
        assert by_file["core/legacy.py"] == flags, (label, by_line, flags)
        assert n_syncs == nms + flags, (label, by_line)
        assert flags == (CONFIG_READS if kw is None else 0), (label, flags)
        # The legacy stabilizer passes its first frame through and starts
        # its queue with the second: the same counts.
        outs = [o for o in outs if o is not None]
        assert len(outs) == VARIANT_FRAMES - radius + 1, (label, len(outs))
        assert len(flushed) == radius - 1, (label, len(flushed))
        for o in outs:
            assert tuple(o.shape) == tuple(pool.shape[1:]) and \
                o.dtype == torch.uint8, (label, o.shape)
        std = float(outs[-1].float().std())
        st = stab._state
        extra = {}
        if name == "canvas":
            extra = {"canvas_shape": list(st.canvas.shape),
                     "canvas_scale": float(st.canvas_scale)}
            assert tuple(st.canvas.shape[:2]) == canvas_shape(
                stab.params, *pool.shape[1:3]), st.canvas.shape
            assert float(st.canvas_scale) >= stab.params.min_canvas_scale
        if name == "deep":
            assert isinstance(st.deepstab, DeepStabNet)
        path = st.path_ring[:min(int(st.n_path), st.path_ring.shape[0])]
        assert bool(torch.isfinite(path).all()), label
        print(f"{label}: {len(outs)} frames emitted in stream, "
              f"{len(flushed)} by flush(); last frame std {std:.3f} {extra}")
        assert std > 5.0
        by_run[label] = launches
        numbers[label] = dict(ms_per_frame=ms, host_reads=n_syncs,
                              nms_reads=nms, redetect_flag_reads=flags,
                              reads_frames=CONFIG_READS,
                              launches_per_frame=per_frame,
                              peak_memory_mib=peak_mb, **extra)
    return by_run, numbers


# 56 frames a run: the rtsp_serving and default configs queue 30 frames
# (smoothing_radius 30), so the timed window starts at frame 32.
CONFIG_FRAMES, CONFIG_WARM, CONFIG_TIMED, CONFIG_READS = 56, 32, 16, 8
# The kernels each run must launch (the default config runs no stage).
CONFIG_KERNELS = {
    "default": (),
    "drone_hf": ("warp_affine_u8", "corner_response", "lk_track"),
    "rtsp_serving": ("warp_affine_u8", "corner_response", "lk_track"),
    "selftest": ("enhance_head", "enhance_tail", "warp_affine_u8",
                 "corner_response", "lk_track"),
    "wide band": ("enhance_head", "enhance_tail", "warp_affine_u8",
                  "corner_response", "lk_track", "interior_rect",
                  "content_mask"),
    "homography roll": ("enhance_u8", "warp_affine_u8", "warp_homography_u8",
                        "corner_response", "lk_track"),
}


class LkSteps:
    """While ``on``, each of the stabilizer's ``lk_track`` calls also runs
    K6 twice more on the same planes with ``steps=``: once with the call's
    ``init_pts`` (the motion prior) and once without, keeping each valid
    point's Newton steps on the device. Those two launches, and the K9
    launches of the planes they read, are measurement: they are taken
    back out of K6's and K9's launch counts."""

    def __init__(self, torch):
        from video_stab_tpu_torch.core import stabilizer as tstab
        self.torch, self.tstab = torch, tstab
        self.real = tstab.lk_track
        self.on = False
        self.steps = {"prior": [], "no prior": []}
        self.shifts = []     # |prior| per frame (0 where the gate held it)

    def __enter__(self):
        self.tstab.lk_track = self._track
        return self

    def __exit__(self, *exc):
        self.tstab.lk_track = self.real

    def _track(self, prev_gray, gray, prev_pts, mask, win, max_level, iters,
               init_pts=None):
        out = self.real(prev_gray, gray, prev_pts, mask, win=win,
                        max_level=max_level, iters=iters, init_pts=init_pts)
        if self.on:
            from video_stab_tpu_torch.kernels import lk as klk
            from video_stab_tpu_torch.kernels import lk_planes as klp
            from video_stab_tpu_torch.ops.lk import lk_planes
            launches = klk.LAUNCHES, klp.PLANES_LAUNCHES
            if init_pts is not None:
                self.shifts.append((init_pts - prev_pts).abs().amax())
            prev_planes, curr_planes = lk_planes(prev_gray, gray, max_level)
            for label, ip in (("prior", init_pts), ("no prior", None)):
                steps = self.torch.zeros(prev_pts.shape[0],
                                         dtype=self.torch.int32,
                                         device=prev_pts.device)
                klk.lk_levels_cuda(prev_planes, curr_planes, prev_pts, mask,
                                   ip, win, iters, 0.03, 1e-4, steps=steps)
                # Masked at report time: a boolean index reads the device.
                self.steps[label].append((steps, mask.clone()))
            klk.LAUNCHES, klp.PLANES_LAUNCHES = launches
        return out

    def report(self, label) -> dict:
        out = {}
        for key, parts in self.steps.items():
            if not parts:
                continue
            v = self.torch.cat([st[m] for st, m in parts]).cpu().numpy()
            out[key] = [int(v.min()), float(np.median(v)),
                        float(np.percentile(v, 90)), int(v.max())]
            print(f"{label}: K6 steps= {key} over {len(parts)} frames "
                  f"({v.size} points): min, median, p90, max {out[key]}")
        if self.shifts:
            shifts = [float(g) for g in self.shifts]
            out["prior_px"] = shifts
            print(f"{label}: the prior's shift (analysis px) on those "
                  f"frames: {shifts} (0: not confident, held at 0)")
        return out


def run_configs(torch, dev, pool) -> tuple[dict, dict]:
    """Phase 4e: the four shipped configs (``shipped_configs``), the wide
    band run (``wide_band_config``: +-70 deg roll, azc, the full enhancer,
    I420, pipelined) and the homography chain with roll (the entry()
    params with the homography stabilizer: the two-pass roll, K2's emit)
    through ``ProcessingChain`` at 1080p, 56 frames each,
    counters zeroed around each run: ms/frame over CONFIG_TIMED
    steady-state frames (CUDA events), then the host reads of CONFIG_READS
    more (torch's sync debug mode, attributed by the library's counters to
    the GFTT NMS and to ``interior_rect``), with K6's steps on those frames
    with the motion prior and without it; then ``flush()``. -> (launches by
    run, numbers by run)."""
    from video_stab_tpu_torch.core import autozoomcrop as tazc
    from video_stab_tpu_torch.core.chain import ProcessingChain

    by_run, numbers = {}, {}
    runs = {**shipped_configs(), "wide band": wide_band_config(),
            "homography roll": dict(entry_params(),
                                    stabilizer=homography_params())}
    for name, kw in runs.items():
        label = f"config {name}"
        wide = name == "wide band"
        chain = ProcessingChain(**kw, pipelined=wide,
                                output_format="i420" if wide else "bgr")
        step = chain.process if wide else chain.process_device
        zero_counts()
        outs = [step(pool[i]) for i in range(CONFIG_WARM)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        timed_to = CONFIG_WARM + CONFIG_TIMED
        start.record()
        outs += [step(pool[i]) for i in range(CONFIG_WARM, timed_to)]
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / CONFIG_TIMED
        rect0 = tazc.RECT_READS
        with LkSteps(torch) as lk_steps:
            lk_steps.on = True
            by_line, n_syncs, nms = count_syncs(
                torch, label, lambda f: outs.append(step(f)),
                pool[timed_to:CONFIG_FRAMES])
        rect = tazc.RECT_READS - rect0
        steps = lk_steps.report(label)
        while (f := chain.flush()) is not None:
            outs.append(f)
        torch.cuda.synchronize()
        launches = read_counts()
        print(f"{label} 1080p: {ms:.3f} ms/frame over {CONFIG_TIMED} "
              f"steady-state frames (CUDA events); host reads over "
              f"{CONFIG_READS} frames: {n_syncs} ({nms} GFTT NMS, {rect} "
              f"interior_rect); launches {launches}")
        assert all(launches[k] > 0 for k in CONFIG_KERNELS[name]), launches
        # Every read of the package, by file: the GFTT NMS and
        # interior_rect (each also counted by its library), the homography
        # refit's eigh / matrix_exp, the pipelined copy's wait.
        by_file = collections.Counter()
        for where, n in by_line.items():
            by_file[where.split(":")[0]] += n
        assert by_file["ops/features.py"] == nms, (label, by_line, nms)
        assert by_file["core/autozoomcrop.py"] == rect, (label, by_line, rect)
        hom_reads = by_file["motion/homography.py"]
        copy_waits = by_file["core/chain.py"]
        assert n_syncs == nms + rect + hom_reads + copy_waits, (label, by_line)
        outs = [o for o in outs if o is not None]
        sp = kw["stabilizer"]
        assert len(outs) == CONFIG_FRAMES, (label, len(outs))
        h, w = pool.shape[1:3]
        shape = (h * 3 // 2, w) if wide else (h, w, 3)
        for o in outs:
            assert tuple(o.shape) == shape, (label, o.shape)
        last = outs[-1]
        std = float(last.float().std()) if isinstance(last, torch.Tensor) \
            else float(np.asarray(last, np.float64).std())
        print(f"{label}: {len(outs)} frames delivered (flush included); "
              f"last frame std {std:.3f}; stabilizer "
              f"{'on' if kw['mode'].stabilizer_enabled else 'off'}, "
              f"motion_prediction {sp.motion_prediction}")
        assert std > 5.0
        if kw["mode"].stabilizer_enabled:
            assert steps["prior"] and steps["no prior"], steps
        if wide:
            angle = float(chain.state.roll.smoothed_angle)
            print(f"{label}: smoothed roll angle {angle:.6f} deg")
            assert np.isfinite(angle)
        by_run[label] = launches
        numbers[label] = dict(ms_per_frame=ms, host_reads=n_syncs,
                              nms_reads=nms, interior_rect_reads=rect,
                              homography_reads=hom_reads,
                              pipelined_copy_waits=copy_waits,
                              reads_frames=CONFIG_READS, k6_steps=steps)
    return by_run, numbers


WIDE_STAGE_FRAMES, WIDE_STAGE_WARM = 10, 2


def wide_band_stages(torch, dev, pool) -> dict:
    """Phase 4e, where the wide-band run's pre-stages spend their time at
    1080p: each stage of ``_pre_stages`` with the full enhancer, and the
    I420 conversion, timed alone by the host clock between two
    synchronizes (launches and device time together), the median over
    WIDE_STAGE_FRAMES frames after WIDE_STAGE_WARM."""
    from video_stab_tpu_torch.core import autozoomcrop as tazc
    from video_stab_tpu_torch.core import enhancer as tenh
    from video_stab_tpu_torch.core import rollcorrection as troll
    from video_stab_tpu_torch.kernels import enhance as kenh
    from video_stab_tpu_torch.kernels.warp import warp_affine_u8
    from video_stab_tpu_torch.ops.color import bgr_to_i420, saturate_u8
    from video_stab_tpu_torch.ops.filters import (bilateral_denoise,
                                                  unsharp_mask)
    from video_stab_tpu_torch.ops.warp import (BORDER_REPLICATE,
                                               rotation_matrix_2d)

    kw = wide_band_config()
    ep, rp = kw["enhancer"], kw["roll"]
    times = collections.defaultdict(list)
    reads = tazc.RECT_READS

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        return out

    roll = troll.roll_state_init(dev)
    for i in range(WIDE_STAGE_WARM + WIDE_STAGE_FRAMES):
        f = pool[i]
        x = timed("K4 head", lambda: kenh.enhance_head(ep, f))
        x = timed("CLAHE on Lab L", lambda: tenh.clahe_lab(
            x, ep.clahe_clip_limit, ep.clahe_tile_grid_size))
        x = timed("vibrance (HSV)", lambda: tenh.vibrance(
            x, ep.vibrance_strength))
        x = timed("unsharp mask", lambda: unsharp_mask(x, ep.sharpness,
                                                       ep.blur_sigma))
        x = timed("bilateral denoise", lambda: bilateral_denoise(
            x, ep.denoise_strength))
        u8, gray = timed("K4 tail", lambda: kenh.enhance_tail(ep, x, True))
        roll = timed("roll estimate (Canny, Hough)",
                     lambda: troll.estimate_roll_angle(rp, roll, gray))
        rot = rotation_matrix_2d(960.0, 540.0, roll.smoothed_angle)
        u8 = timed("K1 whole-frame rotation", lambda: warp_affine_u8(
            u8, rot, border_mode=BORDER_REPLICATE))
        u8 = timed("auto zoom-crop", lambda: saturate_u8(
            tazc.auto_zoom_crop_f32(kw["azc"], u8.float(),
                                    keep_input_size=True)))
        timed("I420", lambda: bgr_to_i420(u8))
    out = {name: float(np.median(v[WIDE_STAGE_WARM:]))
           for name, v in times.items()}
    total = sum(out.values())
    print(f"wide band pre-stages at 1080p, median ms over "
          f"{WIDE_STAGE_FRAMES} frames (host clock between synchronizes; "
          f"interior_rect read {tazc.RECT_READS - reads} times over "
          f"{WIDE_STAGE_WARM + WIDE_STAGE_FRAMES} frames):")
    for name, ms in sorted(out.items(), key=lambda kv: -kv[1]):
        print(f"  {name}: {ms:.3f} ms ({ms / total * 100:.1f} %)")
    print(f"  sum: {total:.3f} ms")
    return out


def small_reference_configs(torch) -> None:
    """Phase 5b, the drone config and the wide band run on the card against
    the CPU on a small clip, fed the same RANSAC draws: the drone config
    with a never-starved analysis (256x144, 128 corners; see
    small_reference_smoothers), the wide band run pipelined into I420."""
    import dataclasses

    from video_stab_tpu_torch.core.chain import ProcessingChain
    from video_stab_tpu_torch.core.params import ModeParams

    frames = make_frames(288, 512, 24, seed=4)
    cases = {
        "drone_hf": (shipped_configs()["drone_hf"],
                     dict(analysis_width=256, analysis_height=144,
                          max_corners=128, min_distance=8.0,
                          border_size=8)),
        "wide band": (wide_band_config(),
                      dict(analysis_width=128, analysis_height=72,
                           max_corners=64)),
    }
    for name, (kw, small) in cases.items():
        wide = name == "wide band"
        outs = {}
        for use_cuda in (False, True):
            p = dict(kw, mode=dataclasses.replace(kw["mode"],
                                                  use_cuda=use_cuda),
                     stabilizer=dataclasses.replace(
                         kw["stabilizer"], smoothing_radius=5,
                         ransac_hypotheses=64, **small))
            chain = ProcessingChain(
                **p, pipelined=wide, output_format="i420" if wide else "bgr",
                ransac_draws=injected_draws(torch, len(frames), 64, 2, 9))
            got = [o for o in (chain.process(f) for f in frames)
                   if o is not None]
            while (f := chain.flush()) is not None:
                got.append(f)
            outs[use_cuda] = np.stack(got)
        # The wide band run's CLAHE bins truncate Lab L, and the card's pow
        # differs from the CPU's by an ulp: a pixel may take the next bin,
        # which the unsharp mask and the bilateral spread (>= 99 %).
        compare_small(f"small input 288x512: CUDA vs CPU chain, config "
                      f"{name}", outs[True], outs[False],
                      0.99 if wide else 0.995)


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
    small_reference_variants(torch, frames, sp)


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


def compare_small(label: str, a: np.ndarray, b: np.ndarray,
                  share: float = 0.995) -> None:
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a.astype(int) - b.astype(int))
    same = float((d <= 1).mean())
    print(f"{label}: {len(a)} frames, {same * 100:.4f}% of px within 1, "
          f"max diff {d.max()}")
    assert same >= share, label


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


def small_reference_variants(torch, frames, sp) -> None:
    """Phase 5b, the variants of phase 4f on the card against the CPU on a
    small clip: the virtual canvas and the FAST, ORB and BRISK detectors fed
    the same RANSAC draws (within 1 on >= 99.5 % of pixels); deep
    stabilization, which draws nothing, in the bfloat16 default (the
    convolutions' bfloat16 sums round apart on cuDNN and on the CPU: the
    transforms within 2e-2, >= 98 % of pixels within 1, the bound of
    tests/test_torch_deepstab.py); the legacy stabilizer (the same
    re-detect decisions, transforms within 1e-2 px / 1e-4 rad: K6 may
    freeze a point one Newton step apart from the plain version, within
    eps = 0.01 px, >= 99.5 % of pixels within 1)."""
    import dataclasses

    from video_stab_tpu_torch.core.legacy import LegacyStabilizer
    from video_stab_tpu_torch.core.params import (LegacyStabilizerParams,
                                                  ModeParams)
    from video_stab_tpu_torch.core.stabilizer import Stabilizer

    size = f"small input {frames.shape[1]}x{frames.shape[2]}"
    lp = LegacyStabilizerParams(smoothing_radius=8, max_corners=120,
                                min_distance=8.0, min_tracking_features=10,
                                redetect_interval=6)
    for name, kw in VARIANTS.items():
        outs, trs, reds = {}, {}, {}
        for use_cuda in (False, True):
            mode = ModeParams(use_cuda=use_cuda)
            if kw is None:
                stab = LegacyStabilizer(lp, mode=mode)
            else:
                stab = Stabilizer(dataclasses.replace(sp, **kw), mode=mode,
                                  ransac_draws=injected_draws(
                                      torch, len(frames),
                                      sp.ransac_hypotheses, 2, 9))
            got, tr, red = [], [], []
            for f in frames:
                o = stab.stabilize(f)
                if o is not None:
                    got.append(o)
                if stab.last_metrics:
                    tr.append(stab.last_metrics["transform"].cpu().numpy())
                    red.append(bool(stab.last_metrics.get("redetected",
                                                          False)))
            while (f := stab.flush()) is not None:
                got.append(f)
            outs[use_cuda], trs[use_cuda] = np.stack(got), np.array(tr)
            reds[use_cuda] = red
        d_tr = np.abs(trs[True] - trs[False])
        print(f"{size}: CUDA vs CPU variant {name}: transforms max|diff| "
              f"{d_tr[:, :2].max():.3e} px, {d_tr[:, 2].max():.3e} rad")
        assert len(outs[False]) == len(frames), (name, len(outs[False]))
        if name == "deep":
            assert d_tr.max() <= 2e-2, d_tr.max()
            compare_small(f"{size}: CUDA vs CPU variant {name}", outs[True],
                          outs[False], share=0.98)
            continue
        if kw is None:
            assert reds[True] == reds[False] and any(reds[False])
            assert d_tr[:, :2].max() <= 1e-2 and d_tr[:, 2].max() <= 1e-4
        compare_small(f"{size}: CUDA vs CPU variant {name}", outs[True],
                      outs[False])


# The multi-stream step (video_stab_tpu_torch/parallel/): bench.py's
# fps_8x1080p_aggregate configuration, 8 lockstep 1080p streams with
# smoothing_radius 15 and the defaults otherwise.
MS_STREAMS = 8
MS_POOL = 12                      # distinct frames per stream, cycled
MS_WARM, MS_TIMED, MS_PROFILED, MS_READS = 16, 40, 8, 8
MS_TICKS = MS_WARM + MS_TIMED     # ticks counted by the launch counters
MS_RESET = 3                      # the stream reset mid-run


def ms_params(**kw):
    from video_stab_tpu_torch.core.params import StabilizerParams
    return StabilizerParams(smoothing_radius=15, **kw)


def check_batched_kernels(torch, dev) -> dict:
    """Phase 3, the stream axis: K1, K2, K3 and K6 at N = 8 streams, the
    multi-stream path's shapes, each against its batched plain version and
    against 8 single-stream launches of the same kernel (bit for bit for
    K1, K2 and K3 (K3 within 1e-5 of the plain version, as at N = 1); for
    K6 identical status, positions, err and steps to the 8 launches and
    each stream at the plain version's tolerance), then its device time at
    N = 8 beside one stream's (x 8) and its bound at N = 8. -> {kernel
    name: row}"""
    import dataclasses

    from video_stab_tpu_torch.core.stabilizer import (_analysis_gray,
                                                      _detect_features)
    from video_stab_tpu_torch.kernels import features as kfeat
    from video_stab_tpu_torch.kernels import lk as klk
    from video_stab_tpu_torch.kernels import warp as kwarp
    from video_stab_tpu_torch.ops.lk import lk_planes
    from video_stab_tpu_torch.ops.warp import invert_affine

    n = MS_STREAMS
    sp = ms_params()
    q = sp.effective_radius + 1
    h, w = 1080, 1920
    pool = torch.from_numpy(make_frames(h, w, 2 * n, seed=6)).to(dev)
    # The (N, Q, H, W, 3) ring of the batched emit, every slot its own
    # memory; the timed calls cycle the slot table, so each reads frames
    # that are cold in L2, as on the path.
    ring = pool[torch.arange(n * q, device=dev) % (2 * n)].reshape(
        n, q, h, w, 3)
    rng = np.random.default_rng(12)
    slot_np = [(rng.integers(0, q, n) + k) % q for k in range(N_COLD)]
    slot_tabs = [torch.from_numpy(t.astype(np.int32)).to(dev)
                 for t in slot_np]
    rows = {}

    def report(name, label, batched, single, nbytes, flops, symbols,
               extra):
        dev_us = device_us(torch, batched, symbols)
        one_us = device_us(torch, single, symbols)
        b_us, b_by = bound_us(nbytes, flops)
        row = dict(n_streams=n, shape=label, device_us=dev_us,
                   single_device_us=one_us, eight_single_device_us=n * one_us,
                   bound_us=b_us, bound_by=b_by, bound_share=b_us / dev_us,
                   **extra)
        print(f"{name} {label}: device {dev_us:.3f} us for {n} streams, "
              f"one stream {one_us:.3f} us (x {n} = {n * one_us:.3f} us); "
              f"bound at N = {n} {b_us:.3f} us ({b_by}), bound_share "
              f"{row['bound_share']:.3f}")
        rows[name] = row

    a = np.radians(rng.normal(0, 0.5, n))
    fwd = np.stack([[[np.cos(t), -np.sin(t), dx], [np.sin(t), np.cos(t), dy]]
                    for t, dx, dy in zip(a, *rng.normal(0, 6, (2, n)))])
    minv_aff = invert_affine(torch.from_numpy(fwd.astype(np.float32))
                             .to(dev)).reshape(n, 6).contiguous()
    hm = np.tile(np.eye(3), (n, 1, 1)) + rng.normal(0, 1e-3, (n, 3, 3))
    hm[:, :2, 2] += rng.normal(0, 6, (n, 2))
    hm[:, 2, :2] = rng.normal(0, 2e-6, (n, 2))
    minv_hom = torch.from_numpy(np.linalg.inv(hm).reshape(n, 9)
                                .astype(np.float32)).to(dev)
    for name, label, minv, batched, plain, single, proj in (
            ("warp_affine_u8", "K1", minv_aff,
             kwarp.warp_affine_u8_batched_cuda,
             kwarp.warp_affine_u8_batched_plain, kwarp.warp_affine_u8_cuda,
             False),
            ("warp_homography_u8", "K2", minv_hom,
             kwarp.warp_homography_u8_batched_cuda,
             kwarp.warp_homography_u8_batched_plain,
             kwarp.warp_homography_u8_cuda, True)):
        got = batched(ring, slot_tabs[0], minv, h, w, 0)
        want = plain(ring, slot_tabs[0], minv, h, w, 0)
        ones = torch.stack([single(ring[b, int(slot_np[0][b])], minv[b], h,
                                   w, 0) for b in range(n)])
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        same = bool(torch.equal(got, ones))
        print(f"{label} batched emit {n}x1080x1920x3 ring of {q}: "
              f"max|kernel-plain| {err}, equal to {n} single launches "
              f"{same}")
        assert err == 0 and same, label
        report(name, f"{n}x{q}x1080x1920x3 ring emit",
               lambda i, bt=batched, m=minv: bt(ring, slot_tabs[i % N_COLD],
                                                m, h, w, 0),
               lambda i, sg=single, m=minv: sg(ring[i % n, i % q],
                                               m[i % n], h, w, 0),
               n * 2 * h * w * 3, n * h * w * WARP_FLOPS[proj](3),
               ["warp_tile_kernel"],
               dict(max_abs_err=float(err), equal_to_single_launches=same))

    gray = _analysis_gray(sp, pool[:n].float()).contiguous()
    ha, wa = gray.shape[-2:]
    resp, peak = kfeat.corner_response_cuda(gray)
    p_resp, p_peak = kfeat.corner_response_plain(gray)
    ones = [kfeat.corner_response_cuda(gray[b]) for b in range(n)]
    torch.cuda.synchronize()
    err = float((resp - p_resp).abs().max())
    n_peak = int((peak != p_peak).sum())
    same = all(torch.equal(resp[b], r) and torch.equal(peak[b], pk)
               for b, (r, pk) in enumerate(ones))
    print(f"K3 batched {n}x{ha}x{wa}: max|resp diff| {err:.3e}, {n_peak} "
          f"peak-mask differences, equal to {n} single launches {same}")
    assert err <= 1e-5 and n_peak == 0 and same
    report("corner_response", f"{n}x{ha}x{wa}",
           lambda i: kfeat.corner_response_cuda(gray),
           lambda i: kfeat.corner_response_cuda(gray[i % n]),
           n * ha * wa * (4 + 4 + 1), n * ha * wa * CORNER_FLOPS,
           ["corner_strip_kernel"],
           dict(max_abs_err=err, equal_to_single_launches=same))

    curr = _analysis_gray(sp, pool[n:2 * n].float()).contiguous()
    pts, mask = _detect_features(sp, gray, redetect=True)
    assert int(mask.sum()) == n * sp.max_corners, int(mask.sum())
    planes = lk_planes(gray, curr, sp.lk_levels)
    win, iters, eps = sp.lk_window, sp.lk_iters, 0.03
    args = (pts, mask, None, win, iters, eps, 1e-4)
    k_steps, p_steps = (torch.empty(mask.shape, dtype=torch.int32,
                                    device=dev) for _ in range(2))
    got = klk.lk_levels_cuda(*planes, *args, steps=k_steps)
    want = klk.lk_levels_plain(*planes, *args, steps=p_steps)
    same = True
    for b in range(n):
        one_steps = torch.empty(mask.shape[1], dtype=torch.int32, device=dev)
        one = klk.lk_levels_cuda([p[b] for p in planes[0]],
                                 [c[b] for c in planes[1]], pts[b], mask[b],
                                 None, win, iters, eps, 1e-4,
                                 steps=one_steps)
        torch.cuda.synchronize()
        same &= all(torch.equal(g[b], o) for g, o in zip(got, one)) and \
            torch.equal(k_steps[b], one_steps)
        lk_agreement(f"lk_track batched stream {b}", [t[b] for t in got],
                     [t[b] for t in want], eps)
    k = k_steps.cpu().numpy()
    print(f"K6 batched {n}x200 points: equal to {n} single launches "
          f"(status, positions, err, steps) {same}; Newton steps per point "
          f"median {float(np.median(k)):.1f}, max {int(k.max())}")
    assert same
    levels = len(planes[0])
    n_pts, win2 = pts.shape[0] * pts.shape[1], (win + 1) ** 2
    nbytes = n_pts * (levels * 4 * win2 * 4 + 8 + 1 + 8 + 1 + 4)
    flops = win * win * (n_pts * levels * LK_TEMPLATE_FLOPS
                         + float(k.mean()) * n_pts * LK_STEP_FLOPS)
    single_planes = ([p[0] for p in planes[0]], [c[0] for c in planes[1]])
    report("lk_track", f"{n}x200 points {ha}x{wa} {levels} levels",
           lambda i: klk.lk_levels_cuda(*planes, *args),
           lambda i: klk.lk_levels_cuda(*single_planes, pts[0], mask[0],
                                        None, win, iters, eps, 1e-4),
           nbytes, flops, ["lk_track_kernel"],
           dict(equal_to_single_launches=bool(same),
                steps_max=int(k.max()), steps_median=float(np.median(k))))
    clock = sm_clock_mhz(torch, lambda i: klk.lk_levels_cuda(*planes, *args))
    floor = (int(k.max()) * LK_STEP_FLOOR_CYCLES
             + levels * LK_TEMPLATE_FLOOR_CYCLES) / clock
    rows["lk_track"].update(latency_floor_us=floor, sm_clock_mhz=clock,
                            floor_share=floor / rows["lk_track"]["device_us"])
    print(f"K6 batched: latency floor {floor:.3f} us at {clock:.0f} MHz, "
          f"floor_share {rows['lk_track']['floor_share']:.3f}")
    del ring, pool
    torch.cuda.empty_cache()
    return rows


def multistream_pool(torch, dev):
    """(MS_POOL, 8, 1080, 1920, 3) u8 on the card: stream i is
    ``make_frames`` content with its own jitter seed."""
    return torch.stack([torch.from_numpy(make_frames(1080, 1920, MS_POOL,
                                                     seed=100 + i))
                        for i in range(MS_STREAMS)], 1).to(dev)


def ms_turn(torch, label, route, params, pool, reset=False):
    """One run of phase 4g: the batched MultiStreamStabilizer or 8
    single-stream Stabilizers stepped in a host loop, on the same frames,
    counters zeroed around it: MS_WARM ticks, MS_TIMED ticks timed by CUDA
    events, MS_PROFILED under torch.profiler, MS_READS under the sync debug
    mode. With ``reset``, then reset_stream(MS_RESET) and ticks until that
    stream emits again."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from video_stab_tpu_torch.core.params import ModeParams
    from video_stab_tpu_torch.core.stabilizer import Stabilizer
    from video_stab_tpu_torch.parallel import MultiStreamStabilizer

    n = MS_STREAMS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    if route == "batched":
        ms = MultiStreamStabilizer(params, n, mode=ModeParams())
        step = ms.stabilize_batch_device
    else:
        singles = [Stabilizer(dataclasses.replace(params,
                                                  seed=params.seed + i),
                              mode=ModeParams()) for i in range(n)]

        def step(batch):
            return [s.stabilize_device(batch[i])
                    for i, s in enumerate(singles)]
    zero_counts()
    tick = 0

    def run(k):
        nonlocal tick
        out = None
        for _ in range(k):
            out = step(pool[tick % len(pool)])
            tick += 1
        return out

    run(MS_WARM)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = run(MS_TIMED)
    end.record()
    end.synchronize()
    ms_tick = start.elapsed_time(end) / MS_TIMED
    launches = read_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(MS_PROFILED)
        torch.cuda.synchronize()
    n_launch, records, busy_us = kernel_counts(prof)
    dev_ms = busy_us / 1000.0 / MS_PROFILED
    window = [pool[(tick + i) % len(pool)] for i in range(MS_READS)]
    tick += MS_READS
    by_line, n_syncs, nms = count_syncs(torch, label, step, window)
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    frames = out if route == "batched" else torch.stack(out)
    assert tuple(frames.shape) == (n, 1080, 1920, 3), frames.shape
    std = float(frames.float().std())
    assert std > 5.0, std
    per_tick = {k: launches[k] / MS_TICKS for k in
                ("warp_affine_u8", "warp_homography_u8", "corner_response",
                 "lk_track")}
    row = dict(route=route, ms_per_tick=ms_tick,
               aggregate_frames_per_s=n * 1000.0 / ms_tick,
               launches_per_tick=n_launch / MS_PROFILED,
               kernel_records_per_tick=records / MS_PROFILED,
               device_ms_per_tick=dev_ms, device_busy_share=dev_ms / ms_tick,
               kernel_launches_per_tick=per_tick, host_reads=n_syncs,
               nms_reads=nms, reads_ticks=MS_READS,
               peak_memory_mib=peak_mb)
    print(f"{label}: {ms_tick:.3f} ms/tick, {row['aggregate_frames_per_s']:.1f}"
          f" aggregate frames/s (CUDA events over {MS_TIMED} ticks); "
          f"profiled: {row['launches_per_tick']:.1f} launches/tick, device "
          f"{dev_ms:.3f} ms/tick, busy {row['device_busy_share'] * 100:.2f}%;"
          f" K1 / K2 / K3 / K6 launches per tick {per_tick}; host reads over "
          f"{MS_READS} ticks {n_syncs} ({nms} GFTT NMS); peak device memory "
          f"above the start {peak_mb:.1f} MiB")
    n_hom = sum(c for k, c in by_line.items()
                if k.startswith("motion/homography"))
    assert n_syncs == nms + n_hom, (label, by_line)
    if params.motion_model != "homography":
        assert n_hom == 0, (label, by_line)
    if route == "batched":
        # One launch a tick for all streams: K6 and the warp on every tick
        # but the first, K3 on the first and on every re-detect tick.
        warp = launches["warp_homography_u8" if params.motion_model ==
                        "homography" else "warp_affine_u8"]
        redetects = sum(1 for t in range(1, MS_TICKS)
                        if t % params.redetect_interval == 0)
        assert launches["lk_track"] == MS_TICKS - 1, launches
        assert warp == MS_TICKS - 1, launches
        assert launches["corner_response"] == 1 + redetects, launches
    if reset:
        ms.reset_stream(MS_RESET)
        others = [i for i in range(n) if i != MS_RESET]
        back = None
        for k in range(1, 3 * params.effective_radius):
            run(1)
            assert ms.last_valid[others].all(), ms.last_valid
            if ms.last_valid[MS_RESET]:
                back = k
                break
        print(f"{label}: reset_stream({MS_RESET}); stream {MS_RESET} emits "
              f"again after {back} ticks (effective_radius "
              f"{params.effective_radius}); the other streams emitted on "
              f"every tick")
        assert back == params.effective_radius, back
        row["ticks_until_reset_stream_emits"] = back
    return row, launches


def run_multistream(torch, dev) -> tuple[dict, dict]:
    """Phase 4g: bench.py's multi-stream configuration (8 x 1080p,
    smoothing_radius 15) batched against 8 single-stream Stabilizers in a
    host loop, in turns (batched, looped, looped, batched), the frames on
    the card; then the batched homography run, and reset_stream mid-run.
    -> (launches by run, numbers)"""
    pool = multistream_pool(torch, dev)
    by_run, turns = {}, {"batched": [], "looped": []}
    for turn, route in enumerate(("batched", "looped", "looped", "batched")):
        label = f"multistream 8x1080p {route} turn {turn}"
        row, launches = ms_turn(torch, label, route, ms_params(), pool,
                                reset=turn == 3)
        turns[route].append(row)
        by_run[f"multistream 8x1080p {route}"] = launches
    label = "multistream 8x1080p homography batched"
    hom, launches = ms_turn(torch, label, "batched",
                            ms_params(motion_model="homography"), pool)
    by_run[label] = launches
    del pool
    torch.cuda.empty_cache()

    def mean(route, key):
        return float(np.mean([r[key] for r in turns[route]]))

    summary = {route: {key: mean(route, key) for key in
                       ("ms_per_tick", "aggregate_frames_per_s",
                        "launches_per_tick", "device_ms_per_tick",
                        "device_busy_share", "host_reads")}
               for route in turns}
    print(f"multistream 8x1080p: batched {summary['batched']['ms_per_tick']:.3f}"
          f" ms/tick ({summary['batched']['aggregate_frames_per_s']:.1f} "
          f"frames/s) against looped {summary['looped']['ms_per_tick']:.3f} "
          f"ms/tick ({summary['looped']['aggregate_frames_per_s']:.1f} "
          f"frames/s); homography batched {hom['ms_per_tick']:.3f} ms/tick, "
          f"{hom['host_reads']} host reads over {MS_READS} ticks")
    return by_run, {"turns": turns, "mean": summary,
                    "homography batched": hom}


def small_reference_multistream(torch) -> None:
    """Phase 5b, the batched route: 4 streams on the card against the CPU
    on a small clip (288x512, each stream its own content), fed the same
    per-stream RANSAC draws: the similarity model within 1 on >= 99.9 % of
    pixels; the homography model on >= 99.5 % (the single stream's bound:
    ``eigh`` and ``matrix_exp`` round apart on the two devices)."""
    import dataclasses

    from video_stab_tpu_torch.core.params import ModeParams, StabilizerParams
    from video_stab_tpu_torch.parallel import MultiStreamStabilizer

    n, h, w, ticks = 4, 288, 512, 16
    clips = np.stack([make_frames(h, w, ticks, seed=20 + i)
                      for i in range(n)], 1)
    sp = StabilizerParams(smoothing_radius=5, analysis_width=128,
                          analysis_height=72, max_corners=64,
                          ransac_hypotheses=64)
    for model, share in (("similarity", 0.999), ("homography", 0.995)):
        p = dataclasses.replace(sp, motion_model=model)
        width = 4 if model == "homography" else 2
        outs = {}
        for use_cuda in (False, True):
            hooks = [injected_draws(torch, ticks, p.ransac_hypotheses,
                                    width, 30 + i) for i in range(n)]

            def inject(n_valid, hooks=hooks):
                return torch.stack([hk(v) for hk, v in
                                    zip(hooks, n_valid.cpu())])
            ms = MultiStreamStabilizer(p, n,
                                       mode=ModeParams(use_cuda=use_cuda),
                                       ransac_draws=inject)
            got = [o for o in (ms.stabilize_batch(b) for b in clips)
                   if o is not None]
            outs[use_cuda] = np.stack(got)
        assert len(outs[True]) == ticks - p.effective_radius + 1
        compare_small(f"small input {h}x{w}: CUDA vs CPU multistream {n} "
                      f"streams {model}", outs[True], outs[False],
                      share=share)


# Phase 4h: the application (``io/runner.py:StabilizerApp``), the detector
# and the CLI on the card.
APP_FRAMES = 96                  # output frames of the 1080p app run
APP_FPS_WINDOW = 120             # the app's frames/s: the sink's last frames
APP_RELOAD_CYCLES = 3
WIRING_FRAMES = 32
DETECTOR_FRAMES = 4
DETECTOR_TIMED = 20
CLI_CLIP_FRAMES = 48             # the CLI's 640x360 clip
APP_H, APP_W = 1080, 1920        # the synthetic source and the frames
# The kernels the selftest config runs: the emit warp, GFTT, the full
# enhancer's head and tail, LK.
APP_KERNELS = ("warp_affine_u8", "corner_response", "enhance_head",
               "enhance_tail", "lk_track")


def _repo_path(*parts) -> str:
    import os
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), *parts)


def _mib(n: float) -> float:
    return n / 2 ** 20


def _wait(cond, seconds: float, what: str) -> None:
    deadline = time.monotonic() + seconds
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def app_full_width(torch, tracker: bool = True, frames_in=None,
                   source_fps: float = 0.0) -> tuple[dict, dict]:
    """Phase 4h.1: ``configs/selftest.yaml`` (the port's ``load_config``)
    with a 1080p synthetic source and the tracker on (or, to show its
    cost, off), through the threaded frame graph into a ``CallbackSink``
    until APP_FRAMES frames came out, then ``stop()`` (its drain
    included). With ``frames_in`` (numpy frames, cycled) no thread runs:
    ``_process_frame`` is called in this thread, to show what the threads
    cost. With ``source_fps`` the synthetic source is replaced by one that
    delivers ``make_frames`` frames at that rate, as a live camera does,
    where the JAX package's ``SyntheticSource`` free-runs."""
    import dataclasses

    from video_stab_tpu_torch.io.runner import StabilizerApp
    from video_stab_tpu_torch.io.sinks import CallbackSink
    from video_stab_tpu_torch.utils.config import load_config

    cfg = load_config(_repo_path("configs", "selftest.yaml"))
    cfg = dataclasses.replace(
        cfg, video_source=f"synthetic:{APP_W}x{APP_H}",
        mode=dataclasses.replace(cfg.mode, tracker_enabled=tracker))
    delivered = {"n": 0, "last": None}
    stamps = collections.deque(maxlen=APP_FPS_WINDOW)

    def receive(frame):
        stamps.append(time.perf_counter())
        delivered["n"] += 1
        delivered["last"] = frame

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_counts()
    app = StabilizerApp(cfg, sink=CallbackSink(receive),
                        max_frames=APP_FRAMES)
    if source_fps:
        from video_stab_tpu_torch.io.sources import (SourceParams,
                                                     SyntheticSource)
        pool = make_frames(APP_H, APP_W, 32)
        start = []

        def paced(i):
            start.append(time.perf_counter()) if not start else None
            delay = start[0] + i / source_fps - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            return pool[i % len(pool)]
        app.source = app.graph.pipeline("source").source = SyntheticSource(
            SourceParams(source="paced"), height=APP_H, width=APP_W,
            frame_fn=paced)
    t0 = time.perf_counter()
    if frames_in is None:
        app.run(duration=180.0)
    else:
        i = 0
        while app._frames_out < APP_FRAMES:
            out = app._process_frame(frames_in[i % len(frames_in)])
            i += 1
            if out is not None:
                receive(out)
        app.stop()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = read_counts()
    peak = _mib(torch.cuda.max_memory_allocated() - base)
    frames = app._frames_out
    stages = app.metrics.timer.summary()
    fps = (len(stamps) - 1) / (stamps[-1] - stamps[0])
    per_frame = {k: launches[k] / frames for k in APP_KERNELS}
    last = delivered["last"]
    out = dict(
        frames_out=frames, frames_delivered=delivered["n"],
        warmup_frames=app.metrics.counters["warmup_frames"],
        fused_chain_p50_ms=stages["fused_chain"]["p50_ms"],
        app_fps=fps, seconds=seconds, peak_mib_above_start=peak,
        launches_per_output_frame=per_frame)
    if tracker:
        out.update(track_p50_ms=stages["track"]["p50_ms"],
                   detector_mean_ms=app._tracker.mean_inference_ms,
                   detections_run=app._tracker._frame_count)
    label = "app selftest 1080p" + (" + tracker" if tracker else "") + (
        ", no threads" if frames_in is not None else "") + (
        f", source paced at {source_fps:g} frames/s" if source_fps else "")
    print(f"{label}: {frames} frames out ({delivered['n']} delivered to "
          f"the sink, {out['warmup_frames']} warm-up) in {seconds:.1f} s; "
          f"fused_chain p50 {out['fused_chain_p50_ms']:.3f} ms; "
          + (f"track p50 {out['track_p50_ms']:.3f} ms, detector mean "
             f"{out['detector_mean_ms']:.3f} ms over "
             f"{out['detections_run']} detections; " if tracker else "")
          + f"{fps:.2f} frames/s; peak {peak:.1f} MiB above the start; "
          f"launches per output frame {per_frame}")
    assert frames >= APP_FRAMES and delivered["n"] > 0, out
    assert tuple(last.shape) == (APP_H, APP_W, 3) and last.dtype == np.uint8
    assert float(np.asarray(last, np.float64).std()) > 5.0
    assert not tracker or app._tracker._frame_count > 0
    assert all(launches[k] > 0 for k in APP_KERNELS), launches
    return out, launches


def app_hot_reload(torch) -> tuple[dict, dict]:
    """Phase 4h.2: ``configs/default.yaml`` (every toggle off) with a 1080p
    synthetic source, written to a temporary file; the output listens to
    "source" and no kernel launches. Rewriting the file with the
    stabilizer on (r = 15) reloads it, the output switches to "processed"
    and K1 / K3 / K6 launch; writing it back returns to "source". Three
    cycles; the peak device memory of each may not grow by more than one
    chain's frame ring over the first's."""
    import dataclasses
    import gc
    import os
    import tempfile

    from video_stab_tpu_torch.io.runner import run_app
    from video_stab_tpu_torch.io.sinks import NullSink
    from video_stab_tpu_torch.utils.config import load_config, save_config

    off = load_config(_repo_path("configs", "default.yaml"))
    off = dataclasses.replace(off, video_source=f"synthetic:{APP_W}x{APP_H}")
    on = dataclasses.replace(
        off, mode=dataclasses.replace(off.mode, stabilizer_enabled=True),
        stabilizer=dataclasses.replace(off.stabilizer, smoothing_radius=15))
    ring = _mib((on.stabilizer.effective_radius + 1) * APP_H * APP_W * 3)
    launches = dict.fromkeys(kernel_modules(), 0)
    cycles = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "app.yaml")
        stamp = [time.time()]

        def write(cfg):
            # Whole files only, as an editor saves: the watcher polls every
            # 50 ms and must not parse a half-written one.
            save_config(cfg, path + ".tmp")
            stamp[0] += 5.0        # a distinct mtime on any clock
            os.utime(path + ".tmp", (stamp[0], stamp[0]))
            os.replace(path + ".tmp", path)

        write(off)
        sink = NullSink()
        radius = on.stabilizer.effective_radius
        steps = 0
        torch.cuda.synchronize()
        gc.collect()
        base = torch.cuda.memory_allocated()
        app = run_app(path, sink=sink)
        app.watcher.poll_interval = 0.05
        output = app.graph.pipeline("output")

        def chain_steps():
            return app.metrics.timer._samples.get("fused_chain", [])
        zero_counts()
        app.start()
        try:
            _wait(lambda: sink.count >= 10, 60.0, "passthrough frames")
            assert output.listen_to == "source" and app.chain is None
            assert sum(read_counts().values()) == 0, read_counts()
            for cycle in range(APP_RELOAD_CYCLES):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                zero_counts()
                steps0 = len(chain_steps())
                write(on)
                _wait(lambda: app.metrics.counters["config_reloads"]
                      == 2 * cycle + 1, 30.0, "the reload")
                assert output.listen_to == "processed"
                # Past the warm-up: the chain has emitted 8 frames.
                _wait(lambda: len(chain_steps()) >= steps0 + radius + 8,
                      120.0, "processed frames")
                write(off)
                _wait(lambda: app.metrics.counters["config_reloads"]
                      == 2 * cycle + 2, 30.0, "the reload back")
                assert output.listen_to == "source"
                # The processing thread has moved on to frames without the
                # chain, so it holds no reference to the old one.
                f0 = app.metrics.counters["frames_out"]
                _wait(lambda: app.metrics.counters["frames_out"] >= f0 + 3,
                      60.0, "passthrough frames after the switch back")
                steps += len(chain_steps()) - steps0
                torch.cuda.synchronize()
                gc.collect()
                got = read_counts()
                for k, n in got.items():
                    launches[k] += n
                cycles.append(dict(
                    peak_mib_above_start=_mib(
                        torch.cuda.max_memory_allocated() - base),
                    allocated_mib_after=_mib(
                        torch.cuda.memory_allocated() - base),
                    launches=got))
                print(f"app hot reload cycle {cycle}: peak "
                      f"{cycles[-1]['peak_mib_above_start']:.1f} MiB above "
                      f"the start, {cycles[-1]['allocated_mib_after']:.1f} "
                      f"MiB held after the switch back; launches {got}")
                assert all(got[k] > 0 for k in ("warp_affine_u8",
                                                 "corner_response",
                                                 "lk_track")), got
        finally:
            app.stop()
    peaks = [c["peak_mib_above_start"] for c in cycles]
    print(f"app hot reload: peaks {peaks} MiB, one ring {ring:.1f} MiB, "
          f"{app.metrics.counters['config_reloads']} reloads")
    assert max(peaks) - peaks[0] <= ring, (peaks, ring)
    assert cycles[-1]["allocated_mib_after"] <= ring, cycles
    return dict(cycles=cycles, ring_mib=ring, chain_steps=steps,
                reloads=app.metrics.counters["config_reloads"]), launches


def app_wiring(torch, pool) -> tuple[dict, dict]:
    """Phase 4h.3: ``StabilizerApp._process_frame`` (tracker off, the
    ``entry()`` parameters) on WIRING_FRAMES frames against a
    ``ProcessingChain`` with the same parameters and seed on the same
    frames: bit for bit; then ``stop()`` drains exactly the chain's queued
    frames into the sink, each equal to the twin's ``flush()``."""
    from video_stab_tpu_torch.core.chain import ProcessingChain
    from video_stab_tpu_torch.io.runner import StabilizerApp
    from video_stab_tpu_torch.io.sinks import CallbackSink
    from video_stab_tpu_torch.utils.config import AppConfig

    kw = entry_params()
    cfg = AppConfig(video_source=f"synthetic:{APP_W}x{APP_H}",
                    mode=kw["mode"], enhancer=kw["enhancer"],
                    roll_correction=kw["roll"],
                    stabilizer=kw["stabilizer"])
    drained = []
    app = StabilizerApp(cfg, sink=CallbackSink(drained.append))
    frames = [pool[i].cpu().numpy() for i in range(WIRING_FRAMES)]
    zero_counts()
    got = [app._process_frame(f) for f in frames]
    queued = app.chain._frames_in - app.chain._emitted
    app.stop()
    torch.cuda.synchronize()
    launches = read_counts()          # the app's own, before the twin's
    twin = ProcessingChain(**kw)
    n_out = 0
    for i, f in enumerate(frames):
        want = twin.process(f)
        assert (got[i] is None) == (want is None), i
        if want is not None:
            assert np.array_equal(got[i], want), f"frame {i} differs"
            n_out += 1
    assert len(drained) == queued > 0, (len(drained), queued)
    for f in drained:
        assert np.array_equal(f, twin.flush())
    assert twin.flush() is None
    print(f"app wiring (entry() params): {n_out} frames of "
          f"_process_frame equal to ProcessingChain bit for bit, "
          f"{len(drained)} drained by stop() equal to its flush()")
    return dict(frames_equal=n_out, drained=len(drained)), launches


def app_detector(torch, dev) -> dict:
    """Phase 4h.4: the detector with the bundled weights on the card
    against the same module on the CPU, on DETECTOR_FRAMES ``make_frames``
    frames resized to 640x384. float32: the heads within 1e-4 and the
    valid detections identical (at a threshold in the widest gap of the
    CPU's best scores, so none lies within 1e-4 of it). bfloat16: the
    heads within 2e-2 of each head's largest magnitude (bfloat16 keeps 8
    bits; the trained maps reach |x| ~ 17, where 2e-2 absolute is below
    one bfloat16 step). Then the bfloat16 detector's device ms per frame
    (CUDA events, batch 1)."""
    import cv2

    from video_stab_tpu_torch.models import detector as tdet

    frames = make_frames(APP_H, APP_W, DETECTOR_FRAMES, seed=SEED + 7)
    x = np.stack([cv2.resize(f, (640, 384)) for f in frames])
    x = torch.from_numpy(x.astype(np.float32))
    out = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        cfg = tdet.DetectorConfig(dtype=dtype)
        cpu = tdet.load_detector(tdet.bundled_weights_path(), cfg,
                                 device="cpu")
        card = tdet.load_detector(tdet.bundled_weights_path(), cfg,
                                  device=dev)
        with torch.no_grad():
            want = cpu(x / 127.5 - 1.0)
            got = card(x.to(dev) / 127.5 - 1.0)
        errs = {}
        for head in ("heatmap", "size", "offset"):
            a, b = want[head], got[head].cpu()
            err = float((a - b).abs().max())
            scale = float(a.abs().max()) if name == "bfloat16" else 1.0
            errs[head] = err
            assert err <= (1e-4 if name == "float32" else 2e-2) * scale, \
                (name, head, err, scale)
        row = dict(max_abs_err=errs)
        if name == "float32":
            top = np.sort(tdet.detect(cpu, x, 0.0, 100)["score"].numpy()
                          .reshape(-1))[::-1][:40]
            gaps = top[:-1] - top[1:]
            i = 4 + int(np.argmax(gaps[4:]))    # >= 5 valid detections
            thr = float((top[i] + top[i + 1]) / 2)
            dw = tdet.detect(cpu, x, thr, 100)
            dg = {k: v.cpu() for k, v in
                  tdet.detect(card, x.to(dev), thr, 100).items()}
            assert float(np.abs(dw["score"].numpy() - thr).min()) > 1e-4
            assert torch.equal(dw["valid"], dg["valid"])
            v = dw["valid"]
            assert torch.equal(dw["class_id"][v], dg["class_id"][v])
            box_err = float((dw["bbox"][v] - dg["bbox"][v]).abs().max())
            assert box_err <= 1e-3, box_err
            row.update(threshold=thr, valid=int(v.sum()),
                       bbox_max_abs_err=box_err)
        else:
            x1 = x[:1].to(dev)
            for _ in range(3):
                tdet.detect(card, x1, 0.5, 100)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(DETECTOR_TIMED):
                tdet.detect(card, x1, 0.5, 100)
            end.record()
            end.synchronize()
            row["device_ms_per_frame"] = \
                start.elapsed_time(end) / DETECTOR_TIMED
        print(f"detector {name}, card vs CPU at 640x384: {row}")
        out[name] = row
    return out


def app_cli(torch) -> tuple[dict, dict]:
    """Phase 4h.5: the CLI in subprocesses (``selftest``; ``stabilize`` and
    ``offline --method box`` on a 640x360 .avi that cv2 writes), each of
    which must exit 0; then the same ``offline --method box`` in this
    process, for K5b's launch count."""
    import contextlib
    import io
    import os
    import tempfile

    import cv2

    from video_stab_tpu_torch import cli

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "in.avi")
        w = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"MJPG"), 30.0,
                            (640, 360))
        for f in make_frames(360, 640, CLI_CLIP_FRAMES, seed=SEED + 3):
            w.write(f)
        w.release()
        runs = {"selftest": ["selftest"],
                "stabilize": ["stabilize", clip,
                              os.path.join(tmp, "stab.avi")],
                "offline box": ["offline", clip,
                                os.path.join(tmp, "off.avi"), "--method",
                                "box"]}
        for name, argv in runs.items():
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "video_stab_tpu_torch.cli", *argv],
                cwd=_repo_path(), capture_output=True, text=True,
                timeout=300)
            seconds = time.perf_counter() - t0
            last = proc.stdout.strip().splitlines()[-1] if proc.stdout \
                else ""
            print(f"cli {name}: exit {proc.returncode} in {seconds:.1f} s: "
                  f"{last}")
            assert proc.returncode == 0, proc.stderr[-4000:]
            out[name] = dict(seconds=seconds, result=json.loads(last))
        assert out["selftest"]["result"]["selftest"] == "ok"
        assert out["stabilize"]["result"]["frames_out"] == CLI_CLIP_FRAMES
        zero_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(runs["offline box"])
        torch.cuda.synchronize()
        launches = read_counts()
    print(f"cli offline box in process: exit {rc}, launches {launches}")
    assert rc == 0 and launches["box_filter_centered"] > 0, launches
    return out, launches


def run_app_phase(torch, dev) -> tuple[dict, dict, dict]:
    """Phase 4h, the application on the card. -> (the {"app": ...}
    numbers, launches by run, frames by run)."""
    pool = torch.from_numpy(make_frames(APP_H, APP_W, WIRING_FRAMES)).to(dev)
    full, full_launches = app_full_width(torch)
    no_tracker, _ = app_full_width(torch, tracker=False)
    no_threads, _ = app_full_width(torch, tracker=False,
                                   frames_in=make_frames(APP_H, APP_W, 32))
    paced, _ = app_full_width(torch, source_fps=30.0)
    reload, reload_launches = app_hot_reload(torch)
    assert reload["chain_steps"] > 0
    wiring, wiring_launches = app_wiring(torch, pool)
    del pool
    detector = app_detector(torch, dev)
    cli_runs, cli_launches = app_cli(torch)
    numbers = dict(full_width=full, full_width_no_tracker=no_tracker,
                   full_width_no_threads=no_threads,
                   full_width_source_30fps=paced,
                   hot_reload=reload, wiring=wiring,
                   detector=detector, cli=cli_runs)
    by_run = {"app selftest 1080p + tracker": full_launches,
              "app hot reload (3 cycles)": reload_launches,
              "app wiring (entry())": wiring_launches,
              "cli offline box (48 frames)": cli_launches}
    frames = {"app selftest 1080p + tracker": full["frames_out"],
              "app hot reload (3 cycles)": reload["chain_steps"],
              "app wiring (entry())": WIRING_FRAMES,
              "cli offline box (48 frames)": CLI_CLIP_FRAMES}
    return numbers, by_run, frames


# Phase 4i: the codec layer and the packet graph (``io/codec.py``,
# ``io/packets.py``, ``io/rtsp.py`` and the packet branch of
# ``io/runner.py``). The codec runs on the host (libavcodec / libx264,
# built by g++ from ``video_stab_tpu_torch/native/``); the chain between
# decode and encode runs on the card.
PKT_FRAMES = 128                 # the 1080p Annex-B clip, 30 frames/s
PKT_GOP = 12                     # an IDR every 12 frames (a live camera's)
PKT_RTSP_MIN_FRAMES = 48         # decodable frames the RTSP client must get
PKT_CLI_FRAMES = 48              # the CLI's 640x360 MP4
# The kernels the entry() chain runs (fused K4), and rtsp_serving's.
PKT_ENTRY_KERNELS = ("warp_affine_u8", "corner_response", "enhance_u8",
                     "lk_track")
PKT_RTSP_KERNELS = ("warp_affine_u8", "corner_response", "lk_track")


def _first_error_line(text: str) -> str:
    lines = [ln.strip() for ln in (text or "").splitlines() if ln.strip()]
    for ln in lines:
        if "error" in ln.lower():
            return ln
    return lines[0] if lines else "unknown"


def packet_toolchain() -> dict:
    """Phase 4i.0: what the machine has for the codec layer: g++, the
    libavcodec headers, the shared libraries the linker would find, and
    whether the port's native libraries build. ``missing`` names what the
    machine lacks; where it lacks nothing, a library that does not build
    (or a libx264 that does not open) raises with the compiler's message,
    since that is a fault of the port."""
    import shutil

    from video_stab_tpu_torch import native
    from video_stab_tpu_torch.io import codec

    gxx = shutil.which(os.environ.get("CXX") or "g++")
    version = "none"
    if gxx:
        version = subprocess.run([gxx, "--version"], capture_output=True,
                                 text=True).stdout.splitlines()[0]
    headers = [d for d in ("/usr/include", "/usr/local/include",
                           "/usr/include/x86_64-linux-gnu",
                           "/usr/include/aarch64-linux-gnu")
               if os.path.exists(os.path.join(d, "libavcodec",
                                              "avcodec.h"))]
    import ctypes.util
    runtime = {name: ctypes.util.find_library(name)
               for name in ("avcodec", "avformat", "swscale", "x264")}
    t0 = time.perf_counter()
    host = native.available()
    x264 = codec.available("libx264")
    missing = [what for what, have in (
        ("g++", gxx), ("libavcodec headers", headers),
        ("libavcodec shared library", runtime["avcodec"]))
        if not have]
    out = dict(gxx=version, libavcodec_headers=headers,
               shared_libraries=runtime, missing=missing,
               native_available=host, libx264_available=x264,
               build_s=time.perf_counter() - t0)
    if not x264:
        err = native.build_error("vstab_codec") or \
            "libx264 does not open in the built codec library"
        out["reason"] = _first_error_line(err)
    print(f"packets toolchain: {out}")
    if gxx and not host:
        raise RuntimeError("g++ is here but the host library does not "
                           f"build: {native.build_error('vstab_host')}")
    if not missing and not x264:
        raise RuntimeError("the libavcodec headers and libraries are here "
                           f"but the codec layer does not work: {err}")
    return out


def _wait_quiet(values, quiet: float, seconds: float, what: str) -> None:
    """Wait until ``values()`` stays the same for ``quiet`` seconds."""
    deadline = time.monotonic() + seconds
    last, since = values(), time.monotonic()
    while time.monotonic() - since < quiet:
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)
        now = values()
        if now != last:
            last, since = now, time.monotonic()


def _timed(fn, samples: list):
    """fn, appending each call's host ms to ``samples``."""
    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        result = fn(*args, **kw)
        samples.append((time.perf_counter() - t0) * 1e3)
        return result
    return wrapper


def _p50(samples) -> float:
    return float(np.median(samples)) if len(samples) else float("nan")


def _decode_file(path: str) -> list:
    from video_stab_tpu_torch.io.codec import VideoDecoder
    from video_stab_tpu_torch.io.packets import PacketSource
    dec = VideoDecoder()
    src = PacketSource(path)
    frames = []
    while (au := src.read()) is not None:
        frames += dec.decode(b"".join(au))
    frames += dec.flush()
    src.stop()
    dec.close()
    return frames


def packet_clip(path: str) -> None:
    """Phase 4i.1: PKT_FRAMES ``make_frames`` frames at 1080p, encoded by
    the port's ``VideoEncoder`` into an Annex-B .h264 file."""
    from video_stab_tpu_torch.io.codec import VideoEncoder
    from video_stab_tpu_torch.io.sinks import bitrate_bps_app

    enc = VideoEncoder(APP_W, APP_H, 30.0,
                       bitrate_bps=bitrate_bps_app(APP_W, APP_H, 30),
                       gop=PKT_GOP)
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        for frame in make_frames(APP_H, APP_W, PKT_FRAMES, seed=SEED + 11):
            f.write(enc.encode(frame))
        f.write(enc.flush())
    enc.close()
    print(f"packets clip: {PKT_FRAMES} frames 1080p H.264 "
          f"({os.path.getsize(path)} bytes) in "
          f"{time.perf_counter() - t0:.1f} s")


def _packet_app(torch, cfg):
    from video_stab_tpu_torch.io.runner import StabilizerApp
    app = StabilizerApp(cfg)
    assert app.packet_mode and app.device.type == "cuda", app.device
    return app


def packet_passthrough(torch, clip: str, tmp: str) -> dict:
    """Phase 4i.a: every toggle off, .h264 in and out: the packet graph
    relays the clip byte for byte, constructs no decoder and launches no
    kernel."""

    from video_stab_tpu_torch.core.params import ModeParams
    from video_stab_tpu_torch.utils.config import AppConfig

    out_path = os.path.join(tmp, "passthrough.h264")
    app = _packet_app(torch, AppConfig(video_source=clip,
                                       output_source=out_path,
                                       mode=ModeParams()))
    zero_counts()
    t0 = time.perf_counter()
    app.graph.start()
    try:
        _wait(lambda: app.source.eof and app.sink.units_written
              == app.source.units_read == PKT_FRAMES, 60.0,
              "the passthrough relay")
    finally:
        app.stop()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    with open(clip, "rb") as a, open(out_path, "rb") as b:
        identical = a.read() == b.read()
    out = dict(units=app.sink.units_written, byte_identical=identical,
               decoder_constructed=app.decoder_constructed,
               launches=sum(launches.values()), seconds=seconds)
    print(f"packets (a) passthrough: {out}")
    assert identical and not app.decoder_constructed, out
    assert sum(launches.values()) == 0, launches
    return out


def packet_processing(torch, clip: str, tmp: str) -> tuple[dict, dict]:
    """Phase 4i.b: the ``entry()`` parameters, processing from the start,
    .h264 out: the chain runs in I420, the port's decoder reads the output
    back as 1080p frames, as many as went in less the chain's queue, and
    K1 / K3 / K4 / K6 launch. p50 ms per frame of the decode
    (``PacketDecoderBridge.decode_unit``), the chain (the app's
    ``fused_chain`` stage: upload, chain, download) and the encode
    (``PacketEncoderBridge.encode_frame_yuv``), host clock."""

    from video_stab_tpu_torch.utils.config import AppConfig

    kw = entry_params()
    out_path = os.path.join(tmp, "processed.h264")
    cfg = AppConfig(video_source=clip, output_source=out_path,
                    mode=kw["mode"], enhancer=kw["enhancer"],
                    roll_correction=kw["roll"], stabilizer=kw["stabilizer"])
    app = _packet_app(torch, cfg)
    assert app.graph.pipeline("output").listen_to == "processed_pkt"
    decode_ms, encode_ms = [], []
    app._pkt_decoder.decode_unit = _timed(app._pkt_decoder.decode_unit,
                                          decode_ms)
    app._pkt_encoder.encode_frame_yuv = _timed(
        app._pkt_encoder.encode_frame_yuv, encode_ms)
    processing = app.graph.pipeline("processing")
    output = app.graph.pipeline("output")
    # The decoder's parser holds the last frame until a flush, which a
    # live relay never sends: PKT_FRAMES - 1 frames reach the chain.
    n_in = PKT_FRAMES - 1
    zero_counts()
    t0 = time.perf_counter()
    app.graph.start()
    try:
        _wait(lambda: len(decode_ms) == PKT_FRAMES
              and app.chain is not None and app.chain._frames_in == n_in
              and output.frames_processed == processing.frames_processed
              == app._pkt_encoder.units_out, 180.0, "the processed stream")
    finally:
        app.stop()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = read_counts()
    queued = app.chain._frames_in - app.chain._emitted
    frames = _decode_file(out_path)
    n_out = app.metrics.counters["frames_out"]
    per_frame = {k: launches[k] / n_out for k in PKT_ENTRY_KERNELS}
    stages = app.metrics.timer.summary()
    out = dict(
        units_in=PKT_FRAMES, frames_in=n_in, frames_out=n_out,
        queued=queued,
        decoded_back=len(frames),
        output_format=app.chain.params.output_format,
        yuv_encodes=len(encode_ms),
        decode_p50_ms=_p50(decode_ms),
        fused_chain_p50_ms=stages["fused_chain"]["p50_ms"],
        encode_p50_ms=_p50(encode_ms), seconds=seconds,
        launches_per_output_frame=per_frame)
    print(f"packets (b) processing, entry() params: {out}")
    assert out["output_format"] == "i420" and len(encode_ms) == n_out, out
    assert len(frames) == n_out == n_in - queued > 0, out
    assert all(f.shape == (APP_H, APP_W, 3) for f in frames)
    assert float(np.asarray(frames[-1], np.float64).std()) > 5.0
    assert all(launches[k] > 0 for k in PKT_ENTRY_KERNELS), launches
    return out, launches


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def packet_rtsp(torch, clip: str) -> tuple[dict, dict]:
    """Phase 4i.c: ``configs/rtsp_serving.yaml`` through the port's
    ``load_config``, with the clip as its camera and an RTSP server on a
    free local port as its output. An in-process client (the port's
    ``RtspPacketSource`` and ``VideoDecoder``) joins; the app starts in
    passthrough and switches to processing once the client has decoded
    2 frames: the decoder attaches at the next IDR and frames keep
    flowing. The client must decode >= PKT_RTSP_MIN_FRAMES 1080p frames;
    K1 / K3 / K6 launch."""
    import dataclasses
    import threading

    from video_stab_tpu_torch.io.codec import VideoDecoder
    from video_stab_tpu_torch.io.packets import RtspPacketSource
    from video_stab_tpu_torch.utils.config import load_config

    url = f"rtsp://127.0.0.1:{_free_port()}/stabilized"
    cfg = dataclasses.replace(load_config(_repo_path(
        "configs", "rtsp_serving.yaml")), video_source=clip,
        output_source=url)
    app = _packet_app(torch, cfg)
    client = RtspPacketSource(url).start()
    got = {"frames": 0, "shapes": set(), "units": 0}
    stop = threading.Event()

    def receive():
        dec = VideoDecoder()
        while not stop.is_set():
            au = client.read(timeout=0.5)
            if au is None:
                continue
            got["units"] += 1
            for f in dec.decode(b"".join(au)):
                got["frames"] += 1
                got["shapes"].add(f.shape)
        dec.close()

    reader = threading.Thread(target=receive, daemon=True)
    reader.start()
    processing = app.graph.pipeline("processing")
    output = app.graph.pipeline("output")
    app.switch_passthrough()
    zero_counts()
    t0 = time.perf_counter()
    app.graph.start()
    try:
        _wait(lambda: got["frames"] >= 2, 60.0, "passthrough frames")
        before = got["frames"]
        assert not app.decoder_constructed
        app.switch_processing()
        # Done when the source is spent and nothing moves for 2 s (a
        # chain step takes well under that; the chain's own count moves
        # through its warm-up, when nothing comes out).
        _wait(lambda: app.source.eof, 60.0, "the end of the clip")
        _wait_quiet(lambda: (app.chain._frames_in,
                             processing.frames_processed,
                             output.frames_processed, got["frames"]),
                    2.0, 180.0, "the RTSP stream")
    finally:
        stop.set()
        reader.join(timeout=5.0)
        client.stop()
        app.stop()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = read_counts()
    n_out = app.metrics.counters["frames_out"]
    out = dict(url=url, frames_received=got["frames"],
               passthrough_frames_before_switch=before,
               processed_frames_out=n_out,
               chain_frames_in=app.chain._frames_in,
               decoder_constructed=app.decoder_constructed,
               shapes=sorted(got["shapes"]), seconds=seconds,
               fused_chain_p50_ms=app.metrics.timer.summary()[
                   "fused_chain"]["p50_ms"],
               launches_per_output_frame={
                   k: launches[k] / max(n_out, 1)
                   for k in PKT_RTSP_KERNELS})
    print(f"packets (c) rtsp_serving.yaml: {out}")
    assert got["frames"] >= PKT_RTSP_MIN_FRAMES, out
    assert got["shapes"] == {(APP_H, APP_W, 3)}, out
    assert app.decoder_constructed and n_out > 0, out
    # Every processed frame reached the client after the switch (its
    # decoder, too, holds the last one).
    assert got["frames"] - before >= n_out - 1, out
    assert all(launches[k] > 0 for k in PKT_RTSP_KERNELS), launches
    return out, launches


def packet_cli(tmp: str) -> dict:
    """Phase 4i.d: ``vstab-torch stabilize in.mp4 out.mp4 --device cuda``
    in a subprocess on a 640x360 MP4 the port's ``ContainerWriter``
    wrote: exit 0, and the output demuxes as H.264 to every frame."""

    from video_stab_tpu_torch.io.codec import (ContainerDemuxer,
                                               ContainerWriter, VideoDecoder)

    src = os.path.join(tmp, "in.mp4")
    dst = os.path.join(tmp, "out.mp4")
    w = ContainerWriter(src, 640, 360, 30.0)
    for f in make_frames(360, 640, PKT_CLI_FRAMES, seed=SEED + 13):
        w.write(f)
    w.close()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "video_stab_tpu_torch.cli", "stabilize", src,
         dst, "--device", "cuda"], cwd=_repo_path(), capture_output=True,
        text=True, timeout=300)
    seconds = time.perf_counter() - t0
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout else ""
    print(f"packets (d) cli stabilize in.mp4 out.mp4: exit "
          f"{proc.returncode} in {seconds:.1f} s: {last}")
    assert proc.returncode == 0, proc.stderr[-4000:]
    dm = ContainerDemuxer(dst)
    dec = VideoDecoder()
    frames = []
    while (pkt := dm.read()) is not None:
        frames += dec.decode(pkt)
    frames += dec.flush()
    codec_name = dm.codec_name
    dm.close()
    dec.close()
    out = dict(exit=proc.returncode, seconds=seconds,
               result=json.loads(last), codec=codec_name,
               frames_decoded=len(frames))
    assert codec_name == "h264" and len(frames) == PKT_CLI_FRAMES, out
    assert frames[0].shape == (360, 640, 3)
    return out


def run_packet_phase(torch) -> tuple[dict, dict, dict]:
    """Phase 4i, the codec layer and the packet graph. -> (the
    {"packets": ...} numbers, launches by run, frames by run); with no
    codec on the machine, the toolchain and the reason only."""
    import tempfile

    tool = packet_toolchain()
    if not tool["libx264_available"]:
        # packet_toolchain raised unless the machine lacks a piece.
        numbers = dict(available=False, reason=tool["reason"],
                       missing=tool["missing"], toolchain=tool)
        print(json.dumps({"packets": {"available": False,
                                      "missing": tool["missing"],
                                      "reason": tool["reason"]}}))
        return numbers, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "clip.h264")
        packet_clip(clip)
        passthrough = packet_passthrough(torch, clip, tmp)
        processing, proc_launches = packet_processing(torch, clip, tmp)
        rtsp, rtsp_launches = packet_rtsp(torch, clip)
        cli_run = packet_cli(tmp)
    numbers = dict(available=True, toolchain=tool, passthrough=passthrough,
                   processing=processing, rtsp_serving=rtsp, cli=cli_run)
    by_run = {"packets entry() 1080p": proc_launches,
              "packets rtsp_serving 1080p": rtsp_launches}
    frames = {"packets entry() 1080p": processing["frames_out"],
              "packets rtsp_serving 1080p": rtsp["processed_frames_out"]}
    return numbers, by_run, frames


class Lap:
    """Prints the seconds each phase took (host clock), for the script's
    own time budget."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, label: str) -> None:
        now = time.perf_counter()
        print(f"time: {label} {now - self.t:.1f} s")
        self.t = now


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

    lap = Lap()
    kernels = check_kernels(torch, dev, launch_floor)
    for name, row in check_legacy_shapes(torch, dev).items():
        kernels[name]["legacy_shape"] = row
    lap("phase 3")
    for name, row in check_batched_kernels(torch, dev).items():
        kernels[name]["multistream"] = row
    lap("phase 3, the stream axis")
    ms_paths, ms_numbers = run_multistream(torch, dev)
    lap("phase 4g")

    pool = torch.from_numpy(make_frames(1080, 1920, N_FRAMES)).to(dev)
    config_paths, config_numbers = run_configs(torch, dev, pool)
    config_numbers["wide band pre-stages ms"] = wide_band_stages(torch, dev,
                                                                 pool)
    by_path = {"chain": run_slice(torch, dev, pool),
               "homography stream": run_homography_stream(torch, dev, pool),
               **run_offline(torch, dev, pool),
               **run_smoother_streams(torch, dev, pool)}
    frames = {"chain": N_FRAMES, "homography stream": N_FRAMES,
              "offline similarity+box": OFFLINE_SLICE_FRAMES,
              "offline homography+box": OFFLINE_SLICE_FRAMES,
              **{f"stream {name}": SMOOTHER_FRAMES
                 for name in STREAM_SMOOTHERS}}
    by_path.update(config_paths)
    frames.update({label: CONFIG_FRAMES for label in config_paths})
    lap("phases 4a-4e")
    variant_paths, variant_numbers = run_variants(torch, dev, pool)
    lap("phase 4f")
    by_path.update(variant_paths)
    frames.update({label: VARIANT_FRAMES for label in variant_paths})
    # The multi-stream runs count per tick (8 frames).
    by_path.update(ms_paths)
    frames.update({label: MS_TICKS for label in ms_paths})
    steady_state(torch, dev, pool)
    routes = lk_routes(torch, dev, pool)
    del pool
    lap("phases 5a, 5c")
    offline = offline_throughput(torch, dev)
    lap("offline throughput")
    by_path.update(offline)
    frames.update({label: OFFLINE_TIMED_FRAMES for label in offline})
    small_reference(torch, dev)
    small_reference_configs(torch)
    small_reference_multistream(torch)
    lap("phase 5b")
    app_numbers, app_paths, app_frames = run_app_phase(torch, dev)
    lap("phase 4h")
    by_path.update(app_paths)
    frames.update(app_frames)
    packet_numbers, packet_paths, packet_frames = run_packet_phase(torch)
    lap("phase 4i")
    by_path.update(packet_paths)
    frames.update(packet_frames)

    meta = {
        "warp_affine_u8": ("video_stab_tpu_torch/csrc/warp.cu",
                           "video_stab_tpu/pallas/warp.py:112"),
        "warp_homography_u8": ("video_stab_tpu_torch/csrc/warp.cu",
                               "video_stab_tpu/pallas/warp.py:424"),
        "corner_response": ("video_stab_tpu_torch/csrc/features.cu",
                            "video_stab_tpu/pallas/features.py:43"),
        "enhance_u8": ("video_stab_tpu_torch/csrc/enhance.cu",
                       "video_stab_tpu/pallas/enhance.py:28"),
        "enhance_head": ("video_stab_tpu_torch/csrc/enhance.cu",
                         "video_stab_tpu/pallas/enhance.py:28"),
        "enhance_tail": ("video_stab_tpu_torch/csrc/enhance.cu",
                         "video_stab_tpu/pallas/enhance.py:28"),
        "box_filter_convolve": ("video_stab_tpu_torch/csrc/traj.cu",
                                "video_stab_tpu/pallas/traj.py:55"),
        "box_filter_centered": ("video_stab_tpu_torch/csrc/traj.cu",
                                "video_stab_tpu/pallas/traj.py:94"),
        # K6d, the Newton loop; the gather probes K6a-K6c in "also_replaces"
        "lk_track": ("video_stab_tpu_torch/csrc/lk.cu",
                     "tools/lk_inkernel_probe.py:332"),
        # No Pallas kernel: the JAX package's jax.lax.while_loop
        "interior_rect": ("video_stab_tpu_torch/csrc/azc.cu",
                          "video_stab_tpu/core/autozoomcrop.py:33"),
        # No Pallas kernel: XLA ops (gray, threshold, close)
        "content_mask": ("video_stab_tpu_torch/csrc/azc.cu",
                         "video_stab_tpu/core/autozoomcrop.py:105"),
        # No Pallas kernel: XLA ops (pyramids, Scharr, bfloat16 rounding)
        "lk_planes": ("video_stab_tpu_torch/csrc/lk_planes.cu",
                      "video_stab_tpu/ops/lk.py"),
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
                      "template_floor_cycles", "launch_floor_us",
                      "launch_floor_queued_us", "launch", "launches_per_call", "values_differ",
                      "legacy_shape", "ptxas", "sass_loop",
                      "instructions_per_value", "issue_floor_us",
                      "device_us_gamma_off", "device_us_no_gray", "sweep"):
            if extra in k:
                row[extra] = k[extra]
        if "multistream" in k:
            row["multistream"] = dict(k["multistream"], launches_per_tick={
                route: r["kernel_launches_per_tick"][name]
                for route, r in (("batched", ms_numbers["turns"]["batched"][0]),
                                 ("looped", ms_numbers["turns"]["looped"][0]),
                                 ("homography batched",
                                  ms_numbers["homography batched"]))})
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
        # K1-K4 move bytes: their operations stay under their bytes.
        if name in ("warp_affine_u8", "warp_homography_u8",
                    "corner_response", "enhance_u8", "enhance_head",
                    "enhance_tail"):
            assert row["bound_by"] == "bytes", row
    print(json.dumps({"lk_routes": routes}))
    print(json.dumps({"configs": config_numbers}))
    print(json.dumps({"variants": variant_numbers}))
    print(json.dumps({"multistream": ms_numbers}))
    print(json.dumps({"app": app_numbers}))
    print(json.dumps({"packets": packet_numbers}))
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
