"""Command-line interface of the port — counterpart of
``video_stab_tpu/cli.py``:

  python -m video_stab_tpu_torch.cli run <config.yaml> [--duration S]
                                         [--frames N] [--rest] [--tcp]
                                         [--packet auto|on|off]
  python -m video_stab_tpu_torch.cli stabilize <in.mp4> <out.mp4>
                                               [--radius N] ...
  python -m video_stab_tpu_torch.cli offline <in> <out> [--method l1]
  python -m video_stab_tpu_torch.cli selftest        # synthetic end to end
  python -m video_stab_tpu_torch.cli profile         # torch.profiler trace

(or ``vstab-torch <command>`` once installed). Every command runs on the
card unless ``--device cpu`` asks for the CPU; for ``run`` the YAML's
``mode.use_cuda`` decides, and ``--device`` overrides it. ``bench``,
``train-detector`` and ``train-deepstab`` are not ported yet and exit
non-zero, naming their ROADMAP items.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

NOT_PORTED = {
    "bench": "the port's benchmark is ROADMAP queue 1 item 1",
    "train-detector": "training is ROADMAP queue 1 item 12b",
    "train-deepstab": "training is ROADMAP queue 1 item 12b",
}


def _quiet_cv2():
    try:
        import cv2
        cv2.setNumThreads(0)
    except ImportError:
        pass


def _mode(args):
    """The ModeParams that put a command on ``--device``."""
    from video_stab_tpu_torch.core.params import ModeParams
    return ModeParams(use_cuda=args.device != "cpu")


def cmd_run(args) -> int:
    _quiet_cv2()
    from video_stab_tpu_torch.io.runner import run_app

    pkt = {"auto": None, "on": True, "off": False}[args.packet]
    use_cuda = None if args.device is None else args.device == "cuda"
    app = run_app(args.config, enable_rest=args.rest, enable_tcp=args.tcp,
                  max_frames=args.frames, packet_mode=pkt, use_cuda=use_cuda)
    print(f"[cli] running {args.config} on {app.device} "
          f"(duration={args.duration or 'inf'}s frames={args.frames or 'inf'}"
          f" packet_mode={app.packet_mode})")
    app.run(duration=args.duration)
    snap = app.metrics.snapshot()
    print(json.dumps(snap, indent=2, default=str))
    return 0


def cmd_stabilize(args) -> int:
    """File in -> stabilized file out (the roll-correction-file.cpp /
    file-capture.cpp style one-shot path)."""
    _quiet_cv2()
    import cv2

    from video_stab_tpu_torch.core.params import StabilizerParams
    from video_stab_tpu_torch.core.stabilizer import Stabilizer
    from video_stab_tpu_torch.io.sinks import open_sink

    cap = cv2.VideoCapture(args.input)
    if not cap.isOpened():
        print(f"cannot open {args.input}", file=sys.stderr)
        return 1
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    st = Stabilizer(StabilizerParams(
        smoothing_radius=args.radius, border_type=args.border,
        border_size=args.border_size, crop_n_zoom=args.crop,
        smoothing_method=args.method), mode=_mode(args))
    sink = open_sink(args.output, fps=fps)
    n_in = n_out = 0
    t0 = time.perf_counter()
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        n_in += 1
        out = st.stabilize(frame)
        if out is not None:
            sink.write(out)
            n_out += 1
    while (out := st.flush()) is not None:
        sink.write(out)
        n_out += 1
    sink.close()
    cap.release()
    dt = time.perf_counter() - t0
    print(json.dumps({"frames_in": n_in, "frames_out": n_out,
                      "seconds": round(dt, 2),
                      "fps": round(n_in / dt, 1) if dt else 0.0,
                      "device": str(st.device)}))
    return 0


def cmd_offline(args) -> int:
    """Whole-clip batch stabilization (supports the cinematic --method l1
    path)."""
    _quiet_cv2()
    import cv2
    import numpy as np

    from video_stab_tpu_torch.core.params import StabilizerParams
    from video_stab_tpu_torch.io.sinks import open_sink
    from video_stab_tpu_torch.offline import stabilize_clip

    cap = cv2.VideoCapture(args.input)
    if not cap.isOpened():
        print(f"cannot open {args.input}", file=sys.stderr)
        return 1
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok or (args.max_frames and len(frames) >= args.max_frames):
            break
        frames.append(frame)
    cap.release()
    if not frames:
        print("no frames decoded", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    out = stabilize_clip(np.stack(frames), StabilizerParams(
        smoothing_radius=args.radius, smoothing_method=args.method,
        border_size=args.border_size, crop_n_zoom=args.crop),
        mode=_mode(args))
    dt = time.perf_counter() - t0
    sink = open_sink(args.output, fps=fps)
    for f in out:
        sink.write(f)
    sink.close()
    print(json.dumps({"frames": len(frames), "seconds": round(dt, 2),
                      "fps": round(len(frames) / dt, 1)}))
    return 0


def cmd_selftest(args) -> int:
    """Synthetic end-to-end run: synthetic source -> enhance -> roll ->
    stabilize, with the queue drained. No hardware but the card, no files.
    """
    _quiet_cv2()
    from video_stab_tpu_torch import pick_device
    from video_stab_tpu_torch.core.enhancer import Enhancer
    from video_stab_tpu_torch.core.params import (
        EnhancerParams,
        RollCorrectionParams,
        StabilizerParams,
    )
    from video_stab_tpu_torch.core.rollcorrection import RollCorrection
    from video_stab_tpu_torch.core.stabilizer import Stabilizer
    from video_stab_tpu_torch.io.sources import SourceParams, SyntheticSource

    mode = _mode(args)
    dev = pick_device(mode.use_cuda)
    # Synchronous read: a threaded bounded queue would drop frames while
    # the first steps run, which is not what a selftest should measure.
    src = SyntheticSource(SourceParams(source="synthetic",
                                       threaded_queue_mode=False),
                          height=96, width=128, n_frames=16, seed=1).start()
    en = Enhancer(EnhancerParams(brightness=5.0, contrast=1.1, gamma=0.95),
                  device=dev)
    roll = RollCorrection(RollCorrectionParams(scale_factor=0.5), device=dev)
    st = Stabilizer(StabilizerParams(
        smoothing_radius=5, analysis_width=128, analysis_height=96,
        max_corners=64, ransac_hypotheses=64), mode=mode)
    n_out = 0
    for _ in range(16):
        frame = src.read(timeout=2.0)
        if frame is None:
            break
        frame = en.enhance(frame)
        frame = roll.auto_correct_roll(frame)
        out = st.stabilize(frame)
        if out is not None:
            n_out += 1
    while st.flush() is not None:
        n_out += 1
    src.stop()
    ok = n_out >= 12
    print(json.dumps({"selftest": "ok" if ok else "FAIL",
                      "frames_out": n_out, "device": str(dev)}))
    return 0 if ok else 1


def cmd_profile(args) -> int:
    """Record a torch.profiler trace of the steady-state stabilizer step
    (``<logdir>/trace.json``, Chrome trace format)."""
    import numpy as np
    import torch

    from video_stab_tpu_torch.core.params import StabilizerParams
    from video_stab_tpu_torch.core.stabilizer import Stabilizer
    from video_stab_tpu_torch.utils.telemetry import (start_profiler_trace,
                                                      stop_profiler_trace)

    p = StabilizerParams(smoothing_radius=15)
    st = Stabilizer(p, mode=_mode(args))
    rng = np.random.default_rng(0)
    frame = torch.from_numpy(rng.integers(
        0, 255, (args.height, args.width, 3), dtype=np.uint8)).to(st.device)

    def sync():
        if st.device.type == "cuda":
            torch.cuda.synchronize(st.device)

    for _ in range(p.effective_radius + 2):   # fill the queue + warm up
        st.stabilize_device(frame)
    sync()
    start_profiler_trace(args.logdir)
    for _ in range(args.frames):
        st.stabilize_device(frame)
    sync()
    path = stop_profiler_trace()
    print(json.dumps({"trace": path, "frames": args.frames,
                      "device": str(st.device)}))
    return 0


def cmd_not_ported(args) -> int:
    print(f"vstab-torch {args.cmd}: not ported yet: {NOT_PORTED[args.cmd]}",
          file=sys.stderr)
    return 2


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="vstab-torch",
        description="video stabilization, PyTorch/CUDA port")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_arg(parser, default):
        parser.add_argument(
            "--device", choices=("cuda", "cpu"), default=default,
            help="where to run (default: %(default)s)")

    pr = sub.add_parser("run", help="run from a YAML config (vsg.cpp mode)")
    pr.add_argument("config")
    pr.add_argument("--duration", type=float, default=0.0)
    pr.add_argument("--frames", type=int, default=0)
    pr.add_argument("--rest", action="store_true")
    pr.add_argument("--tcp", action="store_true")
    pr.add_argument("--packet", choices=("auto", "on", "off"),
                    default="auto",
                    help="compressed-domain graph (auto: when both "
                         "endpoints speak H.264 / HEVC packets)")
    device_arg(pr, None)
    pr.set_defaults(fn=cmd_run)

    ps = sub.add_parser("stabilize", help="stabilize a video file")
    ps.add_argument("input")
    ps.add_argument("output")
    ps.add_argument("--radius", type=int, default=15)
    ps.add_argument("--border", default="black")
    ps.add_argument("--border-size", type=int, default=0, dest="border_size")
    ps.add_argument("--crop", action="store_true")
    ps.add_argument("--method", default="box",
                    choices=["box", "gaussian", "kalman", "butterworth"])
    device_arg(ps, "cuda")
    ps.set_defaults(fn=cmd_stabilize)

    po = sub.add_parser("offline", help="batch-stabilize a whole clip")
    po.add_argument("input")
    po.add_argument("output")
    po.add_argument("--radius", type=int, default=15)
    po.add_argument("--method", default="l1",
                    choices=["box", "gaussian", "kalman", "butterworth",
                             "l1"])
    po.add_argument("--border-size", type=int, default=0, dest="border_size")
    po.add_argument("--crop", action="store_true")
    po.add_argument("--max-frames", type=int, default=0, dest="max_frames")
    device_arg(po, "cuda")
    po.set_defaults(fn=cmd_offline)

    pt = sub.add_parser("selftest", help="synthetic end-to-end run")
    device_arg(pt, "cuda")
    pt.set_defaults(fn=cmd_selftest)

    pp = sub.add_parser("profile", help="record a torch.profiler trace")
    pp.add_argument("--logdir", default=os.path.join(tempfile.gettempdir(),
                                                     "vstab_trace"))
    pp.add_argument("--frames", type=int, default=30)
    pp.add_argument("--width", type=int, default=1920)
    pp.add_argument("--height", type=int, default=1080)
    device_arg(pp, "cuda")
    pp.set_defaults(fn=cmd_profile)

    # Not ported yet; the JAX CLI's arguments are accepted.
    nps = {name: sub.add_parser(name, help=f"not ported yet ({why})")
           for name, why in NOT_PORTED.items()}
    for name in ("train-detector", "train-deepstab"):
        nps[name].add_argument("--steps", type=int)
        nps[name].add_argument("--batch", type=int)
    nps["train-deepstab"].add_argument("--out", default="")
    for pn in nps.values():
        pn.set_defaults(fn=cmd_not_ported)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
