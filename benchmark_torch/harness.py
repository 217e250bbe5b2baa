"""One run of one cell: set-up, the measured window, the traced window,
and the comparison with the plain reference.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own that this module finds by name:

- the cell ``<config>.<traffic>`` of ``BENCHMARK.json``;
- ``configs/<config>.json``: the deployment as it is run, with the
  ``system`` (``systems/<system>.py``, the program's wrapper under test),
  the ``reference`` (``reference/<reference>.py``, whose ``outputs`` gives
  the frames the system should deliver) and the limits of its
  correctness numbers;
- ``traffic/<traffic>.json``: the mix, read by ``drive`` below;
- ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: one reader per
  metric, named as in ``BENCHMARK.json``;
- ``work/<kernel>.py``: the bytes and operations of one kernel's launch.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from benchmark_torch import compare, frames
from benchmark_torch.host import HostWatch
from benchmark_torch.trace import read_chrome_trace

HERE = Path(__file__).resolve().parent
WARM_OUTPUTS = 8          # delivered frames of the warm-up
TRACE_SKIP = 4            # window calls before the first traced one
TRACE_WARMUP = 2          # profiled calls the profiler discards
TRACE_ATTEMPTS = 4        # traces taken until one keeps every kernel
SYNC_CALLS = 8            # calls under torch's sync debug mode


def load_module(path: Path):
    """Import the file ``path`` (its name may hold dots) as a module."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_torch._x_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A workload of the manifest resolved to its files."""

    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(manifest: dict, workload: str, root: Path,
            bench: Path = HERE) -> Cell:
    """The cell ``workload`` of ``manifest``: its configuration (a path
    from ``root``) and traffic (in ``bench``) files read, and the metrics
    it reports."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    with open(root / entry["file"]) as f:
        config = json.load(f)
    with open(bench / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name=workload, config=config,
                traffic=traffic,
                end_to_end=[m for m in manifest["end_to_end"]
                            if _applies(m, workload)],
                per_layer=[m for m in manifest["per_layer"]
                           if _applies(m, workload)])


def make_pool(cfg: dict, seed: int, device: torch.device) -> torch.Tensor:
    """The run's frames from the seed: (P, S, H, W, 3) uint8 on
    ``device``."""
    return frames.make_pool(seed, cfg["pool_frames"], cfg["streams"],
                            cfg["height"], cfg["width"], device)


def load_reference(cfg: dict, bench: Path = HERE):
    """The configuration's plain reference, ``reference/<name>.py``."""
    return load_module(bench / "reference" / f"{cfg['reference']}.py")


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time, 10 ms
    resolution; without /proc, since this module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) \
            - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


@dataclass
class Window:
    """What the measured window saw."""

    setup_s: float = 0.0
    first_call: int = 0
    calls: int = 0
    frames_per_call: int = 1
    failed_calls: int = 0
    elapsed_s: float = 0.0
    latencies_s: list = field(default_factory=list)
    late_s: float = 0.0           # the most an open-loop call was sent late
    call_s: list = field(default_factory=list)   # each call's own time
    kept: dict = field(default_factory=dict)     # call -> delivered frames
    last: tuple = ()              # (call, frames) of the last delivery

    @property
    def frames(self) -> int:
        return (self.calls - self.failed_calls) * self.frames_per_call


class Tracer:
    """The traced part of a ``--trace 1`` window: profiled calls (a new
    trace while the last one dropped kernel records, up to
    TRACE_ATTEMPTS), then SYNC_CALLS calls under torch's sync debug mode."""

    def __init__(self, active: int, device: torch.device):
        self.active = active
        self.cuda = device.type == "cuda"
        self.traces = []
        self.phase = "wait"
        self._prof = None
        self._steps = 0
        self._caught = None
        self._catcher = None
        self.sync_calls = 0
        self.syncs = 0

    @property
    def done(self) -> bool:
        return self.phase == "done"

    def before(self, k: int) -> None:
        """Before the k-th call of the window."""
        from torch.profiler import ProfilerActivity, profile, schedule
        if self.phase == "wait" and k >= TRACE_SKIP:
            self.phase = "profile"
        if self.phase == "profile" and self._prof is None:
            acts = [ProfilerActivity.CPU] + \
                ([ProfilerActivity.CUDA] if self.cuda else [])
            self._prof = profile(
                activities=acts, on_trace_ready=self._read,
                schedule=schedule(wait=0, warmup=TRACE_WARMUP,
                                  active=self.active, repeat=1))
            self._prof.__enter__()
            self._steps = 0
        if self.phase == "sync" and self._catcher is None:
            self._catcher = warnings.catch_warnings(record=True)
            self._caught = self._catcher.__enter__()
            warnings.simplefilter("always")
            if self.cuda:
                torch.cuda.set_sync_debug_mode("warn")

    def after(self) -> None:
        """After a call."""
        if self.phase == "profile":
            self._prof.step()
            self._steps += 1
            if self._steps == TRACE_WARMUP + self.active:
                self._prof.__exit__(None, None, None)
                self._prof = None
                if not self.cuda or self.traces[-1].complete or \
                        len(self.traces) >= TRACE_ATTEMPTS:
                    self.phase = "sync"
                else:
                    print(f"trace {len(self.traces)}: "
                          f"{self.traces[-1].kernel_records} kernel records "
                          f"for {self.traces[-1].launches} launches; "
                          f"tracing again", file=sys.stderr)
        elif self.phase == "sync":
            self.sync_calls += 1
            if self.sync_calls == SYNC_CALLS:
                if self.cuda:
                    torch.cuda.set_sync_debug_mode("default")
                self._catcher.__exit__(None, None, None)
                # Counted as chip_smoke.py's count_syncs counts them: the
                # synchronizing calls the program's own lines make.
                self.syncs = sum(1 for w in self._caught
                                 if "synchroniz" in str(w.message)
                                 and "video_stab_tpu_torch" in w.filename)
                self.phase = "done"

    def _read(self, prof) -> None:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            self.traces.append(read_chrome_trace(path))
        finally:
            os.unlink(path)

    def best(self):
        """The trace that kept the largest share of its kernel records."""
        return max(self.traces, key=lambda t: (t.complete, t.kernel_records
                                               / max(t.launches, 1)))


def _call(system, i: int, window: Window, sample, tracer) -> None:
    """One call of the window: a call that raises or delivers nothing
    counts as failed."""
    if tracer is not None:
        tracer.before(i - window.first_call)
    t0 = time.perf_counter()
    try:
        with _label("bench.call", tracer):
            out = system.call(i)
    except Exception:                                    # noqa: BLE001
        if window.failed_calls == 0:
            traceback.print_exc()
        out = None
    if out is None:
        window.failed_calls += 1
    else:
        window.last = (i, out)
        if i in sample:
            window.kept[i] = out
    window.calls += 1
    window.call_s.append(time.perf_counter() - t0)
    if tracer is not None:
        tracer.after()


def _label(name: str, tracer):
    """A span of the harness's own in a traced run's trace."""
    if tracer is None:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def drive(system, traffic: dict, window: Window, seconds: float, sample,
          tracer=None, clock=time.perf_counter, sleep=time.sleep) -> None:
    """The measured window. An open loop (``"loop": "open"``) sends call i
    when it is due, at ``rate_per_s`` from the window's start, whatever
    the program is doing, and times it from its due time to its return;
    it offers rate x seconds calls. A closed loop sends the next call when
    the last returns, until ``seconds`` have passed."""
    first = window.first_call
    t0 = clock()
    if traffic["loop"] == "open":
        rate = float(traffic["rate_per_s"])
        n = int(round(rate * seconds))
        for k in range(n):
            due = t0 + k / rate
            now = clock()
            if now < due:
                with _label("bench.wait_for_due", tracer):
                    sleep(due - now)
            else:
                window.late_s = max(window.late_s, now - due)
            _call(system, first + k, window, sample, tracer)
            window.latencies_s.append(clock() - due)
    elif traffic["loop"] == "closed":
        while clock() - t0 < seconds:
            _call(system, first + window.calls, window, sample, tracer)
    else:
        raise ValueError(f"unknown loop {traffic['loop']!r}")
    window.elapsed_s = clock() - t0
    # A trace still open at the window's end runs on past it (a traced
    # run reports no end-to-end metric).
    while tracer is not None and not tracer.done:
        _call(system, first + window.calls, window, sample, tracer)


def sample_calls(seed: int, first: int, every: int) -> range:
    """The window calls whose delivered frames are compared: every
    ``every``-th from an offset drawn from the seed (``run`` adds the
    last)."""
    offset = int(np.random.default_rng(seed % (2 ** 63)).integers(every))
    return range(first + offset, sys.maxsize, every)


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run(manifest: dict, root: Path, workload: str, seed: int,
        seconds: float, trace: bool, device: torch.device,
        bench: Path = HERE) -> dict:
    """One run of ``workload``; the result line's object. ``bench``: the
    directory that holds the traffic, systems and metric readers."""
    marks = {"imports": process_age_s()}
    cell = resolve(manifest, workload, root, bench)
    cfg, traffic = cell.config, cell.traffic
    system_mod = load_module(bench / "systems" / f"{cfg['system']}.py")
    if device.type == "cuda":
        from video_stab_tpu_torch.kernels import _lib
        _lib.library()
    marks["kernels"] = process_age_s()
    reference = load_reference(cfg, bench)
    n_str = cfg["streams"]
    pool_dev = make_pool(cfg, seed, device)
    pool = pool_dev.cpu().numpy()
    del pool_dev
    marks["frames"] = process_age_s()
    system = system_mod.System(cfg, pool, frames.stream_seed(seed), device)
    first = system.lead + WARM_OUTPUTS
    for i in range(first):
        out = system.call(i)
        if (out is None) != (i < system.lead):
            raise RuntimeError(f"warm-up call {i} delivered "
                               f"{'nothing' if out is None else 'a frame'}")
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    window = Window(first_call=first, frames_per_call=n_str)
    sample = sample_calls(seed, first, int(traffic["sample_every"]))
    tracer = Tracer(int(traffic["traced_calls"]), device) if trace else None
    watch = HostWatch()
    window.setup_s = marks["warm_up"] = process_age_s()
    drive(system, traffic, window, seconds, sample, tracer)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    host = watch.read(window.call_s)
    host["torch_threads"] = torch.get_num_threads()
    system.close()
    del system
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = {}
    kept = dict(window.kept)
    if window.last:
        kept[window.last[0]] = window.last[1]
    if kept:
        pool_dev = make_pool(cfg, seed, device)
        ref = reference.outputs(cfg, pool_dev, first + window.calls, seed,
                                sorted(kept))
        checks = compare.numbers(kept, ref)
    limits = cfg["correct_limits"]
    ok = bool(kept) and window.failed_calls == 0 and all(
        checks[k] <= limits[k] for k in limits)

    result = {"correct": ok,
              "attempted": window.calls * n_str,
              "failed": window.failed_calls * n_str}
    metrics = {}
    if trace:
        ctx = Reading(cfg=cfg, trace=tracer.best(), tracer=tracer,
                      frames_per_call=n_str)
        for m in cell.per_layer:
            v = load_module(bench / "metrics" / f"{m['name']}.py").read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v = load_module(bench / "end_to_end" / f"{m['name']}.py").read(
                window)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak),
           "name_and_power_limit": power_limit()
           if device.type == "cuda" else None}
    if trace:
        best = tracer.best()
        dev.update(busy_s=best.busy_s(), window_s=best.window_s)
        result["breakdown"] = {"device_ops": best.device_ops(),
                               "idle_gaps": best.idle_gaps()}
    result["device"] = dev
    # Where set-up went: seconds since the process started at the end of
    # each of its phases.
    result["setup_marks_s"] = marks
    result["call_ms"] = {f"p{q}": float(np.percentile(window.call_s, q)) * 1e3
                         for q in (10, 50, 90, 99)} if window.call_s else {}
    if traffic["loop"] == "open":
        result["open_loop_late_ms_max"] = window.late_s * 1e3
        if window.latencies_s:
            result["frame_latency_ms"] = {
                f"p{q}": float(np.percentile(window.latencies_s, q)) * 1e3
                for q in (50, 95, 99)}
    result["host"] = host
    result["frames_compared"] = sum(v.shape[0] for v in kept.values())
    result["sampled_calls"] = sorted(kept)
    result["calls_made"] = first + window.calls
    result["checks"] = {k: {"value": checks.get(k), "limit": limits[k]}
                        for k in limits}
    return result


@dataclass
class Reading:
    """What a per-layer metric's reader reads: the configuration, the
    chosen trace, the tracer (its sync count) and the frames a call
    delivers."""

    cfg: dict
    trace: object
    tracer: Tracer
    frames_per_call: int
