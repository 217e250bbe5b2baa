"""Structured logging, counters and per-stage timing — port of
``video_stab_tpu/utils/telemetry.py``.

Named counters, per-stage millisecond histograms and an FPS meter, cheap
enough for per-frame use, plus a ``trace`` context manager that labels a
range in ``torch.profiler`` timelines. ``start_profiler_trace`` /
``stop_profiler_trace`` record a ``torch.profiler`` trace of the card (and
the host) into a directory, where the JAX package uses ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, Optional


def get_logger(tag: str, enabled: bool = True,
               level: int = logging.INFO) -> logging.Logger:
    """Tagged logger matching the reference's `[Component] msg` convention."""
    logger = logging.getLogger(f"video_stab_tpu_torch.{tag}")
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(f"[{tag}] %(message)s"))
        logger.addHandler(h)
        logger.propagate = False
    logger.setLevel(level if enabled else logging.CRITICAL)
    return logger


class StageTimer:
    """Per-stage wall-time accumulator with simple percentile estimates."""

    def __init__(self, keep_last: int = 300):
        self.keep_last = keep_last
        self._samples: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1e3
            buf = self._samples[name]
            buf.append(dt)
            if len(buf) > self.keep_last:
                del buf[:len(buf) - self.keep_last]

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, buf in self._samples.items():
            if not buf:
                continue
            s = sorted(buf)
            out[name] = {
                "n": len(s),
                "mean_ms": sum(s) / len(s),
                "p50_ms": s[len(s) // 2],
                "p95_ms": s[min(int(len(s) * 0.95), len(s) - 1)],
                "max_ms": s[-1],
            }
        return out


class FpsMeter:
    """Sliding-window FPS (the reference prints every 30/300 frames)."""

    def __init__(self, window: int = 120):
        self.window = window
        self._stamps: list = []

    def tick(self) -> float:
        now = time.perf_counter()
        self._stamps.append(now)
        if len(self._stamps) > self.window:
            del self._stamps[:len(self._stamps) - self.window]
        if len(self._stamps) < 2:
            return 0.0
        dt = self._stamps[-1] - self._stamps[0]
        return (len(self._stamps) - 1) / dt if dt > 0 else 0.0


class Metrics:
    """Named counters + gauges: fps, dropped frames, feature count, RANSAC
    inlier ratio, correction magnitude."""

    def __init__(self):
        self.counters: Dict[str, int] = defaultdict(int)
        self.gauges: Dict[str, float] = {}
        self.timer = StageTimer()
        self.fps = FpsMeter()

    def inc(self, name: str, n: int = 1):
        self.counters[name] += n

    def set(self, name: str, value: float):
        self.gauges[name] = float(value)

    def snapshot(self) -> dict:
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "stages": self.timer.summary(),
        }


@contextlib.contextmanager
def trace(name: str):
    """A labelled range in ``torch.profiler`` timelines (no cost to speak
    of when no profiler runs)."""
    import torch
    with torch.profiler.record_function(name):
        yield


# The trace that start_profiler_trace began, until stop_profiler_trace.
_trace_lock = threading.Lock()
_active: Optional[tuple] = None


def start_profiler_trace(logdir: str) -> None:
    """Begin recording a ``torch.profiler`` trace of the host and, where
    there is one, the card."""
    import torch
    global _active
    with _trace_lock:
        if _active is not None:
            raise RuntimeError("a profiler trace is already running")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        _active = (prof, logdir)


def stop_profiler_trace() -> str:
    """End the trace and write it as ``<logdir>/trace.json`` (Chrome trace
    format; open in Perfetto or chrome://tracing). Returns the path."""
    global _active
    with _trace_lock:
        if _active is None:
            raise RuntimeError("no profiler trace is running")
        prof, logdir = _active
        _active = None
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    return path
