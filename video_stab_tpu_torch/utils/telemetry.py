"""Structured logging, counters, spans and per-stage timing — port of
``video_stab_tpu/utils/telemetry.py``.

- ``Metrics``: the app's named counters, gauges and per-stage millisecond
  histograms (``vstab-torch run``'s final snapshot).
- ``trace(name)``: a span of the per-frame path, a
  ``torch.profiler.record_function`` range while a profiler records on
  this thread and a shared null context otherwise, so a span costs one
  check when nothing traces. The spans land in the profiler's chrome
  trace as ``user_annotation`` events, on the device records' clock.
- ``count(name, n)`` / ``counters()``: the process's host-side counters
  of the per-frame path (the GFTT NMS's host reads and rounds, the legacy
  re-detect flag's reads), always on.
- ``start_profiler_trace`` / ``stop_profiler_trace``: a ``torch.profiler``
  trace of the card (and the host) into a directory, where the JAX
  package uses ``jax.profiler``.
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

import torch


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


class Metrics:
    """Named counters + gauges: dropped frames, feature count, RANSAC
    inlier ratio, correction magnitude."""

    def __init__(self):
        self.counters: Dict[str, int] = defaultdict(int)
        self.gauges: Dict[str, float] = {}
        self.timer = StageTimer()

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


_NO_SPAN = contextlib.nullcontext()


def trace(name: str):
    """A span named ``name``: a ``torch.profiler.record_function`` range
    while a profiler records on this thread, else a shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


_counter_lock = threading.Lock()
_counters: Dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process-wide counter ``name``."""
    with _counter_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of every counter since the process started."""
    with _counter_lock:
        return dict(_counters)


# The trace that start_profiler_trace began, until stop_profiler_trace.
_trace_lock = threading.Lock()
_active: Optional[tuple] = None


def start_profiler_trace(logdir: str) -> None:
    """Begin recording a ``torch.profiler`` trace of the host and, where
    there is one, the card."""
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
