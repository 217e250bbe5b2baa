"""Readings of the host that a run's window ran on, printed beside the
result (key ``host``) so that runs that spread apart can be told apart by
their host: how fast one core ran a fixed loop before and after the
window, how fast it copied memory, how much of the window the process
was on a CPU, and, where ``/proc`` has them, the load average, the share
of the host's CPU time stolen by other guests and the cores' clock. The
driver reads none of it; no metric is corrected by it.
"""

from __future__ import annotations

import resource
import time

import numpy as np

PROBE_LOOPS = 200_000     # iterations of the fixed loop (~10 ms a pass)
PROBE_PASSES = 3
COPY_BYTES = 64 << 20


def cpu_probe_ms() -> float:
    """The fastest of PROBE_PASSES passes of a fixed pure-Python loop, ms:
    the speed one core gave this process."""
    best = float("inf")
    for _ in range(PROBE_PASSES):
        t0 = time.perf_counter()
        x = 0
        for i in range(PROBE_LOOPS):
            x += i * i
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def copy_probe_gb_s() -> float:
    """Bytes a host memcpy of COPY_BYTES moves a second (the fastest of
    PROBE_PASSES), GB/s: the bandwidth that pageable copies also draw on."""
    src = np.ones(COPY_BYTES, np.uint8)
    dst = np.empty_like(src)
    best = float("inf")
    for _ in range(PROBE_PASSES):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        best = min(best, time.perf_counter() - t0)
    return COPY_BYTES / best / 1e9


def _proc_stat() -> list | None:
    """The host's CPU time so far, ``/proc/stat``'s first line (user, nice,
    system, idle, iowait, irq, softirq, steal, ...), in clock ticks."""
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        return None


def proc_readings() -> dict:
    """The load average over one minute and the mean clock of the cores
    in MHz, where ``/proc`` has them."""
    out = {}
    try:
        with open("/proc/loadavg") as f:
            out["loadavg_1m"] = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        pass
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f
                   if line.startswith("cpu MHz")]
        if mhz:
            out["cpu_mhz_mean"] = sum(mhz) / len(mhz)
            out["cpu_mhz_min"] = min(mhz)
    except (OSError, ValueError, IndexError):
        pass
    return out


def _cpu_s() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


class HostWatch:
    """Started at the window's open, read at its close."""

    def __init__(self):
        self.probe_before_ms = cpu_probe_ms()
        self.proc_before = proc_readings()
        self._stat = _proc_stat()
        self._t = time.perf_counter()
        self._cpu = _cpu_s()

    def read(self, call_s: list) -> dict:
        """The readings over the window whose calls took ``call_s``
        seconds each."""
        wall = time.perf_counter() - self._t
        out = {"cpu_probe_ms_before": self.probe_before_ms,
               "process_cpu_share": (_cpu_s() - self._cpu) / wall}
        # Each fifth of the window's calls, its median call: how far the
        # host's speed moved within the window.
        if len(call_s) >= 5:
            out["call_ms_p50_by_fifth"] = [
                float(np.median(part)) * 1e3
                for part in np.array_split(np.asarray(call_s), 5)]
        stat = _proc_stat()
        if stat and self._stat and len(stat) > 7:
            spent = [b - a for a, b in zip(self._stat, stat)]
            if sum(spent) > 0:
                out["host_busy_share"] = 1 - (spent[3] + spent[4]) / sum(spent)
                out["host_steal_share"] = spent[7] / sum(spent)
        out["proc_before"] = self.proc_before
        out["proc_after"] = proc_readings()
        out["cpu_probe_ms_after"] = cpu_probe_ms()
        out["copy_probe_gb_s"] = copy_probe_gb_s()
        return out
