"""The device trace of a traced run, read from ``torch.profiler``'s chrome
trace: the traced window (the span of its ``ProfilerStep#`` steps), the
device's kernels, copies and fills in it, the host's kernel launches, and
the host operation open over each idle gap of the device.

The profiler drops kernel records at times (a sandboxed card's tracer
keeps them all, but not always), so a reading of one kernel's time is
taken over the records it kept, with their count beside it, and
``complete`` says whether the trace kept a kernel record for (nearly)
every kernel the host launched.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def short_name(name: str) -> str:
    """A kernel's demangled signature without its return type, namespaces
    and parameter list: ``warp_tile_kernel<3, 0, false, false>``."""
    name = re.sub(r"\(.*$", "", name.replace("(anonymous namespace)::", ""))
    name = re.sub(r"^void ", "", name)
    return name.rsplit("::", 1)[-1] if "<" not in name else name


@dataclass
class Trace:
    start_us: float
    end_us: float
    device: list = field(default_factory=list)    # (name, cat, start, end)
    host: list = field(default_factory=list)      # (name, start, end)
    launches: int = 0

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) * 1e-6

    @property
    def kernel_records(self) -> int:
        return sum(1 for d in self.device if d[1] == "kernel")

    @property
    def complete(self) -> bool:
        return self.launches > 0 and \
            self.kernel_records >= 0.98 * self.launches

    def busy_intervals(self) -> list:
        """The union of the device's intervals, clipped to the window."""
        spans = sorted((max(s, self.start_us), min(e, self.end_us))
                       for _, _, s, e in self.device)
        out = []
        for s, e in spans:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def kernel_time(self, symbol: str) -> tuple[int, float]:
        """(records, total device us) of the kernels whose name holds
        ``symbol``."""
        n, us = 0, 0.0
        for name, cat, s, e in self.device:
            if cat == "kernel" and symbol in name:
                n += 1
                us += e - s
        return n, us

    def device_ops(self, k: int = 10) -> list:
        """The k device operations that took most time: [name, seconds]."""
        tot: dict = {}
        for name, _, s, e in self.device:
            key = short_name(name)
            tot[key] = tot.get(key, 0.0) + (e - s) * 1e-6
        return [[n, t] for n, t in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The k longest gaps between device intervals inside the window,
        each named by the innermost host operation open at its middle:
        [name, seconds]."""
        busy = self.busy_intervals()
        edges = [self.start_us] + [x for iv in busy for x in iv] \
            + [self.end_us]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:k]:
            mid = 0.5 * (s + e)
            open_ops = [h for h in self.host if h[1] <= mid <= h[2]]
            name = max(open_ops, key=lambda h: h[1])[0] if open_ops \
                else "(no host op)"
            out.append([name, (e - s) * 1e-6])
        return out


def read_chrome_trace(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("ProfilerStep#")]
    if not steps:
        raise ValueError(f"{path}: no ProfilerStep in the trace")
    t0 = min(float(e["ts"]) for e in steps)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in steps)
    tr = Trace(start_us=t0, end_us=t1)
    for e in events:
        if e.get("ph") != "X":
            continue
        s = float(e["ts"])
        end = s + float(e.get("dur", 0.0))
        cat, name = e.get("cat"), e.get("name", "")
        if cat in DEVICE_CATS:
            if end > t0 and s < t1:
                tr.device.append((name, cat, s, end))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "LaunchKernel" in name and t0 <= s <= t1:
                tr.launches += 1
        elif cat in HOST_CATS and not name.startswith("ProfilerStep#"):
            tr.host.append((name, s, end))
    return tr
