"""The program's spans in a traced run: the ``vstab.*`` ranges that
``video_stab_tpu_torch.utils.telemetry.trace`` opens on the per-frame path
while a profiler records. They land in the chrome trace as host
annotations (``Trace.host``), on the clock of the device's records, so a
span's time and the device's idle time inside it are read from one trace.

Each reader takes the same ``harness.Reading`` as ``readings.py``'s and
reads the chosen trace's active calls, per delivered frame. A trace with
no span of the program (a program without them) reads None, and the run
leaves the metric out.
"""

from __future__ import annotations

PREFIX = "vstab."
OUTSIDE = "(outside the program)"


def _union(intervals) -> list:
    """The union of (start, end) intervals as sorted, disjoint [s, e]."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _spans(trace) -> list:
    """(name, start, end) of the program's spans, clipped to the traced
    window."""
    out = []
    for name, s, e in trace.host:
        if name.startswith(PREFIX):
            s, e = max(s, trace.start_us), min(e, trace.end_us)
            if e > s:
                out.append((name, s, e))
    return out


def span_intervals(trace, name: str) -> list:
    """The union of the spans named ``name`` inside the window."""
    return _union((s, e) for n, s, e in _spans(trace) if n == name)


def idle_intervals(trace) -> list:
    """The window less the union of the device's intervals."""
    out, t = [], trace.start_us
    for s, e in trace.busy_intervals():
        if s > t:
            out.append([t, s])
        t = max(t, e)
    if trace.end_us > t:
        out.append([t, trace.end_us])
    return out


def _overlap_us(a: list, b: list) -> float:
    """The length of the intersection of two sorted, disjoint lists."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def idle_by_span(trace) -> list:
    """The window's idle time, each stretch put down to the innermost
    program span open over it (the latest to open; OUTSIDE where none
    is): [[span, seconds]], most first. The seconds add up to the window
    less the device's busy time."""
    spans = sorted(_spans(trace), key=lambda x: (x[1], -x[2]))
    idle = idle_intervals(trace)
    points = sorted({p for iv in idle for p in iv}
                    | {p for _, s, e in spans for p in (s, e)})
    tot: dict = {}
    active, k, g = [], 0, 0
    for a, b in zip(points, points[1:]):
        while g < len(idle) and idle[g][1] <= a:
            g += 1
        if g == len(idle):
            break
        while k < len(spans) and spans[k][1] <= a:
            active.append(spans[k])
            k += 1
        active = [x for x in active if x[2] > a]
        if idle[g][0] > a:
            continue                      # a busy stretch
        name = max(active, key=lambda x: (x[1], -x[2]))[0] if active \
            else OUTSIDE
        tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
    return [[n, t] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])]


def _frames(ctx) -> int:
    return ctx.tracer.active * ctx.frames_per_call


def _span_ms_per_frame(ctx, name: str):
    if ctx.trace is None:
        return None
    spans = span_intervals(ctx.trace, name)
    if not spans:
        return None
    return sum(e - s for s, e in spans) * 1e-3 / _frames(ctx)


def upload_ms_per_frame(ctx):
    """Host ms per delivered frame inside ``vstab.upload``: the frame's
    copy to the card."""
    return _span_ms_per_frame(ctx, "vstab.upload")


def download_ms_per_frame(ctx):
    """Host ms per delivered frame inside ``vstab.download``: the wait for
    the frame's work and its copy to the host."""
    return _span_ms_per_frame(ctx, "vstab.download")


def step_host_ms_per_frame(ctx):
    """Host ms per delivered frame inside ``vstab.step``: the dispatch of
    the frame's work, its NMS reads included."""
    return _span_ms_per_frame(ctx, "vstab.step")


def step_idle_share(ctx):
    """100 x the device's idle time inside ``vstab.step`` spans over the
    traced window, in %; None without device records or spans."""
    t = ctx.trace
    if t is None or not t.device:
        return None
    steps = span_intervals(t, "vstab.step")
    if not steps:
        return None
    return 100.0 * _overlap_us(steps, idle_intervals(t)) \
        / (t.end_us - t.start_us)


def nms_rounds_per_frame(ctx):
    """The GFTT NMS's rounds per delivered frame: each ``vstab.nms_read``
    span is one read of the convergence flag, after
    ``NMS_ROUNDS_PER_SYNC`` rounds (the program's ``nms_rounds``
    counter's step). None where the trace holds no ``vstab.step``."""
    if ctx.trace is None or not span_intervals(ctx.trace, "vstab.step"):
        return None
    from video_stab_tpu_torch.ops.features import NMS_ROUNDS_PER_SYNC
    reads = sum(1 for n, _, _ in _spans(ctx.trace) if n == "vstab.nms_read")
    return reads * NMS_ROUNDS_PER_SYNC / _frames(ctx)
