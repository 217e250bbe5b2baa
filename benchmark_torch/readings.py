"""The per-layer quantities a traced run reads; ``metrics/<name>.py``
names one of them for the end-to-end metric it moves. A reader that finds
nothing to read returns None, and the run leaves the metric out."""

from __future__ import annotations

from pathlib import Path

from benchmark_torch import peaks

WORK = Path(__file__).resolve().parent / "work"


def host_syncs_per_frame(ctx):
    """The program's synchronizing calls per delivered frame over the
    calls run under torch's sync debug mode."""
    t = ctx.tracer
    if not t.sync_calls:
        return None
    return t.syncs / (t.sync_calls * ctx.frames_per_call)


def launches_per_frame(ctx):
    """The host's kernel launches per delivered frame in the trace."""
    if ctx.trace is None or ctx.trace.launches == 0:
        return None
    return ctx.trace.launches / (ctx.tracer.active * ctx.frames_per_call)


def kernel_roofline_share(ctx):
    """Sum over the hand-written kernels of the least time their recorded
    launches need at the cell's shapes (``work/``, ``peaks.least_us``),
    over the sum of their recorded device time, in %. Work files that name
    one symbol (a kernel with two modes) each list their own launches; the
    symbol's recorded launches and time are taken once, against the mean
    least time of all the launches they list."""
    from benchmark_torch.harness import load_module
    if ctx.trace is None:
        return None
    shapes = {}
    for path in sorted(WORK.glob("*.py")):
        mod = load_module(path)
        shapes.setdefault(mod.SYMBOL, []).extend(mod.launches(ctx.cfg))
    least, spent = 0.0, 0.0
    for symbol, listed in shapes.items():
        if not listed:
            continue
        n, us = ctx.trace.kernel_time(symbol)
        per_launch = sum(peaks.least_us(b, o) for b, o in listed) \
            / len(listed)
        least += n * per_launch
        spent += us
    if spent <= 0.0:
        return None
    return 100.0 * least / spent


def device_idle_share(ctx):
    """100 x (1 - the union of the device's kernels, copies and fills over
    the traced window / the window), in %."""
    if ctx.trace is None:
        return None
    busy = ctx.trace.busy_s()
    if busy <= 0.0:
        return None
    return 100.0 * (1.0 - busy / ctx.trace.window_s)
