"""Layer step: host ms per delivered frame inside ``vstab.clahe``,
conditional CLAHE on the analysis gray (computed every frame under drone
mode, selected by the device's starvation counter), read in the cells
that run the drone configuration; None where the trace holds no such
span."""

from benchmark_torch.spans import _span_ms_per_frame


def read(ctx):
    return _span_ms_per_frame(ctx, "vstab.clahe")
