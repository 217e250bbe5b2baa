"""Layer step: host ms per delivered frame inside ``vstab.prior``, the
``motion_prediction`` prior (both grays resized to analysis / 2**lk_levels,
the centre patch correlated over the search window, the confidence gate)
inside ``vstab.lk``, read in the cells that run the drone configuration;
None where the trace holds no such span (a program without it)."""

from benchmark_torch.spans import _span_ms_per_frame


def read(ctx):
    return _span_ms_per_frame(ctx, "vstab.prior")
