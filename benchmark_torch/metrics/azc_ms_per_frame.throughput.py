"""Layer step: host ms per delivered frame inside ``vstab.azc`` (auto
zoom-crop in the two-pass pre-stages, its host reads included), read in
the cells that run auto zoom-crop; None where the trace holds no such
span."""

from benchmark_torch.spans import _span_ms_per_frame


def read(ctx):
    return _span_ms_per_frame(ctx, "vstab.azc")
