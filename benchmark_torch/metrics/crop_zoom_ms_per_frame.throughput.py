"""Layer step: host ms per delivered frame inside ``vstab.crop_zoom``,
crop-and-zoom (the crop of ``border_size`` px off each side of the emit
warp's output and the bilinear resample back to the frame's size), read
in the cells that run the drone configuration; None where the trace
holds no such span."""

from benchmark_torch.spans import _span_ms_per_frame


def read(ctx):
    return _span_ms_per_frame(ctx, "vstab.crop_zoom")
