"""Layer step: host ms per delivered frame inside ``vstab.hf``, the
drone high-frequency chain (``motion/hf.py:hf_apply``: dead zone,
micro-shake suppression, rotation low-pass, history push), read in the
cells that run the drone configuration; None where the trace holds no
such span."""

from benchmark_torch.spans import _span_ms_per_frame


def read(ctx):
    return _span_ms_per_frame(ctx, "vstab.hf")
