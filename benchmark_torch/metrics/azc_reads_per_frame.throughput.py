"""Layer wrappers: ``interior_rect``'s host reads per delivered frame,
one ``vstab.azc_read`` span each (one a chunk of its shrink loop), read in
the cells that run auto zoom-crop; None where the trace holds no
``vstab.azc`` span."""

from benchmark_torch.spans import _frames, _spans


def read(ctx):
    if ctx.trace is None:
        return None
    names = [n for n, _, _ in _spans(ctx.trace)]
    if "vstab.azc" not in names:
        return None
    return names.count("vstab.azc_read") / _frames(ctx)
