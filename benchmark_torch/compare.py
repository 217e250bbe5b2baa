"""The comparison that decides ``correct``: each frame the program
delivered at a sampled call against the plain reference's frame for the
same call, every value of it.

Two numbers, each the worst over the compared frames (every stream's
frame of a sampled call counts as a frame): ``frame_mad_max``, the mean
absolute difference of a frame in levels of its uint8 values, and
``frame_off2_max``, the share of a frame's values (%) that differ by more
than 2 levels. A frame moved by a fraction of a pixel changes few values
by more than a level; a wrong transform, a stale frame, a missing stream
or a lower precision moves many.
"""

from __future__ import annotations

import numpy as np
import torch


def numbers(program: dict, reference: dict) -> dict:
    """program: {call: (S, H, W, 3) uint8 numpy}, reference: {call: (S, H,
    W, 3) uint8 tensor} -> {"frame_mad_max": levels, "frame_off2_max": %}."""
    mad, off2 = 0.0, 0.0
    for call, got in program.items():
        want = reference[call]
        got_t = torch.from_numpy(np.ascontiguousarray(got)).to(want.device)
        if got_t.shape != want.shape:
            return {"frame_mad_max": float("inf"),
                    "frame_off2_max": 100.0}
        d = (got_t.to(torch.int16) - want.to(torch.int16)).abs()
        d = d.reshape(d.shape[0], -1)
        mad = max(mad, float(d.float().mean(dim=1).max()))
        off2 = max(off2, float((d > 2).float().mean(dim=1).max()) * 100.0)
    return {"frame_mad_max": mad, "frame_off2_max": off2}
