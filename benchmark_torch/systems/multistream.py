"""Lockstep cameras: every call one ``MultiStreamStabilizer.stabilize_batch``
tick, the (N, H, W, 3) host uint8 frames in, the N stabilized host frames
out."""

from __future__ import annotations

import numpy as np
import torch


class System:
    """Calls ``stabilize_batch`` on tick ``i % P`` of the pool.
    ``lead``: the ticks that deliver nothing while the look-ahead fills."""

    def __init__(self, cfg: dict, pool: np.ndarray, seed: int,
                 device: torch.device):
        from video_stab_tpu_torch.core.params import (ModeParams,
                                                      StabilizerParams)
        from video_stab_tpu_torch.parallel import MultiStreamStabilizer
        stab = StabilizerParams(**cfg["stabilizer"], seed=seed)
        self.ms = MultiStreamStabilizer(
            stab, cfg["streams"],
            mode=ModeParams(use_cuda=device.type == "cuda"))
        self.lead = stab.effective_radius - 1
        self.pool = [np.ascontiguousarray(f) for f in pool]

    def call(self, i: int):
        """One tick of every stream; the delivered (N, H, W, 3) frames, or
        None while the look-ahead fills."""
        return self.ms.stabilize_batch(self.pool[i % len(self.pool)])

    def close(self) -> None:
        self.ms = None
