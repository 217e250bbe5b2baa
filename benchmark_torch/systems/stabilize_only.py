"""The stabilizer alone: one camera through ``ProcessingChain.process``
with only the stabilizer enabled (no enhancer, no roll correction), the
route the application takes for ``configs/drone_hf.yaml`` and
``configs/rtsp_serving.yaml``; a host uint8 frame in, the stabilized host
frame out."""

from __future__ import annotations

import numpy as np
import torch


class System:
    """Calls ``ProcessingChain.process`` on frame ``i % P`` of the pool.
    ``lead``: the calls that deliver nothing while the look-ahead fills."""

    def __init__(self, cfg: dict, pool: np.ndarray, seed: int,
                 device: torch.device):
        from video_stab_tpu_torch.core.chain import ProcessingChain
        from video_stab_tpu_torch.core.params import (EnhancerParams,
                                                      ModeParams,
                                                      RollCorrectionParams,
                                                      StabilizerParams)
        mode = ModeParams(stabilizer_enabled=True,
                          use_cuda=device.type == "cuda")
        stab = StabilizerParams(**cfg["stabilizer"], seed=seed)
        self.chain = ProcessingChain(mode, EnhancerParams(),
                                     RollCorrectionParams(), stab)
        self.lead = stab.effective_radius - 1
        self.pool = [np.ascontiguousarray(f[0]) for f in pool]

    def call(self, i: int):
        """Process the i-th frame of the stream; the delivered (1, H, W, 3)
        frame, or None while the look-ahead fills."""
        out = self.chain.process(self.pool[i % len(self.pool)])
        return None if out is None else out[None]

    def close(self) -> None:
        self.chain = None
