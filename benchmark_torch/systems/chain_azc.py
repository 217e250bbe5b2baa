"""The live restream chain: one camera through ``ProcessingChain.process``
with auto zoom-crop after the two-pass roll, planar I420 delivered and the
download pipelined, a host uint8 frame in, the previous call's I420 frame
out."""

from __future__ import annotations

import numpy as np
import torch


class System:
    """Calls ``ProcessingChain.process`` on frame ``i % P`` of the pool.
    ``lead``: the calls that deliver nothing while the look-ahead fills,
    one more than the unpipelined chain's."""

    def __init__(self, cfg: dict, pool: np.ndarray, seed: int,
                 device: torch.device):
        from video_stab_tpu_torch.core.chain import ProcessingChain
        from video_stab_tpu_torch.core.params import (AutoZoomCropParams,
                                                      EnhancerParams,
                                                      ModeParams,
                                                      RollCorrectionParams,
                                                      StabilizerParams)
        mode = ModeParams(enhancer_enabled=True, roll_correction_enabled=True,
                          stabilizer_enabled=True,
                          use_cuda=device.type == "cuda")
        stab = StabilizerParams(**cfg["stabilizer"], seed=seed)
        self.chain = ProcessingChain(
            mode, EnhancerParams(**cfg["enhancer"]),
            RollCorrectionParams(**cfg["roll"]), stab,
            azc=AutoZoomCropParams(**cfg["azc"]),
            pipelined=cfg["pipelined"], output_format=cfg["output_format"])
        self.lead = stab.effective_radius - 1 + int(cfg["pipelined"])
        self.pool = [np.ascontiguousarray(f[0]) for f in pool]

    def call(self, i: int):
        """Process the i-th frame of the stream; the delivered frame with a
        leading stream axis ((1, 3H/2, W) in I420), or None while the
        look-ahead and the pipeline fill."""
        out = self.chain.process(self.pool[i % len(self.pool)])
        return None if out is None else out[None]

    def close(self) -> None:
        if self.chain is not None:
            self.chain.drain()
        self.chain = None
