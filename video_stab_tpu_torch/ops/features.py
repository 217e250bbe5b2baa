"""Shi-Tomasi corner detection with fixed-capacity outputs.

Counterpart of ``video_stab_tpu/ops/features.py``. The detector returns
exactly ``max_corners`` point slots plus a validity mask. The response and
its 3x3 peak mask come from K3 (``kernels/features.py``). Candidates are
the exact top ``n_candidates`` by response, as the JAX package's
``topk="flat"`` path takes them; its ``"staged"`` top-k and the row-budget
cascade are TPU workarounds and are not ported.

N streams detect at once on (N, H, W) grays (the multi-stream step,
``parallel/``): one K3 launch, one sort, and one greedy selection over
(N, C, C) conflict matrices whose convergence flag is read on the host
once per ``NMS_ROUNDS_PER_SYNC`` rounds for the whole batch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from video_stab_tpu_torch.kernels.features import (  # noqa: F401 (re-export)
    corner_response,
    dilate3x3 as _dilate3x3,
    min_eig_response,
)
from video_stab_tpu_torch.utils import telemetry

# Rounds of the greedy selection run between two checks for convergence.
# Each check is one device->host read; real content converges in < 10
# rounds, so a frame's detection costs one or two reads. The counters
# ``nms_reads`` and ``nms_rounds`` (``utils.telemetry.counters()``) count
# the reads and the rounds run.
NMS_ROUNDS_PER_SYNC = 8


def top_candidates(values: torch.Tensor, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last dim, ties to the lower index — what
    ``lax.top_k`` returns (``torch.topk`` orders ties arbitrarily on CUDA)."""
    vals, idx = torch.sort(values, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def good_features_to_track(
    gray: torch.Tensor,
    max_corners: int = 200,
    quality_level: float = 0.01,
    min_distance: float = 30.0,
    block_size: int = 3,
    roi: Optional[torch.Tensor] = None,
    n_candidates: int = 2048,
    topk: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """goodFeaturesToTrack with static shapes.

    Args:
      gray: (H, W) float32 u8-domain grayscale, or (N, H, W) for N streams
            (the results then have a leading N).
      roi: optional (4,) [x, y, w, h] integer tensor; response outside is
           zeroed.
      topk: accepted and ignored (a TPU layout knob).

    Returns:
      pts:  (max_corners, 2) float32 (x, y), quality-descending order.
      mask: (max_corners,) bool validity.
    """
    del topk
    h, w = gray.shape[-2:]
    if block_size == 3:
        resp, is_peak = corner_response(gray)
    else:
        resp = min_eig_response(gray, block_size)
        is_peak = resp >= _dilate3x3(resp)
    if roi is not None:
        ys = torch.arange(h, device=gray.device)[:, None]
        xs = torch.arange(w, device=gray.device)[None, :]
        inside = ((xs >= roi[0]) & (xs < roi[0] + roi[2]) &
                  (ys >= roi[1]) & (ys < roi[1] + roi[3]))
        resp = torch.where(inside, resp, torch.zeros_like(resp))
        is_peak = resp >= _dilate3x3(resp)
    thresh = quality_level * resp.amax(dim=(-2, -1), keepdim=True)
    cand = torch.where(is_peak & (resp > thresh), resp,
                       torch.full_like(resp, -1.0))
    top_vals, top_idx = top_candidates(cand.flatten(-2),
                                       min(n_candidates, h * w))
    pts, mask, _ = _nms_compact(top_vals, top_idx, w, max_corners,
                                min_distance)
    return pts, mask


def _nms_compact(top_vals: torch.Tensor, top_idx: torch.Tensor, w: int,
                 max_corners: int, min_distance: float
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy min-distance selection over quality-ordered candidates +
    order-preserving compaction. Returns (pts, mask, n_selected_total).
    Candidates (C,) for one frame or (N, C) for N streams, whose rounds run
    together.

    Greedy selection == the lexicographically-first maximal independent set
    of the conflict graph under quality order, resolved in parallel rounds:
    SELECT i when every higher-ranked conflicting j is already suppressed;
    SUPPRESS i when a selected j conflicts with it. Rounds past convergence
    change nothing, so ``NMS_ROUNDS_PER_SYNC`` rounds run between two reads
    of the convergence flag."""
    n_cand = top_vals.shape[-1]
    lead = tuple(top_vals.shape[:-1])
    dev = top_vals.device
    cand_x = (top_idx % w).to(torch.float32)
    cand_y = torch.div(top_idx, w, rounding_mode="floor").to(torch.float32)
    k = max_corners
    min_d2 = float(np.float32(min_distance * min_distance))

    valid = top_vals > 0.0
    d2 = ((cand_x[..., :, None] - cand_x[..., None, :]) ** 2
          + (cand_y[..., :, None] - cand_y[..., None, :]) ** 2)
    rank = torch.arange(n_cand, device=dev)
    conflict = (d2 < min_d2) & (rank[None, :] < rank[:, None]) \
        & valid[..., None, :]

    unknown = valid
    selected = torch.zeros_like(valid)
    while True:
        for _ in range(NMS_ROUNDS_PER_SYNC):
            active = unknown | selected
            higher_active = (conflict & active[..., None, :]).any(dim=-1)
            newly = unknown & ~higher_active
            selected = selected | newly
            suppressed = (conflict & selected[..., None, :]).any(dim=-1)
            unknown = unknown & ~newly & ~suppressed
        telemetry.count("nms_rounds", NMS_ROUNDS_PER_SYNC)
        telemetry.count("nms_reads")
        with telemetry.trace("vstab.nms_read"):
            converged = not bool(unknown.any())
        if converged:
            break

    pos = torch.cumsum(selected.to(torch.int32), -1) - 1
    take = selected & (pos < k)
    idx = torch.where(take, pos, torch.full_like(pos, k)).to(torch.int64)
    # Each kept candidate to its slot; the others all to the spare slot k.
    pts = torch.zeros(lead + (k + 1, 2), dtype=torch.float32, device=dev)
    pts.scatter_(-2, idx[..., None].expand(*idx.shape, 2),
                 torch.stack([cand_x, cand_y], dim=-1))
    mask = torch.zeros(lead + (k + 1,), dtype=torch.bool, device=dev)
    mask.scatter_(-1, idx, take)
    # Contiguous for K6 (a no-op for one frame).
    return pts[..., :k, :].contiguous(), mask[..., :k].contiguous(), \
        selected.sum(dim=-1)
