"""FAST corner detection, with ORB and BRISK-style rescoring, on static
shapes.

Counterpart of ``video_stab_tpu/ops/fast.py`` (the reference's alternative
feature detectors, detectFeatures, src/Stabilizer.cpp:1194-1266).

FAST-9/16: the 16 Bresenham-circle neighbours are 16 shifted images (edge
padded); a pixel is a corner when 9 contiguous neighbours around the
circle are all brighter or all darker than it by ``threshold``. Its score
is the sum over the whole circle of max(|neighbour - centre| - threshold,
0), added in ``_CIRCLE`` order.

- ORB keypoints are FAST corners re-ranked by the min-eigenvalue response:
  K3's response on a CUDA tensor (``kernels/features.py:corner_response``),
  its plain version on a CPU tensor.
- BRISK's AGAST detector is approximated by FAST at two pyramid scales.

Selection is the wrapped 3x3 peak test, the first ``n_candidates`` by
score and GFTT's greedy min-distance selection (``ops/features.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from video_stab_tpu_torch.kernels.features import corner_response, dilate3x3
from video_stab_tpu_torch.ops.features import _nms_compact, top_candidates
from video_stab_tpu_torch.ops.resize import pyr_down

# Bresenham circle of radius 3 (OpenCV's FAST-16 offsets, clockwise from top).
_CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)


def _shift(padded: torch.Tensor, dx: int, dy: int, h: int, w: int
           ) -> torch.Tensor:
    """The image value at (x + dx, y + dy), from its 3-pixel edge pad."""
    return padded[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]


def _has_arc(mask: torch.Tensor, arc: int) -> torch.Tensor:
    """(16, H, W) bool -> (H, W): >= ``arc`` contiguous True around the
    16-cycle."""
    doubled = torch.cat([mask, mask], dim=0)
    acc = torch.zeros_like(mask[0])
    for s in range(16):
        run = doubled[s]
        for k in range(1, arc):
            run = run & doubled[s + k]
        acc = acc | run
    return acc


def fast_response(gray: torch.Tensor, threshold: float = 10.0,
                  arc: int = 9) -> torch.Tensor:
    """FAST-N/16 corner response map of an (H, W) float32 gray; 0 where
    not a corner."""
    h, w = gray.shape
    padded = F.pad(gray[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    neigh = torch.stack([_shift(padded, dx, dy, h, w) for dx, dy in _CIRCLE])
    brighter = neigh > (gray + threshold)[None]
    darker = neigh < (gray - threshold)[None]
    is_corner = _has_arc(brighter, arc) | _has_arc(darker, arc)
    terms = torch.clamp((neigh - gray[None]).abs() - threshold, min=0.0)
    sad = terms[0]
    for k in range(1, 16):
        sad = sad + terms[k]
    return torch.where(is_corner, sad, torch.zeros_like(sad))


def _nms_topk(resp: torch.Tensor, max_corners: int, min_distance: float,
              n_candidates: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """Wrapped 3x3 peak test + greedy min-distance top-K (GFTT's
    selection)."""
    h, w = resp.shape
    cand = torch.where((resp >= dilate3x3(resp)) & (resp > 0.0), resp,
                       torch.full_like(resp, -1.0))
    top_vals, top_idx = top_candidates(cand.reshape(-1),
                                       min(n_candidates, h * w))
    pts, mask, _ = _nms_compact(top_vals, top_idx, w, max_corners,
                                min_distance)
    return pts, mask


def fast_corners(gray: torch.Tensor, threshold: float = 10.0,
                 max_corners: int = 200, min_distance: float = 7.0,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """FAST keypoints: (max_corners, 2) xy + validity mask."""
    return _nms_topk(fast_response(gray, threshold), max_corners,
                     min_distance)


def orb_corners(gray: torch.Tensor, threshold: float = 10.0,
                max_corners: int = 200, min_distance: float = 7.0,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """ORB keypoints: FAST corners re-ranked by the min-eigenvalue
    response (block 3)."""
    fresp = fast_response(gray, threshold)
    harris, _ = corner_response(gray)
    resp = torch.where(fresp > 0.0, torch.clamp(harris, min=1e-9),
                       torch.zeros_like(fresp))
    return _nms_topk(resp, max_corners, min_distance)


def brisk_corners(gray: torch.Tensor, threshold: float = 10.0,
                  max_corners: int = 200, min_distance: float = 7.0,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """BRISK-style keypoints: FAST over two pyramid scales, the coarse
    response repeated back to full size (nearest) and the larger taken."""
    r0 = fast_response(gray, threshold)
    r1 = fast_response(pyr_down(gray), threshold)
    r1_up = r1.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    r1_up = r1_up[:r0.shape[0], :r0.shape[1]]
    ph = r0.shape[0] - r1_up.shape[0]
    pw = r0.shape[1] - r1_up.shape[1]
    if ph or pw:
        r1_up = F.pad(r1_up, (0, pw, 0, ph))
    return _nms_topk(torch.maximum(r0, r1_up), max_corners, min_distance)
