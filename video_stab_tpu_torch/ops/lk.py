"""Sparse pyramidal Lucas-Kanade optical flow.

Counterpart of ``video_stab_tpu/ops/lk.py:lk_track``, written as a direct
per-window bilinear gather with replicate (clamped-index) borders. The JAX
package extracts each point's source slab with one-hot matmuls, a TPU
workaround; this port gathers the same slab (same origin, same clamped
indices, values rounded to bfloat16 as the JAX slab matmuls round them) and
interpolates windows inside it. The semantics that decide which points
fail are kept exactly:

- per pyramid level, rounds of ``iters_per = ceil(iters / rounds)`` Newton
  steps (4 rounds at the top level, 2 below), the current-frame slab
  re-fetched at each round's starting guess;
- the in-slab window origin clamped to ``[0, s_c - win - 1]`` with
  ``s_c = win + 1 + 2 * drift`` (``kernels/lk.py`` ``DRIFT`` below the
  top, ``DRIFT_TOP`` at it);
- points freeze once a step is within ``eps``; the ``lvl_ok`` min-eig test;
  the final ``err`` window; the ``inside`` test.

``lk_track`` builds the full planes here: both pyramids, the Scharr
derivatives of each prev level, and one bfloat16 rounding of each plane.
The per-point ladder over them is ``kernels/lk.py:lk_levels``: on CUDA
tensors one launch of K6 for every level, round and step, on CPU tensors
its plain version.

JAX leaves a round's loop early once every point has converged; the plain
version runs every round's full step budget with converged points frozen,
and K6 stops each point once it has converged. Both give the same output
without reading the device's convergence flag on the host.
``motion_prediction``'s initial guess (``init_pts``) is accepted; the prior
that produces it is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from video_stab_tpu_torch.kernels.lk import lk_levels
from video_stab_tpu_torch.ops.filters import scharr_derivs
from video_stab_tpu_torch.ops.resize import build_pyramid


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Values as the JAX package's bfloat16 slab selection sees them."""
    return x.to(torch.bfloat16).to(torch.float32)


def lk_planes(prev_gray: torch.Tensor, curr_gray: torch.Tensor,
              max_level: int
              ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """The planes K6 reads, per level 0 .. max_level: (3, Hl, Wl) stacks
    [prev, d/dx, d/dy] and (Hl, Wl) current planes, rounded to bfloat16."""
    prev_planes = []
    for prev_l in build_pyramid(prev_gray, max_level):
        ix, iy = scharr_derivs(prev_l)
        prev_planes.append(_bf16(torch.stack([prev_l, ix, iy])))
    curr_planes = [_bf16(c) for c in build_pyramid(curr_gray, max_level)]
    return prev_planes, curr_planes


def lk_track(prev_gray: torch.Tensor, curr_gray: torch.Tensor,
             prev_pts: torch.Tensor, pts_mask: torch.Tensor,
             win: int = 15, max_level: int = 2, iters: int = 20,
             eps: float = 0.03, min_eig_thresh: float = 1e-4,
             init_pts: Optional[torch.Tensor] = None,
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Track ``prev_pts`` from prev_gray to curr_gray.

    Args:
      prev_gray/curr_gray: (H, W) float32 u8-domain grayscale.
      prev_pts: (N, 2) float32 (x, y).
      pts_mask: (N,) bool validity of inputs.
      init_pts: optional (N, 2) initial position guesses.

    Returns:
      curr_pts: (N, 2) float32 tracked positions.
      status:   (N,) bool — tracked successfully and inside the image.
      err:      (N,) float32 — mean abs intensity diff over the final window.
    """
    prev_planes, curr_planes = lk_planes(prev_gray, curr_gray, max_level)
    return lk_levels(prev_planes, curr_planes, prev_pts, pts_mask, init_pts,
                     win, iters, eps, min_eig_thresh)
