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

``lk_track`` builds the full planes with ``lk_planes``: both pyramids,
the Scharr derivatives of each prev level, and one bfloat16 rounding of
each plane; on CUDA tensors one launch of K9 a level
(``kernels/lk_planes.py``), on CPU tensors its plain version,
``lk_planes_plain``. The per-point ladder over them is
``kernels/lk.py:lk_levels``: on CUDA tensors one launch of K6 for every
level, round and step, on CPU tensors its plain version.

JAX leaves a round's loop early once every point has converged; the plain
version runs every round's full step budget with converged points frozen,
and K6 stops each point once it has converged. Both give the same output
without reading the device's convergence flag on the host.
``motion_prediction``'s initial guess (``init_pts``) comes from
``global_translation_prior`` below.

``lk_planes`` and ``lk_track`` also take N streams at once, a leading
axis on the grays (N, H, W) and on the points (N, P, ...): each K9 launch
then covers all N (in the plain version each filter of the pyramids and
derivatives is one launch for all N), and the ladder is one K6 launch for
all N * P points.
"""

from __future__ import annotations

from typing import Optional

import torch

from video_stab_tpu_torch.kernels.lk import lk_levels
from video_stab_tpu_torch.kernels.lk_planes import lk_planes_cuda
from video_stab_tpu_torch.ops.filters import scharr_derivs
from video_stab_tpu_torch.ops.resize import build_pyramid


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Values as the JAX package's bfloat16 slab selection sees them."""
    return x.to(torch.bfloat16).to(torch.float32)


def lk_planes(prev_gray: torch.Tensor, curr_gray: torch.Tensor,
              max_level: int
              ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """The planes K6 reads, per level 0 .. max_level: (3, Hl, Wl) stacks
    [prev, d/dx, d/dy] and (Hl, Wl) current planes, rounded to bfloat16;
    for (N, H, W) grays (N, 3, Hl, Wl) and (N, Hl, Wl). CUDA grays launch
    K9 (``max_level + 1`` launches) or raise; CPU grays take
    ``lk_planes_plain``."""
    if prev_gray.is_cuda:
        return lk_planes_cuda(prev_gray.contiguous(), curr_gray.contiguous(),
                              max_level)
    if prev_gray.device.type != "cpu":
        raise ValueError(f"lk_planes: unsupported device {prev_gray.device}")
    return lk_planes_plain(prev_gray, curr_gray, max_level)


def lk_planes_plain(prev_gray: torch.Tensor, curr_gray: torch.Tensor,
                    max_level: int
                    ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Plain PyTorch version of K9 (any device): the pyramids by
    ``pyr_down``, the Scharr pair of every prev level, one bfloat16
    rounding of each plane."""
    prev_planes = []
    for prev_l in build_pyramid(prev_gray, max_level):
        ix, iy = scharr_derivs(prev_l)
        prev_planes.append(_bf16(torch.stack([prev_l, ix, iy], dim=-3)))
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
      prev_gray/curr_gray: (H, W) float32 u8-domain grayscale, or (S, H, W)
        for S streams (every argument and result then has a leading S).
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


def global_translation_prior(prev_small: torch.Tensor,
                             curr_small: torch.Tensor,
                             search: int = 24) -> torch.Tensor:
    """Coarse global translation (dx, dy) between two small gray frames by
    zero-mean centre-patch correlation (``video_stab_tpu/ops/lk.py``'s
    prior, which seeds LK under ``motion_prediction``).

    The JAX package correlates with a channelized convolution; here every
    search offset's window is one row of an unfolded (n * n, patch^2)
    matrix, multiplied by the patch in full float32 (a float32 convolution
    would go to cuDNN's TF32 on the card, and TF32 can move the argmax).
    The first maximum wins, as in ``jnp.argmax``. Confidence-gated: when
    the peak's z-score over the correlation surface (population std) is
    not above 4, the prior is 0. All on the device: nothing is read
    back. N streams' (N, h, w) grays give (N, 2), one batched matmul and
    each reduction once for the batch."""
    *lead, h, w = prev_small.shape
    dev = prev_small.device
    patch = min(64, ((min(h, w) // 2) // 8) * 8)
    search = min(search, (h - patch) // 2 - 1, (w - patch) // 2 - 1)
    if search < 4 or patch < 16:
        return torch.zeros((*lead, 2), dtype=torch.float32, device=dev)
    cy, cx = (h - patch) // 2, (w - patch) // 2
    p = prev_small[..., cy:cy + patch, cx:cx + patch]
    p = p - p.mean(dim=(-2, -1), keepdim=True)
    region = curr_small[..., cy - search:cy + patch + search,
                        cx - search:cx + patch + search]
    region = region - region.mean(dim=(-2, -1), keepdim=True)
    n = 2 * search + 1
    d = region.dim()
    windows = region.unfold(d - 2, patch, 1).unfold(d - 1, patch, 1).reshape(
        *lead, n * n, patch * patch)                      # (..., n * n, p^2)
    corr = torch.matmul(windows, p.reshape(*lead, patch * patch, 1))[..., 0]
    idx = torch.argmax(corr, dim=-1)
    z = (corr.amax(dim=-1) - corr.mean(dim=-1)) / torch.clamp(
        corr.std(dim=-1, correction=0), min=1e-6)
    shift = torch.stack([idx % n, idx // n], dim=-1).to(torch.float32) \
        - search
    return torch.where((z > 4.0)[..., None], shift, torch.zeros_like(shift))
