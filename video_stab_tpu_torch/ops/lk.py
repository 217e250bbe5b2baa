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
  ``s_c = win + 1 + 2 * drift`` (``DRIFT`` below the top, ``DRIFT_TOP`` at
  it);
- points freeze once a step is within ``eps``; the ``lvl_ok`` min-eig test;
  the final ``err`` window; the ``inside`` test.

JAX leaves a round's loop early once every point has converged; here every
round runs its full step budget with converged points frozen, which gives
the same output without reading the device's convergence flag on the host.
``motion_prediction``'s initial guess (``init_pts``) is accepted; the prior
that produces it is not ported yet.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from video_stab_tpu_torch.ops.filters import scharr_derivs
from video_stab_tpu_torch.ops.resize import build_pyramid

DRIFT = 8
DRIFT_TOP = 24


def _slab(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, s: int
          ) -> torch.Tensor:
    """Per-point s x s slabs at integer top-left corners, indices clamped
    (replicate border). img: (C, H, W); y0/x0: (N,) int64 -> (N, C, s, s)."""
    ch, h, w = img.shape
    ss = torch.arange(s, device=img.device)
    ry = (y0[:, None] + ss[None, :]).clamp(0, h - 1)            # (N, s)
    rx = (x0[:, None] + ss[None, :]).clamp(0, w - 1)
    flat = (ry[:, :, None] * w + rx[:, None, :]).reshape(1, -1)  # (1, N*s*s)
    vals = img.reshape(ch, h * w).gather(1, flat.expand(ch, -1))
    return vals.reshape(ch, -1, s, s).transpose(0, 1)


@functools.lru_cache(maxsize=32)
def _tap_offsets(win: int, s: int, device: torch.device) -> torch.Tensor:
    """(win, s) float32 i - a for window row i and slab row a."""
    i = torch.arange(win, dtype=torch.float32, device=device)[:, None]
    a = torch.arange(s, dtype=torch.float32, device=device)[None, :]
    return i - a


def _hat(c: torch.Tensor, win: int, s: int) -> torch.Tensor:
    """(..., win, s) separable bilinear weights max(0, 1 - |c + i - a|):
    exactly two taps per row, exact bilinear (the JAX package's
    ``_hat_weights``). c: (...,) in-slab offsets."""
    return torch.relu(1.0 - torch.abs(c[..., None, None]
                                      + _tap_offsets(win, s, c.device)))


def _interp_window(slab: torch.Tensor, cyx: torch.Tensor, win: int
                   ) -> torch.Tensor:
    """Sub-pixel win x win windows from (N, C, s, s) slabs at fractional
    in-slab offsets cyx = (N, 2) [y, x]: rows first, then columns, as two
    batched matmuls with the hat weights. -> (N, C, win, win)."""
    w = _hat(cyx, win, slab.shape[-1])                      # (N, 2, win, s)
    return (w[:, 0:1] @ slab) @ w[:, 1:2].transpose(-1, -2)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Values as the JAX package's bfloat16 slab selection sees them."""
    return x.to(torch.bfloat16).to(torch.float32)


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
    h, w = curr_gray.shape
    prev_pyr = build_pyramid(prev_gray, max_level)
    curr_pyr = build_pyramid(curr_gray, max_level)
    half = (win - 1) * 0.5
    s_t = win + 1

    start = prev_pts if init_pts is None else init_pts
    guess = start * (1.0 / (2 ** max_level))
    ok = pts_mask
    err = torch.zeros(prev_pts.shape[0], dtype=torch.float32,
                      device=prev_pts.device)

    for level in range(max_level, -1, -1):
        drift = DRIFT_TOP if level == max_level else DRIFT
        s_c = win + 1 + 2 * drift
        prev_l = prev_pyr[level]
        curr_l = _bf16(curr_pyr[level])[None]                # (1, Hl, Wl)
        ix, iy = scharr_derivs(prev_l)
        stk = _bf16(torch.stack([prev_l, ix, iy]))           # (3, Hl, Wl)

        # Template: fixed sub-pixel window around pt_prev at this level.
        pt_prev = prev_pts / (2 ** level)
        ty0f = torch.floor(pt_prev[:, 1] - half)
        tx0f = torch.floor(pt_prev[:, 0] - half)
        t_slab = _slab(stk, ty0f.to(torch.int64), tx0f.to(torch.int64), s_t)
        tmpl = _interp_window(
            t_slab, torch.stack([pt_prev[:, 1] - half - ty0f,
                                 pt_prev[:, 0] - half - tx0f], dim=1), win)
        i_win, ix_win, iy_win = tmpl[:, 0], tmpl[:, 1], tmpl[:, 2]
        # (N, 2, win*win) gradients for b = G . (J - I) as one matmul.
        g_flat = tmpl[:, 1:].reshape(tmpl.shape[0], 2, win * win)

        # Spatial gradient matrix + trackability (cv2's minEigThreshold).
        g11 = (ix_win * ix_win).sum(dim=(1, 2))
        g12 = (ix_win * iy_win).sum(dim=(1, 2))
        g22 = (iy_win * iy_win).sum(dim=(1, 2))
        det = g11 * g22 - g12 * g12
        half_tr = 0.5 * (g11 + g22)
        min_eig = half_tr - torch.sqrt(
            torch.clamp(half_tr * half_tr - det, min=0.0))
        lvl_ok = (det > 1e-7) & (min_eig / (win * win) > min_eig_thresh)
        safe_det = torch.where(lvl_ok, det, torch.ones_like(det))
        zero = torch.zeros_like(det)
        inv11 = torch.where(lvl_ok, g22 / safe_det, zero)
        inv12 = torch.where(lvl_ok, -g12 / safe_det, zero)
        inv22 = torch.where(lvl_ok, g11 / safe_det, zero)
        # -G^-1 with rows ordered (dy, dx): the Newton loop keeps points
        # as [y, x], the order of the in-slab window offsets.
        neg_inv = -torch.stack([torch.stack([inv12, inv22], dim=1),
                                torch.stack([inv11, inv12], dim=1)], dim=1)

        rounds = 4 if level == max_level else 2
        iters_per = -(-iters // rounds)
        pt, done = guess.flip(1), (~lvl_ok)[:, None]            # [y, x]
        for _ in range(rounds):
            # Current-frame slab covering the drift budget around the
            # round's starting guess.
            c0 = torch.floor(pt - half) - drift                  # (N, 2)
            c_slab = _slab(curr_l, c0[:, 0].to(torch.int64),
                           c0[:, 1].to(torch.int64), s_c)
            origin = c0 + half
            for _ in range(iters_per):
                cyx = torch.clamp(pt - origin, 0.0, s_c - win - 1.0)
                j_win = _interp_window(c_slab, cyx, win)[:, 0]
                b = g_flat @ (j_win - i_win).reshape(-1, win * win, 1)
                d = (neg_inv @ b)[:, :, 0]                     # (N, 2) dy, dx
                pt = torch.where(done, pt, pt + d)
                done = done | ((d * d).sum(dim=1, keepdim=True) <= eps * eps)
        pt = pt.flip(1)                                          # [x, y]
        ok = ok & lvl_ok
        guess = torch.where(ok[:, None], pt, guess)
        if level > 0:
            guess = guess * 2.0
        else:
            # Final-window error: fresh slab at the converged position.
            ey0 = torch.floor(guess[:, 1] - half) - 1
            ex0 = torch.floor(guess[:, 0] - half) - 1
            e_slab = _slab(curr_l, ey0.to(torch.int64), ex0.to(torch.int64),
                           win + 3)
            j_win = _interp_window(
                e_slab, torch.stack([guess[:, 1] - half - ey0,
                                     guess[:, 0] - half - ex0], dim=1),
                win)[:, 0]
            err = torch.abs(j_win - i_win).mean(dim=(1, 2))

    inside = ((guess[:, 0] >= 0) & (guess[:, 0] <= w - 1) &
              (guess[:, 1] >= 0) & (guess[:, 1] <= h - 1))
    return guess, ok & inside, err
