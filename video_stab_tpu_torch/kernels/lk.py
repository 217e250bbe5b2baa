"""K6: the pyramidal Lucas-Kanade Newton ladder in one launch (csrc/lk.cu).

Counterpart of the JAX package's in-kernel LK probes, which never shipped
on the TPU (DESIGN.md 5d-quater (a), 5d-octies): ``tools/lk_kernel_proto.py``
``kernel`` (K6a) and ``tools/lk_inkernel_probe.py`` ``kernel`` /
``kernel_noroll`` (K6b), ``kernel_loads`` (K6c) and ``kernel_newton`` (K6d).
K6d is one level's Newton loop, ``newton_steps_plain`` below; K6a-K6c gate
the per-point window and slab gathers, which are the kernel's gather phase.
The function is the per-point part of ``video_stab_tpu/ops/lk.py:lk_track``
after the pyramids and derivatives: for every point and level, the
template window, G and ``lvl_ok``, the rounds with the current-frame slab
re-fetched at each round's guess, the Newton steps with the eps freeze,
the level hand-off, and at level 0 the final ``err`` window and the
``inside`` test.

``lk_levels`` takes the planes ``ops/lk.py:lk_track`` builds: per level
``l = 0 .. max_level`` a (3, Hl, Wl) float32 stack [prev, d/dx, d/dy] and a
(Hl, Wl) float32 current plane, every value already rounded to bfloat16
(as the JAX package's slab matmuls round them). A CUDA tensor launches K6
(one block per point) or raises; a CPU tensor takes ``lk_levels_plain``.
``LAUNCHES`` counts K6 launches.

The plain version runs every round's full step budget with converged points
frozen; the kernel stops a point once it has converged. Frozen points never
move, so both give the JAX early exit's output. Both can report how many
Newton steps each point ran before it froze (``steps=``, a measurement
hook: the ladder's callers do not pass it).

N streams (the multi-stream step, ``parallel/``) pass (N, 3, Hl, Wl) and
(N, Hl, Wl) planes per level and (N, P, ...) points: K6 tracks all N * P
points in one launch (a grid of points by streams); the plain version
runs the single-stream ladder per stream and stacks the results.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from video_stab_tpu_torch.kernels import _lib

LAUNCHES = 0    # K6 launches since import (or the last reset)

DRIFT = 8       # per-level Newton drift budget (px) below the top level
DRIFT_TOP = 24  # and at the top level
MAX_LEVEL = 5   # the deepest pyramid level K6 takes (csrc/lk.cu kMaxLevels)
MAX_WIN = 22    # the largest window K6 takes (csrc/lk.cu kMaxWin)


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
    """Sub-pixel win x win windows from (N, C, s_r, s_c) slabs at fractional
    in-slab offsets cyx = (N, 2) [y, x]: rows first, then columns, as two
    batched matmuls with the hat weights. -> (N, C, win, win)."""
    s_r, s_c = slab.shape[-2:]
    if s_r == s_c:
        # The path's slabs are square: one hat build serves both axes, a
        # few launches fewer per Newton step when this runs on the card.
        w = _hat(cyx, win, s_c)                             # (N, 2, win, s)
        wy, wx = w[:, 0:1], w[:, 1:2]
    else:
        wy = _hat(cyx[:, 0], win, s_r)[:, None]             # (N, 1, win, s_r)
        wx = _hat(cyx[:, 1], win, s_c)[:, None]
    return (wy @ slab) @ wx.transpose(-1, -2)


def newton_steps_plain(slab: torch.Tensor, i_win: torch.Tensor,
                       g: torch.Tensor, neg_inv: torch.Tensor,
                       cyx: torch.Tensor, iters: int, eps: float,
                       clamp: Optional[float] = None,
                       origin: Optional[torch.Tensor] = None,
                       done: Optional[torch.Tensor] = None,
                       steps: Optional[torch.Tensor] = None,
                       live: Optional[torch.Tensor] = None,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """``iters`` Newton steps of every point over its (N, S_R, S_C) slab (K6d,
    ``tools/lk_inkernel_probe.py:kernel_newton``).

    Each step reads the window at ``c = cyx - origin`` (``origin`` None: 0),
    clamped to ``[0, clamp]`` when ``clamp`` is given; computes
    ``b = sum(g * (J - I))`` over the window with ``g`` (N, 2, win, win) the
    template's [d/dx, d/dy]; takes the step ``d = neg_inv @ b`` with
    ``neg_inv`` (N, 2, 2) = -G^-1 in rows (dy, dx); moves the points that are
    not ``done`` (N, 1) bool by d; and freezes a point once ``|d|^2 <=
    eps^2``. cyx: (N, 2) [y, x]. With ``steps`` (N,) int32, each step adds
    one for every point that is ``live`` (N,) bool and not yet ``done``.
    Returns (cyx, done)."""
    n, win = i_win.shape[0], i_win.shape[-1]
    g_flat = g.reshape(n, 2, win * win)
    if done is None:
        done = torch.zeros((n, 1), dtype=torch.bool, device=cyx.device)
    slab = slab[:, None]
    for _ in range(iters):
        if steps is not None:
            running = ~done[:, 0] if live is None else live & ~done[:, 0]
            steps += running.to(steps.dtype)
        c = cyx if origin is None else cyx - origin
        if clamp is not None:
            c = torch.clamp(c, 0.0, clamp)
        j_win = _interp_window(slab, c, win)[:, 0]
        b = g_flat @ (j_win - i_win).reshape(-1, win * win, 1)
        d = (neg_inv @ b)[:, :, 0]                         # (N, 2) dy, dx
        cyx = torch.where(done, cyx, cyx + d)
        done = done | ((d * d).sum(dim=1, keepdim=True) <= eps * eps)
    return cyx, done


def _inverse(tmpl: torch.Tensor, win: int, min_eig_thresh: float):
    """-G^-1 in rows (dy, dx) and ``lvl_ok`` (cv2's minEigThreshold test)
    from the (N, 3, win, win) template windows [I, d/dx, d/dy]."""
    ix_win, iy_win = tmpl[:, 1], tmpl[:, 2]
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
    # The Newton loop keeps points as [y, x], the order of the in-slab
    # window offsets.
    neg_inv = -torch.stack([torch.stack([inv12, inv22], dim=1),
                            torch.stack([inv11, inv12], dim=1)], dim=1)
    return neg_inv, lvl_ok


def lk_levels_plain(prev_planes: Sequence[torch.Tensor],
                    curr_planes: Sequence[torch.Tensor],
                    prev_pts: torch.Tensor, pts_mask: torch.Tensor,
                    init_pts: Optional[torch.Tensor], win: int, iters: int,
                    eps: float, min_eig_thresh: float,
                    steps: Optional[torch.Tensor] = None,
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K6 (any device): the Newton ladder from the
    top level down. ``steps``, a preallocated (N,) int32 tensor, receives
    the Newton steps each point ran over all levels: a point runs a step
    while it is unmasked, every level so far was trackable and it has not
    frozen at this level. Returns (curr_pts (N, 2) (x, y), status (N,)
    bool, err (N,)). With a leading stream axis (points (S, N, 2), planes
    (S, 3, Hl, Wl) and (S, Hl, Wl)) each stream's ladder runs on its own
    and the outputs are stacked."""
    if prev_pts.dim() == 3:
        outs = [lk_levels_plain(
            [p[b] for p in prev_planes], [c[b] for c in curr_planes],
            prev_pts[b], pts_mask[b],
            None if init_pts is None else init_pts[b], win, iters, eps,
            min_eig_thresh, None if steps is None else steps[b])
            for b in range(prev_pts.shape[0])]
        return tuple(torch.stack(t) for t in zip(*outs))
    if steps is not None:
        steps.zero_()
    max_level = len(prev_planes) - 1
    h, w = curr_planes[0].shape
    half = (win - 1) * 0.5

    start = prev_pts if init_pts is None else init_pts
    guess = start * (1.0 / (2 ** max_level))
    ok = pts_mask
    err = torch.zeros(prev_pts.shape[0], dtype=torch.float32,
                      device=prev_pts.device)

    for level in range(max_level, -1, -1):
        drift = DRIFT_TOP if level == max_level else DRIFT
        s_c = win + 1 + 2 * drift
        curr_l = curr_planes[level][None]                    # (1, Hl, Wl)

        # Template: fixed sub-pixel window around pt_prev at this level,
        # [I, d/dx, d/dy].
        pt_prev = prev_pts / (2 ** level)
        ty0f = torch.floor(pt_prev[:, 1] - half)
        tx0f = torch.floor(pt_prev[:, 0] - half)
        t_slab = _slab(prev_planes[level], ty0f.to(torch.int64),
                       tx0f.to(torch.int64), win + 1)
        tmpl = _interp_window(
            t_slab, torch.stack([pt_prev[:, 1] - half - ty0f,
                                 pt_prev[:, 0] - half - tx0f], dim=1), win)
        i_win = tmpl[:, 0]
        neg_inv, lvl_ok = _inverse(tmpl, win, min_eig_thresh)

        rounds = 4 if level == max_level else 2
        iters_per = -(-iters // rounds)
        pt, done = guess.flip(1), (~lvl_ok)[:, None]            # [y, x]
        for _ in range(rounds):
            # Current-frame slab covering the drift budget around the
            # round's starting guess.
            c0 = torch.floor(pt - half) - drift                  # (N, 2)
            c_slab = _slab(curr_l, c0[:, 0].to(torch.int64),
                           c0[:, 1].to(torch.int64), s_c)[:, 0]
            pt, done = newton_steps_plain(
                c_slab, i_win, tmpl[:, 1:], neg_inv, pt, iters_per, eps,
                clamp=s_c - win - 1.0, origin=c0 + half, done=done,
                steps=steps, live=ok)
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


def lk_levels(prev_planes: Sequence[torch.Tensor],
              curr_planes: Sequence[torch.Tensor],
              prev_pts: torch.Tensor, pts_mask: torch.Tensor,
              init_pts: Optional[torch.Tensor], win: int, iters: int,
              eps: float, min_eig_thresh: float,
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6 on CUDA tensors (one launch, for one stream or N), the plain
    version on CPU tensors. Arguments as ``lk_levels_plain``."""
    args = (prev_planes, curr_planes, prev_pts, pts_mask, init_pts, win,
            iters, eps, min_eig_thresh)
    if prev_pts.is_cuda:
        return lk_levels_cuda(*args)
    if prev_pts.device.type != "cpu":
        raise ValueError(f"lk_levels: unsupported device {prev_pts.device}")
    return lk_levels_plain(*args)


def lk_levels_cuda(prev_planes: Sequence[torch.Tensor],
                   curr_planes: Sequence[torch.Tensor],
                   prev_pts: torch.Tensor, pts_mask: torch.Tensor,
                   init_pts: Optional[torch.Tensor], win: int, iters: int,
                   eps: float, min_eig_thresh: float,
                   steps: Optional[torch.Tensor] = None,
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K6 on the current stream: every level, round and step of
    every point of every stream in one launch. ``steps`` as in
    ``lk_levels_plain``."""
    global LAUNCHES
    n_levels = len(prev_planes)
    if not 1 <= n_levels <= MAX_LEVEL + 1 or len(curr_planes) != n_levels:
        raise ValueError(f"lk_levels: {n_levels} prev and {len(curr_planes)}"
                         f" curr planes; K6 takes 1 to {MAX_LEVEL + 1} levels")
    if not 2 <= win <= MAX_WIN or iters < 0:
        raise ValueError(f"lk_levels: win {win} (K6 takes 2 to {MAX_WIN}),"
                         f" iters {iters}")
    _lib.require_cuda(prev_pts, "lk prev_pts", torch.float32, (2, 3))
    batched = prev_pts.dim() == 3
    _lib.require_cuda(pts_mask, "lk pts_mask", torch.bool,
                      (prev_pts.dim() - 1,))
    lead = tuple(prev_pts.shape[:-1])              # (P,) or (N, P)
    n_streams = prev_pts.shape[0] if batched else 1
    n = prev_pts.shape[-2]
    if prev_pts.shape[-1] != 2 or tuple(pts_mask.shape) != lead:
        raise ValueError(f"lk_levels: prev_pts {tuple(prev_pts.shape)}, "
                         f"pts_mask {tuple(pts_mask.shape)}")
    if init_pts is not None:
        _lib.require_cuda(init_pts, "lk init_pts", torch.float32,
                          (prev_pts.dim(),))
        if init_pts.shape != prev_pts.shape:
            raise ValueError(f"lk_levels: init_pts {tuple(init_pts.shape)}")
    if steps is not None:
        _lib.require_cuda(steps, "lk steps", torch.int32,
                          (prev_pts.dim() - 1,))
        if tuple(steps.shape) != lead or steps.device != prev_pts.device:
            raise ValueError(f"lk_levels: steps {tuple(steps.shape)} on "
                             f"{steps.device}")
    ptrs = []
    sizes = []
    for level, (stk, cur) in enumerate(zip(prev_planes, curr_planes)):
        _lib.require_cuda(stk, f"lk prev planes {level}", torch.float32,
                          (4 if batched else 3,))
        _lib.require_cuda(cur, f"lk curr plane {level}", torch.float32,
                          (3 if batched else 2,))
        if stk.shape[-3] != 3 or stk.shape[-2:] != cur.shape[-2:] \
                or stk.shape[:-3] != cur.shape[:-2] \
                or (batched and cur.shape[0] != n_streams):
            raise ValueError(f"lk_levels: level {level} prev planes "
                             f"{tuple(stk.shape)}, curr {tuple(cur.shape)}")
        if stk.device != prev_pts.device or cur.device != prev_pts.device:
            raise ValueError("lk_levels: planes and points on different "
                             "devices")
        ptrs += [stk.data_ptr(), cur.data_ptr()]
        sizes += list(cur.shape[-2:])
    dev = prev_pts.device
    out = torch.empty(prev_pts.shape, dtype=torch.float32, device=dev)
    status = torch.empty(lead, dtype=torch.bool, device=dev)
    err = torch.empty(lead, dtype=torch.float32, device=dev)
    if n == 0 or n_streams == 0:
        return out, status, err
    ptr_arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    size_arr = (ctypes.c_int * len(sizes))(*sizes)
    rc = _lib.library().vs_lk_track_batched(
        ctypes.cast(ptr_arr, ctypes.c_void_p),
        ctypes.cast(size_arr, ctypes.c_void_p), n_levels,
        prev_pts.data_ptr(), pts_mask.data_ptr(),
        None if init_pts is None else init_pts.data_ptr(), n, n_streams,
        win, iters,
        eps * eps, min_eig_thresh, out.data_ptr(), status.data_ptr(),
        err.data_ptr(), None if steps is None else steps.data_ptr(),
        _lib.stream_handle(dev))
    _lib.check(rc, "lk_track")
    LAUNCHES += 1
    return out, status, err
