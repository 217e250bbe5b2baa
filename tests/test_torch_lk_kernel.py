"""K6, the LK Newton ladder (video_stab_tpu_torch/kernels/lk.py), on the CPU.

- ``newton_steps_plain`` against K6d, the in-kernel Newton loop of
  ``tools/lk_inkernel_probe.py:kernel_newton``, run by Pallas in interpret
  mode. Only ``kernel_newton`` and ``build_newton`` are taken from the probe
  (by ``ast``, with its module constants bound here), so its module-level
  timing never runs. The problem is a consistent one built with numpy: a
  smooth analytic slab per point, the template cut from the same function
  at a known sub-pixel offset, its analytic gradients and G^-1, and a start
  within 1.5 px, so the iteration stays inside the slab, where the probe's
  missing window clamp never acts. Tolerance: 1e-4 on the probe's output
  (y + x + done), i.e. positions within 1e-4 px and the same freeze; the
  two sum the 225-term b in different orders.
- ``lk_levels_plain`` through ``lk_track`` against the JAX ``lk_track`` in
  cases ``tests/test_torch_ops.py::test_lk_track`` lacks: initial guesses,
  every point masked, a flat frame (``lvl_ok`` fails everywhere) and points
  far outside the frame, at ``test_lk_track``'s tolerances.
- A mirror of the plane reads behind the CUDA kernel's slabs (windows
  read straight from the plane with clamped indices and origins; the hat
  weights as the kernel forms them) against ``lk_levels_plain``, at the
  tolerance the card tests hold the kernel to.
- A mirror of the kernel's Newton step (a patch of the round's slab
  staged with the kernel's row stride and aligned copies, staged again
  when the window leaves it, each thread's run of two window pixels blended
  rows first with the shared middle column, b summed per thread, by a
  butterfly per warp, then over the warps) against ``newton_steps_plain``
  within 1e-4 px, the tolerance of the K6d test above.
- ``lk_levels_plain(..., steps=)``: the Newton steps each point ran.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from conftest import make_textured  # noqa: E402
from video_stab_tpu.ops import lk as jlk  # noqa: E402
from video_stab_tpu_torch.kernels import lk as klk  # noqa: E402
from video_stab_tpu_torch.ops import lk as tlk  # noqa: E402

PROBE = Path(__file__).resolve().parent.parent / "tools" / \
    "lk_inkernel_probe.py"


def _np(x):
    return x.detach().cpu().numpy()


# ------------------------------------------------- K6d, the Newton loop --

def _build_newton(n, win, s_r, s_c):
    """``build_newton`` of the probe, with its constants bound and
    ``interpret=True``; nothing else of the probe runs."""
    tree = ast.parse(PROBE.read_text())
    fns = [f for f in tree.body if isinstance(f, ast.FunctionDef)
           and f.name in ("kernel_newton", "build_newton")]
    assert len(fns) == 2
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, N=n, WIN=win,
              SLAB_R=s_r, SLAB_C=s_c, interpret=True)
    exec(compile(ast.Module(body=fns, type_ignores=[]), str(PROBE), "exec"),
         ns)
    return ns["build_newton"]


def _newton_problem(seed, n=8, win=15, s_r=32, s_c=128):
    """A smooth analytic image per point sampled as an (n, s_r, s_c) slab,
    the template and its gradients from the same function at a known
    offset, G^-1 (x, y order), and a start near the offset [y, x]."""
    rng = np.random.default_rng(seed)
    ph = rng.uniform(0.0, 2 * np.pi, (n, 1, 1, 2))
    fq = rng.uniform(0.12, 0.3, (n, 1, 1, 4))

    def f(y, x):
        u = fq[..., 0] * y + fq[..., 1] * x + ph[..., 0]
        v = fq[..., 2] * x - fq[..., 3] * y + ph[..., 1]
        return (128.0 + 50.0 * np.sin(u) + 40.0 * np.cos(v),
                50.0 * fq[..., 1] * np.cos(u) - 40.0 * fq[..., 2] * np.sin(v),
                50.0 * fq[..., 0] * np.cos(u) + 40.0 * fq[..., 3] * np.sin(v))

    slab = f(np.arange(s_r)[None, :, None], np.arange(s_c)[None, None, :])[0]
    true = np.stack([rng.uniform(4.0, 10.0, n), rng.uniform(4.0, 100.0, n)], 1)
    ii = np.arange(win)
    i_win, gx, gy = f(true[:, 0, None, None] + ii[None, :, None],
                      true[:, 1, None, None] + ii[None, None, :])
    g = np.array([[np.sum(gx * gx, (1, 2)), np.sum(gx * gy, (1, 2))],
                  [np.sum(gx * gy, (1, 2)), np.sum(gy * gy, (1, 2))]])
    inv = np.linalg.inv(np.moveaxis(g, -1, 0))                   # (n, 2, 2)
    start = true + rng.uniform(-1.5, 1.5, (n, 2))
    f32 = np.float32
    return (slab.astype(f32), i_win.astype(f32), gx.astype(f32),
            gy.astype(f32), inv.astype(f32), start.astype(f32), true)


@pytest.mark.parametrize("seed,iters", [(0, 2), (1, 5), (2, 8)])
def test_newton_steps_match_probe_kernel(seed, iters):
    n, win = 8, 15
    slab, i_win, gx, gy, inv, start, true = _newton_problem(seed, n, win)
    want = np.asarray(_build_newton(n, win, 32, 128)(iters)(
        *map(jnp.asarray, (slab, i_win, gx, gy, inv,
                           start[:, 0, None, None], start[:, 1, None, None]))
    ))[:, 0, 0]
    neg_inv = -np.stack([np.stack([inv[:, 0, 1], inv[:, 1, 1]], 1),
                         np.stack([inv[:, 0, 0], inv[:, 0, 1]], 1)], 1)
    cyx, done = klk.newton_steps_plain(
        torch.from_numpy(slab), torch.from_numpy(i_win),
        torch.from_numpy(np.stack([gx, gy], 1)), torch.from_numpy(neg_inv),
        torch.from_numpy(start), iters, 0.03)
    got = _np(cyx).sum(1) + _np(done)[:, 0]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if iters >= 5:      # the problem is consistent: Newton converges
        assert _np(done).all()
        assert np.abs(_np(cyx) - true).max() < 0.1


# ------------------------------ lk_levels_plain against the JAX lk_track --

def _frames(seed, shift, h=96, w=128, flat=False):
    if flat:
        prev = np.full((h, w), 117.0, np.float32)
        return prev, prev.copy()
    import cv2
    world = make_textured(h + 40, w + 40, seed=seed)
    prev = world[20:20 + h, 20:20 + w]
    m = np.float32([[1, 0, shift[0]], [0, 1, shift[1]]])
    curr = cv2.warpAffine(world, m, (w + 40, h + 40))[20:20 + h, 20:20 + w]
    return prev, curr.astype(np.float32)


def _case(name):
    h, w, n = 96, 128, 40
    rng = np.random.default_rng(5)
    pts = np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n)],
                   axis=1).astype(np.float32)
    mask = rng.random(n) > 0.1
    init = None
    shift = (2.6, -1.9)
    flat = False
    if name == "init_pts":
        shift = (14.0, -11.0)        # beyond what the top level absorbs
        init = (pts + np.float32(shift)
                + rng.normal(0, 0.5, pts.shape)).astype(np.float32)
    elif name == "all masked":
        mask[:] = False
    elif name == "flat frame":
        flat = True
    elif name == "far outside":
        far = np.stack([rng.choice([-200.0, -45.0, w + 45.0, w + 300.0], n),
                        rng.choice([-150.0, -30.0, h + 30.0, h + 250.0], n)],
                       axis=1)
        pts[::2] = far[::2] + rng.uniform(-3, 3, (n, 2))[::2]
    prev, curr = _frames(7, shift, h, w, flat)
    return prev, curr, pts, mask, init


def _check_lk(got, want, eps, expect_tracked):
    """test_lk_track's tolerances: identical status; tracked positions
    within max(1e-3, eps), >= 95 % within 1e-3; err within 1e-2 where the
    positions agree."""
    status = np.asarray(want[1])
    np.testing.assert_array_equal(_np(got[1]), status)
    assert bool(status.any()) == expect_tracked
    gp, wp = _np(got[0]), np.asarray(want[0])
    np.testing.assert_allclose(gp[status], wp[status], atol=max(1e-3, eps),
                               rtol=0)
    same = np.abs(gp - wp).max(1) < 1e-3
    assert (same & status).sum() >= 0.95 * status.sum()
    np.testing.assert_allclose(_np(got[2])[same], np.asarray(want[2])[same],
                               atol=1e-2)
    return same


@pytest.mark.parametrize("name", ["init_pts", "all masked", "flat frame",
                                  "far outside"])
def test_lk_levels_plain_matches_jax(name):
    prev, curr, pts, mask, init = _case(name)
    kw = dict(win=15, max_level=2, iters=20, eps=0.03)
    before = klk.LAUNCHES
    got = tlk.lk_track(torch.from_numpy(prev), torch.from_numpy(curr),
                       torch.from_numpy(pts), torch.from_numpy(mask),
                       init_pts=None if init is None
                       else torch.from_numpy(init), **kw)
    assert klk.LAUNCHES == before            # CPU tensors: the plain version
    want = jlk.lk_track(jnp.asarray(prev), jnp.asarray(curr),
                        jnp.asarray(pts), jnp.asarray(mask),
                        init_pts=None if init is None else jnp.asarray(init),
                        **kw)
    tracked = name in ("init_pts", "far outside")
    same = _check_lk(got, want, 0.03, tracked)
    if name in ("all masked", "flat frame"):
        # Nothing moves: every point keeps its input position exactly.
        np.testing.assert_array_equal(_np(got[0]), pts)
        np.testing.assert_array_equal(np.asarray(want[0]), pts)
        assert same.all()
    if name == "far outside":
        assert not np.asarray(want[1])[::2].any()
    if name == "init_pts":
        # Without the guesses the top level cannot absorb the shift.
        assert np.asarray(want[1]).sum() > 0.8 * mask.sum()


# --------------------------------- a mirror of the kernel's direct gather --

def _taps(c):
    """The kernel's two hat weights at offset c (csrc/lk.cu ``taps``)."""
    f = torch.floor(c)
    return (f.to(torch.int64), torch.relu(1.0 - torch.abs(c + (-f))),
            torch.relu(1.0 - torch.abs(c + (-(f + 1.0)))))


def _direct(plane, oy, ox, cy, cx, win):
    """Windows straight from a (C, h, w) plane: origins oy/ox (N,) integer
    floats clamped to [-128, h] as the kernel clamps them, in-window offset
    c, rows then columns. -> (N, C, win, win)."""
    _, h, w = plane.shape
    ky, wy0, wy1 = _taps(cy)
    kx, wx0, wx1 = _taps(cx)
    ii = torch.arange(win)
    by = oy.clamp(-128, h).to(torch.int64)[:, None] + ky[:, None] + ii
    bx = ox.clamp(-128, w).to(torch.int64)[:, None] + kx[:, None] + ii

    def at(ry, rx):
        return plane[:, ry.clamp(0, h - 1)[:, :, None],
                     rx.clamp(0, w - 1)[:, None, :]].transpose(0, 1)

    def col(rx):
        return (wy0[:, None, None, None] * at(by, rx)
                + wy1[:, None, None, None] * at(by + 1, rx))
    return (col(bx) * wx0[:, None, None, None]
            + col(bx + 1) * wx1[:, None, None, None])


def _mirror(prev_planes, curr_planes, prev_pts, mask, win, iters, eps):
    top = len(prev_planes) - 1
    half = (win - 1) * 0.5
    guess = prev_pts * (1.0 / 2 ** top)
    ok = mask.clone()
    for level in range(top, -1, -1):
        drift = klk.DRIFT_TOP if level == top else klk.DRIFT
        curr = curr_planes[level][None]
        t = prev_pts / 2 ** level - half
        t0 = torch.floor(t)
        tmpl = _direct(prev_planes[level], t0[:, 1], t0[:, 0],
                       t[:, 1] - t0[:, 1], t[:, 0] - t0[:, 0], win)
        neg_inv, lvl_ok = klk._inverse(tmpl, win, 1e-4)
        pt, done = guess.flip(1), ~(lvl_ok & ok)[:, None]
        for _ in range(4 if level == top else 2):
            c0 = torch.floor(pt - half) - drift
            o = c0 + half
            for _ in range(-(-iters // (4 if level == top else 2))):
                c = torch.clamp(pt - o, 0.0, 2.0 * drift)
                j = _direct(curr, c0[:, 0], c0[:, 1], c[:, 0], c[:, 1],
                            win)[:, 0]
                b = (tmpl[:, 1:] * (j - tmpl[:, 0])[:, None]).sum((2, 3))
                d = (neg_inv @ b[:, :, None])[:, :, 0]
                pt = torch.where(done, pt, pt + d)
                done = done | ((d * d).sum(1, keepdim=True) <= eps * eps)
        ok = ok & lvl_ok
        guess = torch.where(ok[:, None], pt.flip(1), guess)
        guess = guess * 2.0 if level > 0 else guess
    e = guess - half
    e0 = torch.floor(e) - 1
    j = _direct(curr, e0[:, 1], e0[:, 0], e[:, 1] - e0[:, 1],
                e[:, 0] - e0[:, 0], win)[:, 0]
    h, w = curr_planes[0].shape
    inside = ((guess[:, 0] >= 0) & (guess[:, 0] <= w - 1) &
              (guess[:, 1] >= 0) & (guess[:, 1] <= h - 1))
    return guess, ok & inside, torch.abs(j - tmpl[:, 0]).mean((1, 2))


@pytest.mark.parametrize("name", ["init_pts", "far outside", "shift"])
def test_direct_gather_mirror_matches_plain(name):
    prev, curr, pts, mask, _ = _case(name)
    planes = tlk.lk_planes(torch.from_numpy(prev), torch.from_numpy(curr), 2)
    args = (torch.from_numpy(pts), torch.from_numpy(mask))
    want = klk.lk_levels_plain(*planes, *args, None, 15, 20, 0.03, 1e-4)
    got = _mirror(*planes, *args, 15, 20, 0.03)
    _check_lk(got, want, 0.03, True)


def test_cuda_wrapper_refuses_cpu_tensors_and_deep_pyramids():
    prev, curr, pts, mask, _ = _case("shift")
    planes = tlk.lk_planes(torch.from_numpy(prev), torch.from_numpy(curr), 2)
    args = (torch.from_numpy(pts), torch.from_numpy(mask), None, 15, 20,
            0.03, 1e-4)
    with pytest.raises(ValueError, match="CUDA"):
        klk.lk_levels_cuda(*planes, *args)
    with pytest.raises(ValueError, match="levels"):
        klk.lk_levels_cuda([planes[0][0]] * (klk.MAX_LEVEL + 2),
                           [planes[1][0]] * (klk.MAX_LEVEL + 2), *args)


# ------------------------- a mirror of the kernel's staged Newton step --

K_THREADS, K_RUN, K_STRIDE, K_DRIFT = 128, 2, 48, 8   # csrc/lk.cu


def _stage(plane, y0, x0, size):
    """csrc/lk.cu ``stage``: the size x size slab at (y0, x0), replicate
    border, rows K_STRIDE apart; in aligned 4-float pieces from the aligned
    column left of x0 where the slab lies between the plane's left and
    right edge and the plane's rows are a multiple of 4 wide. What no
    thread writes stays NaN. Returns (slab, the column of its rows that
    holds the slab's first column)."""
    h, w = plane.shape
    s = np.full(size * K_STRIDE + 4, np.nan, np.float32)
    ry = np.clip(y0 + np.arange(size), 0, h - 1)
    if w % 4 == 0 and x0 >= 0 and x0 + size <= w:
        shift = x0 & 3
        cols = np.arange(4 * ((shift + size + 3) >> 2))
        rx = x0 - shift + cols
        assert rx.max() < w and cols.max() < K_STRIDE
    else:
        shift = 0
        cols = np.arange(size)
        rx = np.clip(x0 + cols, 0, w - 1)
    rows = np.arange(size)[:, None] * K_STRIDE + cols[None, :]
    s[rows] = plane[ry[:, None], rx[None, :]]
    return s, shift


def _np_taps(c):
    f = np.floor(c)
    one = np.float32(1.0)
    return (int(f), np.maximum(np.float32(0), one - np.abs(c + (-f))),
            np.maximum(np.float32(0), one - np.abs(c + (-(f + one)))))


def _block_sum(vals):
    """(threads,) float32 -> the kernel's block sum: a xor butterfly in
    each warp, then the warps' partials in warp order."""
    v = vals.reshape(-1, 32).astype(np.float32)
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, lanes ^ o]
    assert (v == v[:, :1]).all()                 # the same bits on every lane
    total = v[0, 0]
    for part in v[1:, 0]:
        total = total + part
    return total


def _staged_newton(plane, c0, tmpl, neg_inv, pt, win, drift, iters, eps):
    """One round of one point, as the kernel runs it. plane (h, w); c0 the
    slab's integer corner [y, x]; tmpl (3, win, win); pt [y, x]."""
    f32 = np.float32
    h, w = plane.shape
    stride = K_STRIDE
    half = f32((win - 1) * 0.5)
    o = (c0 + half).astype(f32)
    y0 = int(np.clip(c0[0], -128.0, h))
    x0 = int(np.clip(c0[1], -128.0, w))
    # The kernel stages a patch of the round's slab: K_DRIFT pixels around
    # the window it is staged for, staged again when a window leaves it.
    patch = win + 1 + 2 * K_DRIFT
    py0, px0 = y0 + drift - K_DRIFT, x0 + drift - K_DRIFT
    slab, shift = _stage(plane, py0, px0, patch)
    restaged = 0
    rpr = (win + K_RUN - 1) // K_RUN
    n_thr = K_THREADS * -(-win * rpr // K_THREADS)
    run = np.arange(n_thr)
    i, j = run // rpr, (run % rpr) * K_RUN
    nv = np.where(i < win, np.minimum(win - j, K_RUN), 0)
    off = np.where(nv > 0, i * stride + j, 0)
    pt = pt.astype(f32).copy()
    done = False
    steps = 0
    cmax = f32(2 * drift)
    for _ in range(iters):
        if done:
            break
        ky, wy0, wy1 = _np_taps(np.clip(pt[0] - o[0], f32(0), cmax))
        kx, wx0, wx1 = _np_taps(np.clip(pt[1] - o[1], f32(0), cmax))
        ry, rx = y0 + ky - py0, x0 + kx - px0
        if not (0 <= ry <= 2 * K_DRIFT and 0 <= rx <= 2 * K_DRIFT):
            py0, px0 = py0 + ry - K_DRIFT, px0 + rx - K_DRIFT
            ry = rx = K_DRIFT
            slab, shift = _stage(plane, py0, px0, patch)
            restaged += 1
        base = ry * stride + rx + shift + off
        # Thread t owns runs t + K_THREADS * k and sums them in that order.
        bx = np.zeros(K_THREADS, f32)
        by = np.zeros(K_THREADS, f32)
        for k in range(n_thr // K_THREADS):
            own = slice(k * K_THREADS, (k + 1) * K_THREADS)
            t = [wy0 * slab[base[own] + m]
                 + wy1 * slab[base[own] + stride + m]
                 for m in range(K_RUN + 1)]
            for m in range(K_RUN):
                live = m < nv[own]
                jv = t[m] * wx0 + t[m + 1] * wx1
                ii = np.minimum(i[own], win - 1)
                jj = np.minimum(j[own] + m, win - 1)
                res = jv - tmpl[0][ii, jj]
                assert np.isfinite(res[live]).all()   # only staged pixels
                bx = np.where(live, bx + tmpl[1][ii, jj] * res, bx)
                by = np.where(live, by + tmpl[2][ii, jj] * res, by)
        bsx, bsy = _block_sum(bx), _block_sum(by)
        d = np.array([neg_inv[0, 0] * bsx + neg_inv[0, 1] * bsy,
                      neg_inv[1, 0] * bsx + neg_inv[1, 1] * bsy], f32)
        pt = pt + d
        done = bool(d[0] * d[0] + d[1] * d[1] <= f32(eps * eps))
        steps += 1
    return pt, done, steps, restaged


@pytest.mark.parametrize("name,win,level,push,iters", [
    ("shift", 15, 0, 0.0, 10),         # a converging round
    ("shift", 15, 2, 0.0, 5),          # the top level's 64 x 64 slab
    ("shift", 15, 0, 40.0, 2),         # the window at the clamp c = 2 * drift
    ("shift", 15, 2, 40.0, 2),         # and at the top level: a new patch
    ("far outside", 15, 0, 0.0, 3),    # slabs hanging over the frame's edge
    ("shift", 21, 0, 0.0, 4),          # two runs a thread
    ("shift", 6, 1, 0.0, 4),           # an even window: no odd last pixel
])
def test_staged_newton_mirror_matches_plain(name, win, level, push, iters):
    prev, curr, pts, mask, _ = _case(name)
    prev_planes, curr_planes = tlk.lk_planes(
        torch.from_numpy(prev), torch.from_numpy(curr), 2)
    drift = klk.DRIFT_TOP if level == 2 else klk.DRIFT
    s_c = win + 1 + 2 * drift
    half = (win - 1) * 0.5
    tpts = torch.from_numpy(pts) / 2 ** level
    t0 = torch.floor(tpts - half)
    tmpl = klk._interp_window(
        klk._slab(prev_planes[level], t0[:, 1].to(torch.int64),
                  t0[:, 0].to(torch.int64), win + 1),
        (tpts - half - t0).flip(1), win)
    neg_inv, lvl_ok = klk._inverse(tmpl, win, 1e-4)
    guess = tpts.flip(1)                                  # [y, x]
    c0 = torch.floor(guess - half) - drift
    start = guess + push
    c_slab = klk._slab(curr_planes[level][None], c0[:, 0].to(torch.int64),
                       c0[:, 1].to(torch.int64), s_c)[:, 0]
    eps = 0.03
    want, want_done = klk.newton_steps_plain(
        c_slab, tmpl[:, 0], tmpl[:, 1:], neg_inv, start, iters, eps,
        clamp=s_c - win - 1.0, origin=c0 + half, done=(~lvl_ok)[:, None])
    checked = 0
    hanging = 0
    restaged = 0
    h, w = curr_planes[level].shape
    for q in np.flatnonzero(lvl_ok.numpy()):
        got, done, steps, n_re = _staged_newton(
            curr_planes[level].numpy(), c0[q].numpy(), tmpl[q].numpy(),
            neg_inv[q].numpy(), start[q].numpy(), win, drift, iters, eps)
        np.testing.assert_allclose(got, want[q].numpy(), atol=1e-4, rtol=0)
        assert done == bool(want_done[q, 0])
        assert 1 <= steps <= iters
        checked += 1
        restaged += n_re
        hanging += bool(c0[q, 0] < 0 or c0[q, 1] < 0 or c0[q, 0] + s_c > h
                        or c0[q, 1] + s_c > w)
    assert checked >= 10, checked
    if name == "far outside" or level == 2:
        assert hanging > 0
    if push:
        # Every window sat at the clamp on its first step; at the top
        # level that is outside the patch staged for the round's start.
        assert bool(((start - (c0 + half)) > 2 * drift).all())
        assert restaged >= checked if level == 2 else restaged == 0


# ------------------------------------------------------ the steps count --

def _run_steps(name, iters=20, eps=0.03, levels=2):
    prev, curr, pts, mask, init = _case(name)
    planes = tlk.lk_planes(torch.from_numpy(prev), torch.from_numpy(curr),
                           levels)
    args = (torch.from_numpy(pts), torch.from_numpy(mask),
            None if init is None else torch.from_numpy(init), 15, iters, eps,
            1e-4)
    steps = torch.full((len(pts),), -7, dtype=torch.int32)
    got = klk.lk_levels_plain(*planes, *args, steps=steps)
    want = klk.lk_levels_plain(*planes, *args)
    for g, w_ in zip(got, want):            # passing steps changes nothing
        assert torch.equal(g, w_)
    return steps.numpy(), mask, got


def _budget(iters, levels):
    """The most steps a point can run: ``iters`` rounded up to whole
    rounds (4 at the top level, 2 below) at each of ``levels + 1``."""
    return 4 * -(-iters // 4) + levels * 2 * -(-iters // 2)


@pytest.mark.parametrize("name", ["shift", "init_pts", "far outside"])
def test_steps_counts_are_within_the_budget(name):
    steps, mask, got = _run_steps(name)
    assert (steps[~mask] == 0).all()                       # masked: no step
    assert (steps >= 0).all() and (steps <= _budget(20, 2)).all()
    tracked = got[1].numpy()
    # A tracked point ran at least one step at each of the three levels,
    # and at eps = 0.03 on a consistent shift it froze long before the end.
    assert (steps[tracked] >= 3).all()
    assert np.median(steps[tracked]) < _budget(20, 2) / 2


@pytest.mark.parametrize("iters", [20, 7, 1, 0])
def test_steps_of_a_point_that_never_converges_is_the_budget(iters):
    """eps = 0: |d|^2 <= 0 only once a step is exactly zero, so trackable
    points run every round of every level."""
    steps, mask, got = _run_steps("shift", iters=iters, eps=0.0)
    assert (steps <= _budget(iters, 2)).all()
    assert (steps[~mask] == 0).all()
    assert (steps[mask] == _budget(iters, 2)).sum() >= 0.5 * mask.sum()


@pytest.mark.parametrize("name", ["flat frame", "all masked"])
def test_steps_of_untrackable_points_are_zero(name):
    """A flat frame fails lvl_ok at every level; a masked point is never
    live: neither runs a step."""
    steps, _, _ = _run_steps(name)
    assert (steps == 0).all()


def test_steps_wrapper_checks():
    prev, curr, pts, mask, _ = _case("shift")
    planes = tlk.lk_planes(torch.from_numpy(prev), torch.from_numpy(curr), 2)
    with pytest.raises(ValueError, match="CUDA"):
        klk.lk_levels_cuda(*planes, torch.from_numpy(pts),
                           torch.from_numpy(mask), None, 15, 20, 0.03, 1e-4,
                           steps=torch.zeros(len(pts), dtype=torch.int32))
