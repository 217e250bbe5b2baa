"""The stream axis of K1, K2, K3 and K6's plain versions, on the CPU.

Each batched plain version (and each wrapper on a CPU tensor) is held bit
for bit to the stack of its single-stream plain version over the streams:
the warps reading each stream's frame from an (N, Q, H, W, C) ring at its
own slot, K3 on (N, H, W) grays, K6 on (N, P) points over N pyramids. The
shapes are odd on purpose (no multiple of a tile or a warp). The kernels
themselves are held to these on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from video_stab_tpu_torch.kernels import features as kf  # noqa: E402
from video_stab_tpu_torch.kernels import lk as klk  # noqa: E402
from video_stab_tpu_torch.kernels import warp as kw  # noqa: E402
from video_stab_tpu_torch.ops.lk import lk_planes, lk_track  # noqa: E402
from video_stab_tpu_torch.ops.warp import (BORDER_CONSTANT,  # noqa: E402
                                           BORDER_REFLECT_101,
                                           similarity_matrix)


def _ring(rng, n, q, h, w, c):
    shape = (n, q, h, w) + ((c,) if c > 1 else ())
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))


def _maps(rng, n):
    da = torch.from_numpy(rng.normal(0, 0.03, n).astype(np.float32))
    dx = torch.from_numpy(rng.normal(0, 4, n).astype(np.float32))
    dy = torch.from_numpy(rng.normal(0, 4, n).astype(np.float32))
    return similarity_matrix(dx, dy, da)                   # (N, 2, 3)


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("mode", [BORDER_CONSTANT, BORDER_REFLECT_101])
@pytest.mark.parametrize("shape", [(3, 4, 37, 53), (5, 2, 29, 131)])
def test_affine_ring_warp_is_the_stack_of_single_warps(shape, mode, c):
    n, q, h, w = shape
    rng = np.random.default_rng(n * h + c)
    ring = _ring(rng, n, q, h, w, c)
    slots = torch.from_numpy(rng.integers(0, q, n).astype(np.int32))
    m = _maps(rng, n)
    got = kw.warp_affine_u8_batched(ring, slots, m, border_mode=mode)
    want = torch.stack([kw.warp_affine_u8(ring[b, int(slots[b])], m[b],
                                          border_mode=mode)
                        for b in range(n)])
    assert got.shape == want.shape == (n, h, w) + ((c,) if c > 1 else ())
    assert torch.equal(got, want)
    minv = kw.invert_affine(m).reshape(n, 6)
    assert torch.equal(kw.warp_affine_u8_batched_plain(
        ring, slots, minv, h - 3, w + 5, mode), torch.stack(
        [kw.warp_affine_u8_plain(ring[b, int(slots[b])], minv[b], h - 3,
                                 w + 5, mode) for b in range(n)]))


@pytest.mark.parametrize("shape", [(3, 4, 37, 53), (2, 6, 31, 97)])
def test_homography_ring_warp_is_the_stack_of_single_warps(shape):
    n, q, h, w = shape
    rng = np.random.default_rng(h)
    ring = _ring(rng, n, q, h, w, 3)
    slots = torch.from_numpy(rng.integers(0, q, n).astype(np.int32))
    hm = torch.eye(3).repeat(n, 1, 1) + torch.from_numpy(
        rng.normal(0, 1e-3, (n, 3, 3)).astype(np.float32))
    hm[:, :2, 2] += torch.from_numpy(rng.normal(0, 3, (n, 2))
                                     .astype(np.float32))
    got = kw.warp_homography_u8_batched(ring, slots, hm)
    want = torch.stack([kw.warp_homography_u8(ring[b, int(slots[b])], hm[b])
                        for b in range(n)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(4, 37, 53), (3, 1, 29), (2, 29, 1),
                                   (3, 540 // 9, 960 // 9)])
def test_corner_response_is_the_stack_of_single_responses(shape):
    rng = np.random.default_rng(shape[1])
    gray = torch.from_numpy(rng.integers(0, 256, shape).astype(np.float32))
    resp, peak = kf.corner_response(gray)
    for b in range(shape[0]):
        r1, p1 = kf.corner_response_plain(gray[b])
        assert torch.equal(resp[b], r1) and torch.equal(peak[b], p1)


def _lk_inputs(rng, n, h, w, p, levels):
    base = rng.integers(0, 256, (n, h + 8, w + 8)).astype(np.float32)
    k = np.ones(5, np.float32) / 5
    for ax in (1, 2):
        base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), ax,
                                   base)
    prev = torch.from_numpy(base[:, 4:4 + h, 4:4 + w].copy())
    shift = rng.normal(0, 1.5, (n, 1, 1, 2))
    curr = torch.from_numpy(np.stack([
        np.roll(base[b], (int(round(shift[b, 0, 0, 1])),
                          int(round(shift[b, 0, 0, 0]))), (0, 1))
        [4:4 + h, 4:4 + w] for b in range(n)]).astype(np.float32))
    pts = torch.from_numpy(np.stack([
        rng.uniform(4, w - 5, (n, p)), rng.uniform(4, h - 5, (n, p))],
        axis=-1).astype(np.float32))
    mask = torch.from_numpy(rng.random((n, p)) > 0.2)
    return prev, curr, pts, mask


@pytest.mark.parametrize("n,h,w,p,levels", [(3, 61, 83, 17, 2),
                                            (2, 45, 67, 9, 1)])
def test_lk_ladder_is_the_stack_of_single_ladders(n, h, w, p, levels):
    rng = np.random.default_rng(p)
    prev, curr, pts, mask = _lk_inputs(rng, n, h, w, p, levels)
    planes = lk_planes(prev, curr, levels)
    for b in range(n):
        pb, cb = lk_planes(prev[b], curr[b], levels)
        for x, y in zip(planes[0], pb):
            assert torch.equal(x[b], y)
        for x, y in zip(planes[1], cb):
            assert torch.equal(x[b], y)
    init = pts + 0.5
    steps = torch.zeros((n, p), dtype=torch.int32)
    got = klk.lk_levels_plain(*planes, pts, mask, init, 9, 12, 0.03, 1e-4,
                              steps=steps)
    for b in range(n):
        one_steps = torch.zeros(p, dtype=torch.int32)
        want = klk.lk_levels_plain([x[b] for x in planes[0]],
                                   [x[b] for x in planes[1]], pts[b],
                                   mask[b], init[b], 9, 12, 0.03, 1e-4,
                                   steps=one_steps)
        for g, wnt in zip(got, want):
            assert torch.equal(g[b], wnt)
        assert torch.equal(steps[b], one_steps)
    tracked = lk_track(prev, curr, pts, mask, win=9, max_level=levels,
                       iters=12)
    for b in range(n):
        one = lk_track(prev[b], curr[b], pts[b], mask[b], win=9,
                       max_level=levels, iters=12)
        for g, wnt in zip(tracked, one):
            assert torch.equal(g[b], wnt)


def test_wrappers_count_no_launch_on_the_cpu():
    """On CPU tensors the wrappers take the plain versions: no kernel
    launch is counted."""
    rng = np.random.default_rng(1)
    before = (kw.LAUNCHES, kw.HOMOGRAPHY_LAUNCHES, kf.LAUNCHES,
              klk.LAUNCHES)
    ring = _ring(rng, 2, 3, 17, 19, 3)
    slots = torch.zeros(2, dtype=torch.int32)
    kw.warp_affine_u8_batched(ring, slots, _maps(rng, 2))
    kw.warp_homography_u8_batched(ring, slots, torch.eye(3).repeat(2, 1, 1))
    kf.corner_response(torch.rand(2, 17, 19) * 255)
    assert (kw.LAUNCHES, kw.HOMOGRAPHY_LAUNCHES, kf.LAUNCHES,
            klk.LAUNCHES) == before
