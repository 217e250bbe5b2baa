"""A numpy mirror of the K5a / K5b kernels (csrc/traj.cu) against their plain
PyTorch versions, bit for bit, on the CPU.

The CUDA kernels run only on the card. What can go wrong in them without a
compiler noticing is index arithmetic: which staged slot holds which path
sample, which slots take the pad, which taps a chunk of the window loop
reads, and whether the rank counting picks ``sorted[n // 2]`` under ties.
The mirror below walks the same blocks, threads and loops as the kernels,
with ``launch_config``'s tiling, and must give the plain versions' bits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from video_stab_tpu_torch.kernels import traj as ktraj  # noqa: E402

F32 = np.float32
CHUNK = 16      # taps loaded ahead of their adds (window_mean, traj.cu)


def _window_mean(s, start, stride, window, centered, i, r, n):
    acc = F32(0.0)
    for k0 in range(0, window, CHUNK):
        v = [s[start + (k0 + j) * stride] if k0 + j < window else F32(0.0)
             for j in range(CHUNK)]
        for vj in v:
            acc = F32(acc + vj)
    wf = F32(window)
    o = F32(acc * F32(F32(1.0) / wf))
    if centered:
        count = min(i + r, n - 1) - max(i - r, 0) + 1
        o = F32(F32(o * wf) / F32(count))
    return o


def mirror_window_kernel(x, offset, window, pad, centered, r):
    """box_window_kernel over every block."""
    n, c = x.shape
    blocks, threads, tile_rows, smem = ktraj.launch_config(n, c, window, False)
    assert threads == c * tile_rows and blocks * tile_rows >= n
    flat = x.reshape(-1)
    total = n * c
    out = np.full(total, np.nan, F32)
    for block in range(blocks):
        row0 = block * tile_rows
        rows = min(tile_rows, n - row0)
        staged = (rows + window - 1) * c
        base = (row0 - offset) * c
        assert 4 * staged <= smem
        s = np.full(staged, np.nan, F32)
        for f in range(staged):
            g = base + f
            if 0 <= g < total:
                s[f] = flat[g]
            else:
                s[f] = F32(0.0) if pad is None else pad[f % c]
        for ty in range(rows):
            for ch in range(c):
                tid = ty * c + ch
                out[row0 * c + tid] = _window_mean(
                    s, tid, c, window, centered, row0 + ty, r, n)
    assert not np.isnan(out).any()
    return out.reshape(n, c)


def _sort_key(v):
    if v != v:
        return 0xFFFFFFFF
    b = int(np.array(v, F32).view(np.uint32))
    return (~b & 0xFFFFFFFF) if b & 0x80000000 else (b | 0x80000000)


def mirror_median_kernel(x, offset, window, centered, r):
    """box_median_kernel: a block per channel."""
    n, c = x.shape
    blocks, _threads, _, smem = ktraj.launch_config(n, c, window, True)
    assert blocks == c
    n4 = (n + 3) & ~3
    staged = n + window - 1
    assert 4 * (n4 + 4 + staged) == smem
    out = np.full((n, c), np.nan, F32)
    for ch in range(c):
        keys = [_sort_key(x[a, ch]) if a < n else 0xFFFFFFFF
                for a in range(n4)]
        s = np.full(staged, np.nan, F32)
        for a in range(n):
            if a + offset < staged:
                s[a + offset] = x[a, ch]
        picked = []
        for a in range(n):
            ka, a4, j = keys[a], a >> 2, a & 3
            rank = sum(k <= ka for k in keys[:4 * a4])
            g = keys[4 * a4:4 * a4 + 4]
            rank += sum((g[m] <= ka) if j > m else (g[m] < ka)
                        for m in range(4))
            rank += sum(k < ka for k in keys[4 * a4 + 4:])
            if rank == n >> 1:
                picked.append(x[a, ch])
        assert len(picked) == 1
        for j in range(staged):
            if not 0 <= j - offset < n:
                s[j] = picked[0]
        assert not np.isnan(s).any() or np.isnan(x[:, ch]).any()
        for i in range(n):
            out[i, ch] = _window_mean(s, i, 1, window, centered, i, r, n)
    return out


def _path(n, c, seed):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(0, 1, (n, c)), axis=0).astype(F32)


@pytest.mark.parametrize("n,c,r", [(240, 3, 15), (240, 9, 15), (37, 3, 5),
                                   (33, 3, 3), (32, 3, 16), (9, 1, 8),
                                   (16, 2, 15), (300, 7, 50), (3, 300, 1),
                                   (97, 1, 8), (1, 3, 1), (64, 5, 24)])
def test_window_kernel_mirror_matches_plain_centered(n, c, r):
    """K5b: the tiles' edges (32 rows of 3 channels a block), windows that
    are and are not whole chunks of 16 taps, and a path wider than a
    block's 96 threads (one row a block)."""
    x = _path(n, c, seed=n + c)
    got = mirror_window_kernel(x, r, 2 * r + 1, None, True, r)
    if n <= r:
        # The wrappers return such a path as it is (the filter is the
        # identity there); the kernel itself would compute the clamped,
        # count-normalized window.
        want = np.stack([x[max(i - r, 0):i + r + 1].mean(axis=0)
                         for i in range(n)]).astype(F32)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        return
    want = ktraj.box_filter_centered_plain(torch.from_numpy(x), r).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,c,r", [(3000, 3, 8), (2100, 9, 4), (5, 3, 8),
                                   (130, 3, 17)])
def test_window_kernel_mirror_matches_plain_convolve(n, c, r):
    """K5a's tiled route (the medians passed as a pad array), which a path
    above ``MEDIAN_MAX_ROWS`` takes."""
    x = _path(n, c, seed=n)
    pad = np.sort(x, axis=0)[n // 2]
    got = mirror_window_kernel(x, r, r, pad, False, 0)
    want = ktraj.box_filter_convolve_plain(torch.from_numpy(x), r).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["walk", "ties", "constant", "nan",
                                  "signed zeros"])
@pytest.mark.parametrize("n,c,r", [(240, 3, 8), (37, 9, 5), (1, 1, 2),
                                   (2, 3, 1), (6, 2, 8), (101, 1, 50)])
def test_median_kernel_mirror_matches_plain(n, c, r, case):
    """K5a with the median ranked in the launch: exactly one sample has rank
    n // 2, under ties, NaNs (last, as torch.sort has them) and zeros of
    both signs, and it is torch.sort's."""
    x = _path(n, c, seed=10 * n + c)
    if case == "ties":
        x = np.round(x / 4.0).astype(F32)
    elif case == "constant":
        x[:] = 2.5
    elif case == "nan":
        x[::3, 0] = np.nan
    elif case == "signed zeros":
        x = np.where(np.arange(n)[:, None] % 2 == 0, F32(-0.0), F32(0.0)) \
            * np.ones((1, c), F32)
    x = np.ascontiguousarray(x, F32)
    assert ktraj.median_in_kernel(n)
    got = mirror_median_kernel(x, r, r, False, 0)
    want = ktraj.box_filter_convolve_plain(torch.from_numpy(x), r).numpy()
    np.testing.assert_array_equal(got, want)


def test_launch_config_limits():
    assert ktraj.median_in_kernel(2048)
    assert not ktraj.median_in_kernel(2049)
    blocks, threads, tile_rows, smem = ktraj.launch_config(240, 3, 31, False)
    assert (blocks, threads, tile_rows) == (8, 96, 32)
    assert smem == 4 * (32 + 30) * 3
    blocks, threads, tile_rows, _ = ktraj.launch_config(240, 9, 8, True)
    assert (blocks, threads, tile_rows) == (9, 256, 240)
    assert ktraj.launch_config(18000, 3, 31, False)[0] == 563
    assert ktraj.launch_config(4, 300, 3, False)[:3] == (4, 300, 1)
