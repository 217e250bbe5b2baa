"""K9, LK's planes as one CUDA launch a pyramid level (``csrc/lk_planes.cu``,
``kernels/lk_planes.py``), without a card.

The kernel itself runs only on the card (``test_torch_cuda.py``). Held
here: a replay of the kernel's blocks in numpy float32 (the tile sizes
read from the source; per block the staged source window, pyr_down's H
and W passes over the halo'd tile with the zero taps read outside the
stage, Scharr's vertical then horizontal passes, the bfloat16 rounding)
against ``lk_planes_plain`` bit for bit on odd and tiny shapes at every
level count K9 takes, for one and three streams; CPU grays taking the
plain planes with no launch counted; the wrapper's refusals, raised
before any launch; the source and its C entry registered with the build.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from video_stab_tpu_torch.kernels import _lib  # noqa: E402
from video_stab_tpu_torch.kernels import lk as klk  # noqa: E402
from video_stab_tpu_torch.kernels import lk_planes as klp  # noqa: E402
from video_stab_tpu_torch.ops import lk as tlk  # noqa: E402
from video_stab_tpu_torch.ops.filters import reflect_101_index  # noqa: E402
from video_stab_tpu_torch.ops.resize import _taps  # noqa: E402
from video_stab_tpu_torch.utils import telemetry  # noqa: E402

F32 = np.float32
SMOOTH = (F32(3.0 / 16), F32(10.0 / 16), F32(3.0 / 16))
DIFF = (F32(-0.5), F32(0.0), F32(0.5))


def _constant(name: str) -> int:
    src = (_lib.CSRC / "lk_planes.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


TILE_H, TILE_W = _constant("kTileH"), _constant("kTileW")


def _gray(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """u8-domain float32 grays with texture and some exact integers."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.0, 255.0, (n, h, w)).astype(F32)
    g[:, ::3] = np.round(g[:, ::3])
    return g


def _taps3(a, b, c, k):
    """((a * k0 + b * k1) + c * k2) in float32, each product rounded."""
    return (a * k[0] + b * k[1]) + c * k[2]


class _Replay:
    """K9's blocks in numpy float32; ``fallbacks`` counts the zero taps
    read outside the staged window (the kernel's global-memory reads)."""

    def __init__(self):
        self.fallbacks = 0

    def down_rows(self, src, rows_o, cols, idx, wts):
        """pyr_down's H pass at level rows ``rows_o`` and source columns
        ``cols`` from the whole source (the kernel's global reads)."""
        acc = None
        for t in range(idx.shape[1]):
            p = src[:, idx[rows_o, t]][:, :, cols] * wts[rows_o, t][None, :,
                                                                   None]
            acc = p if acc is None else acc + p
        return acc

    def level(self, src, down, hl, wl):
        """Level l of (n, hs, ws) ``src`` over K9's blocks: (L, ix, iy)."""
        n, hs, ws = src.shape
        if down:
            idx_h, w_h = _taps("pyr", hs, hl)
            idx_w, w_w = _taps("pyr", ws, wl)
        lvl = np.full((n, hl, wl), np.nan, F32)
        ix = np.full_like(lvl, np.nan)
        iy = np.full_like(lvl, np.nan)
        for r0 in range(0, hl, TILE_H):
            for c0 in range(0, wl, TILE_W):
                rows = min(TILE_H + 2, hl - r0 + 2)
                cols = min(TILE_W + 2, wl - c0 + 2)
                ri = [reflect_101_index(r0 - 1 + r, hl) for r in range(rows)]
                ci = [reflect_101_index(c0 - 1 + c, wl) for c in range(cols)]
                if not down:
                    s_l = src[:, ri][:, :, ci]
                else:
                    s_l = self.down_tile(src, r0, c0, ri, ci, idx_h, w_h,
                                         idx_w, w_w)
                t_rows, t_cols = min(TILE_H, hl - r0), min(TILE_W, wl - c0)
                a = _taps3(s_l[:, :t_rows], s_l[:, 1:t_rows + 1],
                           s_l[:, 2:t_rows + 2], SMOOTH)
                b = _taps3(s_l[:, :t_rows], s_l[:, 1:t_rows + 1],
                           s_l[:, 2:t_rows + 2], DIFF)
                sl = (slice(None), slice(r0, r0 + t_rows),
                      slice(c0, c0 + t_cols))
                lvl[sl] = s_l[:, 1:t_rows + 1, 1:t_cols + 1]
                ix[sl] = _taps3(a[:, :, :t_cols], a[:, :, 1:t_cols + 1],
                                a[:, :, 2:t_cols + 2], DIFF)
                iy[sl] = _taps3(b[:, :, :t_cols], b[:, :, 1:t_cols + 1],
                                b[:, :, 2:t_cols + 2], SMOOTH)
        return lvl, ix, iy

    def down_tile(self, src, r0, c0, ri, ci, idx_h, w_h, idx_w, w_w):
        n, hs, ws = src.shape
        sr0, sr1 = max(0, 2 * r0 - 4), min(hs - 1, 2 * (r0 + TILE_H) + 2)
        sc0, sc1 = max(0, 2 * c0 - 4), min(ws - 1, 2 * (c0 + TILE_W) + 2)
        stage = src[:, sr0:sr1 + 1, sc0:sc1 + 1]
        assert stage.shape[1] <= 2 * TILE_H + 7
        assert stage.shape[2] <= 2 * TILE_W + 7
        s_v = np.empty((n, len(ri), sc1 - sc0 + 1), F32)
        for r, o in enumerate(ri):
            acc = None
            for t in range(idx_h.shape[1]):
                sr = idx_h[o, t]
                if sr0 <= sr <= sr1:
                    x = stage[:, sr - sr0]
                else:
                    # Only the zero-weight pad taps leave the stage.
                    assert w_h[o, t] == 0 and sr == 0, (o, t, sr)
                    self.fallbacks += 1
                    x = src[:, sr, sc0:sc1 + 1]
                p = x * w_h[o, t]
                acc = p if acc is None else acc + p
            s_v[:, r] = acc
        s_l = np.empty((n, len(ri), len(ci)), F32)
        for c, o in enumerate(ci):
            acc = None
            for t in range(idx_w.shape[1]):
                sc = idx_w[o, t]
                if sc0 <= sc <= sc1:
                    x = s_v[:, :, sc - sc0]
                else:
                    assert w_w[o, t] == 0 and sc == 0, (o, t, sc)
                    self.fallbacks += 1
                    x = self.down_rows(src, ri, [sc], idx_h, w_h)[:, :, 0]
                p = x * w_w[o, t]
                acc = p if acc is None else acc + p
            s_l[:, :, c] = acc
        return s_l


def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).to(torch.bfloat16).to(torch.float32)


def _replay_planes(prev: np.ndarray, curr: np.ndarray, max_level: int,
                   replay: _Replay):
    """K9's launches of one call: (prev stacks, curr planes) per level."""
    prev_planes, curr_planes = [], []
    src_p, src_c = prev, curr
    for level in range(max_level + 1):
        down = level > 0
        hs, ws = src_p.shape[1:]
        hl, wl = ((hs + 1) // 2, (ws + 1) // 2) if down else (hs, ws)
        lp, ixp, iyp = replay.level(src_p, down, hl, wl)
        lc, _, _ = replay.level(src_c, down, hl, wl)
        prev_planes.append(torch.stack([_bf16(lp), _bf16(ixp), _bf16(iyp)],
                                       dim=1))
        curr_planes.append(_bf16(lc))
        src_p, src_c = lp, lc
    return prev_planes, curr_planes


REPLAY_CASES = [((1, 1), 0), ((1, 1), 5), ((2, 3), 3), ((3, 2), 5),
                ((5, 4), 2), ((45, 67), 3), ((61, 83), 5), ((61, 83), 1),
                ((33, 65), 2), ((70, 130), 2), ((17, 200), 4)]


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("shape,max_level", REPLAY_CASES,
                         ids=[f"{h}x{w}-L{m}" for (h, w), m in REPLAY_CASES])
def test_k9_replay_matches_plain_planes(shape, max_level, n):
    """The replay of K9's blocks equals ``lk_planes_plain`` on every plane,
    bit for bit (NaN marks a pixel no block wrote)."""
    h, w = shape
    prev, curr = _gray(n, h, w, h * w + n), _gray(n, h, w, h + w + n)
    replay = _Replay()
    got = _replay_planes(prev, curr, max_level, replay)
    want = tlk.lk_planes_plain(torch.from_numpy(prev),
                               torch.from_numpy(curr), max_level)
    for level in range(max_level + 1):
        assert torch.equal(got[0][level], want[0][level]), level
        assert torch.equal(got[1][level], want[1][level]), level


def test_k9_replay_reads_the_zero_taps_outside_the_stage():
    """Where a block's last level columns or rows have fewer than the
    table's taps, their zero-weight taps at index 0 lie outside the staged
    window; the replay (as the kernel) reads them from the whole source."""
    prev = _gray(1, 61, 83, 1)
    replay = _Replay()
    replay.level(prev, True, 31, 42)
    assert replay.fallbacks > 0


@pytest.mark.parametrize("n", [1, 3])
def test_lk_planes_on_cpu_takes_the_plain_planes(n):
    """CPU grays take ``lk_planes_plain``: the same planes, no K9 launch
    counted, for one stream and for three."""
    shape = (n, 45, 67) if n > 1 else (45, 67)
    prev = torch.from_numpy(_gray(n, 45, 67, 5).reshape(shape))
    curr = torch.from_numpy(_gray(n, 45, 67, 6).reshape(shape))
    launches = klp.PLANES_LAUNCHES
    counted = telemetry.counters().get("lk_planes_kernel", 0)
    got = tlk.lk_planes(prev, curr, 2)
    want = tlk.lk_planes_plain(prev, curr, 2)
    assert klp.PLANES_LAUNCHES == launches
    assert telemetry.counters().get("lk_planes_kernel", 0) == counted
    for g, x in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, x)
    assert got[0][0].shape == (*shape[:-2], 3, 45, 67)
    assert got[1][2].shape == (*shape[:-2], 12, 17)


def test_k9_wrapper_refuses_before_any_launch():
    """The wrapper refuses CPU grays, float64, non-contiguous grays,
    mismatched or empty shapes and more levels than K6 takes, each before
    it builds or launches anything."""
    g = torch.from_numpy(_gray(1, 20, 30, 7)[0])
    launches = klp.PLANES_LAUNCHES
    for prev, curr, levels, match in (
            (g, g, 2, "CUDA"),
            (g, g, klk.MAX_LEVEL + 1, "max_level"),
            (g, g, -1, "max_level"),
            (g, g, 1.5, "max_level")):
        with pytest.raises(ValueError, match=match):
            klp.lk_planes_cuda(prev, curr, levels)
    assert klp.PLANES_LAUNCHES == launches


def test_k9_source_is_built():
    assert "lk_planes.cu" in _lib.SOURCES
    assert "vs_lk_planes" in _lib._SIGNATURES
    src = (_lib.CSRC / "lk_planes.cu").read_text()
    assert 'extern "C" int vs_lk_planes(' in src
    assert "lk_planes_kernel" in src
