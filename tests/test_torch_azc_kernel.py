"""K7, auto zoom-crop's shrink loop as one CUDA launch, and K8, its
content mask as one launch (``csrc/azc.cu``, ``kernels/azc.py``), without
a card.

The kernel itself runs only on the card (``test_torch_cuda.py``). Held
here: a scalar integer replay of the kernel's arithmetic (the starting
rect from the table's hole totals; per iteration the eight lanes' table
reads, their differences and the move rule) against the plain loop's
``_shrink`` step by step and against ``interior_rect`` at every
``max_iters`` of the card's tests; the rects the card's tests hold K7 to
(``azc_masks.RECTS``) against the JAX package; a CPU mask taking the plain
path (its reads counted, K7 not launched); the source and its C entry
registered with the build.

K8: a replay of the kernel's tiles in Python integers (the tile and halo
sizes read from the source; the threshold's bits a row-word with only the
halo words' 2r lanes next to the tile loaded, the dilate's and the
erode's runs as the funnel shifts of a word and its neighbours, bits
outside the frame set for the erode) against ``content_mask_plain`` bit
for bit on ``azc_masks.mask_frame``'s frames; the ellipse's rows as runs
(the half-widths K8 is passed); a CPU frame taking the plain path (K8
not launched) and the wrapper's refusals.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from video_stab_tpu.core import autozoomcrop as jazc  # noqa: E402
from video_stab_tpu_torch.core import autozoomcrop as tazc  # noqa: E402
from video_stab_tpu_torch.core.params import AutoZoomCropParams  # noqa: E402
from video_stab_tpu_torch.kernels import _lib  # noqa: E402
from video_stab_tpu_torch.kernels import azc as kazc  # noqa: E402
from video_stab_tpu_torch.ops.color import bgr_to_gray  # noqa: E402
from video_stab_tpu_torch.ops.filters import _ellipse_offsets  # noqa: E402
from video_stab_tpu_torch.utils import telemetry  # noqa: E402

from azc_masks import (  # noqa: E402
    MASK_KSIZES,
    MASK_SHAPES,
    MASK_THRESHOLDS,
    MASKS,
    MAX_ITERS,
    RECTS,
    mask_frame,
)


def _table(mask: np.ndarray) -> torch.Tensor:
    return tazc._prefix_table(torch.from_numpy(mask) > 0)


def _start(cum: list, h: int, w: int) -> tuple:
    """The kernel's starting rect: rows and columns with fewer holes than
    their length hold content."""
    col = h * (w + 1)
    rows = [r for r in range(h) if cum[r * (w + 1) + w] < w]
    cols = [c for c in range(w) if cum[col + c * (h + 1) + h] < h]
    return (min(cols, default=w), min(rows, default=h),
            max(cols, default=-1), max(rows, default=-1))


def _move(cum: list, rect: tuple, h: int, w: int):
    """One iteration of the kernel's loop in Python integers: the new rect,
    or None where the loop stops."""
    x0, y0, x1, y1 = rect
    cx0, cy0 = min(max(x0, 0), w - 1), min(max(y0, 0), h - 1)
    cx1, cy1 = min(max(x1, 0), w - 1), min(max(y1, 0), h - 1)
    col = h * (w + 1)
    v = []
    for lane in range(8):
        edge, end = lane >> 1, (lane & 1) == 0
        if edge & 1 == 0:
            idx = (col + (cx0 if edge == 0 else cx1) * (h + 1)
                   + (cy1 + 1 if end else cy0))
        else:
            idx = (cy0 if edge == 1 else cy1) * (w + 1) + (
                cx1 + 1 if end else cx0)
        v.append(cum[idx])
    cl, ct, cr, cb = v[0] - v[1], v[2] - v[3], v[4] - v[5], v[6] - v[7]
    if not (cl + ct + cr + cb > 0 and x0 < x1 and y0 < y1):
        return None
    top = ct > cb and ct > cl and ct > cr
    bottom = not ct > cb and cb > cl and cb > cr
    left = cl >= cr and cl >= cb and cl >= ct
    right = not cl >= cr and cr >= ct and cr >= cb
    tie = not (top or bottom or left or right)
    return (x0 + int(left or (tie and cl > 0)),
            y0 + int(top or (tie and ct > 0)),
            x1 - int(right or (tie and cr > 0)),
            y1 - int(bottom or (tie and cb > 0)))


def _kernel_replay(mask: np.ndarray, max_iters) -> tuple:
    h, w = mask.shape
    cum = _table(mask).tolist()
    rect = _start(cum, h, w)
    for _ in range(h + w if max_iters is None else max_iters):
        moved = _move(cum, rect, h, w)
        if moved is None:
            break
        rect = moved
    return rect


@pytest.mark.parametrize("name", list(MASKS))
def test_move_rule_matches_shrink(name):
    """The kernel's iteration against the plain loop's ``_shrink``, one
    step at a time from the plain starting rect until the loop stops."""
    m = MASKS[name]
    h, w = m.shape
    cum_t = _table(m)
    cum = cum_t.tolist()
    rect_t = tazc.interior_rect(torch.from_numpy(m), max_iters=0)
    assert _start(cum, h, w) == tuple(rect_t.tolist())
    steps = 0
    while True:
        moved = _move(cum, tuple(rect_t.tolist()), h, w)
        new_t, go = tazc._shrink(cum_t, rect_t, h, w)
        assert bool(go) == (moved is not None), (name, steps)
        if moved is None:
            assert torch.equal(new_t, rect_t)
            break
        assert tuple(new_t.tolist()) == moved, (name, steps)
        rect_t = new_t
        steps += 1
    assert steps > 0 or not name.startswith("rot")


@pytest.mark.parametrize("max_iters", MAX_ITERS)
@pytest.mark.parametrize("name", list(MASKS))
def test_kernel_replay_matches_plain_and_jax(name, max_iters):
    """The whole kernel replayed, the plain loop and the JAX package give
    the rect the card's tests hold K7 to, at every ``max_iters``."""
    m = MASKS[name]
    want = RECTS[name][max_iters]
    assert _kernel_replay(m, max_iters) == want
    got = tazc.interior_rect(torch.from_numpy(m), max_iters)
    assert tuple(got.tolist()) == want
    assert tuple(int(v) for v in np.asarray(
        jazc.interior_rect(jnp.asarray(m), max_iters))) == want


def test_cpu_mask_takes_the_plain_path():
    """A CPU mask runs the chunked loop: its reads are counted (RECT_READS,
    ``azc_rect_reads``), K7 is not launched, and the kernel's wrapper
    refuses a CPU table rather than falling back."""
    m = torch.from_numpy(MASKS["rot 30.0"])
    reads, launches = tazc.RECT_READS, kazc.RECT_KERNEL_LAUNCHES
    counted = dict(telemetry.counters())
    tazc.interior_rect(m)
    after = telemetry.counters()
    assert tazc.RECT_READS - reads >= 2            # > 32 moves
    assert (after.get("azc_rect_reads", 0) - counted.get("azc_rect_reads", 0)
            == tazc.RECT_READS - reads)
    assert kazc.RECT_KERNEL_LAUNCHES == launches
    assert after.get("azc_rect_kernel", 0) == counted.get("azc_rect_kernel",
                                                          0)
    h, w = m.shape
    with pytest.raises(ValueError, match="CUDA"):
        kazc.interior_rect_cuda(_table(MASKS["rot 30.0"]), h, w, h + w)
    assert kazc.RECT_KERNEL_LAUNCHES == launches
    assert kazc.table_size(h, w) == _table(MASKS["full"]).numel()


def test_k7_is_built_and_bound():
    """``azc.cu`` is one of the library's sources and ``vs_interior_rect``
    has its C signature (cum, h, w, max_iters, rect, stream)."""
    assert "azc.cu" in _lib.SOURCES
    assert (_lib.CSRC / "azc.cu").is_file()
    assert "vs_interior_rect" in (_lib.CSRC / "azc.cu").read_text()
    p, i = _lib.ctypes.c_void_p, _lib.ctypes.c_int
    assert _lib._SIGNATURES["vs_interior_rect"] == (p, i, i, i, p, p)


# ---- K8: the content mask ----------------------------------------------

M32 = 0xFFFFFFFF


def _k8_constant(name: str) -> int:
    src = (_lib.CSRC / "azc.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _funnel_r(lo: int, hi: int, s: int) -> int:
    """__funnelshift_r: the low word of hi:lo shifted right by s."""
    return ((hi << 32 | lo) >> s) & M32


def _funnel_l(lo: int, hi: int, s: int) -> int:
    """__funnelshift_l: the high word of hi:lo shifted left by s."""
    return ((hi << 32 | lo) << s) >> 32 & M32


def _run(left: int, word: int, right: int, hw: int, is_or: bool) -> int:
    v = word
    for s in range(1, hw + 1):
        a, b = _funnel_r(word, right, s), _funnel_l(left, word, s)
        v = (v | a | b) if is_or else (v & a & b)
    return v


def _in_frame_bits(y: int, xs: int, h: int, w: int) -> int:
    if not 0 <= y < h:
        return 0
    lo, hi = max(0, -xs), min(32, w - xs)
    return 0 if hi <= lo else ((1 << hi) - 1) & ~((1 << lo) - 1)


def _k8_replay(frame: torch.Tensor, thresh: float, ksize: int
               ) -> np.ndarray:
    """K8's four phases, tile by tile, in Python integers. The threshold
    reads the plain gray (K8's is K4's arithmetic, held on the card)."""
    tile_words, tile_rows = _k8_constant("kTileWords"), \
        _k8_constant("kTileRows")
    row_words = tile_words + 2
    h, w, _ = frame.shape
    r = ksize // 2
    hws = kazc.ellipse_half_widths(ksize)
    content = (bgr_to_gray(frame) > thresh).numpy()
    lanes = np.arange(32)
    out = np.full((h, w), -1.0, np.float32)        # -1: never written
    for y0 in range(0, h, tile_rows):
        for x0 in range(0, w, tile_words * 32):
            wx = x0 - 32
            m = []                                 # rows y0 - 2r ..
            for row in range(tile_rows + 4 * r):
                y = y0 - 2 * r + row
                words = []
                for word in range(row_words):
                    x = wx + 32 * word + lanes
                    need = (((word > 0) | (lanes >= 32 - 2 * r))
                            & ((word < row_words - 1) | (lanes < 2 * r)))
                    ok = need & (x >= 0) & (x < w) & (0 <= y < h)
                    bits = np.zeros(32, bool)
                    bits[ok] = content[y, x[ok]] if ok.any() else False
                    words.append(int(sum(1 << int(i)
                                         for i in np.flatnonzero(bits))))
                m.append(words)
            d = []                                 # rows y0 - r ..
            for row in range(tile_rows + 2 * r):
                words = []
                for word in range(row_words):
                    acc = 0
                    for dy in range(-r, r + 1):
                        mr = m[row + r + dy]
                        acc |= _run(mr[word - 1] if word > 0 else 0,
                                    mr[word],
                                    mr[word + 1] if word < row_words - 1
                                    else 0, hws[dy + r], True)
                    outside = ~_in_frame_bits(y0 - r + row, wx + 32 * word,
                                              h, w) & M32
                    words.append(acc | outside)
                d.append(words)
            for row in range(tile_rows):
                for word in range(1, tile_words + 1):
                    acc = M32
                    for dy in range(-r, r + 1):
                        dr = d[row + r + dy]
                        acc &= _run(dr[word - 1], dr[word], dr[word + 1],
                                    hws[dy + r], False)
                    y = y0 + row
                    for bit in range(32):
                        x = x0 + 32 * (word - 1) + bit
                        if y < h and x < w:
                            out[y, x] = 255.0 if acc >> bit & 1 else 0.0
    return out


@pytest.mark.parametrize("ksize", MASK_KSIZES)
@pytest.mark.parametrize("shape", MASK_SHAPES)
def test_k8_replay_matches_plain(shape, ksize):
    """The kernel's tiles replayed give ``content_mask_plain`` bit for
    bit, every pixel written once: random colours at each threshold, and
    values on and within 0.5 of the threshold 10."""
    h, w = shape
    frames = [(mask_frame(h, w, ksize, deg=10.0 + 2 * ksize), t)
              for t in MASK_THRESHOLDS]
    frames.append((mask_frame(h, w, ksize + 1, deg=25.0, near=10.0), 10.0))
    for f, t in frames:
        ft = torch.from_numpy(f)
        want = tazc.content_mask_plain(ft, t, ksize).numpy()
        np.testing.assert_array_equal(_k8_replay(ft, t, ksize), want)


@pytest.mark.parametrize("ksize", range(1, kazc.MASK_MAX_KSIZE + 1, 2))
def test_ellipse_rows_are_runs(ksize):
    """Each row dy of the ellipse is the run -hw .. hw that K8 is passed,
    hw <= r (the kernel's halo) and at most 15 (4 bits)."""
    r = ksize // 2
    hws = kazc.ellipse_half_widths(ksize)
    assert len(hws) == 2 * r + 1 and max(hws) <= min(r, 15)
    assert r <= _k8_constant("kMaskMaxR")
    runs = tuple((dy, dx) for dy, hw in zip(range(-r, r + 1), hws)
                 for dx in range(-hw, hw + 1))
    assert runs == _ellipse_offsets(ksize)


def test_cpu_frame_takes_the_plain_mask_path():
    """A CPU frame runs ``content_mask_plain``: K8 is not launched nor
    counted, and the wrapper refuses a CPU frame, another dtype, a
    non-contiguous frame and a ksize it has no ellipse for, rather than
    falling back."""
    f = torch.from_numpy(mask_frame(40, 70, 3))
    launches = kazc.MASK_KERNEL_LAUNCHES
    counted = telemetry.counters().get("azc_mask_kernel", 0)
    got = tazc.content_mask(f, 10.0, 5)
    assert torch.equal(got, tazc.content_mask_plain(f, 10.0, 5))
    tazc.auto_zoom_crop_f32(AutoZoomCropParams(), f)
    assert kazc.MASK_KERNEL_LAUNCHES == launches
    assert telemetry.counters().get("azc_mask_kernel", 0) == counted
    for bad, ksize, match in ((f, 5, "CUDA"), (f.double(), 5, "CUDA"),
                              (f.transpose(0, 1), 5, "CUDA"),
                              (f, 4, "ksize"), (f, 0, "ksize"),
                              (f, kazc.MASK_MAX_KSIZE + 2, "ksize")):
        with pytest.raises(ValueError, match=match):
            kazc.content_mask_cuda(bad, 10.0, ksize)
    assert kazc.MASK_KERNEL_LAUNCHES == launches


def test_k8_is_built_and_bound():
    """``vs_content_mask`` is in ``azc.cu`` with its C signature (frame, h,
    w, thresh, r, hw_bits, out, stream)."""
    assert "vs_content_mask" in (_lib.CSRC / "azc.cu").read_text()
    p, i, f = _lib.ctypes.c_void_p, _lib.ctypes.c_int, _lib.ctypes.c_float
    assert _lib._SIGNATURES["vs_content_mask"] == (
        p, i, i, f, i, _lib.ctypes.c_ulonglong, p, p)
