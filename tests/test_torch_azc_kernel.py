"""K7, auto zoom-crop's shrink loop as one CUDA launch (``csrc/azc.cu``,
``kernels/azc.py``), without a card.

The kernel itself runs only on the card (``test_torch_cuda.py``). Held
here: a scalar integer replay of the kernel's arithmetic (the starting
rect from the table's hole totals; per iteration the eight lanes' table
reads, their differences and the move rule) against the plain loop's
``_shrink`` step by step and against ``interior_rect`` at every
``max_iters`` of the card's tests; the rects the card's tests hold K7 to
(``azc_masks.RECTS``) against the JAX package; a CPU mask taking the plain
path (its reads counted, K7 not launched); the source and its C entry
registered with the build.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from video_stab_tpu.core import autozoomcrop as jazc  # noqa: E402
from video_stab_tpu_torch.core import autozoomcrop as tazc  # noqa: E402
from video_stab_tpu_torch.kernels import _lib  # noqa: E402
from video_stab_tpu_torch.kernels import azc as kazc  # noqa: E402
from video_stab_tpu_torch.utils import telemetry  # noqa: E402

from azc_masks import MASKS, MAX_ITERS, RECTS  # noqa: E402


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
