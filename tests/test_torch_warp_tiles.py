"""K1's interior rule, on the CPU.

The warp kernels (``video_stab_tpu_torch/csrc/warp.cu``) give each warp one
output row of a 128-pixel tile. In the 3-channel affine kernel (K1's emit
warp) the warp maps the row's two ends through M^-1 with the kernel's own
float32 arithmetic; when both lie 2 px inside [0, w-1) x [0, h-1), the warp
reads every pixel's four taps without the border mode's index maps. If that
rule were wrong, the constant border mode would silently sample past the
source's edge.

``row_interior`` below mirrors the kernel's test expression for expression.
The property: whenever it declares a row interior, every pixel of the row
has its taps (floor, floor + 1 of ``affine_coords``, the coordinates K1 and
its plain version compute) inside the source.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from video_stab_tpu_torch.ops.warp import (  # noqa: E402
    affine_coords,
    invert_affine,
)

TILE_W = 128            # output pixels of a warp's row: kBlockX * kRun
MARGIN = np.float32(2.0)
F = np.float32


def _lin(p, q, r, x, y):
    """(p * x + q * y) + r, each step rounded to float32 (warp.cu:lin)."""
    return F(F(F(p) * F(x)) + F(F(q) * F(y))) + F(r)


def _inside(m, x, y, h, w):
    """Whether output pixel (x, y) maps inside the margin."""
    sx = _lin(m[0], m[1], m[2], x, y)
    sy = _lin(m[3], m[4], m[5], x, y)
    hx = F(w - 1) - MARGIN
    hy = F(h - 1) - MARGIN
    return bool(sx >= MARGIN and sx < hx and sy >= MARGIN and sy < hy)


def row_interior(m, x0, x1, y, h, w):
    """The kernel's test for output row y, pixels [x0, x1]."""
    return _inside(m, x0, y, h, w) and _inside(m, x1, y, h, w)


def _check_map(m_inv, h, w, oh, ow):
    """Assert the property for every warp row of an (oh, ow) output;
    return how many rows were interior."""
    m = m_inv.reshape(-1).numpy().astype(np.float32)
    sx, sy = affine_coords(m_inv.reshape(2, 3), oh, ow)
    fx, fy = torch.floor(sx), torch.floor(sy)
    inside = (fx >= 0) & (fx + 1 <= w - 1) & (fy >= 0) & (fy + 1 <= h - 1)
    n = 0
    for y in range(oh):
        for x0 in range(0, ow, TILE_W):
            x1 = min(x0 + TILE_W, ow) - 1
            if row_interior(m, x0, x1, y, h, w):
                n += 1
                assert bool(inside[y, x0:x1 + 1].all()), (y, x0, m)
    return n


def _affine(deg, scale, tx, ty, cx, cy):
    a = math.radians(deg)
    c, s = scale * math.cos(a), scale * math.sin(a)
    return torch.tensor([[c, -s, cx - c * cx + s * cy + tx],
                         [s, c, cy - s * cx - c * cy + ty]],
                        dtype=torch.float32)


maps = st.fixed_dictionaries(dict(
    h=st.integers(6, 160), w=st.integers(6, 300),
    oh=st.integers(1, 12), ow=st.integers(1, 400),
    deg=st.floats(-45.0, 45.0), scale=st.floats(0.5, 2.0),
    tx=st.floats(-1.2, 1.2), ty=st.floats(-1.2, 1.2)))


@settings(max_examples=300, deadline=None, derandomize=True)
@given(maps)
def test_interior_rows_keep_every_tap_inside(p):
    """Rotations to 45 deg, scales 0.5-2, and translations up to the
    source's size, so rows land near and across every edge."""
    h, w = p["h"], p["w"]
    m = _affine(p["deg"], p["scale"], p["tx"] * w, p["ty"] * h,
                w / 2.0, h / 2.0)
    _check_map(invert_affine(m), h, w, p["oh"], p["ow"])


@pytest.mark.parametrize("roll_deg", [0.0, 2.0])
def test_stabilizing_map_rows_are_interior(roll_deg):
    """A stabilizing map at 1080p, alone and with the chain's 2 deg roll
    correction: the rule holds and admits the rows away from the frame's
    edge, so the fast path is the common one."""
    m = _affine(0.3 + roll_deg, 1.0, 3.2, -1.7, 960.0, 540.0)
    n = _check_map(invert_affine(m), 1080, 1920, 1080, 1920)
    # The segments with an end within 2 px of the source's edge (the first
    # of each row, shifted 3.2 px left, and those of the rows the rotation
    # takes to the top and bottom edges) take the general path: 9 % here.
    assert n >= 0.9 * 1080 * 15, n


def test_nan_map_is_never_interior():
    m = np.full(6, np.nan, dtype=np.float32)
    assert not row_interior(m, 0, 127, 0, 100, 100)
    m = np.array([1, 0, np.nan, 0, 1, 10], dtype=np.float32)
    assert not row_interior(m, 0, 127, 0, 100, 200)
