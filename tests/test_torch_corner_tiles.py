"""K3's strip-walking algorithm (video_stab_tpu_torch/csrc/features.cu), on
the CPU.

``strip_corner_response`` below mirrors the kernel step for step in numpy
float32 (each product and sum rounded on its own, as the kernel's
``__fmul_rn`` / ``__fadd_rn``): a warp owns a strip of 26 output columns
(32 lanes less a 3-column halo each side) and walks down 16 output rows
and a 3-row halo above and below. A lane's column and a step's row are
frame coordinates wrapped around the frame; vertical neighbours are the
lane's own last three rows, horizontal neighbours come from other lanes
(a shuffle), chosen by reflect-101 of the lane's own column (at column 0
the lane to the right, at column w - 1 the lane to the left) for the Sobel
and the box sums, and lane - 1 / lane + 1 (the wrap) for the peak test.
Lanes and rows whose neighbours were never computed hold garbage (zeros
at the start, values of other columns at a warp's ends); the mirror keeps
that, so a result that used any of it shows.

The property: responses equal ``corner_response_plain`` bit for bit and
the peak mask exactly, on sizes that no strip divides, exact strips,
frames smaller than a strip, one-row and one-column frames, and with
small strips that put many seams and rim cases into a small frame.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from video_stab_tpu.ops import features as jfeat  # noqa: E402
from video_stab_tpu_torch.kernels import features as kfeat  # noqa: E402

F = np.float32
STRIP_W, ROWS, HALO = 26, 16, 3   # csrc/features.cu kStripW, kRows, kHalo
SCALE = F(kfeat.SCALE)


def _taps3(k0, a, k1, b, k2, c):
    return (F(k0) * a + F(k1) * b) + F(k2) * c


def _sum3(a, b, c):
    return (a + b) + c


def _min_eig(sxx, syy, sxy):
    half_tr = F(0.5) * (sxx + syy)
    half_df = F(0.5) * (sxx - syy)
    disc = np.ascontiguousarray(half_df * half_df + sxy * sxy)
    # The square root is PyTorch's, as in the plain version: on a CPU it
    # differs from numpy's in the last bit for ~1 % of inputs (on the card
    # both are correctly rounded, like the kernel's __fsqrt_rn).
    return half_tr - torch.sqrt(torch.from_numpy(disc)).numpy()


def _strip(img, ys, xs, strip_w, rows, resp_out, peak_out):
    """One warp of csrc/features.cu:corner_strip_kernel: ``lanes`` columns
    (strip_w outputs and a 3-column halo each side), walking down ``rows``
    output rows and a 3-row halo above and below."""
    h, w = img.shape
    lanes = strip_w + 2 * HALO
    lane = np.arange(lanes)
    x = xs - HALO + lane
    col = x % w                                   # wrapped frame column
    at = lambda v, src: v[src % lanes]            # a shuffle from lane src
    left = np.where(col == 0, lane if w == 1 else lane + 1, lane - 1)
    right = np.where(col == w - 1, lane if w == 1 else lane - 1, lane + 1)
    writes = (lane >= HALO) & (lane < HALO + strip_w) & (x < w)
    single = h == 1

    def above(first, before, this, after):
        return (this if single else after) if first else before

    def below(last, before, this, after):
        return (this if single else before) if last else after

    zero = np.zeros(lanes, F)
    row_l, row_a, row_b = (ys - HALO) % h, 0, 0
    g0 = g1 = g2 = zero
    p0 = p1 = p2 = [zero, zero, zero]
    m0 = m1 = m2 = r1 = zero
    for t in range(rows + 2 * HALO):
        g0, g1, g2 = g1, g2, img[row_l, col]
        # Row L - 1: Sobel pair and products.
        up = above(row_a == 0, g0, g1, g2)
        dn = below(row_a == h - 1, g0, g1, g2)
        hs = _taps3(1, up, 2, g1, 1, dn)
        hd = _taps3(-1, up, 0, g1, 1, dn)
        gx = _taps3(-1, at(hs, left), 0, hs, 1, at(hs, right)) * SCALE
        gy = _taps3(1, at(hd, left), 2, hd, 1, at(hd, right)) * SCALE
        p0, p1, p2 = p1, p2, [gx * gx, gy * gy, gx * gy]
        # Row L - 2: box sums, response, the row's wrapped 3-column maximum.
        s = []
        for k in range(3):
            v = _sum3(above(row_b == 0, p0[k], p1[k], p2[k]), p1[k],
                      below(row_b == h - 1, p0[k], p1[k], p2[k]))
            s.append(_sum3(at(v, left), v, at(v, right)))
        r = _min_eig(*s)
        m0, m1 = m1, m2
        m2 = np.fmax(np.fmax(at(r, lane - 1), r), at(r, lane + 1))
        # Row L - 3: response and peak flag.
        y = ys + t - 2 * HALO
        if t >= 2 * HALO and y < h:
            resp_out[y, x[writes]] = r1[writes]
            peak_out[y, x[writes]] = (r1 >= np.fmax(np.fmax(m0, m1),
                                                     m2))[writes]
        r1 = r
        row_b, row_a = row_a, row_l
        row_l = 0 if row_l + 1 == h else row_l + 1


def strip_corner_response(img, strip_w=STRIP_W, rows=ROWS):
    h, w = img.shape
    resp = np.full((h, w), np.nan, F)
    peak = np.zeros((h, w), bool)
    for ys in range(0, h, rows):
        for xs in range(0, w, strip_w):
            _strip(img, ys, xs, strip_w, rows, resp, peak)
    assert np.isfinite(resp).all()               # every pixel written
    return resp, peak


def _gray(h, w, seed):
    """Smooth texture plus noise, u8-valued: corners, flats and ties."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = (120 + 60 * np.sin(0.31 * xx + 0.17 * yy + seed)
           + 50 * np.cos(0.23 * yy - 0.11 * xx)
           + rng.integers(-20, 21, (h, w)))
    return np.clip(np.round(img), 0, 255).astype(F)


def _check(img, tw, th):
    want_r, want_p = kfeat.corner_response_plain(torch.from_numpy(img))
    got_r, got_p = strip_corner_response(img, tw, th)
    np.testing.assert_array_equal(got_r, want_r.numpy())      # bit for bit
    np.testing.assert_array_equal(got_p, want_p.numpy())


@pytest.mark.parametrize("shape", [
    (37, 53),            # no strip divides it
    (16, 26),            # exactly one strip
    (32, 52),            # exactly 2 x 2 strips
    (5, 7), (2, 2),      # smaller than a strip
    (1, 1), (1, 90), (90, 1), (2, 70), (70, 2), (3, 3),
    (23, 81),            # four strips wide, the last one 3 px
    (135, 240),          # the analysis gray at a quarter of its size
    (54, 200),           # strips away from every edge in the middle
])
def test_strip_mirror_equals_plain(shape):
    _check(_gray(*shape, seed=sum(shape)), STRIP_W, ROWS)


# (strip_w, rows)
@pytest.mark.parametrize("tile", [(8, 4), (5, 3), (1, 1), (16, 2)])
@pytest.mark.parametrize("shape", [(37, 53), (1, 29), (29, 1), (9, 9),
                                   (20, 41)])
def test_small_strips_put_seams_everywhere(shape, tile):
    """The same algorithm with small strips: many seams, strips whose halo
    crosses two edges at once or wraps around the frame more than once."""
    _check(_gray(*shape, seed=3), *tile)


def test_flat_and_tied_frames():
    """Flat frames: every response 0 and every pixel a (tied) peak; a step
    edge: ties along the edge, on both sides of the wrap."""
    flat = np.full((20, 70), 117.0, F)
    _check(flat, STRIP_W, ROWS)
    got_r, got_p = strip_corner_response(flat)
    assert (got_r == 0).all() and got_p.all()
    step = flat.copy()
    step[:, 35:] = 30.0
    _check(step, STRIP_W, ROWS)
    _check(step.T.copy(), STRIP_W, ROWS)


def test_strip_mirror_matches_jax_gftt_semantics():
    """Against the JAX package's GFTT response and wrapped 3x3 dilation, at
    the plain version's tolerance (tests/test_torch_ops.py::
    test_corner_response_matches_jax_gftt_semantics: 1e-5 on the response,
    which sums in another order; the peak mask identical)."""
    img = _gray(54, 96, seed=1)
    resp, peak = strip_corner_response(img)
    ref = jfeat.min_eig_response(jnp.asarray(img), 3)
    np.testing.assert_allclose(resp, np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(peak,
                                  np.asarray(ref >= jfeat._dilate3x3(ref)))
