"""Parity of the PyTorch port's operators with the JAX package's, on the
CPU: the same numpy inputs go through both. On a CPU tensor each kernel
wrapper runs its plain PyTorch version; the JAX side runs as its own CPU
tests run it (the XLA path, or ``interpret=True`` for a Pallas call).

Tolerances: color/resize/filters agree to 1e-4 in u8 units (float32
rounding of a different summation order); the corner response to 1e-5
with an identical peak mask;
GFTT points, LK status, RANSAC inliers, Canny edges and Hough lines are
identical; the enhancer's u8 output differs by at most 1 on < 0.1 % of
pixels (powf rounding).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import make_textured  # noqa: E402
from video_stab_tpu.core import enhancer as jenh  # noqa: E402
from video_stab_tpu.core.params import EnhancerParams as JEnhancerParams  # noqa: E402
from video_stab_tpu.motion import estimate as jest  # noqa: E402
from video_stab_tpu.ops import canny as jcanny  # noqa: E402
from video_stab_tpu.ops import color as jcolor  # noqa: E402
from video_stab_tpu.ops import features as jfeat  # noqa: E402
from video_stab_tpu.ops import filters as jfilt  # noqa: E402
from video_stab_tpu.ops import hough as jhough  # noqa: E402
from video_stab_tpu.ops import lk as jlk  # noqa: E402
from video_stab_tpu.ops import resize as jresize  # noqa: E402
from video_stab_tpu.pallas.features import corner_response as pallas_corner  # noqa: E402
from video_stab_tpu_torch.core import enhancer as tenh  # noqa: E402
from video_stab_tpu_torch.core.params import EnhancerParams  # noqa: E402
from video_stab_tpu_torch.kernels import enhance as kenh  # noqa: E402
from video_stab_tpu_torch.kernels import features as kfeat  # noqa: E402
from video_stab_tpu_torch.motion import estimate as t_est  # noqa: E402
from video_stab_tpu_torch.ops import canny as tcanny  # noqa: E402
from video_stab_tpu_torch.ops import color as tcolor  # noqa: E402
from video_stab_tpu_torch.ops import features as tfeat  # noqa: E402
from video_stab_tpu_torch.ops import filters as tfilt  # noqa: E402
from video_stab_tpu_torch.ops import hough as though  # noqa: E402
from video_stab_tpu_torch.ops import lk as tlk  # noqa: E402
from video_stab_tpu_torch.ops import resize as tresize  # noqa: E402

U8_ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _gray(h, w, seed=0):
    return make_textured(h, w, seed=seed).astype(np.float32)


# ---------------------------------------------------------------- color --

def test_saturate_u8_rounds_half_to_even():
    x = np.asarray([-3.0, 0.5, 1.5, 2.5, 2.4999, 254.5, 255.5, 300.0, 7.0],
                   np.float32)
    np.testing.assert_array_equal(_np(tcolor.saturate_u8(_t(x))),
                                  np.asarray(jcolor.saturate_u8(x)))


def test_bgr_to_gray():
    rng = np.random.default_rng(0)
    img = (rng.random((37, 53, 3)) * 255).astype(np.float32)
    np.testing.assert_allclose(_np(tcolor.bgr_to_gray(_t(img))),
                               np.asarray(jcolor.bgr_to_gray(img)),
                               atol=U8_ATOL, rtol=0)


# --------------------------------------------------------------- resize --

@pytest.mark.parametrize("shape,out", [
    ((96, 128), (48, 64)), ((100, 140), (54, 96)), ((48, 64), (96, 130)),
    ((90, 120, 3), (45, 60)), ((1, 17), (1, 9))])
def test_resize_bilinear(shape, out):
    rng = np.random.default_rng(1)
    img = (rng.random(shape) * 255).astype(np.float32)
    got = _np(tresize.resize_bilinear(_t(img), *out))
    want = np.asarray(jresize.resize_bilinear(img, *out))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=U8_ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(48, 64), (27, 33), (96, 130)])
def test_pyramid(shape):
    img = _gray(*shape, seed=3)
    got = tresize.build_pyramid(_t(img), 2)
    want = jresize.build_pyramid(jnp.asarray(img), 2)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        np.testing.assert_allclose(_np(g), np.asarray(w_), atol=U8_ATOL,
                                   rtol=0)


# -------------------------------------------------------------- filters --

@pytest.mark.parametrize("kh,kw", [
    ((1.0, 2.0, 1.0), (-1.0, 0.0, 1.0)),
    ((0.25, 0.5, 0.25), (0.1, 0.2, 0.4, 0.2, 0.1)),
    ((1.0, 1.0, 1.0), (1.0, 1.0, 1.0))])
def test_sep_filter2d(kh, kw):
    img = (np.random.default_rng(4).random((31, 45)) * 255).astype(np.float32)
    np.testing.assert_allclose(
        _np(tfilt.sep_filter2d(_t(img), kh, kw)),
        np.asarray(jfilt.sep_filter2d(img, kh, kw)), atol=U8_ATOL, rtol=1e-6)


@pytest.mark.parametrize("fn", ["sobel", "scharr_derivs"])
def test_derivatives(fn):
    img = _gray(40, 56, seed=5)
    for got, want in zip(getattr(tfilt, fn)(_t(img)),
                         getattr(jfilt, fn)(img)):
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=U8_ATOL, rtol=1e-6)


# ---------------------------------------------------- corner response (K3) --

@pytest.mark.parametrize("shape,seed", [((48, 64), 0), ((54, 96), 1),
                                        ((64, 128), 2)])
def test_corner_response_matches_jax_gftt_semantics(shape, seed):
    gray = _gray(*shape, seed=seed)
    before = kfeat.LAUNCHES
    resp, peak = kfeat.corner_response(_t(gray))
    assert kfeat.LAUNCHES == before
    ref = jfeat.min_eig_response(jnp.asarray(gray), 3)
    ref_peak = ref >= jfeat._dilate3x3(ref)
    np.testing.assert_allclose(_np(resp), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(_np(peak), np.asarray(ref_peak))
    # The Pallas kernel pads the source once: it agrees on the interior.
    p_resp, p_peak = pallas_corner(jnp.asarray(gray), interpret=True)
    np.testing.assert_allclose(_np(resp)[2:-2, 2:-2],
                               np.asarray(p_resp)[2:-2, 2:-2], atol=1e-5,
                               rtol=0)
    agree = np.mean(_np(peak)[2:-2, 2:-2] == np.asarray(p_peak)[2:-2, 2:-2])
    assert agree >= 0.995, agree


def test_corner_response_noise_image():
    gray = (np.random.default_rng(7).random((40, 60)) * 255).astype(
        np.float32)
    resp, peak = kfeat.corner_response(_t(gray))
    ref = jfeat.min_eig_response(jnp.asarray(gray), 3)
    np.testing.assert_allclose(_np(resp), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(
        _np(peak), np.asarray(ref >= jfeat._dilate3x3(ref)))


# ---------------------------------------------------------------- GFTT --

@pytest.mark.parametrize("shape,kw", [
    ((48, 64), dict(max_corners=32, quality_level=0.01, min_distance=5.0)),
    ((96, 128), dict(max_corners=64, quality_level=0.02, min_distance=15.0)),
    ((60, 80), dict(max_corners=200, quality_level=0.01, min_distance=3.0)),
])
def test_good_features_to_track(shape, kw):
    gray = _gray(*shape, seed=11)
    pts, mask = tfeat.good_features_to_track(_t(gray), **kw)
    for topk in ("flat", "auto"):
        jp, jm = jfeat.good_features_to_track(jnp.asarray(gray), topk=topk,
                                              **kw)
        np.testing.assert_array_equal(_np(mask), np.asarray(jm))
        np.testing.assert_array_equal(_np(pts), np.asarray(jp))


def test_good_features_roi():
    gray = _gray(48, 64, seed=12)
    roi = np.asarray([10, 8, 30, 20], np.int32)
    pts, mask = tfeat.good_features_to_track(_t(gray), max_corners=16,
                                             min_distance=4.0, roi=_t(roi))
    jp, jm = jfeat.good_features_to_track(jnp.asarray(gray), max_corners=16,
                                          min_distance=4.0,
                                          roi=jnp.asarray(roi))
    np.testing.assert_array_equal(_np(mask), np.asarray(jm))
    np.testing.assert_array_equal(_np(pts), np.asarray(jp))


# ------------------------------------------------------------------- LK --

@pytest.mark.parametrize("eps", [0.03, 1e-6])
@pytest.mark.parametrize("shift,seed", [((1.7, -2.3), 0), ((-4.2, 3.1), 1),
                                        ((9.5, 6.0), 2)])
def test_lk_track(shift, seed, eps):
    """Identical status; positions within 1e-3 px. With the stabilizer's
    eps = 0.03 a point whose converging step lands within float rounding
    of eps freezes one Newton step earlier or later in one of the two, so
    there >= 95 % of points agree within 1e-3 px and every one within eps;
    eps = 1e-6 removes that discontinuity and every point agrees within
    1e-3 px."""
    h, w = 96, 128
    world = make_textured(h + 40, w + 40, seed=seed)
    prev = world[20:20 + h, 20:20 + w]
    m = np.float32([[1, 0, shift[0]], [0, 1, shift[1]]])
    import cv2
    curr = cv2.warpAffine(world, m, (w + 40, h + 40))[20:20 + h, 20:20 + w]
    rng = np.random.default_rng(seed)
    n = 48
    pts = np.stack([rng.uniform(-5, w + 5, n), rng.uniform(-5, h + 5, n)],
                   axis=1).astype(np.float32)
    mask = rng.random(n) > 0.1
    got = tlk.lk_track(_t(prev), _t(curr.astype(np.float32)), _t(pts),
                       _t(mask), win=15, max_level=2, iters=20, eps=eps)
    want = jlk.lk_track(jnp.asarray(prev), jnp.asarray(curr, jnp.float32),
                        jnp.asarray(pts), jnp.asarray(mask), win=15,
                        max_level=2, iters=20, eps=eps)
    status = np.asarray(want[1])
    np.testing.assert_array_equal(_np(got[1]), status)
    assert status.sum() > n // 2
    np.testing.assert_allclose(_np(got[0])[status], np.asarray(want[0])[status],
                               atol=max(1e-3, eps), rtol=0)
    same = status & (np.abs(_np(got[0]) - np.asarray(want[0])).max(1) < 1e-3)
    assert same.sum() >= 0.95 * status.sum(), (same.sum(), status.sum())
    # The final-window error agrees wherever the positions do.
    np.testing.assert_allclose(_np(got[2])[same], np.asarray(want[2])[same],
                               atol=1e-2)


# --------------------------------------------------------------- RANSAC --

@pytest.mark.parametrize("seed,n_hyp", [(0, 32), (1, 100), (2, 500)])
def test_ransac_with_jax_draws(seed, n_hyp):
    rng = np.random.default_rng(seed)
    n = 64
    prev = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    ang, s = 0.03, 1.01
    rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    curr = (prev @ (s * rot).T + np.array([2.5, -1.5])).astype(np.float32)
    curr[:12] += rng.uniform(-30, 30, (12, 2)).astype(np.float32)  # outliers
    curr += rng.normal(0, 0.3, curr.shape).astype(np.float32)
    mask = rng.random(n) > 0.15
    key = jax.random.PRNGKey(seed)
    n_valid = int(mask.sum())
    draws = np.asarray(jax.random.randint(key, (n_hyp, 2), 0,
                                          max(n_valid, 1)))
    m, ok, inl = t_est.estimate_similarity_ransac(
        _t(prev), _t(curr), _t(mask), draws=_t(draws), n_hypotheses=n_hyp)
    jm, jok, jinl = jest.estimate_similarity_ransac(
        jnp.asarray(prev), jnp.asarray(curr), jnp.asarray(mask), key,
        n_hypotheses=n_hyp)
    assert bool(ok) == bool(jok)
    np.testing.assert_array_equal(_np(inl), np.asarray(jinl))
    np.testing.assert_allclose(_np(m), np.asarray(jm), atol=1e-4, rtol=0)


def test_ransac_generator_draws_stay_in_range():
    g = torch.Generator().manual_seed(0)
    for n_valid in (0, 1, 2, 7, 200):
        d = t_est.ransac_draws(g, 500, torch.tensor(n_valid))
        assert d.shape == (500, 2) and d.dtype == torch.int64
        assert int(d.min()) >= 0 and int(d.max()) <= max(n_valid, 1) - 1


# ------------------------------------------------------------- Canny --

@pytest.mark.parametrize("seed", [0, 1])
def test_canny_edges(seed):
    gray = _gray(67, 120, seed=seed)
    yy, xx = np.mgrid[:67, :120]
    gray = gray * 0.6 + 90.0 * (yy < 30 + 0.05 * xx)
    gray = gray.astype(np.float32)
    np.testing.assert_array_equal(_np(tcanny.canny_edges(_t(gray))),
                                  np.asarray(jcanny.canny_edges(gray)))


# ------------------------------------------------------------- Hough --

def _tilted_lines(h, w, deg_list, seed=0):
    rng = np.random.default_rng(seed)
    edges = np.zeros((h, w), np.float32)
    xs = np.arange(w)
    for k, deg in enumerate(deg_list):
        y = (h * (k + 1) / (len(deg_list) + 1)
             + np.tan(np.radians(deg)) * (xs - w / 2)).round().astype(int)
        ok = (y >= 0) & (y < h)
        edges[y[ok], xs[ok]] = 255.0
    edges[rng.random((h, w)) < 0.01] = 255.0
    return edges


@pytest.mark.parametrize("theta_range", [None, (math.radians(80.0),
                                                math.radians(100.0))])
@pytest.mark.parametrize("degs", [(2.0,), (-3.0, 1.5, 4.0)])
def test_hough_lines(degs, theta_range):
    edges = _tilted_lines(90, 160, degs)
    kw = dict(rho=1.0, theta=math.radians(1.0), threshold=40, max_lines=64,
              theta_range=theta_range)
    lines, votes, mask = though.hough_lines(_t(edges), **kw)
    jl, jv, jm = jhough.hough_lines(jnp.asarray(edges), **kw)
    assert int(_np(mask).sum()) >= len(degs)
    np.testing.assert_array_equal(_np(votes), np.asarray(jv))
    np.testing.assert_array_equal(_np(mask), np.asarray(jm))
    np.testing.assert_array_equal(_np(lines), np.asarray(jl))


# ---------------------------------------------------------- enhance (K4) --

ENHANCE_CASES = [
    dict(brightness=5.0, contrast=1.1, gamma=0.9),          # entry() config
    dict(brightness=10.0, contrast=1.2, gamma=0.8, enable_white_balance=True,
         wb_strength=0.5),
    dict(contrast=0.7),
    dict(gamma=1.0005),                                     # gamma skipped
]


@pytest.mark.parametrize("kw", ENHANCE_CASES)
def test_enhance_u8_matches_enhance_frame_saturate(kw):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (100, 140, 3), dtype=np.uint8)
    before = kenh.LAUNCHES
    out, gray = tenh.enhance_frame_u8(EnhancerParams(**kw), _t(img),
                                      want_gray=True)
    assert kenh.LAUNCHES == before
    f = jenh.enhance_frame(JEnhancerParams(**kw), jnp.asarray(img,
                                                              jnp.float32))
    want = np.asarray(jcolor.saturate_u8(f))
    d = np.abs(_np(out).astype(int) - want.astype(int))
    assert d.max() <= 1, d.max()
    assert (d == 0).mean() >= 0.999, (d == 0).mean()
    np.testing.assert_allclose(_np(gray), np.asarray(jcolor.bgr_to_gray(f)),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(
        _np(tenh.enhance_frame(EnhancerParams(**kw), _t(img).float())),
        np.asarray(f), atol=1e-3, rtol=0)
