"""The port's filters, axis-aligned resample and LK translation prior
against the JAX package's, on the CPU, inputs from a numpy seed.

Held: ``gaussian_kernel_1d`` and ``_ellipse_offsets`` equal; morphology
and threshold exact (max / min / compare of the same values); the blurs,
unsharp masking and the bilateral filter within 1e-3 on u8-scaled values
(each 1-D filter is a tap loop here and a banded matmul there, so sums
differ in order); ``resample_axis_aligned`` within 1e-3 (two taps here,
the dense tent matrices there); the translation prior's integer shift
equal on textured shifts and 0 on flat content.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from video_stab_tpu.ops import filters as jfilt  # noqa: E402
from video_stab_tpu.ops import resize as jresize  # noqa: E402
from video_stab_tpu.ops.lk import global_translation_prior as jprior  # noqa: E402
from video_stab_tpu_torch.ops import filters as tfilt  # noqa: E402
from video_stab_tpu_torch.ops import resize as tresize  # noqa: E402
from video_stab_tpu_torch.ops.lk import global_translation_prior as tprior  # noqa: E402


def _np(t):
    return t.detach().cpu().numpy()


def _textured(h, w, seed, sigma=2.0):
    rng = np.random.default_rng(seed)
    img = rng.random((h + 16, w + 16)).astype(np.float32)
    k = np.exp(-0.5 * (np.arange(-8, 9) / sigma) ** 2)
    k /= k.sum()
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "valid"), 1, img)
    img = np.apply_along_axis(lambda c: np.convolve(c, k, "valid"), 0, img)
    img = (img - img.min()) / (img.max() - img.min()) * 255.0
    return np.ascontiguousarray(img, np.float32)


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(5)
    return np.stack([_textured(40, 56, 1), _textured(40, 56, 2),
                     rng.random((40, 56)).astype(np.float32) * 255.0], -1)


@pytest.mark.parametrize("sigma,ksize", [(1.0, None), (2.5, None),
                                         (1.5, 6), (0.8, 3)])
def test_gaussian_kernel_1d_equal(sigma, ksize):
    assert tfilt.gaussian_kernel_1d(sigma, ksize) == \
        jfilt.gaussian_kernel_1d(sigma, ksize)


@pytest.mark.parametrize("ksize", [1, 3, 5, 7])
def test_ellipse_offsets_equal(ksize):
    assert tfilt._ellipse_offsets(ksize) == jfilt._ellipse_offsets(ksize)


@pytest.mark.parametrize("op", ["gaussian", "box", "unsharp", "bilateral"])
@pytest.mark.parametrize("gray", [False, True])
def test_blurs_match_jax(frame, op, gray):
    img = frame[..., 0] if gray else frame
    t, j = torch.from_numpy(np.ascontiguousarray(img)), jnp.asarray(img)
    got, want = {
        "gaussian": lambda: (tfilt.gaussian_blur(t, 1.3),
                             jfilt.gaussian_blur(j, 1.3)),
        "box": lambda: (tfilt.box_blur(t, 5), jfilt.box_blur(j, 5)),
        "unsharp": lambda: (tfilt.unsharp_mask(t, 2.0, 1.0),
                            jfilt.unsharp_mask(j, 2.0, 1.0)),
        "bilateral": lambda: (tfilt.bilateral_denoise(t, 10.0),
                              jfilt.bilateral_denoise(j, 10.0)),
    }[op]()
    assert _np(got).shape == np.asarray(want).shape
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-3, rtol=0)


@pytest.mark.parametrize("ksize", [3, 5])
def test_morphology_and_threshold_exact(frame, ksize):
    mask = np.where(frame[..., 2] > 128.0, 255.0, 0.0).astype(np.float32)
    t, j = torch.from_numpy(mask), jnp.asarray(mask)
    for tf, jf in ((tfilt.dilate, jfilt.dilate), (tfilt.erode, jfilt.erode),
                   (tfilt.morph_close, jfilt.morph_close)):
        np.testing.assert_array_equal(_np(tf(t, ksize)),
                                      np.asarray(jf(j, ksize)))
    g = torch.from_numpy(frame[..., 1].copy())
    for inv in (False, True):
        np.testing.assert_array_equal(
            _np(tfilt.threshold_binary(g, 100.0, 255.0, inverse=inv)),
            np.asarray(jfilt.threshold_binary(jnp.asarray(frame[..., 1]),
                                              100.0, 255.0, inverse=inv)))


@pytest.mark.parametrize("y0,sy,x0,sx,oh,ow", [
    (3.0, 0.75, 5.25, 0.8, 40, 56),      # crop and zoom in
    (0.0, 40 / 24, 0.0, 56 / 32, 24, 32),  # whole frame, down
    (-4.5, 1.1, 50.0, 0.9, 30, 20),      # partly outside: zero weight
    (7.0, 1.0, 2.0, 1.0, 20, 30),        # integer taps
])
def test_resample_axis_aligned_matches_jax(frame, y0, sy, x0, sx, oh, ow):
    got = tresize.resample_axis_aligned(
        torch.from_numpy(frame), torch.tensor(y0), torch.tensor(sy),
        torch.tensor(x0), torch.tensor(sx), oh, ow)
    want = jresize.resample_axis_aligned(
        jnp.asarray(frame), jnp.float32(y0), jnp.float32(sy),
        jnp.float32(x0), jnp.float32(sx), oh, ow)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-3,
                               rtol=0)


@pytest.mark.parametrize("dx,dy", [(0, 0), (5, -3), (-11, 7), (16, 16)])
def test_translation_prior_finds_textured_shifts(dx, dy):
    world = _textured(120, 160, 9, sigma=1.5)
    prev = world[20:87, 20:140]                     # (67, 120)
    curr = world[20 - dy:87 - dy, 20 - dx:140 - dx]
    got = _np(tprior(torch.from_numpy(np.ascontiguousarray(prev)),
                     torch.from_numpy(np.ascontiguousarray(curr))))
    want = np.asarray(jprior(jnp.asarray(prev), jnp.asarray(curr)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [dx, dy])


def test_translation_prior_is_zero_on_flat_content():
    flat = np.full((67, 120), 80.0, np.float32)
    for a, b in ((flat, flat), (flat, flat + 3.0)):
        got = _np(tprior(torch.from_numpy(a), torch.from_numpy(b)))
        np.testing.assert_array_equal(got, [0.0, 0.0])
        np.testing.assert_array_equal(np.asarray(jprior(jnp.asarray(a),
                                                        jnp.asarray(b))),
                                      [0.0, 0.0])


def test_translation_prior_too_small_is_zero():
    tiny = np.random.default_rng(0).random((20, 30)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tprior(torch.from_numpy(tiny), torch.from_numpy(tiny))), [0, 0])
