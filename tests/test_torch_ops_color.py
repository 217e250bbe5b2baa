"""The port's color conversions against the JAX package's, on the CPU:
``gray_to_bgr``, ``bgr_to_hsv`` / ``hsv_to_bgr``, ``bgr_to_lab`` /
``lab_to_bgr`` and ``bgr_to_i420`` / ``i420_to_bgr``, inputs from a numpy
seed.

Tolerances: HSV and its inverse within 1e-4 (float32 divides in another
order); Lab within 2e-3 (the cube root is ``pow(t, 1/3)`` here, ``cbrt``
there, and the sRGB power 2.4 differs by an ulp or two, amplified by the
Lab scales); I420 exact on >= 99.9 % of samples and within 1 everywhere
(the weights are summed term by term here, as a matmul there, and a sum
that lands on .5 can round either way), its inverse within 1e-4; the
half-up rounding of I420 (not ``saturate_u8``'s half to even) exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from video_stab_tpu.ops import color as jcolor  # noqa: E402
from video_stab_tpu_torch.ops import color as tcolor  # noqa: E402


def _img(h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
    img[:4] = 0.0                                # black rows
    img[4:8] = 255.0                             # white rows
    img[8:12] = img[8:12, :, :1]                 # gray rows (S = 0)
    return img


def _np(t):
    return t.detach().cpu().numpy()


def test_gray_to_bgr_replicates():
    g = np.random.default_rng(1).random((5, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tcolor.gray_to_bgr(torch.from_numpy(g))),
        np.asarray(jcolor.gray_to_bgr(jnp.asarray(g))))


def test_hsv_round_trip_matches_jax():
    img = _img()
    hsv = _np(tcolor.bgr_to_hsv(torch.from_numpy(img)))
    want = np.array(jcolor.bgr_to_hsv(jnp.asarray(img)))
    np.testing.assert_allclose(hsv, want, atol=1e-4, rtol=0)
    back = _np(tcolor.hsv_to_bgr(torch.from_numpy(want)))
    np.testing.assert_allclose(back, np.asarray(jcolor.hsv_to_bgr(
        jnp.asarray(want))), atol=1e-4, rtol=0)
    np.testing.assert_allclose(back, img, atol=1e-2, rtol=0)


def test_lab_round_trip_matches_jax():
    img = _img(seed=2)
    lab = _np(tcolor.bgr_to_lab(torch.from_numpy(img)))
    want = np.array(jcolor.bgr_to_lab(jnp.asarray(img)))
    np.testing.assert_allclose(lab, want, atol=2e-3, rtol=0)
    back = _np(tcolor.lab_to_bgr(torch.from_numpy(want)))
    np.testing.assert_allclose(back, np.asarray(jcolor.lab_to_bgr(
        jnp.asarray(want))), atol=2e-3, rtol=0)
    np.testing.assert_allclose(back, img, atol=0.05, rtol=0)


def test_i420_matches_jax():
    img = _img(96, 128, seed=3).astype(np.uint8)
    got = _np(tcolor.bgr_to_i420(torch.from_numpy(img)))
    want = np.array(jcolor.bgr_to_i420(jnp.asarray(img)))
    assert got.shape == want.shape == (144, 128) and got.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(), d.mean())
    back = _np(tcolor.i420_to_bgr(torch.from_numpy(want), 96))
    np.testing.assert_allclose(back, np.asarray(jcolor.i420_to_bgr(
        jnp.asarray(want), 96)), atol=1e-4, rtol=0)


def test_i420_rounds_half_up():
    """I420's rounding is floor(x + 0.5): 16.5 -> 17, where saturate_u8
    rounds half to even (16)."""
    x = torch.tensor([16.5, 17.5, -0.4, 255.6])
    np.testing.assert_array_equal(_np(tcolor._u8_half_up(x)),
                                  [17, 18, 0, 255])
    assert _np(tcolor.saturate_u8(x))[0] == 16


@pytest.mark.parametrize("shape", [(90, 64, 3), (96, 63, 3), (94, 64, 3)])
def test_i420_raises_like_jax_on_odd_sizes(shape):
    """H % 4 != 0 or W % 2 != 0 raises in both packages (a reference
    defect kept for parity)."""
    img = np.zeros(shape, np.uint8)
    with pytest.raises(ValueError, match="I420"):
        tcolor.bgr_to_i420(torch.from_numpy(img))
    with pytest.raises(ValueError, match="I420"):
        jcolor.bgr_to_i420(jnp.asarray(img))
