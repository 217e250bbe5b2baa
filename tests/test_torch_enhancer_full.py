"""The port's full enhancer against the JAX package's ``enhance_frame`` on
the CPU: K4's head and tail plain versions against the matching pieces of
the JAX chain, and ``enhance_frame_u8`` (K4 head -> CLAHE / vibrance /
unsharp / denoise -> K4 tail) against ``saturate_u8(enhance_frame)``.

Tolerances: the head exactly (the same float32 operations); the tail's u8
exactly and its gray within 1e-3; the full chain's u8 within 1 on >= 99.9 %
of pixels. With CLAHE, >= 99 % within 1 and every pixel within 12: CLAHE
bins by truncating the float Lab L, so a 1e-6 difference in Lab (the cube
root is ``pow(t, 1/3)`` here) can move a pixel to the next bin and its
tile's LUT value by a few levels.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from video_stab_tpu.core import enhancer as jenh  # noqa: E402
from video_stab_tpu.core.params import EnhancerParams as JEnhancerParams  # noqa: E402
from video_stab_tpu.ops import color as jcolor  # noqa: E402
from video_stab_tpu_torch.core import enhancer as tenh  # noqa: E402
from video_stab_tpu_torch.core.params import EnhancerParams  # noqa: E402
from video_stab_tpu_torch.kernels import enhance as kenh  # noqa: E402

BASE = dict(brightness=1.5, contrast=1.1, gamma=1.2)
FULL_CASES = {
    "selftest unsharp": dict(BASE, enable_unsharp=True, sharpness=2.0),
    "vibrance+wb": dict(BASE, enable_vibrance=True, vibrance_strength=0.3,
                        enable_white_balance=True, wb_strength=0.5),
    "denoise": dict(BASE, enable_denoise=True, denoise_strength=10.0),
    "clahe": dict(BASE, enable_clahe=True),
    "all four": dict(BASE, enable_clahe=True, enable_vibrance=True,
                     enable_unsharp=True, sharpness=1.0,
                     enable_denoise=True, denoise_strength=5.0,
                     enable_white_balance=True),
}


@pytest.fixture(scope="module")
def img():
    rng = np.random.default_rng(11)
    base = rng.integers(0, 256, (48, 64, 3)).astype(np.float32)
    k = np.ones(5) / 5.0
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    return np.clip(base + rng.normal(0, 8, base.shape), 0, 255).astype(
        np.uint8)


def _jax_u8(kw, img):
    f = jenh.enhance_frame(JEnhancerParams(**kw),
                           jnp.asarray(img, jnp.float32))
    return np.asarray(jcolor.saturate_u8(f)), np.asarray(f)


@pytest.mark.parametrize("kw", [dict(BASE), dict(BASE, gamma=1.0),
                                dict(BASE, enable_white_balance=True)])
def test_head_plain_matches_jax_pointwise(img, kw):
    """The head is white balance then contrast/brightness, gamma off."""
    p = EnhancerParams(**kw)
    got = kenh.enhance_head(p, torch.from_numpy(img)).numpy()
    want = np.asarray(jenh.enhance_frame(
        dataclasses.replace(JEnhancerParams(**kw), gamma=1.0),
        jnp.asarray(img, jnp.float32)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gamma", [1.2, 0.9, 1.0])
def test_tail_plain_matches_jax_gamma_and_saturate(img, gamma):
    x = img.astype(np.float32) * 1.3 - 20.0          # out of [0, 255] too
    p = EnhancerParams(gamma=gamma)
    out, gray = kenh.enhance_tail(p, torch.from_numpy(x), want_gray=True)
    f = jenh.enhance_frame(JEnhancerParams(gamma=gamma), jnp.asarray(x))
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jcolor.saturate_u8(f)))
    np.testing.assert_allclose(gray.numpy(),
                               np.asarray(jcolor.bgr_to_gray(f)),
                               atol=1e-3, rtol=0)
    assert kenh.enhance_tail(p, torch.from_numpy(x))[1] is None


@pytest.mark.parametrize("case", list(FULL_CASES))
def test_full_chain_matches_jax(img, case):
    kw = FULL_CASES[case]
    p = EnhancerParams(**kw)
    assert tenh.has_filters(p)
    launches = (kenh.LAUNCHES, kenh.HEAD_LAUNCHES, kenh.TAIL_LAUNCHES)
    out, gray = tenh.enhance_frame_u8(p, torch.from_numpy(img),
                                      want_gray=True)
    # A CPU tensor takes the plain versions: no kernel launched.
    assert (kenh.LAUNCHES, kenh.HEAD_LAUNCHES, kenh.TAIL_LAUNCHES) == \
        launches
    want, f = _jax_u8(kw, img)
    d = np.abs(out.numpy().astype(int) - want.astype(int))
    if "clahe" in case or case == "all four":
        assert (d <= 1).mean() >= 0.99 and d.max() <= 12, \
            ((d <= 1).mean(), d.max())
    else:
        assert d.max() <= 1 and (d == 0).mean() >= 0.999, \
            (d.max(), (d == 0).mean())
        np.testing.assert_allclose(gray.numpy(),
                                   np.asarray(jcolor.bgr_to_gray(f)),
                                   atol=1e-2, rtol=0)
    # The float chain is the plain reference of the same route.
    ref = tenh.enhance_frame(p, torch.from_numpy(img).float())
    np.testing.assert_array_equal(
        torch.clamp(torch.round(ref), 0, 255).to(torch.uint8).numpy(),
        out.numpy())


def test_enhancer_class_on_the_cpu(img):
    kw = FULL_CASES["selftest unsharp"]
    # use_cuda=False in the params does not pick the device.
    e = tenh.Enhancer(EnhancerParams(**kw, use_cuda=False), device="cpu")
    got = e.enhance(img)
    want, _ = _jax_u8(kw, img)
    assert got.dtype == np.uint8 and got.shape == img.shape
    assert (np.abs(got.astype(int) - want.astype(int)) <= 1).all()
    np.testing.assert_array_equal(
        tenh.Enhancer.enhance_image(img, EnhancerParams(**kw),
                                    device="cpu"), got)
    np.testing.assert_array_equal(
        tenh.Enhancer(device="cpu", **kw).enhance(img), got)


def test_enhance_frame_refuses_the_card_route():
    """The float chain is the plain version: a CUDA tensor must take
    enhance_frame_u8 (K4). Checked without a card through the device
    test the function makes first."""
    class FakeCuda:
        is_cuda = True
    with pytest.raises(ValueError, match="enhance_frame_u8"):
        tenh.enhance_frame(EnhancerParams(), FakeCuda())
