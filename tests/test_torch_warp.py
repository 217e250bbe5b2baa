"""Parity of the port's affine warp (K1's plain version on the CPU) with
the JAX package's ``warp_affine_fast`` (the XLA tiled formulation on the
CPU) and with its Pallas kernel ``warp_affine_u8(interpret=True)``, on the
affine cases of tests/test_pallas.py, for one and three channels and every
border mode. Bit-exact, except that a difference of 1 is allowed where the
exact (float64) bilinear value lies within 1e-3 of a .5 rounding tie.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from video_stab_tpu.ops import warp as jwarp  # noqa: E402
from video_stab_tpu.pallas.warp import warp_affine_u8 as pallas_warp  # noqa: E402
from video_stab_tpu_torch.kernels import warp as kwarp  # noqa: E402
from video_stab_tpu_torch.ops import warp as twarp  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().cpu().numpy()


# ------------------------------------------------------------ warp (K1) --

WARP_CASES = [
    # test_pallas.py's affine cases: (h, w, angle, tx, ty, seed)
    (24, 40, 0.04, 3.3, -2.2, 0),
    (27, 133, -0.03, -5.0, 4.5, 2),
    (16, 130, 0.0, 0.0, 0.0, 1),
]


def _tie_mask(img, minv, mode):
    """Pixels whose exact (float64) bilinear value at the float32 source
    coordinates lies within 1e-3 of a .5 rounding boundary."""
    img64 = torch.from_numpy(np.asarray(img, np.float64))
    sx, sy = twarp.affine_coords(_t(minv).reshape(2, 3), img.shape[0],
                                 img.shape[1])
    v = _np(twarp.sample_bilinear(img64, sx.double(), sy.double(), mode))
    return np.abs(v - np.floor(v) - 0.5) < 1e-3


def _check_tie_only(got, want, ties):
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1, d.max()
    assert not np.any((d > 0) & ~ties), np.argwhere((d > 0) & ~ties)[:5]


@pytest.mark.parametrize("mode", range(5))
@pytest.mark.parametrize("ch", [1, 3])
@pytest.mark.parametrize("case", WARP_CASES)
def test_warp_affine_fast_matches_jax_and_pallas(case, ch, mode):
    h, w, ang, tx, ty, seed = case
    rng = np.random.default_rng(seed)
    shape = (h, w, 3) if ch == 3 else (h, w)
    img = rng.integers(0, 255, shape, dtype=np.uint8)
    m = np.array([[np.cos(ang), -np.sin(ang), tx],
                  [np.sin(ang), np.cos(ang), ty]], np.float32)
    before = kwarp.LAUNCHES
    got = _np(twarp.warp_affine_fast(_t(img), _t(m), border_mode=mode))
    assert kwarp.LAUNCHES == before          # CPU tensor: plain version
    assert got.dtype == np.uint8 and got.shape == img.shape
    minv = _np(twarp.invert_affine(_t(m))).reshape(6)
    ties = _tie_mask(img, minv, mode)
    if ch == 3:
        ties = ties if ties.ndim == 3 else ties[..., None]
    jax_tiled = np.asarray(jwarp.warp_affine_fast(jnp.asarray(img),
                                                  jnp.asarray(m),
                                                  border_mode=mode))
    _check_tie_only(got, jax_tiled.astype(np.uint8), ties)
    pallas = np.asarray(pallas_warp(jnp.asarray(img), jnp.asarray(m),
                                    border_mode=mode, interpret=True))
    _check_tie_only(got, pallas, ties)


def test_warp_half_even_ties():
    img = np.zeros((16, 130), np.uint8)
    img[:, 1::2] = 1
    m = np.array([[1.0, 0.0, 0.5], [0.0, 1.0, 0.0]], np.float32)
    out = _np(twarp.warp_affine_fast(_t(img), _t(m)))
    assert (out[:, 2:-2] == 0).all()


def test_warp_outside_jax_envelope_is_exact_gather():
    """A 20-deg rotation with a 150 px shift: beyond the JAX warp's static
    envelope (which clamps there) K1 still matches the exact gather."""
    rng = np.random.default_rng(9)
    img = rng.integers(0, 255, (60, 200, 3), dtype=np.uint8)
    ang = np.radians(20.0)
    m = np.array([[np.cos(ang), -np.sin(ang), 150.0],
                  [np.sin(ang), np.cos(ang), -20.0]], np.float32)
    got = _np(twarp.warp_affine_fast(_t(img), _t(m)))
    ref = np.asarray(jwarp.warp_affine(jnp.asarray(img, jnp.float32),
                                       jnp.asarray(m)))
    minv = _np(twarp.invert_affine(_t(m))).reshape(6)
    _check_tie_only(got, np.clip(np.round(ref), 0, 255).astype(np.uint8),
                    _tie_mask(img, minv, 0))


def test_warp_wrapper_rejects_other_devices():
    img = torch.empty((8, 8, 3), dtype=torch.uint8, device="meta")
    m = torch.eye(2, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kwarp.warp_affine_u8(img, m)


@pytest.mark.parametrize("mode", range(5))
def test_float_warp_affine_matches_jax(mode):
    """The port's exact gather warp (float out) against the JAX package's."""
    rng = np.random.default_rng(mode)
    img = (rng.random((29, 47, 3)) * 255).astype(np.float32)
    ang = np.radians(4.0)
    m = np.array([[np.cos(ang), -np.sin(ang), 2.7],
                  [np.sin(ang), np.cos(ang), -3.1]], np.float32)
    got = _np(twarp.warp_affine(_t(img), _t(m), 31, 50, border_mode=mode))
    want = np.asarray(jwarp.warp_affine(jnp.asarray(img), jnp.asarray(m),
                                        31, 50, border_mode=mode))
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
