"""The port's FAST / ORB / BRISK detectors (``video_stab_tpu_torch/ops/
fast.py``) against the JAX package's, on the CPU.

Held on seeded textured frames, at even and odd sizes (BRISK's coarse
response is padded back to an odd size): ``fast_response`` within 1e-4
(its 16-term SAD is added in ``_CIRCLE`` order here, XLA's order there) and
the same corner set; ``fast_corners``, ``orb_corners`` and
``brisk_corners`` giving identical masks and identical points. ORB's
min-eigenvalue rescoring is K3's plain version on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from chip_smoke import make_frames  # noqa: E402
from video_stab_tpu.ops import fast as jfast  # noqa: E402
from video_stab_tpu_torch.kernels import features as kfeat  # noqa: E402
from video_stab_tpu_torch.ops import fast as tfast  # noqa: E402

SIZES = [(96, 128), (95, 127), (97, 131)]
DETECTORS = ["fast_corners", "orb_corners", "brisk_corners"]


def _gray(i, h, w):
    frame = make_frames(112, 144, 3, seed=3)[i]
    g = frame.astype(np.float32) @ np.array([0.114, 0.587, 0.299], np.float32)
    return np.ascontiguousarray(g[:h, :w])


@pytest.mark.parametrize("threshold", [5.0, 10.0])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("i", [0, 2])
def test_fast_response_matches_jax(i, size, threshold):
    g = _gray(i, *size)
    want = np.asarray(jfast.fast_response(jnp.asarray(g), threshold))
    got = tfast.fast_response(torch.from_numpy(g), threshold).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert (want > 0).sum() > 20


@pytest.mark.parametrize("name", DETECTORS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("i", [0, 1, 2])
def test_detectors_match_jax(name, size, i):
    g = _gray(i, *size)
    pj, mj = getattr(jfast, name)(jnp.asarray(g), 10.0, max_corners=64)
    before = kfeat.LAUNCHES
    pt, mt = getattr(tfast, name)(torch.from_numpy(g), 10.0, max_corners=64)
    assert kfeat.LAUNCHES == before          # CPU tensors: plain versions
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert pt.shape == (64, 2) and int(mt.sum()) >= 20


def test_orb_rescoring_is_the_min_eigenvalue_response():
    """ORB ranks FAST corners by K3's ``resp`` output, the function of the
    JAX package's ``min_eig_response``."""
    from video_stab_tpu.ops.features import min_eig_response
    g = _gray(1, 96, 128)
    want = np.asarray(min_eig_response(jnp.asarray(g), 3))
    got = kfeat.corner_response(torch.from_numpy(g))[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
