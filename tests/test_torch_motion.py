"""Parity of the port's trajectory filters, motion-intent analysis and roll
estimate with the JAX package's, on the CPU, over the same numpy inputs.
Tolerances: smoothed values 1e-5 (float32 sums in another order), intent
codes and radii identical, the roll angle 1e-4 deg."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from video_stab_tpu.core import rollcorrection as jroll  # noqa: E402
from video_stab_tpu.core.params import RollCorrectionParams as JRollParams  # noqa: E402
from video_stab_tpu.motion import filters as jfilters  # noqa: E402
from video_stab_tpu.motion import intent as jintent  # noqa: E402
from video_stab_tpu_torch.core import rollcorrection as troll  # noqa: E402
from video_stab_tpu_torch.core.params import RollCorrectionParams  # noqa: E402
from video_stab_tpu_torch.motion import filters as tfilters  # noqa: E402
from video_stab_tpu_torch.motion import intent as tintent  # noqa: E402

RING = 128


def _ring(kind, seed=0):
    """(RING, 3) raw-transform rings with a known character."""
    rng = np.random.default_rng(seed)
    if kind == "pan":
        r = np.tile([6.0, 0.5, 0.001], (RING, 1)) + rng.normal(0, 0.1,
                                                              (RING, 3))
    elif kind == "shake":
        r = rng.normal(0, 1.0, (RING, 3)) * [1.0, 1.0, 0.02]
        r[:, 2] += 0.02
    elif kind == "follow":
        ang = rng.uniform(-np.pi, np.pi, RING)
        r = np.stack([8 * np.cos(ang), 8 * np.sin(ang),
                      rng.normal(0, 0.01, RING)], axis=1)
    else:
        r = rng.normal(0, 2.0, (RING, 3)) * [1.0, 1.0, 0.01]
    return r.astype(np.float32)


def _i(v):
    return torch.tensor(v, dtype=torch.int32)


@pytest.mark.parametrize("n_path,emit,radius", [
    (1, 0, 2), (5, 2, 8), (40, 20, 5), (40, 38, 8), (200, 170, 3),
    (200, 199, 8), (3, 1, 4)])
def test_box_filter_emit_and_adaptive_radius(n_path, emit, radius):
    path = np.cumsum(_ring("random", seed=n_path), axis=0)
    got = tfilters.box_filter_emit(torch.from_numpy(path), _i(n_path),
                                   _i(emit), _i(radius), 8)
    want = jfilters.box_filter_emit(jnp.asarray(path), jnp.int32(n_path),
                                    jnp.int32(emit), jnp.int32(radius), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)
    assert int(tfilters.adaptive_radius(torch.from_numpy(path), _i(n_path),
                                        15)) == \
        int(jfilters.adaptive_radius(jnp.asarray(path), jnp.int32(n_path),
                                     15))


def test_ring_push_get():
    ring = torch.zeros((RING, 3))
    for n in (0, 5, 127, 128, 300):
        ring = tfilters.ring_push(ring, _i(n), torch.full((3,), float(n)))
        assert float(tfilters.ring_get(ring, _i(n))[0]) == n
    got = tfilters.ring_get(ring, torch.tensor([300, 127, 5]))
    assert got[:, 0].tolist() == [300.0, 127.0, 5.0]


@pytest.mark.parametrize("kind", ["pan", "shake", "follow", "random"])
@pytest.mark.parametrize("frame_index,n", [(0, 40), (20, 40), (60, 100),
                                           (10, 14)])
def test_motion_intent(kind, frame_index, n):
    ring = _ring(kind, seed=frame_index)
    motion = ring[frame_index % RING]
    got = tintent.analyze_motion_intent(torch.from_numpy(ring), _i(n),
                                        torch.from_numpy(motion),
                                        _i(frame_index))
    want = jintent.analyze_motion_intent(jnp.asarray(ring), jnp.int32(n),
                                         jnp.asarray(motion),
                                         jnp.int32(frame_index))
    assert int(got) == int(want)
    scale = tintent.intent_correction_scale(got, torch.from_numpy(motion),
                                            _i(frame_index))
    jscale = jintent.intent_correction_scale(want, jnp.asarray(motion),
                                             jnp.int32(frame_index))
    assert float(scale) == float(jscale)


def test_motion_intent_classes_are_reached():
    codes = set()
    for kind in ("pan", "shake", "follow", "random"):
        ring = _ring(kind, seed=20)
        codes.add(int(tintent.analyze_motion_intent(
            torch.from_numpy(ring), _i(40), torch.from_numpy(ring[20]),
            _i(20))))
    assert len(codes) >= 3, codes


@pytest.mark.parametrize("deg,prev", [(2.0, 0.0), (-3.5, 1.0), (0.0, 0.4),
                                      (12.0, -0.2)])
def test_estimate_roll_angle(deg, prev):
    """Canny + Hough + smoothing on a float frame with a tilted horizon
    (beyond the band at 12 deg, where the angle decays instead)."""
    h, w = 240, 320
    rng = np.random.default_rng(int(abs(deg) * 10))
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    sky = yy < (h / 2.0 + np.tan(np.radians(deg)) * (xx - w / 2.0))
    gray = 60.0 + 120.0 * sky + rng.normal(0, 3.0, (h, w))
    frame = np.repeat(gray[:, :, None], 3, axis=2).astype(np.float32)
    jp = JRollParams(hough_threshold=40)
    got = troll.estimate_roll_angle(
        RollCorrectionParams(hough_threshold=40),
        troll.RollState(torch.tensor(prev, dtype=torch.float32)),
        torch.from_numpy(frame))
    want = jroll.estimate_roll_angle(
        jp, jroll.RollState(jnp.float32(prev)), jnp.asarray(frame))
    assert math.isclose(float(got.smoothed_angle),
                        float(want.smoothed_angle), abs_tol=1e-4)
    if abs(deg) <= 10.0 and deg != 0.0:
        assert float(got.smoothed_angle) != prev
