"""The port's legacy deterministic stabilizer against the JAX package's, on
the CPU.

Held: ``remove_outliers_median`` and ``estimate_rigid_closed_form`` bit for
bit on random masked point sets (odd and even counts, fewer than 3 valid
points, fewer than ``min_keep`` kept, sums above one window of 32 and
above 32 windows), and within 4 ulp at 17 to 32 points, where XLA
vectorizes the last sum; ``LegacyStabilizer`` over a 40-frame clip: the same
warm-up, per-frame transforms within 1e-4 px and 1e-6 rad, the same
re-detect decisions, emitted frames within 1 level; and its accumulated
path against the cv2 oracle of ``tests/test_legacy_parity.py`` at that
test's tolerances.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from test_legacy_parity import CV2LegacyOracle, make_clip  # noqa: E402
from video_stab_tpu import LegacyStabilizer as JLegacy  # noqa: E402
from video_stab_tpu import LegacyStabilizerParams as JLegacyParams  # noqa: E402
from video_stab_tpu.motion import estimate as jest  # noqa: E402
from video_stab_tpu_torch.core import legacy as tlegacy  # noqa: E402
from video_stab_tpu_torch.core.params import (  # noqa: E402
    LegacyStabilizerParams,
    ModeParams,
)
from video_stab_tpu_torch.motion import estimate as test_  # noqa: E402
from video_stab_tpu_torch.utils import telemetry  # noqa: E402

CPU = ModeParams(use_cuda=False)
STREAM = dict(smoothing_radius=8, max_corners=120, min_distance=8.0,
              min_tracking_features=10)


def _points(n, seed, keep_share):
    rng = np.random.default_rng(seed)
    prev = (rng.random((n, 2)) * 900).astype(np.float32)
    curr = (prev + rng.normal(0, 3, (n, 2))).astype(np.float32)
    curr[rng.random(n) < 0.2] += 40.0        # outliers
    mask = rng.random(n) < keep_share
    return prev, curr, mask


def _solver_pairs(n, seed, keep_share):
    prev, curr, mask = _points(n, seed, keep_share)
    for threshold, min_keep in ((15.0, 10), (2.0, 10), (2.0, 1000)):
        want = np.asarray(jest.remove_outliers_median(
            jnp.asarray(prev), jnp.asarray(curr), jnp.asarray(mask),
            threshold=threshold, min_keep=min_keep))
        got = test_.remove_outliers_median(
            torch.from_numpy(prev), torch.from_numpy(curr),
            torch.from_numpy(mask), threshold=threshold,
            min_keep=min_keep).numpy()
        np.testing.assert_array_equal(got, want)
        t_want = np.asarray(jest.estimate_rigid_closed_form(
            jnp.asarray(prev), jnp.asarray(curr), jnp.asarray(want)))
        t_got = test_.estimate_rigid_closed_form(
            torch.from_numpy(prev), torch.from_numpy(curr),
            torch.from_numpy(want.copy())).numpy()
        yield t_got, t_want


@pytest.mark.parametrize("n,keep_share", [
    (2, 1.0), (5, 0.9), (16, 0.7), (64, 0.5), (120, 0.8), (200, 0.8),
    (201, 0.6), (2048, 0.7), (200, 0.04)])
@pytest.mark.parametrize("seed", [0, 1])
def test_legacy_solver_bit_for_bit(n, keep_share, seed):
    for t_got, t_want in _solver_pairs(n, seed, keep_share):
        np.testing.assert_array_equal(t_got, t_want)


@pytest.mark.parametrize("n", [20, 31])
@pytest.mark.parametrize("seed", [0, 1])
def test_legacy_solver_within_4_ulp_at_17_to_32_points(n, seed):
    """XLA vectorizes a last sum of 17 to 32 values into partial sums
    (``motion/estimate.py``): the mask stays bit for bit, the solve within
    4 ulp."""
    for t_got, t_want in _solver_pairs(n, seed, 0.7):
        np.testing.assert_array_max_ulp(t_got, t_want, maxulp=4)


def test_ordered_sum_is_one_window_below_33():
    x = torch.arange(1, 33, dtype=torch.float32) / 7.0
    acc = x[0]
    for v in x[1:]:
        acc = acc + v
    assert torch.equal(test_.ordered_sum(x), acc)


def _run_legacy(stab, frames):
    outs, transforms, redetects = [], [], []
    for f in frames:
        outs.append(stab.stabilize(f))
        if stab.last_metrics:
            transforms.append(np.asarray(stab.last_metrics["transform"]))
            redetects.append(bool(stab.last_metrics["redetected"]))
    while (o := stab.flush()) is not None:
        outs.append(np.asarray(o))
    return outs, np.array(transforms), redetects


@pytest.mark.parametrize("seed,extra", [
    (3, {}), (11, {"border_size": 6, "border_type": "replicate"}),
    (5, {"crop_n_zoom": True, "redetect_interval": 12})])
def test_legacy_stabilizer_matches_jax(seed, extra):
    frames, _ = make_clip(n=40, seed=seed)
    j = JLegacy(JLegacyParams(**STREAM, **extra))
    t = tlegacy.LegacyStabilizer(LegacyStabilizerParams(**STREAM, **extra),
                                 mode=CPU)
    j_out, j_tr, j_re = _run_legacy(j, frames)
    t_out, t_tr, t_re = _run_legacy(t, frames)
    assert [o is None for o in t_out] == [o is None for o in j_out]
    np.testing.assert_array_equal(t_out[0], frames[0])     # passed through
    np.testing.assert_allclose(t_tr[:, :2], j_tr[:, :2], atol=1e-4, rtol=0)
    np.testing.assert_allclose(t_tr[:, 2], j_tr[:, 2], atol=1e-6, rtol=0)
    assert t_re == j_re and any(t_re)
    pairs = [(a, b) for a, b in zip(t_out, j_out) if b is not None]
    assert len(pairs) == len(frames)
    for a, b in pairs:
        assert a.shape == b.shape and a.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


@pytest.mark.parametrize("seed", [3, 11])
def test_legacy_path_matches_cv2_oracle(seed):
    """test_legacy_parity.py's oracle comparison, for the port."""
    frames, _ = make_clip(seed=seed)
    p = LegacyStabilizerParams(smoothing_radius=8, max_corners=120,
                               min_distance=8.0, min_tracking_features=10)
    ours = tlegacy.LegacyStabilizer(p, mode=CPU)
    oracle = CV2LegacyOracle(p)
    for f in frames:
        ours.stabilize(f)
        oracle.push(f)
    st = ours._state
    ring = st.path_ring.numpy()
    n = int(st.n_path)
    our_path = np.array([ring[i % ring.shape[0]] for i in range(n)])
    ref_path = np.array(oracle.path)
    assert len(our_path) == len(ref_path)
    assert np.abs(our_path[:, :2] - ref_path[:, :2]).max() < 0.5
    assert np.abs(our_path[:, 2] - ref_path[:, 2]).max() < 5e-3
    ref_corr = oracle.corrections()
    r = p.box_radius
    from video_stab_tpu_torch.motion.filters import box_filter_emit
    for e in range(n):
        sm = box_filter_emit(st.path_ring, st.n_path,
                             torch.tensor(e, dtype=torch.int32), r,
                             max(r, 1)).numpy()
        assert np.abs((sm - our_path[e])[:2] - ref_corr[e][:2]).max() < 0.5


def test_legacy_reads_one_flag_per_frame():
    """The re-detect flag is the analyze step's one host read."""
    frames, _ = make_clip(n=6, seed=3)
    t = tlegacy.LegacyStabilizer(LegacyStabilizerParams(**STREAM), mode=CPU)
    before = telemetry.counters().get("legacy_redetect_reads", 0)
    for f in frames:
        t.stabilize(f)
    assert telemetry.counters()["legacy_redetect_reads"] - before == \
        len(frames) - 1
    t.clean()
    assert t._state is None and t.stabilize(frames[0]) is not None
