"""The homography pieces of ``reference/stream_homography.py`` held to
witnesses of their own, not to the port whose output the reference
judges: on seeded point sets on the CPU, the estimate recovers a planted
homography and keeps exactly the points it moves within the threshold,
its refit is the float64 Hartley DLT of its inliers, and the log and exp
maps of sl(3) agree with scipy's ``logm`` and ``expm`` in float64.

    python -m pytest benchmark_torch/tests -q
"""

import numpy as np
import pytest
import scipy.linalg
import torch

from benchmark_torch.harness import HERE, load_module

ref = load_module(HERE / "reference" / "stream_homography.py")
WIDTH, HEIGHT = 320.0, 180.0
THRESHOLD = 5.0
TRUE_H = np.array([[1.01, 0.02, 3.0], [-0.015, 0.99, -2.0],
                   [2e-5, -3e-5, 1.0]])
GRID = np.stack(np.meshgrid(np.linspace(0, WIDTH, 9),
                            np.linspace(0, HEIGHT, 9)), -1).reshape(-1, 2)


def project(h, pts):
    """(3, 3) H applied to (N, 2) points in float64."""
    x = np.c_[pts, np.ones(len(pts))] @ np.asarray(h, np.float64).T
    return x[:, :2] / x[:, 2:]


def point_set(seed, n=64, noise=0.0, outliers=0.2, n_valid=None):
    """Points in a 320 x 180 analysis frame moved by TRUE_H with ``noise``
    px of gaussian noise, a share of them thrown 30 px off, and a mask."""
    rng = np.random.default_rng(seed)
    prev = (rng.random((n, 2)) * [WIDTH, HEIGHT]).astype(np.float32)
    curr = (project(TRUE_H, prev)
            + rng.normal(0.0, noise, (n, 2))).astype(np.float32)
    bad = rng.random(n) < outliers
    curr[bad] += rng.normal(0.0, 30.0, (int(bad.sum()), 2)).astype(
        np.float32)
    mask = rng.random(n) < 0.85
    if n_valid is not None:
        mask[:] = np.arange(n) < n_valid
    return prev, curr, mask


def estimate(prev, curr, mask, seed, k=64):
    """The reference's (H, inliers, ok) on draws from the seed into the
    valid points."""
    draws = np.random.default_rng(seed + 1000).integers(
        0, max(int(mask.sum()), 1), (1, k, 4))
    h, inl, ok = ref.estimate_homography(
        torch.from_numpy(prev)[None], torch.from_numpy(curr)[None],
        torch.from_numpy(mask)[None], torch.from_numpy(draws), THRESHOLD)
    return h[0].numpy().astype(np.float64), inl[0].numpy(), bool(ok[0])


def dlt64(prev, curr):
    """The Hartley-normalized DLT in float64 by SVD, H[2, 2] = 1."""
    def normalizer(p):
        mean = p.mean(0)
        s = np.sqrt(2.0) / np.linalg.norm(p - mean, axis=1).mean()
        return np.array([[s, 0, -s * mean[0]], [0, s, -s * mean[1]],
                         [0, 0, 1.0]])
    p, q = prev.astype(np.float64), curr.astype(np.float64)
    tp, tq = normalizer(p), normalizer(q)
    pn, qn = project(tp, p), project(tq, q)
    rows = []
    for (x, y), (u, v) in zip(pn, qn):
        rows.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        rows.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    hn = np.linalg.svd(np.array(rows))[2][-1].reshape(3, 3)
    h = np.linalg.inv(tq) @ hn @ tp
    return h / h[2, 2]


@pytest.mark.parametrize("seed", range(6))
def test_estimate_recovers_a_planted_homography(seed):
    """Exact correspondences and 20 % thrown 30 px off: a hypothesis
    through four good points is TRUE_H to float32 round-off, so the
    inliers are exactly the valid points TRUE_H moves within the
    threshold, and the refit maps the frame within 1e-3 px of TRUE_H
    (measured <= 1.6e-4 px on seeds 0-5: float32 round-off of the
    normalized system)."""
    prev, curr, mask = point_set(seed)
    h, inl, ok = estimate(prev, curr, mask, seed)
    err2 = ((project(TRUE_H, prev) - curr) ** 2).sum(-1)
    assert ok
    assert (inl == (mask & (err2 < THRESHOLD ** 2))).all()
    assert inl.sum() >= 30
    assert np.abs(project(h, GRID) - project(TRUE_H, GRID)).max() < 1e-3


@pytest.mark.parametrize("seed", range(3))
def test_refit_is_the_float64_dlt_of_its_inliers(seed):
    """0.3 px of noise: the refit is the least-squares DLT of the inlier
    set, which a float64 DLT by SVD of the same points recomputes. The
    reference works in float32; measured <= 7.5e-5 px apart over the
    frame on seeds 0-2, so 1e-3 px. Leaving out any one inlier moves the
    float64 fit by 4.7e-3 to 0.49 px (median 0.035), so this holds the
    weighting, the normalization and the null vector as well as the
    inlier set."""
    prev, curr, mask = point_set(seed, noise=0.3)
    h, inl, ok = estimate(prev, curr, mask, seed)
    assert ok and inl.sum() >= 30
    want = dlt64(prev[inl], curr[inl])
    assert np.abs(project(h, GRID) - project(want, GRID)).max() < 1e-3


def test_estimate_with_few_inliers_fits_its_inliers():
    """12 valid points, 5 of them thrown off: these draws find a
    hypothesis through four of the 7 exact ones, the inliers are those 7
    and the refit passes through them (measured 4.3e-5 px, held to 1e-3).
    The frame's corners, an extrapolation from 7 points, are not held."""
    prev, curr, mask = point_set(102, n=12, outliers=0.5, n_valid=12)
    h, inl, ok = estimate(prev, curr, mask, 102)
    err2 = ((project(TRUE_H, prev) - curr) ** 2).sum(-1)
    assert ok and inl.sum() == 7
    assert (inl == (err2 < THRESHOLD ** 2)).all()
    assert np.abs(project(h, prev[inl]) - curr[inl]).max() < 1e-3


@pytest.mark.parametrize("n_valid", [0, 7])
def test_identity_under_eight_valid_points(n_valid):
    prev, curr, mask = point_set(100, n_valid=n_valid)
    h, inl, ok = estimate(prev, curr, mask, 100)
    assert not ok and not inl.any()
    assert (h == np.eye(3)).all()


@pytest.mark.parametrize("seed", range(4))
def test_log_and_exp_agree_with_scipy_in_float64(seed):
    """A correction of the size the emit sees (translation ~5 px, rotation
    and shear ~1e-2, projective ~1e-5). exp: the reference's scaled
    Taylor series in float32 against scipy's expm in float64, 1e-5 of the
    largest entry (the float32 step is 6e-8 of it; squaring 5 times
    multiplies that ~30 times); measured <= 1.3e-6 of it. log: the
    12-term series of the det-scaled float32 matrix against scipy's logm
    of the same matrix scaled in float64, 2e-6 absolute on entries up to
    ~5 (the float32 step there is 5e-7; measured <= 3.5e-7)."""
    rng = np.random.default_rng(seed)
    size = np.array([[1e-2, 1e-2, 5.0], [1e-2, 1e-2, 5.0],
                     [1e-5, 1e-5, 1e-2]])
    logm = rng.normal(0.0, 1.0, (3, 3)) * size
    logm -= np.eye(3) * np.trace(logm) / 3.0
    want = scipy.linalg.expm(logm)
    got = ref.exp_sl3(torch.from_numpy(logm.astype(np.float32))[None])[0]
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    h = want * 1.3                       # any scale: log takes det 1 first
    back = ref.log_sl3(torch.from_numpy(h.astype(np.float32))[None])[0]
    want_log = scipy.linalg.logm(h / np.cbrt(np.linalg.det(h))).real
    assert np.abs(want_log - logm).max() < 1e-9
    assert np.abs(back.numpy() - want_log).max() < 2e-6
