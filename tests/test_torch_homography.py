"""The port's homography model against the JAX package's, on the CPU.

Same numpy inputs through both. Tolerances, each with its reason:

- K2's plain version against the JAX gather ``warp_perspective``: when fed
  the JAX package's own inverse, identical; with its own adjugate inverse,
  the band of tests/test_pallas.py (0 difference away from a 5e-3 band
  around .5 ties, <= 1 everywhere, < 1 % of pixels differing): the two
  inverses differ in the last bits, which moves a sample by ~255 * 1e-6.
- RANSAC with the JAX draws injected: the same inlier set; H within 1e-4 of
  the JAX H relative to its largest entry (float32 sums in another order
  in the 9x9 normal matrix, whose smallest eigenvector the refit takes).
- log / exp / the smoothed path: 1e-5 (float32; ``matrix_exp`` is another
  expm algorithm than jax.scipy's Pade).
- the refit's eigenvector (float32 ``eigh``) against a float64 numpy
  ``eigh``: 1e-5 up to sign.
- The streaming Stabilizer (JAX draws injected): log-homography rings
  within 1e-4 relative to the ring's largest entry; emitted u8 frames
  within 1 on >= 99.5 % of pixels.
- ``adaptive_radius`` on a 9-channel ring: the same radius.
"""

import math

import cv2
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_stabilizer import JaxDraws, _close_frames, _run  # noqa: E402
from video_stab_tpu.core.params import StabilizerParams as JParams  # noqa: E402
from video_stab_tpu.core.stabilizer import Stabilizer as JStabilizer  # noqa: E402
from video_stab_tpu.motion import filters as jfilters  # noqa: E402
from video_stab_tpu.motion import homography as jhom  # noqa: E402
from video_stab_tpu.ops.warp import warp_perspective as jwarp_perspective  # noqa: E402
from video_stab_tpu_torch.core.params import ModeParams, StabilizerParams  # noqa: E402
from video_stab_tpu_torch.core.stabilizer import Stabilizer  # noqa: E402
from video_stab_tpu_torch.core.state import StabilizerState, state_to_numpy  # noqa: E402
from video_stab_tpu_torch.kernels import warp as kwarp  # noqa: E402
from video_stab_tpu_torch.motion import filters as tfilters  # noqa: E402
from video_stab_tpu_torch.motion import homography as thom  # noqa: E402
from video_stab_tpu_torch.ops import warp as twarp  # noqa: E402

CPU = ModeParams(use_cuda=False)
HOMOG = dict(smoothing_radius=5, analysis_width=64, analysis_height=48,
             max_corners=32, ransac_hypotheses=32,
             motion_model="homography")


def perspective_clip(n=14, seed=5, h=96, w=128):
    """A textured world seen through a window with translation and small
    perspective jitter per frame."""
    rng = np.random.default_rng(seed)
    world = cv2.GaussianBlur(rng.random((h + 100, w + 130)).astype(
        np.float32), (0, 0), 2)
    world = (world - world.min()) / (world.max() - world.min()) * 255.0
    frames = []
    for _ in range(n):
        dx, dy = rng.normal(0, 2, 2)
        p1, p2 = rng.normal(0, 2e-4, 2)
        hf = np.float32([[1, 0, -(40 + dx)], [0, 1, -(40 + dy)],
                         [p1, p2, 1.0]])
        f = cv2.warpPerspective(world, hf, (w, h))
        frames.append(np.repeat(f[:, :, None], 3, 2).astype(np.uint8))
    return frames


# --- adaptive_radius on the 9-channel ring ---------------------------------

def test_adaptive_radius_homography_channel_mapping():
    """The 9-channel log-homography ring maps translation from l02/l12 and
    rotation from (l01 - l10)/2 (JAX motion/filters.py:161-171): the same
    radius as the JAX function, and as the equivalent 3-channel ring."""
    rng = np.random.default_rng(11)
    ring3 = np.zeros((128, 3), np.float32)
    ring9 = np.zeros((128, 9), np.float32)
    n = 20
    ring3[:n] = rng.normal(0, 1, (n, 3)) * [3.0, 3.0, 0.01]
    ring9[:n, 2], ring9[:n, 5] = ring3[:n, 0], ring3[:n, 1]
    ring9[:n, 1], ring9[:n, 3] = -ring3[:n, 2], ring3[:n, 2]
    ring9[:n, [0, 4, 6, 7, 8]] = rng.normal(0, 1e-3, (n, 5))
    got = int(tfilters.adaptive_radius(torch.from_numpy(ring9),
                                       torch.tensor(n, dtype=torch.int32), 10))
    want = int(jfilters.adaptive_radius(jnp.asarray(ring9), jnp.int32(n), 10))
    same3 = int(tfilters.adaptive_radius(torch.from_numpy(ring3),
                                         torch.tensor(n, dtype=torch.int32),
                                         10))
    assert got == want == same3
    assert got < 25       # not pinned at the band max by x-translation


@pytest.mark.parametrize("n", [5, 15, 40])
def test_adaptive_radius_9ch_matches_jax(n):
    rng = np.random.default_rng(n)
    ring = np.cumsum(rng.normal(0, 1, (128, 9)) * [1e-3, 5e-3, 2.0, 5e-3,
                                                   1e-3, 2.0, 1e-6, 1e-6,
                                                   1e-3], axis=0)
    ring = ring.astype(np.float32)
    got = tfilters.adaptive_radius(torch.from_numpy(ring),
                                   torch.tensor(n, dtype=torch.int32), 15)
    want = jfilters.adaptive_radius(jnp.asarray(ring), jnp.int32(n), 15)
    assert int(got) == int(want)


# --- K2's plain version against the JAX warp_perspective -------------------

def _rot_h(deg, tx, ty, g, h):
    a = np.radians(deg)
    return np.float32([[np.cos(a), -np.sin(a), tx],
                       [np.sin(a), np.cos(a), ty], [g, h, 1.0]])


@pytest.mark.parametrize("hm,seed", [
    (_rot_h(0.4, 2.1, -1.3, 3e-5, -2e-5), 6),
    (_rot_h(4.0, 3.0, 2.0, 6e-5, 4e-5), 9),
    (np.float32([[1.02, 0.01, 2.0], [0.005, 0.99, -1.5], [1e-4, -5e-5, 1.0]]),
     3),
])
def test_warp_homography_plain_matches_jax(hm, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (40, 140, 3), dtype=np.uint8)
    ref = np.asarray(jwarp_perspective(jnp.asarray(img, jnp.float32),
                                       jnp.asarray(hm)))
    ref_u8 = np.clip(np.round(ref), 0, 255).astype(np.int64)
    out = kwarp.warp_homography_u8(torch.from_numpy(img),
                                   torch.from_numpy(hm)).numpy()
    d = np.abs(out.astype(np.int64) - ref_u8)
    near_tie = np.abs(ref - np.floor(ref) - 0.5) < 5e-3
    assert d[~near_tie].max() == 0, d[~near_tie].max()
    assert d.max() <= 1
    assert (d > 0).mean() < 0.01
    # Fed the JAX package's own inverse, the plain version is exact.
    hinv = np.array(jnp.linalg.inv(jnp.asarray(hm)))
    same = kwarp.warp_homography_u8(torch.from_numpy(img),
                                    torch.from_numpy(hinv), inverse_map=True)
    np.testing.assert_array_equal(same.numpy().astype(np.int64), ref_u8)


@pytest.mark.parametrize("mode", range(5))
def test_warp_perspective_border_modes_match_jax(mode):
    """Float warp_perspective in every border mode, gray image, with the
    JAX inverse: the same float32 samples."""
    rng = np.random.default_rng(mode)
    img = rng.random((33, 47)).astype(np.float32) * 255.0
    hm = _rot_h(5.0, 7.5, -4.0, 4e-4, -3e-4)
    hinv = np.array(jnp.linalg.inv(jnp.asarray(hm)))
    want = np.asarray(jwarp_perspective(jnp.asarray(img), jnp.asarray(hinv),
                                        30, 50, mode, 7.0, inverse_map=True))
    got = twarp.warp_perspective(torch.from_numpy(img), torch.from_numpy(hinv),
                                 30, 50, mode, 7.0, inverse_map=True).numpy()
    np.testing.assert_array_equal(got, want)


def test_warp_homography_identity_exact():
    rng = np.random.default_rng(2)
    img = torch.from_numpy(rng.integers(0, 255, (24, 132, 3), dtype=np.uint8))
    out = twarp.warp_perspective_fast(img, torch.eye(3))
    assert torch.equal(out, img)


def test_invert_homography_and_det():
    h = torch.from_numpy(_rot_h(3.0, 5.0, -2.0, 1e-4, 2e-4))
    inv = twarp.invert_homography(h)
    np.testing.assert_allclose((inv @ h).numpy(), np.eye(3), atol=1e-6)
    want = np.linalg.det(h.numpy().astype(np.float64))
    np.testing.assert_allclose(float(twarp.det3(h)), want, rtol=1e-6)
    batch = torch.stack([h, 2.0 * h])
    np.testing.assert_allclose(twarp.invert_homography(batch)[1].numpy(),
                               inv.numpy() / 2.0, rtol=1e-6, atol=1e-9)


# --- RANSAC, log / exp, the smoothed path ----------------------------------

def _correspondences(seed, n=48, n_bad=10, scale=(128.0, 96.0)):
    rng = np.random.default_rng(seed)
    hm = _rot_h(rng.normal(0, 0.5), *rng.normal(0, 2, 2),
                *rng.normal(0, 2e-4, 2))
    prev = (rng.random((n, 2)) * scale).astype(np.float32)
    d = hm[2, 0] * prev[:, 0] + hm[2, 1] * prev[:, 1] + hm[2, 2]
    curr = np.stack([(hm[0, 0] * prev[:, 0] + hm[0, 1] * prev[:, 1]
                      + hm[0, 2]) / d,
                     (hm[1, 0] * prev[:, 0] + hm[1, 1] * prev[:, 1]
                      + hm[1, 2]) / d], 1).astype(np.float32)
    curr += rng.normal(0, 0.3, curr.shape).astype(np.float32)
    bad = rng.choice(n, n_bad, replace=False)
    curr[bad] += rng.normal(0, 20, (n_bad, 2)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[rng.choice(n, 4, replace=False)] = False
    return prev, curr, mask


@pytest.mark.parametrize("seed,n_valid_cut", [(0, 0), (1, 0), (2, 0),
                                              (3, 42)])
def test_estimate_homography_ransac_matches_jax(seed, n_valid_cut):
    """n_valid_cut > 0 leaves 6 valid points: under 8, the identity."""
    prev, curr, mask = _correspondences(seed)
    if n_valid_cut:
        mask[:n_valid_cut] = False
    k = 64
    key = jax.random.PRNGKey(seed)
    hj, okj, inlj = jhom.estimate_homography_ransac(
        jnp.asarray(prev), jnp.asarray(curr), jnp.asarray(mask), key,
        n_hypotheses=k)
    draws = jax.random.randint(key, (k, 4), 0, max(int(mask.sum()), 1))
    ht, okt, inlt = thom.estimate_homography_ransac(
        torch.from_numpy(prev), torch.from_numpy(curr),
        torch.from_numpy(mask), n_hypotheses=k,
        draws=torch.from_numpy(np.array(draws, np.int64)))
    assert bool(okt) == bool(okj) == (not n_valid_cut)
    np.testing.assert_array_equal(inlt.numpy(), np.asarray(inlj))
    hj = np.asarray(hj)
    assert np.abs(ht.numpy() - hj).max() <= 1e-4 * np.abs(hj).max()


def test_estimate_homography_ransac_own_generator():
    """Without injected draws the port draws (K, 4) from its generator and
    still recovers the clean points."""
    prev, curr, mask = _correspondences(7, n_bad=8)
    g = torch.Generator().manual_seed(0)
    h, ok, inl = thom.estimate_homography_ransac(
        torch.from_numpy(prev), torch.from_numpy(curr),
        torch.from_numpy(mask), generator=g, n_hypotheses=128)
    assert bool(ok) and int(inl.sum()) >= int(mask.sum()) - 8 - 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_log_exp_homography_match_jax(seed):
    rng = np.random.default_rng(seed)
    hm = _rot_h(rng.normal(0, 1), *rng.normal(0, 5, 2),
                *rng.normal(0, 1e-4, 2))
    hm[:2, :2] *= np.float32(1.0 + rng.normal(0, 0.01))
    lj = np.asarray(jhom.log_homography(jnp.asarray(hm)))
    lt = thom.log_homography(torch.from_numpy(hm)).numpy()
    np.testing.assert_allclose(lt, lj, atol=1e-5, rtol=0)
    ej = np.asarray(jhom.exp_homography(jnp.asarray(lj)))
    et = thom.exp_homography(torch.from_numpy(lj)).numpy()
    np.testing.assert_allclose(et, ej, atol=1e-5 * np.abs(ej).max(), rtol=0)
    # Round trip: exp(log H) is H scaled to det 1.
    hn = hm / np.cbrt(np.linalg.det(hm.astype(np.float64)))
    np.testing.assert_allclose(et, hn, atol=1e-5 * np.abs(hn).max())


def test_smooth_homography_path_matches_jax():
    from video_stab_tpu.pallas.traj import box_filter_centered as jbox
    from video_stab_tpu_torch.kernels.traj import box_filter_centered
    rng = np.random.default_rng(4)
    logs = (rng.normal(0, 1, (30, 3, 3)) * [[1e-3, 5e-3, 2.0],
                                            [5e-3, 1e-3, 2.0],
                                            [1e-6, 1e-6, 1e-3]])
    logs = logs.astype(np.float32)
    want = np.asarray(jhom.smooth_homography_path(
        jnp.asarray(logs), lambda p: jbox(p, 5, interpret=True)))
    got = thom.smooth_homography_path(
        torch.from_numpy(logs), lambda p: box_filter_centered(p, 5)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)


# --- the streaming homography Stabilizer -----------------------------------

@pytest.fixture(scope="module")
def jax_homography_run():
    frames = perspective_clip()
    jp = JParams(**HOMOG)
    js = JStabilizer(jp)
    j_out, j_tr, j_fl = _run(js, frames)
    return frames, jp, j_out, j_tr, j_fl, js.state_dict()


def test_homography_stabilizer_matches_jax(jax_homography_run):
    frames, jp, j_out, j_tr, j_fl, j_state = jax_homography_run
    port = Stabilizer(StabilizerParams(**HOMOG), mode=CPU,
                      ransac_draws=JaxDraws(jax.random.PRNGKey(jp.seed),
                                            jp.ransac_hypotheses, width=4))
    t_out, t_tr, t_fl = _run(port, frames)
    assert [o is None for o in t_out] == [o is None for o in j_out]
    for a, b in zip(t_tr, j_tr):
        if b is not None:
            assert a.shape == (9,)
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-4 * max(1.0, np.abs(b).max()))
    t_state = state_to_numpy(port._state)
    for name in ("trans_ring", "path_ring"):
        want = np.asarray(getattr(j_state, name))
        assert t_state[name].shape == want.shape == (128, 9)
        np.testing.assert_allclose(t_state[name], want, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(want).max()))
    assert int(t_state["envelope_exceeded"]) == \
        int(np.asarray(j_state.envelope_exceeded))
    assert len(t_fl) == len(j_fl) == jp.effective_radius - 1
    for a, b in zip([o for o in t_out if o is not None] + t_fl,
                    [o for o in j_out if o is not None] + j_fl):
        assert a.shape == b.shape and a.dtype == np.uint8
        assert _close_frames(a, b) >= 0.995


def test_homography_state_from_jax_continues_like_jax():
    """Start the port from the JAX homography stabilizer's mid-stream
    state (9-channel rings) and compare the next 4 steps."""
    frames = perspective_clip(n=12)
    jp = JParams(**HOMOG)
    js = JStabilizer(jp)
    for f in frames[:8]:
        js.stabilize(f)
    np_state = js.state_dict()
    port = Stabilizer(StabilizerParams(**HOMOG), mode=CPU,
                      ransac_draws=JaxDraws(np_state.key,
                                            jp.ransac_hypotheses, width=4))
    h, w = frames[0].shape[:2]
    port.load_state_dict(np_state, h, w)
    for name in StabilizerState._fields:
        if name not in ("key", "hf", "deepstab"):
            np.testing.assert_array_equal(
                state_to_numpy(port._state)[name],
                np.asarray(getattr(np_state, name)), err_msg=name)
    for f in frames[8:12]:
        a, b = port.stabilize(f), js.stabilize(f)
        assert (a is None) == (b is None)
        tb = np.asarray(js.last_metrics["transform"])
        np.testing.assert_allclose(np.asarray(port.last_metrics["transform"]),
                                   tb, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(tb).max()))
        if a is not None:
            assert _close_frames(a, b) >= 0.995


def test_homography_steady_state_reads_nothing(monkeypatch):
    """The homography step converts no device scalar on the host in its
    Python code; the only device reads are inside ``eigh`` and
    ``matrix_exp`` on a CUDA tensor, which chip_smoke.py counts."""
    frames = perspective_clip(n=8)
    port = Stabilizer(StabilizerParams(**HOMOG, redetect_interval=1000),
                      mode=CPU)
    for f in frames[:3]:
        port.stabilize_device(f)
    calls = []
    for meth in ("item", "__bool__", "__int__", "__float__"):
        orig = getattr(torch.Tensor, meth)

        def spy(self, *a, _orig=orig, _m=meth, **k):
            calls.append(_m)
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, meth, spy)
    for f in frames[3:8]:
        port.stabilize_device(f)
    monkeypatch.undo()
    assert calls == [], calls


def test_smallest_eigenvector_matches_eigh():
    """The refit's float32 eigenvector against a float64 numpy eigh on
    weighted DLT-like normal matrices: the same unit vector up to sign,
    within 1e-5."""
    rng = np.random.default_rng(3)
    for _ in range(20):
        n = int(rng.integers(8, 60))
        h = rng.normal(0, 1, 9)
        h /= np.linalg.norm(h)
        a = rng.normal(0, 1, (2 * n, 9))
        a = a - np.outer(a @ h, h) + rng.normal(0, 10 ** rng.uniform(-4, -1),
                                                (2 * n, 9))
        m32 = (a.T @ a).astype(np.float32)
        want = np.linalg.eigh(m32.astype(np.float64))[1][:, 0]
        got = thom._smallest_eigenvector(torch.from_numpy(m32)).numpy()
        err = min(np.abs(got - want).max(), np.abs(got + want).max())
        assert err <= 1e-5, err


def test_full_resolution_conjugation_matches_matmul():
    from video_stab_tpu_torch.core.stabilizer import to_full_resolution
    p = StabilizerParams(**HOMOG)
    h = torch.from_numpy(_rot_h(1.0, 2.0, -3.0, 1e-4, -2e-4))
    sx, sy = 1920 / 64, 1080 / 48
    s = torch.diag(torch.tensor([sx, sy, 1.0]))
    s_inv = torch.diag(torch.tensor([1.0 / sx, 1.0 / sy, 1.0]))
    assert torch.equal(to_full_resolution(p, (1080, 1920, 3), h),
                       s @ h @ s_inv)
    assert math.isclose(float(to_full_resolution(p, (96, 128, 3), h)[0, 2]),
                        2.0 * 2.0, rel_tol=1e-6)


@pytest.mark.parametrize("shift", [0.0, 1e-3, 0.7, 30.0, 250.0])
def test_expm_matches_jax_expm(shift):
    """exp_homography (``torch.linalg.matrix_exp``) against
    jax.scipy.linalg.expm, batched, on sl(3)-like logs: rotation/scale
    ~1e-2, perspective ~1e-5, translation from 0 to a few hundred px
    (full-resolution logs). Tolerance, relative to the result's largest
    entry: 1e-5, or 2^s * 2.4e-7 with s squarings of the JAX algorithm
    when that is larger (float32 rounding doubles with each squaring; the
    JAX result is that far from a float64 expm at s = 7)."""
    import jax.scipy.linalg as jsl
    rng = np.random.default_rng(int(shift * 10))
    a = (rng.normal(0, 1, (4, 3, 3)) * [[1e-2, 1e-2, shift],
                                        [1e-2, 1e-2, shift],
                                        [1e-5, 1e-5, 1e-2]])
    a = a.astype(np.float32)
    got = thom.exp_homography(torch.from_numpy(a)).numpy()
    for g, x in zip(got, a):
        want = np.asarray(jsl.expm(jnp.asarray(x)))
        norm = np.abs(x).sum(axis=0).max()
        s = max(0.0, np.floor(np.log2(norm / 3.925724783138660)))
        tol = max(1e-5, 2.0 ** s * 2.4e-7)
        np.testing.assert_allclose(g, want, rtol=0,
                                   atol=tol * np.abs(want).max())
    np.testing.assert_array_equal(
        thom.exp_homography(torch.zeros(3, 3)).numpy(),
        np.eye(3, dtype=np.float32))
