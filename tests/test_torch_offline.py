"""The port's offline whole-clip stabilization and trajectory box filters
against the JAX package's, on the CPU.

Same numpy inputs through both. Tolerances, each with its reason:

- K5a / K5b plain versions against the JAX Pallas kernels run in
  interpret mode: bit for bit (the same summation and normalization
  order); the JAX XLA fallback of the box smoother (``use_pallas=False``)
  against the port's one path, K5b: 1e-5 (XLA sums the window in another
  order).
- ``_smooth_path`` with the gaussian, kalman and butterworth smoothers:
  1e-5 of the path's largest entry (the same float32 expressions, summed
  in another order); with l1: 1e-3 px and 1e-5 rad (60 x 25 iterations,
  see test_torch_smoothers.py).
- ``stabilize_clip`` with the JAX package's draws injected: emitted u8
  frames within 1 on >= 99.5 % of pixels (the warps are exact; the
  corrections agree to float32 rounding, which moves a .5 tie).

The JAX package's offline kalman and butterworth smoothers hard-code 3
channels, so they cannot run the 9-channel log-homography path: those
comparisons are skipped with that reason, and the port's own 9-channel
runs are held to the streaming filters instead.
"""

import cv2
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_homography import perspective_clip  # noqa: E402
from test_torch_stabilizer import JaxDraws, _close_frames  # noqa: E402
from video_stab_tpu import offline as joffline  # noqa: E402
from video_stab_tpu.core.params import StabilizerParams as JParams  # noqa: E402
from video_stab_tpu.pallas import traj as jtraj  # noqa: E402
from video_stab_tpu_torch import offline as toffline  # noqa: E402
from video_stab_tpu_torch.core.params import ModeParams, StabilizerParams  # noqa: E402
from video_stab_tpu_torch.kernels import traj as ktraj  # noqa: E402

CPU = ModeParams(use_cuda=False)
SMALL = dict(smoothing_radius=5, analysis_width=64, analysis_height=48,
             max_corners=32, ransac_hypotheses=32)


def _path(n, c, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n,) if c is None else (n, c)
    return np.cumsum(rng.normal(0, 1, shape), axis=0).astype(np.float32)


# --- K5a / K5b ---------------------------------------------------------------

@pytest.mark.parametrize("c", [None, 3, 9])
@pytest.mark.parametrize("n,r", [(240, 15), (37, 5), (6, 8), (8, 8), (1, 2)])
def test_box_filter_centered_plain_matches_jax(n, r, c):
    """n <= r is the identity."""
    p = _path(n, c, seed=n + r)
    want = np.asarray(jtraj.box_filter_centered(jnp.asarray(p), r,
                                                interpret=True))
    got = ktraj.box_filter_centered(torch.from_numpy(p), r).numpy()
    assert got.shape == want.shape == p.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c", [None, 3, 9])
@pytest.mark.parametrize("n,r", [(240, 8), (37, 5), (5, 8), (3, 1)])
def test_box_filter_convolve_plain_matches_jax(n, r, c):
    p = _path(n, c, seed=n * r)
    want = np.asarray(jtraj.box_filter_convolve(jnp.asarray(p), r,
                                                interpret=True))
    got = ktraj.box_filter_convolve(torch.from_numpy(p), r).numpy()
    assert got.shape == want.shape == p.shape
    np.testing.assert_array_equal(got, want)
    ref = np.asarray(jtraj.box_filter_convolve_reference(jnp.asarray(p), r))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_box_filters_r_zero_is_identity():
    p = torch.from_numpy(_path(10, 3))
    assert ktraj.box_filter_centered(p, 0) is p
    assert ktraj.box_filter_convolve(p, 0) is p


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("n,radius", [(40, 6), (3, 6), (120, 80)])
def test_smooth_path_matches_jax(use_pallas, n, radius):
    """radius 80 is clipped to 50, as in the JAX package. The port smooths
    through K5b whatever ``use_pallas`` says; the JAX package's XLA branch
    (``use_pallas=False``) agrees with it to 1e-5."""
    p = _path(n, 3, seed=n)
    jp = JParams(smoothing_radius=radius, use_pallas=use_pallas)
    tp = StabilizerParams(smoothing_radius=radius, use_pallas=use_pallas)
    want = np.asarray(joffline._smooth_path(jp, jnp.asarray(p)))
    got = toffline._smooth_path(tp, torch.from_numpy(p)).numpy()
    if use_pallas:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


# --- stabilize_clip ----------------------------------------------------------

def _clip(n=16, seed=0):
    rng = np.random.default_rng(seed)
    world = cv2.GaussianBlur(rng.random((180, 240)).astype(np.float32),
                             (0, 0), 2) * 255
    frames = []
    for _ in range(n):
        dx, dy = rng.normal(0, 2, 2)
        m = np.float32([[1, 0, -(40 + dx)], [0, 1, -(40 + dy)]])
        f = cv2.warpAffine(world, m, (128, 96))
        frames.append(np.repeat(f[:, :, None], 3, 2).astype(np.uint8))
    return np.stack(frames)


def _check_clip(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    for a, b in zip(got, want):
        assert _close_frames(a, b) >= 0.995


@pytest.mark.parametrize("kw", [
    {},
    {"border_size": 8},
    {"border_size": 8, "crop_n_zoom": True},
    {"horizon_lock": True, "full_res_corrections": False,
     "redetect_interval": 3},
])
def test_stabilize_clip_similarity_matches_jax(kw):
    clip = _clip()
    jp = JParams(**SMALL, **kw)
    want = joffline.stabilize_clip(clip, jp)
    got = toffline.stabilize_clip(
        clip, StabilizerParams(**SMALL, **kw), mode=CPU,
        ransac_draws=JaxDraws(jax.random.PRNGKey(jp.seed),
                              jp.ransac_hypotheses))
    _check_clip(got, want)


def test_stabilize_clip_homography_matches_jax():
    clip = np.stack(perspective_clip(n=12))
    kw = dict(SMALL, motion_model="homography")
    jp = JParams(**kw)
    want = joffline.stabilize_clip(clip, jp)
    stages = {}
    got = toffline.stabilize_clip_device(
        clip, StabilizerParams(**kw), device="cpu",
        ransac_draws=JaxDraws(jax.random.PRNGKey(jp.seed),
                              jp.ransac_hypotheses, width=4),
        stage_ms=stages)
    _check_clip(got.numpy(), want)
    assert sorted(stages) == ["analyze", "smooth", "warp"]
    assert all(v >= 0.0 for v in stages.values())


def test_analyze_clip_homography_matches_jax():
    """The (T, 3, 3) forward log-homographies (last = 0), within 1e-4
    relative to the largest entry (float32 refit, see
    test_torch_homography)."""
    clip = np.stack(perspective_clip(n=8))
    kw = dict(SMALL, motion_model="homography")
    jp = JParams(**kw)
    want = np.asarray(joffline._analyze_clip_homography(
        jp, jnp.asarray(clip), jax.random.PRNGKey(jp.seed)))
    got = toffline._analyze_clip_homography(
        StabilizerParams(**kw), torch.from_numpy(clip),
        JaxDraws(jax.random.PRNGKey(jp.seed), jp.ransac_hypotheses,
                 width=4)).numpy()
    assert got.shape == want.shape == (8, 3, 3)
    assert not got[-1].any()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_stabilize_clip_own_generator_reduces_jitter():
    """Without injected draws the port draws from its own generator; the
    result still stabilizes."""
    clip = _clip(n=14, seed=3)

    def jitter(frames):
        return float(np.mean([np.abs(a[8:-8, 8:-8].astype(np.float32)
                                     - b[8:-8, 8:-8]).mean()
                              for a, b in zip(frames[:-1], frames[1:])]))

    out = toffline.stabilize_clip(clip, StabilizerParams(**SMALL), mode=CPU)
    assert out.shape == clip.shape
    assert jitter(out) < jitter(clip) * 0.5


REFERENCE_3_CHANNELS = ("the JAX package's offline kalman and butterworth "
                        "smoothers hard-code 3 channels "
                        "(video_stab_tpu/offline.py:134, 143-144), so its "
                        "9-channel log-homography path fails there")


@pytest.mark.parametrize("method", ["gaussian", "l1", "kalman",
                                    "butterworth"])
def test_unported_offline_smoothers_raise(method):
    """The offline smoothers that once raised (hence the name) now run:
    ``stabilize_clip`` of both packages on the same clip."""
    clip = _clip()
    kw = dict(SMALL, smoothing_method=method, jitter_frequency="low")
    jp = JParams(**kw)
    want = joffline.stabilize_clip(clip, jp)
    got = toffline.stabilize_clip(
        clip, StabilizerParams(**kw), mode=CPU,
        ransac_draws=JaxDraws(jax.random.PRNGKey(jp.seed),
                              jp.ransac_hypotheses))
    _check_clip(got, want)
    assert np.abs(got.astype(int) - clip.astype(int)).max() > 0


@pytest.mark.parametrize("c", [3, 9])
@pytest.mark.parametrize("method", ["gaussian", "l1", "kalman",
                                    "butterworth"])
def test_smooth_path_smoothers_match_jax(method, c):
    p = _path(60, c, seed=c)
    if c == 3:
        p[:, 2] *= 0.01
    kw = dict(smoothing_method=method, gaussian_sigma=2.5, border_size=12)
    if c == 9 and method == "l1":
        # The (px, px, rad) crop bound is 3 wide: neither package defines
        # the l1 smoother for the 9-channel path.
        with pytest.raises((TypeError, ValueError)):
            joffline._smooth_path(JParams(**kw), jnp.asarray(p))
        with pytest.raises(ValueError, match="3-channel"):
            toffline._smooth_path(StabilizerParams(**kw), torch.from_numpy(p))
        return
    got = toffline._smooth_path(StabilizerParams(**kw),
                                torch.from_numpy(p)).numpy()
    assert got.shape == p.shape and np.isfinite(got).all()
    if c == 9 and method in ("kalman", "butterworth"):
        with pytest.raises((TypeError, ValueError)):
            joffline._smooth_path(JParams(**kw), jnp.asarray(p))
        pytest.skip(REFERENCE_3_CHANNELS)
    want = np.asarray(joffline._smooth_path(JParams(**kw), jnp.asarray(p)))
    if method == "l1":
        assert (np.abs(got - want) <= [1e-3, 1e-3, 1e-5]).all()
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("method", ["kalman", "butterworth"])
def test_smooth_path_nine_channels_is_the_streaming_filter(method):
    """The case the reference cannot run: the 9-channel path through the
    channel-generic start states equals the streaming filter of
    ``motion/filters.py`` stepped over the same path, and its first three
    channels equal the 3-channel run."""
    from video_stab_tpu_torch.motion import filters as tfilters
    p = torch.from_numpy(_path(40, 9, seed=4))
    params = StabilizerParams(smoothing_method=method)
    got = toffline._smooth_path(params, p)
    assert got.shape == (40, 9)
    if method == "kalman":
        st = tfilters.kalman_init(p[0])
        assert st["x"].shape == (2, 9) and st["p"].shape == (2, 2, 9)
        want = [p[0]]
        for z in p[1:]:
            st, out = tfilters.kalman_step(st, z)
            want.append(out)
    else:
        st = p[0].expand(4, -1)
        cutoff = tfilters.jitter_frequency_cutoff(params.jitter_frequency)
        want = [p[0]]
        for z in p[1:]:
            st, out = tfilters.butterworth_cascade(st, z, cutoff, 4)
            want.append(out)
    assert torch.equal(got, torch.stack(want))
    assert torch.equal(got[:, :3],
                       toffline._smooth_path(params, p[:, :3].contiguous()))


@pytest.mark.parametrize("method", ["gaussian", "kalman", "butterworth"])
def test_stabilize_clip_homography_smoothers(method):
    """The homography clip reaches every smoother through
    ``smooth_homography_path``; the gaussian one is held to the JAX
    package, the other two (which the reference cannot run) to running and
    changing the clip."""
    clip = np.stack(perspective_clip(n=10))
    kw = dict(SMALL, motion_model="homography", smoothing_method=method)
    jp = JParams(**kw)
    got = toffline.stabilize_clip(
        clip, StabilizerParams(**kw), mode=CPU,
        ransac_draws=JaxDraws(jax.random.PRNGKey(jp.seed),
                              jp.ransac_hypotheses, width=4))
    assert got.shape == clip.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - clip.astype(int)).max() > 0
    if method != "gaussian":
        with pytest.raises((TypeError, ValueError)):
            joffline.stabilize_clip(clip, jp)
        pytest.skip(REFERENCE_3_CHANNELS)
    _check_clip(got, joffline.stabilize_clip(clip, jp))


def test_offline_refuses_only_unknown_methods_and_models():
    with pytest.raises(NotImplementedError, match="smoothing_method"):
        toffline.stabilize_clip(_clip(n=2), StabilizerParams(
            smoothing_method="median", **SMALL), mode=CPU)
    with pytest.raises(NotImplementedError, match="motion_model"):
        toffline.stabilize_clip(_clip(n=2), StabilizerParams(
            motion_model="affine", **SMALL), mode=CPU)


@pytest.mark.parametrize("model", ["similarity", "homography"])
def test_stabilize_clip_single_frame_is_identity(model):
    """One frame has no motion: the JAX package returns it unchanged (its
    scan is empty), and so does the port."""
    clip = _clip(n=1)
    p = StabilizerParams(**SMALL, motion_model=model)
    out = toffline.stabilize_clip(clip, p, mode=CPU)
    np.testing.assert_array_equal(out, clip)
    np.testing.assert_array_equal(
        joffline.stabilize_clip(clip, JParams(**SMALL, motion_model=model)),
        clip)
