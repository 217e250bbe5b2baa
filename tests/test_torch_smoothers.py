"""The port's trajectory smoothers, drone high-frequency chain, L1 path
solver and CLAHE against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through both. Tolerances, each
with its reason:

- ``gaussian_kernel``: 1e-7 (float32 ``exp`` of numpy against XLA's).
- the elementwise filters (``gaussian_filter_emit``, ``kalman_step``,
  ``butterworth_cascade``) on paths of magnitude <= 100: 1e-5 absolute
  (the same float32 expressions; a sum's order and fused multiply-adds
  differ).
- ``hf_apply``: equal flags and counters; floats within 1e-6 (each step is
  a handful of float32 operations on values of magnitude <= 10).
- ``l1_smooth_path`` after its 60 x 25 iterations: 1e-3 px and 1e-5 rad
  (measured 2e-5 px: 1500 CG steps of float32 sums taken in another order).
- ``clahe``: within 1 grey level, >= 99.9 % of pixels within 1e-3 (integer
  histograms and LUTs are exact; the bilinear blend is float32).

The streams through both packages' ``Stabilizer`` are in
``test_torch_smoother_streams.py``, the chain's in ``test_torch_chain.py``.
Here also: the gated emit before warm-up holds the smoother cursors, and a
stream resumed from ``state_dict()`` continues its RANSAC draws.
"""

import cv2
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from test_torch_smoother_streams import clip  # noqa: E402
from test_torch_stabilizer import CPU, SMALL, _run  # noqa: E402
from video_stab_tpu.motion import filters as jfilters  # noqa: E402
from video_stab_tpu.motion import hf as jhf  # noqa: E402
from video_stab_tpu.motion import l1path as jl1  # noqa: E402
from video_stab_tpu.ops import filters as jofilters  # noqa: E402
from video_stab_tpu_torch.core.params import StabilizerParams  # noqa: E402
from video_stab_tpu_torch.core.stabilizer import (  # noqa: E402
    Stabilizer,
    stabilizer_analyze_step_fn,
    stabilizer_emit_gated_fn,
    stabilizer_init_step_fn,
)
from video_stab_tpu_torch.core.state import (  # noqa: E402
    stabilizer_state_init,
)
from video_stab_tpu_torch.motion import filters as tfilters  # noqa: E402
from video_stab_tpu_torch.motion import hf as thf  # noqa: E402
from video_stab_tpu_torch.motion import l1path as tl1  # noqa: E402
from video_stab_tpu_torch.ops import filters as tofilters  # noqa: E402

RING = 128


def _path(n, c, seed, scale=1.0):
    """A (n, c) random-walk path of magnitude <= 100."""
    rng = np.random.default_rng(seed)
    p = np.cumsum(rng.normal(0, scale, (n, c)), axis=0)
    return (p * min(1.0, 100.0 / np.abs(p).max())).astype(np.float32)


def _ring(path):
    """The (RING, C) ring holding ``path`` at slots i % RING."""
    ring = np.zeros((RING, path.shape[1]), np.float32)
    for i, v in enumerate(path):
        ring[i % RING] = v
    return ring


def _i32(v):
    return torch.tensor(v, dtype=torch.int32)


# --- motion/filters.py -------------------------------------------------------

@pytest.mark.parametrize("sigma", [0.3, 1.0, 2.0, 3.7])
def test_gaussian_kernel_matches_jax(sigma):
    want = np.asarray(jfilters.gaussian_kernel(sigma))
    got = tfilters.gaussian_kernel(sigma)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    assert tfilters.gaussian_kernel(sigma) is got      # cached per device


@pytest.mark.parametrize("c", [3, 9])
@pytest.mark.parametrize("n,e", [(1, 0), (3, 0), (3, 2), (40, 0), (40, 17),
                                 (40, 39), (150, 120), (150, 149)])
def test_gaussian_filter_emit_matches_jax(n, e, c):
    """Both reflections: on the left near e = 0, on the right near e =
    n - 1; past 128 samples the ring has wrapped."""
    ring = _ring(_path(n, c, seed=n + e))
    want = np.asarray(jfilters.gaussian_filter_emit(
        jnp.asarray(ring), jnp.int32(n), jnp.int32(e),
        jfilters.gaussian_kernel(2.0)))
    got = tfilters.gaussian_filter_emit(
        torch.from_numpy(ring), _i32(n), _i32(e),
        tfilters.gaussian_kernel(2.0))
    assert got.shape == (c,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("c", [3, 9])
def test_kalman_matches_jax(c):
    path = _path(40, c, seed=c)
    jst = jfilters.kalman_init(jnp.asarray(path[0]))
    tst = tfilters.kalman_init(torch.from_numpy(path[0]))
    assert tst["x"].shape == (2, c) and tst["p"].shape == (2, 2, c)
    for z in path[1:]:
        jst, want = jfilters.kalman_step(jst, jnp.asarray(z))
        tst, got = tfilters.kalman_step(tst, torch.from_numpy(z))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
        for k in ("x", "p"):
            np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                       rtol=0, atol=1e-5)


@pytest.mark.parametrize("c", [3, 9])
@pytest.mark.parametrize("name", ["low", "medium", "high", "adaptive",
                                  "unknown"])
def test_butterworth_matches_jax(name, c):
    cutoff = tfilters.jitter_frequency_cutoff(name)
    assert cutoff == jfilters.jitter_frequency_cutoff(name)
    path = _path(40, c, seed=10 + c)
    jst = jnp.broadcast_to(jnp.asarray(path[0]), (4, c))
    tst = torch.from_numpy(path[0]).expand(4, -1)
    for z in path[1:]:
        jst, want = jfilters.butterworth_cascade(jst, jnp.asarray(z),
                                                 cutoff, 4)
        tst, got = tfilters.butterworth_cascade(tst, torch.from_numpy(z),
                                                cutoff, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(tst.numpy(), np.asarray(jst), rtol=0,
                                   atol=1e-5)


# --- motion/hf.py ------------------------------------------------------------

@pytest.mark.parametrize("n", range(0, 11))
def test_median_even_avg_matches_jax(n):
    vals = np.random.default_rng(n).normal(0, 3, thf.HF_HISTORY) \
        .astype(np.float32)
    want = np.asarray(jhf._median_even_avg(jnp.asarray(vals), jnp.int32(n)))
    got = thf._median_even_avg(torch.from_numpy(vals), _i32(n))
    if n == 0:
        assert not np.isfinite(want) and not np.isfinite(got.numpy())
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("horizon_lock", [False, True])
@pytest.mark.parametrize("seed,scale", [(0, 0.8), (1, 2.5), (2, 6.0)])
def test_hf_apply_matches_jax(seed, scale, horizon_lock):
    """80 raw transforms whose size walks in and out of the dead zone
    (threshold 2.0): every state flag and counter equal, floats within
    1e-6."""
    assert thf.HF_HISTORY == jhf.HF_HISTORY
    assert thf.HFState._fields == jhf.HFState._fields
    rng = np.random.default_rng(seed)
    raws = rng.normal(0, scale, (80, 3)).astype(np.float32)
    raws[:, 2] *= 0.02
    raws[20:35] *= 0.1                     # a calm stretch: freeze
    raws[50] *= 8.0                        # a jolt: exit
    kw = dict(dead_zone_threshold=2.0, freeze_duration=10,
              accumulator_decay=0.9, shake_px=1.5, rot_lp_alpha=0.2,
              horizon_lock=horizon_lock)
    jst, tst = jhf.hf_init(), thf.hf_init("cpu")
    frozen = 0
    for raw in raws:
        jst, want = jhf.hf_apply(jst, jnp.asarray(raw), **kw)
        tst, got = thf.hf_apply(tst, torch.from_numpy(raw), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
        for name in thf.HFState._fields:
            a, b = getattr(tst, name).numpy(), np.asarray(getattr(jst, name))
            assert a.dtype == b.dtype and a.shape == b.shape, name
            if a.dtype == np.float32:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6,
                                           err_msg=name)
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)
        frozen += int(tst.in_dead_zone)
    if scale < 3.0:
        assert 0 < frozen < len(raws)      # the dead zone was entered and left


# --- motion/l1path.py --------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_difference_operators_match_jax(n):
    rng = np.random.default_rng(n)
    p = rng.normal(0, 1, (n, 3)).astype(np.float32)
    for k, (td, tdt, jd, jdt) in enumerate([
            (tl1._d1, tl1._d1t, jl1._d1, jl1._d1t),
            (tl1._d2, tl1._d2t, jl1._d2, jl1._d2t),
            (tl1._d3, tl1._d3t, jl1._d3, jl1._d3t)], start=1):
        d = td(torch.from_numpy(p))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd(jnp.asarray(p))),
                                   rtol=0, atol=1e-6)
        z = rng.normal(0, 1, d.shape).astype(np.float32)
        np.testing.assert_allclose(
            tdt(torch.from_numpy(z), n).numpy(),
            np.asarray(jdt(jnp.asarray(z), n)), rtol=0, atol=1e-6)
    x = rng.normal(0, 2, (5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tl1._soft(torch.from_numpy(x), 1.5).numpy(),
        np.asarray(jl1._soft(jnp.asarray(x), 1.5)))


@pytest.mark.parametrize("t,c", [(60, 3), (60, 9), (120, 3), (4, 3)])
def test_l1_smooth_path_matches_jax(t, c):
    """The full 60 x 25 iterations. (T, 3): pixels, pixels, radians with
    the offline bound (20, 20, 0.05); (T, 9): a scalar bound."""
    p = _path(t, c, seed=t + c, scale=2.0)
    if c == 3:
        p[:, 2] *= 0.01
        bound = np.array([20.0, 20.0, 0.05], np.float32)
    else:
        bound = np.float32(20.0)
    want = np.asarray(jl1.l1_smooth_path(jnp.asarray(p), jnp.asarray(bound)))
    got = tl1.l1_smooth_path(torch.from_numpy(p),
                             torch.as_tensor(bound)).numpy()
    assert got.shape == p.shape and np.isfinite(got).all()
    tol = np.array([1e-3, 1e-3, 1e-5], np.float32) if c == 3 else 1e-3
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max(axis=0)
    assert (np.abs(got - p) <= bound + 1e-6).all()       # inside the crop box
    if t >= 60:
        assert np.abs(got - p).max() > 0.5               # and it did smooth


# --- ops/filters.py: clahe ---------------------------------------------------

@pytest.mark.parametrize("shape,clip,grid", [
    ((48, 64), 2.0, 8), ((50, 70), 2.0, 8), ((135, 240), 2.0, 8),
    ((48, 64), 4.0, 4), ((33, 41), 1.0, 8)])
def test_clahe_matches_jax(shape, clip, grid):
    """Sizes that do and do not divide the tile grid (reflect-101 pad)."""
    rng = np.random.default_rng(shape[0])
    img = cv2.GaussianBlur(rng.random(shape).astype(np.float32), (0, 0),
                           1.5)
    img = (img - img.min()) / (img.max() - img.min()) * 200.0 + 20.0
    img = img.astype(np.float32)
    want = np.asarray(jofilters.clahe(jnp.asarray(img), clip, grid))
    got = tofilters.clahe(torch.from_numpy(img), clip, grid).numpy()
    assert got.shape == shape and got.dtype == np.float32
    d = np.abs(got - want)
    assert d.max() <= 1.0 and (d <= 1e-3).mean() >= 0.999
    assert np.abs(got - img).max() > 1.0                  # it did equalize


# --- the gated emit and a resumed stream ------------------------------------

@pytest.mark.parametrize("method", ["kalman", "butterworth"])
@pytest.mark.parametrize("model", ["similarity", "homography"])
def test_gated_emit_before_warm_up_holds_the_cursors(model, method):
    """While the queue is short of ``effective_radius`` frames the gated
    emit leaves ``kalman_x``, ``kalman_p``, ``butter_state``, ``emit_idx``
    and ``envelope_exceeded`` as they were."""
    p = StabilizerParams(**SMALL, motion_model=model,
                         smoothing_method=method)
    frames = clip(n=3)
    dev = torch.device("cpu")
    st = stabilizer_state_init(p, 96, 128, dev)
    c = 9 if model == "homography" else 3
    st = st._replace(kalman_x=torch.full((2, c), 3.0),
                     kalman_p=torch.full((2, 2, c), 0.5),
                     butter_state=torch.full((4, c), -2.0))
    st = stabilizer_init_step_fn(p, st, torch.from_numpy(frames[0]))
    for f in frames[1:]:
        st, _ = stabilizer_analyze_step_fn(p, st, torch.from_numpy(f))
        new, _out, ready = stabilizer_emit_gated_fn(p, st)
        assert not bool(ready)
        for name in ("kalman_x", "kalman_p", "butter_state", "emit_idx",
                     "envelope_exceeded"):
            assert torch.equal(getattr(new, name), getattr(st, name)), name
        st = new


@pytest.mark.parametrize("kw", [
    {}, {"smoothing_method": "kalman"}, {"drone_high_freq_mode": True},
    {"motion_model": "homography", "smoothing_method": "butterworth"}])
def test_resumed_stream_continues_its_draws(kw):
    """12 frames, save, load into a new Stabilizer, 10 more frames and the
    flush: transforms and outputs equal the uninterrupted stream's bit for
    bit (the generator's position is carried, so are the smoother cursors
    and the drone chain's state)."""
    frames = clip(n=22)
    p = StabilizerParams(**SMALL, seed=3, **kw)
    whole = Stabilizer(p, mode=CPU)
    w_out, w_tr, w_fl = _run(whole, frames)

    first = Stabilizer(p, mode=CPU)
    for f in frames[:12]:
        first.stabilize(f)
    saved = first.state_dict()
    assert saved["key_state"].dtype == np.uint8
    second = Stabilizer(p, mode=CPU)
    second.load_state_dict(saved, 96, 128)
    r_out, r_tr, r_fl = _run(second, frames[12:])
    for a, b in zip(r_tr, w_tr[12:]):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    for a, b in zip(r_out + r_fl, w_out[12:] + w_fl):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)

    # A fresh generator from the same seed would have restarted the draws.
    restarted = dict(saved)
    del restarted["key_state"]
    third = Stabilizer(p, mode=CPU)
    third.load_state_dict(restarted, 96, 128)
    assert not np.array_equal(third._state.key.get_state().numpy(),
                              saved["key_state"])
