"""The PyTorch port's fused ProcessingChain against the JAX package's, on
the CPU, in the ``__graft_entry__.entry()`` configuration scaled down:
small frames with a ~2 deg tilted horizon composited in (bench.py's
chain pool) so the roll stage engages, the small analysis size, and a
Hough vote threshold scaled to the quarter-size roll image.

Held: identical ``ready`` sequences, the smoothed roll angle within 1e-3
deg after every frame, emitted frames within 1 on >= 99.5 % of pixels, the
same number of frames drained by ``flush()``; and from a mid-stream JAX
ChainState carried into the port, the same for the next 5 steps.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from video_stab_tpu.core import chain as jchain  # noqa: E402
from video_stab_tpu.core import params as jparams  # noqa: E402
from video_stab_tpu_torch.core import chain as tchain  # noqa: E402
from video_stab_tpu_torch.core import params as tparams  # noqa: E402

H, W = 192, 256
N = 20


class JaxDraws:
    """RANSAC draws from the JAX package's stream key chain (see
    test_torch_stabilizer.py)."""

    def __init__(self, key, n_hypotheses):
        self.key = jnp.asarray(key)
        self.k = n_hypotheses

    def __call__(self, n_valid):
        self.key, sub = jax.random.split(self.key)
        d = jax.random.randint(sub, (self.k, 2), 0, max(int(n_valid), 1))
        return torch.from_numpy(np.array(d, np.int64))


def _frames():
    """bench.py's _make_pool at (H, W) with per-frame jitter, and its
    ~2 deg tilted horizon edge composited in."""
    rng = np.random.default_rng(0)
    pad = 32
    world = rng.random((H + 2 * pad, W + 2 * pad)).astype(np.float32)
    kern = np.exp(-0.5 * (np.arange(-6, 7) / 2.0) ** 2)
    kern /= kern.sum()
    world = np.apply_along_axis(
        lambda r: np.convolve(r, kern, mode="same"), 1, world)
    world = np.apply_along_axis(
        lambda c: np.convolve(c, kern, mode="same"), 0, world)
    world -= world.min()
    world /= max(world.max(), 1e-6)
    world = (world * 255.0).astype(np.uint8)
    yy = np.arange(H, dtype=np.float32)[:, None, None]
    xx = np.arange(W, dtype=np.float32)[None, :, None]
    sky = yy < (H / 2.0 + np.tan(np.radians(2.0)) * (xx - W / 2.0))
    out = []
    for _ in range(N):
        dx, dy = rng.integers(-6, 7, 2)
        f = world[pad + dy:pad + dy + H, pad + dx:pad + dx + W]
        f = np.stack([f, np.roll(f, 1, 0), 255 - f], axis=-1)
        out.append(np.clip(f * 0.75 + sky * 60.0, 0, 255).astype(np.uint8))
    return out


def _params(pm):
    return dict(
        mode=pm.ModeParams(enhancer_enabled=True,
                           roll_correction_enabled=True,
                           stabilizer_enabled=True),
        enhancer=pm.EnhancerParams(brightness=5.0, contrast=1.1, gamma=0.9),
        roll=pm.RollCorrectionParams(hough_threshold=30),
        stabilizer=pm.StabilizerParams(
            smoothing_radius=5, analysis_width=64, analysis_height=48,
            max_corners=32, ransac_hypotheses=32))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX chain over the clip: outputs, angles, the state after frame
    12 as numpy, and the flushed frames."""
    frames = _frames()
    ch = jchain.ProcessingChain(**_params(jparams))
    outs, angles, mid = [], [], None
    for i, f in enumerate(frames):
        outs.append(ch.process(f))
        angles.append(float(ch._state.roll.smoothed_angle))
        if i == 11:
            mid = (jax.tree_util.tree_map(np.array, ch._state),
                   ch._frames_in, ch._emitted)
    flushed = []
    while (o := ch.flush()) is not None:
        flushed.append(o)
    return frames, outs, angles, mid, flushed


def _port_chain(key):
    p = _params(tparams)
    p["mode"] = tparams.ModeParams(use_cuda=False, enhancer_enabled=True,
                                   roll_correction_enabled=True,
                                   stabilizer_enabled=True)
    return tchain.ProcessingChain(
        **p, ransac_draws=JaxDraws(key, p["stabilizer"].ransac_hypotheses))


def _close(a, b):
    return (np.abs(a.astype(np.int64) - b.astype(np.int64)) <= 1).mean()


def test_roll_fusion_is_the_path(jax_run):
    assert tchain.ChainParams(**_params(tparams)).roll_fusion_active
    _frames_, _outs, angles, _mid, _fl = jax_run
    assert abs(angles[-1]) > 0.1, angles     # the roll stage engaged


def test_chain_matches_jax(jax_run):
    frames, j_outs, j_angles, _mid, j_flushed = jax_run
    ch = _port_chain(jax.random.PRNGKey(0))
    for f, jo, ja in zip(frames, j_outs, j_angles):
        o = ch.process(f)
        assert (o is None) == (jo is None)
        assert abs(float(ch.state.roll.smoothed_angle) - ja) <= 1e-3
        if o is not None:
            assert o.shape == jo.shape and o.dtype == np.uint8
            assert _close(o, jo) >= 0.995
    flushed = []
    while (o := ch.flush()) is not None:
        flushed.append(o)
    assert len(flushed) == len(j_flushed) > 0
    for a, b in zip(flushed, j_flushed):
        assert _close(a, np.asarray(b)) >= 0.995


def test_chain_state_round_trip_continues_like_jax(jax_run):
    frames, j_outs, j_angles, (state, frames_in, emitted), _fl = jax_run
    ch = _port_chain(state.stab.key)
    ch.load_state(tchain.chain_state_from_numpy(state.roll.smoothed_angle,
                                                state.stab, "cpu"),
                  frames_in, emitted)
    for i in range(12, 17):
        o = ch.process(frames[i])
        assert (o is None) == (j_outs[i] is None)
        assert abs(float(ch.state.roll.smoothed_angle) - j_angles[i]) <= 1e-3
        if o is not None:
            assert _close(o, j_outs[i]) >= 0.995
