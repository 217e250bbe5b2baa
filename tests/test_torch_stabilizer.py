"""The PyTorch port's Stabilizer against the JAX package's, on the CPU.

Both stabilize the same jittered clip with the same StabilizerParams; the
port's RANSAC is fed the JAX package's own draws (the JAX stream key chain,
split once per analyze step), since a torch generator cannot reproduce
them. Held: identical ``ready`` sequences, emitted u8 frames within 1 on
>= 99.5 % of pixels, per-frame transforms within 1e-3, and the same number
of frames drained by ``flush()``. A mid-stream JAX state carried into the
port (``state_from_numpy``) continues identically for 5 more steps.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from video_stab_tpu.core.params import StabilizerParams as JParams  # noqa: E402
from video_stab_tpu.core.stabilizer import Stabilizer as JStabilizer  # noqa: E402
from video_stab_tpu_torch.core.params import ModeParams, StabilizerParams  # noqa: E402
from video_stab_tpu_torch.core.stabilizer import Stabilizer  # noqa: E402
from video_stab_tpu_torch.core.state import (  # noqa: E402
    StabilizerState,
    state_from_numpy,
    state_to_numpy,
)

SMALL = dict(smoothing_radius=5, analysis_width=64, analysis_height=48,
             max_corners=32, ransac_hypotheses=32)
CPU = ModeParams(use_cuda=False)


class JaxDraws:
    """RANSAC draws from the JAX package's stream key chain: each analyze
    step splits the key and draws randint(sub, (K, width), 0,
    max(n_valid, 1)); width 2 for the similarity model, 4 for the
    homography model."""

    def __init__(self, key, n_hypotheses, width=2):
        self.key = jnp.asarray(key)
        self.k = n_hypotheses
        self.width = width

    def __call__(self, n_valid):
        self.key, sub = jax.random.split(self.key)
        d = jax.random.randint(sub, (self.k, self.width), 0,
                               max(int(n_valid), 1))
        return torch.from_numpy(np.array(d, np.int64))


def _close_frames(a, b):
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    return (d <= 1).mean()


def _run(stab, frames):
    outs, transforms = [], []
    for f in frames:
        outs.append(stab.stabilize(f))
        transforms.append(np.asarray(stab.last_metrics["transform"])
                          if stab.last_metrics else None)
    flushed = []
    while (o := stab.flush()) is not None:
        flushed.append(np.asarray(o))
    return outs, transforms, flushed


@pytest.mark.parametrize("kw", [
    {},
    {"redetect_interval": 3, "min_distance": 10.0},
    {"full_res_corrections": False, "horizon_lock": True},
])
def test_stabilizer_matches_jax(jittered_clip, kw):
    frames, _ = jittered_clip
    jp = JParams(**SMALL, **kw)
    j_out, j_tr, j_fl = _run(JStabilizer(jp), frames)
    port = Stabilizer(StabilizerParams(**SMALL, **kw), mode=CPU,
                      ransac_draws=JaxDraws(jax.random.PRNGKey(jp.seed),
                                            jp.ransac_hypotheses))
    t_out, t_tr, t_fl = _run(port, frames)

    assert [o is None for o in t_out] == [o is None for o in j_out]
    for a, b in zip(t_tr, j_tr):
        if b is not None:
            np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)
    assert len(t_fl) == len(j_fl) == jp.effective_radius - 1
    for a, b in zip([o for o in t_out if o is not None] + t_fl,
                    [o for o in j_out if o is not None] + j_fl):
        assert a.shape == b.shape and a.dtype == np.uint8
        assert _close_frames(a, b) >= 0.995


def test_state_round_trip_continues_like_jax(jittered_clip):
    """Start the port from the JAX stabilizer's mid-stream state and
    compare the next 5 steps."""
    frames, _ = jittered_clip
    jp = JParams(**SMALL)
    js = JStabilizer(jp)
    for f in frames[:12]:
        js.stabilize(f)
    np_state = js.state_dict()
    port = Stabilizer(StabilizerParams(**SMALL), mode=CPU,
                      ransac_draws=JaxDraws(np_state.key,
                                            jp.ransac_hypotheses))
    h, w = frames[0].shape[:2]
    port.load_state_dict(np_state, h, w)
    for name in StabilizerState._fields:
        if name not in ("key", "hf", "deepstab"):
            np.testing.assert_array_equal(
                state_to_numpy(port._state)[name],
                np.asarray(getattr(np_state, name)), err_msg=name)
    for f in frames[12:17]:
        a, b = port.stabilize(f), js.stabilize(f)
        assert (a is None) == (b is None)
        np.testing.assert_allclose(np.asarray(port.last_metrics["transform"]),
                                   np.asarray(js.last_metrics["transform"]),
                                   atol=1e-3, rtol=0)
        if a is not None:
            assert _close_frames(a, b) >= 0.995


def test_state_numpy_round_trip():
    p = StabilizerParams(**SMALL)
    from video_stab_tpu_torch.core.state import stabilizer_state_init
    st = stabilizer_state_init(p, 48, 64, torch.device("cpu"))
    st = st._replace(n_path=torch.tensor(7, dtype=torch.int32),
                     prev_pts=torch.rand(32, 2))
    back = state_from_numpy(type("S", (), state_to_numpy(st)), "cpu")
    for name in StabilizerState._fields:
        if name not in ("key", "hf", "deepstab"):
            assert torch.equal(getattr(back, name), getattr(st, name)), name


def test_steady_state_reads_nothing_from_the_device(jittered_clip,
                                                    monkeypatch):
    """Past the first frames the wrapper never converts a device scalar on
    the host: readiness and the redetect cadence are host counters (the
    GFTT NMS loop's convergence reads are counted separately)."""
    frames, _ = jittered_clip
    port = Stabilizer(StabilizerParams(**SMALL, redetect_interval=1000),
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
    for f in frames[3:10]:
        port.stabilize_device(f)
    monkeypatch.undo()
    assert calls == [], calls
