"""The port's bordered emit and motion prediction against the JAX
package's Stabilizer, on the CPU: a stream per border type (padded by
``border_size`` before the warp), per crop-and-zoom case and per fade case,
for both motion models, and streams with ``motion_prediction`` (the global
translation prior seeding LK).

Both stabilize the same jittered clip (``jittered_clip``, 96 x 128); the
port's RANSAC gets the JAX package's own draws. Held, as in
``test_torch_stabilizer.py``: identical ``ready`` sequences, per-frame
transforms within 1e-3 (5e-3 px for the prior's stream, whose analysis
size of 256 x 192 the prior needs: there the same stream without the prior
differs from JAX by up to 3.6e-3 too, LK's eps freeze a step apart),
emitted and flushed u8 frames within 1 on
>= 99.5 % of pixels, the padded output shape (h + 2b, w + 2b, 3); for the
fade border the fade counter equal and the history within 1e-3 on >= 99.5 %
of values and within 1 everywhere after the stream (a warped pixel one
level apart moves its history by 0.1 a frame), and a stream resumed from
the JAX package's mid-stream state continues like it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from video_stab_tpu.core.params import StabilizerParams as JParams  # noqa: E402
from video_stab_tpu.core.stabilizer import Stabilizer as JStabilizer  # noqa: E402
from video_stab_tpu_torch.core import stabilizer as tstab  # noqa: E402
from video_stab_tpu_torch.core.params import ModeParams, StabilizerParams  # noqa: E402
from video_stab_tpu_torch.core.stabilizer import Stabilizer  # noqa: E402

SMALL = dict(smoothing_radius=5, analysis_width=64, analysis_height=48,
             max_corners=32, ransac_hypotheses=32)
CPU = ModeParams(use_cuda=False)
B = 6

CASES = {
    "black": dict(border_size=B),
    "replicate": dict(border_size=B, border_type="replicate"),
    "reflect": dict(border_size=B, border_type="reflect"),
    "reflect_101": dict(border_size=B, border_type="reflect_101"),
    "reflect101": dict(border_size=B, border_type="reflect101"),
    "wrap": dict(border_size=B, border_type="wrap"),
    "fade": dict(border_size=B, border_type="fade", fade_duration=4,
                 fade_alpha=0.3),
    "crop_n_zoom reflect_101": dict(border_size=B, border_type="reflect_101",
                                    crop_n_zoom=True),
    "crop_n_zoom fade": dict(border_size=B, border_type="fade",
                             crop_n_zoom=True),
    "homography replicate": dict(border_size=B, border_type="replicate",
                                 motion_model="homography"),
    "homography crop_n_zoom": dict(border_size=B, crop_n_zoom=True,
                                   motion_model="homography"),
    # The prior needs >= 32 rows at analysis / 2**lk_levels to measure.
    "motion_prediction": dict(motion_prediction=True, analysis_width=256,
                              analysis_height=192),
    "motion_prediction homography": dict(motion_prediction=True,
                                         motion_model="homography"),
}


class JaxDraws:
    """RANSAC draws from the JAX package's stream key chain (see
    test_torch_stabilizer.py)."""

    def __init__(self, key, n_hypotheses, width=2):
        self.key = jnp.asarray(key)
        self.k = n_hypotheses
        self.width = width

    def __call__(self, n_valid):
        self.key, sub = jax.random.split(self.key)
        d = jax.random.randint(sub, (self.k, self.width), 0,
                               max(int(n_valid), 1))
        return torch.from_numpy(np.array(d, np.int64))


def _close(a, b):
    return (np.abs(a.astype(np.int64) - b.astype(np.int64)) <= 1).mean()


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


def _port(kw, key):
    p = StabilizerParams(**{**SMALL, **kw})
    width = 4 if p.motion_model == "homography" else 2
    return Stabilizer(p, mode=CPU, ransac_draws=JaxDraws(
        key, p.ransac_hypotheses, width))


@pytest.mark.parametrize("case", list(CASES))
def test_stream_matches_jax(jittered_clip, case, monkeypatch):
    frames, _ = jittered_clip
    frames = frames[:14]
    kw = CASES[case]
    jp = JParams(**{**SMALL, **kw})
    js = JStabilizer(jp)
    j_out, j_tr, j_fl = _run(js, frames)
    priors = []

    def prior(a, b):
        g = tstab.global_translation_prior.__wrapped__(a, b)
        priors.append(g.numpy().copy())
        return g
    prior.__wrapped__ = tstab.global_translation_prior
    monkeypatch.setattr(tstab, "global_translation_prior", prior)
    port = _port(kw, jax.random.PRNGKey(jp.seed))
    t_out, t_tr, t_fl = _run(port, frames)
    if case == "motion_prediction":
        # The prior seeded LK with a measured shift on some frames.
        assert len(priors) == len(frames) - 1
        assert any(np.abs(g).max() > 0 for g in priors), priors
    else:
        assert priors == []      # the homography model tracks without it

    assert [o is None for o in t_out] == [o is None for o in j_out]
    atol = 5e-3 if jp.analysis_width > 64 else 1e-3
    for a, b in zip(t_tr, j_tr):
        if b is not None:
            np.testing.assert_allclose(a, b, atol=atol, rtol=0)
    assert len(t_fl) == len(j_fl) == jp.effective_radius - 1
    h, w = frames[0].shape[:2]
    pad = 0 if (jp.crop_n_zoom or jp.border_pad == 0) else jp.border_pad
    for a, b in zip([o for o in t_out if o is not None] + t_fl,
                    [o for o in j_out if o is not None] + j_fl):
        assert a.shape == b.shape == (h + 2 * pad, w + 2 * pad, 3)
        assert a.dtype == np.uint8
        assert _close(a, np.asarray(b)) >= 0.995
    if case == "fade":
        st, jst = port.state_dict(), js.state_dict()
        assert st["fade_history"].shape == (h + 2 * B, w + 2 * B, 3)
        assert int(st["fade_count"]) == int(jst.fade_count) > 4
        d = np.abs(st["fade_history"] - np.asarray(jst.fade_history))
        assert (d <= 1e-3).mean() >= 0.995 and d.max() <= 1.0, \
            ((d <= 1e-3).mean(), d.max())


def test_fade_stream_resumes_from_a_jax_state(jittered_clip):
    """The port started from the JAX stabilizer's mid-stream state (the
    fade history included) continues like it."""
    frames, _ = jittered_clip
    kw = CASES["fade"]
    jp = JParams(**{**SMALL, **kw})
    js = JStabilizer(jp)
    for f in frames[:10]:
        js.stabilize(f)
    np_state = js.state_dict()
    port = _port(kw, np_state.key)
    h, w = frames[0].shape[:2]
    port.load_state_dict(np_state, h, w)
    np.testing.assert_array_equal(port.state_dict()["fade_history"],
                                  np.asarray(np_state.fade_history))
    for f in frames[10:15]:
        a, b = port.stabilize(f), js.stabilize(f)
        assert (a is None) == (b is None)
        if a is not None:
            assert _close(a, b) >= 0.995


def test_warm_up_holds_the_fade_history():
    """While the queue fills, the gated emit keeps fade_history and
    fade_count as they were."""
    p = StabilizerParams(**SMALL, **CASES["fade"])
    from video_stab_tpu_torch.core.state import stabilizer_state_init
    st = stabilizer_state_init(p, 32, 40, torch.device("cpu"))
    frame = torch.full((32, 40, 3), 100, dtype=torch.uint8)
    st = tstab.stabilizer_init_step_fn(p, st, frame)
    st2, _out, ready = tstab.stabilizer_emit_gated_fn(p, st)
    assert not bool(ready)
    assert int(st2.fade_count) == 0
    assert torch.equal(st2.fade_history, st.fade_history)


@pytest.mark.parametrize("border_type,np_mode", [
    ("replicate", "edge"), ("reflect", "symmetric"),
    ("reflect_101", "reflect"), ("wrap", "wrap"), ("black", "constant"),
    ("fade", "constant"), ("unknown", "constant")])
def test_pad_frame_is_numpy_pad(border_type, np_mode):
    img = np.random.default_rng(0).integers(0, 256, (7, 9, 3), np.uint8)
    for b in (1, 3, 8):
        got = tstab.pad_frame(torch.from_numpy(img), b, border_type).numpy()
        np.testing.assert_array_equal(got, np.pad(img, ((b, b), (b, b),
                                                        (0, 0)),
                                                  mode=np_mode))
