"""The port's virtual canvas (``video_stab_tpu_torch/core/canvas.py``)
against the JAX package's, on the CPU.

Held: ``coverage_analytic`` and ``adaptive_canvas_scale`` (decided from
the recent motion, then frozen) bit for bit; ``virtual_canvas_apply`` with
and without the active-window mask: the new weight bit for bit, the new
canvas bit for bit under a whole-pixel correction and, under a rotation,
within 1 level on at most 0.5 % of its values (the content warp's .5
rounding ties, where K1's plain version and the JAX warp may round apart,
``tests/test_torch_warp.py``), the composite within 1e-4 beside those
(its blurred coverage is a dense matmul in the JAX package, whose
summation order XLA picks, and a tap sum here, so the blend weight differs
by an ulp or two); 20-frame canvas streams through
both packages' ``Stabilizer`` with the JAX RANSAC draws injected, every
emitted pixel within 1 level; the gated emit holding the canvas during
warm-up; and a canvas stream resumed from the JAX package's mid-stream
state (within 1 level) and from the port's own (bit for bit).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_smoother_streams import clip  # noqa: E402
from test_torch_stabilizer import CPU, SMALL, JaxDraws, _run  # noqa: E402
from video_stab_tpu.core import canvas as jcanvas  # noqa: E402
from video_stab_tpu.core.params import StabilizerParams as JParams  # noqa: E402
from video_stab_tpu.core.stabilizer import Stabilizer as JStabilizer  # noqa: E402
from video_stab_tpu_torch.core import canvas as tcanvas  # noqa: E402
from video_stab_tpu_torch.core.params import StabilizerParams  # noqa: E402
from video_stab_tpu_torch.core.stabilizer import (  # noqa: E402
    Stabilizer,
    stabilizer_emit_gated_fn,
)
from video_stab_tpu_torch.core.state import stabilizer_state_init  # noqa: E402

H, W = 96, 128
CANVAS = {"enable_virtual_canvas": True}
STREAMS = {
    "adaptive": CANVAS,
    "fixed scale": {**CANVAS, "adaptive_canvas_size": False,
                    "canvas_scale_factor": 1.3},
    "fade border": {**CANVAS, "border_type": "fade", "border_size": 6},
}


def _affine(dx, dy, da):
    c, s = np.cos(da), np.sin(da)
    return np.array([[c, -s, dx], [s, c, dy]], np.float32)


@pytest.mark.parametrize("m", [(0.0, 0.0, 0.0), (64.5, 47.25, 0.0),
                               (70.3, 40.8, 0.05), (20.0, 90.0, -0.1)])
def test_coverage_analytic_bit_for_bit(m):
    mat = _affine(*m)
    hc, wc = tcanvas.canvas_shape(StabilizerParams(**CANVAS), H, W)
    want = np.asarray(jax.jit(jcanvas.coverage_analytic,
                              static_argnums=(1, 2, 3, 4))(
        jnp.asarray(mat), H, W, hc, wc))
    got = tcanvas.coverage_analytic(torch.from_numpy(mat), H, W, hc, wc)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_path", [0, 1, 5, 29, 30, 40, 300])
@pytest.mark.parametrize("spread", [2.0, 60.0])
def test_adaptive_canvas_scale_decided_then_frozen(n_path, spread):
    rng = np.random.default_rng(n_path)
    ring = rng.normal(0.0, spread, (128, 3)).astype(np.float32)
    for kw in (CANVAS, {**CANVAS, "adaptive_canvas_size": False}):
        jp, tp = JParams(**kw), StabilizerParams(**kw)
        for prev in (0.0, 1.4):
            want = np.asarray(jax.jit(
                lambda r, n, p, jp=jp: jcanvas.adaptive_canvas_scale(
                    jp, r, n, p))(ring, jnp.int32(n_path), jnp.float32(prev)))
            got = tcanvas.adaptive_canvas_scale(
                tp, torch.from_numpy(ring),
                torch.tensor(n_path, dtype=torch.int32),
                torch.tensor(prev)).numpy()
            np.testing.assert_array_equal(got, want)
            if prev > 0 and tp.adaptive_canvas_size:
                assert got == np.float32(prev)      # frozen after first use


@pytest.mark.parametrize("active", [None, 1.7, 2.0])
@pytest.mark.parametrize("corr", [(2.0, -3.0, 0.0), (-7.5, 4.25, 0.03)])
def test_virtual_canvas_apply(active, corr):
    rng = np.random.default_rng(7)
    jp, tp = JParams(**CANVAS), StabilizerParams(**CANVAS)
    hc, wc = tcanvas.canvas_shape(tp, H, W)
    canvas = (rng.random((hc, wc, 3)) * 255).astype(np.float32)
    weight = rng.random((hc, wc)).astype(np.float32)
    frame = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    c = np.asarray(corr, np.float32)
    scale = None if active is None else jnp.float32(active)
    want = jax.jit(lambda cv, wt, fr, co: jcanvas.virtual_canvas_apply(
        jp, cv, wt, fr, co, active_scale=scale))(
        canvas, weight, frame.astype(np.float32), c)
    got = tcanvas.virtual_canvas_apply(
        tp, torch.from_numpy(canvas), torch.from_numpy(weight),
        torch.from_numpy(frame), torch.from_numpy(c),
        active_scale=None if active is None else torch.tensor(active))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    d_canvas = np.abs(got[0].numpy() - np.asarray(want[0]))
    d_out = np.abs(got[2].numpy() - np.asarray(want[2]))
    if corr[2] == 0.0:
        # A whole-pixel shift interpolates nothing: no rounding ties.
        assert d_canvas.max() == 0.0
        assert d_out.max() <= 1e-4
    else:
        ties = d_canvas > 0
        assert ties.mean() <= 5e-3 and d_canvas.max() <= 1.0
        assert d_out.max() <= 1.0
        assert (d_out > 1e-4).mean() <= 5e-3


def _pair(kw, seed=0):
    jp = JParams(**SMALL, **kw, seed=seed)
    port = Stabilizer(StabilizerParams(**SMALL, **kw, seed=seed), mode=CPU,
                      ransac_draws=JaxDraws(jax.random.PRNGKey(seed),
                                            jp.ransac_hypotheses))
    return JStabilizer(jp), port


@pytest.mark.parametrize("name", list(STREAMS))
def test_canvas_stream_matches_jax(name):
    frames = clip(20)
    js, port = _pair(STREAMS[name])
    j_out, j_tr, j_fl = _run(js, frames)
    t_out, t_tr, t_fl = _run(port, frames)
    assert [o is None for o in t_out] == [o is None for o in j_out]
    for a, b in zip(t_tr, j_tr):
        if b is not None:
            np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)
    assert len(t_fl) == len(j_fl) > 0
    pairs = list(zip([o for o in t_out if o is not None] + t_fl,
                     [o for o in j_out if o is not None] + j_fl))
    for a, b in pairs:
        assert a.shape == b.shape == (H, W, 3) and a.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    hc, wc = tcanvas.canvas_shape(port.params, H, W)
    assert port._state.canvas.shape == (hc, wc, 3)
    np.testing.assert_array_equal(port._state.canvas_scale.numpy(),
                                  np.asarray(js.state_dict().canvas_scale))


def test_gated_emit_holds_the_canvas_during_warm_up():
    p = StabilizerParams(**SMALL, **CANVAS)
    st = stabilizer_state_init(p, H, W, torch.device("cpu"))
    st = st._replace(canvas=torch.full_like(st.canvas, 3.0),
                     canvas_weight=torch.full_like(st.canvas_weight, 0.5),
                     n_frames=torch.tensor(1, dtype=torch.int32),
                     n_path=torch.tensor(1, dtype=torch.int32))
    held, _, ready = stabilizer_emit_gated_fn(p, st)
    assert not bool(ready)
    for name in ("canvas", "canvas_weight", "canvas_scale", "emit_idx"):
        assert torch.equal(getattr(held, name), getattr(st, name)), name
    ready_st = st._replace(n_frames=torch.tensor(p.effective_radius + 1,
                                                 dtype=torch.int32))
    moved, _, ready = stabilizer_emit_gated_fn(p, ready_st)
    assert bool(ready) and not torch.equal(moved.canvas, st.canvas)
    assert float(moved.canvas_scale) >= p.min_canvas_scale


def test_canvas_stream_resumes_from_saved_state():
    frames = clip(20)
    js, port = _pair(CANVAS, seed=3)
    for f in frames[:12]:
        js.stabilize(f)
        port.stabilize(f)
    np_state = js.state_dict()
    # From the JAX package's state: the canvas buffers are carried.
    resumed = Stabilizer(port.params, mode=CPU,
                         ransac_draws=JaxDraws(np_state.key,
                                               port.params.ransac_hypotheses))
    resumed.load_state_dict(np_state, H, W)
    for name in ("canvas", "canvas_weight", "canvas_scale"):
        np.testing.assert_array_equal(
            getattr(resumed._state, name).numpy(),
            np.asarray(getattr(np_state, name)), err_msg=name)
    # From the port's own state: the continuation is bit for bit.
    own = Stabilizer(port.params, mode=CPU, ransac_draws=JaxDraws(
        port.ransac_draws.key, port.params.ransac_hypotheses))
    own.load_state_dict(port.state_dict(), H, W)
    for f in frames[12:18]:
        a, b, c, d = (resumed.stabilize(f), js.stabilize(f),
                      own.stabilize(f), port.stabilize(f))
        assert (a is None) == (b is None) == (c is None) == (d is None)
        if a is not None:
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
            np.testing.assert_array_equal(c, d)
    np.testing.assert_array_equal(own._state.canvas.numpy(),
                                  port._state.canvas.numpy())
