"""The port's ProcessingChain in the two-pass roll order, with auto
zoom-crop, I420 delivery and the pipelined wrapper, and each shipped
config scaled down, against the JAX package's chain on the CPU.

Frames: 192 x 256 with a ~2 deg tilted horizon (``test_torch_chain.py``'s
clip), RANSAC fed the JAX package's draws. Held: identical ``ready``
sequences, the smoothed roll angle within 1e-3 deg after every frame,
delivered frames (BGR or I420 planes) within 1 on >= 99.5 % of samples,
the same number drained by ``flush()``.

The wide band (+-70 deg): the JAX package warps and zoom-crops the
unsaturated float frame, the port rounds to u8 before and after K1: the
pre-stages' output differs by at most 1 level (an intended difference,
bounded here on its own), the delivered frames without the stabilizer
within 1 on >= 99.5 %; with the stabilizer, that level moves LK within its
eps and can tip RANSAC's pick, so those frames are held to >= 95 % within
1. The pipelined chain hands back exactly the
unpipelined chain's frames, one call late, the last one by ``drain()`` /
``flush()``.
"""

import dataclasses
import os
import sys

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

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
import chip_smoke  # noqa: E402

H, W = 192, 256
N = 16
SMALL = dict(smoothing_radius=5, analysis_width=64, analysis_height=48,
             max_corners=32, ransac_hypotheses=32)


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


@pytest.fixture(scope="module")
def frames():
    return list(chip_smoke.make_frames(H, W, N, seed=3))


def _params(pm, case):
    """(ChainParams kwargs, output_format) of a case, for either package."""
    mode = pm.ModeParams(enhancer_enabled=True, roll_correction_enabled=True,
                         stabilizer_enabled=True)
    roll = pm.RollCorrectionParams(hough_threshold=30)
    enh = pm.EnhancerParams(brightness=5.0, contrast=1.1, gamma=0.9)
    stab = pm.StabilizerParams(**SMALL)
    azc = pm.AutoZoomCropParams()
    fmt = "bgr"
    if case == "narrow azc i420":
        azc = pm.AutoZoomCropParams(enabled=True)
        fmt = "i420"
    elif case.startswith("wide"):
        if case == "wide azc i420 enhancer":
            mode = dataclasses.replace(mode, stabilizer_enabled=False)
        roll = pm.RollCorrectionParams(hough_threshold=30,
                                       angle_filter_min=-70.0,
                                       angle_filter_max=70.0)
        azc = pm.AutoZoomCropParams(enabled=True)
        enh = pm.EnhancerParams(brightness=5.0, contrast=1.1, gamma=0.9,
                                enable_vibrance=True, enable_unsharp=True,
                                sharpness=1.0, enable_denoise=True,
                                denoise_strength=5.0)
        fmt = "i420"
    elif case == "homography roll":
        stab = pm.StabilizerParams(**SMALL, motion_model="homography")
    elif case in ("two-pass narrow", "fused narrow"):
        pass
    return dict(mode=mode, enhancer=enh, roll=roll, stabilizer=stab,
                azc=azc, fuse_roll=case != "two-pass narrow"), fmt


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return (np.abs(a.astype(np.int64) - b.astype(np.int64)) <= 1).mean()


def _port_chain(kw, fmt, key, pipelined=False):
    kw = dict(kw, mode=dataclasses.replace(kw["mode"], use_cuda=False))
    width = 4 if kw["stabilizer"].motion_model == "homography" else 2
    draws = None if key is None else JaxDraws(
        key, kw["stabilizer"].ransac_hypotheses, width)
    return tchain.ProcessingChain(**kw, output_format=fmt,
                                  pipelined=pipelined, ransac_draws=draws)


def _stream(ch, frames, angle):
    outs, angles = [], []
    for f in frames:
        outs.append(ch.process(f))
        angles.append(angle(ch))
    flushed = []
    while (o := ch.flush()) is not None:
        flushed.append(np.asarray(o))
    return outs, angles, flushed


CASES = ["narrow azc i420", "wide azc i420 enhancer", "homography roll",
         "two-pass narrow", "wide stabilized"]


@pytest.mark.parametrize("case", CASES)
def test_two_pass_chain_matches_jax(frames, case):
    jkw, fmt = _params(jparams, case)
    tkw, _ = _params(tparams, case)
    assert not tchain.ChainParams(**tkw, output_format=fmt) \
        .roll_fusion_active
    j_outs, j_ang, j_fl = _stream(
        jchain.ProcessingChain(**jkw, output_format=fmt), frames,
        lambda c: float(c._state.roll.smoothed_angle))
    t_outs, t_ang, t_fl = _stream(
        _port_chain(tkw, fmt, jax.random.PRNGKey(0)), frames,
        lambda c: float(c.state.roll.smoothed_angle))
    assert abs(j_ang[-1]) > 0.1, j_ang            # the roll stage engaged
    np.testing.assert_allclose(t_ang, j_ang, atol=1e-3, rtol=0)
    assert [o is None for o in t_outs] == [o is None for o in j_outs]
    stabilized = tkw["mode"].stabilizer_enabled
    assert len(t_fl) == len(j_fl) and (len(t_fl) > 0) == stabilized
    # The wide band's one-level difference at the stabilizer's input moves
    # LK within its eps and can tip RANSAC's pick: the stabilized frames
    # there are held to >= 95 % within 1; the same pre-stages without the
    # stabilizer to the general 99.5 %.
    share = 0.95 if case == "wide stabilized" else 0.995
    shape = (H * 3 // 2, W) if fmt == "i420" else (H, W, 3)
    for a, b in zip([o for o in t_outs if o is not None] + t_fl,
                    [o for o in j_outs if o is not None] + j_fl):
        assert a.shape == shape
        assert _close(a, b) >= share


@pytest.mark.parametrize("band", [10.0, 70.0])
def test_pre_stages_within_one_level(frames, band):
    """The two-pass pre-stages (enhance, roll estimate, K1 with
    BORDER_REPLICATE, azc) on the same frame and roll state: the same
    angle; the frame equal but for K4's pow (<= 1 level) in the narrow
    band, within 1 level in the wide band (the intended difference)."""
    jkw, _ = _params(jparams, "narrow azc i420")
    tkw, _ = _params(tparams, "narrow azc i420")
    for kw, pm in ((jkw, jparams), (tkw, tparams)):
        kw["roll"] = pm.RollCorrectionParams(hough_threshold=30,
                                             angle_filter_min=-band,
                                             angle_filter_max=band)
    jp, tp = jchain.ChainParams(**jkw), tchain.ChainParams(**tkw)
    js = jchain.chain_state_init(jp, H, W)
    js = js._replace(roll=js.roll._replace(smoothed_angle=jnp.float32(3.0)))
    ts = tchain.chain_state_init(tp, H, W, torch.device("cpu"))
    ts = ts._replace(roll=ts.roll._replace(
        smoothed_angle=torch.tensor(3.0)))
    for f in frames[:3]:
        j_roll, j_f = jchain._pre_stages(jp, js, jnp.asarray(f))
        t_roll, t_f = tchain._pre_stages(tp, ts, torch.from_numpy(f))
        assert abs(float(t_roll.smoothed_angle)
                   - float(j_roll.smoothed_angle)) <= 1e-3
        d = np.abs(t_f.numpy().astype(int) - np.asarray(j_f).astype(int))
        assert d.max() <= 1, d.max()
        if band <= 15.0:
            assert (d == 0).mean() >= 0.999


@pytest.mark.parametrize("case", ["narrow azc i420", "fused narrow"])
def test_analyze_step_matches_jax(frames, case):
    """chain_analyze_step_fn fills the queue without emitting, on the
    two-pass route (auto zoom-crop) and on the fused one."""
    jkw, _ = _params(jparams, case)
    tkw, _ = _params(tparams, case)
    jp, tp = jchain.ChainParams(**jkw), tchain.ChainParams(**tkw)
    assert tp.roll_fusion_active == (case == "fused narrow")
    js = jchain.chain_init_step(jp, jchain.chain_state_init(jp, H, W),
                                jnp.asarray(frames[0]))
    ts = tchain.chain_init_step_fn(
        tp, tchain.chain_state_init(tp, H, W, torch.device("cpu")),
        torch.from_numpy(frames[0]))
    draws = JaxDraws(np.array(js.stab.key), SMALL["ransac_hypotheses"])
    for i, f in enumerate(frames[1:5], start=1):
        js = jchain.chain_analyze_step(jp, js, jnp.asarray(f))
        ts = tchain.chain_analyze_step_fn(tp, ts, torch.from_numpy(f),
                                          redetect_tick=i,
                                          ransac_draws=draws)
    assert int(ts.stab.n_path) == int(js.stab.n_path) == 4
    assert int(ts.stab.emit_idx) == int(js.stab.emit_idx) == 0
    # Auto zoom-crop's resample leaves a few pixels a level apart (two
    # taps here, the dense tent matrices there): the path within 5e-3.
    np.testing.assert_allclose(ts.stab.path_ring[:4].numpy(),
                               np.asarray(js.stab.path_ring[:4]),
                               atol=5e-3, rtol=0)


@pytest.mark.parametrize("how", ["process", "process_device"])
def test_pipelined_is_unpipelined_one_call_late(frames, how):
    tkw, fmt = _params(tparams, "narrow azc i420")
    plain = _port_chain(tkw, fmt, None)
    piped = _port_chain(tkw, fmt, None, pipelined=True)
    want = [plain.process(f) for f in frames]
    want = [w for w in want if w is not None]
    got = []
    step = getattr(piped, how)
    for f in frames:
        o = step(f)
        if o is not None:
            got.append(np.asarray(o))
    assert len(got) == len(want) - 1
    last = piped.flush() if how == "process" else piped.drain()
    got.append(last)
    assert piped.drain() is None
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    rest_p, rest_q = [], []
    while (o := plain.flush()) is not None:
        rest_p.append(o)
    while (o := piped.flush()) is not None:
        rest_q.append(o)
    assert len(rest_p) == len(rest_q) > 0
    for a, b in zip(rest_p, rest_q):
        np.testing.assert_array_equal(a, b)


def test_with_output_format(frames):
    tkw, _ = _params(tparams, "two-pass narrow")
    ch = _port_chain(tkw, "bgr", None, pipelined=True)
    ch2 = ch.with_output_format("i420")
    assert ch2.params.output_format == "i420" and ch2.pipelined
    assert ch2.params._replace(output_format="bgr") == ch.params
    with pytest.raises(ValueError, match="output_format"):
        ch.with_output_format("nv12")


def _scaled(cfg, pm):
    """A shipped config (chip_smoke.shipped_configs, port params) as the
    params of package ``pm``, scaled to the small clip: analysis 64 x 48,
    32 corners, 32 hypotheses, borders 8 px. The drone mode's conditional
    CLAHE switches on after > 2 frames with fewer than 40 tracked points,
    and on the frame it switches, an equalized frame is tracked against a
    plain one, whose few matches leave RANSAC's pick to float32 rounding
    (PERF.md): its scaled config keeps the clip's full 256 x 192 and
    128 corners, so that it is never starved."""
    out = {}
    for key, value in cfg.items():
        if dataclasses.is_dataclass(value):
            value = getattr(pm, type(value).__name__)(
                **dataclasses.asdict(value))
        out[key] = value
    stab = out["stabilizer"]
    size = dict(analysis_width=256, analysis_height=192, max_corners=128) \
        if stab.drone_high_freq_mode else \
        dict(analysis_width=64, analysis_height=48, max_corners=32)
    out["stabilizer"] = dataclasses.replace(
        stab, **size, ransac_hypotheses=32,
        border_size=min(stab.border_size, 8))
    return out


@pytest.mark.parametrize("name", ["default", "drone_hf", "rtsp_serving",
                                  "selftest"])
def test_shipped_config_scaled_down_matches_jax(frames, name):
    cfg = chip_smoke.shipped_configs()[name]
    jkw, tkw = _scaled(cfg, jparams), _scaled(cfg, tparams)
    j_outs, _ja, j_fl = _stream(jchain.ProcessingChain(**jkw), frames,
                                lambda c: 0.0)
    t_chain = _port_chain(tkw, "bgr", jax.random.PRNGKey(0))
    t_outs, _ta, t_fl = _stream(t_chain, frames, lambda c: 0.0)
    assert [o is None for o in t_outs] == [o is None for o in j_outs]
    assert len(t_fl) == len(j_fl)
    emitted = [o for o in t_outs if o is not None] + t_fl
    assert emitted
    if tkw["stabilizer"].drone_high_freq_mode:
        assert int(t_chain.state.stab.starvation_counter) == 0
    for a, b in zip(emitted, [o for o in j_outs if o is not None] + j_fl):
        assert _close(a, b) >= 0.995
