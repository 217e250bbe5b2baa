"""The drone high-frequency deployment (``configs/drone_hf.yaml``) on the
CPU: the benchmark's plain reference of it
(``benchmark_torch/reference/stream_drone.py``) held to the JAX package
stage by stage, and the port's stabilizer-only route held to the
reference.

Held, each with its tolerance and the reason for it:

- the reference's CLAHE against ``video_stab_tpu/ops/filters.py:clahe``
  on seeded float grays: within 1 grey level, >= 99 % of pixels within 1e-3
  (integer histograms and LUTs are exact; the bilinear blend is float32 in
  another order), and against ``cv2.createCLAHE`` on u8 images whose
  sides both divide the grid or both do not (where cv::CLAHE pads as the
  program does): rounded, within 1 everywhere and equal on >= 99 %;
- its high-frequency chain against ``video_stab_tpu/motion/hf.py``,
  transform by transform: within 1e-6 (a handful of float32 operations on
  values of magnitude <= 10);
- its gaussian emit against ``video_stab_tpu/motion/filters.py`` at the
  path's both ends and inside: within 1e-5 (the same float32 taps summed
  in another order);
- its translation prior against ``video_stab_tpu/ops/lk.py``'s on shifted
  frames: the same shift;
- the port's ``stabilize_only`` system against the reference on the
  benchmark's CPU-size copy of the drone cell, through the harness: the
  cell's own limits;
- a starved stream (low-texture frames, fewer than 40 tracked points, so
  the starvation counter passes 2 and CLAHE is selected), and one whose
  counter passes 2 and resets: the port and the reference select CLAHE on
  the same frames and deliver frames within the cell's limits;
- the drone stages' spans and counters in the port: under
  ``torch.profiler`` each analyze step writes one ``vstab.clahe`` and one
  ``vstab.hf`` inside ``vstab.step`` and each emit one ``vstab.crop_zoom``
  inside ``vstab.emit``, the counters ``clahe_runs``, ``hf_steps`` and
  ``crop_zoom_resamples`` move with them, and the delivered frames are
  the same bit for bit with the profiler recording and without.
"""

import json

import cv2
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from benchmark_torch import compare, frames, harness  # noqa: E402
from benchmark_torch.reference import stream_drone  # noqa: E402
from benchmark_torch.tests.test_harness import (  # noqa: E402
    ROOT,
    small_manifest,
)
from drone_frames import starved_pool  # noqa: E402
from video_stab_tpu.motion import filters as jfilters  # noqa: E402
from video_stab_tpu.motion import hf as jhf  # noqa: E402
from video_stab_tpu.ops import filters as jofilters  # noqa: E402
from video_stab_tpu.ops import lk as jlk  # noqa: E402
from video_stab_tpu_torch.ops import filters as tofilters  # noqa: E402
from video_stab_tpu_torch.utils import telemetry  # noqa: E402

CELL = "drone_hf_1080p.saturated"
SEED = 2 ** 31 + 11
CPU = torch.device("cpu")
SMALL = json.loads(
    (harness.HERE / "tests" / "drone_hf_1080p_small.json").read_text())


def _gray(shape, seed):
    """A smooth seeded gray in [20, 220], float32."""
    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur(rng.random(shape).astype(np.float32), (0, 0),
                           1.5)
    return ((img - img.min()) / np.ptp(img) * 200.0 + 20.0).astype(
        np.float32)


# --- CLAHE -------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(48, 64), (50, 70), (135, 240), (33, 41),
                                   (180, 320)])
def test_clahe_matches_jax_and_the_port(shape):
    """Sizes that do and do not divide the grid (180 x 320, the small
    cell's analysis size, divides it on one side only)."""
    img = _gray(shape, shape[0])
    got = stream_drone.clahe(torch.from_numpy(img)[None])[0].numpy()
    assert got.shape == shape and got.dtype == np.float32
    for want in (np.asarray(jofilters.clahe(jnp.asarray(img), 2.0, 8)),
                 tofilters.clahe(torch.from_numpy(img), 2.0, 8).numpy()):
        d = np.abs(got - want)
        assert d.max() <= 1.0 and (d <= 1e-3).mean() >= 0.99
    assert np.abs(got - img).max() > 1.0                  # it did equalize


@pytest.mark.parametrize("shape", [(64, 64), (48, 64), (50, 70), (37, 53),
                                   (96, 128)])
def test_clahe_matches_cv2_on_u8(shape):
    img = _gray(shape, 7 + shape[1]).astype(np.uint8)
    want = cv2.createCLAHE(2.0, (8, 8)).apply(img).astype(np.int16)
    got = stream_drone.clahe(torch.from_numpy(img.astype(np.float32))[None])
    got = torch.round(got[0]).to(torch.int16).numpy()
    d = np.abs(got - want)
    assert d.max() <= 1 and (d == 0).mean() >= 0.99


# --- the high-frequency chain, the gaussian, the prior -----------------------

@pytest.mark.parametrize("horizon_lock", [False, True])
@pytest.mark.parametrize("seed,scale", [(0, 0.8), (1, 2.5), (2, 6.0)])
def test_hf_chain_matches_jax(seed, scale, horizon_lock):
    """120 raw transforms whose size walks in and out of the dead zone at
    the drone config's settings (threshold 3, freeze 30)."""
    rng = np.random.default_rng(seed)
    raws = rng.normal(0, scale, (120, 3)).astype(np.float32)
    raws[:, 2] *= 0.02
    raws[20:60] *= 0.1                     # a calm stretch: freeze
    raws[70] *= 8.0                        # a jolt: exit
    st = dict(SMALL["stabilizer"], horizon_lock=horizon_lock)
    got = stream_drone.hf_chain(raws, st)
    jst = jhf.hf_init()
    frozen = 0
    for raw, g in zip(raws, got):
        jst, want = jhf.hf_apply(
            jst, jnp.asarray(raw),
            dead_zone_threshold=st["hf_dead_zone_threshold"],
            freeze_duration=st["hf_freeze_duration"],
            accumulator_decay=st["hf_motion_accumulator_decay"],
            shake_px=st["hf_shake_px"], rot_lp_alpha=st["hf_rot_lp_alpha"],
            horizon_lock=horizon_lock)
        np.testing.assert_allclose(g, np.asarray(want), rtol=0, atol=1e-6)
        frozen += int(jst.in_dead_zone)
    if scale < 3.0:
        assert 0 < frozen < len(raws)      # the dead zone was entered and left
    assert np.abs(got[:, :2] - raws[:, :2]).max() > 0.1     # it did change


@pytest.mark.parametrize("n,e", [(16, 1), (16, 12), (40, 0), (60, 45),
                                 (120, 100), (200, 185)])
def test_gaussian_emit_matches_jax(n, e):
    """sigma 15's 91 taps reflected at both ends of the path."""
    rng = np.random.default_rng(n + e)
    path = np.cumsum(rng.normal(0, 3, (n, 3)), axis=0).astype(np.float32)
    taps = stream_drone.gaussian_taps(15.0)
    np.testing.assert_allclose(
        taps, np.asarray(jfilters.gaussian_kernel(15.0)), rtol=0, atol=1e-7)
    ring = np.zeros((128, 3), np.float32)
    for i in range(max(0, n - 128), n):
        ring[i % 128] = path[i]
    want = jfilters.gaussian_filter_emit(jnp.asarray(ring), jnp.int32(n),
                                         jnp.int32(e), jnp.asarray(taps))
    got = stream_drone.gaussian_at(torch.from_numpy(path), n, e,
                                   torch.from_numpy(taps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("shift", [(0, 0), (3, -2), (-7, 5), (11, 0)])
def test_translation_prior_matches_jax(shift):
    """The analysis / 4 grays of the drone config (135 x 240), the second
    one shifted: the same (dx, dy), the shift itself."""
    world = _gray((200, 320), 3)
    prev = world[30:165, 40:280]
    dx, dy = shift
    curr = world[30 - dy:165 - dy, 40 - dx:280 - dx]
    got = stream_drone.translation_prior(torch.from_numpy(prev)[None],
                                         torch.from_numpy(curr)[None])[0]
    want = np.asarray(jlk.global_translation_prior(jnp.asarray(prev),
                                                   jnp.asarray(curr)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.float32(shift))


# --- the port against the reference ------------------------------------------

def test_stabilize_only_matches_the_reference():
    res = harness.run(small_manifest(), ROOT, CELL, SEED, 3.0, False, CPU)
    assert res["correct"], res["checks"]
    assert res["frames_compared"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("rich", [(), (4, 5)], ids=["starved",
                                                         "recovers"])
def test_starved_stream_selects_clahe_and_agrees(rich):
    """The port's starvation counter (read from its state after each call)
    against the reference's; CLAHE selected on the frames after it passes
    2; the delivered frames within the cell's limits at every 6th call."""
    n_calls = 40
    pool = starved_pool(8, SMALL["height"], SMALL["width"], rich)
    system = harness.load_module(
        harness.HERE / "systems" / "stabilize_only.py").System(
            SMALL, pool, frames.stream_seed(SEED), CPU)
    got, counters = {}, []
    for i in range(n_calls):
        out = system.call(i)
        if out is not None:
            got[i] = out
        counters.append(int(system.chain.state.stab.starvation_counter))
    calls = sorted(c for c in got if c % 6 == 0) + [n_calls - 1]
    ref_stream = stream_drone._Stream(SMALL, torch.from_numpy(pool),
                                      n_calls, lambda x: x)
    ref_stream.settle()
    assert counters == ref_stream.starved.tolist()
    selected = ref_stream.clahe_on[1:]
    assert selected.any()
    if rich:                       # the counter reset: CLAHE dropped
        assert not selected.all() and min(counters[8:]) == 0
    want = stream_drone.outputs(SMALL, torch.from_numpy(pool), n_calls, SEED,
                                calls)
    checks = compare.numbers({c: got[c] for c in calls}, want)
    limits = SMALL["correct_limits"]
    assert all(checks[k] <= limits[k] for k in limits), checks


# --- spans and counters ------------------------------------------------------

def _system():
    return harness.load_module(
        harness.HERE / "systems" / "stabilize_only.py").System(
            SMALL, _small_pool(), frames.stream_seed(SEED), CPU)


def _small_pool():
    return frames.make_pool(SEED, 8, 1, SMALL["height"], SMALL["width"],
                            CPU).numpy()


def _spans(calls, tmp_path) -> list:
    """(name, start, end) of the vstab.* spans of ``calls()`` under the
    profiler."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        calls()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e["name"].startswith("vstab.")]


def _parent(spans, i) -> str:
    """The name of the innermost span around ``spans[i]``."""
    _, s, e = spans[i]
    around = [x for j, x in enumerate(spans)
              if j != i and x[1] <= s and e <= x[2]]
    return max(around, key=lambda x: (x[1], -x[2]))[0]


def test_drone_spans_and_counters_per_frame(tmp_path):
    n_calls = 10
    system = _system()
    names = ("clahe_runs", "hf_steps", "crop_zoom_resamples")
    before = [telemetry.counters().get(k, 0) for k in names]
    traced = []
    spans = _spans(lambda: traced.extend(system.call(i)
                                         for i in range(n_calls)), tmp_path)
    counted = [telemetry.counters().get(k, 0) - b
               for k, b in zip(names, before)]
    got = [n for n, _, _ in spans]
    # The first call only detects; every later one analyzes and emits
    # (the emit gated on the device while the look-ahead fills).
    assert got.count("vstab.clahe") == got.count("vstab.hf") == n_calls - 1
    assert got.count("vstab.crop_zoom") == n_calls - 1
    assert counted == [n_calls - 1] * 3
    for i, name in enumerate(got):
        want = {"vstab.clahe": "vstab.step", "vstab.hf": "vstab.step",
                "vstab.crop_zoom": "vstab.emit"}.get(name)
        if want is not None:
            assert _parent(spans, i) == want, (name, _parent(spans, i))
    system = _system()
    plain = [system.call(i) for i in range(n_calls)]
    assert [o is None for o in traced] == [o is None for o in plain]
    assert sum(o is not None for o in plain) >= 5
    for a, b in zip(traced, plain):
        if a is not None:
            np.testing.assert_array_equal(a, b)
