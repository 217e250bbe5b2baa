"""The batched drone deployment's comparison (``drone_hf_8x1080p``), at a
size the CPU holds: the plain reference ``reference/stream_drone_batch.py``
is, stream by stream, the one-camera drone reference replayed alone with
that stream's draws; it refuses what it does not model; and a run whose
batched step is broken underneath in each way a batch of drone streams
can break reads ``correct`` false: stream 0's HF state used for every
stream, two streams' outputs swapped, the crop window a pixel off, the
crop-and-zoom resample in bfloat16; and stream 0's prior given to every
stream, on frames where the prior matters.

The cell's own frames (``frames.make_pool``: a fine texture, +-8 px of
jitter) never pass the prior's confidence gate: at analysis / 4 the
texture aliases, the correlation peak's z-score stays under 4 and the
prior is 0 for every frame, so a wrong prior changes nothing there. The
prior's fault is planted on ``large_motion_pool``'s frames instead: a
smooth world seen through +-40 px of jitter (at 360 x 640), where LK
without the right start loses the motion.

    python -m pytest benchmark_torch/tests -q
"""

import json

import pytest
import torch

from benchmark_torch import compare, frames, harness
from benchmark_torch.reference import stream_drone, stream_drone_batch
from benchmark_torch.tests.test_harness import ROOT, small_manifest

CONFIG = "drone_hf_8x1080p"
CELL = f"{CONFIG}.saturated"
SEED = 2 ** 31 + 11
CPU = torch.device("cpu")
SMALL = json.loads(
    (harness.HERE / "tests" / f"{CONFIG}_small.json").read_text())


def test_each_stream_is_the_one_stream_replay():
    """Stream s of the batch reference is ``stream_drone`` alone on
    ``pool[:, s:s + 1]`` with stream seed ``stream_seed(seed) + s``; the
    streams differ from one another."""
    n_calls, calls = 24, [6, 15, 23]
    pool = frames.make_pool(SEED, 12, SMALL["streams"], SMALL["height"],
                            SMALL["width"], CPU)
    got = stream_drone_batch.outputs(SMALL, pool, n_calls, SEED, calls)
    one = stream_drone_batch.one_stream(SMALL)
    for s in range(SMALL["streams"]):
        want = stream_drone.outputs(one, pool[:, s:s + 1], n_calls,
                                    frames.stream_seed(SEED) + s, calls)
        for c in calls:
            assert got[c].shape == (SMALL["streams"], SMALL["height"],
                                    SMALL["width"], 3)
            assert torch.equal(got[c][s:s + 1], want[c]), (s, c)
    assert not torch.equal(got[calls[-1]][0], got[calls[-1]][1])


@pytest.mark.parametrize("change", [
    ("system", "stabilize_only"),
    ("streams", 0),
    ("stabilizer.drone_high_freq_mode", False),
    ("stabilizer.smoothing_method", "box"),
    ("stabilizer.crop_n_zoom", False),
    ("stabilizer.enable_virtual_canvas", True),
    ("roll", {"scale_factor": 0.25}),
], ids=lambda c: f"{c[0]}={c[1]}")
def test_refuses_what_it_does_not_model(change):
    cfg = json.loads(json.dumps(SMALL))
    stream_drone_batch.check(cfg)
    key, value = change
    group, _, name = key.rpartition(".")
    (cfg[group] if group else cfg)[name] = value
    with pytest.raises(ValueError):
        stream_drone_batch.check(cfg)
    pool = torch.zeros((2, 3, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        stream_drone_batch.outputs(cfg, pool, 40, 5, [20])


def test_refuses_seeds_past_the_stream_seeds_range():
    pool = torch.zeros((2, 3, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="stream seeds"):
        stream_drone_batch.outputs(SMALL, pool, 40, 2 ** 62 - 2, [20])


# --- planted faults ----------------------------------------------------------
# Each takes a ``pytest.MonkeyPatch`` and breaks the batched step where it
# is produced.

def hf_state_of_stream_0(mp):
    """Every stream's HF chain runs from stream 0's state."""
    from video_stab_tpu_torch.core import stabilizer
    from video_stab_tpu_torch.motion.hf import HFState
    real = stabilizer.hf_apply

    def hf(state, raw, **kw):
        if raw.dim() == 2:
            state = HFState(*(f[:1].expand_as(f).clone() for f in state))
        return real(state, raw, **kw)
    mp.setattr(stabilizer, "hf_apply", hf)


def large_motion_pool(n: int, n_streams: int, h: int, w: int, device,
                      seed: int = 3, sigma: float = 8.0,
                      jitter: int = 40) -> torch.Tensor:
    """(n, n_streams, h, w, 3) u8 frames of a smooth world per stream
    (uniform noise blurred at ``sigma`` px) seen through +-``jitter`` px:
    shifts the translation prior measures and LK alone does not follow."""
    g = frames.generator(seed, device)
    pad = jitter
    world = torch.rand((n_streams, h + 2 * pad, w + 2 * pad), generator=g,
                       device=device)
    r = int(3 * sigma)
    taps = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    kern = torch.exp(-0.5 * (taps / sigma) ** 2)
    world = frames._blur(frames._blur(world, 2, kern / kern.sum()), 1,
                         kern / kern.sum())
    lo = world.amin(dim=(1, 2), keepdim=True)
    hi = world.amax(dim=(1, 2), keepdim=True)
    world = (world - lo) / (hi - lo) * 255.0
    jit = torch.randint(-jitter, jitter + 1, (n, n_streams, 2), generator=g,
                        device=device).cpu().tolist()
    out = torch.empty((n, n_streams, h, w, 3), dtype=torch.uint8,
                      device=device)
    for i in range(n):
        for s in range(n_streams):
            dx, dy = jit[i][s]
            f = world[s, pad + dy:pad + dy + h, pad + dx:pad + dx + w]
            out[i, s] = torch.stack([f, torch.roll(f, 1, 0), 255.0 - f],
                                    dim=-1).clamp(0, 255).to(torch.uint8)
    return out


def run_on_pool(cfg: dict, pool: torch.Tensor, seed: int, n_calls: int,
                calls, device) -> dict:
    """The multi-stream system on ``pool`` for ``n_calls`` calls against
    the batch reference at ``calls``: ``compare.numbers``'s checks."""
    system = harness.load_module(
        harness.HERE / "systems" / "multistream.py").System(
            cfg, pool.cpu().numpy(), frames.stream_seed(seed), device)
    got = {}
    for i in range(n_calls):
        out = system.call(i)
        if i in calls:
            got[i] = out
    system.close()
    want = stream_drone_batch.outputs(cfg, pool, n_calls, seed, calls)
    return compare.numbers(got, want)


def prior_of_stream_0(mp):
    """Every stream's LK starts from stream 0's translation prior."""
    from video_stab_tpu_torch.core import stabilizer
    real = stabilizer.global_translation_prior

    def prior(prev, curr, *a, **kw):
        g = real(prev, curr, *a, **kw)
        return g[:1].expand_as(g).clone() if g.dim() == 2 else g
    mp.setattr(stabilizer, "global_translation_prior", prior)


def outputs_swapped(mp):
    """Streams 0 and 1 deliver each other's frames."""
    from video_stab_tpu_torch.parallel import multistream
    real = multistream.batched_step_metrics_fn

    def step(params, state, frames_u8, *a, **kw):
        state, out, ready, metrics = real(params, state, frames_u8, *a,
                                          **kw)
        order = torch.arange(out.shape[0], device=out.device)
        order[:2] = torch.tensor([1, 0])
        return state, out.index_select(0, order), ready, metrics
    mp.setattr(multistream, "batched_step_metrics_fn", step)


def crop_a_pixel_off(mp):
    """The crop window starts a row lower."""
    from video_stab_tpu_torch.core import stabilizer
    real = stabilizer._crop_zoom

    def crop_zoom(params, warped):
        return real(params, torch.roll(warped, -1, dims=-3))
    mp.setattr(stabilizer, "_crop_zoom", crop_zoom)


def zoom_in_bfloat16(mp):
    """The crop-and-zoom resample's taps applied in bfloat16."""
    from video_stab_tpu_torch.core import stabilizer
    from video_stab_tpu_torch.ops import resize

    def crop_zoom(params, warped):
        b = params.border_pad
        h, w = warped.shape[-3:-1]
        x = warped[..., b:h - b, b:w - b, :].to(torch.bfloat16)
        for n_out, dim in ((h, x.dim() - 3), (w, x.dim() - 2)):
            idx, wts = resize._taps_on("resize", x.shape[dim], n_out,
                                       x.device)
            shape = [1] * x.dim()
            shape[dim] = n_out
            out = None
            for t in range(idx.shape[0]):
                term = x.index_select(dim, idx[t]) \
                    * wts[t].to(torch.bfloat16).view(shape)
                out = term if out is None else out + term
            x = out
        return stabilizer.saturate_u8(x.float())
    mp.setattr(stabilizer, "_crop_zoom", crop_zoom)


FAULTS = (hf_state_of_stream_0, outputs_swapped, crop_a_pixel_off,
          zoom_in_bfloat16)


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_broken_batch_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = harness.run(small_manifest(), ROOT, CELL, SEED, 0.5, False,
                      CPU)
    assert not res["correct"], res["checks"]


def test_wrong_prior_is_not_correct_where_the_prior_matters(monkeypatch):
    """On large_motion_pool's frames the program agrees with the reference
    (the prior measures each stream's shift on most frames) and stream
    0's prior given to every stream does not."""
    pool = large_motion_pool(12, SMALL["streams"], SMALL["height"],
                             SMALL["width"], CPU)
    n_calls, calls = 24, [8, 14, 20, 23]
    limits = SMALL["correct_limits"]
    ok = run_on_pool(SMALL, pool, SEED, n_calls, calls, CPU)
    assert all(ok[k] <= limits[k] for k in limits), ok
    prior_of_stream_0(monkeypatch)
    bad = run_on_pool(SMALL, pool, SEED, n_calls, calls, CPU)
    assert any(bad[k] > limits[k] for k in limits), bad
