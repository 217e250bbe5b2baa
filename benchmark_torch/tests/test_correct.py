"""The comparison that decides ``correct``, at a size the CPU holds: the
program as it is passes; the control (the reference computed in bfloat16
in the program's place) fails; and so does a run whose timed path is
broken underneath in each way the cell can break: a step that returns its
state unchanged, an answer altered where it is produced, and, with
several cameras, half of the batch left out.

    python -m pytest benchmark_torch/tests -q
"""

import pytest
import torch

from benchmark_torch import control, harness
from benchmark_torch.tests.test_harness import ROOT, small_manifest

SEED = 2 ** 31 + 11
CPU = torch.device("cpu")


def run(cell, seconds=1.0):
    return harness.run(small_manifest(), ROOT, cell, SEED, seconds, False,
                       CPU)


@pytest.mark.parametrize("cell", ["chain_1080p.saturated",
                                  "multicam_8x1080p.saturated"])
def test_program_passes_and_control_fails(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    cfg = harness.resolve(small_manifest(), cell, ROOT).config
    got = control.control_numbers(cfg, SEED, res["calls_made"],
                                  res["sampled_calls"], CPU)
    limits = cfg["correct_limits"]
    assert any(got[k] > limits[k] for k in limits), got


def _state_unchanged(monkeypatch):
    from video_stab_tpu_torch.core import chain
    real = chain.chain_gated_step_fn

    def step(params, state, frame, *a, **kw):
        _, out, ready = real(params, state, frame, *a, **kw)
        return state, out, ready
    monkeypatch.setattr(chain, "chain_gated_step_fn", step)


def _answer_altered(monkeypatch):
    from video_stab_tpu_torch.core import stabilizer
    real = stabilizer.warp_affine_u8

    def warp(img, m, *a, **kw):
        return torch.roll(real(img, m, *a, **kw), 1, dims=1)
    monkeypatch.setattr(stabilizer, "warp_affine_u8", warp)


def _batch_state_unchanged(monkeypatch):
    from video_stab_tpu_torch.parallel import multistream
    real = multistream.batched_step_metrics_fn

    def step(params, state, frames, *a, **kw):
        _, out, ready, metrics = real(params, state, frames, *a, **kw)
        return state, out, ready, metrics
    monkeypatch.setattr(multistream, "batched_step_metrics_fn", step)


def _batch_answer_altered(monkeypatch):
    from video_stab_tpu_torch.core import stabilizer
    real = stabilizer.warp_affine_u8_batched

    def warp(ring, slots, m, *a, **kw):
        return torch.roll(real(ring, slots, m, *a, **kw), 1, dims=2)
    monkeypatch.setattr(stabilizer, "warp_affine_u8_batched", warp)


def _half_batch_left_out(monkeypatch):
    from video_stab_tpu_torch.parallel import multistream
    real = multistream.batched_step_metrics_fn

    def step(params, state, frames, *a, **kw):
        state, out, ready, metrics = real(params, state, frames, *a, **kw)
        out = out.clone()
        out[out.shape[0] // 2:] = 0
        return state, out, ready, metrics
    monkeypatch.setattr(multistream, "batched_step_metrics_fn", step)


@pytest.mark.parametrize("cell,fault", [
    ("chain_1080p.saturated", _state_unchanged),
    ("chain_1080p.saturated", _answer_altered),
    ("multicam_8x1080p.saturated", _batch_state_unchanged),
    ("multicam_8x1080p.saturated", _batch_answer_altered),
    ("multicam_8x1080p.saturated", _half_batch_left_out),
], ids=lambda x: getattr(x, "__name__", x))
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = run(cell, seconds=0.5)
    assert not res["correct"], res["checks"]
