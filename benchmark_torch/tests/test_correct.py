"""The comparison that decides ``correct``, at a size the CPU holds: the
program as it is passes; the control (the reference computed in bfloat16
in the program's place) fails; and so does a run whose timed path is
broken underneath in each way the cell can break: a step that returns its
state unchanged, an answer altered where it is produced, with the
homography model its perspective terms dropped in the estimate or in the
emit, and, with several cameras, half of the batch left out.

    python -m pytest benchmark_torch/tests -q
"""

import pytest
import torch

from benchmark_torch import control, harness
from benchmark_torch.tests.test_harness import MANIFEST, ROOT, small_manifest

SEED = 2 ** 31 + 11
CPU = torch.device("cpu")


def run(cell, seconds=1.0):
    return harness.run(small_manifest(), ROOT, cell, SEED, seconds, False,
                       CPU)


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
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


def _emit_warp_altered(monkeypatch):
    """The homography emit's projective warp (K2) off by a pixel."""
    from video_stab_tpu_torch.core import stabilizer
    real = stabilizer.warp_perspective_fast

    def warp(img, h, *a, **kw):
        return torch.roll(real(img, h, *a, **kw), 1, dims=1)
    monkeypatch.setattr(stabilizer, "warp_perspective_fast", warp)


def _roll_rotation_altered(monkeypatch):
    """The two-pass roll's whole-frame rotation (K1) off by a pixel."""
    from video_stab_tpu_torch.core import chain
    real = chain.warp_affine_u8

    def warp(img, m, *a, **kw):
        return torch.roll(real(img, m, *a, **kw), 1, dims=1)
    monkeypatch.setattr(chain, "warp_affine_u8", warp)


def _perspective_dropped(monkeypatch):
    """K2 warps with the correction's perspective row zeroed: an affine
    emit where the model is projective."""
    from video_stab_tpu_torch.core import stabilizer
    real = stabilizer.warp_perspective_fast

    def warp(img, h, *a, **kw):
        h = h.clone()
        h[..., 2, :2] = 0.0
        return real(img, h, *a, **kw)
    monkeypatch.setattr(stabilizer, "warp_perspective_fast", warp)


def _estimate_affine(monkeypatch):
    """The 8-DOF estimate cut to its affine part: the perspective entries
    of each frame's H zeroed before the log."""
    from video_stab_tpu_torch.core import stabilizer
    real = stabilizer.estimate_homography_ransac

    def estimate(*a, **kw):
        h, ok, inliers = real(*a, **kw)
        h = h.clone()
        h[..., 2, :2] = 0.0
        return h, ok, inliers
    monkeypatch.setattr(stabilizer, "estimate_homography_ransac", estimate)


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
    ("chain_homography_1080p.saturated", _state_unchanged),
    ("chain_homography_1080p.saturated", _emit_warp_altered),
    ("chain_homography_1080p.saturated", _roll_rotation_altered),
    ("chain_homography_1080p.saturated", _perspective_dropped),
    ("chain_homography_1080p.saturated", _estimate_affine),
    ("multicam_8x1080p.saturated", _batch_state_unchanged),
    ("multicam_8x1080p.saturated", _batch_answer_altered),
    ("multicam_8x1080p.saturated", _half_batch_left_out),
], ids=lambda x: getattr(x, "__name__", x))
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = run(cell, seconds=0.5)
    assert not res["correct"], res["checks"]
