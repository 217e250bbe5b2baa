"""The readers of the program's spans (``benchmark_torch/spans.py``) on
hand-built traces, and a traced run of the small chain on the CPU that
reports them.

    python -m pytest benchmark_torch/tests -q
"""

import json
import random
from types import SimpleNamespace

import pytest
import torch

from benchmark_torch import harness, spans
from benchmark_torch.harness import HERE, load_module
from benchmark_torch.tests.test_harness import ROOT, small_manifest
from benchmark_torch.trace import Trace
from video_stab_tpu_torch.ops.features import NMS_ROUNDS_PER_SYNC

TRACED_CALLS = json.loads(
    (HERE / "traffic" / "saturated.json").read_text())["traced_calls"]
READERS = ("upload_ms_per_frame", "download_ms_per_frame",
           "step_host_ms_per_frame", "step_idle_share",
           "nms_rounds_per_frame")


def hand_trace(with_spans=True, with_device=True) -> Trace:
    """A 1000 us window: one call of the program, the device busy over
    [50, 100], [200, 300] and [720, 860]."""
    tr = Trace(start_us=0.0, end_us=1000.0)
    if with_device:
        tr.device = [("k1", "kernel", 50.0, 100.0),
                     ("k2", "kernel", 200.0, 260.0),
                     ("k3", "kernel", 250.0, 300.0),
                     ("Memcpy DtoH", "gpu_memcpy", 720.0, 860.0)]
        tr.launches = 3
    tr.host = [("bench.call", -5.0, 905.0), ("aten::copy_", 15.0, 90.0)]
    if with_spans:
        tr.host += [("vstab.process", 0.0, 900.0),
                    ("vstab.upload", 10.0, 110.0),
                    ("vstab.step", 110.0, 700.0),
                    ("vstab.detect", 290.0, 530.0),
                    ("vstab.nms_read", 300.0, 350.0),
                    ("vstab.nms_read", 500.0, 520.0),
                    ("vstab.download", 700.0, 880.0)]
    return tr


def reading(tr: Trace, active=2, frames_per_call=4) -> harness.Reading:
    return harness.Reading(cfg={}, trace=tr,
                           tracer=SimpleNamespace(active=active),
                           frames_per_call=frames_per_call)


def test_readers_give_the_hand_counts():
    """8 frames (2 calls of 4): upload 100 us, download 180 us, step 590
    us of which 490 idle (the device busy 200-300), 2 NMS reads."""
    ctx = reading(hand_trace())
    assert spans.upload_ms_per_frame(ctx) == pytest.approx(0.1 / 8)
    assert spans.download_ms_per_frame(ctx) == pytest.approx(0.18 / 8)
    assert spans.step_host_ms_per_frame(ctx) == pytest.approx(0.59 / 8)
    assert spans.step_idle_share(ctx) == pytest.approx(49.0)
    assert spans.nms_rounds_per_frame(ctx) == pytest.approx(
        2 * NMS_ROUNDS_PER_SYNC / 8)


@pytest.mark.parametrize("name", READERS)
def test_each_metric_file_reads_its_function(name):
    mod = load_module(HERE / "metrics" / f"{name}.throughput.py")
    assert mod.read is getattr(spans, name)


def test_idle_by_span_puts_each_gap_under_the_innermost_span():
    got = dict(spans.idle_by_span(hand_trace()))
    assert got == pytest.approx({
        "vstab.process": 30e-6, "vstab.upload": 50e-6,
        "vstab.step": 260e-6, "vstab.detect": 160e-6,
        "vstab.nms_read": 70e-6, "vstab.download": 40e-6,
        spans.OUTSIDE: 100e-6})
    assert sum(got.values()) == pytest.approx(
        hand_trace().window_s - hand_trace().busy_s())


@pytest.mark.parametrize("seed", range(6))
def test_idle_by_span_adds_up_to_the_idle_time(seed):
    """Random nested spans over random device intervals, some past the
    window's edges."""
    rng = random.Random(seed)
    tr = Trace(start_us=100.0, end_us=5100.0)
    t = 50.0
    while t < 5200.0:
        d = rng.uniform(1.0, 80.0)
        tr.device.append(("k", "kernel", t, t + d))
        t += d + rng.choice([0.0, rng.uniform(0.0, 120.0)])
    t = 80.0
    while t < 5200.0:
        d = rng.uniform(100.0, 700.0)
        tr.host.append(("vstab.process", t, t + d))
        a = t + rng.uniform(0.0, d / 2)
        tr.host.append(("vstab.step", a, a + rng.uniform(0.0, d / 3)))
        tr.host.append(("aten::copy_", a, a + 5.0))
        t += d + rng.uniform(0.0, 50.0)
    idle = tr.window_s - tr.busy_s()
    got = spans.idle_by_span(tr)
    assert sum(s for _, s in got) == pytest.approx(idle, rel=1e-9)
    assert {n for n, _ in got} <= {"vstab.process", "vstab.step",
                                   spans.OUTSIDE}
    assert [s for _, s in got] == sorted((s for _, s in got), reverse=True)


def test_step_idle_share_needs_device_records():
    assert spans.step_idle_share(reading(hand_trace(with_device=False))) \
        is None
    assert spans.step_idle_share(reading(hand_trace())) is not None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_spans_reads_nothing(name):
    """The trace of a program without spans, or no trace: None, no
    raise."""
    assert getattr(spans, name)(reading(hand_trace(with_spans=False))) \
        is None
    assert getattr(spans, name)(reading(None)) is None


def test_small_chain_reports_the_span_metrics():
    """A traced run of the small chain on the CPU reports the four span
    metrics that need no device records, with the step's host time the
    largest, and no ``step_idle_share`` (no device)."""
    res = harness.run(small_manifest(), ROOT, "chain_1080p.saturated",
                      2 ** 31 + 9, 1.0, True, torch.device("cpu"))
    assert res["correct"]
    m = {k.split(".")[0]: v["value"] for k, v in res["metrics"].items()}
    for name in ("upload_ms_per_frame", "download_ms_per_frame",
                 "step_host_ms_per_frame", "nms_rounds_per_frame"):
        assert m[name] > 0.0, name
    assert "step_idle_share" not in m
    assert m["step_host_ms_per_frame"] > m["upload_ms_per_frame"] \
        + m["download_ms_per_frame"]
    # GFTT on every second frame, each at least one read of 8 rounds.
    assert m["nms_rounds_per_frame"] >= NMS_ROUNDS_PER_SYNC / 2
    reads = m["nms_rounds_per_frame"] * TRACED_CALLS / NMS_ROUNDS_PER_SYNC
    assert reads == pytest.approx(round(reads))
