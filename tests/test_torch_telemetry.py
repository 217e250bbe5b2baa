"""The port's spans and counters (``video_stab_tpu_torch/utils/telemetry.py``)
on the CPU, at small frames.

Held: under ``torch.profiler`` a ``ProcessingChain`` step, a
``MultiStreamStabilizer`` tick and a ``Stabilizer.stabilize`` call write
the ``vstab.*`` spans into the exported chrome trace, each inside the
span the per-frame path puts it in (upload, step and download inside the
call; the stages inside the step; the NMS read inside the detection);
without a profiler ``trace`` never opens a ``record_function``; the NMS
counters move together; the app's snapshot keeps its keys; ``vstab-torch
profile`` writes the spans; the counter registry loses no update under
threads.
"""

import json
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from video_stab_tpu_torch import cli  # noqa: E402
from video_stab_tpu_torch.core.chain import ProcessingChain  # noqa: E402
from video_stab_tpu_torch.core.params import (  # noqa: E402
    EnhancerParams,
    ModeParams,
    RollCorrectionParams,
    StabilizerParams,
)
from video_stab_tpu_torch.core.stabilizer import Stabilizer  # noqa: E402
from video_stab_tpu_torch.ops.features import (  # noqa: E402
    NMS_ROUNDS_PER_SYNC,
    good_features_to_track,
)
from video_stab_tpu_torch.parallel import MultiStreamStabilizer  # noqa: E402
from video_stab_tpu_torch.utils import telemetry  # noqa: E402

H, W = 96, 128
CPU = ModeParams(use_cuda=False)
SMALL = StabilizerParams(smoothing_radius=3, analysis_width=64,
                         analysis_height=48, max_corners=32,
                         ransac_hypotheses=32, redetect_interval=2)
STAGES = ("vstab.lk", "vstab.ransac", "vstab.emit", "vstab.detect")


def _frames(n, streams=None, seed=0):
    """A smooth random world seen through a few pixels of jitter: (n, H,
    W, 3) uint8, or (n, streams, H, W, 3)."""
    rng = np.random.default_rng(seed)
    pad = 8
    world = rng.random((H + 2 * pad, W + 2 * pad)).astype(np.float32)
    for axis in (0, 1):
        world = (world + np.roll(world, 1, axis) + np.roll(world, -1, axis)
                 ) / 3.0
    world = (255.0 * (world - world.min()) / np.ptp(world)).astype(np.uint8)
    shape = (n,) if streams is None else (n, streams)
    out = np.empty(shape + (H, W, 3), np.uint8)
    for idx in np.ndindex(*shape):
        dx, dy = rng.integers(-4, 5, 2)
        f = world[pad + dy:pad + dy + H, pad + dx:pad + dx + W]
        out[idx] = np.stack([f, np.roll(f, 1, 0), 255 - f], axis=-1)
    return out


def _spans(calls, tmp_path) -> list:
    """(name, start, end) of the vstab.* spans in the chrome trace of
    ``calls()`` run under the profiler."""
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


def _parents(spans) -> list:
    """(name, the name of the innermost span that encloses it, or None)."""
    out = []
    for i, (name, s, e) in enumerate(spans):
        around = [x for j, x in enumerate(spans)
                  if j != i and x[1] <= s and e <= x[2]]
        parent = max(around, key=lambda x: (x[1], -x[2]))[0] \
            if around else None
        out.append((name, parent))
    return out


def _chain():
    return ProcessingChain(
        ModeParams(use_cuda=False, enhancer_enabled=True,
                   roll_correction_enabled=True, stabilizer_enabled=True),
        EnhancerParams(brightness=5.0, contrast=1.1, gamma=0.9),
        RollCorrectionParams(hough_threshold=30), SMALL)


def _warm(call, frames):
    """Call until a frame is delivered; the index of the next frame."""
    for i, f in enumerate(frames):
        if call(f) is not None:
            return i + 1
    raise AssertionError("no frame delivered")


@pytest.mark.parametrize("wrapper", ["chain", "multistream", "stabilizer"])
def test_a_call_writes_its_spans_nested(wrapper, tmp_path):
    """Two delivering calls (one re-detects) under the profiler: upload,
    step and download inside the call's span, the stages inside the step,
    the NMS read inside the detection."""
    if wrapper == "chain":
        obj, top = _chain(), "vstab.process"
        call, frames = obj.process, _frames(12)
    elif wrapper == "multistream":
        obj, top = MultiStreamStabilizer(SMALL, 2, mode=CPU), "vstab.tick"
        call, frames = obj.stabilize_batch, _frames(12, streams=2)
    else:
        obj, top = Stabilizer(SMALL, mode=CPU), "vstab.process"
        call, frames = obj.stabilize, _frames(12)
    i = _warm(call, frames)
    outs = []
    spans = _spans(lambda: outs.extend(call(f) for f in frames[i:i + 2]),
                   tmp_path)
    assert all(o is not None for o in outs)
    parents = _parents(spans)
    names = [n for n, _ in parents]
    assert names.count(top) == 2
    want = {top: None, "vstab.upload": top, "vstab.step": top,
            "vstab.download": top, "vstab.lk": "vstab.step",
            "vstab.ransac": "vstab.step", "vstab.emit": "vstab.step",
            "vstab.detect": "vstab.step", "vstab.nms_read": "vstab.detect"}
    if wrapper == "chain":
        want.update({"vstab.enhance": "vstab.step",
                     "vstab.roll": "vstab.step"})
    assert set(names) == set(want), sorted(set(names))
    for name, parent in parents:
        assert parent == want[name], (name, parent)
    for name in ("vstab.upload", "vstab.step", "vstab.download", "vstab.lk",
                 "vstab.ransac", "vstab.emit"):
        assert names.count(name) == 2, name
    assert names.count("vstab.detect") == 1


def test_no_record_function_without_a_profiler(monkeypatch):
    """With no profiler recording, a span is the shared null context and
    the per-frame path never opens a ``record_function``."""
    def refuse(*a, **k):
        raise AssertionError("record_function opened")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert telemetry.trace("vstab.x") is telemetry.trace("vstab.y")
    st = Stabilizer(SMALL, mode=CPU)
    delivered = [st.stabilize(f) for f in _frames(8)]
    assert any(d is not None for d in delivered)
    assert st.flush() is not None


def test_nms_rounds_are_the_rounds_per_read_times_the_reads():
    before = telemetry.counters()
    gray = torch.from_numpy(_frames(1)[0, :, :, 0].astype(np.float32))
    _, mask = good_features_to_track(gray, max_corners=32,
                                     min_distance=4.0)
    after = telemetry.counters()
    reads = after["nms_reads"] - before.get("nms_reads", 0)
    rounds = after["nms_rounds"] - before.get("nms_rounds", 0)
    assert bool(mask.any()) and reads >= 1
    assert rounds == NMS_ROUNDS_PER_SYNC * reads


def test_counters_is_a_copy():
    snap = telemetry.counters()
    snap["nms_reads"] = -1
    assert telemetry.counters().get("nms_reads", 0) != -1


def test_counter_loses_no_update_under_threads():
    """Eight threads adding to one counter with a short switch interval:
    the total is every add."""
    name = "test_counter_loses_no_update_under_threads"
    n_threads, adds = 8, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [telemetry.count(name, 3) for _ in range(adds)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert telemetry.counters()[name] == 3 * adds * n_threads


def test_metrics_snapshot_keeps_its_keys():
    m = telemetry.Metrics()
    m.inc("frames_out")
    m.set("n_tracked", 12)
    with m.timer.stage("fused_chain"):
        pass
    snap = m.snapshot()
    assert set(snap) == {"counters", "gauges", "stages"}
    assert snap["counters"] == {"frames_out": 1}
    assert snap["gauges"] == {"n_tracked": 12.0}
    assert snap["stages"]["fused_chain"]["n"] == 1


def test_profile_command_writes_the_spans(tmp_path, capsys):
    assert cli.main(["profile", "--device", "cpu", "--frames", "2",
                     "--width", "128", "--height", "96", "--logdir",
                     str(tmp_path)]) == 0
    out = capsys.readouterr().out
    path = json.loads(out[out.rindex("{"):])["trace"]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    assert {"vstab.lk", "vstab.step", "vstab.upload"} <= names
