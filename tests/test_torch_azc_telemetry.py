"""The spans and the counter of auto zoom-crop and of I420 delivery in the
port's chain (``core/chain.py``, ``core/autozoomcrop.py``), on the CPU at
small frames, with the chain configured as the live restream deployment
runs it: the +-70 deg roll band, auto zoom-crop, Kalman smoothing, I420
delivered, pipelined.

Held: under ``torch.profiler`` every frame writes one ``vstab.azc`` span
inside ``vstab.roll`` and every analyze step one ``vstab.i420`` inside
``vstab.step``; each of ``interior_rect``'s host reads is one
``vstab.azc_read`` span inside ``vstab.azc``, and the reads, the
``azc_rect_reads`` counter and ``RECT_READS`` move together (frames with
a black corner, so that the shrink loop reads more than once a frame); the
delivered frames are the same bit for bit with the profiler recording
and without. The kernels' counters: each launch of K8 (the content mask)
and of K7 (the shrink loop) counts once as ``azc_mask_kernel`` and
``azc_rect_kernel``, beside ``MASK_KERNEL_LAUNCHES`` and
``RECT_KERNEL_LAUNCHES``, and a refused launch counts nothing (the
wrappers driven here by a stand-in for the kernel library; the card's
tests count them on the chain).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from video_stab_tpu_torch.core import autozoomcrop  # noqa: E402
from video_stab_tpu_torch.core.chain import ProcessingChain  # noqa: E402
from video_stab_tpu_torch.core.params import (  # noqa: E402
    AutoZoomCropParams,
    EnhancerParams,
    ModeParams,
    RollCorrectionParams,
    StabilizerParams,
)
from video_stab_tpu_torch.kernels import _lib  # noqa: E402
from video_stab_tpu_torch.kernels import azc as kazc  # noqa: E402
from video_stab_tpu_torch.utils import telemetry  # noqa: E402

H, W = 96, 128
N_FRAMES = 10
CORNER = 60        # a black corner: more than one read a frame


def _frames(seed=0):
    """(N_FRAMES, H, W, 3) uint8: a smooth random world seen through a few
    pixels of jitter, black where x + y < CORNER (the corner a rotation
    leaves)."""
    rng = np.random.default_rng(seed)
    pad = 8
    world = rng.random((H + 2 * pad, W + 2 * pad)).astype(np.float32)
    for axis in (0, 1):
        world = (world + np.roll(world, 1, axis) + np.roll(world, -1, axis)
                 ) / 3.0
    world = (255.0 * (world - world.min()) / np.ptp(world)).astype(np.uint8)
    out = np.empty((N_FRAMES, H, W, 3), np.uint8)
    for i in range(N_FRAMES):
        dx, dy = rng.integers(-4, 5, 2)
        f = world[pad + dy:pad + dy + H, pad + dx:pad + dx + W]
        out[i] = np.stack([f, np.roll(f, 1, 0), 255 - f], axis=-1)
    yy, xx = np.mgrid[:H, :W]
    out[:, yy + xx < CORNER] = 0
    return out


def _chain():
    return ProcessingChain(
        ModeParams(use_cuda=False, enhancer_enabled=True,
                   roll_correction_enabled=True, stabilizer_enabled=True),
        EnhancerParams(brightness=5.0, contrast=1.1, gamma=0.9),
        RollCorrectionParams(hough_threshold=30, angle_filter_min=-70.0,
                             angle_filter_max=70.0),
        StabilizerParams(smoothing_radius=3, analysis_width=64,
                         analysis_height=48, max_corners=32,
                         ransac_hypotheses=32, redetect_interval=2,
                         smoothing_method="kalman"),
        azc=AutoZoomCropParams(enabled=True, keep_input_size=True),
        pipelined=True, output_format="i420")


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


def _parent(spans, i) -> str:
    """The name of the innermost span around ``spans[i]``."""
    _, s, e = spans[i]
    around = [x for j, x in enumerate(spans)
              if j != i and x[1] <= s and e <= x[2]]
    return max(around, key=lambda x: (x[1], -x[2]))[0]


def test_azc_and_i420_spans_and_reads_per_frame(tmp_path):
    frames = _frames()
    chain = _chain()
    outs = []
    counted = telemetry.counters().get("azc_rect_reads", 0)
    rect_reads = autozoomcrop.RECT_READS
    spans = _spans(lambda: outs.extend(chain.process(f) for f in frames),
                   tmp_path)
    counted = telemetry.counters()["azc_rect_reads"] - counted
    rect_reads = autozoomcrop.RECT_READS - rect_reads
    names = [n for n, _, _ in spans]
    # The first call initializes the stream and converts nothing; every
    # later call runs an analyze step and its delivery's I420 conversion.
    assert names.count("vstab.azc") == N_FRAMES
    assert names.count("vstab.i420") == N_FRAMES - 1
    reads = names.count("vstab.azc_read")
    assert reads == counted == rect_reads
    assert reads > N_FRAMES
    for i, name in enumerate(names):
        want = {"vstab.azc": "vstab.roll", "vstab.azc_read": "vstab.azc",
                "vstab.i420": "vstab.step"}.get(name)
        if want is not None:
            assert _parent(spans, i) == want, (name, _parent(spans, i))
    delivered = [o for o in outs if o is not None]
    assert delivered and delivered[0].shape == (H * 3 // 2, W)


def test_outputs_are_the_same_with_and_without_recording(tmp_path):
    frames = _frames(seed=1)
    traced, plain = [], []
    chain = _chain()
    _spans(lambda: traced.extend(chain.process(f) for f in frames),
           tmp_path)
    traced.append(chain.drain())
    chain = _chain()
    plain.extend(chain.process(f) for f in frames)
    plain.append(chain.drain())
    assert [o is None for o in traced] == [o is None for o in plain]
    assert sum(o is not None for o in plain) >= 3
    for a, b in zip(traced, plain):
        if a is not None:
            np.testing.assert_array_equal(a, b)


class _Library:
    """Stands in for the built kernel library: each entry records its call
    and returns ``rc``."""

    def __init__(self, rc: int = 0):
        self.rc, self.calls = rc, []

    def vs_content_mask(self, *args):
        self.calls.append("mask")
        return self.rc

    def vs_interior_rect(self, *args):
        self.calls.append("rect")
        return self.rc


def test_mask_and_rect_kernels_count_once_a_launch(monkeypatch):
    frame = torch.zeros((H, W, 3))
    cum = torch.zeros(kazc.table_size(H, W), dtype=torch.int32)
    lib = _Library()
    monkeypatch.setattr(_lib, "library", lambda: lib)
    monkeypatch.setattr(_lib, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_lib, "stream_handle", lambda device: 0)

    def counts():
        c = telemetry.counters()
        return (c.get("azc_mask_kernel", 0), c.get("azc_rect_kernel", 0),
                kazc.MASK_KERNEL_LAUNCHES, kazc.RECT_KERNEL_LAUNCHES)

    before = counts()
    for _ in range(3):
        kazc.content_mask_cuda(frame, 10.0, 5)
        kazc.interior_rect_cuda(cum, H, W, H + W)
    assert lib.calls == ["mask", "rect"] * 3
    assert [a - b for a, b in zip(counts(), before)] == [3, 3, 3, 3]
    lib.rc = 1                             # a refused launch
    before = counts()
    with pytest.raises(RuntimeError, match="content_mask"):
        kazc.content_mask_cuda(frame, 10.0, 5)
    with pytest.raises(RuntimeError, match="interior_rect"):
        kazc.interior_rect_cuda(cum, H, W, H + W)
    assert counts() == before
