"""The PyTorch port's object tracker (``models/tracker.py``) against the JAX
package's.

The association tests of ``tests/test_models.py`` run once per package
(the port's host association is a copy; these hold the copy to the same
behaviour): ids persist, a track dies after ``max_lost_age``, an id coasts
through a detection gap, crossing objects that bounce keep their ids, a
look-alike across the frame cannot veto a local match, ``pick_id_at`` and
``draw_detections``. Then both packages' ``ObjectTracker(async_mode=
False)`` with the bundled weights carried across, in a float32 config, on
the same rendered clip: identical track ids and classes, boxes within 1e-3
px. ``TrackerParams`` is copied field for field.
"""

import dataclasses
import os
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from video_stab_tpu.models import detector as jdet  # noqa: E402
from video_stab_tpu.models import tracker as jtr  # noqa: E402
from video_stab_tpu_torch.models import detector as tdet  # noqa: E402
from video_stab_tpu_torch.models import tracker as ttr  # noqa: E402


def _package(name):
    if name == "jax":
        return types.SimpleNamespace(
            tracker=jtr.ObjectTracker, Detection=jtr.Detection,
            TrackerParams=jtr.TrackerParams, extract_patch=jtr._extract_patch)
    return types.SimpleNamespace(
        tracker=lambda *a, **kw: ttr.ObjectTracker(*a, device="cpu", **kw),
        Detection=ttr.Detection, TrackerParams=ttr.TrackerParams,
        extract_patch=ttr._extract_patch)


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return _package(request.param)


def _tracker(pkg, **kw):
    return pkg.tracker(pkg.TrackerParams(processing_width=96,
                                         processing_height=64, min_hits=1,
                                         **kw), async_mode=False)


def _two_object_frame(xa, xb, w=96, h=64, bw=20, bh=16, y=24):
    """Grayscale frame with two visually DISTINCT objects of identical
    geometry: A = fine checkerboard (dark), B = horizontal stripes
    (bright)."""
    f = np.full((h, w), 80, np.float32)
    yy, xx = np.mgrid[0:bh, 0:bw]
    checker = np.where((yy // 4 + xx // 4) % 2 == 0, 20.0, 60.0)
    stripes = np.where((yy // 4) % 2 == 0, 180.0, 240.0)
    for x0, tex in ((xa, checker), (xb, stripes)):
        x0 = int(round(x0))
        if 0 <= x0 and x0 + bw <= w:
            f[y:y + bh, x0:x0 + bw] = tex
    return f.astype(np.uint8)


def test_track_ids_persist(pkg):
    D = pkg.Detection
    tr = _tracker(pkg)
    out0 = tr._associate([D(0, 0.9, (10, 10, 20, 20)),
                          D(1, 0.8, (60, 30, 15, 15))])
    ids0 = {d.bbox[0] // 10: d.track_id for d in out0}
    out1 = tr._associate([D(0, 0.9, (12, 11, 20, 20)),
                          D(1, 0.8, (62, 31, 15, 15))])
    assert len(out1) == 2
    ids1 = {d.bbox[0] // 10: d.track_id for d in out1}
    assert set(ids0.values()) == set(ids1.values())
    tr.release()


def test_track_dies_after_max_lost(pkg):
    tr = _tracker(pkg)
    tr._associate([pkg.Detection(0, 0.9, (10, 10, 20, 20))])
    for _ in range(tr.params.max_lost_age + 1):
        tr._associate([])
    assert len(tr._tracks) == 0
    tr.release()


def test_id_coasts_through_detection_gap(pkg):
    tr = _tracker(pkg)
    tid = None
    for t in range(6):                       # establish velocity 3px/f
        out = tr._associate([pkg.Detection(0, 0.9,
                                           (10 + 3 * t, 20, 24, 16))])
        tid = out[0].track_id
    gap = tr.params.max_lost_age - 2
    for _ in range(gap):                     # full occlusion
        tr._associate([])
    assert len(tr._tracks) == 1              # still coasting
    x = 10 + 3 * (6 + gap)
    out = tr._associate([pkg.Detection(0, 0.9, (x, 20, 24, 16))])
    assert len(out) == 1
    assert out[0].track_id == tid, (out[0].track_id, tid)
    tr.release()


def test_no_id_swap_when_crossing_objects_bounce(pkg):
    """Two same-size same-class objects converge, vanish while they
    overlap, and bounce while hidden: the appearance channel must keep A's
    id on the checkered object and B's on the striped one."""
    D = pkg.Detection
    tr = _tracker(pkg, max_lost_age=12)
    bw, bh, y = 20, 16, 24
    va, vb = 4.0, -4.0
    xa, xb = 4.0, 72.0
    id_a = id_b = None
    for _ in range(6):
        fr = _two_object_frame(xa, xb)
        out = tr._associate([D(0, 0.9, (xa, y, bw, bh)),
                             D(0, 0.9, (xb, y, bw, bh))], gray=fr)
        assert len(out) == 2
        by_x = sorted(out, key=lambda d: d.bbox[0])
        id_a, id_b = by_x[0].track_id, by_x[1].track_id
        xa += va
        xb += vb
    assert id_a != id_b
    for _ in range(3):
        tr._associate([], gray=_two_object_frame(xa, xb))
        xa += va
        xb += vb
    va, vb = -va, -vb
    for _ in range(3):
        xa += va
        xb += vb
        tr._associate([], gray=_two_object_frame(xa, xb))
    for _ in range(3):
        xa += va
        xb += vb
        out = tr._associate([D(0, 0.9, (xa, y, bw, bh)),
                             D(0, 0.9, (xb, y, bw, bh))],
                            gray=_two_object_frame(xa, xb))
    by_x = sorted(out, key=lambda d: d.bbox[0])
    assert by_x[0].track_id == id_a, (by_x[0].track_id, id_a, id_b)
    assert by_x[1].track_id == id_b, (by_x[1].track_id, id_a, id_b)
    tr.release()


def test_lookalike_across_frame_cannot_veto_local_match(pkg):
    D = pkg.Detection
    tr = _tracker(pkg)
    bw, bh, y = 12, 10, 24
    xa, xb = 2.0, 80.0
    fr = _two_object_frame(xa, xb, bw=bw, bh=bh)
    for _ in range(3):
        out = tr._associate([D(0, 0.9, (xa, y, bw, bh)),
                             D(0, 0.9, (xb, y, bw, bh))], gray=fr)
    id_a = sorted(out, key=lambda d: d.bbox[0])[0].track_id
    rng = np.random.default_rng(5)
    ta, tb = sorted(tr._tracks, key=lambda t: t.x[0])
    ta.template = rng.random(ta.template.shape).astype(np.float32) * 255
    tb.template = pkg.extract_patch(fr, (xa, y, bw, bh),
                                    tr.params.template_size)
    out = tr._associate([D(0, 0.9, (xa, y, bw, bh)),
                         D(0, 0.9, (xb, y, bw, bh))], gray=fr)
    by_x = sorted(out, key=lambda d: d.bbox[0])
    assert by_x[0].track_id == id_a, (by_x[0].track_id, id_a)
    assert len(tr._tracks) == 2
    tr.release()


def test_pick_id_at(pkg):
    tr = _tracker(pkg)
    dets = tr._associate([pkg.Detection(0, 0.9, (10, 10, 20, 20))])
    tr._latest = dets
    assert tr.pick_id_at(15, 15) == dets[0].track_id
    assert tr.pick_id_at(90, 60) == -1
    tr.release()


def test_draw_detections(pkg):
    tr = _tracker(pkg)
    dets = tr._associate([pkg.Detection(0, 0.9, (10, 10, 20, 20))])
    frame = np.zeros((64, 96, 3), np.uint8)
    out = tr.draw_detections(frame, dets)
    assert out.shape == frame.shape
    assert out.sum() > 0
    tr.release()


def test_tracker_params_copied_field_for_field():
    jf = dataclasses.fields(jtr.TrackerParams)
    tf = dataclasses.fields(ttr.TrackerParams)
    assert [(f.name, f.default, f.type) for f in tf] == \
        [(f.name, f.default, f.type) for f in jf]
    assert ttr.TrackerParams.__dataclass_params__.frozen
    assert [f.name for f in dataclasses.fields(ttr.Detection)] == \
        [f.name for f in dataclasses.fields(jtr.Detection)]


def test_trackers_agree_on_a_clip():
    """Both packages' synchronous trackers with the bundled weights in a
    float32 config, on a rendered clip with two moving cars: the same
    confirmed tracks on every frame."""
    from video_stab_tpu.models.scenes import render_clip

    path = jdet.bundled_weights_path()
    if not os.path.exists(path):
        pytest.skip("bundled detector weights not present")
    frames, _gt = render_clip(np.random.default_rng(7), n_frames=14, h=192,
                              w=320, n_objects=2, classes=(0,))
    kw = dict(processing_width=320, processing_height=192,
              confidence_threshold=0.35, min_hits=2)
    _m, params = jdet.load_detector(
        path, jdet.DetectorConfig(dtype=jnp.float32), height=192, width=320)
    jt = jtr.ObjectTracker(jtr.TrackerParams(**kw),
                           detector_cfg=jdet.DetectorConfig(
                               dtype=jnp.float32),
                           detector_params=params, async_mode=False)
    tcfg = tdet.DetectorConfig(dtype=torch.float32)
    tt = ttr.ObjectTracker(ttr.TrackerParams(**kw), detector_cfg=tcfg,
                           detector_params=tdet.load_detector(path, tcfg,
                                                            device="cpu"),
                           async_mode=False, device="cpu")
    confirmed = 0
    for f in frames:
        want = jt.process_frame(f)
        got = tt.process_frame(f)
        assert [(d.track_id, d.class_id, d.label) for d in got] == \
            [(d.track_id, d.class_id, d.label) for d in want]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.bbox, b.bbox, atol=1e-3, rtol=0)
            assert abs(a.confidence - b.confidence) <= 1e-5
        confirmed += len(got)
    assert confirmed >= len(frames)
    assert tt.mean_inference_ms > 0
    jt.release()
    tt.release()


def test_async_tracker_returns_the_previous_result():
    """The latest-only async contract: process_frame answers at once with
    what the worker thread last finished, and release joins the thread."""
    tr = ttr.ObjectTracker(ttr.TrackerParams(processing_width=96,
                                             processing_height=64),
                           device="cpu")
    frame = np.zeros((64, 96, 3), np.uint8)
    assert tr.process_frame(frame) == []
    deadline = time.monotonic() + 30.0
    while tr._frame_count == 0 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert tr._frame_count >= 1
    tr.release()
    assert not tr._thread.is_alive()
