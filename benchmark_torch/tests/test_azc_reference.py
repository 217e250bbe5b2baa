"""The live restream cell (``chain_azc_kalman_1080p``) on the CPU: its
comparison fails a run whose timed path is broken in each stage the cell
adds to the chain (auto zoom-crop skipped or its resample off by a pixel,
the Kalman emit replaced by the unsmoothed path, the whole-frame roll
rotation off by a pixel, the U and V planes swapped); the reference's
zoom-crop agrees with the program's on frames rotated 10-30 deg with a
black border, where the shrink loop runs many chunks; and the K1 work of
the two-pass roll is listed only for a similarity chain that runs it.

    python -m pytest benchmark_torch/tests -q
"""

import json

import pytest
import torch

from benchmark_torch import frames, harness
from benchmark_torch.harness import HERE, load_module
from benchmark_torch.reference import ops, stream_azc
from benchmark_torch.tests.test_correct import _roll_rotation_altered, run

CELL = "chain_azc_kalman_1080p.saturated"


def _azc_skipped(monkeypatch):
    """The frame handed on as rotated, not zoom-cropped."""
    from video_stab_tpu_torch.core import chain
    monkeypatch.setattr(chain, "auto_zoom_crop_f32",
                        lambda params, frame, **kw: frame)


def _azc_resample_altered(monkeypatch):
    """The zoom-crop's resample off by a pixel."""
    from video_stab_tpu_torch.core import autozoomcrop
    real = autozoomcrop.resample_axis_aligned

    def resample(*a, **kw):
        return torch.roll(real(*a, **kw), 1, dims=1)
    monkeypatch.setattr(autozoomcrop, "resample_axis_aligned", resample)


def _kalman_skipped(monkeypatch):
    """The emit corrected toward the unsmoothed path (the filter's state
    still advanced)."""
    from video_stab_tpu_torch.core import stabilizer
    real = stabilizer._smoothed_at_emit

    def smoothed(params, state, e):
        new, _ = real(params, state, e)
        return new, stabilizer.ring_get(state.path_ring, e)
    monkeypatch.setattr(stabilizer, "_smoothed_at_emit", smoothed)


def _chroma_swapped(monkeypatch):
    """I420 with its U and V planes in each other's place."""
    from video_stab_tpu_torch.core import chain
    real = chain.bgr_to_i420

    def i420(bgr):
        out, h = real(bgr), bgr.shape[0]
        return torch.cat([out[:h], out[h + h // 4:], out[h:h + h // 4]])
    monkeypatch.setattr(chain, "bgr_to_i420", i420)


@pytest.mark.parametrize("fault", [
    _azc_skipped, _azc_resample_altered, _kalman_skipped,
    _roll_rotation_altered, _chroma_swapped,
], ids=lambda f: f.__name__)
def test_broken_restream_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = run(CELL, seconds=0.5)
    assert not res["correct"], res["checks"]


def _rotated_black(angle: float) -> torch.Tensor:
    """A 180 x 320 pool frame rotated by ``angle`` deg about its centre
    with a constant black border: (1, H, W, 3) u8."""
    img = frames.make_pool(7, 1, 1, 180, 320, "cpu")[0]
    rot = ops.rotation_matrix_2d(160.0, 90.0, torch.tensor([angle]))
    return ops.warp_u8(img, ops.invert_affine(rot), ops.BORDER_CONSTANT)


@pytest.mark.parametrize("angle", [10.0, 20.0, 30.0])
def test_reference_zoom_crop_is_the_programs(angle):
    """The box, the reads it takes the program and the zoom-cropped frame
    against ``auto_zoom_crop_f32`` on a frame whose black corners make the
    shrink loop run many chunks."""
    from video_stab_tpu_torch.core import autozoomcrop
    from video_stab_tpu_torch.core.params import AutoZoomCropParams
    from video_stab_tpu_torch.ops.color import bgr_to_gray, saturate_u8
    from video_stab_tpu_torch.ops.filters import morph_close, threshold_binary
    azc = {"enabled": True, "content_threshold": 10.0, "morph_kernel": 5,
           "keep_input_size": True}
    img = _rotated_black(angle)
    x = img[0].float()
    mask = morph_close(threshold_binary(bgr_to_gray(x), 10.0, 255.0), 5)
    content = stream_azc.close_mask(ops.bgr_to_gray(img.float()) > 10.0, 5)
    assert torch.equal(content[0], mask > 0)
    reads = autozoomcrop.RECT_READS
    want = autozoomcrop.interior_rect(mask)
    assert autozoomcrop.RECT_READS - reads > 2
    assert stream_azc.interior_rect(content)[0].tolist() == want.tolist()
    got = stream_azc.zoom_crop(img, azc)[0]
    prog = saturate_u8(autozoomcrop.auto_zoom_crop_f32(
        AutoZoomCropParams(**azc), x, keep_input_size=True))
    assert (got.int() - prog.int()).abs().max() <= 1
    assert (got != prog).float().mean() < 1e-3


def test_two_pass_work_is_listed_only_where_the_roll_runs_whole():
    """One whole-frame K1 rotation (12,441,600 bytes, 37 ops a pixel at
    1080p) for the restream config; nothing for the three configurations
    before it, whose K1 work stays as it was."""
    work = load_module(HERE / "work" / "warp_affine_u8_two_pass.py")

    def cfg(name):
        return json.loads((HERE / "configs" / f"{name}.json").read_text())

    assert work.SYMBOL == "warp_tile_kernel"
    assert work.launches(cfg("chain_azc_kalman_1080p")) == [
        (12_441_600, 2_073_600 * 37)]
    for name in ("chain_1080p", "chain_homography_1080p",
                 "multicam_8x1080p"):
        assert work.launches(cfg(name)) == []
    wide = cfg("chain_1080p")
    wide["roll"]["angle_filter_max"] = 20.0
    assert len(work.launches(wide)) == 1


def test_reference_refuses_what_it_does_not_model():
    cfg = json.loads((HERE / "configs" /
                      "chain_azc_kalman_1080p.json").read_text())
    reference = harness.load_reference(cfg)
    reference.check(cfg)
    for group, key, value in (
            (None, "pipelined", False), (None, "output_format", "bgr"),
            ("azc", "enabled", False), ("azc", "keep_input_size", False),
            ("stabilizer", "smoothing_method", "box"),
            ("stabilizer", "motion_model", "homography"),
            (None, "height", 1082)):
        bad = json.loads(json.dumps(cfg))
        (bad if group is None else bad[group])[key] = value
        with pytest.raises(ValueError):
            reference.check(bad)
