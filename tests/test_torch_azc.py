"""The port's auto zoom-crop and roll correction against the JAX
package's, on the CPU.

``interior_rect`` (chunked masked iterations here, a while_loop there)
gives identical rectangles on rotated content masks, on a tie, with no
content and with full content; the chunk reads are counted. The content
mask's plain version, ``content_mask_plain`` (K8's on the card), is the
composition gray -> threshold -> close bit for bit, and the JAX
package's mask by the rules of the ops' own tests: the gray within 1e-3
(a matmul there), threshold and close exact, so the masks differ only
where the two grays fall on either side of the threshold.
``auto_zoom_crop_step`` / ``AutoZoomCrop`` within 1 on >= 99.5 % of
pixels (two-tap resample here, dense tent matrices there); the JAX
``roll_correct_step`` against the port's (K1's plain version) with the
angle within 1e-3 deg and frames within 1 on >= 99.5 % of pixels.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cv2  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from video_stab_tpu.core import autozoomcrop as jazc  # noqa: E402
from video_stab_tpu.ops import color as jcolor  # noqa: E402
from video_stab_tpu.ops import filters as jfilt  # noqa: E402
from video_stab_tpu.core import rollcorrection as jroll  # noqa: E402
from video_stab_tpu.core.params import AutoZoomCropParams as JAzcParams  # noqa: E402
from video_stab_tpu.core.params import RollCorrectionParams as JRollParams  # noqa: E402
from video_stab_tpu_torch.core import autozoomcrop as tazc  # noqa: E402
from video_stab_tpu_torch.core import rollcorrection as troll  # noqa: E402
from video_stab_tpu_torch.core.params import (  # noqa: E402
    AutoZoomCropParams,
    RollCorrectionParams,
)
from video_stab_tpu_torch.ops.color import bgr_to_gray  # noqa: E402
from video_stab_tpu_torch.ops.filters import (  # noqa: E402
    morph_close,
    threshold_binary,
)

from azc_masks import H, MASK_THRESHOLDS, MASKS, W, mask_frame  # noqa: E402


def _rotated(img, deg):
    m = cv2.getRotationMatrix2D((W / 2.0, H / 2.0), deg, 1.0)
    return cv2.warpAffine(img, m, (W, H), flags=cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_CONSTANT, borderValue=0)


@pytest.mark.parametrize("name", list(MASKS))
def test_interior_rect_identical(name):
    m = MASKS[name]
    reads = tazc.RECT_READS
    got = tazc.interior_rect(torch.from_numpy(m)).numpy()
    want = np.asarray(jazc.interior_rect(jnp.asarray(m)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert tazc.RECT_READS - reads >= 1


def test_interior_rect_reads_once_per_chunk():
    """A 60 deg rotation shrinks for many iterations: the reads are
    ceil(iterations / RECT_CHUNK) (+ 1 when the last chunk ends exactly
    on the last move)."""
    m = torch.from_numpy(MASKS["rot 60.0"])
    reads = tazc.RECT_READS
    rect = tazc.interior_rect(m)
    n = tazc.RECT_READS - reads
    # Count the iterations the JAX loop runs by replaying the steps.
    total = 0
    r = tazc.interior_rect(m, max_iters=0)
    h, w = m.shape
    holes = (~(m > 0)).to(torch.int32)
    cum = torch.cat([
        torch.cat([torch.zeros((h, 1), dtype=torch.int32),
                   holes.cumsum(1, dtype=torch.int32)], 1).reshape(-1),
        torch.cat([torch.zeros((w, 1), dtype=torch.int32),
                   holes.t().cumsum(1, dtype=torch.int32)], 1).reshape(-1)])
    while True:
        r, go = tazc._shrink(cum, r, h, w)
        if not bool(go):
            break
        total += 1
    assert torch.equal(r, rect)
    assert total > tazc.RECT_CHUNK
    assert n in (-(-total // tazc.RECT_CHUNK),
                 -(-total // tazc.RECT_CHUNK) + 1), (n, total)


def _frame(seed=4):
    rng = np.random.default_rng(seed)
    base = rng.integers(20, 256, (H, W, 3)).astype(np.uint8)
    return base


@pytest.mark.parametrize("deg", [0.0, 3.0, -12.0])
@pytest.mark.parametrize("keep", [True, False])
def test_auto_zoom_crop_matches_jax(deg, keep):
    img = _rotated(_frame(), deg)
    kw = dict(keep_input_size=keep, out_width=64, out_height=48)
    got = tazc.auto_zoom_crop_step(AutoZoomCropParams(**kw),
                                   torch.from_numpy(img)).numpy()
    want = np.asarray(jazc.auto_zoom_crop_step(JAzcParams(**kw),
                                               jnp.asarray(img)))
    assert got.shape == want.shape == ((H, W, 3) if keep else (48, 64, 3))
    d = np.abs(got.astype(int) - want.astype(int))
    assert (d <= 1).mean() >= 0.995, ((d <= 1).mean(), d.max())


def test_auto_zoom_crop_without_content_resizes_the_frame():
    img = np.zeros((H, W, 3), np.uint8)
    kw = dict(out_width=64, out_height=48)
    got = tazc.AutoZoomCrop(AutoZoomCropParams(**kw), device="cpu") \
        .auto_zoom_crop(img)
    want = np.asarray(jazc.AutoZoomCrop(JAzcParams(**kw)).auto_zoom_crop(
        img))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tazc.AutoZoomCrop.apply(img, AutoZoomCropParams(**kw), device="cpu"),
        got)


# The JAX comparison's shapes and ellipses (the card's tests take more).
JAX_MASK_SHAPES = [(1, 1), (2, 3), (5, 7), (1080, 1920)]
JAX_MASK_KSIZES = [3, 5, 7]


@pytest.mark.parametrize("thresh", MASK_THRESHOLDS)
@pytest.mark.parametrize("ksize", JAX_MASK_KSIZES)
@pytest.mark.parametrize("shape", JAX_MASK_SHAPES)
def test_content_mask_plain_is_the_composition(shape, ksize, thresh):
    """``content_mask_plain`` is gray -> threshold -> close bit for bit,
    and a CPU frame's ``content_mask`` is it."""
    f = torch.from_numpy(mask_frame(*shape, ksize, deg=10.0 + 2 * ksize))
    want = morph_close(threshold_binary(bgr_to_gray(f), thresh, 255.0),
                       ksize)
    got = tazc.content_mask_plain(f, thresh, ksize)
    assert got.shape == shape and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(tazc.content_mask(f, thresh, ksize), want)
    if shape[0] > 7:                      # black corners and content
        assert 0 < int((got > 0).sum()) < got.numel()


@pytest.mark.parametrize("thresh", MASK_THRESHOLDS)
@pytest.mark.parametrize("ksize", JAX_MASK_KSIZES)
@pytest.mark.parametrize("shape", JAX_MASK_SHAPES)
def test_content_mask_plain_matches_jax(shape, ksize, thresh):
    """Against the JAX package's mask: the grays within 1e-3, and the
    port's close of the JAX threshold is the JAX mask bit for bit, so the
    masks agree wherever no pixel's two grays straddle the threshold."""
    frame = mask_frame(*shape, ksize + 1, deg=30.0 - 2 * ksize)
    f, jf = torch.from_numpy(frame), jnp.asarray(frame)
    g_t = bgr_to_gray(f).numpy()
    g_j = np.asarray(jcolor.bgr_to_gray(jf))
    np.testing.assert_allclose(g_t, g_j, atol=1e-3, rtol=0)
    want = np.asarray(jfilt.morph_close(
        jfilt.threshold_binary(jcolor.bgr_to_gray(jf), thresh, 255.0),
        ksize))
    got = tazc.content_mask_plain(f, thresh, ksize).numpy()
    np.testing.assert_array_equal(
        morph_close(threshold_binary(torch.from_numpy(g_j.copy()), thresh,
                                     255.0), ksize).numpy(), want)
    t = np.float32(thresh)
    split = np.argwhere((g_t > t) != (g_j > t))
    # A straddling pixel reaches 2r pixels through the dilate and erode.
    for y, x in np.argwhere(got != want):
        assert len(split) and np.abs(split - (y, x)).max(1).min() \
            <= 2 * (ksize // 2), (y, x)


def test_roll_correct_step_matches_jax():
    """Frames with a tilted horizon: the roll angle and the rotated frame
    of the port's roll_correct_step (K1, BORDER_REPLICATE) against the
    JAX package's over a short stream, and the wrapper class."""
    rng = np.random.default_rng(6)
    h, w = 192, 256
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    rp = dict(hough_threshold=30)
    jst = jroll.roll_state_init()
    port = troll.RollCorrection(RollCorrectionParams(**rp), device="cpu")
    tst = troll.roll_state_init(torch.device("cpu"))
    for i in range(6):
        sky = yy < h / 2.0 + np.tan(np.radians(4.0)) * (xx - w / 2.0)
        f = np.clip(rng.integers(0, 20, (h, w, 1)) + sky[..., None] * 150.0
                    + i, 0, 255).astype(np.uint8).repeat(3, axis=2)
        jst, want = jroll.roll_correct_step(JRollParams(**rp), jst,
                                            jnp.asarray(f))
        tst, got = troll.roll_correct_step(RollCorrectionParams(**rp), tst,
                                           torch.from_numpy(f))
        assert abs(float(tst.smoothed_angle)
                   - float(jst.smoothed_angle)) <= 1e-3
        d = np.abs(got.numpy().astype(int) - np.asarray(want).astype(int))
        assert (d <= 1).mean() >= 0.995
        np.testing.assert_array_equal(port.auto_correct_roll(f),
                                      got.numpy())
    assert abs(port.smoothed_angle) > 0.1       # the stage engaged
    port.reset()
    assert port.smoothed_angle == 0.0
