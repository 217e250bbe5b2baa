"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These need a CUDA device and the CUDA toolkit (the kernels build from
video_stab_tpu_torch/csrc/ at first use); without one they skip. On the
card: ``python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest``
(tests/conftest.py imports JAX and OpenCV, which that machine need not
have).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _textured(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.random((h + 12, w + 12)).astype(np.float32)
    k = np.exp(-0.5 * (np.arange(-6, 7) / 2.0) ** 2)
    k /= k.sum()
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "valid"), 1, img)
    img = np.apply_along_axis(lambda c: np.convolve(c, k, "valid"), 0, img)
    img = (img - img.min()) / (img.max() - img.min()) * 255.0
    # apply_along_axis over axis 0 leaves a column-major array; the kernel
    # wrappers take contiguous tensors only.
    return np.ascontiguousarray(img, dtype=np.float32)


def _rigid(deg, tx, ty, scale=1.0, cx=0.0, cy=0.0):
    """Forward (2, 3) map: rotate by deg and scale about (cx, cy), then
    translate by (tx, ty)."""
    a = np.radians(deg)
    c, s = scale * np.cos(a), scale * np.sin(a)
    return np.array([[c, -s, cx - c * cx + s * cy + tx],
                     [s, c, cy - s * cx - c * cy + ty]])


# (source (h, w), output (h, w), forward map). Tiles are 128 x 8 output
# pixels (csrc/warp.cu): in the 3-channel affine kernel, the larger sources
# give rows that pass the interior test, the others take the general
# per-tap path.
WARP_CASES = {
    "7deg": ((67, 129), (50, 160), _rigid(7.0, 9.3, -31.6)),
    "w161": ((100, 400), (96, 161), _rigid(1.2, 2.5, -1.7, cx=80, cy=48)),
    "zoom out!=in": ((260, 520), (131, 333), _rigid(-1.5, -20.0, 11.0, 0.8,
                                                    cx=260, cy=130)),
    "45deg": ((240, 320), (240, 320), _rigid(45.0, 0.0, 0.0, cx=160,
                                             cy=120)),
    "partly outside": ((120, 300), (120, 300), _rigid(0.5, 70.0, -30.0)),
    "1080p emit": ((1080, 1920), (1080, 1920), _rigid(0.3, 3.2, -1.7,
                                                      cx=960, cy=540)),
}


def _warp_input(dev, case, ch, seed):
    (h, w), (oh, ow), m = WARP_CASES[case]
    rng = np.random.default_rng(seed)
    shape = (h, w, ch) if ch == 3 else (h, w)
    img = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
    return img, m, oh, ow


@pytest.mark.parametrize("case", list(WARP_CASES))
@pytest.mark.parametrize("mode", range(5))
@pytest.mark.parametrize("ch", [1, 3])
def test_warp_kernel_matches_plain(dev, ch, mode, case):
    """K1 and its plain version: bit for bit, in every border mode, at
    widths that are not a multiple of the 4-pixel run, output size !=
    input size, a 45 deg rotation, tiles partly outside the source, and
    the 1080p emit."""
    from video_stab_tpu_torch.kernels import warp as kwarp
    from video_stab_tpu_torch.ops.warp import invert_affine
    img, m_np, oh, ow = _warp_input(dev, case, ch, mode)
    m = torch.tensor(m_np, dtype=torch.float32).to(dev)
    minv = invert_affine(m).reshape(6).contiguous()
    before = kwarp.LAUNCHES
    got = kwarp.warp_affine_u8(img, m, oh, ow, mode, 7.0)
    assert kwarp.LAUNCHES == before + 1
    want = kwarp.warp_affine_u8_plain(img, minv, oh, ow, mode, 7.0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", list(WARP_CASES))
@pytest.mark.parametrize("mode", range(5))
@pytest.mark.parametrize("ch", [1, 3])
def test_homography_kernel_matches_plain(dev, ch, mode, case):
    """K2 and its plain version on the same H^-1: bit for bit, on the K1
    cases with a perspective row added."""
    from video_stab_tpu_torch.kernels import warp as kwarp
    from video_stab_tpu_torch.ops.warp import invert_homography
    img, m_np, oh, ow = _warp_input(dev, case, ch, 10 + mode)
    scale = 1.0 / max(img.shape[:2])
    h = torch.tensor(np.vstack([m_np, [0.1 * scale, -0.07 * scale, 1.0]]),
                     dtype=torch.float32).to(dev)
    hinv = invert_homography(h).reshape(9).contiguous()
    before = kwarp.HOMOGRAPHY_LAUNCHES
    got = kwarp.warp_homography_u8(img, h, oh, ow, mode, 7.0)
    assert kwarp.HOMOGRAPHY_LAUNCHES == before + 1
    want = kwarp.warp_homography_u8_plain(img, hinv, oh, ow, mode, 7.0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("c", [None, 3, 9])
@pytest.mark.parametrize("n,r", [(240, 15), (37, 5), (1000, 50)])
def test_box_filter_kernels_match_plain(dev, n, r, c):
    """K5b (centered) and K5a (convolve) against their plain versions on
    the same path: bit for bit."""
    from video_stab_tpu_torch.kernels import traj as ktraj
    rng = np.random.default_rng(n + r)
    shape = (n,) if c is None else (n, c)
    path = torch.from_numpy(np.cumsum(rng.normal(0, 1, shape), axis=0)
                            .astype(np.float32)).to(dev)
    before = (ktraj.CENTERED_LAUNCHES, ktraj.CONVOLVE_LAUNCHES)
    got_c = ktraj.box_filter_centered(path, r)
    got_v = ktraj.box_filter_convolve(path, r)
    assert (ktraj.CENTERED_LAUNCHES, ktraj.CONVOLVE_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(got_c, ktraj.box_filter_centered_plain(path, r))
    assert torch.equal(got_v, ktraj.box_filter_convolve_plain(path, r))
    assert got_c.shape == got_v.shape == path.shape


def test_corner_kernel_matches_plain(dev):
    from video_stab_tpu_torch.kernels import features as kfeat
    gray = torch.from_numpy(_textured(75, 133, 1)).to(dev)
    resp, peak = kfeat.corner_response(gray)
    p_resp, p_peak = kfeat.corner_response_plain(gray)
    assert float((resp - p_resp).abs().max()) <= 1e-5
    assert torch.equal(peak, p_peak)


# A warp of K3 owns 26 output columns and 16 output rows (csrc/features.cu).
@pytest.mark.parametrize("shape", [
    (37, 53),                   # no strip divides it
    (1, 90), (90, 1), (1, 1),   # one-pixel axes reflect onto themselves
    (2, 2), (3, 200),           # the wrapped halo runs around the frame
    (16, 26), (32, 104),        # exactly one strip; exactly one block row
    (540, 960),                 # the main path's analysis gray
])
def test_corner_kernel_odd_shapes(dev, shape):
    """K3 against its plain version: response within 1e-5 (0 expected: the
    same rounded operations in the same order), the peak mask identical,
    exactly one launch per call."""
    from video_stab_tpu_torch.kernels import features as kfeat
    h, w = shape
    rng = np.random.default_rng(h * 1000 + w)
    # (a texture needs a few pixels: cut small frames out of a larger one)
    gray = (_textured(max(h, 8), max(w, 8), h + w)[:h, :w]
            + rng.integers(-9, 10, (h, w)))
    gray = torch.from_numpy(np.clip(np.round(gray), 0, 255).astype(
        np.float32)).to(dev)
    before = kfeat.LAUNCHES
    resp, peak = kfeat.corner_response(gray)
    assert kfeat.LAUNCHES == before + 1
    p_resp, p_peak = kfeat.corner_response_plain(gray)
    torch.cuda.synchronize()
    assert resp.shape == peak.shape == (h, w)
    assert float((resp - p_resp).abs().max()) <= 1e-5
    assert torch.equal(peak, p_peak)


@pytest.mark.parametrize("layout", ["contiguous", "offset view"])
@pytest.mark.parametrize("wb", [False, True])
def test_enhance_kernel_matches_plain(dev, wb, layout):
    """K4 against its plain version: identical u8 and gray, on a frame
    whose pixel count (61 x 97) is not a multiple of the 16-pixel run, as
    a fresh tensor and as a contiguous view one byte into its storage
    (not 16-byte aligned: the kernel's scalar loop)."""
    from video_stab_tpu_torch.core.params import EnhancerParams
    from video_stab_tpu_torch.kernels import enhance as kenh
    rng = np.random.default_rng(4)
    data = torch.from_numpy(rng.integers(0, 256, 61 * 97 * 3 + 1,
                                         dtype=np.uint8)).to(dev)
    frame = data[1:].view(61, 97, 3) if layout == "offset view" \
        else data[1:].clone().view(61, 97, 3)
    assert frame.is_contiguous()
    assert (frame.data_ptr() % 16 != 0) == (layout == "offset view")
    p = EnhancerParams(brightness=5.0, contrast=1.1, gamma=0.9,
                       enable_white_balance=wb, wb_strength=0.5)
    out, gray = kenh.enhance_u8(p, frame, want_gray=True)
    scales = kenh.white_balance_scales(frame, 0.5) if wb else None
    p_out, p_gray = kenh.enhance_u8_plain(p, frame, scales, want_gray=True)
    d = (out.int() - p_out.int()).abs()
    assert int(d.max()) <= 1 and float((d == 0).float().mean()) >= 0.999
    assert float((gray - p_gray).abs().max()) <= 1e-3
    assert torch.equal(out, p_out) and torch.equal(gray, p_gray)


def test_wrappers_reject_bad_inputs(dev):
    from video_stab_tpu_torch.kernels import features as kfeat
    from video_stab_tpu_torch.kernels import warp as kwarp
    img = torch.zeros((8, 8, 3), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        kwarp.warp_affine_u8(img, torch.eye(2, 3, device=dev))
    with pytest.raises(ValueError):
        kfeat.corner_response_cuda(torch.zeros((8, 8), dtype=torch.float64,
                                               device=dev))
    with pytest.raises(ValueError):
        kwarp.warp_homography_u8(img, torch.eye(3, device=dev))
    from video_stab_tpu_torch.kernels import traj as ktraj
    with pytest.raises(ValueError):
        ktraj.box_filter_centered(torch.zeros((30, 3), dtype=torch.float64,
                                              device=dev), 5)


def _lk_pair(dev, h, w, seed, shift):
    """A textured frame and the same world moved by a sub-pixel shift
    (bilinear), as (H, W) float32 CUDA tensors."""
    world = _textured(h + 40, w + 40, seed).astype(np.float64)
    dy, dx = shift
    iy, ix = int(np.floor(dy)), int(np.floor(dx))
    fy, fx = dy - iy, dx - ix

    def crop(oy, ox):
        return world[20 + oy:20 + oy + h, 20 + ox:20 + ox + w]
    curr = ((1 - fy) * (1 - fx) * crop(-iy, -ix)
            + (1 - fy) * fx * crop(-iy, -ix - 1)
            + fy * (1 - fx) * crop(-iy - 1, -ix)
            + fy * fx * crop(-iy - 1, -ix - 1))
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
            for a in (world[20:20 + h, 20:20 + w], curr)]


def _check_lk(got, want, eps):
    """The plain version's tolerance (tests/test_torch_ops.py::
    test_lk_track): identical status; tracked positions within
    max(1e-3, eps) and >= 95 % of them within 1e-3 px; err within 1e-2
    where the positions agree."""
    status = want[1].cpu().numpy()
    np.testing.assert_array_equal(got[1].cpu().numpy(), status)
    assert status.sum() > len(status) // 2
    gp, wp = got[0].cpu().numpy(), want[0].cpu().numpy()
    np.testing.assert_allclose(gp[status], wp[status], atol=max(1e-3, eps),
                               rtol=0)
    same = np.abs(gp - wp).max(1) < 1e-3
    assert (same & status).sum() >= 0.95 * status.sum()
    np.testing.assert_allclose(got[2].cpu().numpy()[same],
                               want[2].cpu().numpy()[same], atol=1e-2)


@pytest.mark.parametrize("eps", [0.03, 1e-6])
@pytest.mark.parametrize("case", ["96x128", "96x128 init_pts", "540x960"])
def test_lk_kernel_matches_plain(dev, case, eps):
    """K6 against lk_levels_plain on the same planes: at the tolerance of
    the plain version against JAX, at eps = 0.03 and 1e-6; at 96 x 128 with
    48 points in [-5, w + 5], and at the main path's 540 x 960, 3 levels,
    200 GFTT corners."""
    from video_stab_tpu_torch.kernels import lk as klk
    from video_stab_tpu_torch.ops.features import good_features_to_track
    from video_stab_tpu_torch.ops.lk import lk_planes
    rng = np.random.default_rng(3)
    init = None
    if case.startswith("96x128"):
        h, w, n = 96, 128, 48
        prev, curr = _lk_pair(dev, h, w, 1, (2.3, -1.6))
        pts = torch.from_numpy(np.stack(
            [rng.uniform(-5, w + 5, n), rng.uniform(-5, h + 5, n)],
            axis=1).astype(np.float32)).to(dev)
        mask = torch.from_numpy(rng.random(n) > 0.1).to(dev)
        if case.endswith("init_pts"):
            init = pts + torch.tensor([-1.6, 2.3], device=dev)
    else:
        prev, curr = _lk_pair(dev, 540, 960, 2, (6.4, -9.7))
        pts, mask = good_features_to_track(prev, max_corners=200,
                                           quality_level=0.01,
                                           min_distance=15.0)
        assert int(mask.sum()) == 200
    planes = lk_planes(prev, curr, 2)
    before = klk.LAUNCHES
    got = klk.lk_levels(*planes, pts, mask, init, 15, 20, eps, 1e-4)
    assert klk.LAUNCHES == before + 1
    want = klk.lk_levels_plain(*planes, pts, mask, init, 15, 20, eps, 1e-4)
    torch.cuda.synchronize()
    _check_lk(got, want, eps)


def test_lk_track_launches_k6_once_per_call(dev):
    from video_stab_tpu_torch.kernels import lk as klk
    from video_stab_tpu_torch.ops.lk import lk_track
    prev, curr = _lk_pair(dev, 96, 128, 4, (1.2, 0.7))
    rng = np.random.default_rng(4)
    pts = torch.from_numpy(rng.uniform(10, 90, (32, 2)).astype(
        np.float32)).to(dev)
    mask = torch.ones(32, dtype=torch.bool, device=dev)
    before = klk.LAUNCHES
    for k in range(3):
        out, status, err = lk_track(prev, curr, pts, mask)
        assert klk.LAUNCHES == before + k + 1
    assert out.is_cuda and status.dtype == torch.bool
    assert bool(torch.isfinite(out).all()) and int(status.sum()) > 16


def test_lk_wrapper_rejects_bad_inputs(dev):
    from video_stab_tpu_torch.kernels import lk as klk
    from video_stab_tpu_torch.ops.lk import lk_planes
    prev, curr = _lk_pair(dev, 96, 128, 5, (0.5, 0.5))
    prev_planes, curr_planes = lk_planes(prev, curr, 2)
    pts = torch.full((8, 2), 40.0, device=dev)
    mask = torch.ones(8, dtype=torch.bool, device=dev)
    args = (pts, mask, None, 15, 20, 0.03, 1e-4)
    before = klk.LAUNCHES
    with pytest.raises(ValueError, match="float32"):
        klk.lk_levels([p.double() for p in prev_planes], curr_planes, *args)
    with pytest.raises(ValueError, match="contiguous"):
        klk.lk_levels(prev_planes, [c.t().contiguous().t()
                                    for c in curr_planes], *args)
    deep_prev, deep_curr = lk_planes(prev, curr, klk.MAX_LEVEL + 1)
    with pytest.raises(ValueError, match="levels"):
        klk.lk_levels(deep_prev, deep_curr, *args)
    assert klk.LAUNCHES == before


@pytest.mark.parametrize("case", ["96x128", "540x960", "96x128 win 21",
                                  "96x128 5 levels", "96x128 eps 1e-6"])
def test_lk_kernel_counts_steps_like_plain(dev, case):
    """K6's ``steps`` output against the plain version's count: equal for
    every point whose position agrees within 1e-3 px, but for points one
    step apart at the eps freeze (|d|^2 within rounding of eps^2), at most
    2 % of them (at eps = 0.03); never above the budget; 0 for masked
    points. With win 21
    a thread owns two runs of the window; 5 levels is a deeper pyramid
    than the main path's."""
    from video_stab_tpu_torch.kernels import lk as klk
    from video_stab_tpu_torch.ops.features import good_features_to_track
    from video_stab_tpu_torch.ops.lk import lk_planes
    rng = np.random.default_rng(6)
    win = 21 if "win 21" in case else 15
    max_level = 4 if "5 levels" in case else 2
    eps = 1e-6 if "eps" in case else 0.03
    if case.startswith("96x128"):
        h, w, n = 96, 128, 48
        prev, curr = _lk_pair(dev, h, w, 1, (2.3, -1.6))
        pts = torch.from_numpy(np.stack(
            [rng.uniform(-5, w + 5, n), rng.uniform(-5, h + 5, n)],
            axis=1).astype(np.float32)).to(dev)
        mask = torch.from_numpy(rng.random(n) > 0.1).to(dev)
    else:
        prev, curr = _lk_pair(dev, 540, 960, 2, (6.4, -9.7))
        pts, mask = good_features_to_track(prev, max_corners=200,
                                           quality_level=0.01,
                                           min_distance=15.0)
    n = pts.shape[0]
    planes = lk_planes(prev, curr, max_level)
    k_steps = torch.full((n,), -1, dtype=torch.int32, device=dev)
    p_steps = torch.full((n,), -1, dtype=torch.int32, device=dev)
    before = klk.LAUNCHES
    got = klk.lk_levels_cuda(*planes, pts, mask, None, win, 20, eps, 1e-4,
                             steps=k_steps)
    assert klk.LAUNCHES == before + 1
    want = klk.lk_levels_plain(*planes, pts, mask, None, win, 20, eps, 1e-4,
                               steps=p_steps)
    torch.cuda.synchronize()
    _check_lk(got, want, eps)
    k, p = k_steps.cpu().numpy(), p_steps.cpu().numpy()
    budget = 4 * 5 + max_level * 2 * 10
    assert k.min() >= 0 and k.max() <= budget
    assert (k[~mask.cpu().numpy()] == 0).all()
    same = ((got[0] - want[0]).abs().max(dim=1).values < 1e-3).cpu().numpy()
    diff = np.abs(k - p)[same]
    if eps >= 0.03:
        assert (diff <= 1).all(), diff.max()
        assert (diff == 1).sum() <= max(1, 0.02 * same.sum()), \
            (diff == 1).sum()
    else:
        # At eps = 1e-6 a point freezes when its step is at the rounding
        # level of the 225-term sums, whose order differs: the two freeze
        # some steps apart for a minority of points (4 of 200 at 540 x 960,
        # 8 of 48 of the random points here).
        assert np.median(diff) == 0 and (diff == 0).mean() >= 0.7, diff


def test_lk_steps_argument_is_checked(dev):
    from video_stab_tpu_torch.kernels import lk as klk
    from video_stab_tpu_torch.ops.lk import lk_planes
    prev, curr = _lk_pair(dev, 96, 128, 5, (0.5, 0.5))
    planes = lk_planes(prev, curr, 2)
    pts = torch.full((8, 2), 40.0, device=dev)
    mask = torch.ones(8, dtype=torch.bool, device=dev)
    before = klk.LAUNCHES
    with pytest.raises(ValueError, match="int32"):
        klk.lk_levels_cuda(*planes, pts, mask, None, 15, 20, 0.03, 1e-4,
                           steps=torch.zeros(8, device=dev))
    with pytest.raises(ValueError, match="steps"):
        klk.lk_levels_cuda(*planes, pts, mask, None, 15, 20, 0.03, 1e-4,
                           steps=torch.zeros(7, dtype=torch.int32,
                                             device=dev))
    assert klk.LAUNCHES == before
