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

from azc_masks import (  # noqa: E402
    MASK_KSIZES,
    MASK_SHAPES,
    MASK_THRESHOLDS,
    MASKS,
    MAX_ITERS,
    RECTS,
    mask_frame,
)

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


@pytest.mark.parametrize("c", [None, 1, 3, 9])
@pytest.mark.parametrize("n,r", [(1, 2), (1, 1), (5, 8), (8, 8), (9, 8),
                                 (16, 15), (33, 3), (86, 3), (255, 7),
                                 (2048, 50), (2049, 50), (18000, 15)])
def test_box_filter_kernels_odd_shapes(dev, n, r, c):
    """K5a / K5b bit for bit at N = 1, N <= r, N = r + 1, a tile's edge
    (32 rows of 3 channels a block), C = 1, 3, 9, and on both sides of the
    longest path whose median K5a ranks in its launch (2048 rows)."""
    from video_stab_tpu_torch.kernels import traj as ktraj
    rng = np.random.default_rng(1000 * n + r)
    shape = (n,) if c is None else (n, c)
    path = torch.from_numpy(np.cumsum(rng.normal(0, 1, shape), axis=0)
                            .astype(np.float32)).to(dev)
    got_c = ktraj.box_filter_centered(path, r)
    got_v = ktraj.box_filter_convolve(path, r)
    torch.cuda.synchronize()
    assert torch.equal(got_c, ktraj.box_filter_centered_plain(path, r))
    assert torch.equal(got_v, ktraj.box_filter_convolve_plain(path, r))
    assert ktraj.median_in_kernel(n) == (n <= 2048)


@pytest.mark.parametrize("case", ["rows view", "offset view", "column view",
                                  "ties", "nan", "signed zeros"])
def test_box_filter_kernels_views_and_ties(dev, case):
    """A non-contiguous view, a view that starts 4 and 12 bytes into its
    storage (no 16-byte alignment), a path of few distinct values (ties in
    the median's ranking), NaNs (sorted last, as torch.sort has a NaN
    with a clear sign bit) and zeros of both signs."""
    from video_stab_tpu_torch.kernels import traj as ktraj
    rng = np.random.default_rng(11)
    base = torch.from_numpy(np.cumsum(rng.normal(0, 1, (301, 6)), axis=0)
                            .astype(np.float32)).to(dev)
    if case == "rows view":
        paths = [base[::2, :3]]
    elif case == "offset view":
        flat = base.reshape(-1)
        paths = [flat[k:k + 900].reshape(300, 3) for k in (1, 2, 3)]
    elif case == "column view":
        paths = [base[:, 4], base.t()[:5].t()]
    elif case == "ties":
        paths = [torch.round(base[:, :3] / 8.0), torch.zeros_like(base),
                 torch.ones((7, 3), device=dev)]
    elif case == "nan":
        p = base[:, :3].clone()
        p[5, 0] = float("nan")
        p[7:200, 1] = float("nan")
        p[:, 2] = -p[:, 2].abs()
        paths = [p]
    else:
        p = torch.zeros((64, 3), device=dev)
        p[::2] = -0.0
        p[:5, 1] = torch.tensor([1.0, -1.0, 2.0, -2.0, 0.0], device=dev)
        paths = [p]
    for path in paths:
        for r in (4, 15):
            for cuda_fn, plain_fn in (
                    (ktraj.box_filter_centered, ktraj.box_filter_centered_plain),
                    (ktraj.box_filter_convolve, ktraj.box_filter_convolve_plain)):
                got, want = cuda_fn(path, r), plain_fn(path, r)
                torch.cuda.synchronize()
                assert got.shape == path.shape
                assert torch.equal(torch.nan_to_num(got, nan=1e30),
                                   torch.nan_to_num(want, nan=1e30)), \
                    (case, tuple(path.shape), r, cuda_fn.__name__)


@pytest.mark.parametrize("n,launches", [(240, 1), (2048, 1), (5000, None)])
def test_box_filter_convolve_is_one_launch(dev, n, launches):
    """K5a with the median ranked in the kernel is one kernel launch a call
    (the profiler's count of the host's launch calls agrees with the
    wrapper's counter); above the limit the wrapper's sort adds its own."""
    from torch.profiler import ProfilerActivity, profile

    from video_stab_tpu_torch.kernels import traj as ktraj
    path = torch.randn((n, 3), device=dev).cumsum(0)
    ktraj.box_filter_convolve(path, 8)
    torch.cuda.synchronize()
    before = ktraj.CONVOLVE_LAUNCHES
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ktraj.box_filter_convolve(path, 8)
        torch.cuda.synchronize()
    assert ktraj.CONVOLVE_LAUNCHES == before + 1
    seen = sum(ev.count for ev in prof.key_averages()
               if "LaunchKernel" in ev.key)
    if launches is None:
        assert seen > 1, seen
    else:
        assert seen == launches, seen


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
    from video_stab_tpu_torch.ops.lk import lk_planes, lk_planes_plain
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
    # K9 refuses more levels than K6 takes: the deep planes are the plain
    # version's.
    deep_prev, deep_curr = lk_planes_plain(prev, curr, klk.MAX_LEVEL + 1)
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


# --- K9: LK's planes, one launch a level ------------------------------------

def _k9_against_plain(dev, prev, curr, max_level):
    """K9 on the card against ``lk_planes_plain`` on the card, every plane
    bit for bit; ``max_level + 1`` launches counted both ways and no host
    sync during the call (the pyr_down tables are on the card after the
    first call of a shape)."""
    from video_stab_tpu_torch.kernels import lk_planes as klp
    from video_stab_tpu_torch.ops.lk import lk_planes, lk_planes_plain
    from video_stab_tpu_torch.utils import telemetry
    want = lk_planes_plain(prev, curr, max_level)
    lk_planes(prev, curr, max_level)
    torch.cuda.synchronize()
    launches = klp.PLANES_LAUNCHES
    counted = telemetry.counters().get("lk_planes_kernel", 0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = lk_planes(prev, curr, max_level)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert klp.PLANES_LAUNCHES == launches + max_level + 1
    assert telemetry.counters()["lk_planes_kernel"] == \
        counted + max_level + 1
    assert len(got[0]) == len(got[1]) == max_level + 1
    for level in range(max_level + 1):
        for g, w in ((got[0][level], want[0][level]),
                     (got[1][level], want[1][level])):
            assert g.shape == w.shape and g.dtype == torch.float32
            assert g.is_contiguous()
            assert torch.equal(g, w), (level, int((g != w).sum()))


def _k9_grays(dev, n, h, w, seed):
    """(H, W) grays for n = 0, else (n, H, W): u8-domain texture."""
    rng = np.random.default_rng(seed)
    shape = (h, w) if n == 0 else (n, h, w)
    out = []
    for _ in range(2):
        g = rng.uniform(0.0, 255.0, shape).astype(np.float32)
        g[..., ::3, :] = np.round(g[..., ::3, :])
        out.append(torch.from_numpy(g).to(dev))
    return out


K9_SHAPES = [(1, 1), (2, 3), (45, 67), (61, 83)]


@pytest.mark.parametrize("n", [0, 1, 3, 8], ids=["HW", "N1", "N3", "N8"])
@pytest.mark.parametrize("max_level", range(6))
@pytest.mark.parametrize("shape", K9_SHAPES,
                         ids=[f"{h}x{w}" for h, w in K9_SHAPES])
def test_lk_planes_kernel_matches_plain(dev, shape, max_level, n):
    """K9 on odd and tiny shapes at every level count K6 takes, for (H, W)
    grays and for 1, 3 and 8 streams."""
    prev, curr = _k9_grays(dev, n, *shape, seed=shape[0] * 7 + max_level)
    _k9_against_plain(dev, prev, curr, max_level)


@pytest.mark.parametrize("case", ["540x960 L2", "540x960 L2 N8",
                                  "1080x1920 L3"])
def test_lk_planes_kernel_at_the_paths_shapes(dev, case):
    """K9 at the cells' analysis shape (540 x 960, 3 levels, one stream and
    multicam's 8) on a real frame pair's grays, and at the legacy
    stabilizer's 1080 x 1920 with 4 levels."""
    if case.startswith("1080"):
        prev, curr = _lk_pair(dev, 1080, 1920, 5, (4.6, -7.3))
        _k9_against_plain(dev, prev, curr, 3)
        return
    prev, curr = _lk_pair(dev, 540, 960, 2, (6.4, -9.7))
    if case.endswith("N8"):
        prev = torch.stack([torch.roll(prev, 13 * k, dims=1)
                            for k in range(8)])
        curr = torch.stack([torch.roll(curr, 13 * k, dims=1)
                            for k in range(8)])
    _k9_against_plain(dev, prev, curr, 2)


def test_lk_planes_kernel_refuses(dev):
    """K9's wrapper refuses CPU grays, float64, non-contiguous grays,
    grays of two shapes, empty ones and more than 6 levels, each without
    a launch."""
    from video_stab_tpu_torch.kernels import lk_planes as klp
    prev, curr = _k9_grays(dev, 0, 40, 70, 3)
    launches = klp.PLANES_LAUNCHES
    for p, c, levels, match in (
            (prev.cpu(), curr.cpu(), 2, "CUDA"),
            (prev.double(), curr.double(), 2, "float32"),
            (prev.t(), curr.t(), 2, "contiguous"),
            (prev, curr[:, :69].contiguous(), 2, "one shape"),
            (prev[:0], curr[:0], 2, "non-empty"),
            (prev[None, None], curr[None, None], 2, "-d"),
            (prev, curr, 6, "max_level")):
        with pytest.raises(ValueError, match=match):
            klp.lk_planes_cuda(p, c, levels)
    assert klp.PLANES_LAUNCHES == launches


def test_lk_track_same_with_k9_and_plain_planes(dev, monkeypatch):
    """``lk_track`` at 540 x 960 with 200 GFTT corners: (points, status,
    err) identical with K9's planes and with the plain planes (K6 both
    times)."""
    from video_stab_tpu_torch.kernels import lk_planes as klp
    from video_stab_tpu_torch.ops import lk as tlk
    from video_stab_tpu_torch.ops.features import good_features_to_track
    prev, curr = _lk_pair(dev, 540, 960, 2, (6.4, -9.7))
    pts, mask = good_features_to_track(prev, max_corners=200,
                                       quality_level=0.01, min_distance=15.0)
    assert int(mask.sum()) == 200
    launches = klp.PLANES_LAUNCHES
    got = tlk.lk_track(prev, curr, pts, mask, max_level=2)
    assert klp.PLANES_LAUNCHES == launches + 3
    monkeypatch.setattr(tlk, "lk_planes", tlk.lk_planes_plain)
    want = tlk.lk_track(prev, curr, pts, mask, max_level=2)
    assert klp.PLANES_LAUNCHES == launches + 3
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[1].sum()) > 150


def test_chain_with_k9_matches_the_plain_planes(dev, monkeypatch):
    """The chain cell's config and pool over 48 calls: the delivered
    frames with K9 and with the plain planes on the card are identical,
    and K9 runs 3 launches an LK call."""
    import json
    from pathlib import Path

    from benchmark_torch.frames import make_pool
    from benchmark_torch.systems.chain import System
    from video_stab_tpu_torch.kernels import lk as klk
    from video_stab_tpu_torch.kernels import lk_planes as klp
    from video_stab_tpu_torch.ops import lk as tlk
    root = Path(__file__).resolve().parent.parent
    cfg = json.loads((root / "benchmark_torch" / "configs"
                      / "chain_1080p.json").read_text())
    seed = 2 ** 31 + 23
    pool = make_pool(seed, cfg["pool_frames"], 1, cfg["height"],
                     cfg["width"], dev).cpu().numpy()

    def run():
        before = (klp.PLANES_LAUNCHES, klk.LAUNCHES)
        system = System(cfg, pool, seed, dev)
        outs = [system.call(i) for i in range(48)]
        system.close()
        return outs, (klp.PLANES_LAUNCHES - before[0],
                      klk.LAUNCHES - before[1])

    got, (k9, k6) = run()
    assert k6 >= 47 and k9 == 3 * k6, (k9, k6)
    monkeypatch.setattr(tlk, "lk_planes", tlk.lk_planes_plain)
    want, (k9, k6) = run()
    assert k9 == 0 and k6 >= 47
    assert [o is None for o in got] == [o is None for o in want]
    assert sum(o is not None for o in got) >= 24
    for a, b in zip(got, want):
        if a is not None:
            np.testing.assert_array_equal(a, b)


# --- the smoothers and the resumed stream on the card ------------------------

SMALL_STREAM = dict(smoothing_radius=5, analysis_width=128, analysis_height=72,
                    max_corners=64, ransac_hypotheses=64)
CARD_SMOOTHERS = {
    "gaussian": {"smoothing_method": "gaussian"},
    "kalman": {"smoothing_method": "kalman"},
    "butterworth": {"smoothing_method": "butterworth"},
    # Enough corners that the stream is never starved (>= 40 tracked): the
    # frame on which the conditional CLAHE switches on tracks an equalized
    # frame against a plain one, and its few, poor matches leave RANSAC to
    # float32 rounding. CLAHE itself is held to the CPU below.
    "drone": {"drone_high_freq_mode": True, "analysis_width": 256,
              "analysis_height": 144, "max_corners": 128,
              "min_distance": 8.0},
    "homography kalman": {"motion_model": "homography",
                          "smoothing_method": "kalman"},
}


def _jittered(n, h=144, w=256, seed=3):
    """n frames: a textured world seen through a jittering window."""
    rng = np.random.default_rng(seed)
    world = _textured(h + 32, w + 32, seed)
    frames = []
    for _ in range(n):
        dx, dy = rng.integers(-5, 6, 2)
        f = world[16 + dy:16 + dy + h, 16 + dx:16 + dx + w]
        frames.append(np.stack([f, np.roll(f, 1, 0), 255 - f], axis=-1)
                      .astype(np.uint8))
    return np.stack(frames)


def _draws(n_steps, k, width, seed):
    u = np.random.default_rng(seed).random((n_steps, k, width))
    steps = iter(range(n_steps))

    def inject(n_valid):
        hi = max(int(n_valid), 1)
        return torch.from_numpy(np.minimum(np.floor(u[next(steps)] * hi),
                                           hi - 1).astype(np.int64))
    return inject


def _stream(stab, frames):
    outs = [o for o in (stab.stabilize(f) for f in frames) if o is not None]
    while (f := stab.flush()) is not None:
        outs.append(f)
    return np.stack(outs)


def _within_one(a, b):
    assert a.shape == b.shape
    return float((np.abs(a.astype(int) - b.astype(int)) <= 1).mean())


@pytest.mark.parametrize("case", list(CARD_SMOOTHERS))
def test_stabilizer_smoothers_match_cpu(dev, case):
    """The streaming Stabilizer with each new smoother and the drone mode:
    the card (kernels) against the CPU (plain versions) on the same frames
    and RANSAC draws: u8 frames within 1 on >= 99.5 % of pixels."""
    from video_stab_tpu_torch.core.params import ModeParams, StabilizerParams
    from video_stab_tpu_torch.core.stabilizer import Stabilizer
    p = StabilizerParams(**{**SMALL_STREAM, **CARD_SMOOTHERS[case]})
    width = 4 if p.motion_model == "homography" else 2
    frames = _jittered(20)
    outs = [_stream(Stabilizer(p, mode=ModeParams(use_cuda=use_cuda),
                               ransac_draws=_draws(len(frames),
                                                   p.ransac_hypotheses,
                                                   width, 5)), frames)
            for use_cuda in (False, True)]
    assert len(outs[0]) == len(frames)
    assert _within_one(outs[1], outs[0]) >= 0.995


@pytest.mark.parametrize("model,method", [
    ("similarity", "gaussian"), ("similarity", "kalman"),
    ("similarity", "butterworth"), ("similarity", "l1"),
    ("homography", "kalman"), ("homography", "butterworth")])
def test_offline_smoothers_match_cpu(dev, model, method):
    """Offline stabilize_clip with each new smoother, the card against the
    CPU; the homography model with the 9-channel kalman and butterworth
    runs."""
    from video_stab_tpu_torch.core.params import StabilizerParams
    from video_stab_tpu_torch.offline import stabilize_clip
    p = StabilizerParams(**SMALL_STREAM, motion_model=model,
                         smoothing_method=method)
    frames = _jittered(16, seed=4)
    width = 4 if model == "homography" else 2
    outs = [stabilize_clip(frames, p, device=d,
                           ransac_draws=_draws(len(frames),
                                               p.ransac_hypotheses, width, 6))
            for d in ("cpu", "cuda")]
    assert outs[0].shape == frames.shape
    assert _within_one(outs[1], outs[0]) >= 0.995


@pytest.mark.parametrize("kw", [{}, {"smoothing_method": "kalman"},
                                {"drone_high_freq_mode": True},
                                {"motion_model": "homography"}])
def test_resumed_stream_continues_on_the_card(dev, kw):
    """Save after 10 frames, load into a new Stabilizer, continue: equal to
    the uninterrupted stream bit for bit, the draws coming from the card's
    generator, whose position the saved state carries."""
    from video_stab_tpu_torch.core.params import ModeParams, StabilizerParams
    from video_stab_tpu_torch.core.stabilizer import Stabilizer
    p = StabilizerParams(**SMALL_STREAM, seed=2, **kw)
    frames = _jittered(18)
    whole = Stabilizer(p, mode=ModeParams())
    want = [whole.stabilize(f) for f in frames]
    want_tr = whole.last_metrics["transform"].cpu()
    first = Stabilizer(p, mode=ModeParams())
    for f in frames[:10]:
        first.stabilize(f)
    saved = first.state_dict()
    assert saved["key_device"] == "cuda"
    second = Stabilizer(p, mode=ModeParams())
    second.load_state_dict(saved, *frames.shape[1:3])
    for f, w in zip(frames[10:], want[10:]):
        got = second.stabilize(f)
        assert (got is None) == (w is None)
        if got is not None:
            np.testing.assert_array_equal(got, w)
    assert torch.equal(second.last_metrics["transform"].cpu(), want_tr)
    while (w := whole.flush()) is not None:
        np.testing.assert_array_equal(second.flush(), w)


def test_smoother_functions_match_cpu(dev):
    """``clahe``, ``hf_apply`` and ``l1_smooth_path`` on the card against
    the CPU: CLAHE's integer histogram and LUTs are exact, so within 1e-3;
    the HF chain's flags and counters equal; the l1 path within 1e-3."""
    from video_stab_tpu_torch.motion import hf as thf
    from video_stab_tpu_torch.motion.l1path import l1_smooth_path
    from video_stab_tpu_torch.ops.filters import clahe
    img = torch.from_numpy(_textured(135, 240, 8))
    assert float((clahe(img.to(dev)).cpu() - clahe(img)).abs().max()) <= 1e-3
    rng = np.random.default_rng(1)
    raws = rng.normal(0, 2.0, (60, 3)).astype(np.float32)
    raws[:, 2] *= 0.02
    raws[15:30] *= 0.1
    kw = dict(dead_zone_threshold=2.0, freeze_duration=10,
              accumulator_decay=0.9, shake_px=1.5, rot_lp_alpha=0.2,
              horizon_lock=True)
    a, b = thf.hf_init(dev), thf.hf_init("cpu")
    for raw in torch.from_numpy(raws):
        a, ta = thf.hf_apply(a, raw.to(dev), **kw)
        b, tb = thf.hf_apply(b, raw, **kw)
        assert float((ta.cpu() - tb).abs().max()) <= 1e-6
        assert int(a.freeze_counter) == int(b.freeze_counter)
        assert bool(a.in_dead_zone) == bool(b.in_dead_zone)
    path = torch.from_numpy(np.cumsum(rng.normal(0, 2, (120, 3)), axis=0)
                            .astype(np.float32))
    got = l1_smooth_path(path.to(dev), 20.0).cpu()
    assert float((got - l1_smooth_path(path, 20.0)).abs().max()) <= 1e-3


# ---- K4's head and tail modes, the bordered emit, azc, i420, the prior ----

def _head_into(p, frame, scales, dst):
    """K4's head mode through its C entry into ``dst``, a (H, W, 3) float32
    view that may start anywhere (the wrapper allocates its own)."""
    from video_stab_tpu_torch.kernels import _lib
    from video_stab_tpu_torch.kernels import enhance as kenh
    h, w, _ = frame.shape
    do_cb, _ = kenh._stages(p)
    _lib.check(_lib.library().vs_enhance_head(
        frame.data_ptr(), dst.data_ptr(), h * w,
        scales.data_ptr() if scales is not None else None, int(do_cb),
        float(p.contrast), float(p.brightness),
        _lib.stream_handle(frame.device)), "enhance_head")
    torch.cuda.synchronize()


def _tail_into(p, x, dst, gray):
    """K4's tail mode through its C entry into the views ``dst`` (u8) and
    ``gray`` (float32)."""
    from video_stab_tpu_torch.kernels import _lib
    from video_stab_tpu_torch.kernels import enhance as kenh
    h, w, _ = x.shape
    _, do_gamma = kenh._stages(p)
    _lib.check(_lib.library().vs_enhance_tail(
        x.data_ptr(), dst.data_ptr(), gray.data_ptr(), h * w, int(do_gamma),
        float(p.gamma), _lib.stream_handle(x.device)), "enhance_tail")
    torch.cuda.synchronize()


def _offset_view(n, dtype, dev, shape, offset=1):
    """A contiguous view ``offset`` elements into a fresh buffer (not
    16-byte aligned for offset 1)."""
    buf = torch.empty(n + offset, dtype=dtype, device=dev)
    view = buf[offset:].view(shape)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


# (33, 80), (37, 53): pixel counts that are not a multiple of the head's
# 512-pixel or the tail's 128-pixel warp step; (8, 64): exactly one head
# step and four tail steps; (3, 7): less than a step, the scalar loop
# alone.
@pytest.mark.parametrize("shape", [(1080, 1920), (37, 53), (64, 96),
                                   (33, 80), (8, 64), (3, 7)])
@pytest.mark.parametrize("wb", [False, True])
def test_enhance_head_and_tail_bit_for_bit(dev, shape, wb):
    from video_stab_tpu_torch.core.params import EnhancerParams
    from video_stab_tpu_torch.kernels import enhance as kenh
    h, w = shape
    rng = np.random.default_rng(h + w)
    frame = torch.from_numpy(rng.integers(0, 256, (h, w, 3), np.uint8)) \
        .to(dev)
    p = EnhancerParams(brightness=5.0, contrast=1.1, gamma=0.9,
                       enable_white_balance=wb, wb_strength=0.5)
    scales = kenh.white_balance_scales(frame, 0.5) if wb else None
    head = kenh.enhance_head_cuda(p, frame, scales)
    torch.cuda.synchronize()
    p_head = kenh.enhance_head_plain(p, frame, scales)
    assert torch.equal(head, p_head)
    x = head * 1.4 - 30.0                   # a filter's out-of-range values
    # Far outside [0, 255] in both directions, and its ends exactly.
    wide = x.clone().view(-1)
    wide[::97] = 1e4
    wide[1::101] = -1e4
    wide[2::89] = 255.0
    wide[3::83] = 0.0
    wide = wide.view(h, w, 3)
    for xs in (x, wide):
        for gamma in (0.9, 1.0, 1.2):
            pg = EnhancerParams(gamma=gamma)
            out, gray = kenh.enhance_tail_cuda(pg, xs, want_gray=True)
            p_out, p_gray = kenh.enhance_tail_plain(pg, xs, want_gray=True)
            torch.cuda.synchronize()
            assert torch.equal(out, p_out) and torch.equal(gray, p_gray)
            out, none = kenh.enhance_tail_cuda(pg, xs)
            assert none is None and torch.equal(out, p_out)
    # A contiguous view 4 bytes into its buffer (not 16-byte aligned)
    # takes the kernels' scalar loop.
    buf = torch.empty(h * w * 3 + 1, device=dev)
    buf[1:] = x.reshape(-1)
    odd = buf[1:].view(h, w, 3)
    assert odd.is_contiguous() and odd.data_ptr() % 16 != 0
    out, gray = kenh.enhance_tail_cuda(EnhancerParams(gamma=0.9), odd, True)
    p_out, p_gray = kenh.enhance_tail_plain(EnhancerParams(gamma=0.9), odd,
                                            True)
    assert torch.equal(out, p_out) and torch.equal(gray, p_gray)
    raw = torch.empty(h * w * 3 + 1, dtype=torch.uint8, device=dev)
    raw[1:] = frame.reshape(-1)
    head = kenh.enhance_head_cuda(p, raw[1:].view(h, w, 3), scales)
    assert torch.equal(head, kenh.enhance_head_plain(p, frame, scales))
    # Misaligned destinations, with the source aligned and misaligned.
    for src in (frame, raw[1:].view(h, w, 3)):
        dst = _offset_view(h * w * 3, torch.float32, dev, (h, w, 3))
        _head_into(p, src, scales, dst)
        assert torch.equal(dst, p_head)
    for src in (x, odd):
        for gamma in (0.9, 1.2):
            pg = EnhancerParams(gamma=gamma)
            dst = _offset_view(h * w * 3, torch.uint8, dev, (h, w, 3))
            gray = _offset_view(h * w, torch.float32, dev, (h, w))
            _tail_into(pg, src, dst, gray)
            p_out, p_gray = kenh.enhance_tail_plain(pg, src, True)
            assert torch.equal(dst, p_out) and torch.equal(gray, p_gray)


def test_tail_divide_sweep_on_the_card(dev):
    """The tail (u8 and gray) against its plain version, a true division,
    bit for bit over a slice of the float32 in [0, 255] (chip_smoke.py
    sweeps them all): the subnormals, the values around 1 and the values
    up to 255."""
    from video_stab_tpu_torch.core.params import EnhancerParams
    from video_stab_tpu_torch.kernels import enhance as kenh
    top = 0x437F0000                          # 255.0f
    for first, count in ((0, 1 << 24), (0x3F000000, 1 << 24),
                         (top - (1 << 24), (1 << 24) + 1)):
        x = torch.arange(first, first + count, dtype=torch.int32,
                         device=dev).view(torch.float32)
        x = torch.cat([x, x.new_zeros(-count % 3)]).view(1, -1, 3)
        for gamma in (0.9, 1.2):
            p = EnhancerParams(gamma=gamma)
            out, gray = kenh.enhance_tail_cuda(p, x, want_gray=True)
            p_out, p_gray = kenh.enhance_tail_plain(p, x, want_gray=True)
            torch.cuda.synchronize()
            assert torch.equal(out, p_out), (first, gamma)
            assert torch.equal(gray, p_gray), (first, gamma)


def test_enhance_frame_u8_full_route_on_the_card(dev):
    """The full enhancer on the card (K4 head, the filters, K4 tail)
    against the same route on the CPU."""
    from video_stab_tpu_torch.core.enhancer import enhance_frame_u8
    from video_stab_tpu_torch.core.params import EnhancerParams
    from video_stab_tpu_torch.kernels import enhance as kenh
    rng = np.random.default_rng(2)
    frame = rng.integers(0, 256, (120, 160, 3), np.uint8)
    p = EnhancerParams(brightness=5.0, contrast=1.1, gamma=0.9,
                       enable_clahe=True, enable_vibrance=True,
                       enable_unsharp=True, sharpness=1.0,
                       enable_denoise=True, denoise_strength=5.0)
    heads, tails = kenh.HEAD_LAUNCHES, kenh.TAIL_LAUNCHES
    got, gray = enhance_frame_u8(p, torch.from_numpy(frame).to(dev), True)
    assert (kenh.HEAD_LAUNCHES - heads, kenh.TAIL_LAUNCHES - tails) == (1, 1)
    want, want_gray = enhance_frame_u8(p, torch.from_numpy(frame), True)
    # CLAHE bins truncate Lab L, and the card's pow differs from the CPU's
    # by an ulp: a pixel may take the next bin's LUT value, which the
    # unsharp mask and the bilateral spread to its neighbours.
    d = (got.cpu().int() - want.int()).abs()
    assert float((d <= 1).float().mean()) >= 0.99
    dg = (gray.cpu() - want_gray).abs()
    assert float((dg <= 1.0).float().mean()) >= 0.99


BORDER_TYPES = ["black", "replicate", "reflect", "reflect_101", "wrap",
                "fade", "crop_n_zoom"]


@pytest.mark.parametrize("border", BORDER_TYPES)
@pytest.mark.parametrize("model", ["similarity", "homography"])
def test_bordered_emit_matches_the_cpu(dev, border, model):
    """One bordered emit warp (K1 or K2 around the pad, the fade blend or
    the crop-and-zoom) on the card against the CPU, three emits in a row
    for the fade history."""
    from video_stab_tpu_torch.core import stabilizer as tstab
    from video_stab_tpu_torch.core.params import StabilizerParams
    from video_stab_tpu_torch.core.state import stabilizer_state_init
    from video_stab_tpu_torch.ops.warp import BORDER_CONSTANT
    kw = dict(border_size=12, border_type=border)
    if border == "crop_n_zoom":
        kw = dict(border_size=12, crop_n_zoom=True)
    p = StabilizerParams(**kw, motion_model=model, fade_duration=3)
    frame = torch.from_numpy(
        _textured(90, 120, 3).astype(np.uint8)[:, :, None].repeat(3, 2))
    outs = {}
    for d in (torch.device("cpu"), dev):
        st = stabilizer_state_init(p, 90, 120, d)
        f = frame.to(d)
        if model == "homography":
            m = torch.tensor([[1.01, 0.02, -3.0], [-0.015, 0.99, 2.5],
                              [1e-5, -2e-5, 1.0]], device=d)
            warp = lambda img, m=m: tstab.warp_perspective_fast(  # noqa: E731
                img, m, border_mode=BORDER_CONSTANT)
        else:
            m = torch.from_numpy(_rigid(1.5, 3.3, -2.1, cx=60, cy=45)
                                 .astype(np.float32)).to(d)
            warp = lambda img, m=m: tstab.warp_affine_u8(  # noqa: E731
                img, m, border_mode=BORDER_CONSTANT)
        seq = []
        for _ in range(3):
            st, out = tstab._warp_bordered(p, st, f, warp)
            seq.append(out.cpu())
        outs[d.type] = (seq, st.fade_history.cpu(), int(st.fade_count))
    (c_seq, c_hist, c_n), (g_seq, g_hist, g_n) = outs["cpu"], outs["cuda"]
    assert c_n == g_n
    for a, b in zip(c_seq, g_seq):
        assert a.shape == b.shape
        if model == "similarity":
            assert torch.equal(a, b)
        else:
            # The homography's inverse is torch ops on each device; the
            # card's linalg.cross fuses its multiply-adds, which moves a
            # source coordinate by an ulp and can flip a .5 rounding tie.
            d = (a.int() - b.int()).abs()
            assert int(d.max()) <= 1
            assert float((d == 0).float().mean()) >= 0.999
    assert torch.allclose(c_hist, g_hist, atol=1e-4, rtol=0)


def test_auto_zoom_crop_and_i420_match_the_cpu(dev):
    import cv2

    from video_stab_tpu_torch.core import autozoomcrop as tazc
    from video_stab_tpu_torch.core.params import AutoZoomCropParams
    from video_stab_tpu_torch.ops.color import bgr_to_i420
    img = _textured(360, 640, 4).astype(np.uint8)[:, :, None].repeat(3, 2)
    m = cv2.getRotationMatrix2D((320.0, 180.0), 6.0, 1.0)
    img = cv2.warpAffine(img, m, (640, 360))
    for keep in (True, False):
        p = AutoZoomCropParams(keep_input_size=keep)
        reads = tazc.RECT_READS
        got = tazc.auto_zoom_crop_step(p, torch.from_numpy(img).to(dev))
        assert tazc.RECT_READS == reads         # K7: no host read
        want = tazc.auto_zoom_crop_step(p, torch.from_numpy(img))
        assert tazc.RECT_READS - reads >= 1     # the CPU's chunked loop
        d = (got.cpu().int() - want.int()).abs()
        assert int(d.max()) <= 1 and float((d == 0).float().mean()) >= 0.999
        rect_g = tazc.interior_rect(torch.from_numpy(
            (img[..., 0] > 10).astype(np.float32) * 255).to(dev))
        rect_c = tazc.interior_rect(torch.from_numpy(
            (img[..., 0] > 10).astype(np.float32) * 255))
        assert torch.equal(rect_g.cpu(), rect_c)
    y_g = bgr_to_i420(torch.from_numpy(img).to(dev)).cpu()
    y_c = bgr_to_i420(torch.from_numpy(img))
    d = (y_g.int() - y_c.int()).abs()
    assert int(d.max()) <= 1 and float((d == 0).float().mean()) >= 0.999


@pytest.mark.parametrize("max_iters", MAX_ITERS)
@pytest.mark.parametrize("name", list(MASKS))
def test_interior_rect_kernel_matches_plain(dev, name, max_iters):
    """K7 against the plain chunked loop (on the CPU) and the JAX
    package's rect (``azc_masks.RECTS``, held to JAX by the CPU tests) on
    every mask, after at most 0, 1, 31, 32, 33 moves and the whole loop:
    one launch a call, no host read."""
    from video_stab_tpu_torch.core import autozoomcrop as tazc
    from video_stab_tpu_torch.kernels import azc as kazc
    m = torch.from_numpy(MASKS[name])
    want = tazc.interior_rect(m, max_iters)
    md = m.to(dev)
    reads, launches = tazc.RECT_READS, kazc.RECT_KERNEL_LAUNCHES
    got = tazc.interior_rect(md, max_iters)
    assert tazc.RECT_READS == reads
    assert kazc.RECT_KERNEL_LAUNCHES == launches + 1
    assert got.dtype == torch.int32 and got.device == md.device
    assert tuple(got.tolist()) == tuple(want.tolist()) \
        == RECTS[name][max_iters]


@pytest.mark.parametrize("deg", [0.0, 20.0, 60.0])
def test_interior_rect_kernel_at_1080p_without_host_sync(dev, deg):
    """K7 at the restream cell's shape (more rows and columns than the
    block has threads) on a content mask with no holes and on rotated ones
    (hundreds of moves): the plain loop's rect, with torch's sync debug
    mode raising on any host sync during the call."""
    import cv2

    from video_stab_tpu_torch.core import autozoomcrop as tazc
    from video_stab_tpu_torch.kernels import azc as kazc
    full = np.full((1080, 1920), 255.0, np.float32)
    rot = cv2.getRotationMatrix2D((960.0, 540.0), deg, 1.0)
    m = torch.from_numpy(cv2.warpAffine(full, rot, (1920, 1080)))
    want = tazc.interior_rect(m)
    md = m.to(dev)
    torch.cuda.synchronize()
    launches = kazc.RECT_KERNEL_LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tazc.interior_rect(md)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kazc.RECT_KERNEL_LAUNCHES == launches + 1
    assert torch.equal(got.cpu(), want), (got.cpu(), want)
    if deg:
        x0, y0, x1, y1 = want.tolist()
        assert (x1 - x0) + (y1 - y0) < 1919 + 1079 - 100


def _k8_against_plain(dev, frame: np.ndarray, thresh: float, ksize: int
                      ) -> None:
    """K8 on the card against the plain mask on the card and on the CPU,
    bit for bit, one launch, no host sync during the call."""
    from video_stab_tpu_torch.core import autozoomcrop as tazc
    from video_stab_tpu_torch.kernels import azc as kazc
    f = torch.from_numpy(frame)
    fd = f.to(dev)
    want = tazc.content_mask_plain(fd, thresh, ksize)
    torch.cuda.synchronize()
    launches = kazc.MASK_KERNEL_LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tazc.content_mask(fd, thresh, ksize)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kazc.MASK_KERNEL_LAUNCHES == launches + 1
    assert got.dtype == torch.float32 and got.shape == frame.shape[:2]
    assert torch.equal(got, want), int((got != want).sum())
    assert torch.equal(got.cpu(), tazc.content_mask_plain(f, thresh, ksize))


@pytest.mark.parametrize("ksize", MASK_KSIZES)
@pytest.mark.parametrize("shape", MASK_SHAPES)
def test_content_mask_kernel_matches_plain(dev, shape, ksize):
    """K8 against the plain mask on odd shapes (tiles cut raggedly) at
    every threshold, on random colours turned with black corners and on
    values on and within 0.5 of each threshold."""
    h, w = shape
    for i, t in enumerate(MASK_THRESHOLDS):
        _k8_against_plain(dev, mask_frame(h, w, ksize + i,
                                          deg=10.0 + 2 * ksize), t, ksize)
        _k8_against_plain(dev, mask_frame(h, w, ksize + i, deg=25.0,
                                          near=t), t, ksize)


@pytest.mark.parametrize("thresh", MASK_THRESHOLDS)
def test_content_mask_kernel_at_1080p(dev, thresh):
    """K8 at the restream cell's shape, ksize 5: the cell's pool frames
    (``benchmark_torch/frames.py``, no black), frames turned 10-30 deg
    with black corners, and values within 0.5 of the threshold."""
    from benchmark_torch.frames import make_pool
    pool = make_pool(2 ** 31 + 7, 4, 1, 1080, 1920, dev)
    for i in range(pool.shape[0]):
        _k8_against_plain(dev, pool[i, 0].float().cpu().numpy(), thresh, 5)
    for seed, deg in ((1, 10.0), (2, 20.0), (3, 30.0)):
        _k8_against_plain(dev, mask_frame(1080, 1920, seed, deg=deg),
                          thresh, 5)
    _k8_against_plain(dev, mask_frame(1080, 1920, 4, deg=15.0, near=thresh),
                      thresh, 5)


def test_content_mask_kernel_refuses(dev):
    """K8's wrapper refuses another dtype, a non-contiguous frame, a
    frame that is not (H, W, 3), an empty one and a ksize it has no
    ellipse for, and launches nothing."""
    from video_stab_tpu_torch.kernels import azc as kazc
    f = torch.from_numpy(mask_frame(40, 70, 3)).to(dev)
    launches = kazc.MASK_KERNEL_LAUNCHES
    for bad, ksize, match in ((f.double(), 5, "float32"),
                              (f.transpose(0, 1), 5, "contiguous"),
                              (f[..., 0].contiguous(), 5, "-d"),
                              (f[..., :2].contiguous(), 5, "H, W, 3"),
                              (f[:0], 5, "H, W, 3"), (f, 6, "ksize"),
                              (f, kazc.MASK_MAX_KSIZE + 2, "ksize")):
        with pytest.raises(ValueError, match=match):
            kazc.content_mask_cuda(bad, 10.0, ksize)
    assert kazc.MASK_KERNEL_LAUNCHES == launches


def test_restream_chain_with_k8_matches_the_plain_mask(dev, monkeypatch):
    """The restream cell's chain (its config and pool) over 48 calls: the
    delivered I420 frames with K8 and with the plain mask on the card are
    identical, and K8 runs once a zoom-crop, beside K7."""
    import json
    from pathlib import Path

    from benchmark_torch.frames import make_pool
    from benchmark_torch.systems.chain_azc import System
    from video_stab_tpu_torch.core import autozoomcrop as tazc
    from video_stab_tpu_torch.kernels import azc as kazc
    from video_stab_tpu_torch.utils import telemetry
    root = Path(__file__).resolve().parent.parent
    cfg = json.loads((root / "benchmark_torch" / "configs"
                      / "chain_azc_kalman_1080p.json").read_text())
    seed = 2 ** 31 + 11
    pool = make_pool(seed, cfg["pool_frames"], 1, cfg["height"],
                     cfg["width"], dev).cpu().numpy()

    def counts():
        c = telemetry.counters()
        return (kazc.MASK_KERNEL_LAUNCHES, c.get("azc_mask_kernel", 0),
                kazc.RECT_KERNEL_LAUNCHES, c.get("azc_rect_kernel", 0))

    def run():
        before = counts()
        system = System(cfg, pool, seed, dev)
        outs = [system.call(i) for i in range(48)]
        system.close()
        return outs, [a - b for a, b in zip(counts(), before)]

    got, n = run()
    assert n == [48, 48, 48, 48]
    monkeypatch.setattr(tazc, "content_mask", tazc.content_mask_plain)
    want, n = run()
    assert n == [0, 0, 48, 48]
    assert [o is None for o in got] == [o is None for o in want]
    assert sum(o is not None for o in got) >= 24
    for a, b in zip(got, want):
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rich", [(), (4, 5)], ids=["starved",
                                                         "recovers"])
def test_drone_config_on_starved_frames_matches_the_reference(dev, rich):
    """The drone cell's config (``benchmark_torch/configs/
    drone_hf_1080p.json``) at 1080p on frames with too few corners, so the
    starvation counter passes 2 and CLAHE's gray is selected on the card
    (with two frames that show more of the world, it resets and CLAHE is
    dropped again): the counter after each call equals the plain
    reference's (``benchmark_torch/reference/stream_drone.py``, run on the
    card), and the delivered frames are within the cell's limits of its
    frames."""
    import json
    from pathlib import Path

    from drone_frames import starved_pool

    from benchmark_torch import compare
    from benchmark_torch.frames import stream_seed
    from benchmark_torch.reference import stream_drone
    from benchmark_torch.systems.stabilize_only import System
    root = Path(__file__).resolve().parent.parent
    cfg = json.loads((root / "benchmark_torch" / "configs"
                      / "drone_hf_1080p.json").read_text())
    seed, n_calls = 2 ** 31 + 11, 40
    pool = starved_pool(8, cfg["height"], cfg["width"], rich)
    system = System(cfg, pool, stream_seed(seed), dev)
    got, counters = {}, []
    for i in range(n_calls):
        out = system.call(i)
        if out is not None:
            got[i] = out
        counters.append(int(system.chain.state.stab.starvation_counter))
    calls = sorted(c for c in got if c % 6 == 0) + [n_calls - 1]
    pool_dev = torch.from_numpy(pool).to(dev)
    ref = stream_drone._Stream(cfg, pool_dev, n_calls, lambda x: x)
    ref.settle()
    assert counters == ref.starved.tolist()
    selected = ref.clahe_on[1:]
    assert selected.any()
    if rich:
        assert not selected.all() and min(counters[8:]) == 0
    want = stream_drone.outputs(cfg, pool_dev, n_calls, seed, calls)
    checks = compare.numbers({c: got[c] for c in calls}, want)
    limits = cfg["correct_limits"]
    assert all(checks[k] <= limits[k] for k in limits), checks


def test_translation_prior_matches_the_cpu(dev):
    from video_stab_tpu_torch.ops.lk import global_translation_prior
    world = _textured(160, 200, 5)
    prev = np.ascontiguousarray(world[20:155, 20:140])
    for dx, dy in ((0, 0), (7, -4), (-13, 9)):
        curr = np.ascontiguousarray(world[20 - dy:155 - dy,
                                          20 - dx:140 - dx])
        g = global_translation_prior(torch.from_numpy(prev).to(dev),
                                     torch.from_numpy(curr).to(dev))
        c = global_translation_prior(torch.from_numpy(prev),
                                     torch.from_numpy(curr))
        assert torch.equal(g.cpu(), c) and c.tolist() == [dx, dy]


def test_pipelined_chain_on_the_card(dev):
    """The pipelined chain's pinned copies hand back the unpipelined
    chain's frames one call late, I420 and two-pass roll included."""
    from video_stab_tpu_torch.core.chain import ProcessingChain
    from video_stab_tpu_torch.core.params import (AutoZoomCropParams,
                                                  EnhancerParams, ModeParams,
                                                  RollCorrectionParams,
                                                  StabilizerParams)
    rng = np.random.default_rng(8)
    frames = [np.ascontiguousarray(np.roll(
        _textured(96, 128, 6), tuple(rng.integers(-3, 4, 2)), (0, 1))
        .astype(np.uint8)[:, :, None].repeat(3, 2)) for _ in range(12)]
    kw = dict(mode=ModeParams(enhancer_enabled=True,
                              roll_correction_enabled=True,
                              stabilizer_enabled=True),
              enhancer=EnhancerParams(contrast=1.1, enable_unsharp=True,
                                      sharpness=1.0),
              roll=RollCorrectionParams(angle_filter_min=-70.0,
                                        angle_filter_max=70.0),
              stabilizer=StabilizerParams(
                  smoothing_radius=5, analysis_width=64, analysis_height=48,
                  max_corners=32, ransac_hypotheses=32,
                  motion_prediction=True),
              azc=AutoZoomCropParams(enabled=True), output_format="i420")
    draws = np.random.default_rng(9).random((len(frames), 32, 2))

    def inject(k):
        it = iter(range(len(frames)))

        def f(n_valid):
            hi = max(int(n_valid), 1)
            return torch.from_numpy(np.minimum(np.floor(draws[next(it)] * hi),
                                               hi - 1).astype(np.int64))
        return f
    plain = ProcessingChain(**kw, ransac_draws=inject(0))
    piped = ProcessingChain(**kw, pipelined=True, ransac_draws=inject(1))
    want = [o for o in (plain.process(f) for f in frames) if o is not None]
    got = [o for o in (piped.process(f) for f in frames) if o is not None]
    while (o := plain.flush()) is not None:
        want.append(o)
    while (o := piped.flush()) is not None:
        got.append(o)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.shape == (144, 128)
        np.testing.assert_array_equal(a, b)


# --- the remaining variants: legacy shapes, canvas, detectors, deep ----------

def test_lk_kernel_matches_plain_at_the_legacy_shape(dev):
    """K6 at the legacy stabilizer's shape (1080 x 1920, 4 levels, win 21,
    30 iterations, eps 0.01, 200 GFTT corners at min_distance 30) against
    lk_levels_plain, at the tolerance of the 540 x 960 case."""
    from video_stab_tpu_torch.kernels import lk as klk
    from video_stab_tpu_torch.ops.features import good_features_to_track
    from video_stab_tpu_torch.ops.lk import lk_planes
    prev, curr = _lk_pair(dev, 1080, 1920, 5, (4.6, -7.3))
    pts, mask = good_features_to_track(prev, max_corners=200,
                                       quality_level=0.01, min_distance=30.0)
    assert int(mask.sum()) == 200
    planes = lk_planes(prev, curr, 3)
    before = klk.LAUNCHES
    got = klk.lk_levels(*planes, pts, mask, None, 21, 30, 0.01, 1e-4)
    assert klk.LAUNCHES == before + 1
    want = klk.lk_levels_plain(*planes, pts, mask, None, 21, 30, 0.01, 1e-4)
    torch.cuda.synchronize()
    _check_lk(got, want, 0.01)


def test_corner_kernel_at_1080p(dev):
    """K3 at the legacy GFTT's full 1080 x 1920 against its plain version."""
    from video_stab_tpu_torch.kernels import features as kfeat
    gray = torch.from_numpy(np.round(_textured(1080, 1920, 7))).to(dev)
    resp, peak = kfeat.corner_response(gray)
    p_resp, p_peak = kfeat.corner_response_plain(gray)
    assert float((resp - p_resp).abs().max()) <= 1e-5
    assert torch.equal(peak, p_peak)


CARD_VARIANTS = {
    "canvas": {"enable_virtual_canvas": True},
    "canvas fixed": {"enable_virtual_canvas": True,
                     "adaptive_canvas_size": False},
    "fast": {"feature_detector": "fast"},
    "orb": {"feature_detector": "orb"},
    "brisk": {"feature_detector": "brisk"},
}


@pytest.mark.parametrize("case", list(CARD_VARIANTS))
def test_stabilizer_variants_match_cpu(dev, case):
    """The virtual canvas and the FAST / ORB / BRISK detectors: the card
    against the CPU on the same frames and RANSAC draws, u8 frames within 1
    on >= 99.5 % of pixels; K3 runs on the card for GFTT and ORB, not for
    FAST and BRISK."""
    from video_stab_tpu_torch.core.params import ModeParams, StabilizerParams
    from video_stab_tpu_torch.core.stabilizer import Stabilizer
    from video_stab_tpu_torch.kernels import features as kfeat
    from video_stab_tpu_torch.kernels import warp as kwarp
    p = StabilizerParams(**{**SMALL_STREAM, **CARD_VARIANTS[case]})
    frames = _jittered(20)
    before = (kwarp.LAUNCHES, kfeat.LAUNCHES)
    outs = [_stream(Stabilizer(p, mode=ModeParams(use_cuda=use_cuda),
                               ransac_draws=_draws(len(frames),
                                                   p.ransac_hypotheses, 2, 5)),
                    frames)
            for use_cuda in (False, True)]
    assert kwarp.LAUNCHES > before[0]
    assert (kfeat.LAUNCHES > before[1]) == (case not in ("fast", "brisk"))
    assert len(outs[0]) == len(frames)
    assert _within_one(outs[1], outs[0]) >= 0.995


def test_legacy_stream_matches_cpu(dev):
    """LegacyStabilizer on the card (K1, K3, K6) against the CPU: the same
    re-detect decisions, transforms within 1e-2 px / 1e-4 rad (K6 may
    freeze a point one Newton step apart from the plain version, within
    eps = 0.01 px), u8 frames within 1 on >= 99.5 % of pixels."""
    from video_stab_tpu_torch.core.legacy import LegacyStabilizer
    from video_stab_tpu_torch.core.params import (LegacyStabilizerParams,
                                                  ModeParams)
    from video_stab_tpu_torch.kernels import lk as klk
    p = LegacyStabilizerParams(smoothing_radius=8, max_corners=120,
                               min_distance=8.0, min_tracking_features=10,
                               redetect_interval=6)
    frames = _jittered(24, seed=6)
    runs = []
    for use_cuda in (False, True):
        before = klk.LAUNCHES
        stab = LegacyStabilizer(p, mode=ModeParams(use_cuda=use_cuda))
        outs, tr, red = [], [], []
        for f in frames:
            o = stab.stabilize(f)
            if o is not None:
                outs.append(o)
            if stab.last_metrics:
                tr.append(stab.last_metrics["transform"].cpu().numpy())
                red.append(bool(stab.last_metrics["redetected"]))
        while (o := stab.flush()) is not None:
            outs.append(o)
        assert (klk.LAUNCHES > before) == use_cuda
        runs.append((np.stack(outs), np.array(tr), red))
    (c_out, c_tr, c_red), (g_out, g_tr, g_red) = runs
    assert g_red == c_red and any(c_red)
    np.testing.assert_allclose(g_tr[:, :2], c_tr[:, :2], atol=1e-2, rtol=0)
    np.testing.assert_allclose(g_tr[:, 2], c_tr[:, 2], atol=1e-4, rtol=0)
    assert len(c_out) == len(frames)
    assert _within_one(g_out, c_out) >= 0.995


def test_deep_net_on_the_card_matches_cpu(dev):
    """DeepStabNet on the card (cuDNN) against the CPU: within 1e-4 in the
    float32 config, within the bfloat16 bound of tests/test_torch_deepstab.py
    (2e-2) in the default."""
    from video_stab_tpu_torch.models import deepstab as tdeep
    rng = np.random.default_rng(11)
    x = torch.from_numpy((rng.random((2, 72, 128, 2)) * 255).astype(
        np.float32))
    for cfg, tol in ((tdeep.DeepStabConfig(dtype=torch.float32), 1e-4),
                     (tdeep.DeepStabConfig(), 2e-2)):
        net = tdeep.load_deepstab(tdeep.BUNDLED_WEIGHTS, cfg)
        with torch.no_grad():
            want = net(x)
            got = net.to(dev)(x.to(dev)).cpu()
        assert float((got - want).abs().max()) <= tol


def test_deep_stream_matches_cpu(dev, monkeypatch):
    """Deep stabilization in the float32 network config, the card against
    the CPU: u8 frames within 1 on >= 99.5 % of pixels (no RANSAC draws)."""
    from video_stab_tpu_torch.core import stabilizer as tstab
    from video_stab_tpu_torch.core.params import ModeParams, StabilizerParams
    from video_stab_tpu_torch.models import deepstab as tdeep
    cfg = tdeep.DeepStabConfig(dtype=torch.float32)
    monkeypatch.setattr(tstab, "resolve_deepstab_weights",
                        lambda p, d: tdeep.load_deepstab(
                            tdeep.BUNDLED_WEIGHTS, cfg).to(d))
    p = StabilizerParams(**SMALL_STREAM, deep_stabilization=True)
    frames = _jittered(20, seed=7)
    outs = [_stream(tstab.Stabilizer(p, mode=ModeParams(use_cuda=use_cuda)),
                    frames) for use_cuda in (False, True)]
    assert len(outs[0]) == len(frames)
    assert _within_one(outs[1], outs[0]) >= 0.995


# The multi-stream step (video_stab_tpu_torch/parallel/): K1, K2, K3 and K6
# with a stream axis, one launch for all N streams.
N_STREAMS = 8


def _ring_input(dev, n, q, h, w, ch, seed):
    rng = np.random.default_rng(seed)
    shape = (n, q, h, w) + ((ch,) if ch == 3 else ())
    ring = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
    slots = torch.from_numpy(rng.integers(0, q, n).astype(np.int32))
    return ring.to(dev), slots.to(dev), rng


@pytest.mark.parametrize("shape", [(8, 3, 67, 129), (8, 2, 1080, 1920)])
@pytest.mark.parametrize("mode", [0, 4])
@pytest.mark.parametrize("ch", [1, 3])
@pytest.mark.parametrize("kind", ["affine", "homography"])
def test_batched_warp_kernels_match_plain_and_single_launches(
        dev, kind, ch, mode, shape):
    """K1 / K2 on an (N, Q, H, W, C) ring at per-stream slots, one launch:
    bit for bit against the batched plain version and against N
    single-frame launches of the same kernel."""
    from video_stab_tpu_torch.kernels import warp as kwarp
    n, q, h, w = shape
    ring, slots, rng = _ring_input(dev, n, q, h, w, ch, seed=h + ch + mode)
    if kind == "affine":
        minv = torch.from_numpy(np.stack([
            _rigid(rng.normal(0, 1.0), *rng.normal(0, 6, 2), cx=w / 2,
                   cy=h / 2).reshape(6) for _ in range(n)])
            .astype(np.float32)).to(dev)
        batched, plain, single = (kwarp.warp_affine_u8_batched_cuda,
                                  kwarp.warp_affine_u8_batched_plain,
                                  kwarp.warp_affine_u8_cuda)
        counter = "LAUNCHES"
    else:
        hm = np.tile(np.eye(3), (n, 1, 1)) + rng.normal(0, 1e-3, (n, 3, 3))
        hm[:, 2, :2] = rng.normal(0, 2e-5, (n, 2))
        minv = torch.from_numpy(hm.reshape(n, 9).astype(np.float32)).to(dev)
        batched, plain, single = (kwarp.warp_homography_u8_batched_cuda,
                                  kwarp.warp_homography_u8_batched_plain,
                                  kwarp.warp_homography_u8_cuda)
        counter = "HOMOGRAPHY_LAUNCHES"
    before = getattr(kwarp, counter)
    got = batched(ring, slots, minv, h, w, mode)
    assert getattr(kwarp, counter) == before + 1
    want = plain(ring, slots, minv, h, w, mode)
    singles = torch.stack([single(ring[b, int(slots[b])].contiguous(),
                                  minv[b].contiguous(), h, w, mode)
                           for b in range(n)])
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, singles)


@pytest.mark.parametrize("shape", [(8, 540, 960), (8, 37, 53), (3, 1, 29)])
def test_batched_corner_kernel_matches_plain_and_single_launches(dev,
                                                                shape):
    from video_stab_tpu_torch.kernels import features as kfeat
    gray = torch.from_numpy(np.stack([
        _textured(shape[1], shape[2], seed) for seed in range(shape[0])])
    ).to(dev)
    before = kfeat.LAUNCHES
    resp, peak = kfeat.corner_response(gray)
    assert kfeat.LAUNCHES == before + 1
    want_r, want_p = kfeat.corner_response_plain(gray)
    torch.cuda.synchronize()
    torch.testing.assert_close(resp, want_r, atol=1e-5, rtol=0)
    for b in range(shape[0]):
        r1, p1 = kfeat.corner_response_cuda(gray[b].contiguous())
        assert torch.equal(resp[b], r1) and torch.equal(peak[b], p1)


def test_batched_lk_kernel_matches_plain_and_single_launches(dev):
    """K6 over N = 8 streams' pyramids at 540 x 960 with 200 GFTT corners
    each, one launch: each stream at the plain version's tolerance, and
    identical status, positions, err and steps to 8 single-stream
    launches."""
    from video_stab_tpu_torch.kernels import lk as klk
    from video_stab_tpu_torch.ops.features import good_features_to_track
    from video_stab_tpu_torch.ops.lk import lk_planes
    pairs = [_lk_pair(dev, 540, 960, 10 + b, (6.4 - b, -9.7 + 2 * b))
             for b in range(N_STREAMS)]
    prev = torch.stack([p for p, _ in pairs])
    curr = torch.stack([c for _, c in pairs])
    pts, mask = good_features_to_track(prev, max_corners=200,
                                       quality_level=0.01, min_distance=15.0)
    planes = lk_planes(prev, curr, 2)
    steps = torch.zeros((N_STREAMS, 200), dtype=torch.int32, device=dev)
    before = klk.LAUNCHES
    got = klk.lk_levels_cuda(*planes, pts, mask, None, 15, 20, 0.03, 1e-4,
                             steps=steps)
    assert klk.LAUNCHES == before + 1
    want = klk.lk_levels_plain(*planes, pts, mask, None, 15, 20, 0.03, 1e-4)
    for b in range(N_STREAMS):
        one_steps = torch.zeros(200, dtype=torch.int32, device=dev)
        one = klk.lk_levels_cuda([p[b].contiguous() for p in planes[0]],
                                 [c[b].contiguous() for c in planes[1]],
                                 pts[b].contiguous(), mask[b].contiguous(),
                                 None, 15, 20, 0.03, 1e-4, steps=one_steps)
        torch.cuda.synchronize()
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)
        assert torch.equal(steps[b], one_steps)
        _check_lk([t[b] for t in got], [t[b] for t in want], 0.03)


def _stream_draws(n_streams, n_steps, k, width, seed):
    hooks = [_draws(n_steps, k, width, seed + i) for i in range(n_streams)]

    def inject(n_valid):
        return torch.stack([h(v) for h, v in zip(hooks, n_valid.cpu())])
    return inject


@pytest.mark.parametrize("kw", [{}, {"motion_model": "homography"},
                                {"smoothing_method": "kalman"}])
def test_multistream_on_the_card_matches_cpu(dev, kw):
    """The batched step for 4 streams on the card (one launch of each
    kernel a tick) against the CPU (plain versions), the same frames and
    draws: u8 frames within 1 on >= 99.5 % of pixels; each tick launches
    K6 and the emit warp once, K3 once on re-detect ticks."""
    from video_stab_tpu_torch.core.params import ModeParams, StabilizerParams
    from video_stab_tpu_torch.kernels import features as kfeat
    from video_stab_tpu_torch.kernels import lk as klk
    from video_stab_tpu_torch.kernels import warp as kwarp
    from video_stab_tpu_torch.parallel import MultiStreamStabilizer
    p = StabilizerParams(**{**SMALL_STREAM, **kw})
    width = 4 if p.motion_model == "homography" else 2
    n, ticks = 4, 14
    clips = np.stack([_jittered(ticks, seed=3 + i) for i in range(n)], 1)
    outs, counts = [], []
    for use_cuda in (False, True):
        ms = MultiStreamStabilizer(p, n, mode=ModeParams(use_cuda=use_cuda),
                                   ransac_draws=_stream_draws(
                                       n, ticks, p.ransac_hypotheses,
                                       width, 5))
        got = []
        for t, batch in enumerate(clips):
            before = (kfeat.LAUNCHES, klk.LAUNCHES,
                      kwarp.LAUNCHES + kwarp.HOMOGRAPHY_LAUNCHES)
            out = ms.stabilize_batch(batch)
            after = (kfeat.LAUNCHES, klk.LAUNCHES,
                     kwarp.LAUNCHES + kwarp.HOMOGRAPHY_LAUNCHES)
            counts.append((use_cuda, t, tuple(a - b for a, b in
                                              zip(after, before))))
            if out is not None:
                got.append(out)
        outs.append(np.stack(got))
    assert _within_one(outs[1], outs[0]) >= 0.995
    for use_cuda, t, (k3, k6, k1) in counts:
        if not use_cuda:
            assert (k3, k6, k1) == (0, 0, 0)
        elif t == 0:
            assert (k3, k6, k1) == (1, 0, 0)
        else:
            assert (k6, k1) == (1, 1)
            assert k3 == (1 if t % p.redetect_interval == 0 else 0)


def test_batched_drone_step_on_the_card_matches_cpu(dev):
    """The batched drone step (``benchmark_torch/tests/
    drone_hf_8x1080p_small.json``: 3 streams at 360x640, conditional
    CLAHE, the prior, the HF chain, crop-and-zoom) on the card against
    the CPU over 24 ticks of the cell's frames with the same draws: u8
    frames within 1 on >= 99.9 % of pixels
    (``test_torch_multistream_variants.py``'s bound), transforms within
    1e-3 (K6 holds LK's positions to the plain ladder's within 1e-3 px);
    each tick one K6 and one emit-warp launch and three K9 launches for
    the 3 streams."""
    import json
    from pathlib import Path

    from benchmark_torch.frames import make_pool
    from video_stab_tpu_torch.core.params import ModeParams, StabilizerParams
    from video_stab_tpu_torch.kernels import lk as klk
    from video_stab_tpu_torch.kernels import lk_planes as kplanes
    from video_stab_tpu_torch.kernels import warp as kwarp
    from video_stab_tpu_torch.parallel import MultiStreamStabilizer
    root = Path(__file__).resolve().parent.parent
    cfg = json.loads((root / "benchmark_torch" / "tests"
                      / "drone_hf_8x1080p_small.json").read_text())
    p = StabilizerParams(**cfg["stabilizer"])
    n, ticks = cfg["streams"], 24
    pool = make_pool(2 ** 31 + 11, ticks, n, cfg["height"], cfg["width"],
                     torch.device("cpu")).numpy()
    outs, transforms, counts = [], [], []
    for use_cuda in (False, True):
        ms = MultiStreamStabilizer(p, n, mode=ModeParams(use_cuda=use_cuda),
                                   ransac_draws=_stream_draws(
                                       n, ticks, p.ransac_hypotheses, 2, 5))
        got, tr = [], []
        for batch in pool:
            before = (klk.LAUNCHES, kwarp.LAUNCHES, kplanes.PLANES_LAUNCHES)
            out = ms.stabilize_batch(batch)
            after = (klk.LAUNCHES, kwarp.LAUNCHES, kplanes.PLANES_LAUNCHES)
            if use_cuda and ms.last_metrics:
                counts.append(tuple(a - b for a, b in zip(after, before)))
            if ms.last_metrics:
                tr.append(ms.last_metrics["transform"].cpu().numpy())
            if out is not None:
                got.append(out)
        outs.append(np.stack(got))
        transforms.append(np.stack(tr))
    assert outs[0].shape == (ticks - p.effective_radius + 1, n,
                             cfg["height"], cfg["width"], 3)
    assert _within_one(outs[1], outs[0]) >= 0.999
    np.testing.assert_allclose(transforms[1], transforms[0], atol=1e-3,
                               rtol=0)
    assert counts and all(c == (1, 1, p.lk_levels + 1) for c in counts), \
        counts


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_detector_on_the_card_matches_the_cpu(dev, dtype, tol):
    """The CenterNet detector with the bundled weights (cuDNN on the card,
    oneDNN on the CPU) on 2 textured 384x640 frames: each head within
    ``tol`` of its largest magnitude in bfloat16, absolutely in float32;
    the decode's valid detections identical in float32."""
    from video_stab_tpu_torch.models import detector as tdet
    cfg = tdet.DetectorConfig(dtype=getattr(torch, dtype))
    cpu = tdet.load_detector(tdet.bundled_weights_path(), cfg,
                             device="cpu")
    card = tdet.load_detector(tdet.bundled_weights_path(), cfg, device=dev)
    x = torch.from_numpy(np.stack([
        np.repeat(_textured(384, 640, s)[..., None], 3, -1)
        for s in (1, 2)]))
    with torch.no_grad():
        want, got = cpu(x / 127.5 - 1.0), card(x.to(dev) / 127.5 - 1.0)
    for head in ("heatmap", "size", "offset"):
        scale = float(want[head].abs().max()) if dtype == "bfloat16" else 1
        err = float((want[head] - got[head].cpu()).abs().max())
        assert err <= tol * scale, (head, err, scale)
    if dtype == "float32":
        # The threshold sits in the widest gap between the CPU's 5th to
        # 40th best scores, so no score is near it.
        top = tdet.detect(cpu, x, 0.0, 100)["score"].reshape(-1).sort(
            descending=True).values[:40]
        i = 4 + int((top[4:-1] - top[5:]).argmax())
        thr = float(top[i] + top[i + 1]) / 2
        a, b = tdet.detect(cpu, x, thr, 100), tdet.detect(card, x, thr, 100)
        assert float((a["score"] - thr).abs().min()) > 1e-4
        assert torch.equal(a["valid"], b["valid"].cpu())
        v = a["valid"]
        assert torch.equal(a["class_id"][v], b["class_id"].cpu()[v])
        assert float((a["bbox"][v] - b["bbox"].cpu()[v]).abs().max()) <= 1e-3


def test_app_runs_on_the_card(dev):
    """A small app (enhance -> stabilize, the tracker on) on the card
    through the threaded frame graph: frames delivered, and the chain's
    kernels launched."""
    import time

    from video_stab_tpu_torch.core.params import (EnhancerParams,
                                                  ModeParams,
                                                  StabilizerParams)
    from video_stab_tpu_torch.io.runner import StabilizerApp
    from video_stab_tpu_torch.io.sinks import NullSink
    from video_stab_tpu_torch.kernels import enhance as kenh
    from video_stab_tpu_torch.kernels import lk as klk
    from video_stab_tpu_torch.kernels import warp as kwarp
    from video_stab_tpu_torch.models.tracker import TrackerParams
    from video_stab_tpu_torch.utils.config import AppConfig
    cfg = AppConfig(
        video_source="synthetic:320x192",
        mode=ModeParams(enhancer_enabled=True, stabilizer_enabled=True,
                        tracker_enabled=True),
        enhancer=EnhancerParams(brightness=5.0, contrast=1.1, gamma=0.9),
        stabilizer=StabilizerParams(smoothing_radius=5, analysis_width=160,
                                    analysis_height=96),
        tracker=TrackerParams(processing_width=160, processing_height=96))
    before = (kenh.LAUNCHES, klk.LAUNCHES, kwarp.LAUNCHES)
    sink = NullSink()
    app = StabilizerApp(cfg, sink=sink)
    assert app.device.type == "cuda" and app._tracker.device.type == "cuda"
    app.start()
    deadline = time.monotonic() + 60.0
    while sink.count < 10 and time.monotonic() < deadline:
        time.sleep(0.05)
    app.stop()
    assert sink.count >= 10
    after = (kenh.LAUNCHES, klk.LAUNCHES, kwarp.LAUNCHES)
    assert all(a > b for a, b in zip(after, before)), (before, after)


# --- the wrapper layer's page-locked copies (utils/hostcopy.py) --------------

PIN_COUNTERS = ("pinned_uploads", "pinned_downloads", "pinned_bytes",
                "pageable_copies")


def _pin_counts():
    from video_stab_tpu_torch.utils import telemetry
    c = telemetry.counters()
    return {k: c.get(k, 0) for k in PIN_COUNTERS}


def _pin_delta(before):
    return {k: v - before[k] for k, v in _pin_counts().items()}


@pytest.mark.parametrize("shape", [(1080, 1920, 3), (8, 1080, 1920, 3)])
def test_pinned_download_is_cpu_numpy_bit_for_bit(dev, shape):
    """``to_host`` of a 1080p frame and an 8 x 1080p batch: what
    ``.cpu().numpy()`` gives, in a page-locked block of its own."""
    from video_stab_tpu_torch.utils import hostcopy
    t = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev)
    before = _pin_counts()
    got = hostcopy.to_host(t)
    assert _pin_delta(before) == {"pinned_uploads": 0, "pinned_downloads": 1,
                                  "pinned_bytes": t.numel(),
                                  "pageable_copies": 0}
    want = t.cpu().numpy()
    assert got.dtype == np.uint8 and got.shape == shape
    np.testing.assert_array_equal(got, want)
    assert torch.from_numpy(got).is_pinned()
    again = hostcopy.to_host(t)
    assert not np.shares_memory(got, again)


@pytest.mark.parametrize("case", ["frame", "batch", "strided view",
                                  "channel-reversed view", "cpu tensor",
                                  "float frame"])
def test_pinned_upload_is_the_old_upload(dev, case):
    """``to_device`` at 1080p: the old ``.to()``'s tensor bit for bit, one
    pinned upload counted, and the caller's array overwritten as soon as
    the call returns leaves the uploaded frame as it was."""
    from video_stab_tpu_torch.utils import hostcopy
    rng = np.random.default_rng(21)
    big = rng.integers(0, 256, (8, 1080, 1920, 3), np.uint8)
    x = {"frame": big[0].copy(), "batch": big,
         "strided view": big[:4, ::2, ::2],
         "channel-reversed view": big[1, :, :, ::-1],
         "cpu tensor": torch.from_numpy(big[2].copy()),
         "float frame": big[3].astype(np.float32)}[case]
    want = (x.to(dev, dtype=torch.uint8) if isinstance(x, torch.Tensor) else
            torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8)).to(dev))
    before = _pin_counts()
    got = hostcopy.to_device(x, dev)
    assert _pin_delta(before) == {"pinned_uploads": 1, "pinned_downloads": 0,
                                  "pinned_bytes": want.numel(),
                                  "pageable_copies": 0}
    if isinstance(x, torch.Tensor):
        x.fill_(7)
    else:
        x[...] = 7
    torch.cuda.synchronize()
    assert got.device == want.device and got.dtype == torch.uint8
    assert torch.equal(got, want)


def test_unpinnable_copies_go_pageable_and_are_counted(dev, monkeypatch):
    """Where no page-locked block can be had, both copies fall back to the
    pageable ones, give the same values, and count ``pageable_copies``."""
    from video_stab_tpu_torch.utils import hostcopy
    empty = torch.empty

    def no_pinning(*a, pin_memory=False, **kw):
        if pin_memory:
            raise RuntimeError("cudaHostAlloc: out of memory")
        return empty(*a, **kw)
    monkeypatch.setattr(torch, "empty", no_pinning)
    frame = np.random.default_rng(3).integers(0, 256, (72, 128, 3), np.uint8)
    before = _pin_counts()
    up = hostcopy.to_device(frame, dev)
    down = hostcopy.to_host(up)
    assert _pin_delta(before) == {"pinned_uploads": 0, "pinned_downloads": 0,
                                  "pinned_bytes": 0, "pageable_copies": 2}
    np.testing.assert_array_equal(down, frame)


def _warm_ms(dev, n=4):
    from video_stab_tpu_torch.core.params import ModeParams, StabilizerParams
    from video_stab_tpu_torch.parallel import MultiStreamStabilizer
    ms = MultiStreamStabilizer(StabilizerParams(**SMALL_STREAM), n,
                               mode=ModeParams())
    clips = np.stack([_jittered(24, seed=3 + i) for i in range(n)], 1)
    t = 0
    while ms.stabilize_batch(clips[t]) is None:
        t += 1
    return ms, clips, t + 1


def test_multistream_outputs_stay_their_own(dev):
    """Consecutive ``stabilize_batch`` outputs are distinct arrays in
    page-locked memory, and the first is unchanged after the next calls and
    after ``torch.cuda.synchronize()``: the host allocator never recycles a
    block that a live array holds."""
    ms, clips, t = _warm_ms(dev)
    first = ms.stabilize_batch(clips[t])
    kept = first.copy()
    second = ms.stabilize_batch(clips[t + 1])
    assert second is not first and not np.shares_memory(first, second)
    assert torch.from_numpy(first).is_pinned()
    np.testing.assert_array_equal(first, kept)
    del second
    for i in range(t + 2, t + 6):
        ms.stabilize_batch(clips[i])
    torch.cuda.synchronize()
    np.testing.assert_array_equal(first, kept)


def test_process_input_may_be_overwritten_on_return(dev):
    """The chain fed from one reused buffer, overwritten with junk as soon
    as each ``process()`` returns, delivers what the chain fed fresh arrays
    delivers, bit for bit (the same RANSAC draws on both)."""
    from video_stab_tpu_torch.core.chain import ProcessingChain
    from video_stab_tpu_torch.core.params import (EnhancerParams, ModeParams,
                                                  RollCorrectionParams,
                                                  StabilizerParams)
    frames = _jittered(14)
    draws = np.random.default_rng(9).random((len(frames), 32, 2))

    def chain():
        it = iter(range(len(frames)))

        def inject(n_valid):
            hi = max(int(n_valid), 1)
            return torch.from_numpy(np.minimum(np.floor(draws[next(it)] * hi),
                                               hi - 1).astype(np.int64))
        return ProcessingChain(
            ModeParams(enhancer_enabled=True, roll_correction_enabled=True,
                       stabilizer_enabled=True),
            EnhancerParams(brightness=5.0, contrast=1.1, gamma=0.9),
            RollCorrectionParams(hough_threshold=30),
            StabilizerParams(smoothing_radius=5, analysis_width=128,
                             analysis_height=72, max_corners=32,
                             ransac_hypotheses=32), ransac_draws=inject)
    fresh, reused = chain(), chain()
    want = [fresh.process(f.copy()) for f in frames]
    buf = np.empty_like(frames[0])
    got = []
    for f in frames:
        buf[...] = f
        got.append(reused.process(buf))
        buf[...] = 255 - f
    delivered = [(a, b) for a, b in zip(got, want) if b is not None]
    assert len(delivered) > 0
    assert all(a is None for a, b in zip(got, want) if b is None)
    for a, b in delivered:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("wrapper", ["chain", "multistream", "stabilizer"])
def test_steady_state_calls_count_one_pinned_copy_each_way(dev, wrapper):
    """After warm-up every delivering call uploads once and downloads once
    through pinned memory, its frames' bytes each way, and takes no
    pageable copy."""
    from video_stab_tpu_torch.core.chain import ProcessingChain
    from video_stab_tpu_torch.core.params import (EnhancerParams, ModeParams,
                                                  RollCorrectionParams,
                                                  StabilizerParams)
    from video_stab_tpu_torch.core.stabilizer import Stabilizer
    if wrapper == "multistream":
        ms, clips, t = _warm_ms(dev)
        call, frames = ms.stabilize_batch, clips[t:t + 4]
    else:
        p = StabilizerParams(**SMALL_STREAM)
        obj = Stabilizer(p, mode=ModeParams()) if wrapper == "stabilizer" \
            else ProcessingChain(
                ModeParams(enhancer_enabled=True, stabilizer_enabled=True),
                EnhancerParams(contrast=1.1), RollCorrectionParams(), p)
        call = obj.stabilize if wrapper == "stabilizer" else obj.process
        clip = _jittered(16)
        t = 0
        while call(clip[t]) is None:
            t += 1
        frames = clip[t + 1:t + 5]
    before = _pin_counts()
    outs = [call(f) for f in frames]
    assert all(o is not None for o in outs)
    n = len(frames)
    assert _pin_delta(before) == {
        "pinned_uploads": n, "pinned_downloads": n,
        "pinned_bytes": sum(f.nbytes + o.nbytes for f, o in zip(frames, outs)),
        "pageable_copies": 0}


def test_multistream_tick_syncs_only_to_download(dev):
    """Under torch's sync debug mode a steady-state tick synchronizes once
    to download (attributed to ``utils/hostcopy.py``) and once per GFTT NMS
    read, and not to upload: one fewer than the pageable upload's tick."""
    import warnings

    from video_stab_tpu_torch.utils import telemetry
    ms, clips, t = _warm_ms(dev)
    ticks = clips[t:t + 4]        # two re-detect ticks among them
    torch.cuda.synchronize()
    nms0 = telemetry.counters().get("nms_reads", 0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for f in ticks:
                assert ms.stabilize_batch(f) is not None
        finally:
            torch.cuda.set_sync_debug_mode("default")
    nms = telemetry.counters().get("nms_reads", 0) - nms0
    syncs = [w for w in caught if "synchroniz" in str(w.message)
             and "video_stab_tpu_torch" in w.filename]
    at_copy = [w for w in syncs if w.filename.endswith("utils/hostcopy.py")]
    assert nms > 0
    assert len(at_copy) == len(ticks)
    assert len(syncs) == len(ticks) + nms, [
        (w.filename, w.lineno) for w in syncs]
