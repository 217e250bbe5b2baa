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
