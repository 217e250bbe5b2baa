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
