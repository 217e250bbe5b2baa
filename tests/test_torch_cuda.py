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


@pytest.mark.parametrize("mode", range(5))
@pytest.mark.parametrize("ch", [1, 3])
def test_warp_kernel_matches_plain(dev, ch, mode):
    from video_stab_tpu_torch.kernels import warp as kwarp
    from video_stab_tpu_torch.ops.warp import invert_affine
    rng = np.random.default_rng(mode)
    shape = (67, 129, ch) if ch == 3 else (67, 129)
    img = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
    ang = np.radians(7.0)
    m = torch.tensor([[np.cos(ang), -np.sin(ang), 9.3],
                      [np.sin(ang), np.cos(ang), -31.6]],
                     dtype=torch.float32).to(dev)
    minv = invert_affine(m).reshape(6).contiguous()
    before = kwarp.LAUNCHES
    got = kwarp.warp_affine_u8(img, m, 50, 160, mode)
    assert kwarp.LAUNCHES == before + 1
    want = kwarp.warp_affine_u8_plain(img, minv, 50, 160, mode)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", range(5))
@pytest.mark.parametrize("ch", [1, 3])
def test_homography_kernel_matches_plain(dev, ch, mode):
    """K2 and its plain version on the same H^-1: bit for bit."""
    from video_stab_tpu_torch.kernels import warp as kwarp
    from video_stab_tpu_torch.ops.warp import invert_homography
    rng = np.random.default_rng(10 + mode)
    shape = (67, 129, ch) if ch == 3 else (67, 129)
    img = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
    ang = np.radians(5.0)
    h = torch.tensor([[np.cos(ang), -np.sin(ang), 9.3],
                      [np.sin(ang), np.cos(ang), -31.6],
                      [4e-4, -3e-4, 1.0]], dtype=torch.float32).to(dev)
    hinv = invert_homography(h).reshape(9).contiguous()
    before = kwarp.HOMOGRAPHY_LAUNCHES
    got = kwarp.warp_homography_u8(img, h, 50, 160, mode, 7.0)
    assert kwarp.HOMOGRAPHY_LAUNCHES == before + 1
    want = kwarp.warp_homography_u8_plain(img, hinv, 50, 160, mode, 7.0)
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


@pytest.mark.parametrize("wb", [False, True])
def test_enhance_kernel_matches_plain(dev, wb):
    from video_stab_tpu_torch.core.params import EnhancerParams
    from video_stab_tpu_torch.kernels import enhance as kenh
    rng = np.random.default_rng(4)
    frame = torch.from_numpy(
        rng.integers(0, 256, (61, 97, 3), dtype=np.uint8)).to(dev)
    p = EnhancerParams(brightness=5.0, contrast=1.1, gamma=0.9,
                       enable_white_balance=wb, wb_strength=0.5)
    out, gray = kenh.enhance_u8(p, frame, want_gray=True)
    scales = kenh.white_balance_scales(frame, 0.5) if wb else None
    p_out, p_gray = kenh.enhance_u8_plain(p, frame, scales, want_gray=True)
    d = (out.int() - p_out.int()).abs()
    assert int(d.max()) <= 1 and float((d == 0).float().mean()) >= 0.999
    assert float((gray - p_gray).abs().max()) <= 1e-3


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
