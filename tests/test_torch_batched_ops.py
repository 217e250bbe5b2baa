"""The stream axis of the multi-stream step's ops, on the CPU.

Every op the batched step runs on (N, ...) tensors (GFTT with its greedy
selection, both RANSACs with per-stream draws, the ring ops and smoothers,
motion intent, the warp helpers, the deep network) against the same op
called once per stream: bit for bit where the batched op only broadcasts,
to float32 rounding where a batched matmul or ``eigh`` sums in its own
order. And the per-stream draws of ``ransac_draws_streams`` are each
stream's single-stream draws from the same generator.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from video_stab_tpu_torch.core.stabilizer import to_full_resolution  # noqa: E402
from video_stab_tpu_torch.core.params import StabilizerParams  # noqa: E402
from video_stab_tpu_torch.models.deepstab import (predict_transform,  # noqa: E402
                                                  seeded_deepstab)
from video_stab_tpu_torch.motion import filters as mf  # noqa: E402
from video_stab_tpu_torch.motion.estimate import (  # noqa: E402
    estimate_similarity_ransac,
    ransac_draws,
    ransac_draws_streams,
)
from video_stab_tpu_torch.motion.homography import (  # noqa: E402
    estimate_homography_ransac,
    exp_homography,
    log_homography,
)
from video_stab_tpu_torch.motion.intent import (  # noqa: E402
    analyze_motion_intent,
    intent_correction_scale,
)
from video_stab_tpu_torch.ops.features import good_features_to_track  # noqa: E402
from video_stab_tpu_torch.ops.warp import (invert_affine,  # noqa: E402
                                           invert_homography,
                                           similarity_matrix)

N = 3


def _gray(rng, n, h, w):
    g = rng.integers(0, 256, (n, h, w)).astype(np.float32)
    k = np.ones(3, np.float32) / 3
    for ax in (1, 2):
        g = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), ax, g)
    return torch.from_numpy(g.astype(np.float32))


@pytest.mark.parametrize("kw", [
    dict(max_corners=40, quality_level=0.01, min_distance=7.0),
    dict(max_corners=25, quality_level=0.02, min_distance=15.0),
    dict(max_corners=30, quality_level=0.01, min_distance=5.0,
         roi=torch.tensor([9, 5, 30, 20], dtype=torch.int32)),
    dict(max_corners=30, quality_level=0.01, min_distance=5.0,
         block_size=5),
])
def test_gftt_batched_is_per_stream(kw):
    gray = _gray(np.random.default_rng(5), N, 47, 61)
    pts, mask = good_features_to_track(gray, **kw)
    for b in range(N):
        p1, m1 = good_features_to_track(gray[b], **kw)
        assert torch.equal(pts[b], p1) and torch.equal(mask[b], m1)


def _matches(rng, n, p, model):
    prev = torch.from_numpy(rng.uniform(0, 120, (n, p, 2))
                            .astype(np.float32))
    if model == "homography":
        h = torch.eye(3).repeat(n, 1, 1)
        h[:, :2, 2] = torch.from_numpy(rng.normal(0, 3, (n, 2))
                                       .astype(np.float32))
        h[:, 2, :2] = torch.from_numpy(rng.normal(0, 1e-4, (n, 2))
                                       .astype(np.float32))
        ph = torch.cat([prev, torch.ones(n, p, 1)], -1) @ h.transpose(1, 2)
        curr = ph[..., :2] / ph[..., 2:]
    else:
        a = torch.from_numpy(rng.normal(0, 0.02, n).astype(np.float32))
        m = similarity_matrix(torch.tensor(rng.normal(0, 3, n),
                                           dtype=torch.float32),
                              torch.tensor(rng.normal(0, 3, n),
                                           dtype=torch.float32), a)
        curr = prev @ m[:, :, :2].transpose(1, 2) + m[:, None, :, 2]
    curr = curr + torch.from_numpy(rng.normal(0, 0.3, (n, p, 2))
                                   .astype(np.float32))
    out = rng.random((n, p)) < 0.2              # outliers
    curr = torch.where(torch.from_numpy(out)[..., None], curr + 25.0, curr)
    mask = torch.from_numpy(rng.random((n, p)) > 0.1)
    mask[-1, :] = False                         # a stream with no point
    return prev, curr, mask


def test_similarity_ransac_batched_is_per_stream():
    rng = np.random.default_rng(2)
    prev, curr, mask = _matches(rng, N, 40, "similarity")
    gens = [torch.Generator().manual_seed(10 + i) for i in range(N)]
    draws = ransac_draws_streams(gens, 64, mask.sum(-1).to(torch.int32))
    m, ok, inl = estimate_similarity_ransac(prev, curr, mask, draws=draws,
                                            n_hypotheses=64)
    assert not ok[-1] and torch.equal(m[-1], torch.eye(2, 3))
    for b in range(N):
        m1, ok1, inl1 = estimate_similarity_ransac(
            prev[b], curr[b], mask[b], draws=draws[b], n_hypotheses=64)
        assert torch.equal(m[b], m1) and torch.equal(ok[b], ok1) \
            and torch.equal(inl[b], inl1)


def test_stream_draws_are_each_generators_single_draws():
    n_valid = torch.tensor([17, 0, 40], dtype=torch.int32)
    gens = [torch.Generator().manual_seed(3 + i) for i in range(3)]
    got = ransac_draws_streams(gens, 50, n_valid, width=4)
    for b in range(3):
        g = torch.Generator().manual_seed(3 + b)
        assert torch.equal(got[b], ransac_draws(g, 50, n_valid[b], width=4))
    # Drawing with the generators (no draws given) takes the same numbers.
    rng = np.random.default_rng(4)
    prev, curr, mask = _matches(rng, 3, 30, "similarity")
    n_valid = mask.sum(-1).to(torch.int32)
    want = estimate_similarity_ransac(
        prev, curr, mask, n_hypotheses=20, draws=ransac_draws_streams(
            [torch.Generator().manual_seed(i) for i in range(3)], 20,
            n_valid))
    got = estimate_similarity_ransac(
        prev, curr, mask, n_hypotheses=20,
        generator=[torch.Generator().manual_seed(i) for i in range(3)])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_homography_ransac_batched_is_per_stream():
    rng = np.random.default_rng(3)
    prev, curr, mask = _matches(rng, N, 40, "homography")
    gens = [torch.Generator().manual_seed(20 + i) for i in range(N)]
    draws = ransac_draws_streams(gens, 64, mask.sum(-1).to(torch.int32),
                                 width=4)
    h, ok, inl = estimate_homography_ransac(prev, curr, mask, draws=draws,
                                            n_hypotheses=64)
    assert not ok[-1] and torch.equal(h[-1], torch.eye(3))
    for b in range(N):
        h1, ok1, inl1 = estimate_homography_ransac(
            prev[b], curr[b], mask[b], draws=draws[b], n_hypotheses=64)
        assert torch.equal(ok[b], ok1) and torch.equal(inl[b], inl1)
        torch.testing.assert_close(h[b], h1, atol=1e-5, rtol=1e-5)
    p = StabilizerParams(analysis_width=64, analysis_height=48)
    full = to_full_resolution(p, (96, 128, 3), h)
    logs = log_homography(full)
    for b in range(N):
        torch.testing.assert_close(
            full[b], to_full_resolution(p, (96, 128, 3), h[b]), atol=0,
            rtol=0)
        torch.testing.assert_close(logs[b], log_homography(full[b]),
                                   atol=1e-6, rtol=0)
        torch.testing.assert_close(exp_homography(logs)[b],
                                   exp_homography(logs[b]), atol=1e-6,
                                   rtol=0)
        torch.testing.assert_close(invert_homography(full)[b],
                                   invert_homography(full[b]), atol=0,
                                   rtol=0)


def _rings(rng, n, c):
    ring = torch.from_numpy(np.cumsum(rng.normal(0, 2, (n, 128, c)), axis=1)
                            .astype(np.float32))
    n_path = torch.tensor([3, 40, 130][:n], dtype=torch.int32)
    e = torch.clamp(n_path - 6, min=0)
    return ring, n_path, e


@pytest.mark.parametrize("c", [3, 9])
def test_ring_ops_and_smoothers_batched_are_per_stream(c):
    rng = np.random.default_rng(c)
    ring, n_path, e = _rings(rng, 3, c)
    value = torch.from_numpy(rng.normal(0, 1, (3, c)).astype(np.float32))
    pushed = mf.ring_push(ring, n_path, value)
    radius = torch.tensor([2, 5, 8], dtype=torch.int32)
    kernel = mf.gaussian_kernel(2.0)
    ar = mf.adaptive_radius(ring, n_path, 15)
    box = mf.box_filter_emit(ring, n_path, e, radius, 8)
    gauss = mf.gaussian_filter_emit(ring, n_path, e, kernel)
    z = mf.ring_get(ring, e)
    kst = mf.kalman_init(z)
    kst2, ksm = mf.kalman_step(kst, z + 1.0)
    bst = torch.from_numpy(rng.normal(0, 1, (3, 4, c)).astype(np.float32))
    bst2, bsm = mf.butterworth_cascade(bst, z, 0.1, 4)
    idx = torch.stack([e, e - 1, n_path - 1], dim=1)
    got_idx = mf.ring_get(ring, idx)
    for b in range(3):
        assert torch.equal(pushed[b], mf.ring_push(ring[b], n_path[b],
                                                   value[b]))
        assert torch.equal(got_idx[b], mf.ring_get(ring[b], idx[b]))
        assert torch.equal(ar[b], mf.adaptive_radius(ring[b], n_path[b], 15))
        assert torch.equal(box[b], mf.box_filter_emit(
            ring[b], n_path[b], e[b], radius[b], 8))
        assert torch.equal(gauss[b], mf.gaussian_filter_emit(
            ring[b], n_path[b], e[b], kernel))
        k1 = mf.kalman_init(z[b])
        k2, s1 = mf.kalman_step(k1, z[b] + 1.0)
        assert torch.equal(kst["x"][b], k1["x"]) \
            and torch.equal(kst["p"][b], k1["p"])
        assert torch.equal(kst2["x"][b], k2["x"]) \
            and torch.equal(kst2["p"][b], k2["p"]) \
            and torch.equal(ksm[b], s1)
        b2, s2 = mf.butterworth_cascade(bst[b], z[b], 0.1, 4)
        assert torch.equal(bst2[b], b2) and torch.equal(bsm[b], s2)


def test_intent_and_warp_helpers_batched_are_per_stream():
    rng = np.random.default_rng(9)
    ring, n_path, e = _rings(rng, 3, 3)
    ring = ring.diff(dim=1, prepend=torch.zeros(3, 1, 3))   # per-frame
    motion = mf.ring_get(ring, e)
    intent = analyze_motion_intent(ring, n_path, motion, e)
    scale = intent_correction_scale(intent, motion, e)
    m = similarity_matrix(motion[:, 0], motion[:, 1], motion[:, 2])
    for b in range(3):
        i1 = analyze_motion_intent(ring[b], n_path[b], motion[b], e[b])
        assert torch.equal(intent[b], i1)
        assert torch.equal(scale[b], intent_correction_scale(i1, motion[b],
                                                             e[b]))
        m1 = similarity_matrix(motion[b, 0], motion[b, 1], motion[b, 2])
        assert torch.equal(m[b], m1)
        assert torch.equal(invert_affine(m)[b], invert_affine(m1))


def test_deep_network_on_n_pairs_is_per_pair():
    net = seeded_deepstab(3)
    # A network with a non-zero head, so that the outputs mean something.
    with torch.no_grad():
        net.dense1.weight.normal_(0, 0.1, generator=torch.Generator()
                                  .manual_seed(1))
    rng = np.random.default_rng(6)
    prev, curr = _gray(rng, N, 48, 64), _gray(rng, N, 48, 64)
    out = predict_transform(net, prev, curr)
    assert out.shape == (N, 3)
    for b in range(N):
        torch.testing.assert_close(out[b], predict_transform(net, prev[b],
                                                             curr[b]),
                                   atol=1e-5, rtol=0)
