"""The plain reference of the fused chain with the homography model.

It replays a stream from its first frame and returns the frames the
program delivers at the sampled calls, as ``stream.py`` does for the
similarity model, with every stage computed for a whole block of frames
at once. The semantics are those the program states
(``core/chain.py:_pre_stages``, ``core/stabilizer.py``,
``motion/homography.py``); the homography pieces are written here from
those statements, not copied:

- the two-pass roll: per frame K4's enhance and the gray of the
  unsaturated frame, the smoothed roll angle from that gray, the
  saturated frame rotated whole about its centre with a replicated
  border; the analysis gray is taken from the rotated u8 frame, and the
  rotated frame is what is queued;
- per frame k >= 1: LK from frame k - 1 onto frame k with the points
  detected on k - 1 (k - 1 even) or tracked onto it (k - 1 odd);
- RANSAC with 4-point draws: stream s draws from a generator on the
  pool's device seeded with ``frames.stream_seed(seed) + s``, one
  ``torch.rand((K, 4))`` an analyze step (``draw_table``); the valid
  points are compacted to the front and draw d picks the
  floor(d * max(n_valid, 1))-th, clamped;
- each hypothesis the exact homography through its four draws (H[2, 2] =
  1), rejected where |det| of its 8 x 8 system is <= 1e-8, the solve is
  not finite or the four draws are not distinct; a valid point is an
  inlier where its squared reprojection error is below threshold^2; the
  first hypothesis with the most inliers wins;
- its inliers refit by the Hartley-normalized DLT (each point set moved
  to mean 0 and mean distance sqrt(2) over the inliers), H[2, 2] = 1; the
  identity under 8 valid points or under 4 inliers;
- H conjugated to full resolution, S H S^-1 with S = diag(W / Wa, H / Ha,
  1), scaled to det 1 and mapped to sl(3) by the 12-term series
  log(I + X) = X - X^2 / 2 + ...; the 9 entries pushed as path entry
  k - 1, the cumulative path one float32 add an entry;
- the call c >= effective_radius - 1 delivers frame e = c - r + 1: the box
  mean of the path over [e - r, e + r] (clipped to the known entries; the
  path entry itself where n <= r) at the adaptive radius (the variance of
  the last <= 20 path entries of the translation, [2] and [5], plus 1000x
  that of the rotation (l01 - l10) / 2; int(clamp(2 sqrt(.), 5, 25)), the
  configured radius under 10 entries) clamped to [2, 8]; the correction
  exp(raw + smoothed - path) with no motion-intent scaling; one
  projective warp of the queued frame, bilinear, constant border.

Where this file departs from how the program computes the same thing:
the 4-point systems are solved by ``torch.linalg.solve_ex`` with the
determinant from ``torch.linalg.det`` (the program: one
``lu_factor_ex``); the refit's null vector is the last right singular
vector of the weighted 2N x 9 system (``torch.linalg.svd``; the program:
``eigh`` of the 9 x 9 normal matrix); the determinant of the SL(3)
scaling is ``torch.linalg.det`` (the program: a cross product); exp is a
Taylor series after scaling and squaring (the program:
``torch.linalg.matrix_exp``); the warp's inverse map is exp(-correction)
(the program: the adjugate of exp(correction) over its determinant).

``precision``: every stage's result rounded to it, as in ``stream.py``.
A configuration names this file as its ``"reference":
"stream_homography"``; ``check`` refuses what it does not model.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark_torch import frames
from benchmark_torch.reference import ops
from benchmark_torch.reference.stream import (READS, _blocks, _roll_angles,
                                              _roll_detect, _rounder)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BLOCK = 64          # frames per block of the analysis stages
ROT_BLOCK = 8       # full-size frames per block of the roll's rotation
LOG_TERMS = 12      # the program's series
EXP_TERMS = 12      # Taylor terms of exp after scaling to norm <= 1/4

FIXED = {"system": "chain", "streams": 1}
FIXED_STAB = {"redetect_interval": 2, "motion_model": "homography"}
TOP = {"system", "reference", "source", "height", "width", "streams",
       "pool_frames", "assumed", "correct_limits", *READS}


def check(cfg: dict) -> None:
    """Raise ValueError where ``cfg`` asks for what this reference does
    not model: another system, several streams, a key it does not read, a
    stage left out, another motion model or re-detection interval."""
    for key, want in FIXED.items():
        if cfg.get(key) != want:
            raise ValueError(f"the homography reference models {key} = "
                             f"{want!r} only, not {cfg.get(key)!r}")
    extra, missing = set(cfg) - TOP, set(READS) - set(cfg)
    if extra or missing:
        raise ValueError(f"the homography reference does not model the "
                         f"keys {sorted(extra)}; missing {sorted(missing)}")
    for group, keys in READS.items():
        extra = set(cfg[group]) - keys
        if extra:
            raise ValueError(f"the homography reference does not model "
                             f"{group} keys {sorted(extra)}")
    for key, want in FIXED_STAB.items():
        if cfg["stabilizer"].get(key, want) != want:
            raise ValueError(f"the homography reference models stabilizer."
                             f"{key} = {want!r} only, not "
                             f"{cfg['stabilizer'][key]!r}")


def draw_table(seed: int, rows: int, n_hypotheses: int, device
               ) -> torch.Tensor:
    """(rows, n_hypotheses, 4) uniforms in [0, 1): the 4-point draws of
    the stream's first ``rows`` analyze steps, from a generator on
    ``device`` seeded with ``frames.stream_seed(seed)``."""
    g = torch.Generator(device=device)
    g.manual_seed(frames.stream_seed(seed))
    out = torch.empty((rows, n_hypotheses, 4), device=device)
    for k in range(rows):
        out[k] = torch.rand((n_hypotheses, 4), generator=g, device=device)
    return out


# --- the estimate -------------------------------------------------------------

def _four_point(p: torch.Tensor, q: torch.Tensor):
    """Exact homographies through four correspondences p -> q (..., 4, 2):
    (H (..., 3, 3) with H[2, 2] = 1, ok)."""
    x, y, u, v = p[..., 0], p[..., 1], q[..., 0], q[..., 1]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    rows_u = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], -1)
    rows_v = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y], -1)
    a = torch.stack([rows_u, rows_v], dim=-2).flatten(-3, -2)  # (..., 8, 8)
    b = torch.stack([u, v], dim=-1).flatten(-2)                 # (..., 8)
    sol, _info = torch.linalg.solve_ex(a, b)
    ok = (torch.linalg.det(a).abs() > 1e-8) & torch.isfinite(sol).all(-1)
    sol = torch.where(ok[..., None], sol, torch.zeros_like(sol))
    h = torch.cat([sol, torch.ones_like(sol[..., :1])], dim=-1)
    return h.reshape(*h.shape[:-1], 3, 3), ok


def _reproject(h: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(F, K, 3, 3) homographies applied to (F, P, 2) points: (F, K, P, 2);
    a denominator under 1e-9 in magnitude taken as 1e-9."""
    hom = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    out = torch.einsum("fkij,fpj->fkpi", h, hom)
    den = out[..., 2:]
    den = torch.where(den.abs() < 1e-9, torch.full_like(den, 1e-9), den)
    return out[..., :2] / den


def _normalizer(pts: torch.Tensor, w: torch.Tensor):
    """Hartley's similarity for (F, P, 2) points weighted by w (F, P):
    (T (F, 3, 3), the moved points)."""
    n = torch.clamp(w.sum(dim=-1), min=1.0)
    mean = (pts * w[..., None]).sum(dim=1) / n[:, None]
    dist = torch.linalg.vector_norm(pts - mean[:, None], dim=-1)
    s = math.sqrt(2.0) / torch.clamp((dist * w).sum(dim=-1) / n, min=1e-6)
    t = torch.zeros((pts.shape[0], 3, 3), device=pts.device)
    t[:, 0, 0] = t[:, 1, 1] = s
    t[:, :2, 2] = -s[:, None] * mean
    t[:, 2, 2] = 1.0
    return t, (pts - mean[:, None]) * s[:, None, None]


def _refit(prev: torch.Tensor, curr: torch.Tensor, w: torch.Tensor
           ) -> torch.Tensor:
    """The Hartley-normalized DLT through the points weighted by w:
    (F, 3, 3) with H[2, 2] = 1 (a scale under 1e-9 taken as 1e-9)."""
    tp, pn = _normalizer(prev, w)
    tq, qn = _normalizer(curr, w)
    x, y, u, v = pn[..., 0], pn[..., 1], qn[..., 0], qn[..., 1]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    rows_u = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u],
                         -1)
    rows_v = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v],
                         -1)
    a = torch.cat([rows_u, rows_v], dim=1) * torch.cat([w, w], 1)[..., None]
    hn = torch.linalg.svd(a, full_matrices=False)[2][:, -1].reshape(-1, 3, 3)
    h = torch.linalg.inv(tq) @ hn @ tp
    h22 = h[:, 2:, 2:]
    return h / torch.where(h22.abs() > 1e-9, h22, torch.full_like(h22, 1e-9))


def estimate_homography(prev: torch.Tensor, curr: torch.Tensor,
                        mask: torch.Tensor, draws: torch.Tensor,
                        threshold: float):
    """RANSAC homography of F point sets (F, P, 2) with (F, K, 4) draws
    into the valid points compacted to the front: (H (F, 3, 3), inliers
    (F, P), ok (F,)); the identity, no inliers and not ok under 8 valid
    points or 4 inliers."""
    n_valid = mask.to(torch.int32).sum(dim=-1)
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    picks = ops._take(order, draws)                             # (F, K, 4)
    h, ok = _four_point(ops._take(prev, picks), ops._take(curr, picks))
    for i in range(4):
        for j in range(i + 1, 4):
            ok = ok & (picks[..., i] != picks[..., j])
    err2 = ((_reproject(h, prev) - curr[:, None]) ** 2).sum(dim=-1)
    inl = mask[:, None] & (err2 < threshold * threshold)        # (F, K, P)
    score = torch.where(ok, inl.sum(dim=-1), torch.full_like(ok, -1,
                                                             dtype=torch.int64))
    best = torch.argmax(score, dim=-1)                          # the first
    f = torch.arange(prev.shape[0], device=prev.device)
    best_inl = inl[f, best]
    enough = (n_valid >= 8) & (score[f, best] >= 4)
    h = _refit(prev, curr, best_inl.to(torch.float32))
    eye = torch.eye(3, device=prev.device).expand_as(h)
    return torch.where(enough[:, None, None], h, eye), \
        best_inl & enough[:, None], enough


# --- sl(3) ---------------------------------------------------------------------

def log_sl3(h: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) near-identity homographies scaled to det 1 (a cube root
    under 1e-9 in magnitude taken as 1e-9), then log by the 12-term series
    log(I + X) = sum_k (-1)^(k+1) X^k / k."""
    det = torch.linalg.det(h)
    s = torch.sign(det) * det.abs() ** (1.0 / 3.0)
    s = torch.where(s.abs() > 1e-9, s, torch.full_like(s, 1e-9))
    x = h / s[..., None, None] - torch.eye(3, device=h.device)
    out, power = torch.zeros_like(x), x
    for k in range(1, LOG_TERMS + 1):
        out = out + power * (((-1.0) ** (k + 1)) / k)
        power = power @ x
    return out


def exp_sl3(l: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) matrix exponentials: a Taylor series of l / 2^s, squared
    s times, with s such that the largest row sum of |l| / 2^s is <= 1/4."""
    norm = float(l.abs().sum(dim=-1).amax())
    s = max(0, math.ceil(math.log2(norm / 0.25))) if norm > 0.25 else 0
    x = l / (2.0 ** s)
    eye = torch.eye(3, device=l.device).expand_as(x)
    out, term = eye.clone(), eye
    for k in range(1, EXP_TERMS + 1):
        term = term @ x / k
        out = out + term
    for _ in range(s):
        out = out @ out
    return out


def warp_projective_u8(img: torch.Tensor, hinv: torch.Tensor
                       ) -> torch.Tensor:
    """(F, H, W, C) u8 frames, each sampled at its inverse homography
    (F, 3, 3) of the output pixel: each row (p x + q y) + r, the
    denominator taken as 1e-9 under 1e-9 in magnitude; bilinear, x first
    then y, in float32, zero outside the frame, rounded half to even."""
    n, h, w, c = img.shape
    dev = img.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    m = hinv.reshape(n, 9)[:, :, None, None]

    def row(i):
        return (m[:, 3 * i] * xs + m[:, 3 * i + 1] * ys) + m[:, 3 * i + 2]

    den = row(2)
    den = torch.where(den.abs() < 1e-9, torch.full_like(den, 1e-9), den)
    sx, sy = row(0) / den, row(1) / den
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0f)[..., None], (sy - y0f)[..., None]
    x0 = x0f.clamp(-1e9, 1e9).to(torch.int64)
    y0 = y0f.clamp(-1e9, 1e9).to(torch.int64)
    flat = img.reshape(n * h * w, c).float()
    base = (torch.arange(n, device=dev) * (h * w))[:, None, None]

    def tap(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = flat[(base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
                 .reshape(-1)].reshape(n, h, w, c)
        return torch.where(inside[..., None], v, torch.zeros_like(v))

    top = tap(y0, x0) * (1.0 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1.0 - fx) + tap(y0 + 1, x0 + 1) * fx
    return ops.saturate_u8(top * (1.0 - fy) + bot * fy)


# --- the replay ----------------------------------------------------------------

def outputs(cfg: dict, pool: torch.Tensor, n_calls: int, seed: int,
            sample_calls, precision: torch.dtype = torch.float32) -> dict:
    """The frames the program delivers at ``sample_calls``.

    pool: (P, 1, H, W, 3) u8, call c consumes ``pool[c % P]``. n_calls:
    the calls made, which bounds every sampled call. seed: the run's, from
    which the analyze step k >= 1 draws as the program does
    (``draw_table``). -> {call: (1, H, W, 3) u8}."""
    check(cfg)
    q = _rounder(precision)
    st, en, ro = cfg["stabilizer"], cfg["enhancer"], cfg["roll"]
    h, w = cfg["height"], cfg["width"]
    ha, wa = st["analysis_height"], st["analysis_width"]
    n_pool = pool.shape[0]
    r_eff = max(5, min(st["smoothing_radius"], 35))
    last = max(sample_calls)
    if last >= n_calls or min(sample_calls) < r_eff - 1:
        raise ValueError(f"sampled calls {sorted(sample_calls)} outside "
                         f"[{r_eff - 1}, {n_calls})")
    n = last + 1                                  # frames the replay needs
    dev = pool.device

    # Per pool frame: K4's enhance, the saturated frame, the roll's
    # detection on the unsaturated frame's gray.
    enhanced, det, has = [], [], []
    for a, b in _blocks(n_pool, 4):
        x = q(ops.enhance_pointwise(en["brightness"], en["contrast"],
                                    en["gamma"], pool[a:b, 0].float()))
        enhanced.append(ops.saturate_u8(x))
        d, c = _roll_detect(ro, ops.bgr_to_gray(x))
        det.append(d)
        has.append(c)
    enhanced = torch.cat(enhanced)
    pidx = torch.arange(n, device=dev) % n_pool
    alpha = torch.stack(_roll_angles(ro, torch.cat(det)[pidx],
                                     torch.cat(has)[pidx]))
    rot_inv = q(ops.invert_affine(ops.rotation_matrix_2d(w / 2.0, h / 2.0,
                                                         alpha)))

    def rotated(ks):
        return ops.warp_u8(enhanced[pidx[ks]], rot_inv[ks],
                           ops.BORDER_REPLICATE)

    # The analysis gray of every rotated frame.
    gray = torch.empty((n, ha, wa), device=dev)
    for a, b in _blocks(n, ROT_BLOCK):
        g = ops.bgr_to_gray(rotated(torch.arange(a, b, device=dev)).float())
        gray[a:b] = q(ops.resize_bilinear(g, ha, wa))

    # Features: frame 0 with the initial detector, even frames after it
    # with the re-detector.
    mc = st["max_corners"]
    pts = torch.zeros((n, mc, 2), device=dev)
    msk = torch.zeros((n, mc), dtype=torch.bool, device=dev)
    pts[:1], msk[:1] = ops.good_features_to_track(
        gray[:1], mc, st["quality_level"], st["min_distance"])
    det_frames = list(range(2, n, 2))
    for a, b in _blocks(len(det_frames)):
        ks = torch.tensor(det_frames[a:b], device=dev)
        pts[ks], msk[ks] = ops.good_features_to_track(gray[ks], mc, 0.02,
                                                      15.0)

    # LK onto every frame k >= 1: odd k from the detected points of k - 1,
    # then even k from the points tracked onto k - 1.
    curr = torch.zeros_like(pts)
    valid = torch.zeros_like(msk)
    for parity in (1, 0):
        ks_all = [k for k in range(1, n) if k % 2 == parity]
        for a, b in _blocks(len(ks_all)):
            ks = torch.tensor(ks_all[a:b], device=dev)
            prev_pts = pts[ks - 1] if parity == 1 else curr[ks - 1]
            prev_msk = msk[ks - 1] if parity == 1 else valid[ks - 1]
            pp, cp = ops.lk_planes(gray[ks - 1], gray[ks], st["lk_levels"])
            fid = torch.arange(len(ks), device=dev).repeat_interleave(mc)
            got, status = ops.lk_track(pp, cp, fid, prev_pts.reshape(-1, 2),
                                       prev_msk.reshape(-1), st["lk_window"],
                                       st["lk_iters"])
            curr[ks] = q(got).reshape(prev_pts.shape)
            valid[ks] = prev_msk & status.reshape(prev_msk.shape)

    # RANSAC: raw transform k - 1 from the pair (k - 1, k), conjugated to
    # full resolution and mapped to sl(3).
    scale = torch.diag(torch.tensor([w / wa, h / ha, 1.0], device=dev))
    unscale = torch.diag(torch.tensor([wa / w, ha / h, 1.0], device=dev))
    table = draw_table(seed, n - 1, st["ransac_hypotheses"], dev)
    raw = torch.zeros((n - 1, 9), device=dev)
    for a, b in _blocks(n - 1):
        ks = torch.arange(a + 1, b + 1, device=dev)
        prev_pts = torch.where((ks % 2 == 1)[:, None, None], pts[ks - 1],
                               curr[ks - 1])
        draws = ops.ransac_draws(table[ks - 1],
                                 valid[ks].to(torch.int32).sum(dim=-1))
        hm, _inl, _ok = estimate_homography(prev_pts, curr[ks], valid[ks],
                                            draws, st["ransac_threshold"])
        raw[a:b] = q(log_sl3(scale @ hm @ unscale).reshape(-1, 9))

    # The cumulative path, one float32 add per entry as the program adds.
    raw_np = raw.cpu().numpy()
    path_np = np.zeros_like(raw_np)
    acc = raw_np[0].copy()
    path_np[0] = acc
    for j in range(1, n - 1):
        acc = (acc + raw_np[j]).astype(np.float32)
        path_np[j] = acc
    path = q(torch.from_numpy(path_np).to(dev))

    out = {}
    for c in sorted(sample_calls):
        e = c - (r_eff - 1)
        corr = raw[e] + (_smoothed(st, path, c, e) - path[e])
        hinv = q(exp_sl3(-corr.reshape(1, 3, 3)))
        out[c] = warp_projective_u8(rotated(torch.tensor([e], device=dev)),
                                    hinv)
    return out


def _smoothed(st: dict, path: torch.Tensor, n: int, e: int) -> torch.Tensor:
    """The box-smoothed path entry e once n entries are known, at the
    adaptive radius clamped to [2, 8]."""
    win = path[max(n - 20, 0):n]
    var = win.var(dim=0, unbiased=False)
    rot = (win[:, 1] - win[:, 3]) * 0.5
    total = torch.sqrt(var[2] + var[5] + rot.var(unbiased=False) * 1000.0)
    rad = int(torch.clamp(total * 2.0, 5.0, 25.0).to(torch.int32))
    if n < 10:
        rad = st["smoothing_radius"]
    rad = min(max(rad, 2), 8)
    if n <= rad:
        return path[e]
    return path[max(e - rad, 0):min(e + rad, n - 1) + 1].mean(dim=0)
