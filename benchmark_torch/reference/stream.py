"""The plain reference of the streaming stabilizer and the fused chain.

It replays a stream from its first frame and returns the frames the
program delivers at the sampled calls. The program steps one frame at a
time; the reference computes each stage for every frame of the stream at
once (a frame axis in place of the time loop) wherever the stage does not
depend on the one before, and runs the rest (the roll angle's smoothing,
the cumulative path) as short loops over scalars. The semantics are those
the program states (``core/chain.py``, ``core/stabilizer.py``): per frame
k >= 1 the analysis gray, LK from frame k - 1 with the points detected on
frame k - 1 (k - 1 even) or tracked onto it (k - 1 odd), RANSAC with the
k-th draws of the stream's generator, the raw transform pushed as path entry k - 1;
the call c >= effective_radius - 1 delivers frame e = c - r + 1 warped by
the box-smoothed, intent-scaled correction of path entry e, with the
fused roll composed in.

``precision`` is the float type every stage's result is rounded to:
float32 for the reference, bfloat16 for the control (the precision below
the configuration's float32).

A configuration names this file as its ``"reference": "stream"``. It
models the two systems below with the stabilizer's defaults for every
parameter the configuration leaves out; ``outputs`` refuses a
configuration that sets anything else (another motion model, another
re-detection interval, a key it does not read), so that such a
configuration is never compared against a reference of another pipeline.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark_torch import frames
from benchmark_torch.reference import ops

BLOCK = 64      # frames per block of the large stages

# What the reference models: per system the pre-stages it runs, then the
# keys it reads, and the values it takes as given.
SYSTEMS = {"chain": ("enhancer", "roll"), "multistream": ()}
READS = {
    "stabilizer": {"smoothing_radius", "max_corners", "quality_level",
                   "min_distance", "analysis_width", "analysis_height",
                   "lk_window", "lk_levels", "lk_iters", "ransac_threshold",
                   "ransac_hypotheses", "redetect_interval", "motion_model"},
    "enhancer": {"brightness", "contrast", "gamma"},
    "roll": {"scale_factor", "canny_threshold_low", "canny_threshold_high",
             "hough_threshold", "angle_smoothing_alpha", "angle_decay",
             "angle_filter_min", "angle_filter_max", "max_angle_change",
             "hough_rho", "hough_theta_deg", "max_lines"},
}
FIXED = {"stabilizer": {"redetect_interval": 2,
                        "motion_model": "similarity"}}
TOP = {"system", "reference", "source", "height", "width", "streams",
       "pool_frames", "assumed", "correct_limits", "stabilizer"}


def check(cfg: dict) -> None:
    """Raise ValueError where ``cfg`` asks for what this reference does
    not model."""
    if cfg.get("system") not in SYSTEMS:
        raise ValueError(f"the stream reference models the systems "
                         f"{sorted(SYSTEMS)}, not {cfg.get('system')!r}")
    stages = SYSTEMS[cfg["system"]]
    extra = set(cfg) - TOP - set(stages)
    missing = {"stabilizer", *stages} - set(cfg)
    if extra or missing:
        raise ValueError(f"the stream reference of {cfg['system']!r} does "
                         f"not model the keys {sorted(extra)}; missing "
                         f"{sorted(missing)}")
    for group in ("stabilizer", *stages):
        extra = set(cfg[group]) - READS[group]
        if extra:
            raise ValueError(f"the stream reference does not model "
                             f"{group} keys {sorted(extra)}")
        for key, want in FIXED.get(group, {}).items():
            if cfg[group].get(key, want) != want:
                raise ValueError(f"the stream reference models {group}."
                                 f"{key} = {want!r} only, not "
                                 f"{cfg[group][key]!r}")


def _rounder(precision: torch.dtype):
    if precision == torch.float32:
        return lambda x: x
    return lambda x: x.to(precision).to(x.dtype)


def _blocks(n: int, size: int = BLOCK):
    for a in range(0, n, size):
        yield a, min(n, a + size)


def _pool_stage(cfg: dict, pool: torch.Tensor, q):
    """Per pool frame (F, H, W, 3): the frame that is queued (enhanced or
    raw, u8), the full-size gray of the float frame, the analysis gray,
    and with roll correction the detected angle and whether any line
    counted."""
    st, en, ro = cfg["stabilizer"], cfg.get("enhancer"), cfg.get("roll")
    ha, wa = st["analysis_height"], st["analysis_width"]
    queued, gray_a, det, has = [], [], [], []
    for a, b in _blocks(pool.shape[0], 4):
        x = pool[a:b].float()
        if en is not None:
            x = q(ops.enhance_pointwise(en["brightness"], en["contrast"],
                                        en["gamma"], x))
            queued.append(ops.saturate_u8(x))
        else:
            queued.append(pool[a:b])
        g = ops.bgr_to_gray(x)
        gray_a.append(q(ops.resize_bilinear(g, ha, wa)))
        if ro is not None:
            d, c = _roll_detect(ro, g)
            det.append(d)
            has.append(c)
    out = dict(queued=torch.cat(queued), gray=torch.cat(gray_a))
    if ro is not None:
        out.update(det=torch.cat(det), has=torch.cat(has))
    return out


def _roll_detect(ro: dict, gray: torch.Tensor):
    """Per frame the mean angle of the Hough lines in the acceptance band
    and whether any line counted (``core/rollcorrection.py``)."""
    h, w = gray.shape[-2:]
    sh = max(int(h * ro["scale_factor"]), 1)
    sw = max(int(w * ro["scale_factor"]), 1)
    small = ops.resize_bilinear(gray, sh, sw)
    edges = ops.canny_edges(small, ro["canny_threshold_low"],
                            ro["canny_threshold_high"])
    lo, hi = ro["angle_filter_min"], ro["angle_filter_max"]
    dets, counts = [], []
    for e in edges:
        lines, mask = ops.hough_lines(
            e, rho=ro["hough_rho"], theta=math.radians(ro["hough_theta_deg"]),
            threshold=ro["hough_threshold"], max_lines=ro["max_lines"],
            theta_range=(math.radians(90.0 + lo), math.radians(90.0 + hi)))
        angles = lines[:, 1] * (180.0 / math.pi) - 90.0
        keep = mask & (angles >= lo) & (angles <= hi)
        count = keep.to(torch.float32).sum()
        dets.append(torch.where(keep, angles, torch.zeros_like(angles)).sum()
                    / torch.clamp(count, min=1.0))
        counts.append(count > 0)
    return torch.stack(dets), torch.stack(counts)


def _roll_angles(ro: dict, det: torch.Tensor, has: torch.Tensor) -> list:
    """The smoothed roll angle after each frame (0-d float32 tensors), from
    the per-frame detections: exponential smoothing with the per-frame
    clamp, decay toward zero where no line counted."""
    a = ro["angle_smoothing_alpha"]
    clamp = ro["max_angle_change"]
    prev = torch.zeros((), dtype=torch.float32, device=det.device)
    out = []
    for d, c in zip(det, has):
        new = a * d + (1.0 - a) * prev
        diff = new - prev
        if clamp > 0.0:
            diff = torch.clamp(diff, -clamp, clamp)
        prev = torch.where(c, prev + diff,
                           prev * ro["angle_decay"]).to(torch.float32)
        out.append(prev)
    return out


def _rotated_grays(cfg: dict, gray: torch.Tensor, alpha: torch.Tensor, q):
    """The fused chain's analysis grays: each rotated by its frame's roll
    angle about the full frame's centre conjugated into analysis space,
    u8 in and out with a replicated border; the unrotated float gray where
    the angle is exactly 0."""
    h, w = cfg["height"], cfg["width"]
    st = cfg["stabilizer"]
    sx, sy = st["analysis_width"] / w, st["analysis_height"] / h
    r = ops.rotation_matrix_2d(w / 2.0, h / 2.0, alpha)
    a_mat = torch.stack([
        torch.stack([r[:, 0, 0], r[:, 0, 1] * (sx / sy), r[:, 0, 2] * sx], -1),
        torch.stack([r[:, 1, 0] * (sy / sx), r[:, 1, 1], r[:, 1, 2] * sy], -1),
    ], dim=-2)
    rot = ops.warp_u8(ops.saturate_u8(gray), ops.invert_affine(a_mat),
                      ops.BORDER_REPLICATE)
    return q(torch.where((alpha == 0.0)[:, None, None], gray,
                         rot.to(torch.float32)))


def outputs(cfg: dict, pool: torch.Tensor, n_calls: int, seed: int,
            sample_calls, precision: torch.dtype = torch.float32) -> dict:
    """The frames the program delivers at ``sample_calls``.

    pool: (P, S, H, W, 3) u8, call c consumes ``pool[c % P]`` (S streams
    in lockstep; the chain has S = 1). n_calls: the calls made, which
    bounds every sampled call. seed: the run's, from which the analyze
    step k >= 1 of stream s draws as the program does
    (``frames.draw_table``). -> {call: (S, H, W, 3) u8}."""
    check(cfg)
    q = _rounder(precision)
    st = cfg["stabilizer"]
    n_pool, n_str = pool.shape[:2]
    r_eff = max(5, min(st["smoothing_radius"], 35))
    last = max(sample_calls)
    if last >= n_calls or min(sample_calls) < r_eff - 1:
        raise ValueError(f"sampled calls {sorted(sample_calls)} outside "
                         f"[{r_eff - 1}, {n_calls})")
    n = last + 1                                  # frames the replay needs
    dev = pool.device
    pre = _pool_stage(cfg, pool.reshape(-1, *pool.shape[2:]), q)
    # Frame k of stream s is pool frame (k % P) * S + s.
    fidx = ((torch.arange(n, device=dev) % n_pool)[:, None] * n_str
            + torch.arange(n_str, device=dev)[None, :])          # (n, S)

    alpha = None
    if cfg.get("roll") is not None:
        alpha = torch.stack(_roll_angles(
            cfg["roll"], pre["det"][fidx[:, 0]], pre["has"][fidx[:, 0]]))
        store = torch.cat([_rotated_grays(cfg, pre["gray"][fidx[a:b, 0]],
                                          alpha[a:b], q)
                           for a, b in _blocks(n)])
        gidx = torch.arange(n, device=dev)[:, None]               # (n, 1)
    else:
        store, gidx = pre["gray"], fidx

    # Features: frame 0 with the initial detector, even frames after it
    # with the re-detector.
    pts = torch.zeros((n, n_str, st["max_corners"], 2), device=dev)
    msk = torch.zeros((n, n_str, st["max_corners"]), dtype=torch.bool,
                      device=dev)
    pts[0], msk[0] = ops.good_features_to_track(
        store[gidx[0]], st["max_corners"], st["quality_level"],
        st["min_distance"])
    det_frames = list(range(2, n, 2))
    for a, b in _blocks(len(det_frames), max(1, BLOCK // n_str)):
        ks = torch.tensor(det_frames[a:b], device=dev)
        p, m = ops.good_features_to_track(
            store[gidx[ks].reshape(-1)], st["max_corners"], 0.02, 15.0)
        pts[ks] = p.reshape(len(ks), n_str, *p.shape[1:])
        msk[ks] = m.reshape(len(ks), n_str, *m.shape[1:])

    # LK onto every frame k >= 1: odd k from the detected points of k - 1,
    # then even k from the points tracked onto k - 1.
    curr = torch.zeros_like(pts)
    valid = torch.zeros_like(msk)
    for parity in (1, 0):
        ks_all = [k for k in range(1, n) if k % 2 == parity]
        for a, b in _blocks(len(ks_all), max(1, BLOCK // n_str)):
            ks = torch.tensor(ks_all[a:b], device=dev)
            prev_pts = pts[ks - 1] if parity == 1 else curr[ks - 1]
            prev_msk = msk[ks - 1] if parity == 1 else valid[ks - 1]
            prev_g = store[gidx[ks - 1].reshape(-1)]
            curr_g = store[gidx[ks].reshape(-1)]
            pp, cp = ops.lk_planes(prev_g, curr_g, st["lk_levels"])
            nf = prev_g.shape[0]
            pp_flat = prev_pts.reshape(nf, -1, 2)
            fid = torch.arange(nf, device=dev).repeat_interleave(
                pp_flat.shape[1])
            got, status = ops.lk_track(
                pp, cp, fid, pp_flat.reshape(-1, 2),
                prev_msk.reshape(-1), st["lk_window"], st["lk_iters"])
            curr[ks] = q(got).reshape(prev_pts.shape)
            valid[ks] = prev_msk & status.reshape(prev_msk.shape)

    # RANSAC: raw transform k - 1 from the pair (k - 1, k).
    raw = torch.zeros((n, n_str, 3), device=dev)
    draws_u = frames.draw_table(seed, n - 1, n_str, st["ransac_hypotheses"],
                                dev)
    t_rows = draws_u.shape[0]
    for a, b in _blocks(n - 1, 64):
        ks = torch.arange(a + 1, b + 1, device=dev)
        prev_pts = torch.where((ks % 2 == 1)[:, None, None, None],
                               pts[ks - 1], curr[ks - 1])
        prev_msk = valid[ks]
        draws = ops.ransac_draws(draws_u[(ks - 1) % t_rows],
                                 prev_msk.to(torch.int32).sum(dim=-1))
        nf = len(ks) * n_str
        raw[ks - 1] = q(ops.estimate_similarity_ransac(
            prev_pts.reshape(nf, -1, 2), curr[ks].reshape(nf, -1, 2),
            prev_msk.reshape(nf, -1), draws.reshape(nf, *draws.shape[2:]),
            st["ransac_threshold"])).reshape(len(ks), n_str, 3)

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
        minv = _emit_map(cfg, raw, path, c, e, alpha, q)
        queued = pre["queued"][fidx[e]]
        out[c] = ops.warp_u8(queued, minv, ops.BORDER_CONSTANT)
    return out


def _emit_map(cfg: dict, raw: torch.Tensor, path: torch.Tensor, n: int,
              e: int, alpha, q) -> torch.Tensor:
    """The inverse warp maps (S, 2, 3) that emit frame e once n transforms
    are known (``core/stabilizer.py`` ``_emit_inputs``,
    ``_similarity_correction``; ``motion/filters.py``,
    ``motion/intent.py``)."""
    st = cfg["stabilizer"]
    dev = raw.device
    n_str = raw.shape[1]
    # Adaptive radius from the variance of the last <= 20 path entries,
    # clamped to the box band [2, 8] (no adaptive or drone smoothing).
    idx = max(n - 20, 0) + torch.arange(20, device=dev)
    w = (idx <= n - 1).to(torch.float32)[None, :, None]
    vals = path[idx.clamp(max=n - 1)].transpose(0, 1)              # (S,20,3)
    count = torch.clamp(w.sum(dim=-2), min=1.0)
    mean = (vals * w).sum(dim=-2) / count
    var = (((vals - mean[:, None, :]) ** 2) * w).sum(dim=-2) / count
    total = torch.sqrt(var[:, 0] + var[:, 1] + var[:, 2] * 1000.0)
    ar = torch.clamp(total * 2.0, 5.0, 25.0).to(torch.int32)
    if n < 10:
        ar = torch.full_like(ar, st["smoothing_radius"])
    r_lo, r_max = 2, 8
    rad = torch.clamp(ar, r_lo, r_max)
    offs = torch.arange(-r_max, r_max + 1, device=dev)
    bidx = e + offs
    bw = ((offs.abs()[None, :] <= rad[:, None]) & (bidx >= 0)[None, :]
          & (bidx <= n - 1)[None, :]).to(torch.float32)[..., None]
    bvals = path[bidx.clamp(0, n - 1)].transpose(0, 1)             # (S,17,3)
    box = (bvals * bw).sum(dim=-2) / torch.clamp(bw.sum(dim=-2), min=1.0)
    smoothed = torch.where((n <= rad)[:, None], path[e], box)
    diff = smoothed - path[e]
    motion = raw[e]
    scale = _intent_scale(raw, n, motion, e)
    t = q(motion + diff * scale[:, None])
    sxf = cfg["width"] / st["analysis_width"]
    syf = cfg["height"] / st["analysis_height"]
    dx = t[:, 0] * float(np.float32(sxf))
    dy = t[:, 1] * float(np.float32(syf))
    m = ops.similarity_matrix(dx, dy, t[:, 2])
    if alpha is not None:
        row3 = torch.zeros((n_str, 1, 3), device=dev)
        row3[:, 0, 2] = 1.0
        rm = ops.rotation_matrix_2d(cfg["width"] / 2.0, cfg["height"] / 2.0,
                                    alpha[e].expand(n_str))
        # One 3 x 3 product per stream, as the program composes them.
        m3, r3 = torch.cat([m, row3], 1), torch.cat([rm, row3], 1)
        m = torch.stack([(a @ b)[:2] for a, b in zip(m3, r3)])
    return q(ops.invert_affine(m))


def _intent_scale(raw: torch.Tensor, n: int, motion: torch.Tensor,
                  e: int) -> torch.Tensor:
    """The correction's scale by the emitted frame's motion intent: pan
    0.5, shake 1.0, follow 0.8, else 0.7; 1.0 at frame 0."""
    dev = raw.device
    mag = torch.sqrt(motion[:, 0] ** 2 + motion[:, 1] ** 2)
    ang_vel = torch.abs(motion[:, 2]) * 180.0 / math.pi * 30.0
    idx = max(e - 15, 0) + torch.arange(15, device=dev)
    w = ((idx < e) & (idx < n)).to(torch.float32)[None, :]
    t = raw[idx.clamp(max=n - 1)].transpose(0, 1)                  # (S,15,3)
    mags = torch.sqrt(t[..., 0] ** 2 + t[..., 1] ** 2)
    dirs = torch.atan2(t[..., 1], t[..., 0])

    def variance(v):
        cnt = torch.clamp(w.sum(dim=-1), min=1.0)
        mu = (v * w).sum(dim=-1) / cnt
        return (((v - mu[..., None]) ** 2) * w).sum(dim=-1) / cnt

    cnt = torch.clamp(w.sum(dim=-1), min=1.0)
    mu = (mags * w).sum(dim=-1) / cnt
    nonzero = mu != 0.0
    safe = torch.where(nonzero, mu * mu, torch.ones_like(mu))
    cons = torch.where(nonzero,
                       torch.clamp(1.0 / (1.0 + variance(mags) / safe), 0, 1),
                       torch.zeros_like(mu))
    dir_var = variance(dirs)
    is_pan = (dir_var < 0.5) & (cons > 0.7) & (mag > 5.0)
    is_shake = (mag < 3.0) & (cons < 0.3) & (ang_vel > 10.0)
    is_follow = (mag > 3.0) & (mag < 15.0) & (dir_var > 0.5)
    scale = torch.where(is_pan, 0.5, torch.where(
        is_shake, 1.0, torch.where(is_follow, 0.8, 0.7)))
    enabled = (n >= 15) & (w.sum(dim=-1) > 0)
    scale = torch.where(enabled, scale, torch.full_like(scale, 0.7))
    return scale if e > 0 else torch.ones_like(scale)
