"""The plain reference of the drone high-frequency deployment: the
similarity stabilizer alone (no enhancer, no roll) in drone mode, with
conditional CLAHE, the high-frequency vibration chain, the LK prior of
``motion_prediction``, gaussian smoothing, horizon lock and crop-and-zoom.

It replays a stream from its first frame and returns the frames the
program delivers at the sampled calls, as ``stream.py`` does, with the
stages computed for a block of frames at once. The semantics are those the
program states (``core/stabilizer.py``, ``motion/hf.py``,
``motion/filters.py``, ``ops/filters.py:clahe``, ``ops/lk.py``); the drone
stages are written here from those statements, not copied:

- per frame k the analysis gray: the frame's BT.601 gray, resized
  bilinearly to the analysis size;
- conditional CLAHE (cv::CLAHE, clip 2, an 8 x 8 grid): the gray padded
  reflect-101 at the bottom and the right to a multiple of the grid where
  it does not divide, a 256-bin histogram per tile of each value's integer
  part, each bin clipped to max(int(2 area / 256), 1) and the excess
  spread as cv::CLAHE does (excess // 256 to every bin, then one more to
  bins 0, s, 2s, ... for the rest, s = max(256 // rest, 1)), the LUT
  round(cdf 255 / area), the four nearest tiles' LUTs blended bilinearly
  at (x / tw - 0.5, y / th - 0.5); it replaces frame k's gray where the
  starvation counter after frame k - 1 is above 2. The counter counts the
  frames in a row that tracked fewer than 40 points, 0 after frame 0;
- per frame k >= 1 LK from frame k - 1 with the points detected on frame
  k - 1 (k - 1 even) or tracked onto it (k - 1 odd), as ``stream.py``;
  with ``motion_prediction`` the ladder starts from the points shifted by
  the translation prior: both grays resized to analysis / 4, the centred
  patch (side min(64, 8 floor(min(h, w) / 16))) less its mean correlated
  in float32 with every window of the region around it (search
  min(24, (h - patch) / 2 - 1, (w - patch) / 2 - 1)) less its mean, the
  first maximum's offset times 4, or 0 where the peak's z-score over the
  correlation surface (population std) is not above 4, or where the search
  is under 4 or the patch under 16;
- RANSAC with the k-th draws of the stream's generator, as ``stream.py``;
- the high-frequency chain on each raw transform (dx, dy, da), in
  upstream's order, in float32: the dead zone (magnitude sqrt(dx^2 + dy^2
  + 100 da^2); an accumulator max(decay x its last value, magnitude)
  clamped to 5 x the threshold; entered below the threshold with the
  freeze counter at the freeze duration, left when the counter runs out,
  the magnitude passes 1.5 x the threshold or the accumulator 1.2 x; while
  inside, the transform is zero), then micro-shake suppression (the
  translation's distance from the median of the last <= 10 translations,
  held at its last value until 5 are pushed, scaled by 0.01 under
  ``hf_shake_px``, by 0.05 under twice that), then under horizon lock the
  rotation low-passed at ``hf_rot_lp_alpha``, then the translation pushed
  onto the history. The result is the transform the path accumulates and
  the motion intent reads;
- the emit of frame e with n transforms known: the gaussian of the path
  at e (ksize max(3, ceil(6 sigma)) made odd, exp(-x^2 / (2 sigma^2))
  normalized), tap indices e + o reflected as path[-m] -> path[m] on the
  left and path[n - 1 + m] -> path[n - m] on the right, in that order, and
  clamped at 0; the correction raw[e] + (gaussian - path[e]) scaled by the
  motion intent (``stream.py``), its translation scaled to the full frame,
  its rotation 0 under horizon lock; one affine warp of the raw frame,
  bilinear, constant border; then ``border_size`` px cut off each side and
  the rest resized bilinearly back to the frame's size.

Where this file departs from upstream or from how the program computes the
same thing: cv::CLAHE takes u8 and pads a whole tile on a side the grid
divides where the other side does not; the program (and so this file)
bins the float gray by its integer part and pads only the side that does
not divide (at 540 x 960 upstream's tiles are 68 x 121, the program's
68 x 120: the selected gray differs from upstream's, not from the
program's). The histograms are counted by a scatter-add per frame (the
program: one index-add over every tile); the prior's correlation is one
batched matmul over a block of frame pairs (the program: one matmul per
pair); the chain runs in numpy float32 on the host (the program: 0-d
tensors on the device); the starvation counter is checked after a block of
frames is analysed on its predicted choices, and the block is analysed
again from the first frame whose choice was mispredicted.

``precision``: every stage's result rounded to it, as in ``stream.py``.
A configuration names this file as its ``"reference": "stream_drone"``;
``check`` refuses what it does not model.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark_torch import frames
from benchmark_torch.reference import ops
from benchmark_torch.reference.stream import _blocks, _intent_scale, _rounder

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

STARVED_BELOW = 40      # tracked points under which a frame is starved
STARVED_FRAMES = 2      # CLAHE once the counter is above this
CLAHE_CLIP, CLAHE_GRID = 2.0, 8
HF_HISTORY = 10
PRIOR_BLOCK = 8         # frame pairs per block of the prior's matmul

STAB_READS = {"smoothing_radius", "max_corners", "quality_level",
              "min_distance", "analysis_width", "analysis_height",
              "lk_window", "lk_levels", "lk_iters", "ransac_threshold",
              "ransac_hypotheses", "redetect_interval", "motion_model",
              "border_type", "border_size", "crop_n_zoom",
              "smoothing_method", "gaussian_sigma", "motion_prediction",
              "horizon_lock", "drone_high_freq_mode", "hf_shake_px",
              "hf_rot_lp_alpha", "hf_dead_zone_threshold",
              "hf_freeze_duration", "hf_motion_accumulator_decay"}
FIXED = {"system": "stabilize_only", "streams": 1}
FIXED_STAB = {"redetect_interval": 2, "motion_model": "similarity",
              "smoothing_method": "gaussian", "crop_n_zoom": True,
              "drone_high_freq_mode": True}
TOP = {"system", "reference", "source", "height", "width", "streams",
       "pool_frames", "assumed", "correct_limits", "stabilizer"}


def check(cfg: dict) -> None:
    """Raise ValueError where ``cfg`` asks for what this reference does
    not model: another system, several streams, a pre-stage, a key it
    does not read, another motion model, smoother or re-detection
    interval, drone mode off, no crop-and-zoom or no border to crop."""
    for key, want in FIXED.items():
        if cfg.get(key) != want:
            raise ValueError(f"the drone reference models {key} = {want!r} "
                             f"only, not {cfg.get(key)!r}")
    extra, missing = set(cfg) - TOP, TOP - {"assumed", "source"} - set(cfg)
    if extra or missing:
        raise ValueError(f"the drone reference does not model the keys "
                         f"{sorted(extra)}; missing {sorted(missing)}")
    st = cfg["stabilizer"]
    extra = set(st) - STAB_READS
    if extra:
        raise ValueError(f"the drone reference does not model stabilizer "
                         f"keys {sorted(extra)}")
    for key, want in FIXED_STAB.items():
        if st.get(key) != want:
            raise ValueError(f"the drone reference models stabilizer.{key} "
                             f"= {want!r} only, not {st.get(key)!r}")
    if st.get("border_size", 0) <= 0:
        raise ValueError("the drone reference models crop-and-zoom with a "
                         "border_size above 0 only")


# --- conditional CLAHE -------------------------------------------------------

def clahe(gray: torch.Tensor, clip_limit: float = CLAHE_CLIP,
          grid: int = CLAHE_GRID) -> torch.Tensor:
    """CLAHE of (F, H, W) u8-domain float grays (the module's docstring):
    float32 (F, H, W)."""
    n, h, w = gray.shape
    th, tw = -(-h // grid), -(-w // grid)
    ph, pw = th * grid, tw * grid
    x = gray
    if (ph, pw) != (h, w):
        x = F.pad(x[:, None], (0, pw - w, 0, ph - h), mode="reflect")[:, 0]
    bins = torch.clamp(x, 0.0, 255.0).to(torch.int64)          # (F, ph, pw)
    tiles = bins.reshape(n, grid, th, grid, tw).permute(0, 1, 3, 2, 4)
    tiles = tiles.reshape(n, grid * grid, th * tw)
    hist = torch.zeros((n, grid * grid, 256), dtype=torch.int64,
                       device=gray.device)
    hist.scatter_add_(2, tiles, torch.ones_like(tiles))
    area = th * tw
    clip = max(int(clip_limit * area / 256.0), 1)
    excess = torch.clamp(hist - clip, min=0).sum(dim=-1, keepdim=True)
    hist = torch.clamp(hist, max=clip)
    batch = torch.div(excess, 256, rounding_mode="floor")
    rest = excess - batch * 256
    step = torch.clamp(torch.div(256, torch.clamp(rest, min=1),
                                 rounding_mode="floor"), min=1)
    b = torch.arange(256, device=gray.device)
    extra = (torch.remainder(b, step) == 0) & \
        (torch.div(b, step, rounding_mode="floor") < rest)
    hist = hist + batch + extra.to(torch.int64)
    cdf = torch.cumsum(hist, dim=-1).to(torch.float32)
    luts = torch.clamp(torch.round(cdf * (255.0 / area)), 0.0, 255.0)

    def axis(m, t):
        f = torch.arange(m, dtype=torch.float32, device=gray.device) / t - 0.5
        lo = torch.floor(f)
        return (f - lo, torch.clamp(lo, 0, grid - 1).to(torch.int64),
                torch.clamp(lo + 1, 0, grid - 1).to(torch.int64))

    fy, y0, y1 = axis(ph, th)
    fx, x0, x1 = axis(pw, tw)
    flat = luts.reshape(n, -1)

    def lut(ty, tx):
        idx = ((ty[:, None] * grid + tx[None, :]) * 256)[None] + bins
        return flat.gather(1, idx.reshape(n, -1)).reshape(n, ph, pw)

    fx, fy = fx[None, None, :], fy[None, :, None]
    top = lut(y0, x0) * (1.0 - fx) + lut(y0, x1) * fx
    bot = lut(y1, x0) * (1.0 - fx) + lut(y1, x1) * fx
    return (top * (1.0 - fy) + bot * fy)[:, :h, :w]


# --- the translation prior and LK from it ------------------------------------

def translation_prior(prev: torch.Tensor, curr: torch.Tensor,
                      search: int = 24) -> torch.Tensor:
    """(F, 2) (dx, dy) of (F, h, w) small grays (the module's docstring)."""
    n_f, h, w = prev.shape
    patch = min(64, ((min(h, w) // 2) // 8) * 8)
    search = min(search, (h - patch) // 2 - 1, (w - patch) // 2 - 1)
    if search < 4 or patch < 16:
        return torch.zeros((n_f, 2), device=prev.device)
    cy, cx = (h - patch) // 2, (w - patch) // 2
    p = prev[:, cy:cy + patch, cx:cx + patch]
    p = p - p.mean(dim=(1, 2), keepdim=True)
    region = curr[:, cy - search:cy + patch + search,
                  cx - search:cx + patch + search]
    region = region - region.mean(dim=(1, 2), keepdim=True)
    n = 2 * search + 1
    win = region.unfold(1, patch, 1).unfold(2, patch, 1)
    corr = torch.bmm(win.reshape(n_f, n * n, patch * patch),
                     p.reshape(n_f, patch * patch, 1))[..., 0]
    idx = torch.argmax(corr, dim=1)
    z = (corr.amax(dim=1) - corr.mean(dim=1)) / torch.clamp(
        corr.std(dim=1, correction=0), min=1e-6)
    shift = torch.stack([idx % n, idx // n], dim=1).to(torch.float32) \
        - search
    return torch.where((z > 4.0)[:, None], shift, torch.zeros_like(shift))


def lk_track(prev_planes, curr_planes, fid, prev_pts, start_pts, pts_mask,
             win: int, iters: int, eps: float = 0.03,
             min_eig_thresh: float = 1e-4):
    """``ops.lk_track`` with the ladder's first guess at ``start_pts`` (the
    templates still at ``prev_pts``)."""
    max_level = len(prev_planes) - 1
    h, w = curr_planes[0].shape[-2:]
    half = (win - 1) * 0.5
    guess = start_pts * (1.0 / (2 ** max_level))
    ok = pts_mask
    for level in range(max_level, -1, -1):
        drift = ops.DRIFT_TOP if level == max_level else ops.DRIFT
        s_c = win + 1 + 2 * drift
        pt_prev = prev_pts / (2 ** level)
        ty0f = torch.floor(pt_prev[:, 1] - half)
        tx0f = torch.floor(pt_prev[:, 0] - half)
        t_slab = ops._slab(prev_planes[level], fid, ty0f.to(torch.int64),
                           tx0f.to(torch.int64), win + 1)
        tmpl = ops._interp_window(t_slab, torch.stack(
            [pt_prev[:, 1] - half - ty0f, pt_prev[:, 0] - half - tx0f],
            dim=1), win)
        i_win = tmpl[:, 0]
        ix_win, iy_win = tmpl[:, 1], tmpl[:, 2]
        g11 = (ix_win * ix_win).sum(dim=(1, 2))
        g12 = (ix_win * iy_win).sum(dim=(1, 2))
        g22 = (iy_win * iy_win).sum(dim=(1, 2))
        det = g11 * g22 - g12 * g12
        half_tr = 0.5 * (g11 + g22)
        min_eig = half_tr - torch.sqrt(
            torch.clamp(half_tr * half_tr - det, min=0.0))
        lvl_ok = (det > 1e-7) & (min_eig / (win * win) > min_eig_thresh)
        safe_det = torch.where(lvl_ok, det, torch.ones_like(det))
        zero = torch.zeros_like(det)
        inv11 = torch.where(lvl_ok, g22 / safe_det, zero)
        inv12 = torch.where(lvl_ok, -g12 / safe_det, zero)
        inv22 = torch.where(lvl_ok, g11 / safe_det, zero)
        neg_inv = -torch.stack([torch.stack([inv12, inv22], dim=1),
                                torch.stack([inv11, inv12], dim=1)], dim=1)
        g_flat = tmpl[:, 1:].reshape(-1, 2, win * win)
        curr_l = curr_planes[level][:, None]
        rounds = 4 if level == max_level else 2
        iters_per = -(-iters // rounds)
        pt, done = guess.flip(1), (~lvl_ok)[:, None]
        for _ in range(rounds):
            c0 = torch.floor(pt - half) - drift
            c_slab = ops._slab(curr_l, fid, c0[:, 0].to(torch.int64),
                               c0[:, 1].to(torch.int64), s_c)
            origin = c0 + half
            for _ in range(iters_per):
                c = torch.clamp(pt - origin, 0.0, s_c - win - 1.0)
                j_win = ops._interp_window(c_slab, c, win)[:, 0]
                b = g_flat @ (j_win - i_win).reshape(-1, win * win, 1)
                d = (neg_inv @ b)[:, :, 0]
                pt = torch.where(done, pt, pt + d)
                done = done | ((d * d).sum(dim=1, keepdim=True) <= eps * eps)
        pt = pt.flip(1)
        ok = ok & lvl_ok
        guess = torch.where(ok[:, None], pt, guess)
        if level > 0:
            guess = guess * 2.0
    inside = ((guess[:, 0] >= 0) & (guess[:, 0] <= w - 1) &
              (guess[:, 1] >= 0) & (guess[:, 1] <= h - 1))
    return guess, ok & inside


# --- the high-frequency chain, the gaussian ----------------------------------

def hf_chain(raw: np.ndarray, st: dict) -> np.ndarray:
    """(E, 3) float32 raw transforms -> (E, 3) after the chain, each in
    turn (the module's docstring)."""
    f = np.float32
    dz = st["hf_dead_zone_threshold"]
    decay = f(st["hf_motion_accumulator_decay"])
    shake = st["hf_shake_px"]
    alpha = st["hf_rot_lp_alpha"]
    lock = st.get("horizon_lock", False)
    hist = np.zeros((HF_HISTORY, 2), np.float32)
    pushed, median = 0, np.zeros(2, np.float32)
    rot_lp, in_dz, counter, accum = f(0), False, 0, f(0)
    out = np.empty_like(raw)
    for i, t in enumerate(raw.astype(np.float32)):
        # 1. Dead zone.
        mag = np.sqrt(t[0] * t[0] + t[1] * t[1] + t[2] * t[2] * f(100))
        accum = min(max(accum * decay, mag), f(dz * 5.0), f(100))
        if not in_dz and mag < f(dz):
            in_dz, counter = True, st["hf_freeze_duration"]
        if in_dz:
            counter -= 1
            if counter <= 0 or mag > f(dz * 1.5) or accum > f(dz * 1.2):
                in_dz, counter, accum = False, 0, f(0)
        if in_dz:
            t = np.zeros(3, np.float32)
        # 2. Micro-shake against the median of the history.
        if pushed >= 5:
            live = np.sort(hist[:min(pushed, HF_HISTORY)], axis=0)
            mid = live.shape[0] // 2
            median = live[mid] if live.shape[0] % 2 else \
                f(0.5) * (live[mid - 1] + live[mid])
        dev = t[:2] - median
        dist = np.sqrt(dev[0] * dev[0] + dev[1] * dev[1])
        xy = t[:2]
        if dist < f(shake * 2.0):
            xy = median + dev * (f(0.01) if dist < f(shake) else f(0.05))
        # 3. Rotation low-pass under the horizon lock.
        rot = t[2]
        if lock:
            rot_lp = f(1.0 - alpha) * rot_lp + f(alpha) * t[2]
            rot = rot_lp
        # 4. History.
        hist[pushed % HF_HISTORY] = xy
        pushed += 1
        out[i] = (xy[0], xy[1], rot)
    return out


def gaussian_taps(sigma: float) -> np.ndarray:
    k = max(3, int(math.ceil(6 * sigma)))
    k += 1 - k % 2
    xs = np.arange(k, dtype=np.float32) - np.float32(k // 2)
    g = np.exp(-(xs * xs) / np.float32(2.0 * sigma * sigma))
    return (g / g.sum(dtype=np.float32)).astype(np.float32)


def gaussian_at(path: torch.Tensor, n: int, e: int, taps: torch.Tensor
                ) -> torch.Tensor:
    """The gaussian of path entries 0 .. n - 1 at e (the module's
    docstring): (C,)."""
    k = taps.shape[0]
    idx = e + torch.arange(k, device=path.device) - k // 2
    idx = torch.where(idx < 0, -idx, idx)
    idx = torch.where(idx > n - 1, 2 * n - 1 - idx, idx).clamp(min=0)
    return (path[idx] * taps[:, None]).sum(dim=0)


# --- the replay --------------------------------------------------------------

class _Stream:
    """The analysis of a stream's frames 0 .. n - 1: grays, points, the
    starvation counter, settled block by block."""

    def __init__(self, cfg: dict, pool: torch.Tensor, n: int, q):
        st = self.st = cfg["stabilizer"]
        self.q, self.n = q, n
        ha, wa = st["analysis_height"], st["analysis_width"]
        dev = pool.device
        plain, clahed = [], []
        for a, b in _blocks(pool.shape[0], 4):
            g = q(ops.resize_bilinear(ops.bgr_to_gray(pool[a:b, 0].float()),
                                      ha, wa))
            plain.append(g)
            clahed.append(q(clahe(g)))
        self.plain, self.clahed = torch.cat(plain), torch.cat(clahed)
        self.pidx = torch.arange(n, device=dev) % pool.shape[0]
        mc = st["max_corners"]
        self.gray = torch.empty((n, ha, wa), device=dev)
        self.pts = torch.zeros((n, mc, 2), device=dev)
        self.msk = torch.zeros((n, mc), dtype=torch.bool, device=dev)
        self.curr = torch.zeros_like(self.pts)
        self.valid = torch.zeros_like(self.msk)
        self.clahe_on = np.zeros(n, bool)
        self.starved = np.zeros(n, np.int64)     # the counter after frame k
        self.gray[0] = self.plain[self.pidx[0]]
        self.pts[:1], self.msk[:1] = ops.good_features_to_track(
            self.gray[:1], mc, st["quality_level"], st["min_distance"])

    def _analyze(self, a: int, b: int, choice: bool) -> None:
        """Frames a .. b - 1 with CLAHE ``choice`` on each: their grays,
        detections, tracked points and valid masks."""
        st, dev = self.st, self.gray.device
        ks = torch.arange(a, b, device=dev)
        self.clahe_on[a:b] = choice
        self.gray[a:b] = (self.clahed if choice else self.plain)[self.pidx[ks]]
        even = [k for k in range(a, b) if k % 2 == 0]
        if even:
            ke = torch.tensor(even, device=dev)
            self.pts[ke], self.msk[ke] = ops.good_features_to_track(
                self.gray[ke], st["max_corners"], 0.02, 15.0)
        for parity in (1, 0):
            ko = [k for k in range(a, b) if k % 2 == parity]
            if ko:
                self._track(torch.tensor(ko, device=dev), parity)

    def _track(self, ks: torch.Tensor, parity: int) -> None:
        """LK onto frames ks: odd from the detected points of k - 1, even
        from the points tracked onto k - 1."""
        st, q = self.st, self.q
        prev_pts = self.pts[ks - 1] if parity == 1 else self.curr[ks - 1]
        prev_msk = self.msk[ks - 1] if parity == 1 else self.valid[ks - 1]
        start = prev_pts
        if st.get("motion_prediction", False):
            sc = 2 ** st["lk_levels"]
            hs, ws = st["analysis_height"] // sc, st["analysis_width"] // sc
            g = torch.cat([translation_prior(
                ops.resize_bilinear(self.gray[ks[a:b] - 1], hs, ws),
                ops.resize_bilinear(self.gray[ks[a:b]], hs, ws))
                for a, b in _blocks(len(ks), PRIOR_BLOCK)]) * sc
            start = prev_pts + g[:, None, :]
        pp, cp = ops.lk_planes(self.gray[ks - 1], self.gray[ks],
                               st["lk_levels"])
        mc = st["max_corners"]
        fid = torch.arange(len(ks), device=ks.device).repeat_interleave(mc)
        got, status = lk_track(pp, cp, fid, prev_pts.reshape(-1, 2),
                               start.reshape(-1, 2), prev_msk.reshape(-1),
                               st["lk_window"], st["lk_iters"])
        self.curr[ks] = q(got).reshape(prev_pts.shape)
        self.valid[ks] = prev_msk & status.reshape(prev_msk.shape)

    def settle(self, block: int = 64) -> None:
        """Every frame analysed on the CLAHE choice its predecessors'
        counter makes: a block on the last known choice, again from the
        first frame whose choice that mispredicts."""
        a = 1
        while a < self.n:
            choice = bool(self.starved[a - 1] > STARVED_FRAMES)
            b = min(self.n, a + block)
            self._analyze(a, b, choice)
            tracked = self.valid[a:b].sum(dim=-1).cpu().numpy()
            s = int(self.starved[a - 1])
            for k in range(a, b):
                if k > a and bool(s > STARVED_FRAMES) != choice:
                    b = k
                    break
                s = s + 1 if tracked[k - a] < STARVED_BELOW else 0
                self.starved[k] = s
            a = b


def outputs(cfg: dict, pool: torch.Tensor, n_calls: int, seed: int,
            sample_calls, precision: torch.dtype = torch.float32) -> dict:
    """The frames the program delivers at ``sample_calls``.

    pool: (P, 1, H, W, 3) u8, call c consumes ``pool[c % P]``. n_calls:
    the calls made, which bounds every sampled call. seed: the run's, from
    which the analyze step k >= 1 draws as the program does
    (``frames.draw_table``). -> {call: (1, H, W, 3) u8}."""
    check(cfg)
    q = _rounder(precision)
    st = cfg["stabilizer"]
    h, w = cfg["height"], cfg["width"]
    r_eff = max(5, min(st["smoothing_radius"], 35))
    last = max(sample_calls)
    if last >= n_calls or min(sample_calls) < r_eff - 1:
        raise ValueError(f"sampled calls {sorted(sample_calls)} outside "
                         f"[{r_eff - 1}, {n_calls})")
    n = last + 1                                  # frames the replay needs
    dev = pool.device
    s = _Stream(cfg, pool, n, q)
    s.settle()

    # RANSAC: raw transform k - 1 from the pair (k - 1, k).
    raw = torch.zeros((n, 1, 3), device=dev)
    table = frames.draw_table(seed, n - 1, 1, st["ransac_hypotheses"], dev)
    for a, b in _blocks(n - 1):
        ks = torch.arange(a + 1, b + 1, device=dev)
        prev_pts = torch.where((ks % 2 == 1)[:, None, None], s.pts[ks - 1],
                               s.curr[ks - 1])
        draws = ops.ransac_draws(table[ks - 1, 0],
                                 s.valid[ks].to(torch.int32).sum(dim=-1))
        raw[ks - 1, 0] = q(ops.estimate_similarity_ransac(
            prev_pts, s.curr[ks], s.valid[ks], draws, st["ransac_threshold"]))

    # The chain on each transform, then the cumulative path, one float32
    # add per entry as the program adds.
    hf_np = hf_chain(raw[:n - 1, 0].cpu().numpy(), st)
    hf_np = np.concatenate([hf_np, np.zeros((1, 3), np.float32)])
    raw = q(torch.from_numpy(hf_np).to(dev))[:, None]
    path_np = np.zeros_like(hf_np[:-1])
    acc = hf_np[0].copy()
    path_np[0] = acc
    for j in range(1, n - 1):
        acc = (acc + hf_np[j]).astype(np.float32)
        path_np[j] = acc
    path = q(torch.from_numpy(path_np).to(dev))

    taps = torch.from_numpy(gaussian_taps(st["gaussian_sigma"])).to(dev)
    sxf = float(np.float32(w / st["analysis_width"]))
    syf = float(np.float32(h / st["analysis_height"]))
    bs = st["border_size"]
    out = {}
    for c in sorted(sample_calls):
        e = c - (r_eff - 1)
        motion = raw[e]                                           # (1, 3)
        diff = q(gaussian_at(path, c, e, taps)) - path[e]
        scale = _intent_scale(raw, c, motion, e)
        t = q(motion + diff * scale[:, None])
        da = torch.zeros_like(t[:, 2]) if st.get("horizon_lock") else t[:, 2]
        m = ops.similarity_matrix(t[:, 0] * sxf, t[:, 1] * syf, da)
        warped = ops.warp_u8(pool[e % pool.shape[0], :1],
                             q(ops.invert_affine(m)), ops.BORDER_CONSTANT)
        crop = warped[:, bs:h - bs, bs:w - bs].float().movedim(-1, 1)
        zoom = ops.resize_bilinear(crop, h, w).movedim(1, -1)
        out[c] = ops.saturate_u8(q(zoom))
    return out
