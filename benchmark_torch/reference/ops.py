"""Plain PyTorch operators of the reference: the semantics of the
program's plain (non-kernel) versions, copied here so that the reference
imports nothing of the program and never launches one of its CUDA kernels.

Each function names the file of ``video_stab_tpu_torch`` whose semantics it
copies. Only what the benchmark's configurations run is kept: aperture-3
Sobel, block-3 Shi-Tomasi, the constant and replicate borders, the
pointwise enhancer, the similarity model. Functions that the program runs
per stream take a leading frame axis here, so that the reference computes
a whole stream's frames in a few large calls.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

BORDER_CONSTANT = 0
BORDER_REPLICATE = 1


# --- ops/color.py -----------------------------------------------------------

_GRAY_W = (0.114, 0.587, 0.299)


def saturate_u8(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, clamp to [0, 255], uint8."""
    if x.dtype == torch.uint8:
        return x
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) BGR -> (..., H, W): B, G, R summed in that order."""
    return (bgr[..., 0] * _GRAY_W[0] + bgr[..., 1] * _GRAY_W[1]) \
        + bgr[..., 2] * _GRAY_W[2]


# --- kernels/enhance.py (K4's plain version, pointwise stages only) ---------

def enhance_pointwise(brightness: float, contrast: float, gamma: float,
                      x: torch.Tensor) -> torch.Tensor:
    """Contrast/brightness then gamma on a float32 u8-domain frame."""
    if contrast != 1.0 or brightness != 0.0:
        x = torch.clamp(x * contrast + brightness, 0.0, 255.0)
    if abs(gamma - 1.0) > 1e-3:
        denom = torch.full((), 255.0, device=x.device)
        x = torch.pow(torch.clamp(x, 0.0, 255.0) / denom, gamma) * 255.0
    return x


# --- ops/filters.py ---------------------------------------------------------

def reflect_101_index(i: int, n: int) -> int:
    if n == 1:
        return 0
    period = 2 * (n - 1)
    i %= period
    return period - i if i >= n else i


def correlate_1d(x: torch.Tensor, kernel, dim: int) -> torch.Tensor:
    """Centered 1-D correlation along ``dim``, reflect-101 border, taps
    summed left to right."""
    dim = dim % x.dim()
    n = x.shape[dim]
    p = len(kernel) // 2
    xt = x.movedim(dim, -1)
    lead = xt.shape[:-1]
    xp = F.pad(xt.reshape(1, -1, n), (p, p), mode="reflect").reshape(
        *lead, n + 2 * p)
    out = None
    for t, k in enumerate(kernel):
        term = xp[..., t:t + n] * k
        out = term if out is None else out + term
    return out.movedim(-1, dim)


def sep_filter2d(img: torch.Tensor, kh, kw) -> torch.Tensor:
    return correlate_1d(correlate_1d(img, kh, -2), kw, -1)


def sobel(img: torch.Tensor):
    smooth, diff = (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0)
    return sep_filter2d(img, smooth, diff), sep_filter2d(img, diff, smooth)


def scharr_derivs(img: torch.Tensor):
    smooth = (3.0 / 16, 10.0 / 16, 3.0 / 16)
    diff = (-0.5, 0.0, 0.5)
    return sep_filter2d(img, smooth, diff), sep_filter2d(img, diff, smooth)


# --- ops/resize.py ----------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    scale = n_in / n_out
    x = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    x0 = np.floor(x)
    frac = x - x0
    i0 = np.clip(x0.astype(np.int64), 0, n_in - 1)
    i1 = np.clip(x0.astype(np.int64) + 1, 0, n_in - 1)
    w = np.zeros((n_out, n_in), dtype=np.float32)
    rows = np.arange(n_out)
    np.add.at(w, (rows, i0), (1.0 - frac).astype(np.float32))
    np.add.at(w, (rows, i1), frac.astype(np.float32))
    return w


_PYR_K = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0


@functools.lru_cache(maxsize=64)
def _pyr_down_weights(n_in: int) -> np.ndarray:
    n_out = (n_in + 1) // 2
    w = np.zeros((n_out, n_in), dtype=np.float32)
    for o in range(n_out):
        for t in range(-2, 3):
            w[o, reflect_101_index(2 * o + t, n_in)] += _PYR_K[t + 2]
    return w


@functools.lru_cache(maxsize=128)
def _taps_on(kind: str, n_in: int, n_out: int, device: torch.device):
    """The operator's nonzero taps, ascending per row: (k, n_out) indices
    and weights on ``device``."""
    mat = _resize_weights(n_in, n_out) if kind == "resize" \
        else _pyr_down_weights(n_in)
    k = int((mat != 0).sum(axis=1).max())
    idx = np.zeros((n_out, k), np.int64)
    wts = np.zeros((n_out, k), np.float32)
    for o in range(n_out):
        nz = np.nonzero(mat[o])[0]
        idx[o, :len(nz)] = nz
        wts[o, :len(nz)] = mat[o, nz]
    return (torch.from_numpy(idx.T.copy()).to(device),
            torch.from_numpy(wts.T.copy()).to(device))


def _apply(x: torch.Tensor, kind: str, n_out: int, dim: int) -> torch.Tensor:
    idx, wts = _taps_on(kind, x.shape[dim], n_out, x.device)
    shape = [1] * x.dim()
    shape[dim] = n_out
    out = None
    for t in range(idx.shape[0]):
        term = x.index_select(dim, idx[t]) * wts[t].view(shape)
        out = term if out is None else out + term
    return out


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of (..., H, W) float32, OpenCV half-pixel centers."""
    if tuple(img.shape[-2:]) == (out_h, out_w):
        return img
    x = _apply(img.float(), "resize", out_h, img.dim() - 2)
    return _apply(x, "resize", out_w, x.dim() - 1)


def build_pyramid(img: torch.Tensor, levels: int) -> list:
    pyr = [img]
    for _ in range(levels):
        x = pyr[-1]
        x = _apply(x, "pyr", (x.shape[-2] + 1) // 2, x.dim() - 2)
        pyr.append(_apply(x, "pyr", (x.shape[-1] + 1) // 2, x.dim() - 1))
    return pyr


# --- ops/warp.py and kernels/warp.py (K1's plain version) -------------------

def invert_affine(m: torch.Tensor) -> torch.Tensor:
    a, b, tx = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    c, d, ty = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    det = a * d - b * c
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    return torch.stack([torch.stack([ia, ib, itx], dim=-1),
                        torch.stack([ic, id_, ity], dim=-1)], dim=-2)


def rotation_matrix_2d(cx: float, cy: float, angle_deg: torch.Tensor
                       ) -> torch.Tensor:
    """cv2.getRotationMatrix2D for (...,) float32 angles -> (..., 2, 3)."""
    a = angle_deg.to(torch.float32) * (math.pi / 180.0)
    alpha, beta = torch.cos(a), torch.sin(a)
    tx = (1.0 - alpha) * cx - beta * cy
    ty = beta * cx + (1.0 - alpha) * cy
    return torch.stack([torch.stack([alpha, beta, tx], dim=-1),
                        torch.stack([-beta, alpha, ty], dim=-1)], dim=-2)


def similarity_matrix(dx, dy, da) -> torch.Tensor:
    c, s = torch.cos(da), torch.sin(da)
    return torch.stack([torch.stack([c, -s, dx], dim=-1),
                        torch.stack([s, c, dy], dim=-1)], dim=-2)


def warp_u8(img: torch.Tensor, minv: torch.Tensor, border: int
            ) -> torch.Tensor:
    """Frames (F, H, W[, C]) u8 warped by their inverse maps (F, 2, 3),
    bilinear, x first then y, every product and sum in float32, rounded
    half to even; ``border`` BORDER_CONSTANT (0) or BORDER_REPLICATE."""
    has_c = img.dim() == 4
    n, h, w = img.shape[:3]
    dev = img.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    m = minv.reshape(n, 6)[:, :, None, None]
    sx = (m[:, 0] * xs + m[:, 1] * ys) + m[:, 2]
    sy = (m[:, 3] * xs + m[:, 4] * ys) + m[:, 5]
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0f, sy - y0f
    x0 = x0f.clamp(-1e9, 1e9).to(torch.int64)
    y0 = y0f.clamp(-1e9, 1e9).to(torch.int64)
    src = img.reshape(n, h * w, -1).float()
    base = (torch.arange(n, device=dev) * (h * w))[:, None, None]

    def tap(yi, xi):
        v = src.reshape(n * h * w, -1)[
            (base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(-1)
        ].reshape(n, h, w, -1)
        if border == BORDER_CONSTANT:
            ok = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
            v = torch.where(ok[..., None], v, torch.zeros_like(v))
        return v

    v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
    v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    fx, fy = fx[..., None], fy[..., None]
    gx, gy = 1.0 - fx, 1.0 - fy
    top = v00 * gx + v01 * fx
    bot = v10 * gx + v11 * fx
    out = saturate_u8(top * gy + bot * fy)
    return out if has_c else out[..., 0]


# --- ops/canny.py, ops/hough.py (the roll estimate) -------------------------

def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1))
    return p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def canny_edges(gray: torch.Tensor, lo: float, hi: float,
                hysteresis_iters: int = 16) -> torch.Tensor:
    """Binary 0/255 edge maps of (F, H, W) u8-domain grays (L1 magnitude,
    4-way non-max suppression, fixed-count hysteresis)."""
    gx, gy = sobel(gray)
    mag = torch.abs(gx) + torch.abs(gy)
    ax, ay = torch.abs(gx), torch.abs(gy)
    horiz = ay <= ax * 0.4142135623730951
    vert = ay >= ax * 2.414213562373095
    same_sign = (gx * gy) >= 0
    n1 = torch.where(horiz, _shift(mag, 0, -1), torch.where(
        vert, _shift(mag, -1, 0), torch.where(
            same_sign, _shift(mag, -1, -1), _shift(mag, -1, 1))))
    n2 = torch.where(horiz, _shift(mag, 0, 1), torch.where(
        vert, _shift(mag, 1, 0), torch.where(
            same_sign, _shift(mag, 1, 1), _shift(mag, 1, -1))))
    is_max = (mag >= n1) & (mag > n2)
    strong = (is_max & (mag > hi)).to(gray.dtype)
    weak = (is_max & (mag > lo)).to(gray.dtype)
    edges = strong[:, None]
    for _ in range(hysteresis_iters):
        edges = F.max_pool2d(edges, 3, stride=1, padding=1) * weak[:, None]
    return torch.where(edges[:, 0] > 0, 255.0, 0.0).to(gray.dtype)


def top_candidates(values: torch.Tensor, k: int):
    """The k largest along the last dim, ties to the lower index."""
    vals, idx = torch.sort(values, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def hough_lines(edges: torch.Tensor, rho: float, theta: float,
                threshold: int, max_lines: int, theta_range):
    """Lines of one (H, W) edge map: (lines (L, 2) [rho, theta], mask (L,))
    with vote-descending order and ties in index order."""
    dev = edges.device
    h, w = edges.shape
    n_theta_full = int(round(math.pi / theta))
    t0 = max(0, int(math.floor(float(theta_range[0]) / theta)) - 1)
    t1 = min(n_theta_full - 1,
             int(math.ceil(float(theta_range[1]) / theta)) + 1)
    n_theta = t1 - t0 + 1
    n_rho = int(round(((w + h) * 2 + 1) / rho))
    center = (n_rho - 1) // 2
    n_bins = -(-n_rho // 128) * 128
    thetas = (torch.arange(n_theta, dtype=torch.float32, device=dev)
              + float(t0)) * theta
    cos_t = torch.cos(thetas) / rho
    sin_t = torch.sin(thetas) / rho
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    weight = (edges > 0).to(torch.int32).reshape(1, -1).expand(n_theta, -1)
    ridx = torch.round(xs[None] * cos_t[:, None, None]
                       + ys[None] * sin_t[:, None, None]).to(torch.int64)
    ridx = (ridx + center).clamp(0, n_bins - 1).reshape(n_theta, -1)
    acc = torch.zeros((n_theta, n_bins), dtype=torch.int32, device=dev)
    acc.scatter_add_(1, ridx, weight)
    acc = acc[:, :n_rho].to(torch.float32).T
    up = F.pad(acc[:-1, :], (0, 0, 1, 0))
    down = F.pad(acc[1:, :], (0, 0, 0, 1))
    left = F.pad(acc[:, :-1], (1, 0, 0, 0))
    right = F.pad(acc[:, 1:], (0, 1, 0, 0))
    is_peak = (acc > up) & (acc >= down) & (acc > left) & (acc >= right)
    peak_votes = torch.where(is_peak, acc, torch.zeros_like(acc))
    tcol = (torch.arange(n_theta, device=dev) + t0).to(torch.float32) * theta
    lo = torch.full((), float(theta_range[0]) - 1e-9, device=dev)
    hi = torch.full((), float(theta_range[1]) + 1e-9, device=dev)
    in_range = (tcol >= lo) & (tcol <= hi)
    peak_votes = torch.where(in_range[None, :], peak_votes,
                             torch.zeros_like(peak_votes))
    votes, idx = top_candidates(peak_votes.reshape(-1),
                                min(max_lines, n_rho * n_theta))
    r_idx = torch.div(idx, n_theta, rounding_mode="floor")
    t_idx = idx % n_theta
    lines = torch.stack([(r_idx - center).to(torch.float32) * rho,
                         (t_idx + t0).to(torch.float32) * theta], dim=-1)
    return lines, votes > threshold


# --- kernels/features.py (K3's plain version), ops/features.py (GFTT) -------

def corner_response(gray: torch.Tensor):
    """Min-eigenvalue response with OpenCV's u8 scale at block 3 and its
    3x3 peak mask (neighbours wrap around the frame), of (F, H, W)."""
    scale = 1.0 / (4 * 3 * 255.0)
    gx, gy = sobel(gray)
    gx, gy = gx * scale, gy * scale
    ones = (1.0, 1.0, 1.0)
    sxx = sep_filter2d(gx * gx, ones, ones)
    syy = sep_filter2d(gy * gy, ones, ones)
    sxy = sep_filter2d(gx * gy, ones, ones)
    half_tr = 0.5 * (sxx + syy)
    half_df = 0.5 * (sxx - syy)
    resp = half_tr - torch.sqrt(half_df * half_df + sxy * sxy)
    dil = resp
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if (dy, dx) != (0, 0):
                dil = torch.maximum(dil, torch.roll(resp, (-dy, -dx),
                                                    (-2, -1)))
    return resp, resp >= dil


def good_features_to_track(gray: torch.Tensor, max_corners: int,
                           quality_level: float, min_distance: float,
                           n_candidates: int = 2048):
    """goodFeaturesToTrack of (F, H, W) grays, fixed capacity: (pts
    (F, max_corners, 2) (x, y), mask (F, max_corners)); greedy
    min-distance selection in quality order."""
    h, w = gray.shape[-2:]
    resp, is_peak = corner_response(gray)
    thresh = quality_level * resp.amax(dim=(-2, -1), keepdim=True)
    cand = torch.where(is_peak & (resp > thresh), resp,
                       torch.full_like(resp, -1.0))
    top_vals, top_idx = top_candidates(cand.flatten(-2),
                                       min(n_candidates, h * w))
    n_cand = top_vals.shape[-1]
    dev = gray.device
    cx = (top_idx % w).to(torch.float32)
    cy = torch.div(top_idx, w, rounding_mode="floor").to(torch.float32)
    min_d2 = float(np.float32(min_distance * min_distance))
    valid = top_vals > 0.0
    d2 = ((cx[..., :, None] - cx[..., None, :]) ** 2
          + (cy[..., :, None] - cy[..., None, :]) ** 2)
    rank = torch.arange(n_cand, device=dev)
    conflict = (d2 < min_d2) & (rank[None, :] < rank[:, None]) \
        & valid[..., None, :]
    del d2
    unknown, selected = valid, torch.zeros_like(valid)
    while bool(unknown.any()):
        higher = (conflict & (unknown | selected)[..., None, :]).any(dim=-1)
        newly = unknown & ~higher
        selected = selected | newly
        suppressed = (conflict & selected[..., None, :]).any(dim=-1)
        unknown = unknown & ~newly & ~suppressed
    k = max_corners
    lead = tuple(top_vals.shape[:-1])
    pos = torch.cumsum(selected.to(torch.int32), -1) - 1
    take = selected & (pos < k)
    idx = torch.where(take, pos, torch.full_like(pos, k)).to(torch.int64)
    pts = torch.zeros(lead + (k + 1, 2), dtype=torch.float32, device=dev)
    pts.scatter_(-2, idx[..., None].expand(*idx.shape, 2),
                 torch.stack([cx, cy], dim=-1))
    mask = torch.zeros(lead + (k + 1,), dtype=torch.bool, device=dev)
    mask.scatter_(-1, idx, take)
    return pts[..., :k, :].contiguous(), mask[..., :k].contiguous()


# --- ops/lk.py, kernels/lk.py (K6's plain version) --------------------------

DRIFT, DRIFT_TOP = 8, 24


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def lk_planes(prev_gray: torch.Tensor, curr_gray: torch.Tensor,
              max_level: int):
    """Per level: (F, 3, Hl, Wl) [prev, d/dx, d/dy] and (F, Hl, Wl) curr,
    every value rounded to bfloat16 (the program's LK reads them so)."""
    prev_planes = []
    for p in build_pyramid(prev_gray, max_level):
        ix, iy = scharr_derivs(p)
        prev_planes.append(bf16(torch.stack([p, ix, iy], dim=-3)))
    curr_planes = [bf16(c) for c in build_pyramid(curr_gray, max_level)]
    return prev_planes, curr_planes


def _slab(img: torch.Tensor, fid: torch.Tensor, y0: torch.Tensor,
          x0: torch.Tensor, s: int) -> torch.Tensor:
    """Per-point s x s slabs of frame ``fid`` at integer corners, indices
    clamped. img (F, C, H, W); fid, y0, x0 (N,) -> (N, C, s, s)."""
    nf, ch, h, w = img.shape
    ss = torch.arange(s, device=img.device)
    ry = (y0[:, None] + ss[None, :]).clamp(0, h - 1)
    rx = (x0[:, None] + ss[None, :]).clamp(0, w - 1)
    flat = fid[:, None, None] * (h * w) + ry[:, :, None] * w + rx[:, None, :]
    planes = img.transpose(0, 1).reshape(ch, nf * h * w)
    vals = planes[:, flat.reshape(-1)]
    return vals.reshape(ch, -1, s, s).transpose(0, 1)


def _hat(c: torch.Tensor, win: int, s: int) -> torch.Tensor:
    i = torch.arange(win, dtype=torch.float32, device=c.device)[:, None]
    a = torch.arange(s, dtype=torch.float32, device=c.device)[None, :]
    return torch.relu(1.0 - torch.abs(c[..., None, None] + (i - a)))


def _interp_window(slab: torch.Tensor, cyx: torch.Tensor, win: int):
    wts = _hat(cyx, win, slab.shape[-1])
    wy, wx = wts[:, 0:1], wts[:, 1:2]
    return (wy @ slab) @ wx.transpose(-1, -2)


def lk_track(prev_planes, curr_planes, fid: torch.Tensor,
             prev_pts: torch.Tensor, pts_mask: torch.Tensor, win: int,
             iters: int, eps: float = 0.03, min_eig_thresh: float = 1e-4):
    """The pyramidal LK ladder for N points, point i on frame pair
    ``fid[i]`` of the planes: rounds of Newton steps per level (4 at the
    top, 2 below), the current slab re-fetched at each round's guess,
    the eps freeze and the min-eigenvalue test, then the ``inside`` test.
    -> (curr_pts (N, 2) (x, y), status (N,))."""
    max_level = len(prev_planes) - 1
    h, w = curr_planes[0].shape[-2:]
    half = (win - 1) * 0.5
    guess = prev_pts * (1.0 / (2 ** max_level))
    ok = pts_mask
    for level in range(max_level, -1, -1):
        drift = DRIFT_TOP if level == max_level else DRIFT
        s_c = win + 1 + 2 * drift
        pt_prev = prev_pts / (2 ** level)
        ty0f = torch.floor(pt_prev[:, 1] - half)
        tx0f = torch.floor(pt_prev[:, 0] - half)
        t_slab = _slab(prev_planes[level], fid, ty0f.to(torch.int64),
                       tx0f.to(torch.int64), win + 1)
        tmpl = _interp_window(t_slab, torch.stack(
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
            c_slab = _slab(curr_l, fid, c0[:, 0].to(torch.int64),
                           c0[:, 1].to(torch.int64), s_c)
            origin = c0 + half
            for _ in range(iters_per):
                c = torch.clamp(pt - origin, 0.0, s_c - win - 1.0)
                j_win = _interp_window(c_slab, c, win)[:, 0]
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


# --- motion/estimate.py (RANSAC similarity) ---------------------------------

def ransac_draws(u: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """(..., K, 2) draws in [0, max(n_valid, 1)) from uniforms u."""
    hi = torch.clamp(n_valid, min=1).to(torch.float32)[..., None, None]
    return torch.floor(u * hi).to(torch.int64).clamp(
        max=hi.to(torch.int64) - 1)


def _similarity_from_two(p1, p2, q1, q2):
    dp, dq = p2 - p1, q2 - q1
    denom = dp[..., 0] * dp[..., 0] + dp[..., 1] * dp[..., 1]
    ok = denom > 1e-6
    safe = torch.where(ok, denom, torch.ones_like(denom))
    a = (dq[..., 0] * dp[..., 0] + dq[..., 1] * dp[..., 1]) / safe
    b = (dq[..., 1] * dp[..., 0] - dq[..., 0] * dp[..., 1]) / safe
    tx = q1[..., 0] - (a * p1[..., 0] - b * p1[..., 1])
    ty = q1[..., 1] - (b * p1[..., 0] + a * p1[..., 1])
    return torch.stack([a, b, tx, ty], dim=-1), ok


def _similarity_lsq(prev, curr, w):
    n = w.sum(dim=-1)
    ok = n >= 2.0
    safe_n = torch.where(ok, n, torch.ones_like(n))[..., None]
    pm = (prev * w[..., None]).sum(dim=-2) / safe_n
    qm = (curr * w[..., None]).sum(dim=-2) / safe_n
    pc = (prev - pm[..., None, :]) * w[..., None]
    qc = curr - qm[..., None, :]
    dot = (pc[..., 0] * qc[..., 0] + pc[..., 1] * qc[..., 1]).sum(dim=-1)
    cross = (pc[..., 0] * qc[..., 1] - pc[..., 1] * qc[..., 0]).sum(dim=-1)
    norm = ((prev - pm[..., None, :]) ** 2 * w[..., None]).sum(dim=(-2, -1))
    big = norm > 1e-9
    safe_norm = torch.where(big, norm, torch.ones_like(norm))
    a = torch.where(big, dot / safe_norm, torch.ones_like(dot))
    b = torch.where(big, cross / safe_norm, torch.zeros_like(cross))
    tx = qm[..., 0] - (a * pm[..., 0] - b * pm[..., 1])
    ty = qm[..., 1] - (b * pm[..., 0] + a * pm[..., 1])
    return torch.stack([a, b, tx, ty], dim=-1), ok


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[f, idx[f, ...]] per frame f: x (F, P, *feat), idx (F, *I)."""
    feat = x.shape[2:]
    flat = idx.reshape(idx.shape[0], -1)
    g = flat.reshape(*flat.shape, *([1] * len(feat))).expand(*flat.shape,
                                                             *feat)
    return x.gather(1, g).reshape(*idx.shape, *feat)


def estimate_similarity_ransac(prev, curr, mask, draws, threshold: float):
    """RANSAC 4-DOF similarity of F point sets (F, P, 2) with (F, K, 2)
    draws into the valid points compacted to the front; the best
    hypothesis's inliers refit by least squares. -> (F, 3) (tx, ty,
    angle): the identity's under 4 valid points."""
    n_valid = mask.to(torch.int32).sum(dim=-1)
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    samples = _take(order, draws)
    i, j = samples[..., 0], samples[..., 1]
    theta, ok = _similarity_from_two(_take(prev, i), _take(prev, j),
                                     _take(curr, i), _take(curr, j))
    ok = ok & (i != j)
    px, py = prev[..., None, :, 0], prev[..., None, :, 1]
    a, b = theta[..., 0:1], theta[..., 1:2]
    rx = a * px - b * py + theta[..., 2:3]
    ry = b * px + a * py + theta[..., 3:4]
    err2 = (rx - curr[..., None, :, 0]) ** 2 \
        + (ry - curr[..., None, :, 1]) ** 2
    inl = mask[..., None, :] & (err2 < threshold * threshold)
    scores = torch.where(ok, inl.to(torch.int32).sum(dim=-1),
                         torch.full_like(n_valid[..., None], -1))
    best = torch.argmax(scores, dim=-1, keepdim=True)
    best_inliers = _take(inl, best)[:, 0, :]
    theta, fit_ok = _similarity_lsq(prev, curr, best_inliers.to(torch.float32))
    enough = (n_valid >= 4) & (_take(scores, best)[:, 0] >= 2) & fit_ok
    a, b, tx, ty = theta.unbind(dim=-1)
    # m = [[a, -b, tx], [b, a, ty]]; the transform (m02, m12,
    # atan2(m10, m00)), the identity's (0, 0, 0) where not enough.
    raw = torch.stack([tx, ty, torch.atan2(b, a)], dim=-1)
    return torch.where(enough[:, None], raw, torch.zeros_like(raw))
