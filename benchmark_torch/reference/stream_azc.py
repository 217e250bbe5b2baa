"""The plain reference of the live restream chain: the similarity model
through the two-pass roll with auto zoom-crop, Kalman smoothing, planar
I420 delivered one call late.

It replays a stream from its first frame and returns the frames the
program delivers at the sampled calls, as ``stream.py`` does, with every
stage computed for a block of frames at once. The semantics are those the
program states (``core/chain.py:_pre_stages``, ``_deliver`` and
``ProcessingChain(pipelined=True)``, ``core/autozoomcrop.py``,
``core/stabilizer.py:_smoothed_at_emit``, ``ops/color.py:bgr_to_i420``);
the zoom-crop, the Kalman filter and the I420 conversion are written here
from those statements, not copied:

- the two-pass roll: per frame K4's pointwise enhance and the gray of the
  unsaturated frame, the smoothed roll angle from that gray (the band as
  configured), the saturated frame rotated whole about its centre with a
  replicated border;
- auto zoom-crop of the rotated u8 frame: its gray, content where the
  gray is above ``content_threshold``, a morphological close (dilate then
  erode, points outside the frame not counted) with OpenCV's elliptical
  ``morph_kernel`` x ``morph_kernel`` element; the content's bounding box
  shrunk one side at a time while any of its four edges holds a hole and
  the box is not degenerate: the top moves in where its edge holds more
  holes than each other edge, else the bottom where it holds more than
  the left and the right; the left moves in where its edge holds at least
  as many as each other edge, else the right where it holds at least as
  many as the top and the bottom; where no rule picks a side, every side
  whose edge holds a hole moves in; the loop runs to its end. The box
  (inclusive corners x0, y0, x1, y1) is widened or narrowed about its
  centre to the frame's aspect ratio (width (y1 - y0) W / H, kept inside
  the frame) and resampled to H x W, src = (x0' + x sx, y0 + y sy) with
  sx = width / W, sy = (y1 - y0) / H: bilinear tent weights
  max(0, 1 - |src - i|), zero outside the frame, rows first, rounded half
  to even. A frame with no content is passed on whole. The zoom-cropped
  frame is what is queued, and its analysis gray what is tracked;
- per frame k >= 1 LK, RANSAC and the cumulative path as ``stream.py``
  computes them (no roll composed into the emit);
- the Kalman filter per path axis: state (position, velocity) started at
  (path[0], 0) with zero covariance, its output path[0] at e = 0; for
  e >= 1 predict with F = [[1, 1], [0, 1]] and Q = 0.01 I, correct with
  H = [1, 0] and R = 0.1, the output the corrected position;
- the emit of frame e: the correction raw[e] + (kalman[e] - path[e])
  scaled by the motion intent (``stream.py``), one affine warp of the
  queued frame, bilinear, constant border;
- BGR -> I420: BT.601 limited range, Y = 16 + (25.064 B + 129.057 G +
  65.738 R) / 256, U = 128 + (112.439 B - 74.494 G - 37.945 R) / 256,
  V = 128 + (-18.285 B - 94.154 G + 112.439 R) / 256, the chroma the mean
  of each 2 x 2 block, each rounded half up and clipped; the Y plane,
  then U and V, each packed two half-rows a row;
- pipelined: call c >= effective_radius delivers the frame the unpipelined
  chain delivers at call c - 1, frame e = c - effective_radius.

Where this file departs from how the program computes the same thing:
the close is two 2-D convolutions of the binary mask with the element
(the program: the max and min of shifted copies); each edge's holes are
counted along the edge itself (the program: per-row and per-column prefix
sums) and the loop is checked after every step of a block of frames (the
program: in chunks of 32 masked steps, one read a chunk); the Kalman
filter is written in matrix form in numpy float32 (the program: its
entries, on the device); the chroma mean adds the four values in another
order.

``precision``: every stage's result rounded to it, as in ``stream.py``.
A configuration names this file as its ``"reference": "stream_azc"``;
``check`` refuses what it does not model.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark_torch import frames
from benchmark_torch.reference import ops
from benchmark_torch.reference.stream import (READS, _blocks, _intent_scale,
                                              _roll_angles, _roll_detect,
                                              _rounder)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FRAME_BLOCK = 8     # full-size frames per block of the roll and zoom-crop
KALMAN_Q = 0.01
KALMAN_R = 0.1

AZC_READS = {"enabled", "content_threshold", "morph_kernel",
             "keep_input_size"}
FIXED = {"system": "chain_azc", "streams": 1, "output_format": "i420",
         "pipelined": True}
FIXED_AZC = {"enabled": True, "keep_input_size": True}
FIXED_STAB = {"redetect_interval": 2, "motion_model": "similarity",
              "smoothing_method": "kalman"}
GROUPS = {**READS, "stabilizer": READS["stabilizer"] | {"smoothing_method"},
          "azc": AZC_READS}
TOP = {"system", "reference", "source", "height", "width", "streams",
       "pool_frames", "assumed", "correct_limits", "output_format",
       "pipelined", *GROUPS}


def check(cfg: dict) -> None:
    """Raise ValueError where ``cfg`` asks for what this reference does
    not model: another system, several streams, another delivered format
    or an unpipelined chain, a key it does not read, a stage left out,
    auto zoom-crop off or to a fixed size, another motion model, smoother
    or re-detection interval, a frame I420 cannot hold."""
    for key, want in FIXED.items():
        if cfg.get(key) != want:
            raise ValueError(f"the zoom-crop reference models {key} = "
                             f"{want!r} only, not {cfg.get(key)!r}")
    extra, missing = set(cfg) - TOP, TOP - {"assumed", "source"} - set(cfg)
    if extra or missing:
        raise ValueError(f"the zoom-crop reference does not model the keys "
                         f"{sorted(extra)}; missing {sorted(missing)}")
    for group, keys in GROUPS.items():
        extra = set(cfg[group]) - keys
        if extra:
            raise ValueError(f"the zoom-crop reference does not model "
                             f"{group} keys {sorted(extra)}")
    for group, fixed in (("azc", FIXED_AZC), ("stabilizer", FIXED_STAB)):
        for key, want in fixed.items():
            if cfg[group].get(key) != want:
                raise ValueError(f"the zoom-crop reference models {group}."
                                 f"{key} = {want!r} only, not "
                                 f"{cfg[group].get(key)!r}")
    if cfg["height"] % 4 or cfg["width"] % 2:
        raise ValueError(f"I420 needs H % 4 == 0 and W % 2 == 0, not "
                         f"{cfg['height']}x{cfg['width']}")


# --- auto zoom-crop -------------------------------------------------------------

def ellipse(k: int) -> torch.Tensor:
    """OpenCV's MORPH_ELLIPSE element, k x k: row dy from the centre spans
    round(r sqrt(1 - dy^2 / r^2)) either side, r = k // 2; the first and
    last rows their centre only."""
    r = k // 2
    el = torch.zeros((k, k))
    for i in range(k):
        dy = i - r
        half = 0 if r == 0 else int(round(r * math.sqrt(
            max(0.0, (r * r - dy * dy) / (r * r)))))
        el[i, r - half:r + half + 1] = 1.0
    return el


def close_mask(content: torch.Tensor, k: int) -> torch.Tensor:
    """The morphological close of (F, H, W) bool masks with ``ellipse(k)``,
    outside the frame not counted: a point is content after the dilation
    where the element over it covers content, and after the erosion where
    it covers no point that the dilation left empty."""
    el = ellipse(k).to(content.device)[None, None]
    r = k // 2
    dil = F.conv2d(content.float()[:, None], el, padding=r)[:, 0] > 0
    holes = F.conv2d((~dil).float()[:, None], el, padding=r)[:, 0] > 0
    return ~holes


def _edge_holes(holes: torch.Tensor, rect: torch.Tensor) -> torch.Tensor:
    """(F, 4) holes on the left, top, right and bottom edges of each
    frame's box (F, 4) [x0, y0, x1, y1], inclusive, each corner clamped
    into the frame."""
    n, h, w = holes.shape
    f = torch.arange(n, device=holes.device)
    x0, y0 = rect[:, 0].clamp(0, w - 1), rect[:, 1].clamp(0, h - 1)
    x1, y1 = rect[:, 2].clamp(0, w - 1), rect[:, 3].clamp(0, h - 1)
    ys = torch.arange(h, device=holes.device)[None]
    xs = torch.arange(w, device=holes.device)[None]
    rows = (ys >= y0[:, None]) & (ys <= y1[:, None])             # (F, H)
    cols = (xs >= x0[:, None]) & (xs <= x1[:, None])             # (F, W)
    return torch.stack([(holes[f, :, x0] & rows).sum(-1),
                        (holes[f, y0, :] & cols).sum(-1),
                        (holes[f, :, x1] & rows).sum(-1),
                        (holes[f, y1, :] & cols).sum(-1)], dim=-1)


def interior_rect(content: torch.Tensor) -> torch.Tensor:
    """(F, 4) int64 [x0, y0, x1, y1]: each frame's content box shrunk one
    side at a time while an edge holds a hole (the module's docstring)."""
    n, h, w = content.shape
    dev = content.device
    rows, cols = content.any(dim=2), content.any(dim=1)
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    rect = torch.stack([torch.where(cols, xs, w).amin(-1),
                        torch.where(rows, ys, h).amin(-1),
                        torch.where(cols, xs, -1).amax(-1),
                        torch.where(rows, ys, -1).amax(-1)], dim=-1)
    holes = ~content
    step = torch.tensor([1, 1, -1, -1], device=dev)
    while True:
        cl, ct, cr, cb = _edge_holes(holes, rect).unbind(-1)
        go = ((cl + ct + cr + cb) > 0) & (rect[:, 0] < rect[:, 2]) \
            & (rect[:, 1] < rect[:, 3])
        if not bool(go.any()):
            return rect
        top = (ct > cb) & (ct > cl) & (ct > cr)
        bottom = ~(ct > cb) & (cb > cl) & (cb > cr)
        left = (cl >= cr) & (cl >= cb) & (cl >= ct)
        right = ~(cl >= cr) & (cr >= ct) & (cr >= cb)
        none = ~(top | bottom | left | right)
        move = torch.stack([left | (none & (cl > 0)), top | (none & (ct > 0)),
                            right | (none & (cr > 0)),
                            bottom | (none & (cb > 0))], dim=-1)
        rect = rect + torch.where(go[:, None] & move, step, 0)


def _tent(start: torch.Tensor, scale: torch.Tensor, n_out: int, n_in: int):
    """Per frame the two source indices (clamped) and tent weights of each
    output position src = start + o * scale: (F, n_out) each."""
    src = start[:, None] + torch.arange(n_out, dtype=torch.float32,
                                        device=start.device) * scale[:, None]
    lo = torch.floor(src)
    taps = []
    for i in (lo, lo + 1.0):
        wgt = torch.clamp(1.0 - (src - i).abs(), min=0.0)
        wgt = torch.where((i >= 0) & (i <= n_in - 1), wgt, 0.0)
        taps.append((i.clamp(0, n_in - 1).to(torch.int64), wgt))
    return taps


def zoom_crop(frames_u8: torch.Tensor, azc: dict, q=lambda x: x
              ) -> torch.Tensor:
    """Auto zoom-crop of (F, H, W, 3) u8 frames back to H x W: u8."""
    n, h, w = frames_u8.shape[:3]
    x = frames_u8.float()
    content = close_mask(ops.bgr_to_gray(x) > azc["content_threshold"],
                         azc["morph_kernel"])
    rect = interior_rect(content)
    r = rect.to(torch.float32)
    rw = torch.clamp(r[:, 2] - r[:, 0], min=1.0)
    rh = torch.clamp(r[:, 3] - r[:, 1], min=1.0)
    new_w = rh * (w / h)
    nx0 = (r[:, 0] + rw * 0.5) - new_w * 0.5
    nx0 = torch.minimum(torch.clamp(nx0, min=0.0),
                        torch.clamp(w - new_w, min=0.0))
    new_w = torch.clamp(new_w, max=float(w))
    one = torch.ones((), device=x.device)
    f = torch.arange(n, device=x.device)[:, None]
    rows = _tent(r[:, 1], rh / (one * h), h, h)
    x = sum(x[f, i] * wt[..., None, None] for i, wt in rows)
    cols = _tent(nx0, new_w / (one * w), w, w)
    x = sum(x[f, :, i].transpose(1, 2) * wt[:, None, :, None]
            for i, wt in cols)
    out = ops.saturate_u8(q(x))
    found = content.flatten(1).any(-1)
    return torch.where(found[:, None, None, None], out, frames_u8)


# --- Kalman, I420 ---------------------------------------------------------------

def kalman_path(path: np.ndarray) -> np.ndarray:
    """(E, C) float32 path -> (E, C): the filtered position after each
    entry, the filter started at entry 0."""
    fm = np.array([[1.0, 1.0], [0.0, 1.0]], np.float32)
    qm = np.float32(KALMAN_Q) * np.eye(2, dtype=np.float32)
    out = np.empty_like(path)
    out[0] = path[0]
    for c in range(path.shape[1]):
        x = np.array([path[0, c], 0.0], np.float32)
        p = np.zeros((2, 2), np.float32)
        for e in range(1, path.shape[0]):
            x = fm @ x
            p = fm @ p @ fm.T + qm
            gain = p[:, 0] / (p[0, 0] + np.float32(KALMAN_R))
            x = x + gain * (path[e, c] - x[0])
            p = p - np.outer(gain, p[0])
            out[e, c] = x[0]
    return out


def bgr_to_i420(img_u8: torch.Tensor, q=lambda x: x) -> torch.Tensor:
    """(H, W, 3) u8 BGR -> (3H / 2, W) u8 I420 (the module's docstring)."""
    h, w = img_u8.shape[:2]
    b, g, r = img_u8.float().unbind(-1)
    y = 16.0 + (b * 25.064 + g * 129.057 + r * 65.738) / 256.0
    u = 128.0 + (b * 112.439 - g * 74.494 - r * 37.945) / 256.0
    v = 128.0 + (-b * 18.285 - g * 94.154 + r * 112.439) / 256.0

    def quarter(c):
        return (c[0::2, 0::2] + c[1::2, 0::2] + c[0::2, 1::2]
                + c[1::2, 1::2]) / 4.0

    def u8(c):
        return torch.clamp(torch.floor(q(c) + 0.5), 0, 255).to(torch.uint8)

    return torch.cat([u8(y), u8(quarter(u)).reshape(h // 4, w),
                      u8(quarter(v)).reshape(h // 4, w)])


# --- the replay -----------------------------------------------------------------

def outputs(cfg: dict, pool: torch.Tensor, n_calls: int, seed: int,
            sample_calls, precision: torch.dtype = torch.float32) -> dict:
    """The frames the program delivers at ``sample_calls``.

    pool: (P, 1, H, W, 3) u8, call c consumes ``pool[c % P]``. n_calls:
    the calls made, which bounds every sampled call. seed: the run's, from
    which the analyze step k >= 1 draws as the program does
    (``frames.draw_table``). -> {call: (1, 3H / 2, W) u8}."""
    check(cfg)
    q = _rounder(precision)
    st, en, ro = cfg["stabilizer"], cfg["enhancer"], cfg["roll"]
    h, w = cfg["height"], cfg["width"]
    ha, wa = st["analysis_height"], st["analysis_width"]
    n_pool = pool.shape[0]
    r_eff = max(5, min(st["smoothing_radius"], 35))
    last = max(sample_calls)
    if last >= n_calls or min(sample_calls) < r_eff:
        raise ValueError(f"sampled calls {sorted(sample_calls)} outside "
                         f"[{r_eff}, {n_calls})")
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

    def queued(ks):
        rot = ops.warp_u8(enhanced[pidx[ks]], rot_inv[ks],
                          ops.BORDER_REPLICATE)
        return zoom_crop(rot, cfg["azc"], q)

    # The analysis gray of every queued frame.
    gray = torch.empty((n, ha, wa), device=dev)
    for a, b in _blocks(n, FRAME_BLOCK):
        g = ops.bgr_to_gray(queued(torch.arange(a, b, device=dev)).float())
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

    # RANSAC: raw transform k - 1 from the pair (k - 1, k).
    raw = torch.zeros((n, 1, 3), device=dev)
    table = frames.draw_table(seed, n - 1, 1, st["ransac_hypotheses"], dev)
    for a, b in _blocks(n - 1):
        ks = torch.arange(a + 1, b + 1, device=dev)
        prev_pts = torch.where((ks % 2 == 1)[:, None, None], pts[ks - 1],
                               curr[ks - 1])
        draws = ops.ransac_draws(table[ks - 1, 0],
                                 valid[ks].to(torch.int32).sum(dim=-1))
        raw[ks - 1, 0] = q(ops.estimate_similarity_ransac(
            prev_pts, curr[ks], valid[ks], draws, st["ransac_threshold"]))

    # The cumulative path, one float32 add per entry as the program adds,
    # and its Kalman filter.
    raw_np = raw[:n - 1, 0].cpu().numpy()
    path_np = np.zeros_like(raw_np)
    acc = raw_np[0].copy()
    path_np[0] = acc
    for j in range(1, n - 1):
        acc = (acc + raw_np[j]).astype(np.float32)
        path_np[j] = acc
    path = q(torch.from_numpy(path_np).to(dev))
    kalman = q(torch.from_numpy(kalman_path(path.cpu().numpy())).to(dev))

    sxf = float(np.float32(w / wa))
    syf = float(np.float32(h / ha))
    out = {}
    for c in sorted(sample_calls):
        e = c - r_eff
        motion = raw[e]                                           # (1, 3)
        diff = kalman[e] - path[e]
        scale = _intent_scale(raw, c - 1, motion, e)
        t = q(motion + diff * scale[:, None])
        m = ops.similarity_matrix(t[:, 0] * sxf, t[:, 1] * syf, t[:, 2])
        frame = queued(torch.tensor([e], device=dev))
        emitted = ops.warp_u8(frame, q(ops.invert_affine(m)),
                              ops.BORDER_CONSTANT)
        out[c] = bgr_to_i420(emitted[0], q)[None]
    return out
