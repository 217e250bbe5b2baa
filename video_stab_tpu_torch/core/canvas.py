"""Virtual canvas stabilization — port of ``video_stab_tpu/core/canvas.py``
(the reference's applyVirtualCanvasStabilization, src/Stabilizer.cpp:
2066-2443).

The frame history is a RUNNING CANVAS larger than the frame (allocated at
the largest admissible scale, ``canvas_shape``). Each emitted frame is
warped into canvas space; covered pixels refresh the canvas, uncovered ones
keep their history, which decays so that a pixel not refreshed for about
``temporal_buffer_size`` frames stops counting. The output is the centre
crop at frame size, composited through a blurred coverage mask
(``edge_blend_radius``).

The content warp is K1 (``ops/warp.py:warp_affine_fast``), in the JAX
package's decomposition: the frame is warped into an intermediate of
(h + 2 margin, w + 2 margin) with the fractional part of the canvas offset
and placed at its integer part, so K1 sees the same float matrix the JAX
warp sees. The rest is plain PyTorch over the canvas: about fifteen
full-canvas passes a frame (2160x3840 float32 for a 1080p stream at the
defaults).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from video_stab_tpu_torch.motion.estimate import fma
from video_stab_tpu_torch.ops.filters import gaussian_blur
from video_stab_tpu_torch.ops.warp import (BORDER_CONSTANT, invert_affine,
                                           similarity_matrix,
                                           warp_affine_fast)

# A canvas pixel whose recency weight decayed below this no longer counts
# as history (the deque-eviction analog; see virtual_canvas_apply).
_HIST_EPS = 0.05


def coverage_analytic(m: torch.Tensor, src_h: int, src_w: int,
                      out_h: int, out_w: int) -> torch.Tensor:
    """Closed-form bilinear coverage of an affine warp: exactly
    ``warp_affine(ones((src_h, src_w)), m)`` with a constant-0 border.

    Warping all-ones separates: out(x, y) = fx(sx) * fy(sy), f the tent
    ramp of the in-bounds tap weight. The source coordinates are the JAX
    package's ``a * x + b * y + c`` as XLA compiles it on the CPU,
    fma(a, x, b * y) + c (``motion/estimate.py``), so the map is the same
    bit for bit."""
    minv = invert_affine(m)
    dev = m.device
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    sx = fma(minv[0, 0], xs, minv[0, 1] * ys) + minv[0, 2]
    sy = fma(minv[1, 0], xs, minv[1, 1] * ys) + minv[1, 2]
    fx = torch.clamp(torch.minimum(sx + 1.0, float(src_w) - sx), 0.0, 1.0)
    fy = torch.clamp(torch.minimum(sy + 1.0, float(src_h) - sy), 0.0, 1.0)
    return fx * fy


def canvas_shape(params, height: int, width: int) -> tuple[int, int]:
    """Static allocation size: with adaptive_canvas_size the allocation
    covers the LARGEST admissible scale (max_canvas_scale) and the chosen
    active scale masks a central window of it."""
    s = params.canvas_scale_factor
    if getattr(params, "adaptive_canvas_size", False):
        s = max(s, params.max_canvas_scale)
    return int(round(height * s)), int(round(width * s))


def adaptive_canvas_scale(params, trans_ring: torch.Tensor,
                          n_path: torch.Tensor,
                          prev_scale: torch.Tensor) -> torch.Tensor:
    """Active canvas scale (calculateOptimalCanvasSize, Stabilizer.cpp:
    2281-2306): the largest translation over the last <= 30 transforms
    mapped to csf + (max(1, maxMotion / 50) - 1) * 0.5, clamped to
    [min_canvas_scale, max_canvas_scale]. It FREEZES at the first canvas
    use (prev_scale > 0 keeps it), selected on the device."""
    dev = trans_ring.device
    if not getattr(params, "adaptive_canvas_size", False):
        return torch.full((), params.canvas_scale_factor,
                          dtype=torch.float32, device=dev)
    window = 30
    idx = torch.clamp(n_path - window, min=0) + torch.arange(window,
                                                             device=dev)
    valid = (idx <= n_path - 1).to(torch.float32)
    ring = trans_ring.shape[0]
    vals = trans_ring.index_select(
        0, torch.remainder(torch.clamp(idx, min=0), ring).to(torch.int64))
    mag = torch.sqrt(fma(vals[:, 0], vals[:, 0], vals[:, 1] * vals[:, 1])) \
        * valid
    factor = torch.clamp(mag.max() / 50.0, min=1.0)
    scale = params.canvas_scale_factor + (factor - 1.0) * 0.5
    scale = torch.clamp(scale, params.min_canvas_scale,
                        params.max_canvas_scale)
    return torch.where(prev_scale > 0.0, prev_scale, scale).to(torch.float32)


def canvas_init_value(params, height: int, width: int,
                      device: torch.device
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    hc, wc = canvas_shape(params, height, width)
    return (torch.zeros((hc, wc, 3), dtype=torch.float32, device=device),
            torch.zeros((hc, wc), dtype=torch.float32, device=device))


def virtual_canvas_apply(params, canvas: torch.Tensor, weight: torch.Tensor,
                         frame: torch.Tensor, correction: torch.Tensor,
                         active_scale: Optional[torch.Tensor] = None,
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One canvas update + composite.

    frame: (H, W, 3) u8 or float holding u8 values; correction: (3,)
    stabilizing (dx, dy, da). active_scale: the adaptive canvas scale
    (``adaptive_canvas_scale``); history outside the central (H * scale,
    W * scale) window is dropped. Returns (new_canvas, new_weight, out
    (H, W, 3) float32)."""
    h, w = frame.shape[:2]
    hc, wc = canvas.shape[:2]
    dev = canvas.device
    oy = (hc - h) / 2.0
    ox = (wc - w) / 2.0
    m = similarity_matrix(correction[0] + ox, correction[1] + oy,
                          correction[2])

    # The content warp: K1 into an intermediate sized by the JAX warp's
    # envelope margin, placed at the integer canvas offset.
    env_deg = float(getattr(params, "warp_envelope_deg", 6.0))
    margin = int(math.ceil(
        128.0 + math.sin(math.radians(env_deg)) * max(h, w))) + 4
    oy_i, ox_i = int(math.floor(oy)), int(math.floor(ox))
    fy, fx = oy - oy_i, ox - ox_i
    m_loc = similarity_matrix(correction[0] + fx + margin,
                              correction[1] + fy + margin, correction[2])
    wi_h, wi_w = h + 2 * margin, w + 2 * margin
    warped_loc = warp_affine_fast(frame, m_loc, out_h=wi_h, out_w=wi_w,
                                  border_mode=BORDER_CONSTANT)
    y0p, x0p = oy_i - margin, ox_i - margin
    ty, tx = max(0, -y0p), max(0, -x0p)
    ys0, xs0 = max(0, y0p), max(0, x0p)
    ah = min(hc - ys0, wi_h - ty)
    aw = min(wc - xs0, wi_w - tx)
    warped = torch.zeros((hc, wc, 3), dtype=torch.float32, device=dev)
    warped[ys0:ys0 + ah, xs0:xs0 + aw] = \
        warped_loc[ty:ty + ah, tx:tx + aw].to(torch.float32)
    coverage = coverage_analytic(m, h, w, hc, wc)

    # Canvas refresh: covered pixels adopt the new frame (blended with
    # history by canvas_blend_weight); empty pixels keep history. The
    # weight is a recency track decaying below _HIST_EPS after about
    # temporal_buffer_size frames without a refresh.
    bw = params.canvas_blend_weight
    tbs = max(1, int(getattr(params, "temporal_buffer_size", 30)))
    decay = _HIST_EPS ** (1.0 / tbs)
    has_hist = weight > _HIST_EPS
    cov3 = coverage[:, :, None]
    refreshed = torch.where(has_hist[:, :, None],
                            fma(1.0 - bw, canvas, bw * warped), warped)
    new_canvas = fma(cov3, refreshed, (1.0 - cov3) * canvas)
    new_weight = torch.maximum(weight * decay, coverage)

    if active_scale is not None:
        # History may not live outside the central (h * scale, w * scale)
        # window; pixel centres (+0.5) against the half-extents make the
        # mask a no-op at the allocation's own scale.
        ys = torch.arange(hc, dtype=torch.float32, device=dev)[:, None] + 0.5
        xs = torch.arange(wc, dtype=torch.float32, device=dev)[None, :] + 0.5
        half_h = active_scale * h / 2.0
        half_w = active_scale * w / 2.0
        act = ((ys - hc / 2.0).abs() <= half_h) \
            & ((xs - wc / 2.0).abs() <= half_w)
        new_weight = torch.where(act, new_weight, torch.zeros_like(new_weight))
        new_canvas = torch.where(act[:, :, None], new_canvas,
                                 torch.zeros_like(new_canvas))

    # Seamless composite for the output: the blurred coverage is the blend
    # alpha; where there is no history the frame shows as it is. Only the
    # output crop is composited (the JAX package composites the whole
    # canvas and crops: the same values).
    sigma = max(params.edge_blend_radius / 3.0, 0.5)
    y0 = int(round(oy))
    x0 = int(round(ox))
    alpha = torch.clamp(gaussian_blur(coverage, sigma), 0.0, 1.0)
    alpha = alpha[y0:y0 + h, x0:x0 + w]
    hist_valid = (weight[y0:y0 + h, x0:x0 + w] > _HIST_EPS).to(torch.float32)
    a = (alpha + (1.0 - alpha) * (1.0 - hist_valid))[:, :, None]
    out = fma(1.0 - a, canvas[y0:y0 + h, x0:x0 + w],
              a * warped[y0:y0 + h, x0:x0 + w])
    return new_canvas, new_weight, out
