"""Color conversions with OpenCV value conventions (u8 domain, BGR order).

Counterpart of ``video_stab_tpu/ops/color.py``. Float tensors carry
u8-scaled values ([0, 255]). Every three-term weighted sum (gray, the
color matrices, the I420 weights) is written out term by term, B, G, R in
that order, each product rounded to float32 — the same values on the CPU
and on the card, and no ``cbrt`` or matmul whose order depends on the
backend. The JAX package sums them as matmuls, so the two agree to float32
rounding.
"""

from __future__ import annotations

import torch

# OpenCV ITU-R BT.601 luma weights (B, G, R order).
_GRAY_W = (0.114, 0.587, 0.299)


def saturate_u8(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, clamp to [0, 255], uint8 — what ``jnp.round``
    (and so the JAX package's ``saturate_u8``) computes. No-op for u8."""
    if x.dtype == torch.uint8:
        return x
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def _dot3(x: torch.Tensor, w) -> torch.Tensor:
    """x[..., 0] * w0 + x[..., 1] * w1 + x[..., 2] * w2, left to right."""
    return (x[..., 0] * w[0] + x[..., 1] * w[1]) + x[..., 2] * w[2]


def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) BGR -> (..., H, W) gray, BT.601 weights like
    cv::COLOR_BGR2GRAY. Summed B, G, R in that order, each product rounded
    to float32 — the order the enhance kernel (csrc/enhance.cu) uses."""
    return _dot3(bgr, _GRAY_W)


def gray_to_bgr(gray: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H, W, 3) by channel replication
    (cv::COLOR_GRAY2BGR); a view."""
    return gray[..., None].expand(*gray.shape, 3)


def bgr_to_hsv(bgr: torch.Tensor) -> torch.Tensor:
    """cv::COLOR_BGR2HSV for u8-domain values: H in [0, 180), S, V in
    [0, 255]."""
    b, g, r = bgr[..., 0], bgr[..., 1], bgr[..., 2]
    v = torch.maximum(torch.maximum(b, g), r)
    mn = torch.minimum(torch.minimum(b, g), r)
    diff = v - mn
    one = torch.ones_like(v)
    safe = torch.where(diff > 0, diff, one)
    s = torch.where(v > 0, 255.0 * diff / torch.where(v > 0, v, one),
                    torch.zeros_like(v))
    h_r = (g - b) / safe
    h_g = 2.0 + (b - r) / safe
    h_b = 4.0 + (r - g) / safe
    h = torch.where(v == r, h_r, torch.where(v == g, h_g, h_b)) * 30.0
    h = torch.where(diff > 0, h, torch.zeros_like(h))
    h = torch.where(h < 0, h + 180.0, h)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_bgr(hsv: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`bgr_to_hsv` (u8-domain H in [0, 180))."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h60 = h / 30.0
    i = torch.floor(h60)
    f = h60 - i
    sn = s / 255.0
    p = v * (1.0 - sn)
    q = v * (1.0 - sn * f)
    t = v * (1.0 - sn * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*vals):
        # jnp.select over the sectors 0..5; an index outside them (NaN
        # input) gives 0 there.
        out = torch.zeros_like(v)
        for k in range(5, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    r = select(v, q, p, p, t, v)
    g = select(t, v, v, q, p, p)
    b = select(p, p, t, v, v, q)
    return torch.stack([b, g, r], dim=-1)


# BT.601 limited-range RGB -> YCbCr weights (B, G, R), /256, + offset: the
# colorspace the host encoder consumes (the JAX package's _Y_W, _U_W, _V_W).
_Y_W = (25.064, 129.057, 65.738)
_U_W = (112.439, -74.494, -37.945)
_V_W = (-18.285, -94.154, 112.439)


def _u8_half_up(x: torch.Tensor) -> torch.Tensor:
    """floor(x + 0.5), clipped, u8: the I420 rounding (half away from zero
    for the non-negative values here), not ``saturate_u8``'s half to even."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0).to(torch.uint8)


def bgr_to_i420(bgr_u8: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) u8 BGR -> (H * 3 / 2, W) u8 planar I420 (BT.601 limited
    range): the Y plane, then the (H/2, W/2) U plane packed two half-rows
    per row, then V. Chroma is the 2x2 box mean of the per-pixel Cb / Cr.

    Raises unless H % 4 == 0 and W % 2 == 0, as the JAX package does (a
    reference defect kept for parity: the chroma planes need only H % 2)."""
    h, w = bgr_u8.shape[0], bgr_u8.shape[1]
    if h % 4 or w % 2:
        raise ValueError(f"I420 needs H%4==0 and W%2==0, got {h}x{w}")
    f = bgr_u8.float()
    y = _dot3(f, _Y_W) * (1.0 / 256.0) + 16.0
    u = _dot3(f, _U_W) * (1.0 / 256.0) + 128.0
    v = _dot3(f, _V_W) * (1.0 / 256.0) + 128.0
    u = u.reshape(h // 2, 2, w // 2, 2).mean(dim=(1, 3))
    v = v.reshape(h // 2, 2, w // 2, 2).mean(dim=(1, 3))
    return torch.cat([_u8_half_up(y), _u8_half_up(u).reshape(h // 4, w),
                      _u8_half_up(v).reshape(h // 4, w)], dim=0)


def i420_to_bgr(i420_u8: torch.Tensor, height: int) -> torch.Tensor:
    """Inverse of :func:`bgr_to_i420` (nearest-neighbour chroma upsample),
    float32 (H, W, 3) clipped to [0, 255]."""
    h = height
    w = i420_u8.shape[1]
    y = i420_u8[:h].float() - 16.0
    u = i420_u8[h:h + h // 4].reshape(h // 2, w // 2).float()
    v = i420_u8[h + h // 4:].reshape(h // 2, w // 2).float()
    u = u.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1) - 128.0
    v = v.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1) - 128.0
    yl = y * (255.0 / 219.0)
    r = yl + 1.596027 * v
    g = (yl - 0.391762 * u) - 0.812968 * v
    b = yl + 2.017232 * u
    return torch.clamp(torch.stack([b, g, r], dim=-1), 0.0, 255.0)


# sRGB -> XYZ (D65): rows give X, Y, Z from (R, G, B); and back.
_RGB2XYZ = ((0.412453, 0.357580, 0.180423),
            (0.212671, 0.715160, 0.072169),
            (0.019334, 0.119193, 0.950227))
_XYZ2RGB = ((3.240479, -1.537150, -0.498535),
            (-0.969256, 1.875992, 0.041556),
            (0.055648, -0.204043, 1.057311))
_WHITE = (0.950456, 1.0, 1.088754)
_D = 6.0 / 29.0


def _srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.04045, c / 12.92,
                       torch.pow((c + 0.055) / 1.055, 2.4))


def _linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, min=0.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)


def _f_lab(t: torch.Tensor) -> torch.Tensor:
    # The cube root as pow(t, 1/3) on the positive branch (torch has no
    # cbrt): within an ulp or two of jnp.cbrt.
    pos = torch.clamp(t, min=_D ** 3)
    return torch.where(t > _D ** 3, torch.pow(pos, 1.0 / 3.0),
                       t / (3 * _D * _D) + 4.0 / 29.0)


def _f_lab_inv(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > _D, t * t * t, 3 * _D * _D * (t - 4.0 / 29.0))


def bgr_to_lab(bgr: torch.Tensor) -> torch.Tensor:
    """cv::COLOR_BGR2Lab (u8 scaling: L * 255 / 100, a and b offset by
    128)."""
    lin = _srgb_to_linear(bgr.flip(-1) / 255.0)           # R, G, B
    fx, fy, fz = (_f_lab(_dot3(lin, row) / wt)
                  for row, wt in zip(_RGB2XYZ, _WHITE))
    lum = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return torch.stack([lum * 255.0 / 100.0, a + 128.0, b + 128.0], dim=-1)


def lab_to_bgr(lab: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`bgr_to_lab` (u8 scaling), clipped to [0, 255]."""
    lum = lab[..., 0] * 100.0 / 255.0
    a = lab[..., 1] - 128.0
    b = lab[..., 2] - 128.0
    fy = (lum + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    xyz = torch.stack([_f_lab_inv(fx) * _WHITE[0],
                       _f_lab_inv(fy) * _WHITE[1],
                       _f_lab_inv(fz) * _WHITE[2]], dim=-1)
    rgb = torch.stack([_linear_to_srgb(_dot3(xyz, row))
                       for row in _XYZ2RGB], dim=-1)
    return torch.clamp(rgb.flip(-1) * 255.0, 0.0, 255.0)
