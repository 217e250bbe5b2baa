"""Affine and projective warping with OpenCV border-mode semantics.

Counterpart of the port's part of ``video_stab_tpu/ops/warp.py``.
``warp_affine(img, M)`` computes dst(x, y) = src(M^{-1} [x, y, 1]) with
bilinear sampling, matching cv2.warpAffine without WARP_INVERSE_MAP;
``warp_perspective(img, H)`` is the same for a homography
(cv2.warpPerspective). ``warp_affine_fast`` / ``warp_perspective_fast`` are
the u8 hot-path dispatchers: the CUDA kernels K1 / K2 on a CUDA tensor,
their plain versions on a CPU tensor (``kernels/warp.py``).
"""

from __future__ import annotations

import math

import torch

BORDER_CONSTANT = 0
BORDER_REPLICATE = 1
BORDER_REFLECT = 2
BORDER_WRAP = 3
BORDER_REFLECT_101 = 4

_BORDER_NAMES = {"black": BORDER_CONSTANT, "constant": BORDER_CONSTANT,
                 "replicate": BORDER_REPLICATE, "reflect": BORDER_REFLECT,
                 "wrap": BORDER_WRAP, "reflect_101": BORDER_REFLECT_101,
                 "reflect101": BORDER_REFLECT_101,
                 "fade": BORDER_CONSTANT}   # fade: constant warp + history


def border_mode_from_name(name: str) -> int:
    """The reference's borderType strings (Stabilizer.cpp:31-38) as warp
    border codes; unknown names are constant."""
    return _BORDER_NAMES.get(name.lower(), BORDER_CONSTANT)


def _map_index(i: torch.Tensor, n: int, mode: int
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """In-range index for integer sample index i, plus the constant mode's
    validity (None for the other modes, where every tap is valid)."""
    if mode == BORDER_CONSTANT:
        return i.clamp(0, n - 1), (i >= 0) & (i <= n - 1)
    if mode == BORDER_REPLICATE:
        return i.clamp(0, n - 1), None
    if n == 1 and mode in (BORDER_REFLECT, BORDER_REFLECT_101):
        return torch.zeros_like(i), None
    if mode == BORDER_REFLECT:
        period = 2 * n
        j = torch.remainder(i, period)
        return torch.where(j >= n, period - 1 - j, j), None
    if mode == BORDER_REFLECT_101:
        period = 2 * (n - 1)
        j = torch.remainder(i, period)
        return torch.where(j >= n, period - j, j), None
    if mode == BORDER_WRAP:
        return torch.remainder(i, n), None
    raise ValueError(f"unknown border mode {mode}")


def sample_bilinear(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                    border_mode: int = BORDER_CONSTANT,
                    border_value: float = 0.0) -> torch.Tensor:
    """Bilinear sample img (H, W) or (H, W, C) at float32 coords (xs, ys):
    x-interpolation first, then y, each product and sum rounded to float32
    (the order K1 uses). Returns float32 samples of xs's shape (+ C)."""
    has_c = img.dim() == 3
    h, w = img.shape[:2]
    src = img.float()
    x0f = torch.floor(xs)
    y0f = torch.floor(ys)
    fx = xs - x0f
    fy = ys - y0f
    x0 = x0f.clamp(-1e9, 1e9).to(torch.int64)
    y0 = y0f.clamp(-1e9, 1e9).to(torch.int64)
    ym0, yv0 = _map_index(y0, h, border_mode)
    ym1, yv1 = _map_index(y0 + 1, h, border_mode)
    xm0, xv0 = _map_index(x0, w, border_mode)
    xm1, xv1 = _map_index(x0 + 1, w, border_mode)

    def tap(ym, yv, xm, xv):
        v = src[ym, xm]
        if yv is not None:
            ok = yv & xv
            if has_c:
                ok = ok[..., None]
            v = torch.where(ok, v, torch.full_like(v, border_value))
        return v

    v00 = tap(ym0, yv0, xm0, xv0)
    v01 = tap(ym0, yv0, xm1, xv1)
    v10 = tap(ym1, yv1, xm0, xv0)
    v11 = tap(ym1, yv1, xm1, xv1)
    if has_c:
        fx, fy = fx[..., None], fy[..., None]
    gx, gy = 1.0 - fx, 1.0 - fy
    top = v00 * gx + v01 * fx
    bot = v10 * gx + v11 * fx
    return top * gy + bot * fy


def invert_affine(m: torch.Tensor) -> torch.Tensor:
    """Invert (..., 2, 3) affine matrices (cv::invertAffineTransform), on
    m's device."""
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


def det3(h: torch.Tensor) -> torch.Tensor:
    """Determinants of (..., 3, 3) matrices, r0 . (r1 x r2), by torch ops
    on h's device (no LU, so no error check and no host read)."""
    return (h[..., 0, :] * torch.linalg.cross(h[..., 1, :], h[..., 2, :])
            ).sum(dim=-1)


def invert_homography(h: torch.Tensor) -> torch.Tensor:
    """Invert (..., 3, 3) matrices as adjugate / determinant, by torch ops
    on h's device. The result is the true inverse, not normalized by its
    [2, 2] entry (the JAX CPU path's ``jnp.linalg.inv``)."""
    r0, r1, r2 = h[..., 0, :], h[..., 1, :], h[..., 2, :]
    adj = torch.stack([torch.linalg.cross(r1, r2),
                       torch.linalg.cross(r2, r0),
                       torch.linalg.cross(r0, r1)], dim=-1)
    det = (r0 * adj[..., :, 0]).sum(dim=-1)
    return adj / det[..., None, None]


def affine_coords(minv: torch.Tensor, out_h: int, out_w: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Source coordinates (sx, sy), each (out_h, out_w) float32, of the
    inverse map: (a*x + b*y) + c, as K1 computes them."""
    dev = minv.device
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    sx = (minv[0, 0] * xs + minv[0, 1] * ys) + minv[0, 2]
    sy = (minv[1, 0] * xs + minv[1, 1] * ys) + minv[1, 2]
    return sx, sy


def perspective_coords(hinv: torch.Tensor, out_h: int, out_w: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Source coordinates (sx, sy), each (out_h, out_w) float32, of the
    (3, 3) inverse homography, as the JAX CPU path and K2 compute them:
    each row is (p*x + q*y) + r; the denominator is set to 1e-9 where its
    magnitude is below 1e-9; sx and sy are true divides."""
    dev = hinv.device
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    den = (hinv[2, 0] * xs + hinv[2, 1] * ys) + hinv[2, 2]
    den = torch.where(den.abs() < 1e-9, torch.full_like(den, 1e-9), den)
    sx = ((hinv[0, 0] * xs + hinv[0, 1] * ys) + hinv[0, 2]) / den
    sy = ((hinv[1, 0] * xs + hinv[1, 1] * ys) + hinv[1, 2]) / den
    return sx, sy


def warp_perspective(img: torch.Tensor, h_mat: torch.Tensor,
                     out_h: int | None = None, out_w: int | None = None,
                     border_mode: int = BORDER_CONSTANT,
                     border_value: float = 0.0,
                     inverse_map: bool = False) -> torch.Tensor:
    """cv2.warpPerspective: dst(x,y) = src(H^{-1}(x,y)), bilinear, float32
    out. h_mat: (3, 3) homography (dst <- src forward map unless
    inverse_map)."""
    out_h = out_h if out_h is not None else img.shape[0]
    out_w = out_w if out_w is not None else img.shape[1]
    h_mat = h_mat.to(torch.float32)
    hinv = h_mat if inverse_map else invert_homography(h_mat)
    sx, sy = perspective_coords(hinv, out_h, out_w)
    return sample_bilinear(img, sx, sy, border_mode, border_value)


def warp_affine(img: torch.Tensor, m: torch.Tensor,
                out_h: int | None = None, out_w: int | None = None,
                border_mode: int = BORDER_CONSTANT,
                border_value: float = 0.0,
                inverse_map: bool = False) -> torch.Tensor:
    """cv2.warpAffine: dst(x,y) = src(M^{-1}(x,y)), bilinear, float32 out.

    m: (2, 3) float affine (dst <- src forward map unless inverse_map)."""
    out_h = out_h if out_h is not None else img.shape[0]
    out_w = out_w if out_w is not None else img.shape[1]
    m = m.to(torch.float32)
    minv = m if inverse_map else invert_affine(m)
    sx, sy = affine_coords(minv, out_h, out_w)
    return sample_bilinear(img, sx, sy, border_mode, border_value)


def warp_affine_fast(img: torch.Tensor, m: torch.Tensor,
                     out_h: int | None = None, out_w: int | None = None,
                     border_mode: int = BORDER_CONSTANT,
                     border_value: float = 0.0,
                     max_angle_deg: float = 6.0,
                     max_shift: int = 128,
                     branch: str = "auto") -> torch.Tensor:
    """u8-domain warp for the hot per-frame paths, through K1.

    Float input is quantized to u8 first (round half to even, clip), as the
    JAX package's ``warp_affine_fast`` does; the result is u8 (the JAX
    version returns float32 holding the same integers).

    ``max_angle_deg``, ``max_shift`` and ``branch`` size the TPU kernel's
    static envelope and are accepted and ignored: K1 is exact for any
    affine map, where the JAX path clamps outside its envelope."""
    # Imported here: kernels.warp imports this module for its plain version.
    from video_stab_tpu_torch.kernels.warp import warp_affine_u8
    from video_stab_tpu_torch.ops.color import saturate_u8
    del max_angle_deg, max_shift, branch
    return warp_affine_u8(saturate_u8(img), m, out_h, out_w, border_mode,
                          border_value)


def warp_perspective_fast(img: torch.Tensor, h_mat: torch.Tensor,
                          out_h: int | None = None, out_w: int | None = None,
                          border_mode: int = BORDER_CONSTANT,
                          border_value: float = 0.0) -> torch.Tensor:
    """u8-domain projective warp of the homography emit (streaming and
    offline), through K2.

    Float input is quantized to u8 first and the result is u8, as in
    ``warp_affine_fast``. The JAX version's envelope arguments
    (``max_angle_deg``, ``max_shift``, ``branch``) have no counterpart: K2
    is exact for any homography."""
    from video_stab_tpu_torch.kernels.warp import warp_homography_u8
    from video_stab_tpu_torch.ops.color import saturate_u8
    return warp_homography_u8(saturate_u8(img), h_mat, out_h, out_w,
                              border_mode, border_value)


def rotation_matrix_2d(center_x: float, center_y: float,
                       angle_deg: torch.Tensor, scale: float = 1.0
                       ) -> torch.Tensor:
    """cv2.getRotationMatrix2D (positive angle rotates CCW in y-down image
    coords) for a float32 angle tensor; (2, 3) on the angle's device."""
    a = angle_deg.to(torch.float32) * (math.pi / 180.0)
    alpha = scale * torch.cos(a)
    beta = scale * torch.sin(a)
    tx = (1.0 - alpha) * center_x - beta * center_y
    ty = beta * center_x + (1.0 - alpha) * center_y
    return torch.stack([torch.stack([alpha, beta, tx]),
                        torch.stack([-beta, alpha, ty])])


def similarity_matrix(dx: torch.Tensor, dy: torch.Tensor, da: torch.Tensor,
                      scale: float = 1.0) -> torch.Tensor:
    """The stabilizer's rigid matrix [[cos da, -sin da, dx],
    [sin da, cos da, dy]]: (2, 3), or (..., 2, 3) for batched inputs."""
    c = torch.cos(da) * scale
    s = torch.sin(da) * scale
    return torch.stack([torch.stack([c, -s, dx.to(torch.float32)], dim=-1),
                        torch.stack([s, c, dy.to(torch.float32)], dim=-1)],
                       dim=-2)
