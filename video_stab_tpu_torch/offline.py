"""Offline (whole-clip) stabilization — PyTorch port of
``video_stab_tpu/offline.py``.

When the whole clip is available (file workflows, re-encode farms) the
clip lives on the device: motion analysis walks the frames in order (the
one true sequential dependency), the path is smoothed in one whole-path
filter (box: K5b, ``kernels/traj.py``; gaussian, kalman, butterworth or
the L1-optimal path of ``motion/l1path.py``), and every frame is warped once (K1 for
the similarity model, K2 for the homography model). At 1080p a 240-frame
clip is 240 x 1080 x 1920 x 3 bytes = 1.49 GB in and as much out.

API: ``stabilize_clip(frames, params)`` — (T, H, W, 3) uint8 in, the
stabilized (T, H', W', 3) uint8 clip out as numpy, with the streaming
Stabilizer's border and crop semantics; ``stabilize_clip_device`` returns
it as a tensor on the device. The device is explicit: ``device=``, or
``ModeParams.use_cuda`` through ``pick_device`` (no silent CPU fallback).

Ported: every smoother (box through K5b on a CUDA tensor and its plain
version on a CPU tensor; gaussian, l1, kalman and butterworth as tensor
ops on the clip's device), black borders with ``border_size`` and
``crop_n_zoom``, both motion models. The kalman and butterworth start
states are channel-generic, so the 9-channel log-homography path runs
through them too.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from video_stab_tpu_torch import pick_device
from video_stab_tpu_torch.core.params import ModeParams, StabilizerParams
from video_stab_tpu_torch.core.stabilizer import (
    _analysis_gray,
    to_full_resolution,
)
from video_stab_tpu_torch.kernels.traj import box_filter_centered
from video_stab_tpu_torch.kernels.warp import warp_affine_u8
from video_stab_tpu_torch.motion.estimate import (
    estimate_similarity_ransac,
    ransac_draws,
)
from video_stab_tpu_torch.motion.filters import (
    butterworth_cascade,
    gaussian_kernel,
    jitter_frequency_cutoff,
    kalman_init,
    kalman_step,
)
from video_stab_tpu_torch.motion.homography import (
    estimate_homography_ransac,
    log_homography,
    smooth_homography_path,
)
from video_stab_tpu_torch.motion.l1path import l1_smooth_path
from video_stab_tpu_torch.ops.color import saturate_u8
from video_stab_tpu_torch.ops.features import good_features_to_track
from video_stab_tpu_torch.ops.lk import lk_track
from video_stab_tpu_torch.ops.resize import resize_bilinear
from video_stab_tpu_torch.ops.warp import (
    BORDER_CONSTANT,
    invert_affine,
    similarity_matrix,
    warp_perspective_fast,
)

WARP_CHUNK = 8      # frames whose warp matrices are built together

# RANSAC draws for one analysis step given its valid-point count (the hook
# through which parity tests feed the JAX package's own draws), or None.
RansacDraws = Optional[Callable[[torch.Tensor], torch.Tensor]]


SMOOTHING_METHODS = ("box", "gaussian", "l1", "kalman", "butterworth")


def check_supported(params: StabilizerParams) -> None:
    """Raise NotImplementedError for a motion model or a smoothing method
    the package does not know."""
    if params.smoothing_method not in SMOOTHING_METHODS:
        raise NotImplementedError(
            f"offline smoothing_method={params.smoothing_method}")
    if params.motion_model not in ("similarity", "homography"):
        raise NotImplementedError(f"motion_model={params.motion_model}")


def _scan_motion(params: StabilizerParams, frames_u8: torch.Tensor,
                 estimate, out_shape: tuple) -> torch.Tensor:
    """The motion analysis over the clip: analysis gray + GFTT on frame 0,
    then per frame LK tracking, ``estimate(pts, curr_pts, valid)`` and the
    re-detect cadence of the JAX scan (every ``redetect_interval``-th step,
    counting from 1). Returns the stacked per-step outputs, (T-1,
    *out_shape)."""
    if frames_u8.shape[0] < 2:
        return torch.zeros((0, *out_shape), device=frames_u8.device)
    prev_gray = _analysis_gray(params, frames_u8[0].float())
    pts, mask = good_features_to_track(
        prev_gray, max_corners=params.max_corners,
        quality_level=params.quality_level,
        min_distance=params.min_distance, block_size=params.block_size)
    outs = []
    for i in range(1, frames_u8.shape[0]):
        gray = _analysis_gray(params, frames_u8[i].float())
        curr_pts, status, _ = lk_track(
            prev_gray, gray, pts, mask, win=params.lk_window,
            max_level=params.lk_levels, iters=params.lk_iters)
        valid = mask & status
        outs.append(estimate(pts, curr_pts, valid))
        if i % params.redetect_interval == 0:
            pts, mask = good_features_to_track(
                gray, max_corners=params.max_corners, quality_level=0.02,
                min_distance=15.0, block_size=3)
        else:
            pts, mask = curr_pts, valid
        prev_gray = gray
    return torch.stack(outs)


def _draw_source(params: StabilizerParams, device: torch.device,
                 draws: RansacDraws, width: int):
    """Per-step RANSAC draws: the injected hook, or the clip's generator
    seeded from ``params.seed`` (the JAX package's PRNGKey(seed) chain has
    no torch counterpart)."""
    if draws is not None:
        return draws
    g = torch.Generator(device=device)
    g.manual_seed(int(params.seed))
    return lambda n_valid: ransac_draws(g, params.ransac_hypotheses, n_valid,
                                        width=width)


def _analyze_clip(params: StabilizerParams, frames_u8: torch.Tensor,
                  draws: RansacDraws = None) -> torch.Tensor:
    """(T, H, W, 3) -> (T, 3) raw transforms (dx, dy, da), LAST entry zero:
    the forward-motion convention, transform[e] = motion e -> e+1."""
    source = _draw_source(params, frames_u8.device, draws, 2)

    def estimate(pts, curr_pts, valid):
        m, _ok, _inl = estimate_similarity_ransac(
            pts, curr_pts, valid, threshold=params.ransac_threshold,
            n_hypotheses=params.ransac_hypotheses,
            draws=source(valid.sum()))
        return torch.stack([m[0, 2], m[1, 2], torch.atan2(m[1, 0], m[0, 0])])

    raws = _scan_motion(params, frames_u8, estimate, (3,))
    return torch.cat([raws, raws.new_zeros((1, 3))])


def _analyze_clip_homography(params: StabilizerParams,
                             frames_u8: torch.Tensor,
                             draws: RansacDraws = None) -> torch.Tensor:
    """(T, H, W, 3) -> (T, 3, 3) forward log-homographies (last = 0); each
    step's H is conjugated from analysis to full resolution first."""
    source = _draw_source(params, frames_u8.device, draws, 4)

    def estimate(pts, curr_pts, valid):
        h_mat, _ok, _inl = estimate_homography_ransac(
            pts, curr_pts, valid, threshold=params.ransac_threshold,
            n_hypotheses=params.ransac_hypotheses,
            draws=source(valid.sum()))
        return log_homography(
            to_full_resolution(params, frames_u8.shape[1:], h_mat))

    logs = _scan_motion(params, frames_u8, estimate, (3, 3))
    return torch.cat([logs, logs.new_zeros((1, 3, 3))])


def _smooth_path(params: StabilizerParams, path: torch.Tensor
                 ) -> torch.Tensor:
    """Whole-path smoothing of a (T, C) path per ``smoothing_method``. Box:
    r = clip(smoothing_radius, 2, 50), through K5b (``box_filter_centered``)
    whatever ``params.use_pallas`` says. Kalman and butterworth walk the
    path in order (T steps of tensor ops on the path's device, no host
    read), from a start state of the path's own width C."""
    check_supported(params)
    method = params.smoothing_method
    n = path.shape[0]
    if method == "gaussian":
        k = gaussian_kernel(params.gaussian_sigma, path.device)
        offs = torch.arange(k.shape[0], device=path.device) - k.shape[0] // 2
        idx = torch.arange(n, device=path.device)[:, None] + offs[None, :]
        idx = torch.where(idx < 0, -idx, idx)
        idx = torch.where(idx > n - 1, 2 * n - 1 - idx, idx)
        vals = path[idx.clamp(0, n - 1)]                      # (T, K, C)
        return (vals * k[None, :, None]).sum(dim=1)
    if method == "l1":
        # The crop box: border_size px, or 20 px when borderless; 0.05 rad.
        b = float(params.border_size) if params.border_size > 0 else 20.0
        bound = torch.tensor([b, b, 0.05], dtype=path.dtype).to(path.device)
        if path.shape[1] != 3:
            raise ValueError("the l1 crop bound (px, px, rad) is defined "
                             f"for a 3-channel path, got {path.shape[1]}")
        return l1_smooth_path(path, bound)
    if method == "butterworth":
        cutoff = jitter_frequency_cutoff(params.jitter_frequency)
        st = path[0].expand(4, -1)
        outs = [path[0]]
        for t in range(1, n):
            st, out = butterworth_cascade(st, path[t], cutoff, 4)
            outs.append(out)
        return torch.stack(outs)
    if method == "kalman":
        st = kalman_init(path[0])
        outs = [path[0]]
        for t in range(1, n):
            st, out = kalman_step(st, path[t])
            outs.append(out)
        return torch.stack(outs)
    return box_filter_centered(path, max(2, min(params.smoothing_radius, 50)))


def _corrections(params: StabilizerParams, raws: torch.Tensor,
                 frame_shape) -> torch.Tensor:
    """(T, 3) applied similarity corrections: raw + (smoothed - path), the
    horizon lock, and the analysis -> full-res translation scale."""
    path = torch.cumsum(raws, dim=0)
    corr = raws + (_smooth_path(params, path) - path)
    if params.horizon_lock:
        corr = torch.cat([corr[:, :2], torch.zeros_like(corr[:, 2:])], dim=1)
    if params.full_res_corrections:
        sxo = frame_shape[1] / params.analysis_width
        syo = frame_shape[0] / params.analysis_height
        if sxo != 1.0 or syo != 1.0:
            corr = torch.stack([corr[:, 0] * sxo, corr[:, 1] * syo,
                                corr[:, 2]], dim=1)
    return corr


def _warp_similarity(params: StabilizerParams, frames_u8: torch.Tensor,
                     corr: torch.Tensor) -> torch.Tensor:
    """Warp every frame once with its correction (K1), with the constant
    border pad or the crop-and-zoom of ``border_size``."""
    t, h, w = frames_u8.shape[:3]
    b = params.border_pad
    pad = b > 0 and not params.crop_n_zoom
    oh, ow = (h + 2 * b, w + 2 * b) if pad else (h, w)
    out = torch.empty((t, oh, ow, 3), dtype=torch.uint8,
                      device=frames_u8.device)
    for start in range(0, t, WARP_CHUNK):
        end = min(start + WARP_CHUNK, t)
        c = corr[start:end]
        minv = invert_affine(similarity_matrix(c[:, 0], c[:, 1], c[:, 2]))
        minv = minv.reshape(-1, 6).contiguous()
        for i in range(start, end):
            f = frames_u8[i]
            if pad:
                f = torch.nn.functional.pad(f, (0, 0, b, b, b, b))
            res = warp_affine_u8(f, minv[i - start],
                                 border_mode=BORDER_CONSTANT,
                                 inverse_map=True)
            if params.crop_n_zoom and b > 0:
                res = saturate_u8(resize_bilinear(
                    res[b:h - b, b:w - b].float(), h, w))
            out[i] = res
    return out


def _warp_homography(frames_u8: torch.Tensor, corr_h: torch.Tensor
                     ) -> torch.Tensor:
    """Warp every frame once with its correcting homography (K2)."""
    out = torch.empty_like(frames_u8)
    for i in range(frames_u8.shape[0]):
        out[i] = warp_perspective_fast(frames_u8[i], corr_h[i],
                                       border_mode=BORDER_CONSTANT)
    return out


class _Stages:
    """Per-stage times in ms: CUDA events on a CUDA device (read once, at
    the end), the host clock after each stage on the CPU."""

    def __init__(self, device: torch.device, out: Optional[dict]):
        self.out = out
        self.cuda = device.type == "cuda"
        self.marks = []
        self.mark("start")

    def mark(self, name: str) -> None:
        if self.out is None:
            return
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def finish(self) -> None:
        if self.out is None:
            return
        if self.cuda:
            self.marks[-1][1].synchronize()
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            self.out[name] = a.elapsed_time(b) if self.cuda \
                else (b - a) * 1000.0


def stabilize_clip_device(frames,
                          params: StabilizerParams = StabilizerParams(), *,
                          device: Optional[torch.device] = None,
                          mode: Optional[ModeParams] = None,
                          ransac_draws: RansacDraws = None,
                          stage_ms: Optional[dict] = None) -> torch.Tensor:
    """Stabilize a whole (T, H, W, 3) uint8 BGR clip (numpy or tensor) on
    one device; returns the (T, H', W', 3) uint8 result there.

    ``device``: where to run; default ``pick_device(mode.use_cuda)``.
    ``ransac_draws``: optional per-step draws hook ((K, 2) similarity,
    (K, 4) homography), see ``Stabilizer``. ``stage_ms``: if a dict, it
    receives the ``analyze``, ``smooth`` and ``warp`` stage times in ms."""
    check_supported(params)
    dev = torch.device(device) if device is not None \
        else pick_device((mode or ModeParams()).use_cuda)
    if isinstance(frames, torch.Tensor):
        clip = frames.to(device=dev, dtype=torch.uint8).contiguous()
    else:
        clip = torch.from_numpy(
            np.ascontiguousarray(frames, dtype=np.uint8)).to(dev)
    stages = _Stages(dev, stage_ms)
    if params.motion_model == "homography":
        logs = _analyze_clip_homography(params, clip, ransac_draws)
        stages.mark("analyze")
        corr_h = smooth_homography_path(
            logs, lambda path: _smooth_path(params, path))
        stages.mark("smooth")
        out = _warp_homography(clip, corr_h)
    else:
        raws = _analyze_clip(params, clip, ransac_draws)
        stages.mark("analyze")
        corr = _corrections(params, raws, clip.shape[1:3])
        stages.mark("smooth")
        out = _warp_similarity(params, clip, corr)
    stages.mark("warp")
    stages.finish()
    return out


def stabilize_clip(frames, params: StabilizerParams = StabilizerParams(),
                   *, device: Optional[torch.device] = None,
                   mode: Optional[ModeParams] = None,
                   ransac_draws: RansacDraws = None) -> np.ndarray:
    """Batch-stabilize a whole clip: (T, H, W, 3) uint8 BGR in, the
    stabilized clip out as numpy (see ``stabilize_clip_device``)."""
    return stabilize_clip_device(frames, params, device=device, mode=mode,
                                 ransac_draws=ransac_draws).cpu().numpy()
