"""The streaming stabilizer — PyTorch port of
``video_stab_tpu/core/stabilizer.py``.

Per frame:
  analyze:  gray + resize -> [drone mode: CLAHE after > 2 starved frames]
            -> sparse pyramidal LK -> RANSAC similarity (or homography,
            conjugated to full resolution and mapped to sl(3)); with
            ``deep_stabilization`` the network (``models/deepstab.py``) on
            the [prev, curr] gray pair in place of LK and RANSAC -> [drone
            mode, similarity: the high-frequency chain] -> push transform
            and path rings -> re-detect features every
            ``redetect_interval``-th frame (GFTT, FAST, ORB or BRISK)
  emit:     smooth the path at the emit cursor (box, gaussian, kalman or
            butterworth) -> similarity: motion-intent correction scaling ->
            rigid matrix (composed with the fused chain's roll rotation) ->
            one warp of the queued frame (K1), or with
            ``enable_virtual_canvas`` the canvas update and composite
            (``core/canvas.py``); homography: exp of the sl(3) correction
            -> one projective warp (K2)

Every ``StabilizerParams`` the JAX package accepts runs here:
``check_supported`` raises only for unknown values.

Steps are plain functions over an explicit ``StabilizerState`` of device
tensors. The wrappers' steady state reads nothing back from the device:
readiness and the re-detect cadence come from host-side frame counters
that mirror the device's, and every index into a ring is a device tensor.
The homography model adds the reads of its ``eigh`` and ``matrix_exp``
(``motion/homography.py``), and every detector the convergence reads of
its greedy selection (``ops/features.py``).

``batched_*_fn`` are the same steps for N streams in lockstep, every
tensor of the state with a leading N (``parallel/multistream.py``, the
JAX package's vmapped serving step written out): each stage runs once a
tick for all N streams, with the warm-up gate per stream on the device and
one re-detect tick for the batch; upstream's drone mode (conditional CLAHE,
the HF chain, the ``motion_prediction`` prior, crop-and-zoom) runs there
too, each stream's decisions device-side selects.
``check_supported_batched`` names the parameters they do not take yet.
"""

from __future__ import annotations

import functools
import math
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np
import torch

from video_stab_tpu_torch import pick_device
from video_stab_tpu_torch.core.canvas import (adaptive_canvas_scale,
                                              virtual_canvas_apply)
from video_stab_tpu_torch.core.params import ModeParams, StabilizerParams
from video_stab_tpu_torch.core.state import (
    StabilizerState,
    state_from_numpy,
    state_to_numpy,
    stabilizer_state_init,
)
from video_stab_tpu_torch.kernels.warp import (warp_affine_u8,
                                               warp_affine_u8_batched,
                                               warp_homography_u8_batched)
from video_stab_tpu_torch.models.deepstab import (predict_transform,
                                                  resolve_deepstab_weights)
from video_stab_tpu_torch.motion.estimate import estimate_similarity_ransac
from video_stab_tpu_torch.motion.filters import (
    adaptive_radius,
    box_filter_emit,
    butterworth_cascade,
    gaussian_filter_emit,
    gaussian_kernel,
    jitter_frequency_cutoff,
    kalman_init,
    kalman_step,
    ring_get,
    ring_push,
)
from video_stab_tpu_torch.motion.hf import hf_apply
from video_stab_tpu_torch.motion.homography import (
    estimate_homography_ransac,
    exp_homography,
    log_homography,
)
from video_stab_tpu_torch.motion.intent import (
    analyze_motion_intent,
    intent_correction_scale,
)
from video_stab_tpu_torch.ops.color import bgr_to_gray, saturate_u8
from video_stab_tpu_torch.ops.fast import (brisk_corners, fast_corners,
                                           orb_corners)
from video_stab_tpu_torch.ops.features import good_features_to_track
from video_stab_tpu_torch.ops.filters import clahe
from video_stab_tpu_torch.ops.lk import global_translation_prior, lk_track
from video_stab_tpu_torch.ops.resize import resize_bilinear
from video_stab_tpu_torch.ops.warp import (
    BORDER_CONSTANT,
    rotation_matrix_2d,
    similarity_matrix,
    warp_perspective_fast,
)
from video_stab_tpu_torch.utils import hostcopy, telemetry

WARP_MAX_SHIFT = 128    # translation envelope (px) of the JAX emit warp
# Projective allowance |g|, |h| of the JAX projective warp's static envelope
# (video_stab_tpu/pallas/warp.py PROJ_BUDGET_DEFAULT).
PROJ_BUDGET_DEFAULT = 5e-6

# RANSAC draws for a step given its valid-point count, or None: (K, 2) for
# the similarity model, (K, 4) for the homography model.
RansacDraws = Optional[Callable[[torch.Tensor], torch.Tensor]]

SMOOTHING_METHODS = ("box", "gaussian", "kalman", "butterworth")
FEATURE_DETECTORS = ("gftt", "fast", "orb", "brisk")
_ALT_DETECTORS = {"fast": fast_corners, "orb": orb_corners,
                  "brisk": brisk_corners}


def check_supported(params: StabilizerParams) -> None:
    """Raise NotImplementedError for values the stabilizer does not know
    (every branch the JAX package runs is ported)."""
    todo = []
    if params.motion_model not in ("similarity", "homography"):
        todo.append(f"motion_model={params.motion_model} (unknown)")
    if params.smoothing_method not in SMOOTHING_METHODS:
        todo.append(f"smoothing_method={params.smoothing_method} (unknown; "
                    "l1 is offline only)")
    if params.feature_detector not in FEATURE_DETECTORS:
        todo.append(f"feature_detector={params.feature_detector} (unknown)")
    if todo:
        raise NotImplementedError(
            "not supported by video_stab_tpu_torch: " + "; ".join(todo))


def check_supported_batched(params: StabilizerParams) -> None:
    """Raise NotImplementedError, naming each field, for the parameters the
    batched multi-stream step does not take yet (ROADMAP queue 1 item
    11b); ``check_supported`` for the rest."""
    check_supported(params)
    todo = []
    if params.enable_virtual_canvas:
        todo.append("enable_virtual_canvas=True")
    # crop_n_zoom crops the unpadded warp: the border's size is the crop,
    # and its type is unused. Without it the output is padded.
    if not params.crop_n_zoom:
        if params.border_type == "fade":
            todo.append("border_type=fade")
        if params.border_pad > 0:
            todo.append(f"border_size={params.border_size} (a padded "
                        "output, without crop_n_zoom)")
    if params.feature_detector != "gftt":
        todo.append(f"feature_detector={params.feature_detector}")
    if params.aux_rotation_deg != 0.0:
        todo.append(f"aux_rotation_deg={params.aux_rotation_deg}")
    if todo:
        raise NotImplementedError(
            "not supported by the batched multi-stream step yet (ROADMAP "
            "queue 1 item 11b): " + "; ".join(todo))


def _analysis_gray(params: StabilizerParams, frame_f32: torch.Tensor
                   ) -> torch.Tensor:
    """Full-res BGR (or an already-gray plane) -> analysis-resolution gray;
    N streams' (N, H, W, 3) frames -> (N, Ha, Wa)."""
    gray = frame_f32 if frame_f32.dim() == 2 else bgr_to_gray(frame_f32)
    return resize_bilinear(gray, params.analysis_height,
                           params.analysis_width)


def _detect_features(params: StabilizerParams, gray: torch.Tensor,
                     roi: Optional[torch.Tensor] = None,
                     redetect: bool = False):
    """Feature detection dispatch (GFTT | FAST | ORB | BRISK). GFTT's
    re-detection uses the reference's fast parameters (quality 0.02, min
    distance 15); the other detectors keep their own thresholds and ignore
    ``roi`` and ``redetect``."""
    with telemetry.trace("vstab.detect"):
        alt = _ALT_DETECTORS.get(params.feature_detector)
        if alt is not None:
            return alt(gray, float(params.fast_threshold),
                       max_corners=params.max_corners)
        if redetect:
            return good_features_to_track(
                gray, max_corners=params.max_corners, quality_level=0.02,
                min_distance=15.0, block_size=3)
        return good_features_to_track(
            gray, max_corners=params.max_corners,
            quality_level=params.quality_level,
            min_distance=params.min_distance, block_size=params.block_size,
            roi=roi)


def _roi(params: StabilizerParams, frame_shape, device) -> Optional[torch.Tensor]:
    if not params.use_roi:
        return None
    if params.roi[2] > 0 and params.roi[3] > 0:
        sx = params.analysis_width / frame_shape[1]
        sy = params.analysis_height / frame_shape[0]
        vals = [int(params.roi[0] * sx), int(params.roi[1] * sy),
                int(params.roi[2] * sx), int(params.roi[3] * sy)]
    else:
        wa, ha = params.analysis_width, params.analysis_height
        vals = [wa // 5, ha // 5, wa * 3 // 5, ha * 3 // 5]
    return torch.tensor(vals, dtype=torch.int32).to(device)


def _queue_frame(state: StabilizerState, frame_u8: torch.Tensor,
                 aux_roll) -> dict:
    """The queue fields after pushing frame (and its roll angle). The frame
    ring, the state's one large buffer, is written IN PLACE (the JAX
    package donates it to the same effect). N streams' (N, H, W, 3)
    frames go to their (N, Q, H, W, 3) ring, each at its own slot, in one
    copy."""
    ring = state.frame_ring
    q = ring.shape[-4]
    slot = torch.remainder(state.n_frames, q).to(torch.int64).reshape(-1)
    aux_ring = state.aux_roll_ring
    if aux_roll is not None:
        aux = torch.as_tensor(aux_roll, dtype=torch.float32,
                              device=aux_ring.device).reshape(1)
        aux_ring = aux_ring.index_copy(0, slot, aux)
    if ring.dim() == 5:
        slot = slot + torch.arange(ring.shape[0], device=ring.device) * q
    ring.view(-1, *ring.shape[-3:]).index_copy_(
        0, slot, frame_u8.reshape(-1, *ring.shape[-3:]))
    return dict(frame_ring=ring, n_frames=state.n_frames + 1,
                aux_roll_ring=aux_ring)


def stabilizer_init_step_fn(params: StabilizerParams, state: StabilizerState,
                            frame_u8: torch.Tensor, aux_roll=None,
                            analysis_gray: Optional[torch.Tensor] = None
                            ) -> StabilizerState:
    """First frame: analysis gray + initial GFTT detection + queue the frame.

    ``aux_roll`` / ``analysis_gray``: the fused chain's roll path — a
    pre-rotated analysis gray and the roll angle (degrees) queued beside the
    UNROTATED frame; the rotation is composed into the emit warp."""
    check_supported(params)
    gray = _analysis_gray(params, frame_u8.float()) if analysis_gray is None \
        else analysis_gray
    pts, mask = _detect_features(
        params, gray, roi=_roi(params, frame_u8.shape, frame_u8.device))
    return state._replace(prev_gray=gray, prev_pts=pts, prev_mask=mask,
                          **_queue_frame(state, frame_u8, aux_roll))


def to_full_resolution(params: StabilizerParams, frame_shape,
                       h_mat: torch.Tensor) -> torch.Tensor:
    """S H S^-1 with S = diag(sx, sy, 1), analysis -> full resolution.

    Written elementwise, (s_i * h_ij) * (1 / s_j) with each scale rounded
    to float32: the same values as the JAX package's two matmuls with the
    diagonal matrices (their other terms are exact zeros), and no
    host-to-device copy of S."""
    sxf = frame_shape[1] / params.analysis_width
    syf = frame_shape[0] / params.analysis_height
    rows = torch.stack([h_mat[..., 0, :] * sxf, h_mat[..., 1, :] * syf,
                        h_mat[..., 2, :]], dim=-2)
    return torch.stack([rows[..., 0] * (1.0 / sxf),
                        rows[..., 1] * (1.0 / syf), rows[..., 2]], dim=-1)


def _n_streams(t: torch.Tensor, one: int) -> int:
    """Streams of a tensor whose one-stream shape has ``one`` dims: 1, or
    N for N streams' (N, ...)."""
    return t.shape[0] if t.dim() > one else 1


def _lk_init_pts(params: StabilizerParams, state: StabilizerState,
                 gray: torch.Tensor) -> Optional[torch.Tensor]:
    """``motion_prediction``'s LK seed for the similarity model (the JAX
    package's homography branch tracks without it): the previous points
    shifted by the global translation between the two grays, measured at
    analysis / 2**lk_levels and scaled back; None without the prior. N
    streams' grays give each stream its own shift."""
    if not params.motion_prediction or params.motion_model == "homography":
        return None
    with telemetry.trace("vstab.prior"):
        telemetry.count("prior_steps", _n_streams(gray, 2))
        sc = 2 ** params.lk_levels
        hs, ws = params.analysis_height // sc, params.analysis_width // sc
        g = global_translation_prior(
            resize_bilinear(state.prev_gray, hs, ws),
            resize_bilinear(gray, hs, ws)) * sc
        return state.prev_pts + g[..., None, :]


def _conditional_clahe(params: StabilizerParams, state: StabilizerState,
                       gray: torch.Tensor) -> torch.Tensor:
    """Drone mode's conditional CLAHE: the analysis gray is enhanced after
    > 2 consecutive starved frames. The counter lives on the device, so
    CLAHE runs every frame and a select keeps or drops it, per stream for
    N streams: no host read, at the cost of its ~40 small launches."""
    if not (params.drone_high_freq_mode and params.enable_conditional_clahe):
        return gray
    with telemetry.trace("vstab.clahe"):
        telemetry.count("clahe_runs", _n_streams(gray, 2))
        starved = (state.starvation_counter > 2)[..., None, None]
        return torch.where(starved, clahe(gray, clip_limit=2.0, tile_grid=8),
                           gray)


def _hf_step(params: StabilizerParams, state: StabilizerState,
             raw: torch.Tensor):
    """Drone mode's high-frequency vibration chain on the raw transform(s)
    (a similarity-space heuristic, skipped by the homography model): (hf
    state, transform), each stream's state its own for N streams."""
    if not params.drone_high_freq_mode or params.motion_model == "homography":
        return state.hf, raw
    with telemetry.trace("vstab.hf"):
        telemetry.count("hf_steps", _n_streams(raw, 1))
        return hf_apply(
            state.hf, raw,
            dead_zone_threshold=params.hf_dead_zone_threshold,
            freeze_duration=params.hf_freeze_duration,
            accumulator_decay=params.hf_motion_accumulator_decay,
            shake_px=params.hf_shake_px,
            rot_lp_alpha=params.hf_rot_lp_alpha,
            horizon_lock=params.horizon_lock)


def stabilizer_analyze_step_fn(params: StabilizerParams,
                               state: StabilizerState,
                               frame_u8: torch.Tensor, aux_roll=None,
                               analysis_gray: Optional[torch.Tensor] = None,
                               redetect_tick: Optional[int] = None,
                               ransac_draws: RansacDraws = None,
                               ) -> tuple[StabilizerState, dict]:
    """Per-frame motion analysis (generateTransform).

    ``redetect_tick``: the host's count of this stream's analyze steps
    including this one (the JAX step's post-push ``n_path``); features are
    re-detected when it is a multiple of ``redetect_interval``. None reads
    ``n_path`` from the device (one host sync). ``ransac_draws``: see
    ``Stabilizer``."""
    check_supported(params)
    gray = _analysis_gray(params, frame_u8.float()) if analysis_gray is None \
        else analysis_gray
    gray = _conditional_clahe(params, state, gray)
    raw, curr_pts, valid, inliers, est_ok = _estimate_motion(
        params, state, gray, frame_u8.shape[-3:], ransac_draws)
    hf, raw = _hf_step(params, state, raw)
    tick = None if redetect_tick is None else int(redetect_tick)
    return _finish_analyze(params, state._replace(hf=hf), frame_u8, gray,
                           raw, curr_pts, valid, inliers, est_ok, tick,
                           aux_roll)


def _estimate_motion(params: StabilizerParams, state: StabilizerState,
                     gray: torch.Tensor, frame_shape,
                     ransac_draws: RansacDraws):
    """The frame-to-frame motion from the previous analysis gray to
    ``gray``: (raw transform (C,), curr_pts, valid, inliers, estimate_ok),
    by LK (seeded by ``motion_prediction``'s prior) + RANSAC, or with
    ``deep_stabilization`` (similarity) the network, which carries the
    points, marks no inlier and draws nothing. For N streams every input
    and result has a leading N."""
    if params.deep_stabilization and params.motion_model != "homography":
        raw = predict_transform(state.deepstab, state.prev_gray, gray)
        inliers = torch.zeros_like(state.prev_mask)
        est_ok = torch.ones(state.prev_mask.shape[:-1], dtype=torch.bool,
                            device=gray.device)
        return raw, state.prev_pts, state.prev_mask, inliers, est_ok
    with telemetry.trace("vstab.lk"):
        curr_pts, status, _err = lk_track(
            state.prev_gray, gray, state.prev_pts, state.prev_mask,
            win=params.lk_window, max_level=params.lk_levels,
            iters=params.lk_iters,
            init_pts=_lk_init_pts(params, state, gray))
    valid = state.prev_mask & status
    with telemetry.trace("vstab.ransac"):
        draws = None if ransac_draws is None else \
            ransac_draws(valid.sum(dim=-1))
        if params.motion_model == "homography":
            h_mat, est_ok, inliers = estimate_homography_ransac(
                state.prev_pts, curr_pts, valid, generator=state.key,
                threshold=params.ransac_threshold,
                n_hypotheses=params.ransac_hypotheses, draws=draws)
            raw = log_homography(
                to_full_resolution(params, frame_shape, h_mat)).flatten(-2)
        else:
            m, est_ok, inliers = estimate_similarity_ransac(
                state.prev_pts, curr_pts, valid, generator=state.key,
                threshold=params.ransac_threshold,
                n_hypotheses=params.ransac_hypotheses, draws=draws)
            raw = torch.stack([m[..., 0, 2], m[..., 1, 2],
                               torch.atan2(m[..., 1, 0], m[..., 0, 0])],
                              dim=-1)
    return raw, curr_pts, valid, inliers, est_ok


def _finish_analyze(params: StabilizerParams, state: StabilizerState,
                    frame_u8: torch.Tensor, gray: torch.Tensor,
                    raw: torch.Tensor, curr_pts: torch.Tensor,
                    valid: torch.Tensor, inliers: torch.Tensor,
                    est_ok: torch.Tensor, tick: Optional[int], aux_roll
                    ) -> tuple[StabilizerState, dict]:
    """The analyze step after the estimate: push the raw transform and the
    cumulative path into the rings, count starvation, re-detect features
    when ``tick`` (None: ``n_path`` read on the host) is a multiple of
    ``redetect_interval``, queue the frame; and the step's metrics. For N
    streams every tensor has a leading N and ``tick`` is the batch's."""
    n = state.n_path
    started = (n > 0)[..., None]
    prev_path = torch.where(started, ring_get(state.path_ring, n - 1),
                            torch.zeros_like(raw))
    new_path = torch.where(started, prev_path + raw, raw)
    trans_ring = ring_push(state.trans_ring, n, raw)
    path_ring = ring_push(state.path_ring, n, new_path)
    n = n + 1

    n_tracked = valid.to(torch.int32).sum(dim=-1)
    starvation = torch.where(n_tracked < 40, state.starvation_counter + 1,
                             torch.zeros_like(state.starvation_counter))

    if tick is None:
        tick = int(n)
    if tick % params.redetect_interval == 0:
        prev_pts, prev_mask = _detect_features(params, gray, redetect=True)
    else:
        prev_pts, prev_mask = curr_pts, valid

    new_state = state._replace(
        prev_gray=gray, prev_pts=prev_pts, prev_mask=prev_mask,
        trans_ring=trans_ring, path_ring=path_ring, n_path=n,
        starvation_counter=starvation,
        **_queue_frame(state, frame_u8, aux_roll))
    metrics = {
        "n_tracked": n_tracked,
        "n_inliers": inliers.to(torch.int32).sum(dim=-1),
        "estimate_ok": est_ok,
        "transform": raw,
    }
    return new_state, metrics


def smoothing_radius_band(params: StabilizerParams) -> tuple[int, int]:
    """Static [r_lo, r_max] clamp band of the box filter's adaptive radius
    (the JAX package's ``smoothing_radius_band``)."""
    if params.adaptive_smoothing:
        r_lo = max(1, min(int(params.min_smoothing_radius), 45))
        r_max = max(r_lo, min(int(params.max_smoothing_radius), 45))
        if params.drone_high_freq_mode:
            r_lo = max(r_lo, 10)
            r_max = max(r_max, r_lo)
        return r_lo, r_max
    if params.drone_high_freq_mode:
        return 10, 45
    return 2, 8


def _smoothed_at_emit(params: StabilizerParams, state: StabilizerState,
                      e: torch.Tensor) -> tuple[StabilizerState, torch.Tensor]:
    """The smoothed path value at emit index e, per ``smoothing_method``.
    The kalman and butterworth cursors advance one step per emitted frame
    (their value at e depends only on path[0..e]); at e == 0 they start
    from the first sample, selected on the device."""
    method = params.smoothing_method
    if method == "gaussian":
        kernel = gaussian_kernel(params.gaussian_sigma,
                                 state.path_ring.device)
        return state, gaussian_filter_emit(state.path_ring, state.n_path, e,
                                           kernel)
    # (N streams: e (N,); ``first`` broadcast over each state's trailing
    # axes.)
    if method == "butterworth":
        cutoff = jitter_frequency_cutoff(params.jitter_frequency)
        z = ring_get(state.path_ring, e)
        first = (e == 0)[..., None]
        bst, sm = butterworth_cascade(state.butter_state, z, cutoff, 4)
        bst = torch.where(first[..., None], z[..., None, :].expand_as(bst),
                          bst)
        return state._replace(butter_state=bst), torch.where(first, z, sm)
    if method == "kalman":
        z = ring_get(state.path_ring, e)
        first = (e == 0)[..., None]
        st, sm = kalman_step({"x": state.kalman_x, "p": state.kalman_p}, z)
        st0 = kalman_init(z)
        return state._replace(
            kalman_x=torch.where(first[..., None], st0["x"], st["x"]),
            kalman_p=torch.where(first[..., None, None], st0["p"],
                                 st["p"])), \
            torch.where(first, z, sm)
    # Box filter with the adaptive radius, re-clamped to the mode's band.
    ar = adaptive_radius(state.path_ring, state.n_path,
                         params.smoothing_radius)
    r_lo, r_max = smoothing_radius_band(params)
    r = torch.clamp(ar, r_lo, r_max)
    return state, box_filter_emit(state.path_ring, state.n_path, e, r, r_max)


def stabilizer_emit_step_fn(params: StabilizerParams, state: StabilizerState
                            ) -> tuple[StabilizerState, torch.Tensor]:
    """Emit the oldest queued frame, stabilized (applyNextSmoothTransform)."""
    with telemetry.trace("vstab.emit"):
        check_supported(params)
        dev = state.trans_ring.device
        state, e, has_transform, raw, diff = _emit_inputs(params, state)

        q = state.frame_ring.shape[0]
        slot = torch.remainder(e, q).to(torch.int64).reshape(1)
        frame_u8 = state.frame_ring.index_select(0, slot)[0]
        if params.motion_model == "homography":
            return _emit_homography(
                params, state, frame_u8, has_transform,
                torch.where(has_transform, raw + diff, torch.zeros_like(raw)))

        h, w = frame_u8.shape[0], frame_u8.shape[1]
        dx, dy, da, exceeded = _similarity_correction(
            params, state, e, has_transform, raw, diff, (h, w))
        t_mat = similarity_matrix(dx, dy, da)
        m_use = t_mat
        if params.aux_rotation_deg > 0.0:
            # Fused-chain roll: compose correction o roll-rotation about the
            # frame center into ONE resample.
            aux_alpha = state.aux_roll_ring.index_select(0, slot)[0]
            exceeded = exceeded | (
                has_transform & (aux_alpha.abs() > params.aux_rotation_deg))
            r_mat = rotation_matrix_2d(w / 2.0, h / 2.0, aux_alpha)
            row3 = torch.zeros((1, 3), dtype=torch.float32, device=dev)
            row3[0, 2] = 1.0
            m_use = (torch.cat([t_mat, row3]) @ torch.cat([r_mat, row3]))[:2]

        def warp(img):
            return warp_affine_u8(img, m_use, border_mode=BORDER_CONSTANT)

        if params.enable_virtual_canvas and not params.crop_n_zoom:
            # The virtual canvas replaces the plain warp's output: it runs on
            # the RAW queued frame with the applied transform (the reference's
            # currentTransform, Stabilizer.cpp:1130-1134). The fade border's
            # history still advances with the bordered warp.
            if params.border_type == "fade" and params.border_pad > 0:
                state, _ = _warp_bordered(params, state, frame_u8, warp)
            state, out_u8 = _emit_canvas(params, state, frame_u8,
                                         torch.stack([dx, dy, da]))
        else:
            state, out_u8 = _warp_bordered(params, state, frame_u8, warp)
        new_state = state._replace(
            emit_idx=e + 1,
            envelope_exceeded=state.envelope_exceeded
            + exceeded.to(torch.int32))
        return new_state, out_u8


def _emit_inputs(params: StabilizerParams, state: StabilizerState):
    """At the emit cursor e: (state with the smoother advanced, e,
    has_transform, the raw transform (zero without one), smoothed path
    minus path). For N streams each has a leading N."""
    e = state.emit_idx
    has_transform = e < state.n_path
    raw = ring_get(state.trans_ring, e)
    raw = torch.where(has_transform[..., None], raw, torch.zeros_like(raw))
    e_path = torch.minimum(e, state.n_path - 1)
    path_e = ring_get(state.path_ring, e_path)
    state, smoothed = _smoothed_at_emit(params, state, e_path)
    return state, e, has_transform, raw, smoothed - path_e


def _similarity_correction(params: StabilizerParams, state: StabilizerState,
                           e: torch.Tensor, has_transform: torch.Tensor,
                           raw: torch.Tensor, diff: torch.Tensor, frame_hw
                           ) -> tuple[torch.Tensor, ...]:
    """The similarity emit's correction (dx, dy, da): the smoothing diff
    scaled by the motion intent, added to the raw transform, with
    ``horizon_lock`` and ``full_res_corrections``; and whether it leaves
    the JAX warp's static envelope. For N streams each has a leading N."""
    intent = analyze_motion_intent(state.trans_ring, state.n_path, raw, e)
    diff = diff * intent_correction_scale(intent, raw, e)[..., None]
    t_smooth = torch.where(has_transform[..., None], raw + diff,
                           torch.zeros_like(raw))
    dx, dy = t_smooth[..., 0], t_smooth[..., 1]
    da = torch.zeros_like(t_smooth[..., 2]) if params.horizon_lock \
        else t_smooth[..., 2]
    if params.full_res_corrections:
        sxf = frame_hw[1] / params.analysis_width
        syf = frame_hw[0] / params.analysis_height
        if sxf != 1.0 or syf != 1.0:
            dx = dx * float(np.float32(sxf))
            dy = dy * float(np.float32(syf))
    # Envelope observability: the JAX warp clamps (degrades) outside its
    # static envelope; the count stays comparable although K1 is exact.
    env_rad = math.radians(params.warp_envelope_deg)
    exceeded = has_transform & (
        (da.abs() > env_rad)
        | (torch.maximum(dx.abs(), dy.abs()) > WARP_MAX_SHIFT))
    return dx, dy, da, exceeded


def _homography_exceeded(params: StabilizerParams, h_corr: torch.Tensor,
                         has_transform: torch.Tensor) -> torch.Tensor:
    """Whether a (..., 3, 3) correction leaves the JAX projective warp's
    static envelope (rotation / shear slope, shift, projective budget),
    outside which that warp clamps; the count stays comparable although K2
    is exact."""
    s_env = abs(math.sin(math.radians(params.warp_envelope_deg)))
    return has_transform & (
        (torch.maximum(h_corr[..., 0, 2].abs(), h_corr[..., 1, 2].abs())
         > WARP_MAX_SHIFT)
        | (h_corr[..., 0, 1].abs() > s_env) | (h_corr[..., 1, 0].abs() > s_env)
        | (h_corr[..., 2, 0].abs() > PROJ_BUDGET_DEFAULT)
        | (h_corr[..., 2, 1].abs() > PROJ_BUDGET_DEFAULT))


def _emit_canvas(params: StabilizerParams, state: StabilizerState,
                 frame_u8: torch.Tensor, t_smooth: torch.Tensor
                 ) -> tuple[StabilizerState, torch.Tensor]:
    """The virtual canvas emit (``core/canvas.py``). With
    adaptive_canvas_size the active scale is decided from recent motion at
    the first canvas use and frozen afterwards, on the device; otherwise
    the allocation is the active window (no mask)."""
    if params.adaptive_canvas_size:
        scale = adaptive_canvas_scale(params, state.trans_ring, state.n_path,
                                      state.canvas_scale)
        active = scale
    else:
        scale = torch.full((), params.canvas_scale_factor,
                           dtype=torch.float32, device=frame_u8.device)
        active = None
    canvas, weight, out = virtual_canvas_apply(
        params, state.canvas, state.canvas_weight, frame_u8, t_smooth,
        active_scale=active)
    return state._replace(canvas=canvas, canvas_weight=weight,
                          canvas_scale=scale), saturate_u8(out)


def _emit_homography(params: StabilizerParams, state: StabilizerState,
                     frame_u8: torch.Tensor, has_transform: torch.Tensor,
                     t_smooth: torch.Tensor
                     ) -> tuple[StabilizerState, torch.Tensor]:
    """The homography emit: sl(3) correction -> SL(3) -> one projective warp
    (K2). Motion-intent scaling is a similarity-space heuristic and is
    skipped, as in the JAX package."""
    h_corr = exp_homography(t_smooth.reshape(3, 3))
    exceeded = _homography_exceeded(params, h_corr, has_transform)
    state, out_u8 = _warp_bordered(
        params, state, frame_u8,
        lambda img: warp_perspective_fast(img, h_corr,
                                          border_mode=BORDER_CONSTANT))
    new_state = state._replace(
        emit_idx=state.emit_idx + 1,
        envelope_exceeded=state.envelope_exceeded + exceeded.to(torch.int32))
    return new_state, out_u8


# border_type -> numpy pad mode of the pad's index tables (jnp.pad's modes
# in the JAX package); "black", "fade" and unknown types pad with zeros.
_PAD_MODES = {"replicate": "edge", "reflect": "symmetric",
              "reflect_101": "reflect", "reflect101": "reflect",
              "wrap": "wrap"}


@functools.lru_cache(maxsize=32)
def _pad_index(n: int, b: int, mode: str, device: torch.device
               ) -> torch.Tensor:
    """Source index of each of the n + 2b padded positions (numpy's pad of
    an arange), on ``device`` once."""
    idx = np.pad(np.arange(n), (b, b), mode=mode)
    return torch.from_numpy(idx.astype(np.int64)).to(device)


def pad_frame(frame: torch.Tensor, b: int, border_type: str
              ) -> torch.Tensor:
    """copyMakeBorder of an (H, W, C) frame by b on every side with the
    stabilizer's ``border_type``. The non-constant modes gather rows and
    columns by index (numpy's ``symmetric``, OpenCV's BORDER_REFLECT, has
    no ``F.pad`` mode)."""
    mode = _PAD_MODES.get(border_type)
    h, w = frame.shape[:2]
    if mode is None:
        out = frame.new_zeros((h + 2 * b, w + 2 * b) + tuple(frame.shape[2:]))
        out[b:b + h, b:b + w] = frame
        return out
    rows = _pad_index(h, b, mode, frame.device)
    cols = _pad_index(w, b, mode, frame.device)
    return frame.index_select(0, rows).index_select(1, cols)


def _crop_zoom(params: StabilizerParams, warped: torch.Tensor
               ) -> torch.Tensor:
    """crop_n_zoom with ``border_size`` b > 0: b px cut off every side of
    the warped (..., H, W, 3) u8 frame(s) and the rest resized bilinearly
    back to (H, W), N streams' frames in one resample; otherwise
    ``warped`` as it is."""
    b = params.border_pad
    if not params.crop_n_zoom or b == 0:
        return warped
    h, w = warped.shape[-3:-1]
    with telemetry.trace("vstab.crop_zoom"):
        telemetry.count("crop_zoom_resamples", _n_streams(warped, 3))
        return saturate_u8(resize_bilinear(
            warped[..., b:h - b, b:w - b, :], h, w))


def _warp_bordered(params: StabilizerParams, state: StabilizerState,
                   frame_u8: torch.Tensor,
                   warp: Callable[[torch.Tensor], torch.Tensor]
                   ) -> tuple[StabilizerState, torch.Tensor]:
    """The emit warp with ``border_size`` b (Stabilizer.cpp:914-1124), for
    either model: ``warp`` is its u8 -> u8 warp (K1 or K2).

    b == 0: the warp alone. crop_n_zoom: warp the unpadded frame, crop b
    off every side and resize back to (h, w). Otherwise pad by b with
    ``border_type`` and warp the padded frame: the output is (h + 2b,
    w + 2b). The fade border blends the padded frame's border with the
    history in float before the warp (quantized to u8 for it, as the JAX
    package's warp quantizes its input), then updates the history at rate
    0.1 in the border from the warped frame."""
    b = params.border_pad
    if b == 0 or params.crop_n_zoom:
        return state, _crop_zoom(params, warp(frame_u8))
    h, w = frame_u8.shape[:2]
    if params.border_type != "fade":
        return state, warp(pad_frame(frame_u8, b, params.border_type))
    dev = frame_u8.device
    padded = pad_frame(frame_u8.float(), b, "black")
    inside = torch.zeros(padded.shape[:2], dtype=torch.bool, device=dev)
    inside[b:b + h, b:b + w] = True
    border = ~inside[:, :, None]
    count = state.fade_count
    history = torch.where(count == 0, padded, state.fade_history)
    # A device divisor keeps the division true on CUDA (a CPU scalar one
    # becomes a multiply by its reciprocal there).
    duration = torch.full((), float(params.fade_duration), device=dev)
    alpha = torch.where(count < params.fade_duration,
                        params.fade_alpha * count.to(torch.float32)
                        / duration,
                        torch.full((), params.fade_alpha, device=dev))
    blended = alpha * history + (1.0 - alpha) * padded
    out = warp(saturate_u8(torch.where(border, blended, padded)))
    warped = out.float()
    fade_history = torch.where(border, 0.9 * history + 0.1 * warped, warped)
    return state._replace(fade_history=fade_history,
                          fade_count=count + 1), out


def stabilizer_emit_gated_fn(params: StabilizerParams, state: StabilizerState
                             ) -> tuple[StabilizerState, torch.Tensor,
                                        torch.Tensor]:
    """Emit with the warm-up gate on the device: while the queue holds
    fewer than effective_radius frames the emission cursor (and the other
    emission-mutated fields) is held back and ``ready`` is False."""
    ready = (state.n_frames - state.emit_idx) >= params.effective_radius
    new_state, out = stabilizer_emit_step_fn(params, state)
    return _hold_unready(params, state, new_state, ready), out, ready


def _hold_unready(params: StabilizerParams, state: StabilizerState,
                  new_state: StabilizerState, ready: torch.Tensor
                  ) -> StabilizerState:
    """new_state with the emission-mutated fields of every stream that is
    not ``ready`` held at their values in ``state``, on the device."""
    names = ("emit_idx", "kalman_x", "kalman_p", "butter_state",
             "fade_history", "fade_count", "envelope_exceeded")
    if params.enable_virtual_canvas:
        names += ("canvas", "canvas_weight", "canvas_scale")

    def hold(new, old):
        r = ready.reshape(ready.shape + (1,) * (new.dim() - ready.dim()))
        return torch.where(r, new, old)

    return new_state._replace(**{
        name: hold(getattr(new_state, name), getattr(state, name))
        for name in names})


def stabilizer_step_metrics_fn(params: StabilizerParams,
                               state: StabilizerState,
                               frame_u8: torch.Tensor,
                               redetect_tick: Optional[int] = None,
                               ransac_draws: RansacDraws = None,
                               ) -> tuple[StabilizerState, torch.Tensor,
                                          torch.Tensor, dict]:
    """Analyze + gated emit, returning the analysis metrics as device
    tensors (read them at reporting cadence, not per frame)."""
    state, metrics = stabilizer_analyze_step_fn(
        params, state, frame_u8, redetect_tick=redetect_tick,
        ransac_draws=ransac_draws)
    state, out, ready = stabilizer_emit_gated_fn(params, state)
    metrics["envelope_exceeded"] = state.envelope_exceeded
    return state, out, ready, metrics


def batched_init_step_fn(params: StabilizerParams, state: StabilizerState,
                         frames_u8: torch.Tensor) -> StabilizerState:
    """``stabilizer_init_step_fn`` for N streams: (N, H, W, 3) frames, one
    GFTT detection (one K3 launch) for all N."""
    check_supported_batched(params)
    gray = _analysis_gray(params, frames_u8.float())
    pts, mask = _detect_features(
        params, gray, roi=_roi(params, frames_u8.shape[-3:],
                               frames_u8.device))
    return state._replace(prev_gray=gray, prev_pts=pts, prev_mask=mask,
                          **_queue_frame(state, frames_u8, None))


def batched_analyze_step_fn(params: StabilizerParams, state: StabilizerState,
                            frames_u8: torch.Tensor, redetect_tick: int,
                            ransac_draws: RansacDraws = None,
                            ) -> tuple[StabilizerState, dict]:
    """``stabilizer_analyze_step_fn`` for N streams: the analysis grays, LK
    (one K6 launch for all N * P points) and RANSAC, or the network on the
    N gray pairs in one forward pass, on (N, ...) tensors. Each stream
    draws RANSAC's hypotheses from its own generator (``state.key[i]``),
    or ``ransac_draws`` maps the (N,) valid counts to (N, K, width)
    draws. ``redetect_tick`` is the batch's one host counter (the JAX
    package's unbatched tick): every stream re-detects on the same
    ticks. A stream whose slot was just reset analyzes against a zero gray
    with no valid point: its estimate is not ok and its transform zero.
    Drone mode's stages run once for the N streams, each stream's CLAHE
    selected by its own starvation counter, its prior its own shift and
    its HF chain its own state."""
    check_supported_batched(params)
    gray = _conditional_clahe(params, state,
                              _analysis_gray(params, frames_u8.float()))
    raw, curr_pts, valid, inliers, est_ok = _estimate_motion(
        params, state, gray, frames_u8.shape[-3:], ransac_draws)
    hf, raw = _hf_step(params, state, raw)
    return _finish_analyze(params, state._replace(hf=hf), frames_u8, gray,
                           raw, curr_pts, valid, inliers, est_ok,
                           int(redetect_tick), None)


def batched_emit_step_fn(params: StabilizerParams, state: StabilizerState
                         ) -> tuple[StabilizerState, torch.Tensor]:
    """``stabilizer_emit_step_fn`` for N streams: every stream's smoothed
    correction at its own emit cursor, then one warp launch (K1, or K2 for
    the homography model) that reads each stream's queued frame in place
    in the (N, Q, H, W, 3) ring at its slot, a device table: no frame is
    gathered and no slot read on the host; with crop_n_zoom one crop and
    resample of the N warped frames. Returns (N, H, W, 3) u8."""
    with telemetry.trace("vstab.emit"):
        check_supported_batched(params)
        state, e, has_transform, raw, diff = _emit_inputs(params, state)
        ring = state.frame_ring
        slots = torch.remainder(e, ring.shape[1]).to(torch.int32)
        if params.motion_model == "homography":
            h_corr = exp_homography(torch.where(
                has_transform[:, None], raw + diff,
                torch.zeros_like(raw)).reshape(-1, 3, 3))
            exceeded = _homography_exceeded(params, h_corr, has_transform)
            out = warp_homography_u8_batched(ring, slots, h_corr,
                                             border_mode=BORDER_CONSTANT)
        else:
            dx, dy, da, exceeded = _similarity_correction(
                params, state, e, has_transform, raw, diff, ring.shape[2:4])
            out = warp_affine_u8_batched(ring, slots,
                                         similarity_matrix(dx, dy, da),
                                         border_mode=BORDER_CONSTANT)
        out = _crop_zoom(params, out)
        return state._replace(
            emit_idx=e + 1,
            envelope_exceeded=state.envelope_exceeded
            + exceeded.to(torch.int32)), out


def batched_emit_gated_fn(params: StabilizerParams, state: StabilizerState
                          ) -> tuple[StabilizerState, torch.Tensor,
                                     torch.Tensor]:
    """``stabilizer_emit_gated_fn`` for N streams: the warm-up gate per
    stream, on the device; ``ready`` is (N,) bool."""
    ready = (state.n_frames - state.emit_idx) >= params.effective_radius
    new_state, out = batched_emit_step_fn(params, state)
    return _hold_unready(params, state, new_state, ready), out, ready


def batched_step_metrics_fn(params: StabilizerParams, state: StabilizerState,
                            frames_u8: torch.Tensor, redetect_tick: int,
                            ransac_draws: RansacDraws = None,
                            ) -> tuple[StabilizerState, torch.Tensor,
                                       torch.Tensor, dict]:
    """``stabilizer_step_metrics_fn`` for N streams: the batched analyze
    and gated emit of one tick; the metrics are (N, ...) device tensors."""
    state, metrics = batched_analyze_step_fn(
        params, state, frames_u8, redetect_tick, ransac_draws=ransac_draws)
    state, out, ready = batched_emit_gated_fn(params, state)
    metrics["envelope_exceeded"] = state.envelope_exceeded
    return state, out, ready, metrics


def as_device_frame(frame, device: torch.device) -> torch.Tensor:
    """An (H, W, 3) uint8 frame (numpy or tensor; gray is repeated to 3
    channels) as a contiguous tensor on ``device``, uploaded by
    ``hostcopy.to_device``."""
    t = hostcopy.to_device(frame, device)
    if t.dim() == 2:
        t = t[:, :, None].expand(-1, -1, 3)
    return t.contiguous()


class Stabilizer:
    """Streaming stabilizer with the reference's push/pull API:
    ``stabilize(frame)`` returns a stabilized frame once
    ``effective_radius`` frames have accumulated, else None; ``flush()``
    drains the look-ahead queue; ``clean()`` resets.

    The device is picked once, from ``mode.use_cuda`` (default
    ``ModeParams()``: CUDA, raising without one). ``ransac_draws``: an
    optional callable given a step's valid-point count (a 0-d device
    tensor) that returns the RANSAC draws for that step, (K, 2) for the
    similarity model and (K, 4) for the homography model — the hook
    through which parity tests feed the JAX package's own draws. Without
    it the draws come from the state's generator (``params.seed``)."""

    def __init__(self, params: Optional[StabilizerParams] = None, *,
                 mode: Optional[ModeParams] = None,
                 ransac_draws: RansacDraws = None, **kw):
        if params is None:
            params = StabilizerParams(**kw)
        elif kw:
            raise ValueError("pass either params or keyword overrides")
        check_supported(params)
        self.params = params
        self.device = pick_device((mode or ModeParams()).use_cuda)
        self.ransac_draws = ransac_draws
        self._state: Optional[StabilizerState] = None
        self._shape: Optional[tuple] = None
        # Host mirrors of n_frames / emit_idx: steady state reads nothing
        # back from the device.
        self._frames_in = 0
        self._emitted = 0
        self.last_metrics: dict = {}

    def _ensure_state(self, frame: torch.Tensor) -> None:
        h, w = frame.shape[:2]
        if self._state is None:
            self._state = stabilizer_state_init(self.params, h, w,
                                                self.device)
            if self.params.deep_stabilization:
                self._state = self._state._replace(
                    deepstab=resolve_deepstab_weights(self.params,
                                                      self.device))
            self._shape = (h, w)
        elif self._shape != (h, w):
            raise ValueError(
                f"frame size changed {self._shape} -> {(h, w)}; call clean()")

    @property
    def _queued(self) -> int:
        return self._frames_in - self._emitted

    def stabilize_device(self, frame) -> Optional[torch.Tensor]:
        """One step per frame, no device->host reads of its own (the GFTT
        NMS flag and the homography model's ``eigh`` / ``matrix_exp``
        aside): the stabilized frame as a device tensor (None during
        warm-up)."""
        with telemetry.trace("vstab.upload"):
            frame = as_device_frame(frame, self.device)
        with telemetry.trace("vstab.step"):
            self._ensure_state(frame)
            if self._frames_in == 0:
                self._state = stabilizer_init_step_fn(
                    self.params, self._state, frame)
                self._frames_in = 1
                return None
            self._state, out, _ready, self.last_metrics = \
                stabilizer_step_metrics_fn(self.params, self._state, frame,
                                           redetect_tick=self._frames_in,
                                           ransac_draws=self.ransac_draws)
            self._frames_in += 1
            if self._queued < self.params.effective_radius:
                return None
            self._emitted += 1
            return out

    def stabilize(self, frame) -> Optional[np.ndarray]:
        with telemetry.trace("vstab.process"):
            out = self.stabilize_device(frame)
            if out is None:
                return None
            with telemetry.trace("vstab.download"):
                return hostcopy.to_host(out)

    def flush(self) -> Optional[np.ndarray]:
        """Drain one remaining queued frame."""
        if self._state is None or self._queued <= 0:
            return None
        self._state, out = stabilizer_emit_step_fn(self.params, self._state)
        self._emitted += 1
        with telemetry.trace("vstab.download"):
            return hostcopy.to_host(out)

    def clean(self) -> None:
        """Reset all streaming state."""
        self._state = None
        self._shape = None
        self._frames_in = 0
        self._emitted = 0
        self.last_metrics = {}

    def state_dict(self) -> Optional[dict]:
        """The state as numpy arrays under the JAX package's field names
        (``core.state.state_to_numpy``)."""
        return None if self._state is None else state_to_numpy(self._state)

    def load_state_dict(self, state, height: int, width: int) -> None:
        """Resume from a numpy state tree: this class's ``state_dict()`` or
        the JAX package's (``core.state.state_from_numpy``)."""
        if isinstance(state, dict):
            state = SimpleNamespace(**state)
        self._state = state_from_numpy(state, self.device)
        if self.params.deep_stabilization and \
                not isinstance(self._state.deepstab, torch.nn.Module):
            self._state = self._state._replace(
                deepstab=resolve_deepstab_weights(self.params, self.device))
        self._shape = (height, width)
        self._frames_in = int(np.asarray(state.n_frames))
        self._emitted = int(np.asarray(state.emit_idx))
