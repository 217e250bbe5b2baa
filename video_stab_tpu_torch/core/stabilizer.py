"""The streaming stabilizer — PyTorch port of
``video_stab_tpu/core/stabilizer.py``.

Per frame:
  analyze:  gray + resize -> [drone mode: CLAHE after > 2 starved frames]
            -> sparse pyramidal LK -> RANSAC similarity (or homography,
            conjugated to full resolution and mapped to sl(3)) -> [drone
            mode, similarity: the high-frequency chain] -> push transform
            and path rings -> re-detect GFTT features every
            ``redetect_interval``-th frame
  emit:     smooth the path at the emit cursor (box, gaussian, kalman or
            butterworth) -> similarity: motion-intent correction scaling ->
            rigid matrix (composed with the fused chain's roll rotation) ->
            one warp of the queued frame (K1); homography: exp of the sl(3)
            correction -> one projective warp (K2)

The port covers the similarity and homography models with every streaming
smoother, the drone high-frequency mode, black borders and GFTT. The other
branches raise ``NotImplementedError`` naming their ROADMAP queue-1 item.

Steps are plain functions over an explicit ``StabilizerState`` of device
tensors. The wrappers' steady state reads nothing back from the device:
readiness and the re-detect cadence come from host-side frame counters
that mirror the device's, and every index into a ring is a device tensor.
The homography model adds the reads of its ``eigh`` and ``matrix_exp``
(``motion/homography.py``).
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np
import torch

from video_stab_tpu_torch import pick_device
from video_stab_tpu_torch.core.params import ModeParams, StabilizerParams
from video_stab_tpu_torch.core.state import (
    StabilizerState,
    state_from_numpy,
    state_to_numpy,
    stabilizer_state_init,
)
from video_stab_tpu_torch.kernels.warp import warp_affine_u8
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
from video_stab_tpu_torch.ops.color import bgr_to_gray
from video_stab_tpu_torch.ops.features import good_features_to_track
from video_stab_tpu_torch.ops.filters import clahe
from video_stab_tpu_torch.ops.lk import lk_track
from video_stab_tpu_torch.ops.resize import resize_bilinear
from video_stab_tpu_torch.ops.warp import (
    BORDER_CONSTANT,
    rotation_matrix_2d,
    similarity_matrix,
    warp_perspective_fast,
)

WARP_MAX_SHIFT = 128    # translation envelope (px) of the JAX emit warp
# Projective allowance |g|, |h| of the JAX projective warp's static envelope
# (video_stab_tpu/pallas/warp.py PROJ_BUDGET_DEFAULT).
PROJ_BUDGET_DEFAULT = 5e-6

# RANSAC draws for a step given its valid-point count, or None: (K, 2) for
# the similarity model, (K, 4) for the homography model.
RansacDraws = Optional[Callable[[torch.Tensor], torch.Tensor]]

SMOOTHING_METHODS = ("box", "gaussian", "kalman", "butterworth")


def check_supported(params: StabilizerParams) -> None:
    """Raise NotImplementedError for the branches this slice does not port,
    naming the ROADMAP queue-1 item that ports them."""
    todo = []
    if params.motion_model not in ("similarity", "homography"):
        todo.append(f"motion_model={params.motion_model} (unknown)")
    if params.deep_stabilization:
        todo.append("deep_stabilization (queue 1 item 9)")
    if params.smoothing_method not in SMOOTHING_METHODS:
        todo.append(f"smoothing_method={params.smoothing_method} (unknown; "
                    "l1 is offline only)")
    if params.border_pad > 0:
        todo.append(f"border_size > 0 (border_type={params.border_type}, "
                    f"crop_n_zoom, fade; queue 1 item 7)")
    if params.enable_virtual_canvas:
        todo.append("enable_virtual_canvas (queue 1 item 9)")
    if params.feature_detector != "gftt":
        todo.append(f"feature_detector={params.feature_detector} "
                    "(queue 1 item 9)")
    if params.motion_prediction:
        todo.append("motion_prediction (queue 1 item 4)")
    if todo:
        raise NotImplementedError(
            "not ported to video_stab_tpu_torch yet: " + "; ".join(todo))


def _analysis_gray(params: StabilizerParams, frame_f32: torch.Tensor
                   ) -> torch.Tensor:
    """Full-res BGR (or an already-gray plane) -> analysis-resolution gray."""
    gray = frame_f32 if frame_f32.dim() == 2 else bgr_to_gray(frame_f32)
    return resize_bilinear(gray, params.analysis_height,
                           params.analysis_width)


def _detect_features(params: StabilizerParams, gray: torch.Tensor,
                     roi: Optional[torch.Tensor] = None,
                     redetect: bool = False):
    """GFTT detection; re-detection uses the reference's fast parameters
    (quality 0.02, min distance 15)."""
    if redetect:
        return good_features_to_track(
            gray, max_corners=params.max_corners, quality_level=0.02,
            min_distance=15.0, block_size=3)
    return good_features_to_track(
        gray, max_corners=params.max_corners,
        quality_level=params.quality_level, min_distance=params.min_distance,
        block_size=params.block_size, roi=roi)


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
    package donates it to the same effect)."""
    q = state.frame_ring.shape[0]
    slot = torch.remainder(state.n_frames, q).to(torch.int64).reshape(1)
    aux_ring = state.aux_roll_ring
    if aux_roll is not None:
        aux = torch.as_tensor(aux_roll, dtype=torch.float32,
                              device=aux_ring.device).reshape(1)
        aux_ring = aux_ring.index_copy(0, slot, aux)
    return dict(frame_ring=state.frame_ring.index_copy_(0, slot,
                                                        frame_u8[None]),
                n_frames=state.n_frames + 1,
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
    rows = torch.stack([h_mat[0] * sxf, h_mat[1] * syf, h_mat[2]])
    return torch.stack([rows[:, 0] * (1.0 / sxf), rows[:, 1] * (1.0 / syf),
                        rows[:, 2]], dim=1)


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

    # Conditional CLAHE under feature starvation (drone mode): the analysis
    # gray is enhanced after > 2 consecutive starved frames. The counter
    # lives on the device, so CLAHE runs every frame and a select keeps or
    # drops it: no host read, at the cost of its ~40 small launches.
    if params.drone_high_freq_mode and params.enable_conditional_clahe:
        gray = torch.where(state.starvation_counter > 2,
                           clahe(gray, clip_limit=2.0, tile_grid=8), gray)

    curr_pts, status, _err = lk_track(
        state.prev_gray, gray, state.prev_pts, state.prev_mask,
        win=params.lk_window, max_level=params.lk_levels,
        iters=params.lk_iters)
    valid = state.prev_mask & status

    draws = None if ransac_draws is None else ransac_draws(valid.sum())
    if params.motion_model == "homography":
        h_mat, est_ok, inliers = estimate_homography_ransac(
            state.prev_pts, curr_pts, valid, generator=state.key,
            threshold=params.ransac_threshold,
            n_hypotheses=params.ransac_hypotheses, draws=draws)
        raw = log_homography(
            to_full_resolution(params, frame_u8.shape, h_mat)).reshape(9)
    else:
        m, est_ok, inliers = estimate_similarity_ransac(
            state.prev_pts, curr_pts, valid, generator=state.key,
            threshold=params.ransac_threshold,
            n_hypotheses=params.ransac_hypotheses, draws=draws)
        raw = torch.stack([m[0, 2], m[1, 2], torch.atan2(m[1, 0], m[0, 0])])

    # Drone high-frequency vibration chain: a similarity-space heuristic,
    # skipped by the homography model.
    hf = state.hf
    if params.drone_high_freq_mode and params.motion_model != "homography":
        hf, raw = hf_apply(
            hf, raw,
            dead_zone_threshold=params.hf_dead_zone_threshold,
            freeze_duration=params.hf_freeze_duration,
            accumulator_decay=params.hf_motion_accumulator_decay,
            shake_px=params.hf_shake_px,
            rot_lp_alpha=params.hf_rot_lp_alpha,
            horizon_lock=params.horizon_lock)

    # Push raw transform + cumulative path into the rings.
    n = state.n_path
    prev_path = torch.where(n > 0, ring_get(state.path_ring, n - 1),
                            torch.zeros_like(raw))
    new_path = torch.where(n > 0, prev_path + raw, raw)
    trans_ring = ring_push(state.trans_ring, n, raw)
    path_ring = ring_push(state.path_ring, n, new_path)
    n = n + 1

    n_tracked = valid.to(torch.int32).sum()
    starvation = torch.where(n_tracked < 40, state.starvation_counter + 1,
                             torch.zeros_like(state.starvation_counter))

    tick = int(n) if redetect_tick is None else int(redetect_tick)
    if tick % params.redetect_interval == 0:
        prev_pts, prev_mask = _detect_features(params, gray, redetect=True)
    else:
        prev_pts, prev_mask = curr_pts, valid

    new_state = state._replace(
        prev_gray=gray, prev_pts=prev_pts, prev_mask=prev_mask,
        trans_ring=trans_ring, path_ring=path_ring, n_path=n, hf=hf,
        starvation_counter=starvation,
        **_queue_frame(state, frame_u8, aux_roll))
    metrics = {
        "n_tracked": n_tracked,
        "n_inliers": inliers.to(torch.int32).sum(),
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
    if method == "butterworth":
        cutoff = jitter_frequency_cutoff(params.jitter_frequency)
        z = ring_get(state.path_ring, e)
        first = e == 0
        bst, sm = butterworth_cascade(state.butter_state, z, cutoff, 4)
        bst = torch.where(first, z.expand(4, -1), bst)
        return state._replace(butter_state=bst), torch.where(first, z, sm)
    if method == "kalman":
        z = ring_get(state.path_ring, e)
        first = e == 0
        st, sm = kalman_step({"x": state.kalman_x, "p": state.kalman_p}, z)
        st0 = kalman_init(z)
        return state._replace(
            kalman_x=torch.where(first, st0["x"], st["x"]),
            kalman_p=torch.where(first, st0["p"], st["p"])), \
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
    check_supported(params)
    dev = state.trans_ring.device
    e = state.emit_idx
    has_transform = e < state.n_path
    zeros = torch.zeros(state.trans_ring.shape[1], dtype=torch.float32,
                        device=dev)
    raw = torch.where(has_transform, ring_get(state.trans_ring, e), zeros)
    e_path = torch.minimum(e, state.n_path - 1)
    path_e = ring_get(state.path_ring, e_path)

    state, smoothed = _smoothed_at_emit(params, state, e_path)
    diff = smoothed - path_e

    q = state.frame_ring.shape[0]
    slot = torch.remainder(e, q).to(torch.int64).reshape(1)
    frame_u8 = state.frame_ring.index_select(0, slot)[0]
    if params.motion_model == "homography":
        return _emit_homography(params, state, frame_u8, has_transform,
                                torch.where(has_transform, raw + diff, zeros))

    # Motion-intent correction scaling.
    intent = analyze_motion_intent(state.trans_ring, state.n_path, raw, e)
    diff = diff * intent_correction_scale(intent, raw, e)

    t_smooth = torch.where(has_transform, raw + diff, zeros)
    dx, dy = t_smooth[0], t_smooth[1]
    da = torch.zeros_like(t_smooth[2]) if params.horizon_lock \
        else t_smooth[2]
    if params.full_res_corrections:
        sxf = state.frame_ring.shape[2] / params.analysis_width
        syf = state.frame_ring.shape[1] / params.analysis_height
        if sxf != 1.0 or syf != 1.0:
            dx = dx * float(np.float32(sxf))
            dy = dy * float(np.float32(syf))
    t_mat = similarity_matrix(dx, dy, da)
    # Envelope observability: the JAX warp clamps (degrades) outside its
    # static envelope; the count stays comparable although K1 is exact.
    env_rad = math.radians(params.warp_envelope_deg)
    exceeded = has_transform & (
        (da.abs() > env_rad)
        | (torch.maximum(dx.abs(), dy.abs()) > WARP_MAX_SHIFT))

    h, w = frame_u8.shape[0], frame_u8.shape[1]
    m_use = t_mat
    if params.aux_rotation_deg > 0.0:
        # Fused-chain roll: compose correction o roll-rotation about the
        # frame center into ONE resample.
        aux_alpha = state.aux_roll_ring.index_select(0, slot)[0]
        exceeded = exceeded | (has_transform
                               & (aux_alpha.abs() > params.aux_rotation_deg))
        r_mat = rotation_matrix_2d(w / 2.0, h / 2.0, aux_alpha)
        row3 = torch.zeros((1, 3), dtype=torch.float32, device=dev)
        row3[0, 2] = 1.0
        m_use = (torch.cat([t_mat, row3]) @ torch.cat([r_mat, row3]))[:2]
    out_u8 = warp_affine_u8(frame_u8, m_use, border_mode=BORDER_CONSTANT)

    new_state = state._replace(
        emit_idx=e + 1,
        envelope_exceeded=state.envelope_exceeded + exceeded.to(torch.int32))
    return new_state, out_u8


def _emit_homography(params: StabilizerParams, state: StabilizerState,
                     frame_u8: torch.Tensor, has_transform: torch.Tensor,
                     t_smooth: torch.Tensor
                     ) -> tuple[StabilizerState, torch.Tensor]:
    """The homography emit: sl(3) correction -> SL(3) -> one projective warp
    (K2). Motion-intent scaling is a similarity-space heuristic and is
    skipped, as in the JAX package."""
    h_corr = exp_homography(t_smooth.reshape(3, 3))
    # Envelope observability: the JAX projective warp clamps outside its
    # static envelope (rotation/shear slope, shift, projective budget); the
    # count stays comparable although K2 is exact.
    s_env = abs(math.sin(math.radians(params.warp_envelope_deg)))
    exceeded = has_transform & (
        (torch.maximum(h_corr[0, 2].abs(), h_corr[1, 2].abs())
         > WARP_MAX_SHIFT)
        | (h_corr[0, 1].abs() > s_env) | (h_corr[1, 0].abs() > s_env)
        | (h_corr[2, 0].abs() > PROJ_BUDGET_DEFAULT)
        | (h_corr[2, 1].abs() > PROJ_BUDGET_DEFAULT))
    out_u8 = warp_perspective_fast(frame_u8, h_corr,
                                   border_mode=BORDER_CONSTANT)
    new_state = state._replace(
        emit_idx=state.emit_idx + 1,
        envelope_exceeded=state.envelope_exceeded + exceeded.to(torch.int32))
    return new_state, out_u8


def stabilizer_emit_gated_fn(params: StabilizerParams, state: StabilizerState
                             ) -> tuple[StabilizerState, torch.Tensor,
                                        torch.Tensor]:
    """Emit with the warm-up gate on the device: while the queue holds
    fewer than effective_radius frames the emission cursor (and the other
    emission-mutated fields) is held back and ``ready`` is False."""
    ready = (state.n_frames - state.emit_idx) >= params.effective_radius
    new_state, out = stabilizer_emit_step_fn(params, state)
    held = {name: torch.where(ready, getattr(new_state, name),
                              getattr(state, name))
            for name in ("emit_idx", "kalman_x", "kalman_p", "butter_state",
                         "envelope_exceeded")}
    new_state = new_state._replace(**held)
    return new_state, out, ready


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


def stabilizer_step_fn(params: StabilizerParams, state: StabilizerState,
                       frame_u8: torch.Tensor,
                       redetect_tick: Optional[int] = None,
                       ransac_draws: RansacDraws = None,
                       ) -> tuple[StabilizerState, torch.Tensor, torch.Tensor]:
    """Steady-state combined step: analyze the incoming frame and emit the
    oldest queued one; ``ready`` is False until the queue holds
    effective_radius frames."""
    state, out, ready, _ = stabilizer_step_metrics_fn(
        params, state, frame_u8, redetect_tick=redetect_tick,
        ransac_draws=ransac_draws)
    return state, out, ready


def as_device_frame(frame, device: torch.device) -> torch.Tensor:
    """An (H, W, 3) uint8 frame (numpy or tensor; gray is repeated to 3
    channels) as a contiguous tensor on ``device``."""
    if isinstance(frame, torch.Tensor):
        t = frame.to(device=device, dtype=torch.uint8)
    else:
        t = torch.from_numpy(np.ascontiguousarray(frame, dtype=np.uint8))
        t = t.to(device)
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
        frame = as_device_frame(frame, self.device)
        self._ensure_state(frame)
        if self._frames_in == 0:
            self._state = stabilizer_init_step_fn(self.params, self._state,
                                                  frame)
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
        out = self.stabilize_device(frame)
        return None if out is None else out.cpu().numpy()

    def flush(self) -> Optional[np.ndarray]:
        """Drain one remaining queued frame."""
        if self._state is None or self._queued <= 0:
            return None
        self._state, out = stabilizer_emit_step_fn(self.params, self._state)
        self._emitted += 1
        return out.cpu().numpy()

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
        self._shape = (height, width)
        self._frames_in = int(np.asarray(state.n_frames))
        self._emitted = int(np.asarray(state.emit_idx))
