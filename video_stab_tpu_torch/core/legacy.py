"""Legacy deterministic stabilizer — port of ``video_stab_tpu/core/legacy.py``
(src/Stabilizer_legacy.cpp, the RANSAC-free "robust shake-avoiding"
variant with vs::Stabilizer's public API).

Per frame, at full resolution: GFTT (K3 and the greedy NMS) -> pyramidal
LK 21x21 over 4 levels, 30 iterations, eps 0.01 (K6) -> err < 30 filter ->
median-motion outlier rejection -> closed-form centroid / atan2 rigid
solve -> shake damping -> push the rings. The emit smooths the path with
a centred box and warps the queued frame (K1) with ``border_type``.

The re-detect decision depends on how many points LK kept, a device value.
The step reads that one flag back (the counter ``legacy_redetect_reads``
of ``utils.telemetry.counters()`` counts the reads)
and runs the detector only when it fires, where the JAX package takes a
``lax.cond``; the readiness of the emit comes from host counters.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from video_stab_tpu_torch import pick_device
from video_stab_tpu_torch.core.params import (LegacyStabilizerParams,
                                              ModeParams)
from video_stab_tpu_torch.core.stabilizer import as_device_frame
from video_stab_tpu_torch.core.state import LegacyState, legacy_state_init
from video_stab_tpu_torch.motion.estimate import (estimate_rigid_closed_form,
                                                  fma, remove_outliers_median)
from video_stab_tpu_torch.motion.filters import (box_filter_emit, ring_get,
                                                 ring_push)
from video_stab_tpu_torch.ops.color import bgr_to_gray
from video_stab_tpu_torch.ops.features import good_features_to_track
from video_stab_tpu_torch.ops.lk import lk_track
from video_stab_tpu_torch.ops.warp import (border_mode_from_name,
                                           similarity_matrix,
                                           warp_affine_fast)
from video_stab_tpu_torch.utils import hostcopy, telemetry


def _detect_features(params: LegacyStabilizerParams, gray: torch.Tensor):
    """detectInitialFeatures (Stabilizer_legacy.cpp:163-193): GFTT + border
    margin filter."""
    h, w = gray.shape
    pts, mask = good_features_to_track(
        gray, max_corners=params.max_corners,
        quality_level=params.quality_level,
        min_distance=params.min_distance, block_size=params.block_size)
    m = params.feature_border_margin
    inside = ((pts[:, 0] > m) & (pts[:, 1] > m)
              & (pts[:, 0] < w - m) & (pts[:, 1] < h - m))
    return pts, mask & inside


def _suppress_shake(params: LegacyStabilizerParams, t: torch.Tensor
                    ) -> torch.Tensor:
    """suppressShake (Stabilizer_legacy.cpp:360-378): damp x0.15 when both
    |translation| < 3 px and |rotation| < 0.03 rad."""
    t_mag = torch.sqrt(fma(t[0], t[0], t[1] * t[1]))
    is_shake = (t_mag < params.shake_threshold_px) \
        & (t[2].abs() < params.rotation_shake_rad)
    return torch.where(is_shake, t * params.shake_damping_factor, t)


def legacy_init_step_fn(params: LegacyStabilizerParams, state: LegacyState,
                        frame_u8: torch.Tensor) -> LegacyState:
    """initializeFirstFrame (Stabilizer_legacy.cpp:144-161). The first
    frame is not queued: the queue starts with the second input."""
    gray = bgr_to_gray(frame_u8.float())
    pts, mask = _detect_features(params, gray)
    return state._replace(prev_gray=gray, prev_pts=pts, prev_mask=mask)


def legacy_analyze_step_fn(params: LegacyStabilizerParams, state: LegacyState,
                           frame_u8: torch.Tensor
                           ) -> tuple[LegacyState, dict]:
    """generateTransform (Stabilizer_legacy.cpp:195-281)."""
    gray = bgr_to_gray(frame_u8.float())
    curr_pts, status, err = lk_track(
        state.prev_gray, gray, state.prev_pts, state.prev_mask,
        win=params.lk_window, max_level=params.lk_levels,
        iters=params.lk_iters, eps=params.lk_eps)
    good = state.prev_mask & status & (err < params.lk_err_threshold)
    n_good = good.to(torch.int32).sum()

    # Median outlier rejection + closed-form rigid + shake damping.
    kept = remove_outliers_median(state.prev_pts, curr_pts, good,
                                  threshold=params.outlier_threshold,
                                  min_keep=10)
    t = _suppress_shake(params,
                        estimate_rigid_closed_form(state.prev_pts, curr_pts,
                                                   kept))
    low_features = n_good < params.min_tracking_features
    raw = torch.where(low_features, torch.zeros_like(t), t)

    n = state.n_path
    prev_path = torch.where(n > 0, ring_get(state.path_ring, n - 1),
                            torch.zeros_like(raw))
    new_path = torch.where(n > 0, prev_path + raw, raw)
    trans_ring = ring_push(state.trans_ring, n, raw)
    path_ring = ring_push(state.path_ring, n, new_path)

    # Feature maintenance: re-detect on starvation or every
    # redetect_interval-th good frame (legacy:236-248, 276-280), else
    # carry the tracked points with their validity.
    fsd = torch.where(low_features, state.frames_since_detect,
                      state.frames_since_detect + 1)
    do_redetect = low_features | (fsd > params.redetect_interval)
    telemetry.count("legacy_redetect_reads")
    if bool(do_redetect):
        prev_pts, prev_mask = _detect_features(params, gray)
    else:
        prev_pts, prev_mask = curr_pts, state.prev_mask & status
    fsd = torch.where(do_redetect & ~low_features, torch.zeros_like(fsd), fsd)

    q = state.frame_ring.shape[0]
    slot = torch.remainder(state.n_frames, q).to(torch.int64).reshape(1)
    new_state = state._replace(
        prev_gray=gray, prev_pts=prev_pts, prev_mask=prev_mask,
        trans_ring=trans_ring, path_ring=path_ring, n_path=n + 1,
        frame_ring=state.frame_ring.index_copy_(0, slot, frame_u8[None]),
        n_frames=state.n_frames + 1, frames_since_detect=fsd)
    metrics = {"n_tracked": n_good, "transform": raw,
               "redetected": do_redetect}
    return new_state, metrics


def legacy_emit_step_fn(params: LegacyStabilizerParams, state: LegacyState
                        ) -> tuple[LegacyState, torch.Tensor]:
    """applyNextSmoothTransform + applyTransform
    (Stabilizer_legacy.cpp:380-502)."""
    e = state.emit_idx
    has_transform = e < state.n_path
    e_safe = torch.minimum(e, torch.clamp(state.n_path - 1, min=0))

    # Centred box smoothing over the cumulative path (legacy:412-434).
    r = params.box_radius
    smoothed = box_filter_emit(state.path_ring, state.n_path, e_safe, r,
                               max(r, 1))
    raw_path = ring_get(state.path_ring, e_safe)
    correction = torch.where(has_transform, smoothed - raw_path,
                             torch.zeros_like(raw_path))

    q = state.frame_ring.shape[0]
    slot = torch.remainder(e, q).to(torch.int64).reshape(1)
    frame = state.frame_ring.index_select(0, slot)[0]
    h, w = frame.shape[:2]
    border_mode = border_mode_from_name(params.border_type)
    b = params.border_size
    if not params.crop_n_zoom:
        # Larger canvas + offset + crop back (legacy:465-494): the output
        # crop starts at (b/2, b/2) and keeps the original size.
        m = similarity_matrix(correction[0] + b, correction[1] + b,
                              correction[2])
        out = warp_affine_fast(frame, m, out_h=h + 2 * b, out_w=w + 2 * b,
                               border_mode=border_mode)
        if b > 0:
            c = min(max(0, b // 2), 2 * b)
            out = out[c:c + h, c:c + w]
    else:
        m = similarity_matrix(correction[0], correction[1], correction[2])
        out = warp_affine_fast(frame, m, border_mode=border_mode)
    return state._replace(emit_idx=e + 1), out


class LegacyStabilizer:
    """Streaming wrapper over the legacy deterministic path. Unlike
    ``Stabilizer``, the first frame is returned as-is (legacy:160).

    The device is picked once, from ``mode.use_cuda`` (default
    ``ModeParams()``: CUDA, raising without one). Host counters mirror the
    device's queue cursors, so readiness reads nothing back; the re-detect
    flag is the step's one read."""

    def __init__(self, params: Optional[LegacyStabilizerParams] = None, *,
                 mode: Optional[ModeParams] = None, **kw):
        if params is None:
            params = LegacyStabilizerParams(**kw)
        elif kw:
            raise ValueError("pass either params or keyword overrides")
        self.params = params
        self.device = pick_device((mode or ModeParams()).use_cuda)
        self._state: Optional[LegacyState] = None
        self._shape: Optional[tuple] = None
        self._initialized = False
        # Host mirrors of n_frames / emit_idx.
        self._frames_in = 0
        self._emitted = 0
        self.last_metrics: dict = {}

    def _ensure_state(self, frame: torch.Tensor) -> None:
        h, w = frame.shape[:2]
        if self._state is None:
            self._state = legacy_state_init(self.params, h, w, self.device)
            self._shape = (h, w)
        elif self._shape != (h, w):
            raise ValueError(
                f"frame size changed {self._shape} -> {(h, w)}; call clean()")

    @property
    def _queued(self) -> int:
        return self._frames_in - self._emitted

    def stabilize_device(self, frame) -> Optional[torch.Tensor]:
        """One step per frame: the stabilized frame as a device tensor
        (the first frame as it came in), or None while the queue fills."""
        frame = as_device_frame(frame, self.device)
        self._ensure_state(frame)
        if not self._initialized:
            self._state = legacy_init_step_fn(self.params, self._state, frame)
            self._initialized = True
            return frame
        self._state, self.last_metrics = legacy_analyze_step_fn(
            self.params, self._state, frame)
        self._frames_in += 1
        if self._queued < self.params.effective_radius:
            return None
        return self._emit()

    def _emit(self) -> torch.Tensor:
        self._state, out = legacy_emit_step_fn(self.params, self._state)
        self._emitted += 1
        return out

    def stabilize(self, frame) -> Optional[np.ndarray]:
        out = self.stabilize_device(frame)
        return None if out is None else hostcopy.to_host(out)

    def flush(self) -> Optional[np.ndarray]:
        """Drain one remaining queued frame."""
        if self._state is None or self._queued <= 0:
            return None
        return hostcopy.to_host(self._emit())

    def clean(self) -> None:
        self._state = None
        self._shape = None
        self._initialized = False
        self._frames_in = 0
        self._emitted = 0
        self.last_metrics = {}
