"""Fused processing chain: enhance -> roll-correct -> stabilize, one step
per frame — port of ``video_stab_tpu/core/chain.py``.

With roll fusion active (the ``__graft_entry__.entry()`` configuration)
a step is: K4 enhances the frame and yields its gray; the roll angle is
estimated from that gray; only the ANALYSIS-scale gray is rotated (K1);
the frame is queued unrotated and the roll rotation is composed into the
stabilizer's emit warp (K1), one full-res resample in all.

Not ported yet (``NotImplementedError``, ROADMAP queue 1 item 8): the
two-pass roll order (fusion inactive with roll correction on), auto
zoom-crop, the ``i420`` delivered format and the pipelined wrapper.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from video_stab_tpu_torch import pick_device
from video_stab_tpu_torch.core.enhancer import enhance_frame_u8
from video_stab_tpu_torch.core.params import (
    AutoZoomCropParams,
    EnhancerParams,
    ModeParams,
    RollCorrectionParams,
    StabilizerParams,
)
from video_stab_tpu_torch.core.rollcorrection import (
    RollState,
    estimate_roll_angle,
    roll_state_init,
)
from video_stab_tpu_torch.core.stabilizer import (
    RansacDraws,
    _analysis_gray,
    as_device_frame,
    stabilizer_analyze_step_fn,
    stabilizer_emit_gated_fn,
    stabilizer_emit_step_fn,
    stabilizer_init_step_fn,
)
from video_stab_tpu_torch.core.state import (
    StabilizerState,
    state_from_numpy,
    stabilizer_state_init,
)
from video_stab_tpu_torch.ops.color import bgr_to_gray
from video_stab_tpu_torch.ops.warp import (
    BORDER_REPLICATE,
    rotation_matrix_2d,
    warp_affine_fast,
)


class ChainParams(NamedTuple):
    """Static bundle for the fused step (the JAX package's ChainParams)."""

    mode: ModeParams
    enhancer: EnhancerParams
    roll: RollCorrectionParams
    stabilizer: StabilizerParams
    azc: AutoZoomCropParams = AutoZoomCropParams()
    fuse_roll: bool = True
    output_format: str = "bgr"

    AUX_ENVELOPE_CAP_DEG = 15.0

    @property
    def roll_band_deg(self) -> float:
        """The configured roll acceptance band (uncapped)."""
        return max(abs(self.roll.angle_filter_min),
                   abs(self.roll.angle_filter_max))

    @property
    def roll_fusion_active(self) -> bool:
        return (self.fuse_roll
                and self.mode.roll_correction_enabled
                and self.mode.stabilizer_enabled
                and not self.azc.enabled
                and self.stabilizer.motion_model != "homography"
                and not self.stabilizer.enable_virtual_canvas
                and self.stabilizer.border_pad == 0
                and self.roll_band_deg <= self.AUX_ENVELOPE_CAP_DEG)

    @property
    def aux_envelope_deg(self) -> float:
        """Budget of the composed roll rotation, capped at
        AUX_ENVELOPE_CAP_DEG."""
        return min(self.AUX_ENVELOPE_CAP_DEG, self.roll_band_deg)

    @property
    def stabilizer_eff(self) -> StabilizerParams:
        """Stabilizer params with the composed roll rotation's budget when
        fusion is active."""
        if self.roll_fusion_active:
            return dataclasses.replace(self.stabilizer,
                                       aux_rotation_deg=self.aux_envelope_deg)
        return self.stabilizer


class ChainState(NamedTuple):
    roll: RollState
    stab: StabilizerState


def check_supported(params: ChainParams) -> None:
    """Raise NotImplementedError for the chain variants this slice does not
    port (ROADMAP queue 1 item 8)."""
    todo = []
    if params.azc.enabled:
        todo.append("auto zoom-crop (azc)")
    if params.output_format != "bgr":
        todo.append(f"output_format={params.output_format!r}")
    if params.mode.roll_correction_enabled and not params.roll_fusion_active:
        todo.append("the two-pass roll order (roll fusion inactive)")
    if todo:
        raise NotImplementedError(
            "not ported to video_stab_tpu_torch yet: " + "; ".join(todo)
            + " (ROADMAP queue 1 item 8)")


def chain_state_init(params: ChainParams, height: int, width: int,
                     device: torch.device) -> ChainState:
    return ChainState(
        roll=roll_state_init(device),
        stab=stabilizer_state_init(params.stabilizer, height, width, device))


def chain_state_from_numpy(roll_angle, stab_state, device: torch.device
                           ) -> ChainState:
    """A ChainState from the JAX package's ChainState parts as numpy
    (``roll.smoothed_angle`` and the StabilizerState tree); see
    ``core.state.state_from_numpy`` for the key."""
    angle = torch.from_numpy(np.array(roll_angle, np.float32)).to(device)
    return ChainState(roll=RollState(smoothed_angle=angle),
                      stab=state_from_numpy(stab_state, device))


def _pre_stages(params: ChainParams, state: ChainState,
                frame_u8: torch.Tensor):
    """Enhance only (the roll-off case of the JAX two-pass pre-stages)."""
    if params.mode.enhancer_enabled:
        frame_u8, _ = enhance_frame_u8(params.enhancer, frame_u8)
    return state.roll, frame_u8


def _pre_stages_fused(params: ChainParams, state: ChainState,
                      frame_u8: torch.Tensor):
    """Single-resample roll: estimate the roll angle, rotate only the
    ANALYSIS-scale gray, and hand back the UNROTATED enhanced frame plus the
    angle. Returns (roll_state, frame_u8, alpha, gray_rot)."""
    if params.mode.enhancer_enabled:
        f_u8, gray_full = enhance_frame_u8(params.enhancer, frame_u8,
                                           want_gray=True)
    else:
        f_u8, gray_full = frame_u8, bgr_to_gray(frame_u8.float())
    roll_state = estimate_roll_angle(params.roll, state.roll, gray_full)
    alpha = roll_state.smoothed_angle
    h, w = frame_u8.shape[:2]
    sp = params.stabilizer
    gray = _analysis_gray(sp, gray_full)
    # Rotation about the full-res center conjugated into analysis space,
    # A = S R S^-1 (exact for anisotropic analysis scaling).
    sx = sp.analysis_width / w
    sy = sp.analysis_height / h
    r = rotation_matrix_2d(w / 2.0, h / 2.0, alpha)
    a_mat = torch.stack([
        torch.stack([r[0, 0], r[0, 1] * (sx / sy), r[0, 2] * sx]),
        torch.stack([r[1, 0] * (sy / sx), r[1, 1], r[1, 2] * sy]),
    ])
    # alpha == 0 keeps the unrotated gray (the JAX identity skip) as a
    # select, so the warp always runs and nothing is read back.
    gray_rot = warp_affine_fast(gray, a_mat, border_mode=BORDER_REPLICATE)
    gray_rot = torch.where(alpha == 0.0, gray, gray_rot.to(torch.float32))
    return roll_state, f_u8, alpha, gray_rot


def chain_init_step_fn(params: ChainParams, state: ChainState,
                       frame_u8: torch.Tensor) -> ChainState:
    check_supported(params)
    if params.roll_fusion_active:
        roll_state, f, alpha, gray_rot = _pre_stages_fused(params, state,
                                                           frame_u8)
        stab = stabilizer_init_step_fn(params.stabilizer_eff, state.stab, f,
                                       aux_roll=alpha,
                                       analysis_gray=gray_rot)
        return ChainState(roll=roll_state, stab=stab)
    roll_state, f = _pre_stages(params, state, frame_u8)
    stab = stabilizer_init_step_fn(params.stabilizer, state.stab, f)
    return ChainState(roll=roll_state, stab=stab)


def chain_gated_step_fn(params: ChainParams, state: ChainState,
                        frame_u8: torch.Tensor,
                        redetect_tick: Optional[int] = None,
                        ransac_draws: RansacDraws = None,
                        ) -> tuple[ChainState, torch.Tensor, torch.Tensor]:
    """Full per-frame step: pre-stages + stabilizer analyze + warm-up gated
    emit. ``ready`` is False while the look-ahead queue is still filling.
    ``redetect_tick`` / ``ransac_draws``: see the stabilizer's analyze
    step."""
    check_supported(params)
    if params.roll_fusion_active:
        roll_state, f, alpha, gray_rot = _pre_stages_fused(params, state,
                                                           frame_u8)
        sp = params.stabilizer_eff
        stab, _metrics = stabilizer_analyze_step_fn(
            sp, state.stab, f, aux_roll=alpha, analysis_gray=gray_rot,
            redetect_tick=redetect_tick, ransac_draws=ransac_draws)
        stab, out, ready = stabilizer_emit_gated_fn(sp, stab)
        return ChainState(roll=roll_state, stab=stab), out, ready
    roll_state, f = _pre_stages(params, state, frame_u8)
    if params.mode.stabilizer_enabled:
        stab, _metrics = stabilizer_analyze_step_fn(
            params.stabilizer, state.stab, f, redetect_tick=redetect_tick,
            ransac_draws=ransac_draws)
        stab, out, ready = stabilizer_emit_gated_fn(params.stabilizer, stab)
    else:
        stab, out = state.stab, f
        ready = torch.ones((), dtype=torch.bool, device=f.device)
    return ChainState(roll=roll_state, stab=stab), out, ready


def chain_step_fn(params: ChainParams, state: ChainState,
                  frame_u8: torch.Tensor, redetect_tick: Optional[int] = None,
                  ransac_draws: RansacDraws = None,
                  ) -> tuple[ChainState, torch.Tensor]:
    """chain_gated_step_fn minus the readiness flag."""
    state, out, _ready = chain_gated_step_fn(params, state, frame_u8,
                                             redetect_tick, ransac_draws)
    return state, out


def chain_flush_step_fn(params: ChainParams, state: ChainState
                        ) -> tuple[ChainState, torch.Tensor]:
    """Emit-only step: drain one frame from the look-ahead queue."""
    sp = params.stabilizer_eff if params.roll_fusion_active \
        else params.stabilizer
    stab, out = stabilizer_emit_step_fn(sp, state.stab)
    return ChainState(roll=state.roll, stab=stab), out


class ProcessingChain:
    """Streaming wrapper over the fused chain with the Stabilizer-style push
    API: returns None during the stabilizer warm-up, frames after.

    The device is picked once, from ``mode.use_cuda`` (CUDA by default,
    raising without one). ``ransac_draws``: see ``Stabilizer``."""

    def __init__(self, mode: ModeParams, enhancer: EnhancerParams,
                 roll: RollCorrectionParams, stabilizer: StabilizerParams,
                 azc: Optional[AutoZoomCropParams] = None,
                 pipelined: bool = False, fuse_roll: bool = True,
                 output_format: str = "bgr",
                 ransac_draws: RansacDraws = None):
        if output_format not in ("bgr", "i420"):
            raise ValueError(f"unknown output_format {output_format!r}")
        if pipelined:
            raise NotImplementedError(
                "not ported to video_stab_tpu_torch yet: pipelined=True "
                "(ROADMAP queue 1 item 8)")
        self.params = ChainParams(mode=mode, enhancer=enhancer, roll=roll,
                                  stabilizer=stabilizer,
                                  azc=azc or AutoZoomCropParams(),
                                  fuse_roll=fuse_roll,
                                  output_format=output_format)
        check_supported(self.params)
        self.device = pick_device(mode.use_cuda)
        self.ransac_draws = ransac_draws
        self._state: Optional[ChainState] = None
        self._shape = None
        # Host mirrors of the device's warm-up counters: steady state reads
        # nothing back from the device.
        self._frames_in = 0
        self._emitted = 0

    @property
    def state(self) -> Optional[ChainState]:
        return self._state

    def load_state(self, state: ChainState, frames_in: int,
                   emitted: int) -> None:
        """Resume a stream from a ChainState and its host counters."""
        self._state = state
        self._shape = tuple(state.stab.frame_ring.shape[1:3])
        self._frames_in, self._emitted = frames_in, emitted

    def process_device(self, frame) -> Optional[torch.Tensor]:
        """One step per frame; the processed frame as a device tensor (None
        during the stabilizer warm-up)."""
        frame = as_device_frame(frame, self.device)
        h, w = frame.shape[:2]
        if self._state is None:
            self._state = chain_state_init(self.params, h, w, self.device)
            self._shape = (h, w)
        elif self._shape != (h, w):
            raise ValueError("frame size changed; recreate the chain")
        p = self.params
        if p.mode.stabilizer_enabled and self._frames_in == 0:
            self._state = chain_init_step_fn(p, self._state, frame)
            self._frames_in = 1
            return None
        self._state, out, _ready = chain_gated_step_fn(
            p, self._state, frame, redetect_tick=self._frames_in,
            ransac_draws=self.ransac_draws)
        self._frames_in += 1
        if p.mode.stabilizer_enabled:
            if self._frames_in - self._emitted < \
                    p.stabilizer.effective_radius:
                return None
            self._emitted += 1
        return out

    def process(self, frame) -> Optional[np.ndarray]:
        out = self.process_device(frame)
        return None if out is None else out.cpu().numpy()

    def flush(self) -> Optional[np.ndarray]:
        """Drain one remaining look-ahead frame at end of stream."""
        p = self.params
        if (self._state is None or not p.mode.stabilizer_enabled
                or self._frames_in - self._emitted <= 0):
            return None
        self._state, out = chain_flush_step_fn(p, self._state)
        self._emitted += 1
        return out.cpu().numpy()

    def clean(self) -> None:
        self._state = None
        self._shape = None
        self._frames_in = 0
        self._emitted = 0


__all__ = ["ChainParams", "ChainState", "ProcessingChain",
           "chain_flush_step_fn", "chain_gated_step_fn", "chain_init_step_fn",
           "chain_state_from_numpy", "chain_state_init", "chain_step_fn"]
