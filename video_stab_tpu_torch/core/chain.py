"""Fused processing chain: enhance -> roll-correct -> stabilize, one step
per frame — port of ``video_stab_tpu/core/chain.py``.

With roll fusion active (the ``__graft_entry__.entry()`` configuration)
a step is: K4 enhances the frame and yields its gray; the roll angle is
estimated from that gray; only the ANALYSIS-scale gray is rotated (K1);
the frame is queued unrotated and the roll rotation is composed into the
stabilizer's emit warp (K1), one full-res resample in all.

Otherwise (the two-pass order: roll bands wider than 15 deg, auto
zoom-crop, the homography model, borders) the enhanced frame, saturated
by K4 (its tail mode with the full enhancer), is rotated whole by K1 with
BORDER_REPLICATE, auto zoom-cropped when asked, and handed to the
stabilizer. The roll angle is estimated from K4's gray of the unsaturated
frame, as the JAX package estimates it from the float frame. In the
<= 15 deg band the JAX warp quantizes its input to u8 too, so K1 matches
it exactly; in the wider band the JAX package warps (and zoom-crops) the
unsaturated float, and the port's frame may differ from it by one level.

``_pre`` picks the route once a step. ``output_format="i420"`` converts
each delivered frame to planar I420 on the device.
``ProcessingChain(pipelined=True)`` hands back each frame one call late:
frame i - 1's copy to the host (``hostcopy.start_to_host``) runs while
frame i is computed.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from video_stab_tpu_torch import pick_device
from video_stab_tpu_torch.core.autozoomcrop import auto_zoom_crop_f32
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
    check_supported as check_stabilizer_supported,
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
from video_stab_tpu_torch.kernels.warp import warp_affine_u8
from video_stab_tpu_torch.models.deepstab import resolve_deepstab_weights
from video_stab_tpu_torch.ops.color import (
    bgr_to_gray,
    bgr_to_i420,
    saturate_u8,
)
from video_stab_tpu_torch.ops.warp import (
    BORDER_REPLICATE,
    rotation_matrix_2d,
    warp_affine_fast,
)
from video_stab_tpu_torch.utils import hostcopy, telemetry


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
    """Raise NotImplementedError for stabilizer values the port does not
    know, when the chain runs the stabilizer."""
    if params.mode.stabilizer_enabled:
        check_stabilizer_supported(params.stabilizer)


def chain_state_init(params: ChainParams, height: int, width: int,
                     device: torch.device) -> ChainState:
    """The chain's state; with deep stabilization the network's weights are
    resolved into it (``models.deepstab.resolve_deepstab_weights``)."""
    stab = stabilizer_state_init(params.stabilizer, height, width, device)
    if params.stabilizer.deep_stabilization:
        stab = stab._replace(deepstab=resolve_deepstab_weights(
            params.stabilizer, device))
    return ChainState(roll=roll_state_init(device), stab=stab)


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
    """The two-pass pre-stages: enhance (K4) and, with roll correction,
    estimate the angle from the unsaturated frame's gray, rotate the
    saturated frame whole (K1, BORDER_REPLICATE) and auto zoom-crop it.
    Returns (roll_state, u8 frame)."""
    roll_on = params.mode.roll_correction_enabled
    if params.mode.enhancer_enabled:
        with telemetry.trace("vstab.enhance"):
            f_u8, gray = enhance_frame_u8(params.enhancer, frame_u8,
                                          want_gray=roll_on)
    else:
        f_u8 = frame_u8
        gray = bgr_to_gray(frame_u8.float()) if roll_on else None
    if not roll_on:
        return state.roll, f_u8
    with telemetry.trace("vstab.roll"):
        roll_state = estimate_roll_angle(params.roll, state.roll, gray)
        h, w = f_u8.shape[:2]
        rot = rotation_matrix_2d(w / 2.0, h / 2.0, roll_state.smoothed_angle)
        f_u8 = warp_affine_u8(f_u8, rot, border_mode=BORDER_REPLICATE)
        if params.azc.enabled:
            with telemetry.trace("vstab.azc"):
                f_u8 = saturate_u8(auto_zoom_crop_f32(
                    params.azc, f_u8.float(), keep_input_size=True))
    return roll_state, f_u8


def _pre_stages_fused(params: ChainParams, state: ChainState,
                      frame_u8: torch.Tensor):
    """Single-resample roll: estimate the roll angle, rotate only the
    ANALYSIS-scale gray, and hand back the UNROTATED enhanced frame plus the
    angle. Returns (roll_state, frame_u8, alpha, gray_rot)."""
    if params.mode.enhancer_enabled:
        with telemetry.trace("vstab.enhance"):
            f_u8, gray_full = enhance_frame_u8(params.enhancer, frame_u8,
                                               want_gray=True)
    else:
        f_u8, gray_full = frame_u8, bgr_to_gray(frame_u8.float())
    with telemetry.trace("vstab.roll"):
        roll_state = estimate_roll_angle(params.roll, state.roll, gray_full)
        alpha = roll_state.smoothed_angle
        h, w = frame_u8.shape[:2]
        sp = params.stabilizer
        gray = _analysis_gray(sp, gray_full)
        # Rotation about the full-res center conjugated into analysis
        # space, A = S R S^-1 (exact for anisotropic analysis scaling).
        sx = sp.analysis_width / w
        sy = sp.analysis_height / h
        r = rotation_matrix_2d(w / 2.0, h / 2.0, alpha)
        a_mat = torch.stack([
            torch.stack([r[0, 0], r[0, 1] * (sx / sy), r[0, 2] * sx]),
            torch.stack([r[1, 0] * (sy / sx), r[1, 1], r[1, 2] * sy]),
        ])
        # alpha == 0 keeps the unrotated gray (the JAX identity skip) as a
        # select, so the warp always runs and nothing is read back.
        gray_rot = warp_affine_fast(gray, a_mat,
                                    border_mode=BORDER_REPLICATE)
        gray_rot = torch.where(alpha == 0.0, gray,
                               gray_rot.to(torch.float32))
    return roll_state, f_u8, alpha, gray_rot


def _deliver(params: ChainParams, out_u8: torch.Tensor) -> torch.Tensor:
    """The delivered format: planar I420 on the device for
    ``output_format="i420"``, else the BGR frame."""
    if params.output_format == "i420":
        with telemetry.trace("vstab.i420"):
            return bgr_to_i420(out_u8)
    return out_u8


def _pre(params: ChainParams, state: ChainState, frame_u8: torch.Tensor):
    """The pre-stages on the chain's roll route. Returns (roll_state,
    stabilizer params, u8 frame, the stabilizer steps' extra keywords):
    fused, ``stabilizer_eff`` and the angle and rotated analysis gray;
    two-pass, ``params.stabilizer`` and none."""
    if params.roll_fusion_active:
        roll_state, f, alpha, gray_rot = _pre_stages_fused(params, state,
                                                           frame_u8)
        return (roll_state, params.stabilizer_eff, f,
                dict(aux_roll=alpha, analysis_gray=gray_rot))
    roll_state, f = _pre_stages(params, state, frame_u8)
    return roll_state, params.stabilizer, f, {}


def chain_init_step_fn(params: ChainParams, state: ChainState,
                       frame_u8: torch.Tensor) -> ChainState:
    check_supported(params)
    roll_state, sp, f, kw = _pre(params, state, frame_u8)
    stab = stabilizer_init_step_fn(sp, state.stab, f, **kw)
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
    roll_state, sp, f, kw = _pre(params, state, frame_u8)
    if params.mode.stabilizer_enabled:
        stab, _metrics = stabilizer_analyze_step_fn(
            sp, state.stab, f, redetect_tick=redetect_tick,
            ransac_draws=ransac_draws, **kw)
        stab, out, ready = stabilizer_emit_gated_fn(sp, stab)
    else:
        stab, out = state.stab, f
        ready = torch.ones((), dtype=torch.bool, device=f.device)
    return ChainState(roll=roll_state, stab=stab), _deliver(params, out), \
        ready


def chain_analyze_step_fn(params: ChainParams, state: ChainState,
                          frame_u8: torch.Tensor,
                          redetect_tick: Optional[int] = None,
                          ransac_draws: RansacDraws = None) -> ChainState:
    """Warm-up variant: pre-stages + analyze without emitting, so the
    look-ahead queue fills to effective_radius."""
    check_supported(params)
    roll_state, sp, f, kw = _pre(params, state, frame_u8)
    stab, _metrics = stabilizer_analyze_step_fn(
        sp, state.stab, f, redetect_tick=redetect_tick,
        ransac_draws=ransac_draws, **kw)
    return ChainState(roll=roll_state, stab=stab)


def chain_flush_step_fn(params: ChainParams, state: ChainState
                        ) -> tuple[ChainState, torch.Tensor]:
    """Emit-only step: drain one frame from the look-ahead queue, through
    the delivered format."""
    stab, out = stabilizer_emit_step_fn(params.stabilizer_eff, state.stab)
    return ChainState(roll=state.roll, stab=stab), _deliver(params, out)


class ProcessingChain:
    """Streaming wrapper over the fused chain with the Stabilizer-style push
    API: returns None during the stabilizer warm-up, frames after.

    The device is picked once, from ``mode.use_cuda`` (CUDA by default,
    raising without one). ``ransac_draws``: see ``Stabilizer``.

    ``pipelined=True`` hands back each frame one call late: ``process``
    returns frame i - 1, whose device-to-host copy ran while frame i was
    computed (``hostcopy.start_to_host``). ``drain()`` fetches the last
    in-flight frame; ``flush()`` returns it first."""

    def __init__(self, mode: ModeParams, enhancer: EnhancerParams,
                 roll: RollCorrectionParams, stabilizer: StabilizerParams,
                 azc: Optional[AutoZoomCropParams] = None,
                 pipelined: bool = False, fuse_roll: bool = True,
                 output_format: str = "bgr",
                 ransac_draws: RansacDraws = None):
        if output_format not in ("bgr", "i420"):
            raise ValueError(f"unknown output_format {output_format!r}")
        self.params = ChainParams(mode=mode, enhancer=enhancer, roll=roll,
                                  stabilizer=stabilizer,
                                  azc=azc or AutoZoomCropParams(),
                                  fuse_roll=fuse_roll,
                                  output_format=output_format)
        check_supported(self.params)
        self.device = pick_device(mode.use_cuda)
        self.pipelined = pipelined
        self.ransac_draws = ransac_draws
        self._pending: Optional[hostcopy.Download] = None
        self._state: Optional[ChainState] = None
        self._shape = None
        # Host mirrors of the device's warm-up counters: steady state reads
        # nothing back from the device.
        self._frames_in = 0
        self._emitted = 0

    @property
    def state(self) -> Optional[ChainState]:
        return self._state

    def with_output_format(self, fmt: str) -> "ProcessingChain":
        """A fresh chain with the same params and another delivered format
        (the stream restarts: call before streaming)."""
        p = self.params
        return ProcessingChain(p.mode, p.enhancer, p.roll, p.stabilizer,
                               azc=p.azc, pipelined=self.pipelined,
                               fuse_roll=p.fuse_roll, output_format=fmt,
                               ransac_draws=self.ransac_draws)

    def load_state(self, state: ChainState, frames_in: int,
                   emitted: int) -> None:
        """Resume a stream from a ChainState and its host counters."""
        self._state = state
        self._shape = tuple(state.stab.frame_ring.shape[1:3])
        self._frames_in, self._emitted = frames_in, emitted

    def _step(self, frame) -> Optional[torch.Tensor]:
        """One chain step; the delivered frame on the device, or None
        during the stabilizer warm-up."""
        with telemetry.trace("vstab.upload"):
            frame = as_device_frame(frame, self.device)
        with telemetry.trace("vstab.step"):
            h, w = frame.shape[:2]
            if self._state is None:
                self._state = chain_state_init(self.params, h, w,
                                               self.device)
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

    def process_device(self, frame) -> Optional[torch.Tensor]:
        """One step per frame; the processed frame as a device tensor (None
        during the stabilizer warm-up, and on the first ready call when
        pipelined)."""
        out = self._step(frame)
        if out is None or not self.pipelined:
            return out
        prev, self._pending = self._pending, hostcopy.Download(out)
        return None if prev is None else prev.tensor

    def process(self, frame) -> Optional[np.ndarray]:
        with telemetry.trace("vstab.process"):
            out = self._step(frame)
            if out is None:
                return None
            with telemetry.trace("vstab.download"):
                if not self.pipelined:
                    return hostcopy.to_host(out)
                prev, self._pending = (self._pending,
                                       hostcopy.start_to_host(out))
                return None if prev is None else prev.numpy()

    def drain(self) -> Optional[np.ndarray]:
        """Pipelined mode: fetch the last in-flight frame."""
        prev, self._pending = self._pending, None
        if prev is None:
            return None
        with telemetry.trace("vstab.download"):
            return prev.numpy()

    def flush(self) -> Optional[np.ndarray]:
        """Drain one remaining look-ahead frame at end of stream; when
        pipelined, the in-flight frame comes first."""
        if self._pending is not None:
            return self.drain()
        p = self.params
        if (self._state is None or not p.mode.stabilizer_enabled
                or self._frames_in - self._emitted <= 0):
            return None
        self._state, out = chain_flush_step_fn(p, self._state)
        self._emitted += 1
        with telemetry.trace("vstab.download"):
            return hostcopy.to_host(out)

    def clean(self) -> None:
        self._state = None
        self._shape = None
        self._frames_in = 0
        self._emitted = 0
        self._pending = None


__all__ = ["ChainParams", "ChainState", "ProcessingChain",
           "chain_analyze_step_fn", "chain_flush_step_fn",
           "chain_gated_step_fn", "chain_init_step_fn",
           "chain_state_from_numpy", "chain_state_init"]
