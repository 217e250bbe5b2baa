"""Parameter structs of the PyTorch port: copies of the slice's dataclasses.

Field for field the same names, order, defaults and properties as
``video_stab_tpu/core/params.py``; ``tests/test_torch_params.py`` holds the
copies to the originals. They are copied rather than imported because
importing ``video_stab_tpu.core.params`` runs ``video_stab_tpu/core/__init__``,
which imports JAX, and this package never imports JAX.

Knobs that exist for the TPU's layout (``warp_branch``, ``gftt_topk``,
``hough_impl``, ``hough_max_edges``, ``warp_envelope_deg``, ``use_pallas``)
are accepted and have no effect here, the way the JAX package accepts and
ignores ``use_cuda``. In this package ``ModeParams.use_cuda`` is live: it
picks the device (``video_stab_tpu_torch.pick_device``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


class FeatureDetector:
    """Feature detection method (Stabilizer.h:98-103)."""
    GFTT = "gftt"
    ORB = "orb"
    FAST = "fast"
    BRISK = "brisk"


class JitterFrequency:
    """Target jitter frequency for adaptive filtering (Stabilizer.h:142-147)."""
    LOW = "low"
    MEDIUM = "medium"
    HIGH = "high"
    ADAPTIVE = "adaptive"


@dataclasses.dataclass(frozen=True)
class StabilizerParams:
    """Stabilizer parameters (reference: include/video/Stabilizer.h:76-175)."""

    logging: bool = False

    smoothing_radius: int = 30
    max_corners: int = 200
    quality_level: float = 0.01
    min_distance: float = 30.0
    block_size: int = 3

    border_type: str = "black"       # black | reflect | reflect_101 | replicate | wrap | fade
    border_size: int = 0
    crop_n_zoom: bool = False
    # Static rotation envelope (deg) of the emit warp kernel: corrections
    # beyond it clamp (degrade, never crash). Post-smoothing corrections on
    # real shake are well under 1 deg; 3 keeps the warp's tap count - and
    # the per-frame cost, especially at 4K - half of what 6 costs. No
    # reference counterpart (cv::warpAffine has no envelope).
    warp_envelope_deg: float = 3.0
    # Extra emit-warp rotation budget (deg) for an AUXILIARY per-frame
    # rotation composed into the correction — the fused-chain roll path
    # (core/chain.py): queued frames stay unrotated and the roll rotation
    # merges with the stabilizing warp into one resample. 0.0 = feature
    # off, emit path bit-identical to the plain stabilizer.
    aux_rotation_deg: float = 0.0
    # Warp kernel branch selection: "auto" picks the small-rotation tap
    # table per frame via lax.cond; "large" compiles one full-envelope
    # kernel — the right choice for VMAPPED multi-stream serving, where
    # vmap lowers a batched-predicate cond to both-branches + select.
    warp_branch: str = "auto"
    # GFTT candidate extraction: "auto" = exact two-stage top_k with an
    # in-graph guard (lax.cond) falling back to the flat top_k; "flat"
    # forces the flat path; "staged" = cond-free single-branch two-stage
    # (statistically exact) — the right choice under vmap, where a
    # batched-predicate guard would run both branches (ops/features.py).
    gftt_topk: str = "auto"

    smoothing_method: str = "box"    # box | gaussian | kalman
    gaussian_sigma: float = 2.0
    # Declared true-by-default in the reference but DEAD there
    # (predictNextMotion never called): effective behavior is off. Here it
    # is LIVE (coarse global-translation LK prior, ops/lk.py) but defaults
    # off to match the reference's effective behavior — the prior costs
    # ~0.2 ms/frame and only pays off under large inter-frame motion
    # (fast pans beyond LK's top-level drift budget).
    motion_prediction: bool = False
    horizon_lock: bool = False

    feature_detector: str = FeatureDetector.GFTT
    orb_features: int = 500
    fast_threshold: int = 10

    use_roi: bool = False
    roi: Tuple[int, int, int, int] = (0, 0, 0, 0)   # x, y, w, h

    adaptive_smoothing: bool = False
    min_smoothing_radius: int = 5
    max_smoothing_radius: int = 50

    outlier_threshold: float = 3.0
    intentional_motion_threshold: float = 20.0

    stage_one_radius: int = 10
    stage_two_radius: int = 25
    use_temporal_filtering: bool = False
    temporal_window_size: int = 5

    fade_alpha: float = 0.1
    fade_duration: int = 30

    motion_threshold_low: float = 5.0
    motion_threshold_high: float = 20.0
    border_scale_factor: float = 2.0

    roll_compensation: bool = True
    roll_compensation_factor: float = 0.75

    deep_stabilization: bool = False
    model_path: str = ""

    jitter_frequency: str = JitterFrequency.ADAPTIVE
    separate_translation_rotation: bool = True
    use_imu_data: bool = False

    # Virtual canvas (Stabilizer.h:153-162)
    enable_virtual_canvas: bool = False
    canvas_scale_factor: float = 1.5
    temporal_buffer_size: int = 30
    canvas_blend_weight: float = 0.7
    adaptive_canvas_size: bool = True
    max_canvas_scale: float = 2.0
    min_canvas_scale: float = 1.2
    preserve_edge_quality: bool = True
    edge_blend_radius: int = 20

    # Drone high-frequency vibration suppression (Stabilizer.h:164-174)
    drone_high_freq_mode: bool = False
    hf_shake_px: float = 1.5
    hf_analysis_max_width: int = 960
    hf_rot_lp_alpha: float = 0.2
    enable_conditional_clahe: bool = True
    hf_dead_zone_threshold: float = 2.0
    hf_freeze_duration: int = 10
    hf_motion_accumulator_decay: float = 0.9

    # --- TPU-native knobs (no reference counterpart) ---------------------
    analysis_width: int = 960        # steady-state analysis resolution
    analysis_height: int = 540       # (Stabilizer.cpp:410 hardcodes 960x540)
    lk_window: int = 15              # LK window (Stabilizer.cpp:616)
    lk_levels: int = 2               # pyramid levels (Stabilizer.cpp:617)
    lk_iters: int = 20               # iterations (Stabilizer.cpp:618)
    ransac_threshold: float = 5.0    # reproj thresh px (Stabilizer.cpp:566)
    ransac_hypotheses: int = 500     # iterations (Stabilizer.cpp:566)
    redetect_interval: int = 2       # feature re-detect cadence (Stabilizer.cpp:697)
    motion_model: str = "similarity"  # similarity (4-DOF, reference) | homography (8-DOF log-sl(3))
    seed: int = 0                    # stream PRNG seed for RANSAC
    use_pallas: bool = True          # fused Pallas kernels on TPU where profitable
    # Scale the applied similarity correction's translation from analysis
    # pixels to full-frame pixels at emit. The reference estimates dx/dy on
    # the 960x540 analysis frame and warps the FULL-RES frame with them
    # unscaled (transforms_ push, Stabilizer.cpp:660-673; warp matrix,
    # Stabilizer.cpp:901-907) — at 1080p that under-corrects translation 2x
    # (4x at 4K), leaving half the translational shake in the output. True
    # applies the evident intent (full-magnitude correction; path-space
    # heuristics — intent, HF chain, adaptive radius — still run in
    # analysis units); False reproduces the reference quirk bit-for-bit.
    # The homography model always conjugates to full res at estimation.
    full_res_corrections: bool = True

    @property
    def effective_radius(self) -> int:
        """clamp(smoothing_radius, 5, 35) — the look-ahead queue depth
        (Stabilizer.cpp:383)."""
        return max(5, min(self.smoothing_radius, 35))

    @property
    def border_pad(self) -> int:
        """Static border padding applied before the warp."""
        return self.border_size if self.border_size > 0 else 0


@dataclasses.dataclass(frozen=True)
class LegacyStabilizerParams:
    """Parameters consumed by the legacy deterministic path
    (src/Stabilizer_legacy.cpp). Shares the Stabilizer parameter names; only
    the subset the legacy implementation reads, plus its hardcoded constants
    (Stabilizer_legacy.cpp:28-32) exposed as parameters."""

    logging: bool = False
    smoothing_radius: int = 30
    max_corners: int = 200
    quality_level: float = 0.01
    min_distance: float = 30.0
    block_size: int = 3
    border_type: str = "reflect_101"   # legacy default (Stabilizer_legacy.cpp:451)
    border_size: int = 0
    crop_n_zoom: bool = False

    # Hardcoded constants in the reference, parameterized here:
    shake_threshold_px: float = 3.0        # SHAKE_THRESHOLD_PX
    rotation_shake_rad: float = 0.03       # ROTATION_SHAKE_RAD
    shake_damping_factor: float = 0.15     # SHAKE_DAMPING_FACTOR
    min_tracking_features: int = 30        # MIN_TRACKING_FEATURES
    outlier_threshold: float = 15.0        # OUTLIER_THRESHOLD
    feature_border_margin: int = 20        # detectInitialFeatures border (legacy:180)
    redetect_interval: int = 30            # periodic re-detect (legacy:277)

    lk_window: int = 21                    # legacy:222
    lk_levels: int = 3
    lk_iters: int = 30
    lk_eps: float = 0.01
    lk_err_threshold: float = 30.0         # err < 30 filter (legacy:229)

    @property
    def effective_radius(self) -> int:
        """min(smoothing_radius, 30) — legacy look-ahead (legacy:126)."""
        return min(self.smoothing_radius, 30)

    @property
    def box_radius(self) -> int:
        """Box kernel half-width: kernel size clamp(smoothing_radius,5,30)/2
        (legacy:61-62, 422)."""
        return max(5, min(self.smoothing_radius, 30)) // 2


@dataclasses.dataclass(frozen=True)
class RollCorrectionParams:
    """Roll correction parameters (include/video/RollCorrection.h:16-38)."""

    scale_factor: float = 0.25           # downscale before edge detect (RollCorrection.cpp:35)
    canny_threshold_low: float = 50.0    # RollCorrection.cpp:54
    canny_threshold_high: float = 150.0
    canny_aperture: int = 3
    hough_threshold: int = 100           # RollCorrection.cpp:66-73
    angle_smoothing_alpha: float = 0.1   # exponential smoothing (RollCorrection.cpp:129)
    angle_decay: float = 0.995           # drift decay toward zero (RollCorrection.cpp:135)
    angle_filter_min: float = -10.0      # line angle acceptance band deg (RollCorrection.cpp:113-119)
    angle_filter_max: float = 10.0
    max_angle_change: float = 0.5        # per-frame clamp deg (RollCorrection.cpp:131-133)

    # TPU-native knobs
    hough_rho: float = 1.0
    hough_theta_deg: float = 1.0
    max_lines: int = 64
    hough_impl: str = "auto"       # "auto" = exact edge-compaction fast
    #                                path w/ in-graph dense fallback;
    #                                "dense" pins the per-theta sweep
    #                                (for vmapped callers; ops/hough.py)
    hough_max_edges: int = 16384   # sparse-path capacity


@dataclasses.dataclass(frozen=True)
class EnhancerParams:
    """Image enhancement parameters (include/video/Enhancer.h:11-43)."""

    brightness: float = 0.0          # additive beta (Enhancer.cpp convertTo)
    contrast: float = 1.0            # multiplicative alpha
    enable_white_balance: bool = False
    wb_strength: float = 1.0         # gray-world correction strength
    enable_vibrance: bool = False
    vibrance_strength: float = 0.3   # HSV saturation boost
    enable_unsharp: bool = False
    sharpness: float = 0.0           # unsharp amount (Enhancer.h default 0.0)
    blur_sigma: float = 1.0          # unsharp gaussian sigma
    enable_denoise: bool = False
    denoise_strength: float = 10.0   # fastNlMeans h -> bilateral strength
    enable_clahe: bool = False
    clahe_clip_limit: float = 2.0
    clahe_tile_grid_size: int = 8
    gamma: float = 1.0               # LUT gamma (Enhancer.cpp:171-180)
    use_cuda: bool = False           # accepted for config parity; ignored (ModeParams.use_cuda picks the device)


@dataclasses.dataclass(frozen=True)
class AutoZoomCropParams:
    """Auto zoom-crop parameters (src/AutoZoomCrop.cpp). The reference's
    only declared knob ``marginPercent`` (AutoZoomCrop.h:15, default 5%) is
    DEAD in its implementation — the parameter name is commented out of
    the definition (AutoZoomCrop.cpp:102 ``double /*marginPercent*/``) and
    never read. Accepted here for config parity with the same inert
    behavior (wiring it would also break the no-black passthrough
    identity, tested in test_core.py). The output size is hardcoded
    640x360 in the reference (AutoZoomCrop.cpp:246-270); exposed here."""

    enabled: bool = False                # pair with roll correction (roll-correction-file.cpp:61-68)
    margin_percent: float = 5.0          # parsed, inert (dead in the reference too — see docstring)
    content_threshold: float = 10.0      # black-border threshold (AutoZoomCrop.cpp:122)
    morph_kernel: int = 5                # morphological close (AutoZoomCrop.cpp:130-139)
    out_width: int = 640                 # hardcoded 640x360 (AutoZoomCrop.cpp:246)
    out_height: int = 360
    keep_input_size: bool = False        # TPU-native: resize back to input size instead


@dataclasses.dataclass(frozen=True)
class ModeParams:
    """Top-level mode toggles (include/video/Mode.h:9-18)."""

    width: int = 1920
    height: int = 1080
    optimize_fps: bool = True
    use_cuda: bool = True       # picks the device: True = CUDA (raises without one)
    enhancer_enabled: bool = False
    roll_correction_enabled: bool = False
    stabilizer_enabled: bool = False
    tracker_enabled: bool = False
