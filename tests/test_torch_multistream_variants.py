"""Each parameter the batched multi-stream step takes, on the CPU: stream i
of the port's batch against the port's own single-stream
``Stabilizer(seed = seed + i)`` on the same frames (which
tests/test_torch_stabilizer.py and the smoother, homography and deep
tests hold to the JAX package): the same readiness, transforms within
1e-5 (1e-4 for the homography model, whose batched ``eigh`` and
``matrix_exp`` sum in their own order) and frames within 1 on >= 99.9 %
of pixels. Upstream's drone mode (``configs/drone_hf.yaml``) at the small
size, whole and a stage at a time: its analysis at 256 x 192 so that the
``motion_prediction`` prior measures a shift (it needs >= 32 rows at
analysis / 2**lk_levels), 32 corners so that every frame counts as starved
and conditional CLAHE is selected from the fourth frame on.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from video_stab_tpu_torch.core.params import StabilizerParams  # noqa: E402
from video_stab_tpu_torch.core.stabilizer import Stabilizer  # noqa: E402
from video_stab_tpu_torch.parallel import MultiStreamStabilizer  # noqa: E402

from test_torch_stabilizer import CPU, SMALL, _close_frames  # noqa: E402

N, TICKS = 2, 12

# configs/drone_hf.yaml's stabilizer block, at the small size.
DRONE = {"drone_high_freq_mode": True, "motion_prediction": True,
         "horizon_lock": True, "crop_n_zoom": True, "border_size": 8,
         "border_type": "reflect_101", "smoothing_method": "gaussian",
         "gaussian_sigma": 15.0, "min_distance": 10.0, "hf_shake_px": 0.8,
         "hf_rot_lp_alpha": 0.1, "hf_dead_zone_threshold": 3.0,
         "hf_freeze_duration": 30, "hf_motion_accumulator_decay": 0.85,
         "analysis_width": 256, "analysis_height": 192}


@pytest.mark.parametrize("kw", [
    {"smoothing_method": "gaussian"},
    {"smoothing_method": "kalman"},
    {"smoothing_method": "butterworth"},
    {"adaptive_smoothing": True},
    {"horizon_lock": True, "full_res_corrections": False},
    {"redetect_interval": 3, "min_distance": 10.0},
    {"use_roi": True},
    {"motion_model": "homography", "smoothing_method": "kalman"},
    DRONE,
    {"motion_prediction": True, "analysis_width": 256,
     "analysis_height": 192},
    {"crop_n_zoom": True, "border_size": 8},
    {"drone_high_freq_mode": True, "enable_conditional_clahe": False},
    {**DRONE, "horizon_lock": False},
])
def test_batch_stream_equals_single_stream(jittered_clip, kw):
    frames, _ = jittered_clip
    clip = np.stack(frames[:TICKS])
    batches = np.ascontiguousarray(np.stack(
        [clip, np.ascontiguousarray(clip[:, ::-1])], axis=1))
    p = StabilizerParams(**{**SMALL, **kw})
    tol = 1e-4 if p.motion_model == "homography" else 1e-5
    ms = MultiStreamStabilizer(p, N, mode=CPU)
    singles = [Stabilizer(dataclasses.replace(p, seed=p.seed + i), mode=CPU)
               for i in range(N)]
    emitted = 0
    for b in batches:
        out = ms.stabilize_batch(b)
        so = [s.stabilize(b[i]) for i, s in enumerate(singles)]
        assert (out is None) == all(o is None for o in so)
        for i, s in enumerate(singles):
            if s.last_metrics:
                np.testing.assert_allclose(
                    ms.last_metrics["transform"][i].numpy(),
                    s.last_metrics["transform"].numpy(), atol=tol, rtol=0)
            if out is not None:
                assert _close_frames(out[i], so[i]) >= 0.999
        emitted += out is not None
    assert emitted == TICKS - p.effective_radius + 1
