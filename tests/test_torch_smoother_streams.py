"""The port's streaming ``Stabilizer`` with each smoother and with the drone
high-frequency mode against the JAX package's, on the CPU.

44 small frames go through both packages' ``Stabilizer`` with the JAX
package's RANSAC draws injected, then ``flush()``. Held, at the tolerances
of ``test_torch_stabilizer.py``: identical ``ready`` sequences, per-frame
transforms within 1e-3 (times the largest entry for the 9-channel
log-homography), emitted u8 frames within 1 on >= 99.5 % of pixels; and
after the stream the smoother cursors (``kalman_x``, ``kalman_p``,
``butter_state``), the drone chain's ``hf`` state and the starvation
counter within 1e-3, flags and counters equal. The JAX state carried into
the port (``state_from_numpy``) holds every field, ``hf`` included.
"""

import cv2
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from test_torch_stabilizer import CPU, SMALL, JaxDraws, _close_frames, _run  # noqa: E402
from video_stab_tpu.core.params import StabilizerParams as JParams  # noqa: E402
from video_stab_tpu.core.stabilizer import Stabilizer as JStabilizer  # noqa: E402
from video_stab_tpu_torch.core.params import StabilizerParams  # noqa: E402
from video_stab_tpu_torch.core.stabilizer import Stabilizer  # noqa: E402
from video_stab_tpu_torch.core.state import (  # noqa: E402
    StabilizerState,
    state_from_numpy,
    state_to_numpy,
)
from video_stab_tpu_torch.motion.hf import HFState  # noqa: E402


def clip(n=44, seed=5):
    """A textured world seen through a jittering 96 x 128 window."""
    rng = np.random.default_rng(seed)
    world = cv2.GaussianBlur(rng.random((200, 300)).astype(np.float32),
                             (0, 0), 2.0)
    world = (world - world.min()) / (world.max() - world.min()) * 255.0
    frames = []
    for _ in range(n):
        dx, dy = rng.normal(0.0, 2.0, 2)
        m = np.float32([[1, 0, -(40 + dx)], [0, 1, -(40 + dy)]])
        f = cv2.warpAffine(world, m, (128, 96))
        frames.append(np.repeat(f[:, :, None], 3, 2).astype(np.uint8))
    return frames


STREAM_CASES = {
    "gaussian": {"smoothing_method": "gaussian"},
    "kalman": {"smoothing_method": "kalman"},
    "butterworth": {"smoothing_method": "butterworth",
                    "jitter_frequency": "low"},
    "drone": {"drone_high_freq_mode": True},
    "drone horizon lock kalman": {"drone_high_freq_mode": True,
                                  "horizon_lock": True,
                                  "smoothing_method": "kalman"},
    "homography kalman": {"motion_model": "homography",
                          "smoothing_method": "kalman"},
    # A larger analysis frame with ~35 tracked points (still starved, so
    # CLAHE runs): with the ~10 points of the small size the 8-DOF RANSAC
    # on equalized frames has ties between hypotheses that float32
    # rounding decides.
    "homography butterworth drone": {"motion_model": "homography",
                                     "smoothing_method": "butterworth",
                                     "drone_high_freq_mode": True,
                                     "analysis_width": 128,
                                     "analysis_height": 96,
                                     "max_corners": 64, "min_distance": 6.0},
    "homography gaussian": {"motion_model": "homography",
                            "smoothing_method": "gaussian",
                            "gaussian_sigma": 1.2},
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_stabilizer_smoothers_match_jax(case):
    """The homography model takes the drone mode's CLAHE and skips its HF
    chain, as the JAX package does."""
    kw = STREAM_CASES[case]
    frames = clip()
    jp = JParams(**{**SMALL, **kw})
    js = JStabilizer(jp)
    j_out, j_tr, j_fl = _run(js, frames)
    width = 4 if jp.motion_model == "homography" else 2
    port = Stabilizer(StabilizerParams(**{**SMALL, **kw}), mode=CPU,
                      ransac_draws=JaxDraws(jax.random.PRNGKey(jp.seed),
                                            jp.ransac_hypotheses,
                                            width=width))
    t_out, t_tr, t_fl = _run(port, frames)
    assert [o is None for o in t_out] == [o is None for o in j_out]
    scale = max(1.0, max(np.abs(b).max() for b in j_tr if b is not None))
    for a, b in zip(t_tr, j_tr):
        if b is not None:
            np.testing.assert_allclose(a, b, atol=1e-3 * scale, rtol=0)
    assert len(t_fl) == len(j_fl) == jp.effective_radius - 1
    pairs = list(zip([o for o in t_out if o is not None] + t_fl,
                     [o for o in j_out if o is not None] + j_fl))
    assert len(pairs) == len(frames)
    for a, b in pairs:
        assert a.shape == b.shape and a.dtype == np.uint8
        assert _close_frames(a, b) >= 0.995

    want, got = js.state_dict(), port.state_dict()
    for name in ("kalman_x", "kalman_p", "butter_state"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-3 * scale, err_msg=name)
    for name in HFState._fields:
        a, b = getattr(got["hf"], name), np.asarray(getattr(want.hf, name))
        if b.dtype == np.float32:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-3, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert int(got["starvation_counter"]) == int(want.starvation_counter)
    if "drone" in case and jp.motion_model != "homography":
        assert int(want.hf.n_history) == len(frames) - 1

    carried = state_to_numpy(state_from_numpy(want, "cpu"))
    for name in StabilizerState._fields:
        if name in ("key", "deepstab"):
            continue
        if name == "hf":
            for f in HFState._fields:
                np.testing.assert_array_equal(
                    getattr(carried["hf"], f),
                    np.asarray(getattr(want.hf, f)), err_msg=f)
        else:
            np.testing.assert_array_equal(
                carried[name], np.asarray(getattr(want, name)),
                err_msg=name)
