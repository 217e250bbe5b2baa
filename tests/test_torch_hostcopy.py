"""The frame copies of the port's wrapper layer
(``video_stab_tpu_torch/utils/hostcopy.py``) on the CPU.

Held: on a CPU device ``to_device`` / ``to_host`` return what ``.to()`` /
``.cpu().numpy()`` return, for numpy frames, CPU tensors, views with
other strides, gray frames and (N, H, W, 3) batches; ``as_device_frame``
and ``as_device_frames`` return, and raise, what their copy lines did
before they took the helper; the wrappers deliver the same frames through
it; no pinned or pageable counter moves on a CPU device;
``start_to_host(t).numpy()`` is ``to_host(t)`` there; the numpy-facing
APIs (``Enhancer``, ``RollCorrection``, ``AutoZoomCrop``,
``LegacyStabilizer``) take one ``to_device`` and one ``to_host`` a frame
and deliver what their steps compute. The page-locked path runs only on
the card: ``tests/test_torch_cuda.py`` holds it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from video_stab_tpu_torch.core.autozoomcrop import (  # noqa: E402
    AutoZoomCrop,
    auto_zoom_crop_step,
)
from video_stab_tpu_torch.core.chain import ProcessingChain  # noqa: E402
from video_stab_tpu_torch.core.enhancer import (  # noqa: E402
    Enhancer,
    enhance_frame_u8,
)
from video_stab_tpu_torch.core.legacy import LegacyStabilizer  # noqa: E402
from video_stab_tpu_torch.core.params import (  # noqa: E402
    AutoZoomCropParams,
    EnhancerParams,
    LegacyStabilizerParams,
    ModeParams,
    RollCorrectionParams,
    StabilizerParams,
)
from video_stab_tpu_torch.core.rollcorrection import (  # noqa: E402
    RollCorrection,
    roll_correct_step,
    roll_state_init,
)
from video_stab_tpu_torch.core.stabilizer import (  # noqa: E402
    Stabilizer,
    as_device_frame,
)
from video_stab_tpu_torch.parallel import MultiStreamStabilizer  # noqa: E402
from video_stab_tpu_torch.parallel.multistream import (  # noqa: E402
    as_device_frames,
)
from video_stab_tpu_torch.utils import hostcopy, telemetry  # noqa: E402

CPU = torch.device("cpu")
H, W = 24, 40
COUNTERS = ("pinned_uploads", "pinned_downloads", "pinned_bytes",
            "pageable_copies")
SMALL = StabilizerParams(smoothing_radius=3, analysis_width=64,
                         analysis_height=48, max_corners=32,
                         ransac_hypotheses=32, redetect_interval=2)


def _u8(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _inputs():
    """name -> a frame or batch as a caller may hand it over."""
    frame = _u8((H, W, 3))
    batch = _u8((4, H, W, 3), 1)
    wide = _u8((2 * H, 3 * W, 3), 2)
    return {
        "numpy frame": frame,
        "cpu tensor": torch.from_numpy(frame.copy()),
        "strided view": wide[::2, ::3],
        "channel-reversed view": frame[..., ::-1],
        "column-major": np.asfortranarray(frame),
        "tensor view": torch.from_numpy(wide).permute(1, 0, 2)[::3, ::2],
        "float frame": frame.astype(np.float32),
        "gray frame": _u8((H, W), 3),
        "batch": batch,
        "batch of views": _u8((4, H, 2 * W, 3), 4)[:, :, ::2],
    }


INPUTS = _inputs()


def _old_upload(x, device):
    """The wrappers' upload before ``hostcopy``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.uint8)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8)).to(device)


def _old_as_device_frame(frame, device):
    t = _old_upload(frame, device)
    if t.dim() == 2:
        t = t[:, :, None].expand(-1, -1, 3)
    return t.contiguous()


def _old_as_device_frames(frames, device):
    t = _old_upload(frames, device)
    if t.dim() != 4 or t.shape[-1] != 3:
        raise ValueError(f"expected (N, H, W, 3) frames, got "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def _pin_counts():
    c = telemetry.counters()
    return {k: c.get(k, 0) for k in COUNTERS}


def _same(got, want):
    assert got.dtype == want.dtype and got.device == want.device
    assert tuple(got.shape) == tuple(want.shape)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", list(INPUTS))
def test_to_device_on_the_cpu_is_the_old_upload(name):
    """``to_device`` on a CPU device: the tensor the old ``.to()`` gave."""
    x = INPUTS[name]
    _same(hostcopy.to_device(x, CPU), _old_upload(x, CPU))


@pytest.mark.parametrize("name", ["numpy frame", "strided view", "batch",
                                  "gray frame", "tensor view"])
def test_to_host_on_the_cpu_is_cpu_numpy(name):
    """``to_host`` of a CPU tensor: what ``.cpu().numpy()`` gives, values,
    dtype and shape, for contiguous and strided tensors."""
    x = INPUTS[name]
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    got, want = hostcopy.to_host(t), t.cpu().numpy()
    assert isinstance(got, np.ndarray)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["numpy frame", "strided view", "batch",
                                  "gray frame", "tensor view"])
def test_start_to_host_on_the_cpu_is_to_host(name):
    """A download started off CUDA hands back what ``to_host`` gives, and
    the tensor it was made from."""
    x = INPUTS[name]
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    d = hostcopy.start_to_host(t)
    assert d.tensor is t
    got, want = d.numpy(), hostcopy.to_host(t)
    assert isinstance(got, np.ndarray)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["numpy frame", "cpu tensor",
                                  "strided view", "channel-reversed view",
                                  "tensor view", "float frame",
                                  "gray frame"])
def test_as_device_frame_is_unchanged(name):
    """``as_device_frame``: the old contiguous 3-channel frame, the gray
    one expanded."""
    x = INPUTS[name]
    got = as_device_frame(x, CPU)
    _same(got, _old_as_device_frame(x, CPU))
    assert got.is_contiguous() and got.shape[-1] == 3


@pytest.mark.parametrize("name", ["batch", "batch of views"])
def test_as_device_frames_is_unchanged(name):
    x = INPUTS[name]
    got = as_device_frames(x, CPU)
    _same(got, _old_as_device_frames(x, CPU))
    assert got.is_contiguous()


@pytest.mark.parametrize("bad", [
    np.zeros((H, W, 3), np.uint8),            # one frame, no stream axis
    np.zeros((2, H, W, 4), np.uint8),         # four channels
    np.zeros((2, 1, H, W, 3), np.uint8),      # an extra axis
    torch.zeros((2, H, W), dtype=torch.uint8),
])
def test_as_device_frames_raises_as_before(bad):
    """A bad shape raises the same ValueError, message and all."""
    with pytest.raises(ValueError) as old:
        _old_as_device_frames(bad, CPU)
    with pytest.raises(ValueError, match=r"expected \(N, H, W, 3\)") as new:
        as_device_frames(bad, CPU)
    assert str(new.value) == str(old.value)


@pytest.mark.parametrize("bad", [np.array([["a", "b"]]),
                                 np.array([[object()]], dtype=object)])
def test_as_device_frame_raises_as_before(bad):
    """A frame numpy cannot make uint8 raises what it raised before."""
    with pytest.raises(Exception) as old:
        _old_as_device_frame(bad, CPU)
    with pytest.raises(type(old.value)) as new:
        as_device_frame(bad, CPU)
    assert str(new.value) == str(old.value)


def _chain():
    return ProcessingChain(
        ModeParams(use_cuda=False, enhancer_enabled=True,
                   roll_correction_enabled=True, stabilizer_enabled=True),
        EnhancerParams(brightness=5.0, contrast=1.1, gamma=0.9),
        RollCorrectionParams(hough_threshold=30), SMALL)


@pytest.mark.parametrize("wrapper", ["chain", "multistream", "stabilizer"])
def test_no_pin_counter_moves_on_the_cpu(wrapper):
    """A stream through each wrapper on a CPU device, to its flush: frames
    delivered, and not one pinned or pageable copy counted."""
    rng = np.random.default_rng(7)
    if wrapper == "multistream":
        obj = MultiStreamStabilizer(SMALL, 2, mode=ModeParams(use_cuda=False))
        call, flush = obj.stabilize_batch, obj.flush_batch
        frames = rng.integers(0, 256, (8, 2, 96, 128, 3), np.uint8)
    else:
        obj = _chain() if wrapper == "chain" else \
            Stabilizer(SMALL, mode=ModeParams(use_cuda=False))
        call = obj.process if wrapper == "chain" else obj.stabilize
        flush = obj.flush
        frames = rng.integers(0, 256, (8, 96, 128, 3), np.uint8)
    before = _pin_counts()
    outs = [call(f) for f in frames]
    outs.append(flush())
    assert any(o is not None for o in outs)
    assert _pin_counts() == before


def _per_frame_api(api):
    """(call(frame) -> delivered frames, the same frames computed by the
    API's step functions on tensors) for one numpy-facing API."""
    if api == "enhancer":
        p = EnhancerParams(brightness=5.0, contrast=1.1, gamma=0.9)
        return (lambda f: [Enhancer.enhance_image(f, p, device="cpu")],
                lambda f: [enhance_frame_u8(p, torch.from_numpy(f))[0]])
    if api == "roll":
        p = RollCorrectionParams(hough_threshold=30)
        rc, state = RollCorrection(p, device="cpu"), [roll_state_init(CPU)]

        def want(f):
            state[0], out = roll_correct_step(p, state[0], torch.from_numpy(f))
            return [out]
        return lambda f: [rc.auto_correct_roll(f)], want
    if api == "azc":
        p = AutoZoomCropParams(enabled=True)
        return (lambda f: [AutoZoomCrop.apply(f, p, device="cpu")],
                lambda f: [auto_zoom_crop_step(p, torch.from_numpy(f))])
    p = LegacyStabilizerParams(smoothing_radius=2, max_corners=32,
                               min_distance=4.0, min_tracking_features=4)
    got = LegacyStabilizer(p, mode=ModeParams(use_cuda=False))
    twin = LegacyStabilizer(p, mode=ModeParams(use_cuda=False))

    def call(f):
        if f is None:
            return [got.flush(), got.flush()]
        return [got.stabilize(f)]

    def want(f):
        if f is None:
            return [twin._emit() if twin._queued > 0 else None
                    for _ in range(2)]
        return [twin.stabilize_device(f)]
    return call, want


@pytest.mark.parametrize("api", ["enhancer", "roll", "azc", "legacy"])
def test_numpy_apis_copy_through_hostcopy(api, monkeypatch):
    """Each numpy-facing API uploads each frame with one ``to_device`` and
    downloads each delivered frame with one ``to_host``, and delivers the
    frames its steps compute."""
    counts = {"up": 0, "down": 0}
    up, down = hostcopy.to_device, hostcopy.to_host

    def count_up(x, device):
        counts["up"] += 1
        return up(x, device)

    def count_down(t):
        counts["down"] += 1
        return down(t)

    call, want = _per_frame_api(api)
    frames = [_u8((48, 64, 3), seed) for seed in range(6)]
    # None: the legacy stream's flush.
    inputs = frames + [None] if api == "legacy" else frames
    monkeypatch.setattr(hostcopy, "to_device", count_up)
    monkeypatch.setattr(hostcopy, "to_host", count_down)
    got = [o for f in inputs for o in call(f)]
    monkeypatch.undo()
    wanted = [o for f in inputs for o in want(f)]
    assert [o is None for o in got] == [o is None for o in wanted]
    delivered = [(a, b) for a, b in zip(got, wanted) if a is not None]
    assert counts == {"up": len(frames), "down": len(delivered)}
    assert len(delivered) >= 4
    for a, b in delivered:
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, b.numpy())
