"""The PyTorch port's CenterNet detector (``models/detector.py``) against the
JAX package's, on the CPU, with the JAX parameters carried across by
``detector_from_flax``.

Held: the three heads within 1e-4 in a float32 ``DetectorConfig`` and
within 2e-2 in bfloat16 (the 3x3 convolutions' partial sums round as
oneDNN rounds them, not as XLA); ``detect``'s valid detections identical
in float32 (the same class ids in the same order, scores within 1e-5,
boxes within 1e-3 px). A score within 1e-4 of the threshold could flip
``valid`` on rounding alone, so each case first checks that no JAX score
lies that close; in bfloat16 only the maps are compared.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from video_stab_tpu.models import detector as jdet  # noqa: E402
from video_stab_tpu_torch.models import detector as tdet  # noqa: E402
from video_stab_tpu_torch.models import flax_msgpack  # noqa: E402

H, W = 64, 96
K = 32
THRESHOLD = 0.2
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(seed, dtype, **cfg):
    jd, td, _tol = DTYPES[dtype]
    model, params = jdet.create_detector(
        jdet.DetectorConfig(dtype=jd, max_detections=K, **cfg), seed=seed,
        height=H, width=W)
    port = tdet.detector_from_flax(
        _np(params), tdet.DetectorConfig(dtype=td, max_detections=K, **cfg),
        device="cpu")
    return model, params, port


def _frames(n, h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 255.0, (n, h, w, 3)).astype(np.float32)


def _heads_close(model, params, port, x, tol):
    want = model.apply(params, x / 127.5 - 1.0)
    got = port(torch.from_numpy(x) / 127.5 - 1.0)
    for name in ("heatmap", "size", "offset"):
        a = np.asarray(want[name], np.float32)
        b = got[name].permute(0, 2, 3, 1).numpy()
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= tol, (name, np.abs(a - b).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("seed", [0, 1])
def test_heads_match_jax(seed, dtype):
    model, params, port = _pair(seed, dtype)
    _heads_close(model, params, port, _frames(2, seed=seed),
                 DTYPES[dtype][2])


@pytest.mark.parametrize("hw", [(61, 95), (33, 50)])
def test_same_padding_at_odd_sizes(hw):
    """Flax pads (1, 1) at stride 2 on an odd axis and (0, 1) on an even
    one: the heads agree at odd and mixed sizes too."""
    model, params, port = _pair(0, "float32")
    _heads_close(model, params, port, _frames(1, *hw, seed=3), 1e-4)


def _valid(out, i):
    v = np.asarray(out["valid"][i])
    return (np.asarray(out["class_id"][i])[v], np.asarray(out["score"][i])[v],
            np.asarray(out["bbox"][i])[v])


def _detections_equal(want, got, n, threshold=THRESHOLD):
    for i in range(n):
        scores = np.asarray(want["score"][i])
        assert np.abs(scores - threshold).min() > 1e-4
        wc, ws, wb = _valid(want, i)
        gc, gs, gb = _valid({k: v.numpy() for k, v in got.items()}, i)
        assert len(wc) > 0
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_allclose(gs, ws, atol=1e-5, rtol=0)
        np.testing.assert_allclose(gb, wb, atol=1e-3, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_detect_matches_jax(seed):
    model, params, port = _pair(seed, "float32")
    x = _frames(2, seed=seed + 10)
    want = jdet.detect(model, params, x, THRESHOLD, K)
    got = tdet.detect(port, x, THRESHOLD, K)
    assert got["class_id"].dtype == torch.int32
    assert tuple(got["bbox"].shape) == (2, K, 4)
    _detections_equal(want, got, 2)


def test_equal_scores_keep_index_order():
    """With every head's kernel zeroed the heatmap is one constant, every
    pixel is its own 3x3 peak and all scores tie: jax.lax.top_k takes the
    lowest flat (Hs, Ws, C) indices first, and so must the port."""
    model, params, _port = _pair(0, "float32")
    tree = _np(params)
    for head in ("Conv_0", "Conv_1", "Conv_2"):
        tree["params"][head]["kernel"] = np.zeros_like(
            tree["params"][head]["kernel"])
    port = tdet.detector_from_flax(
        tree, tdet.DetectorConfig(dtype=torch.float32, max_detections=K),
        device="cpu")
    x = _frames(1, seed=5)
    want = jdet.detect(model, tree, x, 0.0, K)
    got = tdet.detect(port, x, 0.0, K)
    np.testing.assert_array_equal(got["class_id"].numpy(),
                                  np.asarray(want["class_id"]))
    np.testing.assert_array_equal(got["bbox"].numpy(),
                                  np.asarray(want["bbox"]))


@pytest.fixture(scope="module")
def bundled():
    path = jdet.bundled_weights_path()
    if not os.path.exists(path):
        pytest.skip("bundled detector weights not present")
    return path


def test_bundled_file_reads_as_flax_does(bundled):
    assert tdet.bundled_weights_path() == bundled
    _model, want = jdet.load_detector(bundled, height=H, width=W)
    got = flax_msgpack.load(bundled)
    wl, wdef = jax.tree_util.tree_flatten(_np(want))
    gl, gdef = jax.tree_util.tree_flatten(got)
    assert wdef == gdef
    for a, b in zip(wl, gl):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_bundled_detector_on_the_clip_matches_jax(bundled):
    """The bundled weights on tests/test_models.py's moving clip (one
    rendered car, 192x320), in a float32 config in both packages."""
    from video_stab_tpu.models.scenes import render_clip

    frames, _gt = render_clip(np.random.default_rng(31), n_frames=6,
                              h=192, w=320, n_objects=1, classes=(0,))
    x = np.stack(frames).astype(np.float32)
    cfg = jdet.DetectorConfig(dtype=jnp.float32)
    model, params = jdet.load_detector(bundled, cfg, height=192, width=320)
    port = tdet.load_detector(bundled, tdet.DetectorConfig(
        dtype=torch.float32), device="cpu")
    want = jdet.detect(model, params, x, 0.35, 100)
    got = tdet.detect(port, x, 0.35, 100)
    _detections_equal(want, got, len(frames), threshold=0.35)


def test_create_detector_is_seeded():
    a = tdet.create_detector(seed=3, device="cpu")
    b = tdet.create_detector(seed=3, device="cpu")
    c = tdet.create_detector(seed=4, device="cpu")
    for (name, pa), pb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.blocks[0].kernel, c.blocks[0].kernel)
    assert torch.all(a.heatmap.bias == -2.19)


@pytest.mark.parametrize("make", ["create", "flax", "load"])
def test_constructors_default_to_the_card(make, monkeypatch):
    """With no ``device``, every constructor places the model on CUDA and
    raises without a card; ``device="cpu"`` is the only way to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tdet.bundled_weights_path()
    build = {"create": lambda **kw: tdet.create_detector(**kw),
             "flax": lambda **kw: tdet.detector_from_flax(
                 flax_msgpack.load(path), **kw),
             "load": lambda **kw: tdet.load_detector(path, **kw)}[make]
    with pytest.raises(RuntimeError, match="use_cuda"):
        build()
    assert build(device="cpu").heatmap.weight.device.type == "cpu"
