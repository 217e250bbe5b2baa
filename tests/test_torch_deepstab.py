"""The port's deep-stabilization network (``video_stab_tpu_torch/models/``)
against the JAX package's flax one, on the CPU.

Held: the port's msgpack reader gives the same tree as
``flax.serialization.msgpack_restore`` on both bundled weight files and on
a tree of every type it decodes; ``DeepStabNet`` with
``deepstab_from_flax`` against flax on the bundled weights, within 1e-4 in
a float32 config and within 2e-2 (absolute, on outputs of a few px) in the
bfloat16 default, where XLA's and oneDNN's bfloat16 convolutions round
their partial sums apart; flax's SAME padding at stride 2; the seeded
fallback network; and deep-stabilization streams through both packages'
``Stabilizer`` and ``ProcessingChain``: in the float32 config every
emitted pixel within 1 level and the transforms within 1e-3, in the
bfloat16 default the transforms within 2e-2 and >= 98 % of the pixels
within 1 level.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from test_torch_smoother_streams import clip  # noqa: E402
from test_torch_stabilizer import CPU, SMALL, _close_frames, _run  # noqa: E402
from video_stab_tpu.core import chain as jchain  # noqa: E402
from video_stab_tpu.core import params as jparams  # noqa: E402
from video_stab_tpu.core.stabilizer import Stabilizer as JStabilizer  # noqa: E402
from video_stab_tpu.models import deepstab as jdeep  # noqa: E402
from video_stab_tpu_torch.core import chain as tchain  # noqa: E402
from video_stab_tpu_torch.core import params as tparams  # noqa: E402
from video_stab_tpu_torch.core import stabilizer as tstab  # noqa: E402
from video_stab_tpu_torch.models import deepstab as tdeep  # noqa: E402
from video_stab_tpu_torch.models import flax_msgpack  # noqa: E402

WEIGHTS = os.path.join(os.path.dirname(jdeep.__file__), "weights")
F32 = tdeep.DeepStabConfig(dtype=torch.float32)
_JConfig = jdeep.DeepStabConfig
BF16_BOUND = 2e-2


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _same_tree(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=str(path))


@pytest.mark.parametrize("name", sorted(os.listdir(WEIGHTS)))
def test_msgpack_reader_matches_flax(name):
    path = os.path.join(WEIGHTS, name)
    with open(path, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    _same_tree(flax_msgpack.load(path), want)


def test_msgpack_reader_decodes_every_type():
    rng = np.random.default_rng(0)
    tree = {"f32": rng.random((3, 4)).astype(np.float32),
            "i64": np.arange(300, dtype=np.int64),
            "u8": np.arange(70000 % 251, dtype=np.uint8),
            "bf16": jnp.asarray(rng.random(5), jnp.bfloat16),
            "scalar": np.asarray(2.5, np.float32), "small": 7, "neg": -3,
            "big": 2 ** 40, "f": 0.125, "s": "name" * 10, "t": True,
            "none": None, "list": [1, 2.0, "x"],
            "nested": {str(i): np.full((2,), i, np.int32) for i in range(20)}}
    data = serialization.msgpack_serialize(tree)
    got = flax_msgpack.loads(data)
    want = serialization.msgpack_restore(data)
    assert got["bf16"].dtype == np.float32
    np.testing.assert_array_equal(got["bf16"],
                                  np.asarray(want["bf16"], np.float32))
    got.pop("bf16")
    want.pop("bf16")
    assert got["none"] is None and want["none"] is None
    _same_tree(got, want)


def test_same_padding_follows_parity():
    assert tdeep._same_pad(540) == (0, 1)
    assert tdeep._same_pad(135) == (1, 1)
    assert tdeep._same_pad(96) == (0, 1)


def _flax_out(tree, x, dtype):
    net = jdeep.DeepStabNet(jdeep.DeepStabConfig(dtype=dtype))
    params = {"params": jax.tree_util.tree_map(jnp.asarray, tree["params"])}
    return np.asarray(jax.jit(net.apply)(params, jnp.asarray(x)))


@pytest.mark.parametrize("hw", [(96, 160), (48, 64), (135, 241)])
def test_net_matches_flax(hw):
    tree = flax_msgpack.load(tdeep.BUNDLED_WEIGHTS)
    rng = np.random.default_rng(hw[0])
    x = (rng.random((2, *hw, 2)) * 255).astype(np.float32)
    for jdt, cfg, tol in ((jnp.float32, F32, 1e-4),
                          (jnp.bfloat16, tdeep.DeepStabConfig(), BF16_BOUND)):
        want = _flax_out(tree, x, jdt)
        with torch.no_grad():
            got = tdeep.deepstab_from_flax(tree, cfg)(torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == (2, 3)
        np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)
    assert np.abs(want).max() > 0.1          # the trained net predicts motion


def test_seeded_fallback(monkeypatch):
    monkeypatch.setattr(tdeep, "BUNDLED_WEIGHTS", "/nonexistent.msgpack")
    p = tparams.StabilizerParams(deep_stabilization=True, seed=5)
    a = tdeep.resolve_deepstab_weights(p, "cpu")
    b = tdeep.resolve_deepstab_weights(p, "cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert a.convs[0].abs().sum() > 0
    x = torch.rand(1, 48, 64, 2) * 255
    assert torch.equal(a(x), torch.zeros(1, 3))    # zero output kernel
    c = tdeep.resolve_deepstab_weights(
        tparams.StabilizerParams(deep_stabilization=True, seed=6), "cpu")
    assert not torch.equal(a.convs[0], c.convs[0])


def test_weights_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="use_cuda"):
        tdeep.resolve_deepstab_weights(
            tparams.StabilizerParams(deep_stabilization=True))


def _float32_nets(monkeypatch):
    """Both packages' Stabilizer and chain on the float32 network config."""
    monkeypatch.setattr(jdeep, "DeepStabConfig",
                        functools.partial(_JConfig, dtype=jnp.float32))

    def resolve(params, device=None):
        return tdeep.load_deepstab(params.model_path or tdeep.BUNDLED_WEIGHTS,
                                   F32).to(device or "cpu")
    monkeypatch.setattr(tstab, "resolve_deepstab_weights", resolve)
    monkeypatch.setattr(tchain, "resolve_deepstab_weights", resolve)


@pytest.mark.parametrize("float32", [True, False])
def test_deep_stream_matches_jax(float32, monkeypatch):
    # A seed of each config's own keeps the JAX step's jit cache apart.
    kw = dict(SMALL, deep_stabilization=True, seed=101 if float32 else 102)
    if float32:
        _float32_nets(monkeypatch)
    frames = clip(20)
    j_out, j_tr, j_fl = _run(JStabilizer(jparams.StabilizerParams(**kw)),
                             frames)
    port = tstab.Stabilizer(tparams.StabilizerParams(**kw), mode=CPU)
    t_out, t_tr, t_fl = _run(port, frames)
    assert isinstance(port._state.deepstab, tdeep.DeepStabNet)
    assert [o is None for o in t_out] == [o is None for o in j_out]
    tol = 1e-3 if float32 else BF16_BOUND
    for a, b in zip(t_tr, j_tr):
        if b is not None:
            np.testing.assert_allclose(a, b, atol=tol, rtol=0)
    assert len(t_fl) == len(j_fl) > 0
    for a, b in zip([o for o in t_out if o is not None] + t_fl,
                    [o for o in j_out if o is not None] + j_fl):
        if float32:
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        else:
            assert _close_frames(a, b) >= 0.98


def _chain_params(pm, **stab):
    return dict(
        mode=pm.ModeParams(roll_correction_enabled=False,
                           stabilizer_enabled=True),
        enhancer=pm.EnhancerParams(), roll=pm.RollCorrectionParams(),
        stabilizer=pm.StabilizerParams(**SMALL, **stab))


def test_deep_chain_matches_jax(monkeypatch):
    _float32_nets(monkeypatch)
    stab = dict(deep_stabilization=True, seed=103)
    frames = clip(16)
    jc = jchain.ProcessingChain(**_chain_params(jparams, **stab))
    p = _chain_params(tparams, **stab)
    p["mode"] = tparams.ModeParams(use_cuda=False,
                                   roll_correction_enabled=False,
                                   stabilizer_enabled=True)
    tc = tchain.ProcessingChain(**p)
    outs = [(tc.process(f), jc.process(f)) for f in frames]
    while (a := tc.flush()) is not None:
        outs.append((a, jc.flush()))
    assert jc.flush() is None
    assert isinstance(tc._state.stab.deepstab, tdeep.DeepStabNet)
    emitted = [(a, b) for a, b in outs if b is not None]
    assert [a is None for a, _ in outs] == [b is None for _, b in outs]
    assert len(emitted) == len(frames)
    for a, b in emitted:
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
