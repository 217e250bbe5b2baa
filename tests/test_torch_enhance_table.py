"""K4's table identity, on the CPU.

K4 (``video_stab_tpu_torch/csrc/enhance.cu``) evaluates the enhancer's
pointwise stages once per u8 value and channel into a table, and looks each
pixel up in it. Here that table, built from ``enhance_pointwise``, gathered
per pixel, is held bit for bit against ``enhance_u8_plain``, and against the
JAX package's ``enhance_frame`` at the tolerance of
``tests/test_torch_ops.py::test_enhance_u8_matches_enhance_frame_saturate``.

On the CPU, PyTorch evaluates ``pow`` over a tensor with a vector routine
for whole vector blocks and with libm's ``powf`` for the rest, and the two
can differ in the last bit. So both sides of the bit-for-bit test evaluate
each value alone (a 3-element tensor, below any vector block): the table
one u8 value at a time, the plain version one pixel at a time. On the card
both are one ``powf``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from video_stab_tpu.core import enhancer as jenh  # noqa: E402
from video_stab_tpu.core.params import EnhancerParams as JEnhancerParams  # noqa: E402
from video_stab_tpu.ops import color as jcolor  # noqa: E402
from video_stab_tpu_torch.core.params import EnhancerParams  # noqa: E402
from video_stab_tpu_torch.kernels import enhance as kenh  # noqa: E402
from video_stab_tpu_torch.ops.color import bgr_to_gray, saturate_u8  # noqa: E402

CASES = {
    "entry": dict(brightness=5.0, contrast=1.1, gamma=0.9),
    "wb": dict(brightness=10.0, contrast=1.2, gamma=0.8,
               enable_white_balance=True, wb_strength=0.5),
    "gamma off": dict(brightness=-7.0, contrast=1.3, gamma=1.0005),
    "cb off": dict(gamma=0.7),
    "all off": dict(gamma=1.0),
    "wb, cb off": dict(gamma=1.6, enable_white_balance=True,
                       wb_strength=1.0),
}
SHAPES = [(7, 9), (13, 5), (1, 1), (17, 31)]   # odd pixel counts


def _frame(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (*shape, 3), dtype=np.uint8))


def _gather(table, frame):
    """(H, W, 3) float32: table[c][frame[..., c]] per pixel."""
    idx = frame.long()
    return torch.stack([table[c][idx[..., c]] for c in range(3)], dim=-1)


def _table(params, wb):
    """(3, 256) float32: ``enhance_pointwise`` of each u8 value alone, per
    channel: the table K4 builds and looks every pixel up in."""
    rows = [kenh.enhance_pointwise(
        params, torch.full((1, 1, 3), float(u)), wb)[0, 0] for u in range(256)]
    return torch.stack(rows).t().contiguous()


def _plain_per_pixel(params, frame, wb):
    """``enhance_u8_plain`` of each pixel alone: (u8 frame, gray)."""
    h, w, _ = frame.shape
    px = [kenh.enhance_u8_plain(params, frame[i:i + 1, j:j + 1], wb, True)
          for i in range(h) for j in range(w)]
    out = torch.cat([o for o, _ in px]).reshape(h, w, 3)
    gray = torch.cat([g.reshape(1) for _, g in px]).reshape(h, w)
    return out, gray


def _scales(params, frame):
    return kenh.white_balance_scales(frame, params.wb_strength) \
        if params.enable_white_balance else None


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", list(CASES))
def test_table_lookup_matches_plain_bit_for_bit(case, shape):
    params = EnhancerParams(**CASES[case])
    frame = _frame(shape, seed=sum(shape))
    wb = _scales(params, frame)
    table = _table(params, wb)
    assert table.shape == (3, 256) and table.dtype == torch.float32
    v = _gather(table, frame)
    out, gray = _plain_per_pixel(params, frame, wb)
    assert torch.equal(saturate_u8(v), out)
    assert torch.equal(bgr_to_gray(v), gray)


@pytest.mark.parametrize("case", list(CASES))
def test_table_lookup_matches_enhance_frame(case):
    """The table path against the JAX enhancer, at K4's tolerance: u8
    within 1 on >= 99.9 % identical values, gray within 1e-3."""
    kw = CASES[case]
    frame = _frame((24, 40), seed=5)
    params = EnhancerParams(**kw)
    v = _gather(_table(params, _scales(params, frame)), frame)
    f = jenh.enhance_frame(JEnhancerParams(**kw),
                           jnp.asarray(frame.numpy(), jnp.float32))
    want = np.asarray(jcolor.saturate_u8(f)).astype(int)
    d = np.abs(saturate_u8(v).numpy().astype(int) - want)
    assert d.max() <= 1, d.max()
    assert (d == 0).mean() >= 0.999, (d == 0).mean()
    np.testing.assert_allclose(bgr_to_gray(v).numpy(),
                               np.asarray(jcolor.bgr_to_gray(f)),
                               atol=1e-3, rtol=0)
