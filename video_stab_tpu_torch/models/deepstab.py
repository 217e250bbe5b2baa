"""Learned transform predictor — the deepStabilization hook; port of
``video_stab_tpu/models/deepstab.py``.

A small Siamese CNN regresses the inter-frame similarity transform
(dx, dy, da) from a stacked pair of analysis-resolution gray frames: four
stride-2 3x3 convolutions without bias, each followed by GroupNorm(8) and
ReLU, a global mean, Dense 256, ReLU, Dense 3, and the head scale
[10, 10, 0.1].

The convolutions and dense layers are library calls (``F.conv2d``,
``F.linear``), as the JAX package computes them outside any Pallas kernel,
in ``DeepStabConfig.dtype`` (bfloat16 by default); GroupNorm runs in
float32 with flax's epsilon. Flax's SAME padding at stride 2 depends on the
input's parity, so each convolution pads explicitly.

Weights come from the JAX package's flax checkpoints
(``deepstab_from_flax``), read by ``models/flax_msgpack.py``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from video_stab_tpu_torch import pick_device
from video_stab_tpu_torch.models import flax_msgpack

# The JAX package's bundled checkpoint, read by path as a data file.
BUNDLED_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "video_stab_tpu", "models", "weights",
    "deepstab_96x160.msgpack")

_GN_EPS = 1e-6                    # flax.linen.GroupNorm's default epsilon
_HEAD_SCALE = (10.0, 10.0, 0.1)   # translations in px, rotation in rad


@dataclasses.dataclass(frozen=True)
class DeepStabConfig:
    widths: tuple = (16, 32, 64, 128)
    dense_width: int = 256
    dtype: Any = torch.bfloat16


def _same_pad(n: int, k: int = 3, stride: int = 2) -> tuple[int, int]:
    """Flax / XLA SAME padding of one axis: (lo, hi)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class DeepStabNet(nn.Module):
    """Input: (B, H, W, 2) stacked [prev_gray, curr_gray] in [0, 255].
    Output: (B, 3) float32 — (dx, dy, da) in analysis px / radians."""

    def __init__(self, cfg: DeepStabConfig = DeepStabConfig()):
        super().__init__()
        self.cfg = cfg
        chans = (2,) + tuple(cfg.widths)
        self.convs = nn.ParameterList(
            nn.Parameter(torch.zeros(cout, cin, 3, 3))
            for cin, cout in zip(chans[:-1], chans[1:]))
        self.norms = nn.ModuleList(nn.GroupNorm(8, c, eps=_GN_EPS)
                                   for c in cfg.widths)
        self.dense0 = nn.Linear(cfg.widths[-1], cfg.dense_width)
        self.dense1 = nn.Linear(cfg.dense_width, 3)
        self.register_buffer("head_scale", torch.tensor(_HEAD_SCALE),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        x = (x.to(torch.float32) / 127.5 - 1.0).permute(0, 3, 1, 2)
        for kernel, norm in zip(self.convs, self.norms):
            ph, pw = _same_pad(x.shape[2]), _same_pad(x.shape[3])
            x = F.pad(x.to(dt), (pw[0], pw[1], ph[0], ph[1]))
            x = F.conv2d(x, kernel.to(dt), stride=2)
            x = F.relu(norm(x.to(torch.float32)))
        x = x.mean(dim=(2, 3))
        x = F.linear(x.to(dt), self.dense0.weight.to(dt),
                     self.dense0.bias.to(dt))
        x = F.relu(x)
        x = F.linear(x.to(torch.float32), self.dense1.weight,
                     self.dense1.bias)
        return x * self.head_scale


def deepstab_from_flax(tree: dict,
                       cfg: DeepStabConfig = DeepStabConfig()) -> DeepStabNet:
    """A DeepStabNet holding the JAX package's flax parameters ({"params":
    {"Conv_i": {"kernel"}, "GroupNorm_i": {"scale", "bias"}, "Dense_i":
    {"kernel", "bias"}}} of numpy arrays): conv kernels HWIO -> OIHW,
    dense kernels transposed."""
    p = tree["params"]

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    state = {}
    for i in range(len(cfg.widths)):
        state[f"convs.{i}"] = t(p[f"Conv_{i}"]["kernel"]).permute(3, 2, 0, 1)
        state[f"norms.{i}.weight"] = t(p[f"GroupNorm_{i}"]["scale"])
        state[f"norms.{i}.bias"] = t(p[f"GroupNorm_{i}"]["bias"])
    for i in range(2):
        state[f"dense{i}.weight"] = t(p[f"Dense_{i}"]["kernel"]).t()
        state[f"dense{i}.bias"] = t(p[f"Dense_{i}"]["bias"])
    net = DeepStabNet(cfg)
    net.load_state_dict({k: v.contiguous() for k, v in state.items()})
    return net.eval().requires_grad_(False)


def load_deepstab(path: str,
                  cfg: DeepStabConfig = DeepStabConfig()) -> DeepStabNet:
    """A DeepStabNet from a flax msgpack checkpoint (the JAX package's
    ``save_deepstab``)."""
    return deepstab_from_flax(flax_msgpack.load(path), cfg)


def seeded_deepstab(seed: int,
                    cfg: DeepStabConfig = DeepStabConfig()) -> DeepStabNet:
    """An untrained network from ``seed``: flax's initializers (LeCun
    normal kernels, unit scales, zero biases and a zero output kernel, so
    it predicts no motion) drawn from an explicit torch.Generator."""
    g = torch.Generator().manual_seed(int(seed))
    net = DeepStabNet(cfg)
    with torch.no_grad():
        for k in net.convs:
            fan_in = k.shape[1] * k.shape[2] * k.shape[3]
            k.copy_(_lecun_normal(k.shape, fan_in, g))
        net.dense0.weight.copy_(_lecun_normal(net.dense0.weight.shape,
                                              net.dense0.weight.shape[1], g))
        net.dense0.bias.zero_()
        net.dense1.weight.zero_()
        net.dense1.bias.zero_()
    return net.eval().requires_grad_(False)


def _lecun_normal(shape, fan_in: int, g: torch.Generator) -> torch.Tensor:
    """flax's lecun_normal: a normal truncated to +-2 std, variance
    1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    out = torch.empty(shape)
    nn.init.trunc_normal_(out, std=1.0, a=-2.0, b=2.0, generator=g)
    return out * std


def resolve_deepstab_weights(params, device: Optional[torch.device] = None
                             ) -> DeepStabNet:
    """The network for ``StabilizerParams`` with deep_stabilization on:
    ``params.model_path`` if set, else the bundled checkpoint, else an
    untrained network seeded from ``params.seed``. The convolutions are
    resolution-agnostic, so the bundled 96x160-trained weights serve any
    analysis size."""
    path = params.model_path or (BUNDLED_WEIGHTS
                                 if os.path.exists(BUNDLED_WEIGHTS) else "")
    net = load_deepstab(path) if path else seeded_deepstab(params.seed)
    return net.to(pick_device(True) if device is None else device)


def predict_transform(net: DeepStabNet, prev_gray: torch.Tensor,
                      curr_gray: torch.Tensor) -> torch.Tensor:
    """(H, W) pair -> (3,) transform; the LK + RANSAC path's contract. N
    streams' (N, H, W) pairs -> (N, 3) in one forward pass of the shared
    network (the multi-stream step, ``parallel/``)."""
    pair = torch.stack([prev_gray, curr_gray], dim=-1)
    return net(pair.reshape(-1, *pair.shape[-3:])).reshape(
        *pair.shape[:-3], 3)
