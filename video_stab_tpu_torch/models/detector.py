"""Object detector — the nvinfer stage of the DeepStreamTracker counterpart;
port of ``video_stab_tpu/models/detector.py``.

A small anchor-free (CenterNet-style) detector: seven 3x3 convolutions
without bias (two at stride 2, so the maps are at stride 4), each followed
by GroupNorm(8) in float32 and ReLU, then three 1x1 float32 heads: the
class heatmap, the box size and the center offset. The 3x3 convolutions
run in ``DetectorConfig.dtype`` (bfloat16 by default). Like the deep
stabilization network's, they are library convolutions (cuDNN on the
card), as the JAX package computes them with XLA outside any Pallas
kernel. Flax's SAME padding at stride 2 depends on the input's parity, so
each convolution pads explicitly.

``detect`` decodes a fixed K: the 3x3 max-pool peak mask, the sigmoid, the
K best of the (Hs, Ws, C) map in the JAX package's flat NHWC order, with
equal scores ordered by the lower index as ``jax.lax.top_k`` orders them,
and the box decode at stride 4.

Weights come from the JAX package's flax checkpoints
(``detector_from_flax``, ``load_detector``), read by
``models/flax_msgpack.py``. Without a checkpoint, ``create_detector`` draws
untrained weights from a ``torch.Generator`` seeded with ``seed`` (flax's
initializers; the JAX package's ``PRNGKey(seed)`` draws are not
reproducible here). Each of them places the model on its ``device``
argument; None means CUDA, raising without a card.

Default classes mirror TrafficCamNet's: car, bicycle, person, roadsign.
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
from video_stab_tpu_torch.models.deepstab import _GN_EPS, _lecun_normal, \
    _same_pad

TRAFFICCAMNET_LABELS = ("car", "bicycle", "person", "roadsign")

# Output stride of the backbone (CenterNet convention).
STRIDE = 4

BUNDLED_WEIGHTS = "centernet_traffic.msgpack"
# The heatmap head's bias at initialization (flax constant -2.19).
_HEAT_BIAS_INIT = -2.19


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Model hyperparameters. Defaults give a ~1M-param detector sized for
    the reference's 640x384 processing resolution."""

    num_classes: int = len(TRAFFICCAMNET_LABELS)
    widths: tuple = (32, 64, 128, 256)
    head_width: int = 128
    max_detections: int = 100        # maxTrackedObjects default
    dtype: Any = torch.bfloat16      # the 3x3 convolutions' compute dtype


class ConvBlock(nn.Module):
    """3x3 convolution without bias (SAME padding), GroupNorm(8) in
    float32, ReLU."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 dtype: Any = torch.bfloat16):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(features, in_features, 3, 3))
        self.norm = nn.GroupNorm(8, features, eps=_GN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph = _same_pad(x.shape[2], stride=self.stride)
        pw = _same_pad(x.shape[3], stride=self.stride)
        x = F.pad(x.to(self.dtype), (pw[0], pw[1], ph[0], ph[1]))
        x = F.conv2d(x, self.kernel.to(self.dtype), stride=self.stride)
        return F.relu(self.norm(x.to(torch.float32)))


class CenterNetDetector(nn.Module):
    """Backbone (stride 4) + center heatmap / size / offset heads.

    Input: (B, H, W, 3) float32, already scaled to [-1, 1]. Output: the
    heads as (B, C, Hs, Ws) float32 maps."""

    def __init__(self, cfg: DetectorConfig = DetectorConfig()):
        super().__init__()
        self.cfg = cfg
        w1, w2, w3, w4 = cfg.widths
        plan = ((3, w1, 2), (w1, w1, 1), (w1, w2, 2), (w2, w2, 1),
                (w2, w3, 1), (w3, w4, 1), (w4, cfg.head_width, 1))
        self.blocks = nn.ModuleList(ConvBlock(cin, cout, s, cfg.dtype)
                                    for cin, cout, s in plan)
        self.heatmap = nn.Conv2d(cfg.head_width, cfg.num_classes, 1)
        self.size = nn.Conv2d(cfg.head_width, 2, 1)
        self.offset = nn.Conv2d(cfg.head_width, 2, 1)

    def forward(self, x: torch.Tensor) -> dict:
        x = x.permute(0, 3, 1, 2)
        for block in self.blocks:
            x = block(x)
        return {"heatmap": self.heatmap(x), "size": self.size(x),
                "offset": self.offset(x)}


def _ready(model: CenterNetDetector, device) -> CenterNetDetector:
    """Eval mode, no gradients, on ``device``: CUDA when None (raising
    without a card), as every entry point of the port."""
    device = pick_device(True) if device is None else torch.device(device)
    return model.eval().requires_grad_(False).to(device)


def create_detector(cfg: DetectorConfig = DetectorConfig(), seed: int = 0,
                    height: int = 384, width: int = 640,
                    device: Optional[torch.device] = None
                    ) -> CenterNetDetector:
    """An untrained detector, its weights drawn from ``seed`` with flax's
    initializers (LeCun normal kernels, unit GroupNorm scales, zero biases,
    the heatmap bias at -2.19). ``height`` / ``width`` are the processing
    size the JAX package initializes at; the weights do not depend on it.
    """
    del height, width
    g = torch.Generator().manual_seed(int(seed))
    model = CenterNetDetector(cfg)
    with torch.no_grad():
        for block in model.blocks:
            k = block.kernel
            k.copy_(_lecun_normal(k.shape, k.shape[1] * 9, g))
        for head in (model.heatmap, model.size, model.offset):
            head.weight.copy_(_lecun_normal(head.weight.shape,
                                            head.weight.shape[1], g))
            head.bias.zero_()
        model.heatmap.bias.fill_(_HEAT_BIAS_INIT)
    return _ready(model, device)


def detector_from_flax(tree: dict, cfg: DetectorConfig = DetectorConfig(),
                       device: Optional[torch.device] = None
                       ) -> CenterNetDetector:
    """A CenterNetDetector holding the JAX package's flax parameters
    ({"params": {"ConvBlock_i": {"Conv_0": {"kernel"}, "GroupNorm_0":
    {"scale", "bias"}}, "Conv_0..2": {"kernel", "bias"}}} of numpy
    arrays): kernels HWIO -> OIHW."""
    p = tree["params"]

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    state = {}
    for i in range(7):
        blk = p[f"ConvBlock_{i}"]
        state[f"blocks.{i}.kernel"] = t(blk["Conv_0"]["kernel"]).permute(
            3, 2, 0, 1)
        state[f"blocks.{i}.norm.weight"] = t(blk["GroupNorm_0"]["scale"])
        state[f"blocks.{i}.norm.bias"] = t(blk["GroupNorm_0"]["bias"])
    for i, head in enumerate(("heatmap", "size", "offset")):
        state[f"{head}.weight"] = t(p[f"Conv_{i}"]["kernel"]).permute(
            3, 2, 0, 1)
        state[f"{head}.bias"] = t(p[f"Conv_{i}"]["bias"])
    model = CenterNetDetector(cfg)
    model.load_state_dict({k: v.contiguous() for k, v in state.items()})
    return _ready(model, device)


def load_detector(path: str, cfg: DetectorConfig = DetectorConfig(),
                  height: int = 384, width: int = 640, seed: int = 0,
                  device: Optional[torch.device] = None
                  ) -> CenterNetDetector:
    """A detector from a flax msgpack checkpoint (the JAX package's
    ``save_detector``). ``height`` / ``width`` / ``seed`` shape the JAX
    package's template only; the file holds every weight."""
    del height, width, seed
    return detector_from_flax(flax_msgpack.load(path), cfg, device)


def bundled_weights_path() -> str:
    """The JAX package's bundled traffic-detector weights, read by path as
    a data file."""
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
            __file__)))), "video_stab_tpu", "models", "weights",
        BUNDLED_WEIGHTS)


def _nms_peaks(heat: torch.Tensor) -> torch.Tensor:
    """3x3 max-pool NMS on the class heatmaps (B, C, Hs, Ws); the pool's
    padding is -inf, as flax's SAME max_pool."""
    pooled = F.max_pool2d(heat, 3, stride=1, padding=1)
    return torch.where(heat >= pooled, heat,
                       torch.full_like(heat, float("-inf")))


@torch.no_grad()
def detect(model: CenterNetDetector, frames, score_threshold: float = 0.5,
           max_detections: int = 100) -> dict:
    """Forward + decode.

    frames: (B, H, W, 3) float32 in [0, 255] (a tensor or an array; it is
    moved to the model's device). Returns a dict of (B, K) tensors:
    class_id, score, and (B, K, 4) bboxes in x, y, w, h pixels, plus a
    validity mask (score > threshold)."""
    device = next(model.parameters()).device
    frames = torch.as_tensor(frames, dtype=torch.float32, device=device)
    out = model(frames / 127.5 - 1.0)
    heat = torch.sigmoid(_nms_peaks(out["heatmap"]))
    b, c, hs, ws = heat.shape
    # The JAX package's flat order: (Hs, Ws, C), class fastest.
    flat = heat.permute(0, 2, 3, 1).reshape(b, -1)
    # A stable descending sort keeps equal scores in index order, as
    # jax.lax.top_k does (torch.topk does not promise an order for ties).
    scores, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    scores, idx = scores[:, :max_detections], idx[:, :max_detections]
    cls = idx % c
    pix = idx // c
    gy = (pix // ws).to(torch.float32)
    gx = (pix % ws).to(torch.float32)

    def gather_map(m):
        m = m.permute(0, 2, 3, 1).reshape(b, hs * ws, -1)
        return torch.gather(m, 1, pix[..., None].expand(-1, -1, m.shape[-1]))

    sizes = gather_map(out["size"])           # (B, K, 2)
    offs = gather_map(out["offset"])          # (B, K, 2)
    cx = (gx + offs[..., 0]) * STRIDE
    cy = (gy + offs[..., 1]) * STRIDE
    bw = torch.clamp(sizes[..., 0], min=0.0) * STRIDE
    bh = torch.clamp(sizes[..., 1], min=0.0) * STRIDE
    bbox = torch.stack([cx - bw / 2, cy - bh / 2, bw, bh], dim=-1)
    return {
        "class_id": cls.to(torch.int32),
        "score": scores,
        "bbox": bbox,
        "valid": scores > score_threshold,
    }


__all__ = ["TRAFFICCAMNET_LABELS", "STRIDE", "CenterNetDetector",
           "ConvBlock", "DetectorConfig", "bundled_weights_path",
           "create_detector", "detect", "detector_from_flax",
           "load_detector"]
