"""PyTorch/CUDA port of video_stab_tpu.

The package mirrors ``video_stab_tpu``'s layout and names (``ops/``,
``motion/``, ``core/``, and ``kernels/`` in place of ``pallas/``), so that
``video_stab_tpu_torch/ops/lk.py`` is the counterpart of
``video_stab_tpu/ops/lk.py``. It imports ``torch`` and ``numpy`` and never
``jax``.

Every function takes and returns tensors on one device. The streaming
wrappers (``core.stabilizer.Stabilizer``, ``core.chain.ProcessingChain``)
pick that device once, from ``ModeParams.use_cuda`` (:func:`pick_device`).
The hand-written CUDA kernels (``csrc/``: K1 to K5b, one for each Pallas
kernel of the JAX package) run on CUDA tensors; a CPU tensor takes each
kernel's plain PyTorch version (``kernels/``). The deep-stabilization
network (``models/``) reads the JAX package's bundled flax checkpoint by
path, with a msgpack reader of its own.

Entry points: ``core.stabilizer.Stabilizer`` (streaming, similarity or
homography model, every detector, deep stabilization, the virtual
canvas), ``core.legacy.LegacyStabilizer`` (the legacy deterministic
stabilizer), ``core.chain.ProcessingChain`` (the fused serving chain),
``offline.stabilize_clip`` (whole-clip stabilization),
``parallel.MultiStreamStabilizer`` (lockstep streams), and the
application: ``io.runner.StabilizerApp`` (``vstab-torch run``: the YAML
config with hot reload over the frame graph or the compressed-domain
packet graph, with the object tracker of ``models.tracker``), the host
codec layer (``native/``, ``io.codec``: H.264 / H.265 over the system's
libavcodec, built at first use), the RTSP server (``io.rtsp``) and the
CLI (``cli.py``).

Importing the package turns TF32 off for matmuls and cuDNN convolutions:
the filters, resizes and LK's normal equations need full float32.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def pick_device(use_cuda: bool) -> torch.device:
    """The device a stream runs on: CUDA when ``use_cuda``, else the CPU.

    There is no silent fallback: ``use_cuda=True`` without a CUDA device
    raises."""
    if not use_cuda:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("use_cuda=True but torch finds no CUDA device; "
                           "pass ModeParams(use_cuda=False) to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


__all__ = ["pick_device"]
