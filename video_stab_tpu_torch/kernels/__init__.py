"""Hand-written CUDA kernels of the port, one module per Pallas kernel of
the JAX package (counterparts of ``video_stab_tpu/pallas/``):

- ``warp``     K1  affine warp, u8 -> u8          (pallas/warp.py)
- ``features`` K3  corner response + peak mask    (pallas/features.py)
- ``enhance``  K4  pointwise enhancer, u8 -> u8   (pallas/enhance.py)

Each module holds the kernel's wrapper, its plain PyTorch version and a
module-level launch counter ``LAUNCHES``, which the wrapper increments once
per kernel launch and nowhere else. A wrapper given a CUDA tensor launches
the kernel or raises; a CPU tensor takes the plain version.

The sources live in ``video_stab_tpu_torch/csrc/`` and are built on first
use by ``_lib.library()`` (one nvcc call, ``sm_90a``) into
``build/torch_kernels/`` of the checkout.
"""
