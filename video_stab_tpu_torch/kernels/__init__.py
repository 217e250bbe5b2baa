"""Hand-written CUDA kernels of the port, one module per Pallas kernel of
the JAX package (counterparts of ``video_stab_tpu/pallas/``):

- ``warp``     K1  affine warp, u8 -> u8          (pallas/warp.py)
               K2  projective warp, u8 -> u8      (pallas/warp.py)
- ``features`` K3  corner response + peak mask    (pallas/features.py)
- ``enhance``  K4  pointwise enhancer, u8 -> u8   (pallas/enhance.py)
- ``traj``     K5a trajectory box filter (median-padded, left window)
               K5b centered count-normalized box filter (pallas/traj.py)
- ``lk``       K6  pyramidal LK Newton ladder, one launch (the in-kernel
               LK probes K6a-K6d, tools/lk_kernel_proto.py and
               tools/lk_inkernel_probe.py)

Each module holds the kernels' wrappers, their plain PyTorch versions and
a module-level launch counter per kernel (``warp.LAUNCHES`` and
``warp.HOMOGRAPHY_LAUNCHES``, ``features.LAUNCHES``, ``enhance.LAUNCHES``,
``traj.CONVOLVE_LAUNCHES``, ``traj.CENTERED_LAUNCHES`` and
``lk.LAUNCHES``), which the
kernel's wrapper increments once per launch and nowhere else. A wrapper
given a CUDA tensor launches the kernel or raises; a CPU tensor takes the
plain version.

The sources live in ``video_stab_tpu_torch/csrc/`` and are built on first
use by ``_lib.library()`` (one ``nvcc -c`` per source, started together,
then one link; ``sm_90a``) into ``build/torch_kernels/`` of the checkout.
"""

from video_stab_tpu_torch.kernels.traj import (  # noqa: F401
    box_filter_centered,
    box_filter_convolve,
)
from video_stab_tpu_torch.kernels.warp import (  # noqa: F401
    warp_affine_u8,
    warp_homography_u8,
)

__all__ = ["box_filter_centered", "box_filter_convolve", "warp_affine_u8",
           "warp_homography_u8"]
