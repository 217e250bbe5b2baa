"""Layer kernels: ``readings.kernel_roofline_share``, read in the cells
whose end-to-end metric is frames_per_s."""

from benchmark_torch.readings import (  # noqa: F401
    kernel_roofline_share as read)
