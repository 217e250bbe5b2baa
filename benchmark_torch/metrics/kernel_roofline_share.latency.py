"""Layer kernels: ``readings.kernel_roofline_share``, read in the cells
whose end-to-end metric is frame_latency_p95_ms."""

from benchmark_torch.readings import (  # noqa: F401
    kernel_roofline_share as read)
