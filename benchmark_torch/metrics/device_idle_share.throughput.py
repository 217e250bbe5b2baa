"""Layer device: ``readings.device_idle_share``, read in the cells
whose end-to-end metric is frames_per_s."""

from benchmark_torch.readings import device_idle_share as read  # noqa: F401
