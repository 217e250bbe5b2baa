"""Layer step: ``readings.launches_per_frame``, read in the cells
whose end-to-end metric is frame_latency_p95_ms."""

from benchmark_torch.readings import launches_per_frame as read  # noqa: F401
