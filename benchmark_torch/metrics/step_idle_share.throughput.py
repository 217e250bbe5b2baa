"""Layer device: ``spans.step_idle_share``, read in the cells whose
end-to-end metric is frames_per_s."""

from benchmark_torch.spans import step_idle_share as read  # noqa: F401
