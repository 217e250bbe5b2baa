"""Layer step: ``spans.nms_rounds_per_frame``, read in the cells whose
end-to-end metric is frames_per_s."""

from benchmark_torch.spans import nms_rounds_per_frame as read  # noqa: F401
