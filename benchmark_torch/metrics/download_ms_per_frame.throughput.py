"""Layer wrappers: ``spans.download_ms_per_frame``, read in the cells whose
end-to-end metric is frames_per_s."""

from benchmark_torch.spans import download_ms_per_frame as read  # noqa: F401
