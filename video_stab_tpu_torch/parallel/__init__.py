"""Multi-stream serving on one card (``video_stab_tpu/parallel`` in the JAX
package, without its device mesh)."""

from video_stab_tpu_torch.parallel.multistream import (  # noqa: F401
    MultiStreamStabilizer,
    batched_state_init,
    serve_remote_streams,
)

__all__ = ["MultiStreamStabilizer", "batched_state_init",
           "serve_remote_streams"]
