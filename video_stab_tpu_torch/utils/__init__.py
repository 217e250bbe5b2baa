"""Config (the reference's YAML schema + hot reload), stream-state
checkpoints and telemetry of the port (``video_stab_tpu/utils`` in the JAX
package; its XLA compile cache has no counterpart here)."""
