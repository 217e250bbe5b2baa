"""Image operators of the PyTorch port (counterparts of video_stab_tpu/ops)."""
