"""Motion estimation and trajectory filtering of the PyTorch port."""
