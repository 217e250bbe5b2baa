"""Core streaming components of the PyTorch port (stabilizer, enhancer,
roll correction, fused chain)."""
