"""grid layer of the PyTorch port (mirrors gcmiipy_tpu.grid)."""
