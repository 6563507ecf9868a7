"""model layer of the PyTorch port (mirrors gcmiipy_tpu.model)."""
