"""ops layer of the PyTorch port (mirrors gcmiipy_tpu.ops)."""
