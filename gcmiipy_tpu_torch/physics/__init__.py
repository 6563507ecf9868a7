"""physics layer of the PyTorch port (mirrors gcmiipy_tpu.physics)."""
