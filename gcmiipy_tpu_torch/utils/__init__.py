"""utils layer of the PyTorch port (mirrors gcmiipy_tpu.utils)."""
