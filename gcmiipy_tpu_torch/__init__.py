"""gcmiipy_tpu_torch: the PyTorch / CUDA port of gcmiipy_tpu.

A second package beside the JAX one, held against it by the tests.  Plain
tensor code is PyTorch; each Pallas kernel of the JAX package on the ported
path is a hand-written CUDA kernel under ``csrc/``, built with ``nvcc`` at
first use.  Entry points run on the GPU (``device="cuda"``) unless the caller
asks for the CPU; a missing GPU is an error, never a silent CPU run.
"""

__version__ = "0.1.0"
