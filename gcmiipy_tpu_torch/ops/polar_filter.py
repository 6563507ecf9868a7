"""Arakawa & Lamb 1977 polar zonal low-pass filter.

Port of ``gcmiipy_tpu/ops/polar_filter.py:arakawa_1977``: near the poles
zonal wavenumber ``n`` is damped by the static per-geometry mask
``Geom.polar_mask`` in rFFT space along longitude.  ``torch.fft`` takes the
place of the XLA FFT, outside any kernel, as in the JAX package.  The inverse
length is pinned to ``n=I`` so odd widths work (reference low_pass.py:77
breaks there).
"""

import torch


def arakawa_1977(q, geom):
    """Filter ``q`` ([j,i] or [k,j,i]) along longitude (reference low_pass.py:41-78)."""
    width = q.shape[-1]
    if width == 1:  # (reference low_pass.py:58-59)
        return q
    f_q = torch.fft.rfft(q, dim=-1) * geom.polar_mask.to(q.dtype)
    return torch.fft.irfft(f_q, n=width, dim=-1).to(q.dtype)
