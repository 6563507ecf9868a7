"""C-grid shift / average / difference operators (periodic, roll-based).

Port of ``gcmiipy_tpu/ops/stencil.py``: pure periodic shifts built on
``torch.roll``.  Arrays are ``[k, j, i]`` (layer, latitude, longitude), with
``[j, i]`` for surface fields; the axes count from the end so the same
function serves both.  ``h`` is the half point, ``m`` minus one, ``p`` plus
one; U lives at (i+1/2, j), V at (i, j+1/2) (reference coordinates_3d.py:7-27).
"""

import torch

i_axis = -1
j_axis = -2
k_axis = -3


def ip(q):
    """q at i+1 (periodic)."""
    return torch.roll(q, -1, dims=-1)


def im(q):
    """q at i-1 (periodic)."""
    return torch.roll(q, 1, dims=-1)


def iph_1d(q):
    """q averaged to i+1/2."""
    return (q + ip(q)) * 0.5


def imh_1d(q):
    """q averaged to i-1/2."""
    return (q + im(q)) * 0.5


def div_1d(q_h, dx):
    """Divergence at the cell center of an edge quantity (reference
    coordinates_1d.py:41)."""
    return (q_h - im(q_h)) / dx


def divu_1d(q_h, dx):
    """Centered divergence (reference coordinates_1d.py:45)."""
    return (ip(q_h) - im(q_h)) / (2 * dx)


def gradh_1d(q_i, dx):
    """Gradient at the half point of a centered quantity (reference
    coordinates_1d.py:49)."""
    return (ip(q_i) - q_i) / dx


def ipj(q):
    """q at (i+1, j)."""
    return torch.roll(q, -1, dims=i_axis)


def imj(q):
    """q at (i-1, j)."""
    return torch.roll(q, 1, dims=i_axis)


def ijp(q):
    """q at (i, j+1)."""
    return torch.roll(q, -1, dims=j_axis)


def ijm(q):
    """q at (i, j-1)."""
    return torch.roll(q, 1, dims=j_axis)


def imjp(q):
    """q at (i-1, j+1) (reference coordinates.py:48)."""
    return imj(ijp(q))


def kp(q):
    """q at layer k+1 (periodic in k; callers rely on boundary terms being zero)."""
    return torch.roll(q, -1, dims=k_axis)


def km(q):
    """q at layer k-1."""
    return torch.roll(q, 1, dims=k_axis)


def kph(q):
    return (q + kp(q)) * 0.5


def kmh(q):
    return (q + km(q)) * 0.5


def iph(q):
    return (q + ipj(q)) * 0.5


def imh(q):
    return (q + imj(q)) * 0.5


def jph(q):
    return (q + ijp(q)) * 0.5


def jmh(q):
    return (q + ijm(q)) * 0.5


def gradi(q_i, dx):
    """Gradient at (i+1/2, j) of a centered quantity."""
    return (ipj(q_i) - q_i) / dx


def gradj(q_j, dy):
    """Gradient at (i, j+1/2) of a centered quantity."""
    return (ijp(q_j) - q_j) / dy
