"""Explicit viscosity / diffusion operators.

Port of ``gcmiipy_tpu/dynamics/viscosity.py`` (reference ``viscosity.py``):
the five-point Laplacian diffusion that damps the shallow-water-with-
temperature experiment (reference ``matsumo_temp.py:55``).
"""

from gcmiipy_tpu_torch.ops.stencil import ijm, ijp, imj, ipj


def finite_laplacian_2d(q, dx):
    """Five-point-stencil Laplacian (reference viscosity.py:12-19)."""
    top = ijp(q) + ijm(q) + ipj(q) + imj(q) - 4 * q
    return top / (dx * dx)


def incompressible_viscosity_2d(u, mu, dx):
    """mu * laplacian(u) (reference viscosity.py:22-25)."""
    return mu * finite_laplacian_2d(u, dx)
