"""Matsuno step through the K1 kernel (the v1 'fused' backend).

Port of the v1 pipeline of ``gcmiipy_tpu/dynamics/fused.py``
(``make_fused_matsuno_padded`` :45-95 and the v1 branch of
``make_fused_step`` :218): per half step, the polar filter of the zonal mass
flux, one :func:`gcmiipy_tpu_torch.ops.fused_parts.fused_parts` call, the
polar wall, the second filter and the momentum update.  Same numerics as
:func:`core25d.matsuno_timestep`.

The JAX package's (8,128) padded-state layout, and its fall-back to the
plain core for grids that are not 8 | height and 128 | width
(``fused_grid_supported`` :212), exist for Mosaic's tiling only.  The CUDA
kernel wraps its indices itself, so the port keeps the plain layout and runs
K1 on every grid; the wrapper raises on anything the kernel cannot take.
"""

from gcmiipy_tpu_torch.dynamics import core25d
from gcmiipy_tpu_torch.ops import polar_filter
from gcmiipy_tpu_torch.ops.fused_parts import fused_parts


def make_fused_step(geom, dt, coriolis=False, filter_fn=None,
                    q_limiter=False):
    """Drop-in fused replacement for ``core25d.matsuno_timestep``:
    ``step(p,u,v,t,q) -> (p,u,v,t,q)`` running K1 twice per step."""
    if filter_fn is None:
        filter_fn = polar_filter.arakawa_1977

    def half(base, seval):
        sp, su = seval[0], seval[1]
        spu = filter_fn(core25d.calc_pu(sp, su), geom)
        p_n, v_n, t_n, q_n, pu_partial, pg_phi = fused_parts(
            *base, *seval, spu, dt, geom, coriolis=coriolis,
            q_limiter=q_limiter)
        v_n[:, geom.height - 1, :] = 0.0  # polar wall (dynamics.py:222)
        pgfu = filter_fn(pg_phi, geom)
        u_n = core25d.un_pu(pu_partial - pgfu * dt, p_n)
        return p_n, u_n, v_n, t_n, q_n

    def step(p, u, v, t, q):
        base = (p, u, v, t, q)
        return half(base, half(base, base))

    return step

