"""Matsuno steps through the port's CUDA kernels.

``pipeline="v1"`` (the 'fused' backend) ports the v1 pipeline of
``gcmiipy_tpu/dynamics/fused.py`` (``make_fused_matsuno_padded`` :45-95 and
the v1 branch of ``make_fused_step`` :218): per half step, the polar filter
of the zonal mass flux, one :func:`gcmiipy_tpu_torch.ops.fused_parts.fused_parts`
call (K1), the polar wall, the second filter and the momentum update.  Same
numerics as :func:`core25d.matsuno_timestep`.  :func:`make_fused_matsuno`
(the JAX package's unpadded K2 path, ``make_fused_matsuno`` :15) is the same
function and runs the same kernel.

``pipeline="mega4"`` (the 'mega4' backend) runs one
:class:`gcmiipy_tpu_torch.ops.mega_step.MegaStep` call per step (K6): the
whole step with the polar filter inside (the TPU kernel's banded DFT,
computed in the kernel as a float64 FFT).  ``pipeline="mega"`` (the 'mega'
backend; JAX ``make_fused_matsuno_padded_v3`` :148-180) runs
:class:`gcmiipy_tpu_torch.ops.mega_half.MegaHalf` (K5) twice per step: each
half step with the same filter inside (the JAX kernel's unbanded chunks
add exact zeros).

:func:`make_fused_matsuno_v2` ports the v2 pipeline (JAX
``make_fused_matsuno_padded_v2`` :98-145, which ``bench.py`` runs as
'fused2'; no ``ModelConfig`` backend reaches it): per half step K3
(:func:`gcmiipy_tpu_torch.ops.pgf_rest.pgf_parts`), one batched polar
filter on the stacked ``[spu_raw; pg_phi]``, K4 (``rest_parts``) and the
polar wall.  Same half step as ``core25d.half_timestep_v2``.

The JAX package's padded-state layouts, its fall-back to the plain core for
grids that are not 8 | height and 128 | width (``fused_grid_supported``
:212) and its fall-back from 'mega' and 'mega4' to v1 above
``MEGA_MAX_WIDTH = 1024`` (a TPU v5e VMEM limit) exist for the TPU only.
The CUDA kernels wrap their indices themselves and keep the factor
matrices in device memory, so the port runs its kernels on every grid and
width; the wrappers raise on anything the kernels cannot take.
"""

from gcmiipy_tpu_torch.dynamics import core25d
from gcmiipy_tpu_torch.ops import polar_filter
from gcmiipy_tpu_torch.ops.fused_parts import fused_parts
from gcmiipy_tpu_torch.ops.mega_half import MegaHalf
from gcmiipy_tpu_torch.ops.mega_step import MegaStep
from gcmiipy_tpu_torch.ops.pgf_rest import pgf_parts, rest_parts

PIPELINES = ("v1", "mega", "mega4")


def _matsuno(half):
    """``step(p,u,v,t,q)``: the predictor ``half(base, base)``, then the
    corrector ``half(base, starred)``."""
    def step(p, u, v, t, q):
        base = (p, u, v, t, q)
        return half(base, half(base, base))

    return step


def make_fused_step(geom, dt, coriolis=False, filter_fn=None,
                    q_limiter=False, pipeline="v1"):
    """Drop-in fused replacement for ``core25d.matsuno_timestep``:
    ``step(p,u,v,t,q) -> (p,u,v,t,q)``.  ``"v1"`` runs K1 twice per step
    with ``filter_fn`` (default: the FFT filter) outside it; ``"mega4"``
    runs K6 once per step with its own filter, ``"mega"`` K5 twice per
    step with its own filter (``filter_fn`` is not used by either, as in
    the JAX package)."""
    if pipeline == "mega4":
        return MegaStep(geom, dt, coriolis=coriolis, q_limiter=q_limiter)
    if pipeline == "mega":
        return _matsuno(MegaHalf(geom, dt, coriolis=coriolis,
                                 q_limiter=q_limiter))
    if pipeline != "v1":
        raise NotImplementedError(
            f"fused pipeline {pipeline!r}: the port runs {PIPELINES}")
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

    return _matsuno(half)


def make_fused_matsuno(geom, dt, coriolis=False, filter_fn=None,
                       q_limiter=False):
    """The K2 path (JAX ``make_fused_matsuno``, whose kernel pads unpadded
    fields inside its wrapper): the v1 step, K1 on the unpadded fields."""
    return make_fused_step(geom, dt, coriolis=coriolis, filter_fn=filter_fn,
                           q_limiter=q_limiter, pipeline="v1")


def make_fused_matsuno_v2(geom, dt, coriolis=False, filter_fn=None,
                          q_limiter=False):
    """The v2 Matsuno step (JAX ``make_fused_matsuno_padded_v2``) on
    unpadded fields: per half step K3, ``filter_fn(stack, geom)`` (default:
    the FFT filter, one call on the 2L stacked planes), K4 and the polar
    wall.  The filter stays outside the kernels, as in the JAX package."""
    if filter_fn is None:
        filter_fn = polar_filter.arakawa_1977

    def half(base, seval):
        sp, su, _, st, _ = seval
        stack, pg_phiv = pgf_parts(sp, su, st, geom)
        filt = filter_fn(stack, geom).contiguous()
        p_n, u_n, v_n, t_n, q_n = rest_parts(
            *base, *seval, filt, pg_phiv, dt, geom, coriolis=coriolis,
            q_limiter=q_limiter)
        v_n[:, geom.height - 1, :] = 0.0  # polar wall (dynamics.py:222)
        return p_n, u_n, v_n, t_n, q_n

    return _matsuno(half)
