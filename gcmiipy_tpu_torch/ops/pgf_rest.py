"""K3 and K4: the pgf and rest kernels of the v2 pipeline, in CUDA.

Replace ``gcmiipy_tpu/ops/pallas_stencil.py:make_pgf_kernel_padded`` (its
``pl.pallas_call`` at :459) and ``make_rest_kernel_padded`` (:583).  A v2
half step (:func:`gcmiipy_tpu_torch.dynamics.fused.make_fused_matsuno_v2`)
is :func:`pgf_parts` (K3), one batched polar filter on the stack it
returns, :func:`rest_parts` (K4), and the polar wall.

* :func:`pgf_parts_ref` and :func:`rest_parts_ref` are the plain PyTorch
  versions, on unpadded contiguous tensors;
* :func:`pgf_parts` and :func:`rest_parts` run them on CPU tensors and
  launch ``csrc/pgf_rest.cu`` on CUDA tensors, or raise; they never fall
  back.

K3 is one launch of the pgf tile (``csrc/pgf_tile.cuh``), which is also
the pgf stage of K5, K6 and K7.  K4 is one launch of the rest tile
(``csrc/stencil_tile.cuh``: aflux in a prologue, then the rest stencil),
which is also stages 4-5 of K5, K6 and K7.

:func:`pgf_parts_shard` and :func:`rest_parts_shard` are K3's and K4's
shard forms (JAX ``make_pgf_kernel_padded`` / ``make_rest_kernel_padded``
with ``local_height``, ``local_width`` and ``geom_as_args``, :398-421,
:477, :492-520, :605): the same kernels on a rank's block of a 2D (lat x
lon) mesh, its core and the exchanged halo, with the block's geometry
(:meth:`Geom.take_block`); :mod:`gcmiipy_tpu_torch.parallel.shard_step`'s
fused2d path runs them.

``pgf_parts.launches`` and ``rest_parts.launches`` count the calls that
launched a kernel, ``pgf_parts_shard.launches`` and
``rest_parts_shard.launches`` those of the shard forms.  ``pgf_tile.launches`` and ``rest_stencil.launches``
count every launch of the pgf tile and of the rest tile where the C
entries make it: K3's and K4's own and those inside K5, K6 and K7, which
their wrappers add after the call (:func:`add_pgf_launches`,
:func:`add_stencil_launches`).  The kernels are bound by bytes (the
sources' headers work the numbers out).
"""

import ctypes
import types

import torch

from gcmiipy_tpu_torch.dynamics import core25d
from gcmiipy_tpu_torch.ops import cuda_lib
from gcmiipy_tpu_torch.ops.fused_parts import (
    GEOM_FIELDS, check_args, kernel_consts, on_cpu, pointer_array)
from gcmiipy_tpu_torch.ops.stencil import iph, jph


def pgf_parts_ref(sp, su, st, geom):
    """Plain PyTorch version of K3: ``core25d.pgf_forces`` with the two
    filter-bound forces stacked.  Returns ``(stack, pg_phiv)``: the
    (2L,H,W) ``[spu_raw; pg_phi]`` and the (L,H,W) ``pg_phiv``."""
    spu_raw, pg_phi, pg_phiv = core25d.pgf_forces(sp, su, st, geom)
    return torch.cat([spu_raw, pg_phi], dim=0), pg_phiv


def rest_parts_ref(p, u, v, t, q, sp, su, sv, st, sq, filt_stack, pg_phiv,
                   dt, geom, coriolis=False, q_limiter=False):
    """Plain PyTorch version of K4: ``core25d.half_timestep_rest`` with the
    filtered spu (the stack's first L planes): ``core25d.aflux`` gives
    ``p_n = p - pit dt`` and sd, then ``core25d.rest_tendencies`` and the
    momentum epilogue ``u = (pu - pgfu dt) / iph(p_n)``, ``v = (pv -
    pg_phiv dt) / jph(p_n)`` with the filtered pgfu (its planes L..2L), as
    2D reciprocals and 3D multiplies like the JAX kernel's.  Returns
    ``(p_n, u_n, v_n, t_n, q_n)``; v's wall row is the caller's."""
    L = geom.layers
    spu, pgfu = filt_stack[:L], filt_stack[L:]
    spv = core25d.calc_pv(sp, sv)
    pit, sd = core25d.aflux(spu, spv, geom)
    p_n = p - pit * dt
    pup, pvp, t_n, q_n = core25d.rest_tendencies(
        p, u, v, t, q, sp, su, sv, st, sq, spu, spv, sd, p_n, dt, geom,
        coriolis=coriolis, q_limiter=q_limiter)
    u_n = (pup - pgfu * dt) * (1.0 / iph(p_n))
    v_n = (pvp - pg_phiv * dt) * (1.0 / jph(p_n))
    return p_n, u_n, v_n, t_n, q_n


def _function(name, argtypes, double):
    fn = getattr(cuda_lib.load(cuda_lib.library_name("pgf_rest", double)),
                 name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_PTRS = ctypes.POINTER(ctypes.c_void_p)
_CONSTS = ctypes.POINTER(ctypes.c_double)
_I, _VP = ctypes.c_int, ctypes.c_void_p
PGF_ARGTYPES = [_I, _PTRS, _PTRS, _VP, _VP, _I, _I, _I, _CONSTS,
                ctypes.POINTER(_I), _VP]
REST_ARGTYPES = [_I, _PTRS, _VP, _VP, _PTRS, _PTRS, _I, _I, _I, _CONSTS, _I,
                 _I, ctypes.POINTER(_I), _VP]


def _check_pgf(fields, geom, kernel="pgf_parts"):
    L, H, W = geom.layers, geom.height, geom.width
    check_args(kernel, fields, [(H, W), (L, H, W), (L, H, W)], geom)


def _check_rest(fields, geom, kernel="rest_parts"):
    L, H, W = geom.layers, geom.height, geom.width
    check_args(kernel, fields,
               [(H, W)] + [(L, H, W)] * 4 + [(H, W)] + [(L, H, W)] * 4
               + [(2 * L, H, W), (L, H, W)], geom)


def pgf_parts(sp, su, st, geom):
    """K3: ``(stack, pg_phiv)`` exactly as :func:`pgf_parts_ref`.  ``sp``
    is (H,W), ``su`` and ``st`` (L,H,W)."""
    return _pgf(pgf_parts, (sp, su, st), geom)


pgf_parts.launches = 0


def pgf_parts_shard(sp, su, st, block_geom):
    """K3's shard form: :func:`pgf_parts` on a rank's block of a 2D mesh
    (its Hl x Wl core and the exchanged halo), ``block_geom`` the block's
    geometry (:meth:`Geom.take_block`).  The kernel wraps the block modulo
    its extents, which spoils only outputs within the stencil's reach of
    the block's edges: the core's are the whole globe's."""
    return _pgf(pgf_parts_shard, (sp, su, st), block_geom)


pgf_parts_shard.launches = 0


def _pgf(wrapper, fields, geom):
    """K3 for ``wrapper`` (:func:`pgf_parts` or its shard form): the plain
    version on CPU tensors, else the checked launch, counted on
    ``wrapper.launches``; raises if the launch fails."""
    kernel = wrapper.__name__
    if on_cpu(kernel, fields):
        return pgf_parts_ref(*fields, geom)
    _check_pgf(fields, geom, kernel)
    sp = fields[0]
    L, H, W = geom.layers, geom.height, geom.width
    fn = _function("gcm_pgf_parts", PGF_ARGTYPES, sp.dtype == torch.float64)
    device = sp.device
    stack = torch.empty((2 * L, H, W), dtype=sp.dtype, device=device)
    pg_phiv = torch.empty((L, H, W), dtype=sp.dtype, device=device)
    count = ctypes.c_int(0)
    with torch.cuda.device(device):
        # dt is not read by the pgf stages
        err = fn(int(sp.dtype == torch.float64), pointer_array(fields),
                 pointer_array([getattr(geom, n) for n in GEOM_FIELDS]),
                 stack.data_ptr(), pg_phiv.data_ptr(), L, H, W,
                 kernel_consts(1.0), ctypes.byref(count),
                 torch.cuda.current_stream(device).cuda_stream)
    add_pgf_launches(count)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    return stack, pg_phiv


def rest_parts(p, u, v, t, q, sp, su, sv, st, sq, filt_stack, pg_phiv, dt,
               geom, coriolis=False, q_limiter=False):
    """K4: ``(p_n, u_n, v_n, t_n, q_n)`` exactly as :func:`rest_parts_ref`,
    v not walled.  ``p``/``sp`` are (H,W), ``filt_stack`` (2L,H,W), the
    rest (L,H,W); the outputs are new tensors."""
    return _rest(rest_parts, (p, u, v, t, q, sp, su, sv, st, sq, filt_stack,
                              pg_phiv), dt, geom, coriolis, q_limiter)


def rest_parts_shard(p, u, v, t, q, sp, su, sv, st, sq, filt_stack, pg_phiv,
                     dt, block_geom, coriolis=False, q_limiter=False):
    """K4's shard form: :func:`rest_parts` on a rank's block of a 2D mesh,
    ``block_geom`` the block's geometry (:meth:`Geom.take_block`); the
    filtered spu (the stack's first L planes) must carry the exchanged
    halo, pgfu and ``pg_phiv`` are read at each output point only.  As
    :func:`pgf_parts_shard`, the core's outputs are the whole globe's; v
    is not walled."""
    return _rest(rest_parts_shard, (p, u, v, t, q, sp, su, sv, st, sq,
                                    filt_stack, pg_phiv), dt, block_geom,
                 coriolis, q_limiter)


rest_parts_shard.launches = 0


def _rest(wrapper, fields, dt, geom, coriolis, q_limiter):
    """K4 for ``wrapper`` (:func:`rest_parts` or its shard form): the plain
    version on CPU tensors, else the checked launch, counted on
    ``wrapper.launches``; raises if the launch fails."""
    kernel = wrapper.__name__
    if on_cpu(kernel, fields):
        return rest_parts_ref(*fields, dt, geom, coriolis=coriolis,
                              q_limiter=q_limiter)
    _check_rest(fields, geom, kernel)
    p, filt_stack, pg_phiv = fields[0], fields[10], fields[11]
    L, H, W = geom.layers, geom.height, geom.width
    device = p.device
    outs = [torch.empty((H, W), dtype=p.dtype, device=device)] + [
        torch.empty((L, H, W), dtype=p.dtype, device=device) for _ in range(4)]
    count = ctypes.c_int(0)
    with torch.cuda.device(device):
        double = p.dtype == torch.float64
        err = _function("gcm_rest_parts", REST_ARGTYPES, double)(
            int(double), pointer_array(fields[:10]),
            filt_stack.data_ptr(), pg_phiv.data_ptr(),
            pointer_array([getattr(geom, n) for n in GEOM_FIELDS]),
            pointer_array(outs), L, H, W, kernel_consts(dt),
            int(bool(coriolis)), int(bool(q_limiter)), ctypes.byref(count),
            torch.cuda.current_stream(device).cuda_stream)
    add_stencil_launches(count)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    return tuple(outs)


rest_parts.launches = 0

# the launches of the pgf tile and of the rest tile, counted where the C
# entries make them
pgf_tile = types.SimpleNamespace(launches=0)
rest_stencil = types.SimpleNamespace(launches=0)


def add_pgf_launches(count):
    """Adds to ``pgf_tile.launches`` the pgf tile's launches a C entry
    reports in ``count`` (a ``ctypes.c_int`` it set)."""
    pgf_tile.launches += count.value


def add_stencil_launches(count):
    """Adds to ``rest_stencil.launches`` the rest tile's launches a C entry
    reports in ``count`` (a ``ctypes.c_int`` it set)."""
    rest_stencil.launches += count.value
