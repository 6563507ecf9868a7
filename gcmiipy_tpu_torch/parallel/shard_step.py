"""The decomposed steps: each rank steps its own block of the grid.

Port of ``gcmiipy_tpu/parallel/shard_step.py``.  Each ``make_*`` returns a
function on the rank's own block, the fields ``(p, u, v, t, q)`` with Hl
rows (and Wl columns on a 2D mesh); ``geom`` is always the global
geometry.

On a 2D (lat x lon) mesh (:mod:`gcmiipy_tpu_torch.parallel.mesh`):

* :func:`make_shard_step` (JAX :84-167): the plain core on the block
  padded by a 2D halo of 3, the polar filter as each row's slice of the
  circulant stack after a gather of the row's longitudes (small grids: the
  stack is refused above 2 GiB, as in JAX);
* :func:`make_shard_step_2d` (JAX :210-300): the same with the
  spectral-psum filter (:func:`_spectral_psum_filter`); 'xla' on a mesh;
* :func:`make_shard_step_fused2d` (JAX :302-447): K3's and K4's shard
  forms on the block padded by EX = 3 and the spectral-psum filter
  between them; 'fused', 'mega' and 'mega4' on a 2D mesh.

On a lat ring (``nx = 1``), each step exchanges rows with the ring
neighbours (:func:`halo.exchange_axis`, the fields packed into one buffer
of planes) and runs a kernel on the block of Hl + 2*halo rows with the
block's own row tables, built once per shard on the host, as the JAX
package's ``strip_tables`` and ``rows`` build them:

* :func:`make_shard_step_fused` (JAX :449-551): K5's shard form, twice a
  step;
* :func:`make_shard_step_fused4` (JAX :553-707): K6's shard form, once a
  step; with ``overlap=True`` on three strips, the interior one launched
  before the exchange on a stream of its own;
* :func:`make_shard_stream_ring` (JAX :708-843): K7's shard form, once a
  call of K steps.

The kernels wrap their block modulo its extents; that spoils only halo
cells, and the core comes out as the whole globe's.  ``shard_prognostics``
(JAX :844) is in :mod:`gcmiipy_tpu_torch.parallel.mesh`.
"""

import types
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from gcmiipy_tpu_torch.device import torch_dtype
from gcmiipy_tpu_torch.dynamics import core25d
from gcmiipy_tpu_torch.ops import (
    mega_half, mega_step, pgf_rest, polar_filter, stream_steps)
from gcmiipy_tpu_torch.parallel import distributed, halo
from gcmiipy_tpu_torch.parallel.mesh import block_cols, block_rows

PHJ = 8   # a Matsuno step's row reach (JAX pallas_stencil.PHJ)
HALO = 3  # the plain core's stencil reach per half step (JAX HALO)
EX = 3    # fused2d's exchange depth (JAX shard_step.py:344)
BOTH = (-2, -1)
# calls of the spectral-psum filter (each: two float64 matmuls and one
# all_reduce over the mesh row)
spectral_psum = types.SimpleNamespace(launches=0)


def _shard_rows(mesh, geom):
    if geom.height % mesh.ny:
        raise ValueError("height must divide the lat mesh axis")
    return geom.height // mesh.ny


def _ring_only(mesh, name):
    if mesh.nx > 1:
        raise ValueError(f"{name} decomposes over latitude only; the mesh "
                         f"is {mesh.shape}")


def _on_device(mesh, geom, dtype):
    geom = geom.to(device=mesh.device)
    return geom if dtype is None else geom.to(dtype=torch_dtype(dtype))


def _shard_extents(mesh, geom, reach):
    """``(Hl, Wl)`` of a 2D mesh's blocks; raises unless the grid divides
    the mesh and both extents reach ``reach``."""
    if geom.height % mesh.ny or geom.width % mesh.nx:
        raise ValueError("grid dims must divide the mesh")
    hl, wl = geom.height // mesh.ny, geom.width // mesh.nx
    if hl < reach or wl < reach:
        raise ValueError(f"shard extents ({hl},{wl}) must be >= halo width "
                         f"{reach}")
    return hl, wl


def _block_geom(mesh, geom, halo_):
    """The geometry of this rank's block padded by ``halo_`` cells a side
    on both axes (a ring of one along an axis wraps its own cells)."""
    return geom.take_block(
        block_rows(geom.height, mesh.ny, mesh.index, halo_),
        block_cols(geom.width, mesh.nx, mesh.x_index, halo_))


def _exchange_fields(fields, mesh, depth):
    """The five fields padded by a 2D halo of ``depth``: one exchange of
    their planes packed into one buffer."""
    L = fields[1].shape[0]
    packed = halo.exchange_2d(stream_steps.pack_state(*fields), depth, mesh)
    return stream_steps.unpack_state(packed, L)


def _wall(mesh, v_core):
    """v times 0 on the global row H-1, the last core row of the last y
    shard (dynamics.py:222); in place on a fresh tensor."""
    if mesh.index == mesh.ny - 1:
        v_core[:, -1, :] = 0.0
    return v_core


def _spectral_psum_filter(CS_l, CwSw_l, mcc_l, mesh):
    """The polar filter of lon-sharded core fields, as JAX's (:169-207): on
    each rank the partial forward product ``q2 @ CS_l`` over its
    longitudes, one ``all_reduce(SUM)`` of the ``(rows, 2nb)`` coefficients
    over the mesh row, then ``(spec * mcc) @ CwSw_l`` added to q.  The
    banded-pair correction form of :func:`polar_filter.arakawa_1977`, one
    collective a call whatever the width.  The factors and the sums are
    float64 (the port's rule for filter sums: float32 sums leave 9.6e-5 of
    pg_phi's scale on the polar rows); a float32 field is cast once on the
    way in and rounded once on the way out."""
    def filter_core(q_core):
        lead = q_core.shape[:-1]
        q2 = q_core.reshape(-1, q_core.shape[-1]).to(torch.float64)
        spec = torch.matmul(q2, CS_l)
        if mesh.nx > 1:
            spec = distributed.all_reduce(spec, dist.ReduceOp.SUM,
                                          mesh.row_group)
        mrow = mcc_l.expand(lead[:-1] + mcc_l.shape).reshape(
            -1, mcc_l.shape[-1])
        out = q2 + torch.matmul(spec * mrow, CwSw_l)
        spectral_psum.launches += 1
        return out.reshape(q_core.shape).to(q_core.dtype)

    return filter_core


def spectral_psum_filter(mesh, geom):
    """:func:`_spectral_psum_filter` of this rank's block of ``geom`` (the
    global geometry): ``CS`` cut to the rank's longitudes, ``CwSw`` to its
    columns and the correction mask to its rows, float64 on the mesh's
    device (JAX's ``P('x', None)``, ``P(None, 'x')``, ``P('y', None)``)."""
    CS, CwSw, nb = polar_filter.banded_pair_matrices(geom.width,
                                                     dtype=np.float64)
    mcc = polar_filter.banded_correction_mask_pair(geom.polar_mask, nb,
                                                   dtype=np.float64)
    hl, wl = geom.height // mesh.ny, geom.width // mesh.nx
    rows = slice(mesh.index * hl, (mesh.index + 1) * hl)
    cols = slice(mesh.x_index * wl, (mesh.x_index + 1) * wl)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(mesh.device)

    return _spectral_psum_filter(put(CS[cols]), put(CwSw[:, cols]),
                                 put(mcc[rows]), mesh)


def _core_step(mesh, lgeom, dt, filter_fn, coriolis, q_limiter):
    """The Matsuno step of the plain core on a 2D mesh's block: the state
    and the starred state exchanged by HALO (JAX exchanges the base state
    again for the corrector; it has not changed), each half
    ``core25d.half_timestep`` on the padded block with ``filter_fn``, the
    core cut back out and walled."""
    def half(base, seval):
        out = core25d.half_timestep(*base, *seval, dt, lgeom,
                                    filter_fn=filter_fn, coriolis=coriolis,
                                    q_limiter=q_limiter)
        p, u, v, t, q = (halo.trim(x, HALO, BOTH).contiguous() for x in out)
        return p, u, _wall(mesh, v), t, q

    def run(p, u, v, t, q):
        base = _exchange_fields((p, u, v, t, q), mesh, HALO)
        starred = _exchange_fields(half(base, base), mesh, HALO)
        return half(base, starred)

    return run


def make_shard_step(mesh, geom, dt, coriolis=False, dtype=None):
    """The plain-core Matsuno step on a 2D mesh's block with the polar
    filter as the rows' slices of the circulant stack (JAX
    ``make_shard_step``): the core's filtered rows are gathered along the
    mesh row, multiplied by the rank's ``(Hl, Wl, W)`` slice of the stack
    and re-padded.  The stack is O(H * W^2): a small-grid reference,
    refused above 2 GiB as in JAX.  ``dtype``: the geometry's, if given."""
    _shard_extents(mesh, geom, HALO)
    geom = _on_device(mesh, geom, dtype)
    itemsize = torch.empty((), dtype=geom.sig.dtype).element_size()
    F_bytes = geom.height * geom.width ** 2 * itemsize
    if F_bytes > 2 << 30:
        raise ValueError(
            f"circulant filter stack would need {F_bytes / 2**30:.1f} GiB "
            f"({geom.height}x{geom.width}x{geom.width}); make_shard_step is "
            "the small-grid correctness reference — use "
            "make_shard_step_fused or make_shard_step_2d for this grid")
    hl, wl = geom.height // mesh.ny, geom.width // mesh.nx
    F_all = polar_filter.build_filter_matrices(geom, dtype=np.float64)
    F_local = torch.as_tensor(np.ascontiguousarray(
        F_all[mesh.index * hl:(mesh.index + 1) * hl,
              mesh.x_index * wl:(mesh.x_index + 1) * wl])).to(
        device=mesh.device, dtype=geom.sig.dtype)
    row_group = mesh.row_group

    def filter_fn(q, _geom):
        core = halo.trim(q, HALO, BOTH).contiguous()
        if mesh.nx > 1:
            core = distributed.all_gather_rows(core, row_group, dim=-1)
        out = torch.einsum("jab,...jb->...ja", F_local, core)
        return halo.exchange_2d(out, HALO, mesh)

    return _core_step(mesh, _block_geom(mesh, geom, HALO), dt, filter_fn,
                      coriolis, False)


def make_shard_step_2d(mesh, geom, dt, coriolis=False, dtype=None,
                       q_limiter=False):
    """The plain-core Matsuno step on a 2D mesh's block with the
    spectral-psum filter (JAX ``make_shard_step_2d``): O(W * nb) factors
    instead of the circulant stack, so any grid.  The port's backend 'xla'
    on a mesh ((ny, nx), a lat ring with nx = 1): PyTorch has no GSPMD,
    and this is JAX's explicit-halo form of the same operator, whose 'xla'
    mesh run also takes the DFT filter (JAX driver :986-996)."""
    _shard_extents(mesh, geom, HALO)
    geom = _on_device(mesh, geom, dtype)
    fcore = spectral_psum_filter(mesh, geom)

    def filter_fn(q, _geom):
        core = halo.trim(q, HALO, BOTH).contiguous()
        return halo.exchange_2d(fcore(core), HALO, mesh)

    return _core_step(mesh, _block_geom(mesh, geom, HALO), dt, filter_fn,
                      coriolis, q_limiter)


def make_shard_step_fused2d(mesh, geom, dt, coriolis=False, dtype=None,
                            q_limiter=False):
    """The 2D (lat x lon) decomposition of the v2 step with K3's and K4's
    shard forms (JAX ``make_shard_step_fused2d``).  Each half step, on
    the rank's block padded by a 2D halo of EX = 3 (the stencils' reach;
    JAX's (8, 128) alignment pad is a TPU layout device, not carried
    over): K3's shard form (:func:`pgf_rest.pgf_parts_shard`), the
    spectral-psum filter on the cores of the 2L stacked planes, a 2D halo
    round of the filtered spu planes, K4's shard form
    (:func:`pgf_rest.rest_parts_shard`), then the polar wall on the global
    row H-1.  Exchanges a step: 2 of the state, 2 of spu, 2 psums.  The
    v2 half step equals the core's up to the reassociation of the pv
    force sum."""
    _shard_extents(mesh, geom, EX)
    geom = _on_device(mesh, geom, dtype)
    bgeom = _block_geom(mesh, geom, EX)
    fcore = spectral_psum_filter(mesh, geom)
    L = geom.layers

    def half(base, seval):
        sp, su, _, st, _ = seval
        stack, pg_phiv = pgf_rest.pgf_parts_shard(sp, su, st, bgeom)
        filt = fcore(halo.trim(stack, EX, BOTH).contiguous())
        spu = halo.exchange_2d(filt[:L], EX, mesh)
        pgfu = F.pad(filt[L:], (EX, EX, EX, EX))
        out = pgf_rest.rest_parts_shard(
            *base, *seval, torch.cat([spu, pgfu]), pg_phiv, dt, bgeom,
            coriolis=coriolis, q_limiter=q_limiter)
        p, u, v, t, q = (halo.trim(x, EX, BOTH).contiguous() for x in out)
        return p, u, _wall(mesh, v), t, q

    def run(p, u, v, t, q):
        base = _exchange_fields((p, u, v, t, q), mesh, EX)
        starred = _exchange_fields(half(base, base), mesh, EX)
        return half(base, starred)

    return run


def make_shard_step_fused(mesh, geom, dt, coriolis=False, dtype=None):
    """The 'mega' step on a lat ring (JAX ``make_shard_step_fused``): each
    half step one PHJ-row exchange and K5's shard form
    (:func:`mega_half.mega_half_shard`) on the (Hl + 2*PHJ)-row block with
    the block's row tables, the wall from the global row H-1 (where JAX
    multiplies row PHJ + Hl - 1 of the last shard outside the kernel; the
    cores are the same)."""
    _ring_only(mesh, "make_shard_step_fused")
    hl = _shard_rows(mesh, geom)
    if hl < PHJ:
        raise ValueError(f"shard rows {hl} < padded-state halo {PHJ}")
    half = mega_half.MegaHalf(
        _on_device(mesh, geom, dtype), dt, coriolis=coriolis,
        rows=block_rows(geom.height, mesh.ny, mesh.index, PHJ))
    L = geom.layers

    def ring(fields):
        block = halo.exchange_axis(stream_steps.pack_state(*fields), PHJ,
                                   mesh)
        return stream_steps.unpack_state(block, L)

    def run(p, u, v, t, q):
        base = ring((p, u, v, t, q))
        starred = ring([halo.trim(x, PHJ) for x in half(base, base)])
        return tuple(halo.trim(x, PHJ).contiguous()
                     for x in half(base, starred))

    return run


def _strips(hl, tile_j, overlap):
    """fused4's strips ``(row_lo, rows)`` of a shard (JAX :596-612): with
    ``overlap`` the interior ``(tj, Hl - 2 tj)`` and the two edges of tj
    rows, tj halved from ``tile_j`` until it divides Hl; below Hl = 3 tj
    (or tj < PHJ, where the interior's context would not be local) one
    strip, with JAX's warning."""
    tj = tile_j
    while hl % tj:
        tj //= 2
    if overlap and (hl < 3 * tj or tj < PHJ):
        warnings.warn(
            f"overlap=True needs shard rows {hl} >= 3 * tile_j {tj}; "
            "running the single-kernel (non-overlapped) form", stacklevel=3)
        overlap = False
    if overlap:
        return tj, [(0, tj), (tj, hl - 2 * tj), (hl - tj, tj)]
    return tj, [(0, hl)]


def make_shard_step_fused4(mesh, geom, dt, coriolis=False, q_limiter=False,
                           dtype=None, tile_j=32, overlap=False):
    """One Matsuno step a call on the rank's band: one PHJ-row exchange and
    one call of K6's shard form (:func:`mega_step.mega_step_shard`) on the
    (Hl + 2*PHJ)-row block.  ``geom``: the global geometry.

    ``overlap=True`` (JAX :553-615) splits the band into three strips,
    each K6's shard form on its own ``rows + 2*PHJ`` rows with its own row
    tables (JAX ``strip_tables``): the interior strip's context is local,
    so it is launched before the exchange, on a CUDA stream of its own,
    and the edge strips after it on the current stream, which waits for
    the interior before the strips are joined.  The halo rows are staged
    for the exchange before the interior launch, so that gloo's copies to
    the host do not queue behind it.  Shards below ``3 * tj`` rows run the
    one-strip form with JAX's warning.  The result equals the one-strip
    form's."""
    _ring_only(mesh, "make_shard_step_fused4")
    hl = _shard_rows(mesh, geom)
    if hl < PHJ:
        raise ValueError(f"shard rows {hl} < padded-state halo {PHJ}")
    geom = _on_device(mesh, geom, dtype)
    H, L = geom.height, geom.layers
    tj, strips = _strips(hl, tile_j, overlap)
    base_row = mesh.index * hl
    kernels = [mega_step.MegaStep(
        geom, dt, coriolis=coriolis, q_limiter=q_limiter,
        rows=np.arange(base_row + lo - PHJ, base_row + lo + lh + PHJ) % H)
        for lo, lh in strips]

    def step(kernel, block):
        return kernel(*stream_steps.unpack_state(block.contiguous(), L))

    if len(strips) == 1:
        def run(p, u, v, t, q):
            block = halo.exchange_axis(
                stream_steps.pack_state(p, u, v, t, q), PHJ, mesh)
            return tuple(halo.trim(x, PHJ).contiguous()
                         for x in step(kernels[0], block))

        return run

    side = (torch.cuda.Stream(mesh.device) if mesh.device.type == "cuda"
            else None)

    def run(p, u, v, t, q):
        packed = stream_steps.pack_state(p, u, v, t, q)
        pending = halo.start_exchange(packed, PHJ, mesh)
        inner = packed[:, tj - PHJ:hl - tj + PHJ]
        if side is None:
            mid = step(kernels[1], inner)
        else:
            main = torch.cuda.current_stream(mesh.device)
            side.wait_stream(main)
            packed.record_stream(side)
            with torch.cuda.stream(side):
                mid = step(kernels[1], inner)
            for x in mid:
                x.record_stream(main)
        block = halo.finish_exchange(pending)
        top = step(kernels[0], block[:, :tj + 2 * PHJ])
        bot = step(kernels[2], block[:, hl - tj:])
        if side is not None:
            main.wait_stream(side)
        return tuple(torch.cat([halo.trim(a, PHJ), halo.trim(b, PHJ),
                                halo.trim(c, PHJ)], dim=-2)
                     for a, b, c in zip(top, mid, bot))

    return run


def make_shard_stream_ring(mesh, geom, dt, steps_per_launch=2,
                           coriolis=False, q_limiter=False):
    """K = ``steps_per_launch`` Matsuno steps a call on the rank's band: one
    K*PHJ-row exchange and one call of K7's shard form
    (:func:`stream_steps.stream_steps_shard`) on the (Hl + 2*K*PHJ)-row
    block, whose outer rows go stale step by step while the core stays
    exact (recompute on the halo, in time).  K must be even (the buffer's
    ping-pong) and K*PHJ at most Hl (a one-hop exchange).  Returns
    ``advance(p, u, v, t, q)``; ``advance.chunk_steps`` is K."""
    _ring_only(mesh, "make_shard_stream_ring")
    K = steps_per_launch
    if K < 2 or K % 2:
        raise ValueError(f"steps_per_launch must be even >= 2, got {K}")
    hl = _shard_rows(mesh, geom)
    D = K * PHJ
    if D > hl:
        raise ValueError(
            f"ring halo K*PHJ = {D} exceeds shard rows {hl} (one-hop "
            f"exchange); lower steps_per_launch to <= {hl // PHJ}")
    multi = stream_steps.StreamSteps(
        geom.to(device=mesh.device), dt, coriolis=coriolis,
        q_limiter=q_limiter,
        rows=block_rows(geom.height, mesh.ny, mesh.index, D))
    L = geom.layers

    def advance(p, u, v, t, q):
        packed = halo.exchange_axis(stream_steps.pack_state(p, u, v, t, q),
                                    D, mesh)
        S = torch.stack([packed, torch.empty_like(packed)])
        multi(S, None, K)
        return tuple(halo.trim(x, D).contiguous()
                     for x in stream_steps.unpack_state(S[0], L))

    advance.chunk_steps = K
    return advance
