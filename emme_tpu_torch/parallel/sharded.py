"""Mesh-sharded dense assembly and eigensolve, banded matvec with halo
exchange, and PIC with sharded markers.

Counterpart of ``emme_tpu/parallel/sharded.py``.  Every function here runs
in each rank of a ``mesh.Mesh`` on that rank's tensors (SPMD; the JAX
package's ``shard_map`` bodies), with the collectives of ``mesh.py``:

  * dense assembly: the upper-triangle pair list shards over ``rows``; each
    rank evaluates its pairs' kernel integrals (float32 pairs through the
    CUDA kernel K1, ``eigen._pair_values``, as the single-device assembly
    does), the per-pair values are all-gathered and every rank builds the
    whole operator.  The Newton trace solve runs on that replicated
    operator; rank 0's update is broadcast, so every rank takes the same
    steps.
  * banded matvec: block rows shard over ``rows``; the x segments within
    the band's reach arrive from the neighbours by ``ppermute`` stripe
    relays, zeros at the global edges.
  * PIC: markers shard over ``rows``; each rank deposits its markers and
    the density is summed over the ranks before the field solve, so every
    rank holds the same field.  The plain step (``solvers/pic.py``), as in
    the JAX package.
"""

from __future__ import annotations

import functools
from dataclasses import fields as dc_fields, replace

import numpy as np
import torch

from ..grid import Grid
from ..ops import kernels, linalg
from ..ops.singularity import singularity_coeff_matrix
from ..ops.sparse import BDIAOperator
from ..solvers import eigen as eigen_mod
from ..solvers import newton
from ..solvers import pic as pic_mod
from . import mesh as mesh_mod


def _padded_pairs(n: int, n_shards: int):
    """Upper-triangle pairs padded with the dummy pair (0, 1) to a multiple
    of ``n_shards``; returns (iu, ju, npairs)."""
    iu, ju = np.triu_indices(n, k=1)
    npairs = len(iu)
    pad = (-npairs) % n_shards
    iu = np.concatenate([iu, np.zeros(pad, iu.dtype)])
    ju = np.concatenate([ju, np.ones(pad, ju.dtype)])
    return iu, ju, npairs


@functools.lru_cache(maxsize=8)
def _pair_tensors(n: int, n_shards: int, device: str):
    iu, ju, npairs = _padded_pairs(n, n_shards)
    dev = torch.device(device)
    return torch.as_tensor(iu, device=dev), torch.as_tensor(ju, device=dev), \
        npairs


def sharded_assemble(p, grid: Grid, coeff, omega, mesh, quad=None,
                     chunk: int = 2048, fused: bool = False):
    """M(omega) with pair-sharded quadrature on the base panel mesh (no
    |i - j| tiers, as the JAX function): this rank's contiguous share of
    the padded pair list, the values all-gathered over ``rows`` (O(npairs)
    complex numbers), the operator built on every rank."""
    S = mesh.n_rows
    iu, ju, npairs = _pair_tensors(grid.npoints, S, str(grid.eta.device))
    L = iu.shape[0] // S
    mine = slice(mesh.row * L, (mesh.row + 1) * L)
    ms = (0, 1, 2) if p.electromagnetic else (0,)
    local = eigen_mod._pair_values(p, grid.eta[iu[mine]], grid.eta[ju[mine]],
                                   omega, ms, quad, chunk, fused)
    vals = tuple(mesh_mod.all_gather(v, mesh, tiled=True)[:npairs]
                 for v in local)
    iu, ju = iu[:npairs], ju[:npairs]
    return eigen_mod._materialize_from_pairs(
        p, grid, coeff, vals, (grid.eta[iu], grid.eta[ju]), (iu, ju), omega)


def _assembler(p, grid, coeff, mesh, quad, chunk, fused):
    return functools.partial(sharded_assemble, p, grid, coeff, mesh=mesh,
                             quad=quad, chunk=chunk, fused=fused)


def _step(state, mesh, assemble):
    d_omega = mesh_mod.broadcast(
        -1.0 / linalg.complex_solve_trace(state.M, state.dM), mesh)
    return newton.advance(state, d_omega, assemble, eigen_mod.secant)


def sharded_newton_step(p, grid, coeff, state, mesh, quad=None,
                        chunk: int = 2048, fused: bool = False):
    """Newton-trace-secant step with the sharded assembly; the trace solve
    on the replicated operator, its update broadcast from rank 0 of
    ``rows``."""
    return _step(state, mesh,
                 _assembler(p, grid, coeff, mesh, quad, chunk, fused))


def sharded_init_state(p, grid, coeff, omega_init, mesh, quad=None,
                       chunk: int = 2048, fused: bool = False):
    """Reference ctor seeding (solver.h:396-415) with sharded assemblies
    (``newton.seed``)."""
    return newton.seed(_assembler(p, grid, coeff, mesh, quad, chunk, fused),
                       omega_init, eigen_mod.secant, eigen_mod.EigenState)


def solve(p, omega_init, mesh, tol: float | None = None, quad=None,
          chunk: int = 2048, dtype=None, host64: bool = False):
    """Dense eigensolve with the mesh-sharded assembly: the quadrature --
    most of the solve -- divides over ``rows``; the trace solve runs on
    the replicated operator (for a distributed solve use the banded SPIKE
    path, ``parallel/spike.py``).  TraceSecant with ``eigen.solve``'s stop
    rules (``newton.run``, the host loop).  float32 pairs go through K1
    (its plain version on CPU tensors).  ``host64``:
    ``eigen.host64_polish`` on rank 0 of ``rows`` (complex128 on its
    device), broadcast to the others; the null vector likewise.
    Returns (omega, eigenvector, n_steps, state) on every rank."""
    tol = tol if tol is not None else 1e-6
    dtype = dtype if dtype is not None else p.length.dtype
    device = p.length.device
    fused = dtype == torch.float32
    grid = Grid.create(p.length, p.npoints, dtype=dtype, device=device)
    coeff = singularity_coeff_matrix(p.npoints, dtype=dtype, device=device)
    cdtype = kernels.complex_dtype(dtype)
    assemble = _assembler(p, grid, coeff, mesh, quad, chunk, fused)
    state = newton.seed(
        assemble,
        torch.tensor(complex(omega_init), dtype=cdtype, device=device),
        eigen_mod.secant, eigen_mod.EigenState)
    state, n_steps, omega = newton.run(
        lambda s: _step(s, mesh, assemble), state, tol,
        p.iteration_step_limit + 1, dtype != torch.float64,
        method="TraceSecant", mesh_rows=mesh.n_rows)
    dim = state.M.shape[0]
    buf = torch.zeros(dim + 2, dtype=torch.complex128, device=device)
    if mesh.row == 0:
        extra = 0
        if host64:
            omega, vec, extra = eigen_mod.host64_polish(
                state, eigen_mod.assembler(p, grid, coeff, quad, chunk,
                                           fused=fused),
                tol, omega=omega)
        else:
            vec = eigen_mod.null_space(state.M)
        buf[0], buf[1:-1], buf[-1] = omega, vec, extra
    buf = mesh_mod.broadcast(buf, mesh)
    vec = buf[1:-1].to(torch.complex128 if host64 else cdtype)
    return (complex(buf[0].item()), vec, n_steps + int(buf[-1].real.item()),
            state)


# ---------------------------------------------------------------------------
# row-block sharded banded matvec with ppermute halo stripes
# ---------------------------------------------------------------------------

def shard_bdia(op: BDIAOperator, mesh):
    """This rank's block rows of a BDIAOperator: (data rows (ndiag, nb/S,
    bs, bs), halo max|offset|).  Needs nb divisible by the ``rows`` size."""
    S = mesh.n_rows
    nb = op.n // op.block
    if nb % S:
        raise ValueError(f"{nb} block rows do not divide over {S} ranks")
    nbl = nb // S
    return (op.data[:, mesh.row * nbl:(mesh.row + 1) * nbl],
            max(abs(d) for d in op.offsets))


def bdia_matvec_local(d_local, offsets, halo: int, mesh, x_loc):
    """This rank's segment of y = A x, from its block rows ``d_local``
    (ndiag, nbl, bs, bs) and its x segment: the x stripes of the shards
    within ``halo`` blocks relay hop by hop from both neighbours
    (``ppermute``; zeros arrive at the global edges, which is the open
    boundary), then every diagonal contracts against the extended window.
    The JAX function's ``overlap`` switch orders the relay against the
    contraction for XLA's scheduler; eager collectives here block, so there
    is one order."""
    nbl, bs = d_local.shape[1], d_local.shape[-1]
    x = x_loc.reshape(nbl, bs)
    hops = -(-halo // nbl)
    left, right = [], []
    buf_l = buf_r = x
    for _ in range(hops):
        buf_l = mesh_mod.ppermute(buf_l, mesh, +1)    # from the left
        buf_r = mesh_mod.ppermute(buf_r, mesh, -1)    # from the right
        left.insert(0, buf_l)
        right.append(buf_r)
    x_ext = torch.cat(left + [x] + right)
    base = hops * nbl
    gx = torch.stack([x_ext[base + d:base + d + nbl] for d in offsets])
    y = torch.einsum("dnij,dnj->ni", d_local, gx)
    return y.reshape(-1)


def sharded_bdia_matvec(op: BDIAOperator, mesh, x):
    """y = A x with A's block rows and x sharded over ``rows`` (each rank
    takes its share of ``op`` and ``x``) and the halo exchanged by
    ``bdia_matvec_local``; y all-gathered on every rank."""
    d_local, halo = shard_bdia(op, mesh)
    n_s = op.n // mesh.n_rows
    y = bdia_matvec_local(d_local, op.offsets, halo, mesh,
                          x[mesh.row * n_s:(mesh.row + 1) * n_s])
    return mesh_mod.all_gather(y, mesh, tiled=True)


# ---------------------------------------------------------------------------
# PIC with sharded markers
# ---------------------------------------------------------------------------

_MARKER_FIELDS = tuple(f.name for f in dc_fields(pic_mod.PICState)
                       if f.name != "field")


def shard_markers(state, mesh):
    """This rank's contiguous share of the markers; the field stays whole.
    Needs the marker count divisible by the ``rows`` size."""
    m, S = state.eta.shape[0], mesh.n_rows
    if m % S:
        raise ValueError(f"{m} markers do not divide over {S} ranks")
    L = m // S
    return replace(state, **{f: getattr(state, f)[mesh.row * L:
                                                  (mesh.row + 1) * L]
                             for f in _MARKER_FIELDS})


def _reduce(mesh):
    return functools.partial(mesh_mod.psum, mesh=mesh)


def _prepare(p, marker_per_cell, mesh, generator, state):
    """Every rank loads the whole marker set from the same draws (the seed
    is shared) and keeps its share, so the run is the single-device run's
    with the deposit summed in another order."""
    return shard_markers(
        pic_mod.initial_state(p, marker_per_cell, generator, state), mesh)


def pic_sharded_step(p, mesh, qn_coef, state, dt):
    """One RK3 PIC step of this rank's markers; the deposited density is
    summed over ``rows`` before each field solve."""
    new_s, _v = pic_mod.rk3_step(p, state, dt, qn_coef,
                                 density_reduce=_reduce(mesh))
    return new_s


def pic_sharded_run(p, marker_per_cell, n_steps, dt, mesh, generator=None,
                    state=None):
    """The PIC run with sharded markers.  Returns (final state: this rank's
    markers and the whole field, stats (n_steps, 3)), the JAX function's
    order."""
    s0 = _prepare(p, marker_per_cell, mesh, generator, state)
    stats, s, _ = pic_mod.run(p, marker_per_cell, n_steps, dt, state=s0,
                              density_reduce=_reduce(mesh))
    return s, stats


def pic_sharded_run_timed(p, marker_per_cell, n_steps, dt, mesh,
                          generator=None, state=None,
                          record_fields: bool = False):
    """``pic_sharded_run`` with the reference's per-phase timer sections
    (``pic.run_timed``).  Returns (stats, final state, fields or None)."""
    s0 = _prepare(p, marker_per_cell, mesh, generator, state)
    return pic_mod.run_timed(p, marker_per_cell, n_steps, dt, state=s0,
                             record_fields=record_fields,
                             density_reduce=_reduce(mesh))


def pic_sharded_run_streaming(p, marker_per_cell, n_steps, dt, mesh,
                              stream_path, generator=None, state=None,
                              chunk_steps: int = 16):
    """``pic_sharded_run`` with the per-step fields appended to
    ``stream_path`` during the run (``pic.run_streaming``) by rank 0 of
    ``rows``; the other ranks take the same steps and write nothing.
    Returns (stats, final state)."""
    s0 = _prepare(p, marker_per_cell, mesh, generator, state)
    if mesh.row == 0:
        return pic_mod.run_streaming(
            p, marker_per_cell, n_steps, dt, stream_path, state=s0,
            chunk_steps=chunk_steps, density_reduce=_reduce(mesh))
    stats, s, _ = pic_mod.run(p, marker_per_cell, n_steps, dt, state=s0,
                              density_reduce=_reduce(mesh))
    return stats, s
