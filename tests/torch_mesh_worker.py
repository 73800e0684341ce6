"""Rank functions for the mesh tests of emme_tpu_torch (tests/test_torch_mesh*.py).

``parallel.mesh.launch`` spawns each rank, and a spawned rank imports the
module that defines its function: this one imports torch, numpy and
emme_tpu_torch only, never JAX.  Each function builds its mesh, computes
everything one test module asks of that rank count and returns it from rank
0 (the other ranks return None).
"""
import time

import torch

import emme_tpu_torch as et
from emme_tpu_torch.grid import Grid
from emme_tpu_torch.ops.singularity import (singularity_coeff_band,
                                            singularity_coeff_matrix)
from emme_tpu_torch.ops.sparse import BDIAOperator
from emme_tpu_torch.parallel import mesh as mesh_mod
from emme_tpu_torch.parallel import sharded, spike
from emme_tpu_torch.solvers import arnoldi, pic

C128 = torch.complex128


def _rank0(mesh, out):
    return out if mesh.rank == 0 else None


def collectives():
    """all_gather (stacked and tiled), psum, broadcast and ppermute both
    ways on complex64 / complex128, over a 4-rank rows axis and over the
    rows (2) and scan (2) axes of a 2 x 2 mesh made in the same group."""
    out = {}
    for name, (rows, scan) in (("4x1", (4, 1)), ("2x2", (2, 2))):
        mesh = mesh_mod.make_mesh(rows, scan)
        got = {"coords": mesh_mod.all_gather_object(
            (mesh.rank, mesh.row, mesh.scan, mesh_mod.axis_index(mesh),
             mesh_mod.axis_index(mesh, "scan")), mesh)}
        for dtype in (torch.complex64, C128):
            x = torch.arange(3).to(dtype) + complex(mesh.rank, 1)
            for axis in ("rows", "scan"):
                key = f"{dtype}/{axis}"
                got[key] = dict(
                    gather=mesh_mod.all_gather(x, mesh, axis),
                    tiled=mesh_mod.all_gather(x, mesh, axis, tiled=True),
                    psum=mesh_mod.psum(x, mesh, axis),
                    bcast=mesh_mod.broadcast(x, mesh, axis),
                    right=mesh_mod.ppermute(x, mesh, +1, axis),
                    left=mesh_mod.ppermute(x, mesh, -1, axis))
        out[name] = mesh_mod.all_gather_object(got, mesh)
    return _rank0(mesh, out)


def fail_on_row(row):
    """Rank ``row`` raises while the others wait in a collective."""
    mesh = mesh_mod.make_mesh()
    if mesh.row == row:
        raise ValueError(f"rank {row} fails on purpose")
    mesh_mod.psum(torch.ones(2), mesh)


def sleep(seconds):
    time.sleep(seconds)


def _params(cfg, n):
    return et.from_config(dict(cfg, npoints=n), device="cpu")


def sparse_suite(cfg, quad, op_data, dop_data, offsets, n, block, f, wide):
    """4 ranks: the sharded window assembly of tok``n`` (h 2, bs 8), the
    SPIKE trace, solve and null vector of the given operator, the
    bordered update, the halo matvec of it and of ``wide`` (a BDIAOperator
    whose band reaches past the next shard); the trace and solve on a
    one-shard rows axis; and, on a 2 x 2 mesh, the batched Arnoldi shifts
    over the scan axis and the host64-polished tok32 solves (SPIKE and
    dense), each polished on rank 0 of its group and broadcast."""
    mesh = mesh_mod.make_mesh()
    h = max(offsets)
    p = _params(cfg, n)
    grid = Grid.create(p.length, n, device="cpu")
    cb = singularity_coeff_band(n, (h + 1) * block - 1, device="cpu")
    om = torch.tensor(-0.8 + 0.25j, dtype=C128)
    asm = spike.gather_operator(spike.sharded_assemble_bdia(
        p, grid, cb, om, h, block, mesh, quad=quad), mesh).data
    nbl = (n // block) // mesh.n_rows
    rows = slice(mesh.row * nbl, (mesh.row + 1) * nbl)
    M = BDIAOperator(data=op_data[:, rows], offsets=offsets, n=n, block=block)
    dM = BDIAOperator(data=dop_data[:, rows], offsets=offsets, n=n,
                      block=block)
    n_s = n // mesh.n_rows
    seg = slice(mesh.row * n_s, (mesh.row + 1) * n_s)

    def full(v):
        return mesh_mod.all_gather(v, mesh, tiled=True)

    out = dict(
        assembly=asm,
        d_omega=spike.sharded_trace_d_omega(M, dM, mesh),
        solve=full(spike.sharded_solve_vec(M, mesh, f[seg])),
        solve_multi=full(spike.sharded_solve_vec(
            M, mesh, torch.stack([f, 2j * f], 1)[seg])),
        nullspace=full(spike.sharded_nullspace(M, mesh)),
        bordered=spike.sharded_bordered_d_omega(M, dM, mesh),
        matvec=sharded.sharded_bdia_matvec(
            BDIAOperator(data=op_data, offsets=offsets, n=n, block=block),
            mesh, f),
        matvec_wide=sharded.sharded_bdia_matvec(wide, mesh, f))
    mesh1 = mesh_mod.make_mesh(1, 4)      # one shard: no interface
    whole = BDIAOperator(data=op_data, offsets=offsets, n=n, block=block)
    out["d_omega_one"] = spike.sharded_trace_d_omega(
        whole, BDIAOperator(data=dop_data, offsets=offsets, n=n,
                            block=block), mesh1)
    out["solve_one"] = spike.sharded_solve_vec(whole, mesh1, f)
    mesh2 = mesh_mod.make_mesh(2, 2)
    sigmas = [-0.8 + 0.25j, -0.75 + 0.3j]
    pa = _params(cfg, 32)
    out["shifts_mesh"] = arnoldi.solve_shifts_batched(pa, sigmas, 8, quad,
                                                      mesh=mesh2)
    out["host64"] = {
        "sparse": spike.solve(pa, -0.8 + 0.25j, mesh2, tol=1e-6, quad=quad,
                              block=8, band_deta=10.0, host64=True)[:3],
        "dense": sharded.solve(pa, -0.8 + 0.25j, mesh2, tol=1e-6, quad=quad,
                               host64=True)[:3]}
    return _rank0(mesh, out)


def distributed_suite(op_data, dop_data, offsets, n, block, f):
    """8 ranks: the SPIKE trace and solve of the given operator (one block
    row a rank pair, the JAX package's two-process test)."""
    mesh = mesh_mod.make_mesh()
    nbl = (n // block) // mesh.n_rows
    rows = slice(mesh.row * nbl, (mesh.row + 1) * nbl)
    M = BDIAOperator(data=op_data[:, rows], offsets=offsets, n=n, block=block)
    dM = BDIAOperator(data=dop_data[:, rows], offsets=offsets, n=n,
                      block=block)
    n_s = n // mesh.n_rows
    z = spike.sharded_solve_vec(M, mesh, f[mesh.row * n_s:(mesh.row + 1) * n_s])
    return _rank0(mesh, dict(d_omega=spike.sharded_trace_d_omega(M, dM, mesh),
                             solve=mesh_mod.all_gather(z, mesh, tiled=True)))


def spike_solves(cfg, quad, n):
    """4 ranks: spike.solve at tok``n``, TraceSecant and QRSecant, with
    stats."""
    mesh = mesh_mod.make_mesh()
    p = _params(cfg, n)
    out = {}
    for method in ("TraceSecant", "QRSecant"):
        stats = {}
        om, vec, steps, M = spike.solve(p, -0.8 + 0.25j, mesh, tol=1e-6,
                                        quad=quad, block=8, band_deta=10.0,
                                        method=method, stats=stats)
        out[method] = (om, vec, steps, stats, M.data)
    return _rank0(mesh, out)


def dense_suite(cfg, quad, n, state_arrays):
    """The ranks of a rows mesh: the pair-sharded assembly of tok``n`` at
    -0.8+0.25j, sharded.solve, and one sharded PIC step of the given
    markers (dt 0.25) with its field."""
    mesh = mesh_mod.make_mesh()
    p = _params(cfg, n)
    grid = Grid.create(p.length, n, device="cpu")
    coeff = singularity_coeff_matrix(n, device="cpu")
    M = sharded.sharded_assemble(p, grid, coeff,
                                 torch.tensor(-0.8 + 0.25j, dtype=C128),
                                 mesh, quad=quad)
    solved = sharded.solve(p, -0.8 + 0.25j, mesh, tol=1e-6, quad=quad)[:3]
    pp = _params(cfg, 64)
    s0 = sharded.shard_markers(pic.PICState(**state_arrays), mesh)
    qn = pic.quasi_neutrality_coef(pp, dtype=torch.float64)
    s1 = sharded.pic_sharded_step(pp, mesh, qn, s0, 0.25)
    return _rank0(mesh, dict(assembly=M, solve=solved, pic_field=s1.field))


def spike_solve_card(cfg, n, kw):
    """The ranks of a rows mesh on CUDA cards (NCCL): spike.solve in
    float32 from GUESS, with K1's launches in this rank."""
    from emme_tpu_torch.ops import cuda_kappa
    mesh = mesh_mod.make_mesh()
    p = et.from_config(dict(cfg, npoints=n), dtype=torch.float32,
                       device=mesh.device)
    cuda_kappa.LAUNCHES = 0
    om, vec, steps, M = spike.solve(p, -0.8 + 0.25j, mesh, **kw)
    return _rank0(mesh, dict(omega=om, steps=steps, vec=vec.cpu(),
                             device=str(M.data.device),
                             k1_launches=cuda_kappa.LAUNCHES))
