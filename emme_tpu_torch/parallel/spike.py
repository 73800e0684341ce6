"""Distributed block-banded factorization, solve and Newton-trace step
(SPIKE + Woodbury) over the ``rows`` axis of a mesh.

Counterpart of ``emme_tpu/parallel/spike.py``.  The band's block rows shard
over ``rows`` and every rank factors its LOCAL diagonal block (nb / S
sequential steps instead of nb); the coupling between shards is handled
exactly by a Woodbury correction on the shard interfaces:

    M = D + P K P^T
      D = blockdiag(A_0..A_{S-1})   (per-shard banded blocks, h <= nbl)
      P = edge selectors (top / bottom h block rows of every shard)
      K = interface corner blocks E_s (and E_s^T -- M is complex symmetric)

    M^{-1} = D^{-1} - X (I + K G)^{-1} K X^T,   X = D^{-1} P,  G = P^T X

so a distributed solve is a local banded solve plus a correction by the
r x r reduced system (r = 2 S h bs), replicated on every rank; and

    tr(M^{-1} dM) = sum_s tr(A_s^{-1} dM_ss)                (local Takahashi)
                  - tr((I + K G)^{-1} K (X^T dD X + G K' G))  (reduced)

with dM = dD + P K' P^T split the same way.  In shard-interface groups
[t_s, b_s] (2m wide, m = h bs), R = I + K G is block-tridiagonal with
identity diagonal blocks: the correction solve is block-Thomas and the trace
term needs R^{-1} only out to block offset 2 -- O(S m^3).

The reduced algebra works on complex tensors, stacked over the interface
axis; the JAX package's (re, im) planes were the TPU's workaround.  Its loops
over S are Python loops (S is the number of ranks).  Each rank assembles only
its own block rows (``sparse_eigen.assemble_bdia_window``, kernel table over
its rows and the de_max halo, through K1 for float32), so the quadrature
divides over the ranks too.
"""

from __future__ import annotations

import torch

from ..grid import Grid
from ..ops import banded, kernels
from ..ops.singularity import singularity_coeff_band
from ..ops.sparse import BDIAOperator, bdia_matvec
from ..solvers import eigen, newton
from ..solvers import sparse_eigen as se
from . import mesh as mesh_mod
from .sharded import bdia_matvec_local


# ---------------------------------------------------------------------------
# block-tridiagonal reduced algebra.  K is block-tridiagonal with zero
# diagonal (K[s, s+1] = [[0, 0], [E_s, 0]], K[s+1, s] its symmetric mirror),
# G block-diagonal, so R = I + K G is block-tridiagonal with identity
# diagonal blocks.  Blocks are stacked (k, p, q) complex tensors.
# ---------------------------------------------------------------------------

def _eye(n2: int, like):
    return torch.eye(n2, dtype=like.dtype, device=like.device)


def _trace_prod(a, b):
    """sum_s tr(a_s b_s) over stacked (k, p, p) blocks."""
    return torch.einsum("spq,sqp->", a, b)


def _reduced_tridiag(E_all, G_all, S: int, m: int):
    """Off-diagonal blocks of R = I + K G in shard groups, stacked
    (S-1, 2m, 2m): Rsup[s] = K[s, s+1] G_{s+1} (rows m:2m <- E_s
    G_{s+1}[0:m, :]), Rsub[s] = K[s+1, s] G_s (rows 0:m <- E_s^T
    G_s[m:2m, :])."""
    E = E_all[:S - 1]
    low = E @ G_all[1:, :m, :]
    up = E.transpose(-1, -2) @ G_all[:S - 1, m:, :]
    return (torch.cat([torch.zeros_like(low), low], dim=1),
            torch.cat([up, torch.zeros_like(up)], dim=1))


def _bt_factor(Rsup, Rsub):
    """Forward and backward block-Schur complements of the unit-diagonal
    block-tridiagonal R: D (the LU pivots) and Ebar (the UL pivots),
    stacked (S, n2, n2)."""
    S = Rsup.shape[0] + 1
    eye = _eye(Rsup.shape[-1], Rsup)
    D = [eye]
    for s in range(S - 1):
        D.append(eye - Rsub[s] @ torch.linalg.solve(D[-1], Rsup[s]))
    Ebar = [eye]
    for s in range(S - 2, -1, -1):
        Ebar.insert(0, eye - Rsup[s] @ torch.linalg.solve(Ebar[0], Rsub[s]))
    return torch.stack(D), torch.stack(Ebar)


def _bt_solve(Rsup, Rsub, D, b):
    """Block-Thomas solve R x = b for stacked right-hand sides b
    (S, n2, k)."""
    S = b.shape[0]
    y = [b[0]]
    for s in range(1, S):
        y.append(b[s] - Rsub[s - 1] @ torch.linalg.solve(D[s - 1], y[-1]))
    x = [torch.linalg.solve(D[S - 1], y[S - 1])]
    for s in range(S - 2, -1, -1):
        x.insert(0, torch.linalg.solve(D[s], y[s] - Rsup[s] @ x[0]))
    return torch.stack(x)


def _bt_z_band(Rsup, Rsub, D, Ebar):
    """Selected inverse of the block-tridiagonal R out to block offset 2:
    Z_ss = (D_s + Ebar_s - I)^{-1}; Z_{s, j+1} = -Z_{s, j} Rsup_j
    Ebar_{j+1}^{-1} (rightward), Z_{j+1, s} = -Ebar_{j+1}^{-1} Rsub_j
    Z_{j, s} (downward).  Returns (Zd, Zsup1, Zsub1, Zsup2, Zsub2)."""
    S = D.shape[0]
    iEbar = torch.linalg.inv(Ebar)
    Zd = torch.linalg.inv(D + Ebar - _eye(D.shape[-1], D))
    Zsup1 = -Zd[:S - 1] @ (Rsup @ iEbar[1:])
    Zsub1 = -iEbar[1:] @ (Rsub @ Zd[:S - 1])
    Zsup2 = -Zsup1[:max(S - 2, 0)] @ (Rsup[1:] @ iEbar[2:])
    Zsub2 = -iEbar[2:] @ (Rsub[1:] @ Zsub1[:max(S - 2, 0)])
    return Zd, Zsup1, Zsub1, Zsup2, Zsub2


def _vksup(E, X, m: int):
    """Stacked K[s, s+1] X[s] = [[0], [E_s X_s_top]]."""
    low = E @ X[:, :m, :]
    return torch.cat([torch.zeros_like(low), low], dim=1)


def _vksub(E, X, m: int):
    """Stacked K[s+1, s] X[s] = [[E_s^T X_s_bot], [0]]."""
    up = E.transpose(-1, -2) @ X[:, m:, :]
    return torch.cat([up, torch.zeros_like(up)], dim=1)


# ---------------------------------------------------------------------------
# this rank's shard
# ---------------------------------------------------------------------------

def _mask_local(data, offsets, nbl: int):
    """Zero the blocks (i, i+d) that cross the shard boundary: the SPIKE
    diagonal block A_s."""
    i = torch.arange(nbl, device=data.device)
    return torch.stack([
        data[k] * ((i + d >= 0) & (i + d < nbl))[:, None, None]
        for k, d in enumerate(offsets)])


def _right_corner(data, offsets, h: int, bs: int, nbl: int):
    """Interface corner E_s (h bs x h bs): the blocks of the shard's bottom
    h rows that cross into the next shard's top h rows.  E[a, c] is the
    block at (local row nbl-h+a, offset d = c + h - a); only 1 <= d <= h
    exists (lower-left triangle)."""
    zero = data.new_zeros((bs, bs))
    return torch.cat([
        torch.cat([data[offsets.index(c + h - a), nbl - h + a]
                   if 1 <= c + h - a <= h else zero for c in range(h)], dim=1)
        for a in range(h)], dim=0)


def _edge_rhs(n_s: int, m: int, like):
    """(n_s, 2m): identity at the top h and the bottom h block rows -- the
    P selector columns of one shard."""
    P = like.new_zeros((n_s, 2 * m))
    eye = _eye(m, like)
    P[:m, :m] = eye
    P[n_s - m:, m:] = eye
    return P


def _edge_rows(Z, m: int):
    """P^T Z: the top and bottom h block rows, (2m, cols)."""
    return torch.cat([Z[:m], Z[-m:]])


def _spike_factor(data_local, offsets, h: int, bs: int):
    """The shard's factorization: banded LU of the masked local block, the
    edge spikes X_s = A_s^{-1} [P^t, P^b] and the corner G_s = P^T X_s."""
    nbl = data_local.shape[1]
    n_s, m = nbl * bs, h * bs
    masked = _mask_local(data_local, offsets, nbl)
    lu = banded.banded_lu(BDIAOperator(data=masked, offsets=offsets, n=n_s,
                                       block=bs))
    X = banded.banded_solve(lu, _edge_rhs(n_s, m, data_local))
    return lu, X, _edge_rows(X, m)


def _gather_E(data_local, offsets, h, bs, nbl, mesh):
    """The interface corners of every shard, stacked (S, m, m); E[s]
    couples shard s's bottom edge to shard s+1's top (the last is zero)."""
    E = _right_corner(data_local, offsets, h, bs, nbl)
    if mesh.row == mesh.n_rows - 1:
        E = torch.zeros_like(E)
    return mesh_mod.all_gather(E, mesh)


def _gather_blocks(B, mesh):
    """Every shard's (p, q) block, stacked (S, p, q)."""
    return mesh_mod.all_gather(B, mesh)


def _spike_reduced(E_all, G_all, S: int, m: int):
    """The reduced system: the off-diagonal blocks of R = I + K G and its
    block-Thomas factors."""
    Rsup, Rsub = _reduced_tridiag(E_all, G_all, S, m)
    D, Ebar = _bt_factor(Rsup, Rsub)
    return Rsup, Rsub, D, Ebar


def _spike_apply_inverse(lu, X, E_all, red, f, mesh):
    """This rank's segment of z = M^{-1} f (f: its (n_s,) or (n_s, k)
    segment): local solve, the edge values gathered, the block-Thomas
    correction (none on one shard)."""
    if X is None:
        return banded.banded_solve(lu, f)
    Rsup, Rsub, D, _ = red
    S, m = mesh.n_rows, X.shape[1] // 2
    vec = f.dim() == 1
    g = banded.banded_solve(lu, f[:, None] if vec else f)
    u = _gather_blocks(_edge_rows(g, m), mesh)                # (S, 2m, k)
    zero = torch.zeros_like(u[:1])
    b = (torch.cat([zero, _vksub(E_all[:S - 1], u[:S - 1], m)])
         + torch.cat([_vksup(E_all[:S - 1], u[1:], m), zero]))
    w = _bt_solve(Rsup, Rsub, D, b)
    z = g - X @ w[mesh.row]
    return z[:, 0] if vec else z


def _spike_trace(lu, X, G_all, E_all, red, dM_local, offsets, h, bs, mesh):
    """tr(M^{-1} dM), exactly: sum_s tr(A_s^{-1} dM_ss) - tr(R^{-1} K H),
    H = X^T dD X + G K' G.  K, K', H and R are block-tridiagonal in shard
    groups, so the correction runs on R's selected inverse out to offset
    2.  The same complex 0-d tensor on every rank."""
    nbl = dM_local.shape[1]
    S, m = mesh.n_rows, h * bs
    dD = BDIAOperator(data=_mask_local(dM_local, offsets, nbl),
                      offsets=offsets, n=nbl * bs, block=bs)
    t1 = mesh_mod.psum(banded.banded_trace_product(
        banded.banded_selected_inverse(lu), dD), mesh)
    if X is None:
        return t1

    Rsup, Rsub, D, Ebar = red
    Hd = _gather_blocks(X.transpose(0, 1) @ bdia_matvec(dD, X), mesh)
    Ep = _gather_E(dM_local, offsets, h, bs, nbl, mesh)[:S - 1]
    # (G K' G)[s, s+1] = G_s[:, b] E'_s G_{s+1}[t, :] and its mirror
    Hsup = (G_all[:S - 1, :, m:] @ Ep) @ G_all[1:, :m, :]
    Hsub = (G_all[1:, :, :m] @ Ep.transpose(-1, -2)) @ G_all[:S - 1, m:, :]
    # B = K H out to offset 2 (K couples only neighbours)
    E = E_all[:S - 1]
    zero = torch.zeros_like(Hd[:1])
    Bdiag = (torch.cat([zero, _vksub(E, Hsup, m)])
             + torch.cat([_vksup(E, Hsub, m), zero]))
    Bsup1 = _vksup(E, Hd[1:], m)
    Bsub1 = _vksub(E, Hd[:S - 1], m)
    Bsup2 = _vksup(E_all[:max(S - 2, 0)], Hsup[1:], m)
    Bsub2 = _vksub(E_all[1:S - 1], Hsub[:max(S - 2, 0)], m)
    # t2 = tr(R^{-1} B) over the band: sum_{|d|<=2} tr(Z_{s,s+d} B_{s+d,s})
    Zd, Zsup1, Zsub1, Zsup2, Zsub2 = _bt_z_band(Rsup, Rsub, D, Ebar)
    t2 = sum(_trace_prod(z, b_) for z, b_ in (
        (Zd, Bdiag), (Zsup1, Bsub1), (Zsub1, Bsup1), (Zsup2, Bsub2),
        (Zsub2, Bsup2)))
    return t1 - t2


# ---------------------------------------------------------------------------
# the distributed operator: assembly, the Newton updates, solves
# ---------------------------------------------------------------------------

def _factor(op: BDIAOperator, mesh):
    """The SPIKE factorization of a sharded operator: (lu, X, E_all,
    G_all, reduced system).  One shard has no interface: then only its
    banded LU, and None for the rest (the edge spikes of a wide band cost
    2 h bs right-hand sides)."""
    h, bs = max(op.offsets), op.block
    nbl = op.data.shape[1]
    if mesh.n_rows == 1:
        return banded.banded_lu(op), None, None, None, None
    lu, X, G = _spike_factor(op.data, op.offsets, h, bs)
    E_all = _gather_E(op.data, op.offsets, h, bs, nbl, mesh)
    G_all = _gather_blocks(G, mesh)
    return lu, X, E_all, G_all, _spike_reduced(E_all, G_all, mesh.n_rows,
                                               h * bs)


def sharded_assemble_bdia(p, grid: Grid, coeff_band, omega, h: int,
                          block: int, mesh, quad=None, chunk=None,
                          tiers=None, fused: bool = False) -> BDIAOperator:
    """This rank's block rows of the operator, built in place (kernel table
    over its rows and the halo): a BDIAOperator whose ``data`` holds rows
    [row nbl, (row + 1) nbl) of the global one, ``n`` the global
    dimension."""
    dim = 2 * grid.npoints if p.electromagnetic else grid.npoints
    nb = dim // block
    if nb % mesh.n_rows:
        raise ValueError(f"{nb} block rows do not divide over "
                         f"{mesh.n_rows} ranks")
    nbl = nb // mesh.n_rows
    data = se.assemble_bdia_window(p, grid, coeff_band, omega, h, block,
                                   mesh.row * nbl, nbl, quad, chunk, tiers,
                                   fused)
    return BDIAOperator(data=data, offsets=tuple(range(-h, h + 1)), n=dim,
                        block=block)


def sharded_trace_d_omega(op: BDIAOperator, dop: BDIAOperator, mesh):
    """d_omega = -1 / tr(M^{-1} dM): the whole chain (local LU and
    Takahashi, edge spikes, reduced correction) on sharded operators."""
    lu, X, E_all, G_all, red = _factor(op, mesh)
    return -1.0 / _spike_trace(lu, X, G_all, E_all, red, dop.data,
                               op.offsets, max(op.offsets), op.block, mesh)


def sharded_solve_vec(op: BDIAOperator, mesh, f):
    """This rank's segment of z = M^{-1} f from its segment of f."""
    lu, X, E_all, _G_all, red = _factor(op, mesh)
    return _spike_apply_inverse(lu, X, E_all, red, f, mesh)


def _inverse_iteration(op, mesh, factors, iters: int):
    """This rank's segment of the normalized inverse-iteration vector from
    the JAX package's start 1 + 0.3 i (k/n - 0.5)."""
    lu, X, E_all, _G_all, red = factors
    n_s = op.data.shape[1] * op.block
    rdtype = op.data.real.dtype
    k = torch.arange(n_s, dtype=rdtype, device=op.data.device) \
        + mesh.row * n_s
    v = torch.complex(torch.ones_like(k), 0.3 * (k / op.n - 0.5))
    for _ in range(iters):
        v = _spike_apply_inverse(lu, X, E_all, red, v, mesh)
        v = v / mesh_mod.psum((v.abs() ** 2).sum(), mesh).sqrt()
    return v


def sharded_bordered_d_omega(op: BDIAOperator, dop: BDIAOperator, mesh,
                             iters: int = 3):
    """Distributed bordered-Newton update d_omega = -(v^T M v) / (v^T dM v)
    with v from SPIKE inverse iteration -- the mesh counterpart of
    ``sparse_eigen.bordered_newton_step`` ("QRSecant" on the banded path).
    The bilinears are halo-exchange matvecs (``bdia_matvec_local``) summed
    over the ranks."""
    v = _inverse_iteration(op, mesh, _factor(op, mesh), iters)
    halo = max(op.offsets)

    def bilinear(data):
        y = bdia_matvec_local(data, op.offsets, halo, mesh, v)
        return mesh_mod.psum((v * y).sum(), mesh)

    return -bilinear(op.data) / bilinear(dop.data)


def sharded_nullspace(op: BDIAOperator, mesh, iters: int = 3):
    """This rank's segment of the inverse-iteration null vector
    (cf. solver.h:58-112), the SPIKE factorization built once."""
    return _inverse_iteration(op, mesh, _factor(op, mesh), iters)


def gather_operator(op: BDIAOperator, mesh) -> BDIAOperator:
    """The whole operator from its sharded block rows, on every rank."""
    return BDIAOperator(data=mesh_mod.all_gather(op.data, mesh, dim=1,
                                                 tiled=True),
                        offsets=op.offsets, n=op.n, block=op.block)


# ---------------------------------------------------------------------------
# the distributed sparse eigensolve
# ---------------------------------------------------------------------------

def solve(p, omega_init, mesh, tol: float | None = None, quad=None,
          chunk: int | None = None, dtype=None,
          band_deta: float | None = None, block: int | None = None,
          tiered: bool | None = None, stats: dict | None = None,
          host64: bool = False, fused: bool | None = None,
          method: str = "TraceSecant"):
    """Distributed banded eigensolve: the whole Newton step -- assembly,
    banded factorization, exact trace or bordered bilinears, secant update
    -- runs sharded over the ``rows`` axis.  Seeding, stop rules (the host
    loop of ``newton.run``: tolerance, the float32 floor, the roll-back of
    a non-finite step) and the null vector are ``sparse_eigen.solve``'s;
    each step's update is rank 0's, broadcast.

    ``method``: "TraceSecant" (the reference iteration) or "QRSecant" /
    "BorderedSecant" (both the distributed bordered update, as on the
    single-device banded path).  ``block`` defaults to
    ``pick_block(dim // rows)``; the half-bandwidth must fit one shard.
    ``fused``: kernel tables through K1 (default on for float32; the plain
    version on CPU tensors; ``eigen.discretization``).  ``host64``:
    ``sparse_eigen.host64_polish_banded`` on the gathered operator on rank
    0 of ``rows``, broadcast to the others.  ``stats`` gets mesh_rows,
    block, h, nnz.
    Returns (omega, eigenvector, n_steps, M) on every rank, M the gathered
    operator."""
    if method not in ("TraceSecant", "QRSecant", "BorderedSecant"):
        raise ValueError(f"method must be TraceSecant|QRSecant|"
                         f"BorderedSecant, got {method!r}")
    tol = tol if tol is not None else 1e-6
    dtype = dtype if dtype is not None else p.length.dtype
    device = p.length.device
    band_deta = band_deta if band_deta is not None else se.DEFAULT_BAND_DETA
    grid = Grid.create(p.length, p.npoints, dtype=dtype, device=device)
    dim = 2 * p.npoints if p.electromagnetic else p.npoints
    S = mesh.n_rows
    if block is None:
        block = se.pick_block(dim // S)
    h = se.band_halfwidth(p, grid, block, band_deta)
    nbl = (dim // block) // S
    if h > nbl:
        raise ValueError(
            f"shard too narrow: half-bandwidth {h} blocks > {nbl} local "
            f"block rows (raise block size or lower mesh rows)")
    w_el = se.em_de_max(p.npoints, h, block) if p.electromagnetic \
        else (h + 1) * block - 1
    coeff_band = singularity_coeff_band(p.npoints, w_el, dtype=dtype,
                                        device=device)
    tiers, fused = eigen.discretization(p, dtype, tiered, fused)
    cdtype = kernels.complex_dtype(dtype)
    d_fn = sharded_trace_d_omega if method == "TraceSecant" \
        else sharded_bordered_d_omega

    def assemble(om):
        return sharded_assemble_bdia(p, grid, coeff_band, om, h, block, mesh,
                                     quad, chunk, tiers, fused)

    def step(state):
        d_omega = mesh_mod.broadcast(d_fn(state.M, state.dM, mesh), mesh)
        return newton.advance(state, d_omega, assemble, se.bdia_secant)

    state = newton.seed(
        assemble,
        torch.tensor(complex(omega_init), dtype=cdtype, device=device),
        se.bdia_secant, se.SparseEigenState)
    state, n_steps, omega = newton.run(
        step, state, tol, p.iteration_step_limit + 1, dtype != torch.float64,
        method=method, mesh_rows=S)
    M_full = gather_operator(state.M, mesh)
    if stats is not None:
        stats.update(mesh_rows=S, block=block, h=h, nnz=M_full.nnz)
    if host64:
        dM_full = gather_operator(state.dM, mesh)
        buf = torch.zeros(dim + 2, dtype=torch.complex128, device=device)
        if mesh.row == 0:
            om, v, extra = se.host64_polish_banded(
                se.SparseEigenState(omega=state.omega, d_omega=state.d_omega,
                                    M=M_full, dM=dM_full),
                se.assembler(p, grid, coeff_band, h, block, quad, chunk,
                             tiers, fused),
                tol, omega=omega)
            buf[0], buf[1:-1], buf[-1] = om, v, extra
        buf = mesh_mod.broadcast(buf, mesh)
        omega, vec = complex(buf[0].item()), buf[1:-1]
        n_steps += int(buf[-1].real.item())
    else:
        vec = mesh_mod.all_gather(sharded_nullspace(state.M, mesh), mesh,
                                  tiled=True)
    if p.electromagnetic:
        vec = se.deinterleave(vec)
    return omega, vec, n_steps, M_full
