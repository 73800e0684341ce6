"""Never-dense (block-banded) eigensolve of the gyrokinetic operator M(omega).

Counterpart of ``emme_tpu/solvers/sparse_eigen.py``.  The kernel-integral
operator (reference assembly ``solver.h:417-515``) decays algebraically in
|eta - eta'| while its eigenvectors are localized along the field line, so
a banded truncation |eta - eta'| <= band_deta reproduces the eigenvalue at
a fraction of the dense operator.  The dense matrix never exists:

* ``assemble_bdia`` evaluates kernel integrals only for pairs inside the
  kept block diagonals (``_kernel_table``, float32 pairs through the CUDA
  kernel K1, ``ops/cuda_kappa.py``) and lands them in BDIA block storage,
  mirroring the lower diagonals by the operator's complex symmetry.
* ``arnoldi_estimate`` runs shift-invert Arnoldi on B = M(sigma)^{-1}
  M'(sigma): the matvec is ``ops.sparse.pick_spmv`` (the CUDA kernel K5 on
  the "bsr" route) followed by the block-banded LU solves of
  ``ops/banded.py``.
* The Newton iteration is the banded trace secant (the reference's
  default, solver.h:113-160) with tr(M^{-1} dM) from block-Takahashi
  selected inversion, or the bordered secant on the smallest singular
  pair ("QRSecant").
* ``host64=True`` polishes with complex128 linear algebra on the same
  device (the JAX package's host scipy polish, moved onto the card).

The iteration is every backend's (``newton.py``, one set of stop rules for
all): driven from the host with one flag read a step (``loop="host"``, the
default) or queued with no host wait inside it (``loop="device"``).  Peak
memory is O(n * bandwidth).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import warnings
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from ..grid import Grid
from ..ops import banded, cuda_kappa, kernels
from ..ops.singularity import SINGULAR_BAND_HALF_WIDTH, singularity_coeff_band
from ..ops.sparse import BDIAOperator, bdia_matvec, pick_spmv, spmv_route
from ..params import DYNAMIC_FIELDS
from ..utils.timer import host_read, span
from . import eigen, newton
from .arnoldi import arnoldi_factorization, ritz_from_hessenberg

# Default banding cutoff |eta - eta'| <= band_deta (as emme_tpu: 20.0 keeps
# the dropped pairs' eigenvalue influence below ~1e-7 relative on the
# canonical tokamak).
DEFAULT_BAND_DETA = 20.0

# Pairs per kernel-table call.  Through K1 a call of 2M pairs holds its
# panel rows (mid, half-width: 2 x npairs x n_panels float32) and the
# bound temporaries in about 1.5 GB at the 44-panel tier, and the tok8192
# table (17.8M pairs) takes 10 calls an assembly.  The torch integrand
# (float64, or unfused float32) holds every node of a chunk at once, so it
# goes 2048 pairs at a time, as the dense path does.
FUSED_CHUNK = 1 << 21
PLAIN_CHUNK = 2048


def pick_block(n: int, preferred: int = 128) -> int:
    """Largest block size of (preferred, 64, 32, 16, 8) dividing n."""
    for bs in (preferred, 64, 32, 16, 8):
        if bs <= n and n % bs == 0:
            return bs
    return n


def band_halfwidth(p, grid: Grid, block: int, band_deta: float) -> int:
    """Block half-bandwidth h: every element pair with |eta_i - eta_j| <=
    band_deta lies inside block offsets [-h, h], and never narrower than
    the singularity-handler band (singularity_handler.cpp:3-24).

    Electromagnetic operators use the INTERLEAVED unknown ordering
    [phi_0, A_0, phi_1, A_1, ...]: an element pair (i, j) then occupies
    interleaved offsets |r - c| <= 2|i - j| + 1, which keeps the 2x2
    phi/A coupling inside one contiguous band."""
    w_el = max(int(np.ceil(band_deta / host_read(float, grid.dx))),
               SINGULAR_BAND_HALF_WIDTH)
    if p.electromagnetic:
        nb = 2 * grid.npoints // block
        return min((2 * w_el + 1 + block - 1) // block, nb - 1)
    nb = grid.npoints // block
    return min(-(-w_el // block), nb - 1)


def em_de_max(n: int, h: int, block: int) -> int:
    """Largest element offset |i - j| reachable inside kept interleaved
    block diagonals 0..h (block size ``block``, matrix dim 2n)."""
    return min(((h + 1) * block) // 2, n - 1)


def bdia_secant(op_new: BDIAOperator, op_old: BDIAOperator, d_omega):
    """(M_new - M_old) / d_omega (solver.h:54-57)."""
    return BDIAOperator(data=(op_new.data - op_old.data) * (1.0 / d_omega),
                        offsets=op_new.offsets, n=op_new.n,
                        block=op_new.block)


def _cdot_bilinear(v, w):
    """v^T w, unconjugated (complex symmetry is a transpose)."""
    return (v * w).sum()


# ---------------------------------------------------------------------------
# direct-to-BDIA assembly
# ---------------------------------------------------------------------------

def table_sections(quad, rdtype, de_max: int, tiers):
    """The kernel table's row ranges [(lo_de, hi_de, quad)], one per
    |i - j| tier that the rows 1..de_max reach."""
    if tiers is None:
        return [(1, de_max, quad)]
    sections = []
    lo_de = 1
    for ij_ub, scale in tiers:
        hi_de = min(de_max, max(lo_de - 1, ij_ub - 1))
        if hi_de >= lo_de:
            sections.append(
                (lo_de, hi_de, kernels.scaled_quad(quad, rdtype, scale)))
            lo_de = hi_de + 1
    if lo_de <= de_max:
        sections.append((lo_de, de_max,
                         kernels.scaled_quad(quad, rdtype, tiers[-1][1])))
    return sections


def table_pairs(grid: Grid, lo_de: int, start: int, stop: int, i0: int = 0,
                ncols: int | None = None):
    """(eta_a, eta_b) of flat pairs [start, stop) of a table section whose
    first row is de = lo_de, row by row over the columns i = i0 .. i0 +
    ncols - 1 (default: all n): pair (de, i) is (eta_i, eta_{i+de}); where
    i < 0 or i + de > n - 1 it is a dummy finite pair (eta_i clamped,
    + dx), never read by the assembly."""
    n = grid.npoints
    nc = n if ncols is None else ncols
    eta = grid.eta
    f = torch.arange(start, stop, device=eta.device)
    i = f % nc + i0
    j = i + lo_de + f // nc
    ea = eta[i.clamp(0, n - 1)]
    valid = (i >= 0) & (j <= n - 1)
    return ea, torch.where(valid, eta[j.clamp(0, n - 1)], ea + grid.dx)


def table_pair_chunks(grid: Grid, de_max: int, quad, tiers, chunk: int,
                      i0: int = 0, ncols: int | None = None):
    """Yield (eta_a, eta_b, quad) for the padded (de, i) kernel table over
    the columns i0 .. i0 + ncols - 1 (default: all n), section by section,
    ``chunk`` pairs at a time."""
    nc = grid.npoints if ncols is None else ncols
    for lo_de, hi_de, q in table_sections(quad, grid.eta.dtype, de_max,
                                          tiers):
        npairs = (hi_de - lo_de + 1) * nc
        for s in range(0, npairs, chunk):
            yield (*table_pairs(grid, lo_de, s, min(s + chunk, npairs),
                                i0, ncols), q)


def _kernel_table(p, grid, omega, de_max: int, ms, quad, chunk, tiers,
                  electron: bool = False, fused: bool = False, i0: int = 0,
                  ncols: int | None = None):
    """Ordered-pair kernel table over the padded (de, i) grid: row de - 1
    holds kappa(eta_i, eta_{i+de}) for i = i0 .. i0 + ncols - 1 (default:
    0 .. n - 1; entries with i < 0 or i + de >= n hold a dummy pair and
    must not be read).  Returns one complex (de_max, ncols) tensor per m in
    ``ms``; float32 chunks go through K1 when ``fused``.  ``i0`` and
    ``ncols`` serve the window assembly of the mesh-sharded solve: a shard
    computes only the columns of its own block rows and the de_max halo."""
    with span("assembly.pairs"):
        nc = grid.npoints if ncols is None else ncols
        cdtype = kernels.complex_dtype(grid.eta.dtype)
        out = [torch.empty(de_max * nc, dtype=cdtype, device=grid.eta.device)
               for _ in ms]
        o = 0
        for a, b, q in table_pair_chunks(grid, de_max, quad, tiers, chunk, i0,
                                         ncols):
            if fused:
                vals = cuda_kappa.kappa_pairs_fused(p, a, b, omega, ms=ms,
                                                    quad=q)
            else:
                vals, _ = kernels.kappa_f_tau(p, a, b, omega, ms=ms, quad=q)
            if electron:
                vals = (vals[0],
                        vals[1] + kernels.kappa_f_tau_e(p, a, b, omega, 1),
                        vals[2] + kernels.kappa_f_tau_e(p, a, b, omega, 2))
            for t, v in zip(out, vals):
                t[o:o + a.shape[0]] = v
            o += a.shape[0]
        return [t.reshape(de_max, nc) for t in out]


def _flat_table(T, n):
    """(de_max, n) table -> flat (de_max + 1) * n with a zero row 0, so an
    |i - j| = 0 gather reads 0 before the diagonal override."""
    return torch.cat([torch.zeros((1, n), dtype=T.dtype, device=T.device),
                      T]).reshape(-1)


def _block_index(nrow: int, bs: int, d: int, device):
    """Global (row, col) indices of the blocks on block diagonal d,
    (nrow, bs, bs) each."""
    blk = torch.arange(nrow, device=device)[:, None, None]
    a = torch.arange(bs, device=device)
    return blk * bs + a[None, :, None], (blk + d) * bs + a[None, None, :]


def _mirror(pos_blocks, nb: int):
    """Diagonals 0..h (bottom-padded) -> the stacked -h..h BDIA data: the
    negative diagonals are the transposes (complex symmetry M[j][i] =
    M[i][j], solver.h:446-459)."""
    h = len(pos_blocks) - 1
    neg = []
    for d in range(1, h + 1):
        t = pos_blocks[d][:nb - d].transpose(-1, -2)
        neg.append(torch.cat([t.new_zeros((d,) + t.shape[1:]), t]))
    return torch.stack(neg[::-1] + pos_blocks)


def _pad_rows(v, d: int):
    return torch.cat([v, v.new_zeros((d,) + v.shape[1:])]) if d else v


def assemble_bdia(p, grid: Grid, coeff_band, omega, h: int, block: int,
                  quad=None, chunk: int | None = None, tiers=None,
                  fused: bool = False) -> BDIAOperator:
    """Assemble the electrostatic operator directly into BDIA storage
    (electromagnetic operators go to ``_assemble_bdia_em``).

    Kernel integrals are evaluated only for pairs in block diagonals 0..h;
    the negative diagonals mirror.  ``coeff_band``: (n, 2h'+1) banded
    singularity coefficients (``singularity_coeff_band``) covering at least
    the kept band.  ``chunk``: pairs per kernel-table call (default
    ``FUSED_CHUNK`` through K1, ``PLAIN_CHUNK`` otherwise).  Returns a
    BDIAOperator with offsets (-h..h)."""
    if chunk is None:
        chunk = FUSED_CHUNK if fused else PLAIN_CHUNK
    if p.electromagnetic:
        return _assemble_bdia_em(p, grid, coeff_band, omega, h, block,
                                 quad, chunk, tiers, fused)
    n = grid.npoints
    bs = block
    nb = n // bs
    dev = grid.eta.device
    cw = coeff_band.shape[1] // 2
    ncol = coeff_band.shape[1]
    de_max = min((h + 1) * bs - 1, n - 1)
    T = _kernel_table(p, grid, omega, de_max, (0,), quad, chunk, tiers,
                      fused=fused)[0]
    with span("assembly.place"):
        T = _flat_table(T, n)
        coeff_flat = coeff_band.reshape(-1)
        diag_phi = (1.0 + 1.0 / p.tau).to(grid.eta.dtype)
        diag_val = torch.complex(diag_phi, torch.zeros_like(diag_phi))

        pos_blocks = []
        for d in range(h + 1):
            i_idx, j_idx = _block_index(nb - d, bs, d, dev)
            adiff = (j_idx - i_idx).abs()
            lo = torch.minimum(i_idx, j_idx)
            cvals = coeff_flat[lo * ncol + adiff.clamp(max=cw) + cw]
            v = -T[adiff * n + lo] * cvals * grid.dx
            if d == 0:
                v = torch.where(i_idx == j_idx, diag_val, v)
            pos_blocks.append(_pad_rows(v, d))
        return BDIAOperator(data=_mirror(pos_blocks, nb),
                            offsets=tuple(range(-h, h + 1)), n=n, block=bs)


def _assemble_bdia_em(p, grid: Grid, coeff_band, omega, h: int, block: int,
                      quad, chunk: int, tiers, fused: bool) -> BDIAOperator:
    """Electromagnetic direct-to-BDIA assembly in the INTERLEAVED ordering
    [phi_0, A_0, phi_1, A_1, ...] (matrix dim 2n).

    The reference's [phi; A] layout (solver.h:461-511) puts the phi-A
    coupling n columns off the diagonal; interleaving folds the 2x2
    structure of an element pair into one contiguous block band.  Entry
    map (ii = r//2, jj = c//2, s = sign(jj - ii); one kernel table per
    ordered element pair, shared by all four components, the electron
    closed forms included):

        (phi, phi)  -K0 * coeff(min, |d|) * dx     diag: 1 + 1/tau
        (phi, A)     s * K1 * dx                   diag: 0    (U antisym)
        (A, phi)    -s * K1 * dx                   diag: 0    (U^T = -U)
        (A, A)       K2 * dx                       diag: 2 tau/beta_e bi(eta)

    The interleaved matrix is complex symmetric, so negative diagonals
    mirror by transposition as in the electrostatic path."""
    n = grid.npoints
    bs = block
    dim = 2 * n
    nb = dim // bs
    dev = grid.eta.device
    rdtype = grid.eta.dtype
    cw = coeff_band.shape[1] // 2
    ncol = coeff_band.shape[1]
    de_max = em_de_max(n, h, bs)
    tables = _kernel_table(p, grid, omega, de_max, (0, 1, 2), quad, chunk,
                           tiers, electron=True, fused=fused)
    with span("assembly.place"):
        T0, T1, T2 = (_flat_table(t, n) for t in tables)
        coeff_flat = coeff_band.reshape(-1)
        diag_phi = (1.0 + 1.0 / p.tau).to(rdtype)
        diag_A = ((2.0 * p.tau) / p.beta_e * p.bi(grid.eta)).to(rdtype)

        pos_blocks = []
        for d in range(h + 1):
            r_idx, c_idx = _block_index(nb - d, bs, d, dev)
            ii = r_idx // 2
            jj = c_idx // 2
            de = jj - ii
            adiff = de.abs()
            lo = torch.minimum(ii, jj)
            pos = adiff * n + lo
            sgn = torch.sign(de).to(rdtype)
            even_r = r_idx % 2 == 0
            usign = torch.where(even_r, sgn, -sgn)
            cvals = coeff_flat[lo * ncol + adiff.clamp(max=cw) + cw]
            phiphi = even_r & (c_idx % 2 == 0)
            AA = ~even_r & (c_idx % 2 == 1)
            v = torch.where(phiphi, -T0[pos] * cvals,
                            torch.where(AA, T2[pos], usign * T1[pos]))
            v = v * grid.dx
            if d == 0:
                dvals = torch.where(even_r, diag_phi, diag_A[ii])
                dvals = torch.complex(dvals, torch.zeros_like(dvals))
                v = torch.where(r_idx == c_idx, dvals, v)
            pos_blocks.append(_pad_rows(v, d))
        return BDIAOperator(data=_mirror(pos_blocks, nb),
                            offsets=tuple(range(-h, h + 1)), n=dim, block=bs)


def assemble_bdia_window(p, grid: Grid, coeff_band, omega, h: int,
                         block: int, row0: int, nbl: int, quad=None,
                         chunk: int | None = None, tiers=None,
                         fused: bool = False):
    """Block rows [row0, row0 + nbl) of the global BDIA operator, all 2h+1
    diagonals built directly (no transpose mirroring; the blocks that cross
    into a neighbouring window are included -- the SPIKE path masks and
    extracts them itself).  Electrostatic or electromagnetic (interleaved
    ordering, as ``_assemble_bdia_em``).

    The kernel table covers only the window's columns [row0 bs - de_max,
    (row0 + nbl) bs) (element rows for an electromagnetic operator), so the
    quadrature -- the dominant cost -- divides over the shards, halo
    included.  float32 tables go through K1 when ``fused``; ``chunk``
    defaults as in ``assemble_bdia``.  Returns complex (2h+1, nbl, bs, bs),
    the layout of ``BDIAOperator.data`` rows."""
    if chunk is None:
        chunk = FUSED_CHUNK if fused else PLAIN_CHUNK
    n = grid.npoints
    bs = block
    dev = grid.eta.device
    rdtype = grid.eta.dtype
    em = bool(p.electromagnetic)
    dim = 2 * n if em else n
    de_max = em_de_max(n, h, bs) if em else min((h + 1) * bs - 1, n - 1)
    el0 = (row0 * bs) // 2 if em else row0 * bs     # first element row
    nel = (nbl * bs) // 2 if em else nbl * bs       # element rows in window
    i0 = el0 - de_max
    ncols = nel + de_max
    ms = (0, 1, 2) if em else (0,)
    tables = _kernel_table(p, grid, omega, de_max, ms, quad, chunk, tiers,
                           electron=em, fused=fused, i0=i0, ncols=ncols)
    with span("assembly.place"):
        T = [_flat_table(t, ncols) for t in tables]
        coeff_flat = coeff_band.reshape(-1)
        ncol = coeff_band.shape[1]
        cw = ncol // 2
        diag_phi = (1.0 + 1.0 / p.tau).to(rdtype)
        if em:
            diag_A = ((2.0 * p.tau) / p.beta_e * p.bi(grid.eta)).to(rdtype)

        blocks = []
        for d in range(-h, h + 1):
            r_idx, c_idx = _block_index(nbl, bs, d, dev)
            r_idx, c_idx = r_idx + row0 * bs, c_idx + row0 * bs
            ii, jj = (r_idx // 2, c_idx // 2) if em else (r_idx, c_idx)
            de = jj - ii
            adiff = de.abs()
            lo = torch.minimum(ii, jj).clamp(max(i0, 0), i0 + ncols - 1)
            valid = (c_idx >= 0) & (c_idx < dim)
            pos = adiff.clamp(max=de_max) * ncols + (lo - i0)
            cvals = coeff_flat[lo * ncol + adiff.clamp(max=cw) + cw]
            if not em:
                v = -T[0][pos] * cvals
            else:
                sgn = torch.sign(de).to(rdtype)
                even_r = r_idx % 2 == 0
                usign = torch.where(even_r, sgn, -sgn)
                phiphi = even_r & (c_idx % 2 == 0)
                AA = ~even_r & (c_idx % 2 == 1)
                v = torch.where(phiphi, -T[0][pos] * cvals,
                                torch.where(AA, T[2][pos], usign * T[1][pos]))
            v = torch.where(valid, v * grid.dx, torch.zeros_like(v))
            if d == 0:
                dvals = (torch.where(even_r, diag_phi,
                                     diag_A[ii.clamp(0, n - 1)])
                         if em else diag_phi.expand(r_idx.shape))
                dvals = torch.complex(dvals, torch.zeros_like(dvals))
                v = torch.where(r_idx == c_idx, dvals, v)
            blocks.append(v)
        return torch.stack(blocks)


def deinterleave(vec):
    """Interleaved [phi_0, A_0, phi_1, A_1, ...] -> the reference block
    layout [phi; A] (solver.h:461-511)."""
    return torch.cat([vec[0::2], vec[1::2]])


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SparseEigenState:
    omega: Any      # complex 0-d tensor
    d_omega: Any
    M: Any          # BDIAOperator at omega
    dM: Any         # BDIAOperator (secant derivative)


def _inverse_iteration(lu, v, iters: int):
    """``iters`` normalized solves with the banded LU from v: amplifies the
    near-null direction by 1/sigma_min per solve (cf. solver.h:58-112)."""
    for _ in range(iters):
        v = banded.banded_solve(lu, v)
        v = v / torch.linalg.vector_norm(v)
    return v


def _null_vector(lu, n: int, dtype, iters: int = 2):
    """Inverse iteration from the JAX package's deterministic start
    1 + 0.3 i (k/n - 0.5)."""
    rdtype = torch.float64 if dtype == torch.complex128 else torch.float32
    vi = 0.3 * (torch.arange(n, dtype=rdtype, device=lu.W.device) / n - 0.5)
    return _inverse_iteration(lu, torch.complex(torch.ones_like(vi), vi),
                              iters)


def assembler(p, grid: Grid, coeff_band, h: int, block: int, quad=None,
              chunk=None, tiers=None, fused: bool = False):
    """``assemble(omega)``: ``assemble_bdia`` with everything but omega
    bound, the closure the Newton iteration calls (``newton.py``)."""
    def assemble(omega):
        return assemble_bdia(p, grid, coeff_band, omega, h, block, quad,
                             chunk, tiers, fused)
    return assemble


def _trace_delta(state):
    lu = banded.banded_lu(state.M)
    Zu = banded.banded_selected_inverse(lu)
    return -1.0 / banded.banded_trace_product(Zu, state.dM)


def _bordered_delta(state):
    lu = banded.banded_lu(state.M)
    v = _null_vector(lu, state.M.n, state.M.data.dtype)
    num = _cdot_bilinear(v, bdia_matvec(state.M, v))
    den = _cdot_bilinear(v, bdia_matvec(state.dM, v))
    return -num / den


def trace_newton_step(p, grid, coeff_band, state: SparseEigenState,
                      h: int, block: int, quad=None, chunk=None,
                      tiers=None, fused: bool = False):
    """One Newton-trace-secant step on the banded operator
    (solver.h:113-160): d_omega = -1 / tr(M^{-1} dM), with the banded trace
    computed exactly by selected inversion."""
    return newton.step(state, _trace_delta, assembler(
        p, grid, coeff_band, h, block, quad, chunk, tiers, fused),
        bdia_secant)


def bordered_newton_step(p, grid, coeff_band, state: SparseEigenState,
                         h: int, block: int, quad=None, chunk=None,
                         tiers=None, fused: bool = False):
    """One banded bordered-Newton (QR-secant analogue) step:
    d_omega = -(v^T M v) / (v^T dM v) with v by banded inverse iteration."""
    return newton.step(state, _bordered_delta, assembler(
        p, grid, coeff_band, h, block, quad, chunk, tiers, fused),
        bdia_secant)


def init_state(p, grid, coeff_band, omega_init, h, block, quad=None,
               chunk=None, tiers=None, fused: bool = False):
    """Reference ctor seeding (solver.h:396-415), banded: assemble at
    0.99 w0 and w0, secant derivative from the pair (``newton.seed``).
    ``omega_init`` is a complex 0-d tensor on the grid's device."""
    return newton.seed(assembler(p, grid, coeff_band, h, block, quad, chunk,
                                 tiers, fused), omega_init, bdia_secant,
                       SparseEigenState)


def arnoldi_estimate(state: SparseEigenState, m_krylov: int,
                     spmv: str | None = None):
    """The shift-invert stage: banded LU of M(sigma) and an m-step Arnoldi
    factorization of B = M^{-1} M', whose matvec is the SpMV of
    ``pick_spmv`` (K5 on the "bsr" route) and two banded triangular
    solves.  Returns (V, H) on the operator's device."""
    lu = banded.banded_lu(state.M)
    mv, _ = pick_spmv(state.dM, spmv)
    return arnoldi_factorization(lambda x: banded.banded_solve(lu, mv(x)),
                                 state.M.n, m_krylov, state.M.data.dtype,
                                 state.M.data.device)


def _to_c128(op: BDIAOperator) -> BDIAOperator:
    return BDIAOperator(data=op.data.to(torch.complex128),
                        offsets=op.offsets, n=op.n, block=op.block)


def host64_polish_banded(state: SparseEigenState, assemble, tol: float,
                         omega: complex | None = None, max_steps: int = 8):
    """``newton.polish`` of the banded operator, ``assemble`` an
    ``assembler``: ``emme_tpu``'s ``host64_polish_banded``, with its step
    counting and its ``default_rng(0)`` start vector, except that the
    unpivoted banded LU of ``ops/banded.py`` factors the operators on the
    device where scipy ``splu`` (which pivots rows) factors them on the
    host there."""
    c128 = torch.complex128
    dev = state.M.data.device
    n = state.M.n
    rng = np.random.default_rng(0)
    v0 = torch.as_tensor(rng.normal(size=n) + 1j * rng.normal(size=n),
                         dtype=c128, device=dev)

    def null_vec(A):
        with span("linalg.vector"):
            return _inverse_iteration(banded.banded_lu(A), v0, 3)

    return newton.polish(
        state, tol, assemble, _to_c128,
        lambda v, A: _cdot_bilinear(v, bdia_matvec(A, v)), null_vec,
        lambda new, old, d: bdia_secant(
            new, old, torch.tensor(d, dtype=c128, device=dev)),
        omega, max_steps)


def _params_on(p, device):
    """``p`` with its scalars on ``device``."""
    if p.length.device == device:
        return p
    return replace(p, **{f: getattr(p, f).to(device) for f in DYNAMIC_FIELDS})


def solve_shifts(p, sigmas, tol: float | None = None, m_krylov: int = 16,
                 workers: int = 1, **kw):
    """Banded multi-shift eigensolve: for every shift run ``solve`` (the
    shift-invert Arnoldi stage + the banded Newton polish).  Returns a list
    of (omega, vector, steps) in sigma order; a shift that fails with any
    ``Exception`` (a ``KeyError`` from a tier spec that
    ``kernels.scaled_quad`` does not know included) yields (nan, None, 0)
    after a warning naming the shift and the exception, and the sweep goes
    on, as in the JAX package.

    ``workers > 1`` solves that many shifts at once in threads.  On a CUDA
    device worker i takes card i % device_count (the parameters copied
    there) and a stream of its own, so with one card the workers share it;
    on the CPU they share the host's threads.  Each vector stays on its
    worker's device."""
    cuda = p.length.device.type == "cuda"

    def one(item):
        i, sig = item
        ctx = contextlib.nullcontext()
        pw, stream = p, None
        if cuda and workers > 1:
            dev = torch.device("cuda", i % torch.cuda.device_count())
            stream = torch.cuda.Stream(device=dev)
            stream.wait_stream(torch.cuda.default_stream(p.length.device))
            ctx = contextlib.ExitStack()
            ctx.enter_context(torch.cuda.device(dev))
            ctx.enter_context(torch.cuda.stream(stream))
            pw = _params_on(p, dev)
        with ctx:
            try:
                om, vec, steps, _ = solve(pw, sig, tol=tol,
                                          m_krylov=m_krylov, **kw)
                out = (om, vec, steps)
            except Exception as e:  # per-shift fault tolerance
                warnings.warn(f"solve_shifts: shift {sig} failed: "
                              f"{type(e).__name__}: {e}")
                out = (complex(float("nan"), float("nan")), None, 0)
        if stream is not None:
            stream.synchronize()
        return out

    items = list(enumerate(complex(s) for s in np.asarray(sigmas)))
    if workers <= 1:
        return [one(it) for it in items]
    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        return list(ex.map(one, items))


def solve(p, omega_init, tol: float | None = None, quad=None,
          chunk: int | None = None, dtype=None,
          band_deta: float | None = None, block: int | None = None,
          m_krylov: int = 0, host64: bool = False,
          stats: dict | None = None, method: str = "TraceSecant",
          tiered: bool | None = None, spmv: str | None = None,
          loop: str | None = None, fused: bool | None = None):
    """Banded end-to-end eigensolve.  Returns (omega, eigenvector, steps,
    state); ``omega`` is a Python complex, the eigenvector (in the
    reference [phi; A] layout for electromagnetic cases) and ``state``
    stay on the parameters' device.  Fills ``stats`` with nnz, block, h,
    band_fraction, spmv_route and, with the Arnoldi stage, arnoldi_omega.

    ``method``: "TraceSecant" (banded Newton trace via selected inversion,
    the reference's iteration) or "QRSecant" (bordered secant on the
    smallest singular pair).  ``m_krylov > 0`` runs the shift-invert
    Arnoldi stage first and re-seeds the Newton iteration from its Ritz
    value.  ``spmv``: "bdia" | "bsr" | None (auto, ``pick_spmv``) -- the
    route of the Arnoldi matvecs.  ``loop``:
    "host" (default: the done flag is read after every step) or "device"
    (no host wait inside the loop, the flag read one step late; it queues
    one masked step, a whole banded assembly, past convergence); both walk
    the same states (``newton.run``).  Blocking host reads are counted in
    ``newton.HOST_READS`` and the loop's record is ``newton.LAST_SOLVE``.
    ``fused``: kernel tables through K1 (default on for float32; the plain
    version on CPU tensors).  ``tiered``: coarser panel meshes for far
    pairs (default on for float32; both ``eigen.discretization``).  The
    float32 loop also stops at its run-time detected rounding floor, as
    the dense solve does.
    ``host64``: finish with ``host64_polish_banded``.
    ``layer.solve.setup`` spans the set-up up to the first assembly: the
    argument checks, the grid, the band, the coefficients, the tiers.
    """
    with span("solve.setup"):
        tol = tol if tol is not None else 1e-6
        dtype = dtype if dtype is not None else p.length.dtype
        device = p.length.device
        band_deta = band_deta if band_deta is not None else DEFAULT_BAND_DETA
        if loop is None:
            loop = "host"
        if loop not in ("host", "device"):
            raise ValueError(f"loop must be 'host' or 'device', got {loop!r}")
        if method not in ("TraceSecant", "QRSecant"):
            raise ValueError(f"method must be 'TraceSecant' or 'QRSecant', "
                             f"got {method!r}")
        grid = Grid.create(p.length, p.npoints, dtype=dtype, device=device)
        dim = 2 * p.npoints if p.electromagnetic else p.npoints
        block = block if block is not None else pick_block(dim)
        h = band_halfwidth(p, grid, block, band_deta)
        w_el = em_de_max(p.npoints, h, block) if p.electromagnetic \
            else (h + 1) * block - 1
        coeff_band = singularity_coeff_band(p.npoints, w_el, dtype=dtype,
                                            device=device)
        tiers, fused = eigen.discretization(p, dtype, tiered, fused)
        cdtype = kernels.complex_dtype(dtype)
        assemble = assembler(p, grid, coeff_band, h, block, quad, chunk, tiers,
                             fused)
        delta = _trace_delta if method == "TraceSecant" else _bordered_delta

    def init(om):
        return newton.seed(assemble,
                           torch.tensor(om, dtype=cdtype, device=device),
                           bdia_secant, SparseEigenState)

    state = init(complex(omega_init))
    if m_krylov:
        with span("linalg.arnoldi"):
            _V, H = arnoldi_estimate(state, m_krylov, spmv)
            omegas, _ = ritz_from_hessenberg(
                H, complex(newton.item(state.omega)), m_krylov)
        est = complex(omegas[0])
        if np.isfinite(est.real) and np.isfinite(est.imag):
            state = init(est)   # re-seed the Newton polish from the estimate
        if stats is not None:
            stats["arnoldi_omega"] = est

    state, n_steps, omega = newton.run(
        lambda s: newton.step(s, delta, assemble, bdia_secant), state, tol,
        p.iteration_step_limit + 1, dtype != torch.float64, loop,
        method=method)

    if stats is not None:
        stats["nnz"] = state.M.nnz
        stats["block"] = block
        stats["h"] = h
        stats["band_fraction"] = state.M.nnz / (state.M.n ** 2)
        stats["spmv_route"] = spmv_route(state.M, spmv)

    if host64:
        omega, v, extra = host64_polish_banded(state, assemble, tol,
                                               omega=omega)
        if p.electromagnetic:
            v = deinterleave(v)
        return omega, v, n_steps + extra, state

    with span("linalg.vector"):
        v = _null_vector(banded.banded_lu(state.M), state.M.n,
                         state.M.data.dtype, iters=3)
    if p.electromagnetic:
        v = deinterleave(v)
    return omega, v, n_steps, state
