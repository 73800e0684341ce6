"""The reference-exact float64 engine: adaptive Gauss-Kronrod assembly of
the dense operator, on the card through kernel N1.

Counterpart of ``emme_tpu/native.py``, which binds the multithreaded C++
engine ``native/emme_native.cpp`` on the CPU.  Here every (pair, moment)
integral is one adaptive integral of kernel N1 (``csrc/adaptive.cu``,
``ops/cuda_adaptive.py``) on a CUDA device, and of its plain PyTorch
version (``ops/adaptive.py``) where the caller asked for the CPU.  The
functions take the port's ``Params`` (float64 from ``from_config``) and
return complex128 tensors on ``p.device``.  ``n_threads`` stays in the
signatures for parity with ``emme_tpu.native`` and is not used: the card
runs the integrals in N1's warps.

``assembly_plan`` holds every omega-free input of an assembly: the
parameters (one host read), N1's pair rows and moments, the gathered
singularity coefficients, the flat index of every write into M with the
constant diagonals, and the electron term's omega-free half.  A solve makes
one and gives it to each of its assemblies; ``assemble`` without one makes
its own.  On the card a plan also carries N1's memo
(``cuda_adaptive.Memo``): the plan's first assembly runs N1 plain, its
second fills the memo with each node's omega-free half, and the later ones
read it; an assembly without a plan takes no memo.  Counted in
``ASSEMBLY_ROUTE``.  The spans: ``layer.assembly.pairs``
around the plan and around each assembly's integrals and the kernel values
made of them, ``layer.assembly.place`` around the writes into M; an
electromagnetic operator's electron closed forms open
``layer.assembly.electron`` between them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .ops import adaptive, cuda_adaptive
from .ops.adaptive import phys_from_params  # noqa: F401  (public)
from .utils.timer import span

# plans made, assemblies given a plan, assemblies that made their own, and
# of the planned, those whose N1 launch filled the plan's memo or read it
ASSEMBLY_ROUTE = {"plans": 0, "planned": 0, "unplanned": 0, "memo_fills": 0,
                  "memo_reads": 0}


def build() -> str:
    """Compile kernel N1's library (``csrc/adaptive.cu``) unless built;
    returns its path.  Raises where nvcc is missing or the build fails."""
    return cuda_adaptive.build()["path"]


def available() -> bool:
    """Whether kernel N1's library builds and loads here.  It chooses no
    path: on a CUDA device the kernel always runs (and raises if it
    cannot), on the CPU the plain version."""
    try:
        cuda_adaptive.library()
        return True
    except Exception:
        return False


def _f64(x, device):
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def g_bi(p, eta):
    """(g(eta), b_i(eta)) in float64 on ``p.device``, the engine's forms."""
    ph = phys_from_params(p)
    eta = _f64(eta, p.device)
    return adaptive.g_eta(ph, eta), adaptive.bi_eta(ph, eta)


def kappa_batch(p, m, eta, eta_p, omega, with_electron=False,
                n_threads=None):
    """Adaptive-quadrature kappa for arrays of (m, eta, eta_p): complex128
    on ``p.device`` (the ion integral, plus the closed-form electron term
    where ``with_electron``)."""
    ph = phys_from_params(p)
    eta = _f64(eta, p.device).reshape(-1)
    eta_p = _f64(eta_p, p.device).reshape(-1)
    m = torch.as_tensor(m, device=p.device).to(torch.int32)
    m = torch.broadcast_to(m, eta.shape).contiguous()
    vals, _panels, _miller = cuda_adaptive.integrate(
        adaptive.pair_rows(ph, eta, eta_p), m, adaptive.scalars(ph, omega))
    out = adaptive.ion_prefactor(ph, vals)
    if with_electron:
        out = out + adaptive.kappa_electron(ph, m, eta, eta_p, omega)
    return out


def _pair_inputs(p, ph, i, j):
    """N1's pair rows and moments for the pairs (i, j) of the grid of
    ``p``; the grid, and g and b_i on it.  g and b_i are evaluated once a
    grid point and gathered: each element's operations are
    ``adaptive.pair_rows``' of the pairs' ends."""
    n = int(p.npoints)
    dx = 2.0 * ph.length / (n - 1)
    grid = -ph.length + torch.arange(n, dtype=torch.float64,
                                     device=p.device) * dx
    g, b = adaptive.g_eta(ph, grid), adaptive.bi_eta(ph, grid)
    moments = 3 if p.electromagnetic else 1
    m = torch.arange(moments, dtype=torch.int32,
                     device=p.device).repeat(i.numel())
    i = i.to(p.device).repeat_interleave(moments)
    j = j.to(p.device).repeat_interleave(moments)
    rows = adaptive.rows_of(ph, grid[i] - grid[j], g[i] - g[j], b[i], b[j])
    return rows, m, grid, g, b


def pair_integrals(p, i, j):
    """N1's inputs for the pairs (i, j) of the engine's grid of ``p``
    (dx = 2 L / (npoints - 1)): pair rows and moments, pair-major, one
    integral per moment of the operator (m = 0, or 0, 1, 2 when
    electromagnetic); returns (rows, m, the grid's eta, Phys)."""
    ph = phys_from_params(p)
    rows, m, grid, _g, _b = _pair_inputs(p, ph, i, j)
    return rows, m, grid, ph


@dataclass(frozen=True, eq=False)
class AssemblyPlan:
    """The omega-free inputs of the dense exact operator of one ``Params``
    and singularity matrix (``assembly_plan``)."""
    ph: adaptive.Phys
    dim: int
    dx: float
    rows: torch.Tensor        # N1's pair rows, pair-major, (pairs x moments, 4)
    m: torch.Tensor           # their moments, int32
    coeff: torch.Tensor       # coeff[iu, ju], float64
    index: torch.Tensor       # flat index in M of each written value, int64
    diagonal: torch.Tensor    # the constant diagonal entries, complex128
    electron: adaptive.ElectronPairs | None   # electromagnetic only
    m_e: torch.Tensor | None  # the electron term's moments, (pairs, 2)
    n1_memo: cuda_adaptive.Memo | None   # on the card only


def assembly_plan(p, coeff) -> AssemblyPlan:
    """Everything of ``assemble(p, coeff, omega)`` that omega does not
    change, made once for any number of omega: the parameters (one host
    read), the upper triangle's pairs iu < ju and their N1 rows and moments,
    coeff[iu, ju], the flat index of each write into M (the pairs' entries
    in ``assemble``'s order, then the diagonals), the diagonal entries
    1 + 1 / tau and, when electromagnetic, 2 tau / beta_e b_i(eta), the
    electron term's omega-free half, and on the card N1's memo, empty.
    Under ``layer.assembly.plan``, inside ``layer.assembly.pairs``."""
    dev = p.device
    n = int(p.npoints)
    em = bool(p.electromagnetic)
    ASSEMBLY_ROUTE["plans"] += 1
    with span("assembly.pairs"), span("assembly.plan"):
        ph = phys_from_params(p)
        iu, ju = torch.triu_indices(n, n, 1, device=dev)
        rows, m, grid, g, b = _pair_inputs(p, ph, iu, ju)
        dim = 2 * n if em else n
        diag = torch.arange(n, device=dev)
        # assemble's values in their order: a, a (then u, -u, -u, u, d, d),
        # then the diagonals
        at_r, at_c, diags = [iu, ju], [ju, iu], [diag]
        diagonal = [torch.full((n,), 1.0 + 1.0 / ph.tau,
                               dtype=torch.complex128, device=dev)]
        electron = m_e = None
        if em:
            at_r += [iu, ju, iu + n, ju + n, iu + n, ju + n]
            at_c += [ju + n, iu + n, ju, iu, ju + n, iu + n]
            diags.append(diag + n)
            diagonal.append(((2.0 * ph.tau) / ph.beta_e * b).to(
                torch.complex128))
            electron = adaptive.electron_pairs(
                ph, grid[iu, None] - grid[ju, None], g[iu, None] - g[ju, None])
            m_e = m.reshape(iu.numel(), 3)[:, 1:]
        return AssemblyPlan(
            ph=ph, dim=dim, dx=2.0 * ph.length / (n - 1), rows=rows,
            m=m, coeff=_f64(coeff, dev)[iu, ju],
            index=torch.cat(at_r + diags) * dim + torch.cat(at_c + diags),
            diagonal=torch.cat(diagonal), electron=electron, m_e=m_e,
            n1_memo=cuda_adaptive.Memo() if rows.is_cuda else None)


def assemble(p, coeff, omega, n_threads=None, plan=None):
    """The dense operator M(omega), complex128 (dim, dim) on ``p.device``,
    dim = npoints (electrostatic) or 2 npoints (electromagnetic), with the
    engine's entries (emme_native.cpp:439-496).  ``plan``:
    ``assembly_plan(p, coeff)``, made once for many omega, whose N1 memo
    the call drives; without one the call makes its own and takes no
    memo."""
    memo = None
    if plan is None:
        ASSEMBLY_ROUTE["unplanned"] += 1
        plan = assembly_plan(p, coeff)
    else:
        ASSEMBLY_ROUTE["planned"] += 1
        if plan.dim != int(p.npoints) * (2 if p.electromagnetic else 1):
            raise ValueError("assemble: the plan was made for another "
                             "operator")
        memo = plan.n1_memo
    ph, dx = plan.ph, plan.dx
    with span("assembly.pairs"):
        vals, _panels, _miller = cuda_adaptive.integrate(
            plan.rows, plan.m, adaptive.scalars(ph, omega), memo=memo)
        if memo is not None and memo.last in ("fill", "read"):
            ASSEMBLY_ROUTE[f"memo_{memo.last}s"] += 1
        k = adaptive.ion_prefactor(ph, vals).reshape(plan.coeff.numel(), -1)
    if plan.electron is not None:
        with span("assembly.electron"):
            ke = adaptive.kappa_electron(ph, plan.m_e, plan.electron, None,
                                         omega)
    with span("assembly.place"):
        a = -k[:, 0] * plan.coeff * dx
        vals = [a, a]
        if plan.electron is not None:
            u = (k[:, 1] + ke[:, 0]) * dx
            d = (k[:, 2] + ke[:, 1]) * dx
            nu = -u
            vals += [u, nu, nu, u, d, d]
        vals.append(plan.diagonal)
        M = torch.zeros(plan.dim * plan.dim, dtype=torch.complex128,
                        device=p.device)
        M[plan.index] = torch.cat(vals)
    return M.view(plan.dim, plan.dim)
