"""Shift-invert Arnoldi for the nonlinear eigenproblem M(omega) x = 0.

Counterpart of ``emme_tpu/solvers/arnoldi.py``.  Linearize about a shift
sigma,

    M(omega) ~ M(sigma) + (omega - sigma) M'(sigma),

so nontrivial null vectors satisfy B x = mu x with B = M(sigma)^{-1}
M'(sigma) and omega = sigma - 1/mu: the eigenvalues of the pencil closest
to sigma map to the largest |mu|, which Arnoldi finds first.  M'(sigma) is
the secant difference the reference Newton uses (solver.h:54-57).

The dense path assembles M at sigma and sigma (1 + 0.01) on the base panel
mesh (no |i - j| tiers, as the JAX function assembles), through the CUDA
kernel K1 for float32 and the torch integrand for float64 (the rule of
``eigen.solve``), factors M once with torch's complex LU (the real 2n
embedding is a TPU form and stays behind) and runs Arnoldi on B.
``solve`` polishes the estimate with Newton trace-secant steps;
``solve_shifts_batched`` takes many shifts with one batched LU and one
batched Arnoldi sweep, O(shifts n^2) memory as in the reference, and over a
mesh splits the shifts over its ``scan`` axis.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid import Grid
from ..ops import kernels
from ..ops.singularity import singularity_coeff_matrix
from ..params import default_device
from ..parallel import mesh as mesh_mod
from ..utils.timer import host_read, span
from . import eigen, newton

# Multi-shift surveys (``solve_shifts_batched``) since the caller last set
# them to 0: "surveys" the calls, "shifts" the shifts batched (a rank's
# share on a mesh), "assemblies" the operators they assembled (two a
# shift, ``_secant_pair``) and "plans" the assembly plans ``_secant_pair``
# asked ``_plan`` for (one a shift; built where ``eigen.kernel_route``
# holds, None on the torch route).
SURVEY_ROUTE = {"surveys": 0, "shifts": 0, "assemblies": 0, "plans": 0}


def arnoldi_factorization(solve_B, n: int, m_krylov: int,
                          dtype=torch.complex128, device=None,
                          batch: tuple = ()):
    """m-step Arnoldi on the operator x -> B x given as ``solve_B(x)``.

    Modified Gram-Schmidt on complex vectors with the conjugated inner
    product <a, b> = conj(a)^T b, from the JAX package's start vector
    1 + 0.3 i k / n.  ``batch``: leading dimensions of independent
    operators, each with its own basis (``solve_B`` maps (*batch, n) to
    (*batch, n)).  Returns V (*batch, m+1, n) and H (*batch, m+1, m),
    complex ``dtype`` tensors on ``device`` (None: the CUDA card); nothing
    is read back to the host."""
    rdtype = torch.float64 if dtype == torch.complex128 else torch.float32
    device = default_device(device)
    vi = 0.3 * torch.arange(n, dtype=rdtype, device=device) / n
    v = torch.complex(torch.ones_like(vi), vi)
    v = (v / torch.linalg.vector_norm(v)).expand(*batch, n)
    V = torch.zeros((*batch, m_krylov + 1, n), dtype=dtype, device=v.device)
    H = torch.zeros((*batch, m_krylov + 1, m_krylov), dtype=dtype,
                    device=v.device)
    V[..., 0, :] = v
    for j in range(m_krylov):
        w = solve_B(V[..., j, :])
        for i in range(j + 1):
            h = torch.linalg.vecdot(V[..., i, :], w)
            w = w - h[..., None] * V[..., i, :]
            H[..., i, j] = h
        beta = torch.linalg.vector_norm(w, dim=-1)
        H[..., j + 1, j] = beta
        V[..., j + 1, :] = w / torch.clamp_min(beta, 1e-300)[..., None]
    return V, H


def ritz_from_hessenberg(H, sigma, m_krylov: int):
    """Host-side: eig of the small Hessenberg -> omega estimates sorted by
    |mu| descending (closest to sigma first).  Returns numpy (omegas,
    eigvecs)."""
    if isinstance(H, torch.Tensor):
        H = host_read(H.detach().cpu).numpy()
    Hm = np.asarray(H, np.complex128)[:m_krylov, :m_krylov]
    mu, Y = np.linalg.eig(Hm)
    order = np.argsort(-np.abs(mu))
    mu, Y = mu[order], Y[:, order]
    with np.errstate(divide="ignore", invalid="ignore"):
        omegas = complex(sigma) - 1.0 / mu
    return omegas, Y


def _plan(p, grid, quad, fused):
    """The card's assembly plan on the base mesh (``eigen.assembly_plan``),
    or None where the kernels do not assemble."""
    return eigen.assembly_plan(p, grid, quad) \
        if eigen.kernel_route(p, grid, fused) else None


def _secant_pair(p, grid, coeff, sigma, quad, chunk, d_sigma_frac):
    """M(sigma) and the secant M'(sigma) from M(sigma (1 + d_sigma_frac)),
    on the base panel mesh; K1 for float32, the torch integrand for
    float64."""
    fused = grid.eta.dtype == torch.float32
    plan = _plan(p, grid, quad, fused)
    d_sigma = d_sigma_frac * sigma
    M = eigen.assemble_matrix(p, grid, coeff, sigma, quad, chunk, None, fused,
                              plan)
    M2 = eigen.assemble_matrix(p, grid, coeff, sigma + d_sigma, quad, chunk,
                               None, fused, plan)
    return M, (M2 - M) / d_sigma


def _lu_solver(M, dM):
    """``solve_B(x) = M^{-1} (M' x)`` with M factored once (batched over
    leading dimensions)."""
    lu, piv = torch.linalg.lu_factor(M)

    def solve_B(x):
        return torch.linalg.lu_solve(lu, piv, dM @ x[..., None])[..., 0]

    return solve_B, (lu, piv)


def _shift(sigma, grid):
    return torch.as_tensor(complex(sigma), device=grid.eta.device,
                           dtype=kernels.complex_dtype(grid.eta.dtype))


def shift_invert_factorization(p, grid, coeff, sigma, m_krylov: int,
                               quad=None, chunk: int = 2048,
                               d_sigma_frac: float = 0.01):
    """Assemble M(sigma), M'(sigma) (secant), LU-factor M once, and run the
    Arnoldi factorization of B = M^{-1} M'.  Returns V (m+1, n), H
    (m+1, m) and the factorization (LU, pivots)."""
    M, dM = _secant_pair(p, grid, coeff, _shift(sigma, grid), quad, chunk,
                         d_sigma_frac)
    solve_B, factors = _lu_solver(M, dM)
    V, H = arnoldi_factorization(solve_B, M.shape[0], m_krylov, M.dtype,
                                 M.device)
    return V, H, factors


def solve_one_shift(p, grid, coeff, sigma, m_krylov: int = 24, quad=None,
                    chunk: int = 2048):
    """Arnoldi estimate for the eigenvalue nearest sigma.  Returns
    (omega_estimate, ritz_vector (complex128 numpy, host), None)."""
    V, H, _ = shift_invert_factorization(p, grid, coeff, sigma, m_krylov,
                                         quad, chunk)
    omegas, Y = ritz_from_hessenberg(H, complex(sigma), m_krylov)
    vec = V[:m_krylov].cpu().numpy().astype(np.complex128).T @ Y[:, 0]
    return complex(omegas[0]), vec / np.linalg.norm(vec), None


def _grid_coeff(p, dtype):
    dtype = dtype if dtype is not None else p.length.dtype
    device = p.length.device
    return (Grid.create(p.length, p.npoints, dtype=dtype, device=device),
            singularity_coeff_matrix(p.npoints, dtype=dtype, device=device))


def solve(p, sigma, m_krylov: int = 24, newton_polish: int = 3,
          tol: float = 1e-6, quad=None, chunk: int = 2048, dtype=None):
    """Full alternative eigensolve: the shift-invert Arnoldi estimate, then
    at most ``newton_polish`` Newton trace-secant steps on the base mesh,
    stopping at |d_omega| < tol |omega| (the reference criterion).  Returns
    (omega, vector, polish steps): the Arnoldi estimate and its Ritz vector
    (numpy) when ``newton_polish`` <= 0, else the polished omega and the
    null vector of the last M (``eigen.null_space``) on the device."""
    grid, coeff = _grid_coeff(p, dtype)
    omega_est, vec, _ = solve_one_shift(p, grid, coeff, sigma, m_krylov,
                                        quad, chunk)
    if newton_polish <= 0:
        return omega_est, vec, 0
    fused = grid.eta.dtype == torch.float32
    plan = _plan(p, grid, quad, fused)
    state = eigen.init_state(p, grid, coeff, _shift(omega_est, grid), quad,
                             chunk, None, fused, plan)
    steps = 0
    for _ in range(newton_polish):
        state = eigen.newton_trace_step(p, grid, coeff, state, quad, chunk,
                                        None, fused, plan)
        steps += 1
        d_omega, omega, re, im = newton.items(torch.stack([
            state.d_omega.abs(), state.omega.abs(), state.omega.real,
            state.omega.imag]))
        if d_omega < tol * omega:
            break
    return complex(re, im), eigen.null_space(state.M), steps


def _batched_hessenbergs(p, grid, coeff, sigmas, m_krylov, quad, chunk):
    """M(sigma) and M'(sigma) for every shift filled into (S, n, n)
    tensors, one batched LU, one batched Arnoldi sweep: the (S, m+1, m)
    Hessenbergs on the device."""
    M = dM = None
    with span("survey.secant"):
        for k, s in enumerate(sigmas):
            m, d = _secant_pair(p, grid, coeff, _shift(s, grid), quad, chunk,
                                0.01)
            SURVEY_ROUTE["shifts"] += 1
            SURVEY_ROUTE["assemblies"] += 2
            SURVEY_ROUTE["plans"] += 1
            if M is None:
                M = m.new_empty((len(sigmas), *m.shape))
                dM = torch.empty_like(M)
            M[k], dM[k] = m, d
    with span("survey.lu"):
        solve_B, _ = _lu_solver(M, dM)
    with span("survey.sweep"):
        _, H = arnoldi_factorization(solve_B, M.shape[-1], m_krylov, M.dtype,
                                     M.device, batch=(len(sigmas),))
    return H


def solve_shifts_batched(p, sigmas, m_krylov: int = 24, quad=None,
                         chunk: int = 2048, mesh=None, dtype=None):
    """Multi-shift Arnoldi: one batched LU and one batched Arnoldi sweep
    over the shifts, one read of their Hessenbergs.  Returns the omega
    estimates in shift order (numpy).  With ``mesh`` (a
    ``parallel.mesh.Mesh``, called in every rank) the shifts split over its
    ``scan`` axis -- their number must divide by its size -- each rank
    batches its share, and the Hessenbergs are all-gathered, so every rank
    returns every estimate.

    Counted in ``SURVEY_ROUTE``.  Spans: ``layer.survey.secant`` (each
    shift's two assemblies, the secant and the fill of the batch),
    ``.lu``, ``.sweep``, and ``.ritz`` (the Hessenbergs' read and the host
    eigensolves)."""
    SURVEY_ROUTE["surveys"] += 1
    grid, coeff = _grid_coeff(p, dtype)
    sigmas = np.asarray(sigmas, dtype=np.complex128).reshape(-1)
    if mesh is None:
        H = _batched_hessenbergs(p, grid, coeff, sigmas, m_krylov, quad,
                                 chunk)
    else:
        if not isinstance(mesh, mesh_mod.Mesh):
            raise TypeError(f"mesh must be an emme_tpu_torch.parallel.mesh."
                            f"Mesh, got {type(mesh).__name__}")
        n_scan = mesh.n_scan
        if len(sigmas) % n_scan:
            raise ValueError(f"{len(sigmas)} shifts do not divide over the "
                             f"scan axis of {n_scan}")
        k = len(sigmas) // n_scan
        H = mesh_mod.all_gather(_batched_hessenbergs(
            p, grid, coeff, sigmas[mesh.scan * k:(mesh.scan + 1) * k],
            m_krylov, quad, chunk), mesh, axis="scan", tiled=True)
    with span("survey.ritz"):
        H = host_read(H.cpu).numpy()
        return np.array([ritz_from_hessenberg(H[k], s, m_krylov)[0][0]
                         for k, s in enumerate(sigmas)])
