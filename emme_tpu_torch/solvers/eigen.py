"""Nonlinear eigensolver for the gyrokinetic integral operator M(omega).

Counterpart of the dense path of ``emme_tpu/solvers/eigen.py`` (reference
``EigenSolver``, ``include/solver.h:44-516``):

* Matrix assembly: every upper-triangle pair's kernel integral at once, on
  |i - j|-tiered panel meshes; float32 pairs go through the CUDA kernel K1
  (``ops/cuda_kappa.py``), float64 pairs through the torch integrand
  (``ops/kernels.py``).  M is built by complex index assignment.
* Newton-secant iteration on det M(omega) = 0 via the trace update
  d_omega = -1 / tr(M^{-1} dM) (solver.h:113-160), with dM from the secant
  difference (solver.h:54-57).
* Null space extraction by SVD (solver.h:58-112).

The iteration is driven from the host, one scalar read per step.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..grid import Grid
from ..ops import cuda_kappa, kernels, linalg
from ..ops.singularity import singularity_coeff_matrix


def _pair_indices(n: int):
    iu, ju = np.triu_indices(n, k=1)
    return iu, ju


@functools.lru_cache(maxsize=8)
def pair_plan(n: int, tiers, device: str):
    """Upper-triangle pair indices on ``device`` and, with ``tiers``, the
    pairs grouped by |i - j| tier plus the inverse permutation that restores
    pair order.  Read-only; cached so a solve builds it once."""
    iu, ju = _pair_indices(n)
    dev = torch.device(device)
    plan = {"iu": torch.as_tensor(iu, device=dev),
            "ju": torch.as_tensor(ju, device=dev), "groups": None,
            "perm": None}
    if tiers is not None:
        dij = ju - iu
        groups = []
        lo = 0
        for ij_ub, spec in tiers:
            m = (dij >= lo) & (dij < ij_ub)
            lo = ij_ub
            if m.any():
                groups.append((np.flatnonzero(m), spec))
        perm = np.argsort(np.concatenate([idx for idx, _ in groups]))
        plan["groups"] = [(torch.as_tensor(iu[idx], device=dev),
                           torch.as_tensor(ju[idx], device=dev), spec)
                          for idx, spec in groups]
        plan["perm"] = torch.as_tensor(perm, device=dev)
    return plan


def _pair_values(p, eta_a, eta_b, omega, ms, quad, chunk, fused):
    """Per-pair kernel values: K1 (``cuda_kappa.kappa_pairs_fused``) or the
    torch integrand, ``chunk`` pairs at a time."""
    if fused:
        return cuda_kappa.kappa_pairs_fused(p, eta_a, eta_b, omega,
                                            ms=ms, quad=quad)
    parts = [[] for _ in ms]
    for s in range(0, eta_a.shape[0], chunk):
        vals, _err = kernels.kappa_f_tau(p, eta_a[s:s + chunk],
                                         eta_b[s:s + chunk], omega,
                                         ms=ms, quad=quad)
        for k, v in enumerate(vals):
            parts[k].append(v)
    return tuple(torch.cat(v) for v in parts)


def _tiered_pair_values(p, grid, omega, plan, ms, quad, chunk,
                        fused=False) -> tuple:
    """Kernel values for all pairs with the panel mesh tiered by |i - j|
    (kernels.TIER_TABLE): near pairs get the full mesh, far pairs -- where
    the integrand is smooth -- a coarser one.  Pair order is restored by the
    plan's inverse permutation."""
    rdtype = grid.eta.dtype
    parts = [[] for _ in ms]
    for iu, ju, spec in plan["groups"]:
        q_t = kernels.scaled_quad(quad, rdtype, spec)
        sub = _pair_values(p, grid.eta[iu], grid.eta[ju], omega, ms, q_t,
                           chunk, fused)
        for k, v in enumerate(sub):
            parts[k].append(v)
    return tuple(torch.cat(vs)[plan["perm"]] for vs in parts)


def assemble_matrix(p, grid: Grid, coeff, omega, quad=None, chunk: int = 2048,
                    tiers=None, fused: bool = False):
    """Assemble the dense complex-symmetric M(omega).

    Electrostatic (beta_e == 0): dim = npoints,
      M[i,j] = -kappa_all(0, eta_i, eta_j, omega) * coeff[i,j] * dx (i != j)
      M[i,i] = 1 + 1/tau                                (solver.h:439-459)

    Electromagnetic: dim = 2*npoints with the phi/A_par 2x2 block structure
    of solver.h:461-511: symmetric A (phi-phi), antisymmetric U (phi-A), and
    symmetric D (A-A) with diagonal 2 tau / beta_e * bi(eta_i).

    ``tiers``: optional |i - j| tier table (``kernels.tier_thresholds_ij``)
    -- coarser panel meshes for far pairs.
    """
    n = grid.npoints
    plan = pair_plan(n, tiers, str(grid.eta.device))
    iu, ju = plan["iu"], plan["ju"]
    eta_a = grid.eta[iu]
    eta_b = grid.eta[ju]
    ms = (0, 1, 2) if p.electromagnetic else (0,)

    if tiers is not None:
        vals = _tiered_pair_values(p, grid, omega, plan, ms, quad, chunk,
                                   fused)
    else:
        vals = _pair_values(p, eta_a, eta_b, omega, ms, quad, chunk, fused)
    return _materialize_from_pairs(p, grid, coeff, vals, (eta_a, eta_b),
                                   (iu, ju), omega)


def _materialize_from_pairs(p, grid: Grid, coeff, vals, etas, pairs, omega):
    """Build the dense operator from per-pair kernel values."""
    n = grid.npoints
    dx = grid.dx
    eta_a, eta_b = etas
    iu, ju = pairs
    cdtype = kernels.complex_dtype(grid.eta.dtype)
    device = grid.eta.device
    diag = torch.arange(n, device=device)

    def block(entries, diag_vals, sign=1.0):
        X = torch.empty((n, n), dtype=cdtype, device=device)
        X[iu, ju] = entries.to(cdtype)
        X[ju, iu] = (sign * entries).to(cdtype)
        X[diag, diag] = diag_vals.to(cdtype)
        return X

    diag_a = (1.0 + 1.0 / p.tau).expand(n)

    if not p.electromagnetic:
        k0 = vals[0]  # kappa_e(0) == 0 (Parameters.cpp:193-194)
        return block(-k0 * coeff[iu, ju] * dx, diag_a)

    k0, k1, k2 = vals
    k1 = k1 + kernels.kappa_f_tau_e(p, eta_a, eta_b, omega, 1)
    k2 = k2 + kernels.kappa_f_tau_e(p, eta_a, eta_b, omega, 2)

    A = block(-k0 * coeff[iu, ju] * dx, diag_a)
    # U antisymmetric with zero diagonal (solver.h:480-504)
    U = block(k1 * dx, torch.zeros(n, device=device), sign=-1.0)
    D = block(k2 * dx, (2.0 * p.tau) / p.beta_e * p.bi(grid.eta))
    return torch.cat([torch.cat([A, U], dim=1),
                      torch.cat([U.T, D], dim=1)], dim=0)


@dataclass(frozen=True)
class EigenState:
    omega: Any
    d_omega: Any
    M: Any
    dM: Any


def init_state(p, grid, coeff, omega_init, quad=None, chunk: int = 2048,
               tiers=None, fused: bool = False):
    """Reference ctor seeding (solver.h:396-415): assemble at 0.99*w0 and w0,
    secant derivative from the pair."""
    omega_old = 0.99 * omega_init
    d_omega = 0.01 * omega_init
    M_old = assemble_matrix(p, grid, coeff, omega_old, quad, chunk, tiers,
                            fused)
    omega = omega_old + d_omega
    M = assemble_matrix(p, grid, coeff, omega, quad, chunk, tiers, fused)
    dM = (M - M_old) / d_omega
    return EigenState(omega=omega, d_omega=d_omega, M=M, dM=dM)


def newton_trace_step(p, grid, coeff, state: EigenState, quad=None,
                      chunk: int = 2048, tiers=None,
                      fused: bool = False) -> EigenState:
    """One Newton-trace-secant iteration (solver.h:113-160)."""
    d_omega = -1.0 / linalg.complex_solve_trace(state.M, state.dM)
    omega = state.omega + d_omega
    M_new = assemble_matrix(p, grid, coeff, omega, quad, chunk, tiers, fused)
    dM = (M_new - state.M) / d_omega
    return EigenState(omega=omega, d_omega=d_omega, M=M_new, dM=dM)


def null_space(M):
    """Conjugated last right-singular vector (solver.h:58-112)."""
    return linalg.null_space_vector(M)


def solve(p, omega_init, tol: float | None = None, quad=None,
          chunk: int = 2048, callback=None, dtype=None,
          tiered: bool | None = None, fused: bool | None = None):
    """Full eigen solve: returns (omega, eigenvector, n_steps, state).

    ``omega`` is a Python complex; the eigenvector and ``state`` stay on
    the parameters' device.  Convergence: |d_omega| < tol * |omega| within
    iteration_step_limit steps (main.cpp:43-57).  The float32 loop also stops
    at its own rounding floor, detected at run time: two consecutive steps
    without 1.25x contraction while |d_omega| < 1e-3 |omega|, or a step whose
    update is not finite (then the last good state is kept).

    ``tiered``: coarser panel meshes for far |eta - eta'| pairs
    (kernels.TIER_TABLE).  Default: on for float32, off for float64 (the
    golden-parity path).

    ``fused``: the kernel integrals through ``cuda_kappa.kappa_pairs_fused``
    -- the CUDA kernel K1 on a card, its plain version on the CPU.  Default:
    on for float32; float64 has no kernel.
    """
    tol = tol if tol is not None else 1e-6
    dtype = dtype if dtype is not None else p.length.dtype
    device = p.length.device
    cdtype = kernels.complex_dtype(dtype)
    grid = Grid.create(p.length, p.npoints, dtype=dtype, device=device)
    coeff = singularity_coeff_matrix(p.npoints, dtype=dtype, device=device)

    if tiered is None:
        tiered = dtype == torch.float32
    tiers = None
    if tiered:
        dx = 2.0 * float(p.length) / (p.npoints - 1)
        tiers = kernels.tier_thresholds_ij(dx, p.npoints)
    if fused is None:
        fused = dtype == torch.float32
    if fused and dtype == torch.float64:
        raise ValueError("fused=True is float32-only (the CUDA kernel K1)")

    f32 = dtype != torch.float64
    omega0 = torch.tensor(complex(omega_init), dtype=cdtype, device=device)
    state = init_state(p, grid, coeff, omega0, quad, chunk, tiers, fused)
    n_steps = 0
    d_prev, sc = float("inf"), 0
    for j in range(p.iteration_step_limit + 1):
        prev = state
        state = newton_trace_step(p, grid, coeff, state, quad=quad,
                                  chunk=chunk, tiers=tiers, fused=fused)
        n_steps = j + 1
        if callback is not None:
            callback(j, state)
        adw = abs(complex(state.d_omega.item()))
        aw = abs(complex(state.omega.item()))
        if f32 and not (np.isfinite(adw) and np.isfinite(aw)):
            state = prev   # f32 floor blow-up: keep last good state
            break
        if adw < tol * aw:
            break
        if f32 and adw < 1e-3 * aw and adw > 0.8 * d_prev:
            sc += 1
            if sc >= 2:   # runtime rounding-floor detection
                break
        else:
            sc = 0
        d_prev = adw
    vec = null_space(state.M)
    return complex(state.omega.item()), vec, n_steps, state
