"""Nonlinear eigensolver for the gyrokinetic integral operator M(omega).

Counterpart of the dense path of ``emme_tpu/solvers/eigen.py`` (reference
``EigenSolver``, ``include/solver.h:44-516``):

* Matrix assembly: every upper-triangle pair's kernel integral at once, on
  |i - j|-tiered panel meshes; float32 pairs go through the CUDA kernel K1
  (``ops/cuda_kappa.py``), float64 pairs through the torch integrand
  (``ops/kernels.py``).  On the card in float32 two kernels around K1
  build its inputs and write M (``ops/cuda_assembly.py``, from a plan made
  once a solve); elsewhere torch does, and M is built by complex index
  assignment.
* Newton-secant iteration on det M(omega) = 0 via the trace update
  d_omega = -1 / tr(M^{-1} dM) (solver.h:113-160), with dM from the secant
  difference (solver.h:54-57); the reference's QR-secant update
  (solver.h:210-383) and the bordered update on the smallest singular pair
  are the other two ``method``s.
* Null space extraction by SVD (solver.h:58-112) on the CPU, by inverse
  iteration on a card.
* ``host64_polish``: the certification polish in complex128 on the device.
* ``quadrature_guard``: the run-time accuracy check of the static panel
  mesh; on the card in float32 in kernels beside K1 (``ops/cuda_guard.py``).

The iteration itself is ``newton.py``'s, shared with the other backends:
this module gives it ``assembler``'s closure, the three updates (the
step functions bind each to ``newton.step``) and ``secant``.
``discretization`` decides every backend's tier table and K1 route.
``HOST_READS`` and ``LAST_SOLVE`` are ``newton``'s.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from ..grid import Grid
from ..ops import cuda_assembly, cuda_guard, cuda_kappa, kernels, linalg
from ..ops.singularity import singularity_coeff_matrix
from ..utils.timer import host_read, section, span, sync
from . import newton
from .newton import HOST_READS, LAST_SOLVE  # noqa: F401 (read by callers)


def _pair_indices(n: int):
    iu, ju = np.triu_indices(n, k=1)
    return iu, ju


def _tier_groups(dij, tiers):
    """The pairs of |i - j| offsets ``dij`` grouped by the tier table
    ``tiers`` (``kernels.tier_thresholds_ij``): [(idx, spec)], ``idx`` the
    positions of a tier's pairs, in the table's order, empty tiers left
    out."""
    groups = []
    lo = 0
    for ij_ub, spec in tiers:
        m = (dij >= lo) & (dij < ij_ub)
        lo = ij_ub
        if m.any():
            groups.append((np.flatnonzero(m), spec))
    return groups


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
        groups = _tier_groups(ju - iu, tiers)
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


# Dense assemblies (``assemble_matrix``) since the caller last set them to
# 0, by route: "kernels", the card's float32 route through K1 (kernels P
# and Q around it, ``ops/cuda_assembly.py``); "torch", every other.
ASSEMBLY_ROUTE = {"kernels": 0, "torch": 0}


def kernel_route(p, grid: Grid, fused: bool) -> bool:
    """Whether an assembly takes the kernels: K1 (``fused``) on a CUDA grid,
    the grid and the parameters float32."""
    return bool(fused) and grid.eta.is_cuda \
        and grid.eta.dtype == torch.float32 and p.dtype == torch.float32


def assembly_plan(p, grid: Grid, quad=None, tiers=None):
    """The kernels' plan of ``grid``'s assemblies (``cuda_assembly.Plan``):
    the tiers' pairs and panel meshes as ``_tiered_pair_values`` takes them
    (one tier of every pair on ``quad`` without ``tiers``), g(eta) and
    bi(eta) at the grid's points and the parameters' scalars.  Under the
    span ``layer.assembly.plan``."""
    with span("assembly.plan"):
        plan = pair_plan(grid.npoints, tiers, str(grid.eta.device))
        if tiers is None:
            groups = [(plan["iu"], plan["ju"], None)]
        else:
            groups = [(iu, ju, kernels.scaled_quad(quad, grid.eta.dtype,
                                                   spec))
                      for iu, ju, spec in plan["groups"]]
        return cuda_assembly.build_plan(p, grid, groups, quad)


def assemble_matrix(p, grid: Grid, coeff, omega, quad=None, chunk: int = 2048,
                    tiers=None, fused: bool = False, plan=None):
    """Assemble the dense complex-symmetric M(omega).

    Electrostatic (beta_e == 0): dim = npoints,
      M[i,j] = -kappa_all(0, eta_i, eta_j, omega) * coeff[i,j] * dx (i != j)
      M[i,i] = 1 + 1/tau                                (solver.h:439-459)

    Electromagnetic: dim = 2*npoints with the phi/A_par 2x2 block structure
    of solver.h:461-511: symmetric A (phi-phi), antisymmetric U (phi-A), and
    symmetric D (A-A) with diagonal 2 tau / beta_e * bi(eta_i).

    ``tiers``: optional |i - j| tier table (``kernels.tier_thresholds_ij``)
    -- coarser panel meshes for far pairs.

    Where ``kernel_route`` holds, the kernels assemble (P, K1 a tier, Q),
    from ``plan`` (``assembly_plan`` of the same quad and tiers), made here
    when None; elsewhere ``_assemble_torch``.  Counted in ``ASSEMBLY_ROUTE``.
    """
    if kernel_route(p, grid, fused):
        ASSEMBLY_ROUTE["kernels"] += 1
        if plan is None:
            plan = assembly_plan(p, grid, quad, tiers)
        return cuda_assembly.assemble(plan, coeff, omega)
    ASSEMBLY_ROUTE["torch"] += 1
    return _assemble_torch(p, grid, coeff, omega, quad, chunk, tiers, fused)


def _assemble_torch(p, grid: Grid, coeff, omega, quad=None, chunk: int = 2048,
                    tiers=None, fused: bool = False):
    """``assemble_matrix`` by torch around K1 or the torch integrand: the
    CPU's route, and the plain version the card's kernels are held to."""
    n = grid.npoints
    with span("assembly.pairs"):
        plan = pair_plan(n, tiers, str(grid.eta.device))
        iu, ju = plan["iu"], plan["ju"]
        eta_a = grid.eta[iu]
        eta_b = grid.eta[ju]
        ms = (0, 1, 2) if p.electromagnetic else (0,)
        if tiers is not None:
            vals = _tiered_pair_values(p, grid, omega, plan, ms, quad, chunk,
                                       fused)
        else:
            vals = _pair_values(p, eta_a, eta_b, omega, ms, quad, chunk,
                                fused)
    return _materialize_from_pairs(p, grid, coeff, vals, (eta_a, eta_b),
                                   (iu, ju), omega)


def _materialize_from_pairs(p, grid: Grid, coeff, vals, etas, pairs, omega):
    """Build the dense operator from per-pair kernel values (the electron
    moments of an electromagnetic operator added here)."""
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
        with span("assembly.place"):
            return block(-k0 * coeff[iu, ju] * dx, diag_a)

    k0, k1, k2 = vals
    with span("assembly.pairs"):
        k1 = k1 + kernels.kappa_f_tau_e(p, eta_a, eta_b, omega, 1)
        k2 = k2 + kernels.kappa_f_tau_e(p, eta_a, eta_b, omega, 2)

    with span("assembly.place"):
        A = block(-k0 * coeff[iu, ju] * dx, diag_a)
        # U antisymmetric with zero diagonal (solver.h:480-504)
        U = block(k1 * dx, torch.zeros(n, device=device), sign=-1.0)
        D = block(k2 * dx, (2.0 * p.tau) / p.beta_e * p.bi(grid.eta))
        return torch.cat([torch.cat([A, U], dim=1),
                          torch.cat([U.T, D], dim=1)], dim=0)


def assembler(p, grid: Grid, coeff, quad=None, chunk: int = 2048, tiers=None,
              fused: bool = False, plan=None):
    """``assemble(omega)``: ``assemble_matrix`` with everything but omega
    bound, the closure the Newton iteration calls (``newton.py``)."""
    def assemble(omega):
        return assemble_matrix(p, grid, coeff, omega, quad, chunk, tiers,
                               fused, plan)
    return assemble


def discretization(p, dtype, tiered: bool | None = None,
                   fused: bool | None = None):
    """How an assembly in ``dtype`` discretises M(omega): (tiers, fused).
    ``tiers``: the |i - j| tier table at dx = 2 length / (npoints - 1)
    (``kernels.tier_thresholds_ij``, coarser meshes for far pairs) where
    ``tiered``, else None; ``fused``: the integrals through K1.  Both
    default on for float32, off for float64, which has no K1."""
    if tiered is None:
        tiered = dtype == torch.float32
    if fused is None:
        fused = dtype == torch.float32
    if fused and dtype == torch.float64:
        raise ValueError("fused=True is float32-only (the CUDA kernel K1)")
    tiers = None
    if tiered:
        dx = 2.0 * host_read(float, p.length) / (p.npoints - 1)
        tiers = kernels.tier_thresholds_ij(dx, p.npoints)
    return tiers, fused


@dataclass(frozen=True)
class EigenState:
    omega: Any
    d_omega: Any
    M: Any
    dM: Any
    # set on the state ``solve`` returns: the tier table it assembled with
    # and, on the kernels' route, its assembly plan (the driver's guard
    # takes both)
    tiers: Any = None
    plan: Any = None


def secant(M_new, M_old, d_omega):
    """The dense secant derivative (M_new - M_old) / d_omega
    (solver.h:54-57)."""
    return (M_new - M_old) / d_omega


def init_state(p, grid, coeff, omega_init, quad=None, chunk: int = 2048,
               tiers=None, fused: bool = False, plan=None):
    """Reference ctor seeding (solver.h:396-415): assemble at 0.99*w0 and w0,
    secant derivative from the pair (``newton.seed``)."""
    return newton.seed(assembler(p, grid, coeff, quad, chunk, tiers, fused,
                                 plan), omega_init, secant, EigenState)


def _trace_delta(state):
    return -1.0 / linalg.complex_solve_trace(state.M, state.dM)


def _qr_delta(state):
    return linalg.qr_secant_delta(state.M, state.dM)


def _bordered_delta(state):
    v = linalg.null_space_vector(state.M, method="inverse")
    num = linalg.complex_bilinear(v, state.M)
    den = linalg.complex_bilinear(v, state.dM)
    return -num / den


def newton_trace_step(p, grid, coeff, state: EigenState, quad=None,
                      chunk: int = 2048, tiers=None,
                      fused: bool = False, plan=None) -> EigenState:
    """One Newton-trace-secant iteration (solver.h:113-160):
    d_omega = -1 / tr(M^{-1} dM)."""
    return newton.step(state, _trace_delta, assembler(
        p, grid, coeff, quad, chunk, tiers, fused, plan), secant)


def newton_trace_step_timed(p, grid, coeff, state: EigenState, quad=None,
                            chunk: int = 2048, tiers=None,
                            fused: bool = False, plan=None) -> EigenState:
    """``newton_trace_step`` with the reference's per-phase timer sections
    (" - linear solve" / " - integration" / " - differential",
    solver.h:235-382).  On a card each section ends with a device
    synchronize, so its seconds are the phase's and not its enqueue's: an
    observability variant, slower than the plain step."""
    def timed(name, fn):
        def run(*args):
            with section(name):
                out = fn(*args)
                sync(out)
                return out
        return run

    with section(" - linear solve"), span("linalg.step"):
        d_omega = _trace_delta(state)
        sync(d_omega)
    return newton.advance(
        state, d_omega,
        timed(" - integration", assembler(p, grid, coeff, quad, chunk, tiers,
                                          fused, plan)),
        timed(" - differential", secant))


def newton_qr_secant_step(p, grid, coeff, state: EigenState, quad=None,
                          chunk: int = 2048, tiers=None,
                          fused: bool = False, plan=None) -> EigenState:
    """The reference's "QRSecant" iteration (solver.h:210-383), the TRUE
    trajectory: column-pivoted QR M P = Q R (zgeqp3 there, the
    Businger-Golub Householder sweep ``linalg.qr_column_pivoted`` here),
    approximate null vector v = P [-R_11^{-1} r; 1] so that M v = R_nn q_n,
    and

        d_omega = -R_nn / (Q^H dM v)_n.

    Walks the reference's basin step for step (same pivoting rule; the
    update is invariant to the Householder phase convention)."""
    return newton.step(state, _qr_delta, assembler(
        p, grid, coeff, quad, chunk, tiers, fused, plan), secant)


def newton_bordered_step(p, grid, coeff, state: EigenState, quad=None,
                         chunk: int = 2048, tiers=None,
                         fused: bool = False, plan=None) -> EigenState:
    """Bordered-Newton update on the smallest singular pair -- the cheaper
    analogue of the QR-secant step (same fixed points, smaller basin): v by
    inverse iteration, left vector v^T (M is complex symmetric),
    d_omega = -(v^T M v) / (v^T dM v)."""
    return newton.step(state, _bordered_delta, assembler(
        p, grid, coeff, quad, chunk, tiers, fused, plan), secant)


_STEP_FNS = {"TraceSecant": newton_trace_step,
             "QRSecant": newton_qr_secant_step,
             "BorderedSecant": newton_bordered_step}


def null_space(M):
    """The null vector of the converged operator in the reference's
    nullSpace() convention (solver.h:58-112): by SVD for a CPU tensor, by
    inverse iteration for a CUDA tensor (``linalg.null_space_vector``)."""
    with span("linalg.vector"):
        return linalg.null_space_vector(M)


def _sample_pairs(n: int, sample: int, seed: int, max_dij: int | None = None):
    """Draw ``sample`` (i, j) upper-triangle pairs directly (never
    materializing the O(n^2) full pair list): i uniform, then the offset
    d = j - i uniform over [1, min(max_dij, n-1-i)]."""
    rng = np.random.default_rng(seed)
    npairs = n * (n - 1) // 2
    if max_dij is None and npairs <= sample:
        return _pair_indices(n)
    i = rng.integers(0, n - 1, size=sample).astype(np.int64)
    d_hi = n - 1 - i if max_dij is None else np.minimum(max_dij, n - 1 - i)
    d = 1 + (rng.random(sample) * d_hi).astype(np.int64)
    return i, i + d


@functools.lru_cache(maxsize=8)
def guard_sample(n: int, sample: int, seed: int, tiers=None,
                 max_dij: int | None = None):
    """The guard's sampled pairs (``_sample_pairs``) and their groups by
    the tier mesh the assembly gives them: (iu, ju, ((idx, spec), ...)),
    ``idx`` the positions of a group's pairs, in the tier table's order
    (one group on the base mesh without ``tiers``).  Made once for its
    arguments; read-only."""
    iu, ju = _sample_pairs(n, sample, seed, max_dij)
    groups = _tier_groups(ju - iu, tiers or ((n + 1, 1.0),))
    for a in (iu, ju, *(idx for idx, _ in groups)):
        a.setflags(write=False)
    return iu, ju, tuple(groups)


def guard_pairs(p, grid: Grid, omega, quad=None, chunk: int = 2048,
                sample: int = 4096, seed: int = 0, tiers=None,
                max_dij: int | None = None):
    """The guard's per-pair values through the torch integrand: for each
    sampled pair (``guard_sample``'s order) and each moment, |K| on the
    base mesh, its summed embedded error and |K_tier - K| on the tier mesh
    of its group (0 where the group keeps the base mesh).  Three (n_sampled,
    len(ms)) real tensors on the grid's device, ``chunk`` pairs a call: the
    plain version of kernel G and of R's first half."""
    iu, ju, groups = guard_sample(grid.npoints, sample, seed, tiers, max_dij)
    ms = (0, 1, 2) if p.electromagnetic else (0,)
    rdtype = grid.eta.dtype
    dev = grid.eta.device
    om = torch.tensor(complex(omega), dtype=kernels.complex_dtype(rdtype),
                      device=dev)
    absk, errs, gaps = [], [], []
    for idx, spec in groups:
        q_t = kernels.scaled_quad(quad, rdtype, spec) if spec != 1.0 \
            else None
        ea = grid.eta[torch.as_tensor(iu[idx], device=dev)]
        eb = grid.eta[torch.as_tensor(ju[idx], device=dev)]
        for s in range(0, len(idx), chunk):
            a, b = ea[s:s + chunk], eb[s:s + chunk]
            vals, err = kernels.kappa_f_tau(p, a, b, om, ms=ms, quad=quad)
            absk.append(torch.stack([v.abs() for v in vals], dim=1))
            errs.append(torch.stack(err, dim=1))
            if q_t is None:
                gaps.append(torch.zeros_like(absk[-1]))
                continue
            tvals = kernels.kappa_f_tau(p, a, b, om, ms=ms, quad=q_t)[0]
            gaps.append(torch.stack([(t - v).abs()
                                     for t, v in zip(tvals, vals)], dim=1))
    return torch.cat(absk), torch.cat(errs), torch.cat(gaps)


def guard_report(absk, err, gap, accuracy: float, precision: float) -> dict:
    """The guard's report from ``guard_pairs``' values, in float64 after one
    host read: a pair is flagged where, for some moment, its error or tier
    gap exceeds max(accuracy, precision |K|); ``max_abs_err`` is the largest
    max(err, gap), ``max_rel_err`` the largest max(err, gap) / |K|.  NaNs
    are passed over, as kernel R's fmax does.  The plain version of R."""
    a, e, g = host_read(torch.stack([absk, err, gap]).double().cpu).numpy()
    thresh = np.maximum(accuracy, precision * a)
    flagged = ((e > thresh) | (g > thresh)).any(axis=1)
    e = np.fmax(e, g)
    n = a.shape[0]
    return {
        "n_sampled": n,
        "frac_flagged": int(flagged.sum()) / max(n, 1),
        "max_abs_err": float(np.fmax.reduce(e, axis=None, initial=0.0)),
        "max_rel_err": float(np.fmax.reduce(e / np.maximum(a, 1e-300),
                                            axis=None, initial=0.0)),
    }


# Quadrature guards (``quadrature_guard``) since the caller last set them to
# 0, by route: "kernels", the card's float32 route (P, G and R,
# ``ops/cuda_guard.py``); "torch", every other.
GUARD_ROUTE = {"kernels": 0, "torch": 0}


@functools.lru_cache(maxsize=8)
def _guard_plan(n: int, ms: tuple, sample_key: tuple, quad_items,
                order: int, device: str):
    """The kernels' plan of a guard's sample (``cuda_guard.Plan``), made
    once for its arguments: ``sample_key`` those of ``guard_sample`` after
    n, ``quad_items`` the base mesh's sorted items."""
    iu, ju, groups = guard_sample(n, *sample_key)
    quad = dict(quad_items) if quad_items is not None else None
    return cuda_guard.build_plan(n, ms, groups, iu, ju, quad, order, device)


def quadrature_guard(p, grid: Grid, omega, quad=None, chunk: int = 2048,
                     sample: int = 4096, seed: int = 0, tiers=None,
                     max_dij: int | None = None, fused: bool | None = None,
                     plan=None) -> dict:
    """Runtime accuracy check of the static panel mesh against the
    reference's OWN quadrature acceptance criterion.

    The reference's adaptive Gauss-Kronrod accepts an interval when the
    embedded error satisfies err <= max(accuracy_goal, precision_goal*|I|)
    (functions.h:237-247); the panel mesh here is static, so an off-golden
    (p, omega) regime could silently under-resolve.  This samples
    ``sample`` random (eta, eta') pairs, evaluates every assembled moment's
    kernel (m = 0 electrostatic; m = 0, 1, 2 electromagnetic -- the m >= 1
    moments carry extra norm_vel**m tail weight and are checked with their
    own magnitudes) WITH its embedded error, and flags pairs whose summed
    panel error would fail the reference criterion with the run's own
    integration_accuracy / integration_precision.

    ``tiers``: the static |i - j| tier table the assembly actually used
    (``kernels.tier_thresholds_ij``); each sampled pair is then ALSO
    evaluated on the tier-scaled mesh it would get during assembly, and the
    tier value must agree with the base-mesh value to the same acceptance
    bar.  (The embedded |K - G| estimate is the wrong yardstick for the
    deliberately-coarse tier meshes -- it overestimates the Kronrod error
    by orders of magnitude and would flag the golden regime itself; the
    direct tier-vs-base deviation is the quantity the tier table was
    validated on.)
    ``max_dij``: restrict sampling to |i - j| <= max_dij (the sparse
    backend's kept band -- pairs outside it are never assembled).

    Route, counted in ``GUARD_ROUTE``: where ``kernel_route`` holds (a CUDA
    grid, float32, K1: ``fused``, default on for float32), kernels P, G and
    R and one host read (``ops/cuda_guard.py``), with the point rows and
    scalars of ``plan``, an assembly plan of the same parameters and grid
    (``assembly_plan``; computed here when None); elsewhere the plain
    version, ``guard_pairs`` through the torch integrand and
    ``guard_report``.

    Returns {"n_sampled", "frac_flagged", "max_abs_err", "max_rel_err"}.
    """
    n = grid.npoints
    acc = float(p.integration_accuracy)
    prec = float(p.integration_precision)
    tiers = tuple(tiers) if tiers is not None else None
    if fused is None:
        fused = discretization(p, grid.eta.dtype, tiered=False)[1]
    if not kernel_route(p, grid, fused):
        GUARD_ROUTE["torch"] += 1
        return guard_report(*guard_pairs(p, grid, omega, quad, chunk, sample,
                                         seed, tiers, max_dij), acc, prec)
    GUARD_ROUTE["kernels"] += 1
    if plan is None:
        points, scalars = cuda_assembly.point_rows(p, grid)
    elif plan.n != n or plan.points.device != grid.eta.device:
        raise ValueError(f"the assembly plan is for n = {plan.n} on "
                         f"{plan.points.device}, the grid n = {n} on "
                         f"{grid.eta.device}")
    else:
        points, scalars = plan.points, plan.scalars
    ms = (0, 1, 2) if p.electromagnetic else (0,)
    quad_items = tuple(sorted(quad.items())) if quad else None
    gplan = _guard_plan(n, ms, (sample, seed, tiers, max_dij), quad_items,
                        int(p.integration_start_points),
                        str(grid.eta.device))
    return cuda_guard.guard(gplan, points, scalars, omega, acc, prec)


def refine_quad(quad, dtype, factor: int = 2) -> dict:
    """One-shot denser static mesh: scale every panel count by ``factor``
    (the guard's refinement action; the reference's analogue is interval
    subdivision, functions.h:211-251)."""
    base = dict(kernels.panel_preset(dtype))
    if quad:
        base.update(quad)
    return {k: (v * factor if k.startswith("n_") else v)
            for k, v in base.items()}


def host64_polish(state: EigenState, assemble, tol: float,
                  omega: complex | None = None, max_steps: int = 8):
    """``newton.polish`` of the dense operator, ``assemble`` an
    ``assembler``.  Unlike ``emme_tpu``'s polish (numpy / scipy on the
    host: its chip has no float64), M and dM are cast to complex128 on the
    device and v is inverse iteration by torch's complex LU there, 3 sweeps
    from the numpy ``default_rng(0)`` start of ``emme_tpu``'s
    ``_host64_polish_full``, whose steps these are."""
    c128 = torch.complex128
    dim = state.M.shape[0]
    rng = np.random.default_rng(0)
    v0 = torch.as_tensor(rng.normal(size=dim) + 1j * rng.normal(size=dim),
                         dtype=c128, device=state.M.device)[:, None]

    def null_vec(A):
        with span("linalg.vector"):
            lu, piv, _info = torch.linalg.lu_factor_ex(A, check_errors=False)
            v = v0
            for _ in range(3):
                v = torch.linalg.lu_solve(lu, piv, v)
                v = v / torch.linalg.vector_norm(v)
            return v[:, 0]

    return newton.polish(state, tol, assemble, lambda M: M.to(c128),
                         linalg.complex_bilinear, null_vec, secant, omega,
                         max_steps)


def solve(p, omega_init, tol: float | None = None, quad=None,
          chunk: int = 2048, callback=None, dtype=None,
          method: str = "TraceSecant", host64: bool = False,
          tiered: bool | None = None, fused: bool | None = None,
          loop: str | None = None, timed: bool = False):
    """Full eigen solve: returns (omega, eigenvector, n_steps, state).

    ``omega`` is a Python complex; the eigenvector and ``state`` stay on
    the parameters' device, and ``state`` carries the tier table and, on
    the kernels' route, the assembly plan the solve used (``tiers``,
    ``plan``).  Convergence: |d_omega| < tol * |omega| within
    iteration_step_limit steps (main.cpp:43-57).  The float32 loop also stops
    at its own rounding floor, detected at run time: two consecutive steps
    without 1.25x contraction while |d_omega| < 1e-3 |omega|, or a step whose
    update is not finite (then the last good state is kept).

    ``method``: "TraceSecant" (default), "QRSecant" (the reference's true
    column-pivoted QR trajectory), selected like main.cpp:45-49, or
    "BorderedSecant", the cheaper smallest-singular-pair analogue.

    ``host64=True`` appends ``host64_polish`` (assembly in the working
    precision, complex128 linear algebra on the device): the way to the
    reference's 1e-6 tolerance from float32 parameters.  The eigenvector is
    then complex128 and ``n_steps`` includes the polish's steps; ``state``
    is the loop's.

    ``loop``: "device" runs the iteration with no host wait inside it,
    "host" reads the done flag after every step (needed for ``callback``
    and ``timed``); see ``newton.run``.  Both walk the same states, and
    read the host once more after the loop (the step count and omega in one
    read).  Default: "device" on a CUDA device when there is no callback
    and no timing, "host" on the CPU and for "QRSecant": its pivoted-QR
    sweep is n host-driven column steps bound by their launches, so the
    host has no wait to hide, and the device loop's one masked step past
    convergence would cost a whole sweep.

    ``timed=True`` runs the observability loop: the host loop with
    ``newton_trace_step_timed``, whose phases are bracketed by the
    reference's per-iteration timer sections (" - linear solve" /
    " - integration" / " - differential", solver.h:235-382) and ended by a
    device synchronize; TraceSecant only.

    ``tiered``: coarser panel meshes for far |eta - eta'| pairs
    (kernels.TIER_TABLE).  Default: on for float32, off for float64 (the
    golden-parity path).

    ``fused``: the kernel integrals through ``cuda_kappa.kappa_pairs_fused``
    -- the CUDA kernel K1 on a card, its plain version on the CPU.  Default:
    on for float32; float64 has no kernel (``discretization``).

    ``layer.solve.setup`` spans the set-up up to the first assembly: the
    argument checks, the grid, the coefficients, the tiers and the plan.
    """
    with span("solve.setup"):
        tol = tol if tol is not None else 1e-6
        dtype = dtype if dtype is not None else p.length.dtype
        device = p.length.device
        cdtype = kernels.complex_dtype(dtype)
        if method not in _STEP_FNS:
            raise ValueError(f"method must be one of {sorted(_STEP_FNS)}, "
                             f"got {method!r}")
        if timed and method != "TraceSecant":
            raise ValueError(f"timed=True is TraceSecant only, got {method!r}")
        if loop is None:
            loop = "device" if (device.type == "cuda" and callback is None
                                and not timed and method != "QRSecant") \
                else "host"
        if loop not in ("host", "device"):
            raise ValueError(f"loop must be 'host' or 'device', got {loop!r}")
        if loop == "device" and (callback is not None or timed):
            raise ValueError("loop='device' is incompatible with "
                             "callback/timed")
        grid = Grid.create(p.length, p.npoints, dtype=dtype, device=device)
        coeff = singularity_coeff_matrix(p.npoints, dtype=dtype, device=device)

        tiers, fused = discretization(p, dtype, tiered, fused)
        plan = assembly_plan(p, grid, quad, tiers) \
            if kernel_route(p, grid, fused) else None
        kw = dict(quad=quad, chunk=chunk, tiers=tiers, fused=fused, plan=plan)
        assemble = assembler(p, grid, coeff, **kw)
        step = functools.partial(
            newton_trace_step_timed if timed else _STEP_FNS[method],
            p, grid, coeff, **kw)
        omega0 = torch.tensor(complex(omega_init), dtype=cdtype, device=device)
    state = newton.seed(assemble, omega0, secant, EigenState)
    state, n_steps, omega = newton.run(
        step, state, tol, p.iteration_step_limit + 1, dtype != torch.float64,
        loop, callback, method=method, timed=timed)
    state = replace(state, tiers=tiers, plan=plan)
    if host64:
        omega, vec, extra = host64_polish(state, assemble, tol, omega=omega)
        LAST_SOLVE["polish_steps"] = extra
        return omega, vec, n_steps + extra, state
    return omega, null_space(state.M), n_steps, state
