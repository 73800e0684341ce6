"""The CUDA kernels on an NVIDIA GPU against their plain PyTorch versions:
K1 and the float32 solves through it (Newton, the shift-invert Arnoldi
with its polish, the multi-shift survey's counter and spans, the plans'
and a PIC request's spans, and K1 at the window shape of the mesh-sharded banded
assembly); the dense assembly's kernels P and Q around K1 against the
torch they replace (inputs, M, solves, launches); the quadrature guard's
kernels G and R (with P) against the guard's torch route, its launches and
host reads, and the assembly unchanged beside them; K2, K3 and K4 (the
fused PIC marker pass, in each of its forms, the cluster form's clusters
of 2, 4 and 8 among them) and the fused PIC run; K5 (the BSR SpMV) and
the banded solve through it; the driver's three kernel routes from an input dict, each against
the same driver call on CPU tensors; a one-rank NCCL mesh solve against
the single-device solve; the sorted-window PIC path (plain torch, no
kernel) against the plain run; and N1 (the float64 adaptive assembly of the
reference-exact engine) against its plain version, in its slot and
work-counter edge cases too, with the tok32 solve through it, and N1's
memo (a solve's fill and reads, misses, a flipped sign of Re omega, a
memo of a prefix) against memo-free launches, bit for bit.  Every test
here needs a card and skips without one.

This file imports torch, numpy and the port only, so it also runs on a
machine with a card and without JAX (tests/conftest.py imports JAX):

    python -m pytest --noconftest -o addopts="" -q tests/test_torch_cuda.py -m cuda
"""
import json
import pathlib

import numpy as np
import pytest
import torch

import emme_tpu_torch as et
from emme_tpu_torch import convert, driver, native
from emme_tpu_torch.grid import Grid
from emme_tpu_torch.ops import (adaptive, cuda_adaptive, cuda_assembly,
                                cuda_guard, cuda_kappa, cuda_spmv, kernels,
                                linalg, singularity, sparse)
from emme_tpu_torch.parallel import mesh as mesh_mod
from emme_tpu_torch.solvers import (arnoldi, cuda_pic, eigen, eigen_native,
                                    pic, sparse_eigen)

torch.set_num_threads(2)

INPUTS = pathlib.Path(__file__).resolve().parent / "goldens" / "inputs"
GOLDEN_TOK128 = complex(-0.7542951557921043, 0.27860070416972454)


def _cfg(name, n):
    with open(INPUTS / f"{name}.json") as f:
        return dict(json.load(f), npoints=n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tok32", "tok32_tier1", "stel24"])
def test_kernel_matches_plain(card, case):
    """K1 vs its plain version: 5e-7 max(scale, 1) for ms=(0,) (the Pallas
    kernel's bar, tests/test_pallas_kappa.py:35), 5e-6 max(scale, 1) for the
    electromagnetic moments (:53); one launch counted per call."""
    quad = None
    if case.startswith("tok32"):
        name, n, om, ms, bar = "tokamak", 32, -0.8 + 0.25j, (0,), 5e-7
        if case == "tok32_tier1":
            quad = kernels.scaled_quad(None, torch.float32,
                                       kernels.TIER_TABLE[1][1])
    else:
        name, n, om, ms, bar = "stellarator", 24, -1.656 + 2.49j, (0, 1, 2), 5e-6
    p = et.from_config(_cfg(name, n), dtype=torch.float32, device=card)
    grid = Grid.create(p.length, n, dtype=torch.float32, device=card)
    iu, ju = torch.triu_indices(n, n, 1, device=card)
    before = cuda_kappa.LAUNCHES
    got = cuda_kappa.kappa_pairs_fused(p, grid.eta[iu], grid.eta[ju], om,
                                       ms=ms, quad=quad)
    torch.cuda.synchronize()
    assert cuda_kappa.LAUNCHES == before + 1
    ref = cuda_kappa.kappa_pairs_ref(p, grid.eta[iu], grid.eta[ju], om,
                                     ms=ms, quad=quad)
    for a, b in zip(got, ref):
        assert a.is_cuda and a.dtype == torch.complex64
        assert bool(torch.isfinite(a).all())
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= bar * max(scale, 1.0)


@pytest.mark.cuda
def test_solve_f32_tok128_through_kernel(card):
    """The main path's solve at n=128 on the card: every assembly goes
    through K1 (tiers x (2 + the steps the loop queued) launches: the
    device loop, the default there, queues one masked step past
    convergence) and omega lands within 1e-5 of golden tok128."""
    p = et.from_config(_cfg("tokamak", 128), dtype=torch.float32, device=card)
    dx = 2.0 * float(p.length) / (p.npoints - 1)
    n_tiers = len(kernels.tier_thresholds_ij(dx, p.npoints))
    before = cuda_kappa.LAUNCHES
    om, vec, n_steps, state = eigen.solve(p, -0.8 + 0.25j, tol=1e-5)
    queued = eigen.LAST_SOLVE["queued_steps"]
    assert queued in (n_steps, n_steps + 1)
    assert cuda_kappa.LAUNCHES - before == n_tiers * (2 + queued)
    assert state.M.is_cuda and vec.is_cuda
    assert abs(om - GOLDEN_TOK128) / abs(GOLDEN_TOK128) < 1e-5


@pytest.mark.cuda
def test_arnoldi_solve_f32_tok128_through_kernel(card):
    """The dense shift-invert Arnoldi with its Newton polish at n=128 in
    float32 on the card: every assembly through K1, omega within 1e-5 of
    golden tok128, the null vector on the card; two shifts batched equal
    their unbatched estimates to 1e-4 (float32, two LU paths)."""
    p = et.from_config(_cfg("tokamak", 128), dtype=torch.float32, device=card)
    before = cuda_kappa.LAUNCHES
    om, vec, steps = arnoldi.solve(p, -0.8 + 0.25j, m_krylov=24,
                                   newton_polish=6, tol=1e-5)
    assert cuda_kappa.LAUNCHES > before and 1 <= steps <= 6
    assert vec.is_cuda and vec.shape == (128,)
    assert abs(om - GOLDEN_TOK128) / abs(GOLDEN_TOK128) < 1e-5
    sigmas = np.array([-0.7 + 0.3j, -0.8 + 0.25j])
    ests = arnoldi.solve_shifts_batched(p, sigmas, m_krylov=24)
    grid = Grid.create(p.length, 128, dtype=torch.float32, device=card)
    coeff = singularity.singularity_coeff_matrix(128, dtype=torch.float32,
                                                 device=card)
    for s, e in zip(sigmas, ests):
        one, _, _ = arnoldi.solve_one_shift(p, grid, coeff, s, 24)
        assert abs(e - one) <= 1e-4 * abs(one)


@pytest.mark.cuda
def test_survey_counts_its_work_and_traces_without_moving_it(card):
    """The multi-shift survey at n=128 in float32 on the card: 1 / S / 2S /
    S in ``arnoldi.SURVEY_ROUTE``, its 2S assemblies on the kernels' route
    with a plan each, and the same estimates bit for bit with a profiler
    recording (its four spans open) as without."""
    from torch.profiler import ProfilerActivity, profile
    p = et.from_config(_cfg("tokamak", 128), dtype=torch.float32, device=card)
    sigmas = -0.8 + 0.25j + 0.15 * np.array([0.3 - 0.2j, -0.5 + 0.9j,
                                             1.1 + 0.1j, -0.2 - 1.3j])
    route, kernels_before = dict(arnoldi.SURVEY_ROUTE), \
        eigen.ASSEMBLY_ROUTE["kernels"]
    plain = arnoldi.solve_shifts_batched(p, sigmas, m_krylov=24)
    assert {k: arnoldi.SURVEY_ROUTE[k] - route[k] for k in route} == {
        "surveys": 1, "shifts": 4, "assemblies": 8, "plans": 4}
    assert eigen.ASSEMBLY_ROUTE["kernels"] - kernels_before == 8
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = arnoldi.solve_shifts_batched(p, sigmas, m_krylov=24)
    opened = {e.name() for e in prof.profiler.kineto_results.events()
              if e.name().startswith("layer.survey.")}
    assert opened == {"layer.survey.secant", "layer.survey.lu",
                      "layer.survey.sweep", "layer.survey.ritz"}
    assert np.array_equal(plain, traced) and np.isfinite(plain).all()


_ASSEMBLY_CASES = {"tok": ("tokamak", -0.8 + 0.25j, 5e-7),
                   "stel": ("stellarator", -1.656 + 2.49j, 5e-6)}


def _assembly_case(card, case, n):
    name, om, bar = _ASSEMBLY_CASES[case]
    p = et.from_config(_cfg(name, n), dtype=torch.float32, device=card)
    grid = Grid.create(p.length, n, dtype=torch.float32, device=card)
    coeff = singularity.singularity_coeff_matrix(n, dtype=torch.float32,
                                                 device=card)
    tiers = kernels.tier_thresholds_ij(2.0 * float(p.length) / (n - 1), n)
    return (p, grid, coeff, tiers,
            torch.tensor(om, dtype=torch.complex64, device=card), bar)


def _max_ulps(a, b):
    """The largest distance of ``a`` from ``b`` in units of b's last
    place (float32)."""
    a, b = a.float(), b.float()
    step = (torch.nextafter(b.abs(), torch.full_like(b, float("inf")))
            - b.abs()).double()
    return float(((a.double() - b.double()).abs() / step).max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tok", "stel"])
def test_assembly_inputs_match_prepare(card, case):
    """Kernel P at n = 128: every tier's K1 inputs (mid, halfw, pair, scal)
    within 4 ulp of ``cuda_kappa._prepare``'s on the same tier's pairs,
    the same omega and mesh, one launch for all tiers."""
    p, grid, _coeff, tiers, omega, _bar = _assembly_case(card, case, 128)
    plan = eigen.assembly_plan(p, grid, None, tiers)
    buf = cuda_assembly.inputs(plan, omega)
    groups = eigen.pair_plan(128, tiers, str(grid.eta.device))["groups"]
    assert len(groups) == len(plan.tiers) >= 2
    for t, (iu, ju, spec) in zip(plan.tiers, groups):
        quad = kernels.scaled_quad(None, torch.float32, spec)
        want = cuda_kappa._prepare(p, grid.eta[iu], grid.eta[ju], omega, quad)
        got = plan.inputs(buf, t)
        assert t.order == want[4]
        for a, b in zip(got, want[:4]):
            assert a.shape == b.shape and bool(torch.isfinite(a).all())
            assert _max_ulps(a, b) <= 4


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tok", "stel"])
def test_kernel_route_assembly_matches_torch_route(card, case):
    """M(omega) at n = 1024 through P, K1 and Q against the torch route on
    the card (``_tiered_pair_values`` through K1, placed by
    ``_materialize_from_pairs``): within K1's bar against its plain version
    (5e-7 electrostatic, 5e-6 electromagnetic, of max(scale, 1)), counted
    once in ``ASSEMBLY_ROUTE["kernels"]`` with one K1 launch a tier."""
    p, grid, coeff, tiers, omega, bar = _assembly_case(card, case, 1024)
    plan = eigen.assembly_plan(p, grid, None, tiers)
    before, k1 = dict(eigen.ASSEMBLY_ROUTE), cuda_kappa.LAUNCHES
    M = eigen.assemble_matrix(p, grid, coeff, omega, tiers=tiers, fused=True,
                              plan=plan)
    assert eigen.ASSEMBLY_ROUTE["kernels"] == before["kernels"] + 1
    assert eigen.ASSEMBLY_ROUTE["torch"] == before["torch"]
    assert cuda_kappa.LAUNCHES - k1 == len(plan.tiers)
    want = eigen._assemble_torch(p, grid, coeff, omega, tiers=tiers,
                                 fused=True)
    dim = 1024 * (2 if p.electromagnetic else 1)
    assert M.shape == want.shape == (dim, dim) and M.dtype == torch.complex64
    assert bool(torch.isfinite(M).all())
    scale = float(want.abs().max())
    assert float((M - want).abs().max()) <= bar * max(scale, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tok", "stel"])
def test_solve_kernel_route_matches_torch_route(card, case, monkeypatch):
    """A float32 solve at n = 128 on the kernel route lands within 1e-6 of
    the same solve on the torch route (``kernel_route`` off)."""
    name, om, _bar = _ASSEMBLY_CASES[case]
    p = et.from_config(_cfg(name, 128), dtype=torch.float32, device=card)
    tol = 1e-5 if case == "tok" else 1e-6
    om_k, _vec, _steps, _st = eigen.solve(p, om, tol=tol)
    monkeypatch.setattr(eigen, "kernel_route", lambda *a: False)
    before = dict(eigen.ASSEMBLY_ROUTE)
    om_t, _vec, _steps, _st = eigen.solve(p, om, tol=tol)
    assert eigen.ASSEMBLY_ROUTE["kernels"] == before["kernels"]
    assert eigen.ASSEMBLY_ROUTE["torch"] > before["torch"]
    assert abs(om_k - om_t) / abs(om_t) < 1e-6


@pytest.mark.cuda
def test_assembly_route_counts_every_card_assembly(card):
    """A tok128 float32 solve with its complex128 polish on the card: every
    dense assembly (two seeds, each queued step, each polish step's) takes
    the kernels, none the torch route."""
    p = et.from_config(_cfg("tokamak", 128), dtype=torch.float32, device=card)
    eigen.ASSEMBLY_ROUTE.update(kernels=0, torch=0)
    om, _vec, _n, _st = eigen.solve(p, -0.8 + 0.25j, tol=1e-6, host64=True)
    did = eigen.LAST_SOLVE
    assert eigen.ASSEMBLY_ROUTE == {
        "kernels": 2 + did["queued_steps"] + did["polish_assemblies"],
        "torch": 0}
    assert abs(om - GOLDEN_TOK128) / abs(GOLDEN_TOK128) < 1e-5


@pytest.mark.cuda
def test_assembly_launches_under_profiler(card):
    """One tok1024 ``assemble_matrix`` with its solve's plan launches 10
    kernels or fewer on the card, K1 among them once a tier (4), and
    nothing else named like K1."""
    from torch.profiler import ProfilerActivity, profile
    p, grid, coeff, tiers, omega, _bar = _assembly_case(card, "tok", 1024)
    plan = eigen.assembly_plan(p, grid, None, tiers)

    def assemble():
        return eigen.assemble_matrix(p, grid, coeff, omega, tiers=tiers,
                                     fused=True, plan=plan)

    assemble()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        assemble()
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if not str(e.device_type()).endswith("CPU")
             and not e.name().startswith(("Memcpy", "Memset"))
             and e.duration_ns() > 0]
    k1 = [n for n in names if "kappa_pairs_kernel" in n]
    assert len(plan.tiers) == 4 and len(k1) == 4
    assert len(names) <= 10, names
    assert sum("assembly_inputs_kernel" in n for n in names) == 1
    assert sum("assembly_place_kernel" in n for n in names) == 1


# The guard's cases on the card: (input, npoints, the converged omega, band
# half-width in blocks of the banded cell or None).  The converged omegas:
# golden tok128 and tok1024, the stellarator's continuation point, the
# banded tok8192 cell's guess.
_GUARD_CASES = {"tok128": ("tokamak", 128, GOLDEN_TOK128, None),
                "tok1024": ("tokamak", 1024,
                            complex(-0.8323805740805391, 0.2565467084687576),
                            None),
                "stel1024": ("stellarator", 1024, -1.656 + 2.49j, None),
                "tok8192_band": ("tokamak", 8192, -0.8405 + 0.2529j, 10.0)}
GUARD_BAD_OMEGA = -6.0 + 0.001j   # outpaces the oscillatory panels


def _guard_case(card, case, device=None):
    name, n, om, band = _GUARD_CASES[case]
    device = device or card
    p = et.from_config(_cfg(name, n), dtype=torch.float32, device=device)
    grid = Grid.create(p.length, n, dtype=torch.float32, device=device)
    tiers = kernels.tier_thresholds_ij(2.0 * float(p.length) / (n - 1), n)
    max_dij = None
    if band is not None:
        block = sparse_eigen.pick_block(n)
        max_dij = (sparse_eigen.band_halfwidth(p, grid, block, band) + 1) \
            * block - 1
    return p, grid, dict(tiers=tiers, max_dij=max_dij), om


# The guard's largest errors on the kernel route against the torch route's.
# The torch route itself reads them differently on the card and on the
# CPU (the same sample, float32, the same integrand; only the rounding of
# the two devices' kernels differs).  Measured on an H100 over the cases of
# test_guard_kernel_route_matches_torch_route, the card's reading against
# the CPU's:
# * max_abs_err, the largest embedded error or tier gap: apart by up to
#   2.9e-4 of itself (tok128 at its converged omega), and at the stellarator's
#   converged omega, where every error lies at float32's rounding floor, by
#   7.6e-8 of 3.6e-7.  The kernels are held within 3e-4 of the torch card
#   reading plus K1's bar (5e-7 / 5e-6) of max(scale, 1), the rounding
#   floor of a value of that scale.
# * max_rel_err, the largest error over |K|: its maximum sits at a pair
#   whose |K| is at the rounding floor, a ratio of two rounding errors, and
#   the two readings lie up to 4.64 times apart (stellarator, converged).
#   The kernels are held within a factor of 5 of the nearer of the two.
GUARD_ABS_SPREAD = 3e-4
GUARD_REL_FACTOR = 5.0
# At GUARD_BAD_OMEGA, where the integrand oscillates fast, K1 itself lies
# up to 2.6e-6 of max(scale, 1) from its plain version and the torch
# integrand (H100, the cases below; tok8192_band the largest).  G is held
# there no further than K1 plus the bar, and under this ceiling whatever
# K1 reads.
GUARD_BAD_CEIL = 3e-6


@pytest.mark.cuda
@pytest.mark.parametrize("at", ["converged", "bad"])
@pytest.mark.parametrize("case", list(_GUARD_CASES))
def test_guard_kernel_route_matches_torch_route(card, case, at):
    """The guard on the kernel route (P, G, R) against the torch route on
    the card and on the CPU, at the converged omega and at one that fires
    the flags.  G's values of every set: within K1's bar (5e-7
    electrostatic, 5e-6 electromagnetic, of max(scale, 1)) of K1 itself on
    the same inputs (the same node math, summed in another order); from
    K1's plain version and from the torch integrand (another float32
    evaluation of the integral: atan, the complex Bessel series) no further
    than K1 is from each plus that bar, and within the bar of both at the
    converged omega (at omega = -6 + 0.001i, where the integrand
    oscillates fast, K1 itself lies up to 2.6e-6 of scale from either; G
    within ``GUARD_BAD_CEIL`` of both there).  G's
    embedded errors pair by pair within twice the bar of the torch
    integrand's plus 2^-18 (32 float32 ulp) of their size: a panel's
    |K - G| carries the rounding of two float32 sums where a value carries
    one, and an error sums up to 44 panels' rounded terms.  The reports:
    the same ``n_sampled`` (4096), ``frac_flagged`` within 0.01, the
    largest errors within the torch route's own card-to-CPU spread
    (``GUARD_ABS_SPREAD``, ``GUARD_REL_FACTOR``), and R's report the
    plain reduction (``guard_report``) of G's own rows read as R reads
    them (``cuda_guard.pair_values``): the same largest errors to 1e-6 of
    themselves, the flagged count within 4 of 4096 (R's and torch's complex
    products round |K| and the threshold apart by a float32 ulp, which
    moves only a pair at the threshold).  One guard counts once in
    ``GUARD_ROUTE["kernels"]`` and launches G and R once each."""
    p, grid, kw, om = _guard_case(card, case)
    if at == "bad":
        om = GUARD_BAD_OMEGA
    ms = (0, 1, 2) if p.electromagnetic else (0,)
    bar = 5e-6 if p.electromagnetic else 5e-7
    before, launches = dict(eigen.GUARD_ROUTE), cuda_guard.LAUNCHES
    got = eigen.quadrature_guard(p, grid, om, **kw)
    assert eigen.GUARD_ROUTE == {"kernels": before["kernels"] + 1,
                                 "torch": before["torch"]}
    assert cuda_guard.LAUNCHES == launches + 2
    acc, prec = p.integration_accuracy, p.integration_precision
    torch_card = eigen.guard_report(
        *eigen.guard_pairs(p, grid, om, chunk=16384, **kw), acc, prec)
    p_c, grid_c, kw_c, _ = _guard_case(card, case, torch.device("cpu"))
    torch_cpu = eigen.guard_report(
        *eigen.guard_pairs(p_c, grid_c, om, chunk=16384, **kw_c), acc, prec)
    print(f"guard {case} {at}: kernels {got} torch card {torch_card} "
          f"torch cpu {torch_cpu}")
    assert got["n_sampled"] == torch_card["n_sampled"] \
        == torch_cpu["n_sampled"] == 4096
    assert abs(got["frac_flagged"] - torch_card["frac_flagged"]) <= 0.01
    nearer = min(abs(np.log(got["max_rel_err"] / t["max_rel_err"]))
                 for t in (torch_card, torch_cpu))
    assert nearer <= np.log(GUARD_REL_FACTOR), (got, torch_card, torch_cpu)

    # G's rows against the torch integrand, set by set
    gplan = eigen._guard_plan(
        grid.npoints, ms, (4096, 0, tuple(kw["tiers"]), kw["max_dij"]),
        None, int(p.integration_start_points), str(grid.eta.device))
    points, scalars = cuda_assembly.point_rows(p, grid)
    buf = cuda_assembly.inputs(gplan.inputs_plan(points, scalars), om)
    out = cuda_guard.pairs(gplan, buf)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    iu, ju, groups = eigen.guard_sample(grid.npoints, 4096, 0,
                                        tuple(kw["tiers"]), kw["max_dij"])
    quads = []
    for _idx, spec in groups:
        quads.append(None)
        if spec != 1.0:
            quads.append(kernels.scaled_quad(None, torch.float32, spec))
    assert len(quads) == len(gplan.tiers)
    omega = torch.tensor(om, dtype=torch.complex64, device=card)
    inputs = gplan.inputs_plan(points, scalars)
    apref = (-1j * (p.q * p.R) / (p.vt * np.sqrt(2.0 * np.pi))).abs()
    row, scale = 0, 1.0
    gaps = {"plain": 0.0, "k1": 0.0, "torch": 0.0, "k1_plain": 0.0,
            "k1_torch": 0.0, "error": 0.0, "error_rel": 0.0}
    for t, quad in zip(gplan.tiers, quads):
        rows = out[row:row + t.npairs]
        row += t.npairs
        vals = cuda_kappa._finish(p, rows[:, :2 * len(ms)].contiguous(), ms)
        k1 = cuda_kappa._finish(
            p, cuda_kappa._launch(*inputs.inputs(buf, t), t.order, ms), ms)
        plain = cuda_kappa.kappa_pairs_ref(p, grid.eta[t.iu], grid.eta[t.ju],
                                           omega, ms=ms, quad=quad)
        want, errs = kernels.kappa_f_tau(p, grid.eta[t.iu], grid.eta[t.ju],
                                         omega, ms=ms, quad=quad)
        for k in range(len(ms)):
            s_k = max(float(want[k].abs().max()), 1.0)
            scale = max(scale, s_k)
            err_gap = (apref * rows[:, 2 * len(ms) + k] - errs[k]).abs()
            d = {"plain": vals[k] - plain[k], "k1": vals[k] - k1[k],
                 "torch": vals[k] - want[k], "k1_plain": k1[k] - plain[k],
                 "k1_torch": k1[k] - want[k], "error": err_gap}
            d = {key: float(v.abs().max()) for key, v in d.items()}
            d["error_rel"] = float(((err_gap - 2 * bar * s_k).clamp_min(0)
                                    / errs[k].abs()).nan_to_num().max())
            for key in gaps:
                gaps[key] = max(gaps[key], d[key] / (1.0 if key ==
                                                     "error_rel" else s_k))
            assert d["k1"] <= bar * s_k, (case, at, k, d, s_k)
            assert d["plain"] <= d["k1_plain"] + bar * s_k, (case, at, k, d)
            assert d["torch"] <= d["k1_torch"] + bar * s_k, (case, at, k, d)
            if at == "converged":
                assert max(d["plain"], d["torch"]) <= bar * s_k, (case, k, d)
            else:
                assert max(d["plain"], d["torch"]) <= GUARD_BAD_CEIL * s_k, \
                    (case, k, d)
            assert d["error_rel"] <= 2.0 ** -18, (case, at, k, d, s_k)
    print(f"guard {case} {at}: G's values and errors, of max(scale, 1): "
          f"{gaps}")
    assert abs(got["max_abs_err"] - torch_card["max_abs_err"]) \
        <= GUARD_ABS_SPREAD * torch_card["max_abs_err"] + bar * scale

    # R against the plain reduction of G's own rows
    rep = cuda_guard.report(gplan, out, scalars, acc, prec)
    plain = eigen.guard_report(*cuda_guard.pair_values(gplan, out, scalars),
                               acc, prec)
    flagged, max_abs, max_rel = rep.tolist()
    print(f"guard {case} {at}: R {rep.tolist()} plain on G's rows {plain}")
    assert abs(flagged - plain["frac_flagged"] * 4096) <= 4
    assert max_abs == pytest.approx(plain["max_abs_err"], rel=1e-6)
    assert max_rel == pytest.approx(plain["max_rel_err"], rel=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tok1024", "stel1024"])
def test_guard_launches_and_host_reads(card, case):
    """A tok1024 and a stel1024 guard on the card with its solve's
    assembly plan, as the driver runs it: 10 kernel launches or fewer (P,
    G and R: the launch calls the profiler sees on the host) and one
    ``layer.host_read`` span, the report's; K1 not among the kernels."""
    from torch.profiler import ProfilerActivity, profile
    p, grid, kw, om = _guard_case(card, case)
    plan = eigen.assembly_plan(p, grid, None, kw["tiers"])

    def guard():
        return eigen.quadrature_guard(p, grid, om, plan=plan, **kw)

    guard()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        g = guard()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    on_host = [e.name() for e in events
               if str(e.device_type()).endswith("CPU")]
    launches = sum(n.startswith(("cudaLaunch", "cuLaunch")) for n in on_host)
    reads = on_host.count("layer.host_read")
    names = [e.name() for e in events
             if not str(e.device_type()).endswith("CPU")
             and not e.name().startswith(("Memcpy", "Memset", "layer."))]
    print(f"guard {case}: {launches} launches, {reads} host reads; device "
          f"kernels seen {names}")
    assert 3 <= launches <= 10 and reads == 1
    assert not any("kappa_pairs_kernel" in n for n in names)
    assert g["n_sampled"] == 4096
    with pytest.raises(ValueError, match="assembly plan"):
        small = eigen.assembly_plan(*_guard_case(card, "tok128")[:2], None,
                                    None)
        eigen.quadrature_guard(p, grid, om, plan=small, **kw)


@pytest.mark.cuda
def test_guard_routes_on_the_card_by_dtype_and_k1(card):
    """On the card the guard takes the kernels only for float32 with K1:
    float64 parameters, and float32 with K1 turned off, take the torch
    route, counted in ``GUARD_ROUTE["torch"]`` and launching neither G nor
    R; their reports keep the sample."""
    for dtype, fused in ((torch.float64, None), (torch.float32, False)):
        p = et.from_config(_cfg("tokamak", 128), dtype=dtype, device=card)
        grid = Grid.create(p.length, 128, dtype=dtype, device=card)
        before, launches = dict(eigen.GUARD_ROUTE), cuda_guard.LAUNCHES
        g = eigen.quadrature_guard(p, grid, GOLDEN_TOK128, sample=512,
                                   fused=fused)
        assert eigen.GUARD_ROUTE == {"kernels": before["kernels"],
                                     "torch": before["torch"] + 1}
        assert cuda_guard.LAUNCHES == launches and g["n_sampled"] == 512


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tok", "stel"])
def test_assembly_bytes_unchanged_by_the_guard(card, case):
    """An n = 1024 kernel-route assembly's M is byte-equal before and after
    the guard's kernels G and R are loaded and run from the same library
    (K1, P and Q on the assembly's path unchanged), and again after a
    second guard."""
    p, grid, coeff, tiers, omega, _bar = _assembly_case(card, case, 1024)
    plan = eigen.assembly_plan(p, grid, None, tiers)

    def assemble():
        M = eigen.assemble_matrix(p, grid, coeff, omega, tiers=tiers,
                                  fused=True, plan=plan)
        return torch.view_as_real(M).contiguous().view(torch.int32).clone()

    first = assemble()
    for _ in range(2):
        eigen.quadrature_guard(p, grid, complex(omega), tiers=tiers,
                               plan=plan)
        assert torch.equal(assemble(), first)


def _pic_case(card, n, mpc, dc=True, seed=0):
    p = et.from_config(dict(_cfg("tokamak", n),
                            drift_center_transformation_switch=dc),
                       dtype=torch.float32, device=card)
    gen = torch.Generator(device=card).manual_seed(seed)
    return p, pic.init_state(p, mpc, gen, dtype=torch.float32)


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _within_ulp(a, b):
    inf = torch.full_like(b, float("inf"))
    return bool(((a == b) | (a == torch.nextafter(b, inf))
                 | (a == torch.nextafter(b, -inf))).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dc", [True, False])
@pytest.mark.parametrize("stage_idx,first", [(0, True), (0, False), (1, False),
                                             (2, False)])
def test_pic_stage_matches_plain(card, stage_idx, first, dc):
    """K2 (pic_stage + pic_field) against stage_ref on the same inputs, each
    of the 8 variants: velocity, weight and field within 2e-5 of scale
    (tests/test_pallas_pic.py:33-59), eta within 1 ulp."""
    p, s0 = _pic_case(card, 128, 64, dc)
    fs = cuda_pic.FusedStep(p, 128 * 64, 0.25)
    qn = pic.quasi_neutrality_coef(p, dtype=torch.float32)
    arrs = cuda_pic.state_to_arrs(s0)
    # one plain step first, so the field and the weights are not trivial
    eta, wre, wim, fr, fi, _ = cuda_pic.mega_ref(
        dc, fs.params, s0.field.real.contiguous(),
        s0.field.imag.contiguous(), qn, arrs, 1)
    arrs = dict(arrs, eta=eta, w_re=wre, w_im=wim)
    vel_prev = None
    if stage_idx == 2:
        vel_prev = cuda_pic.stage_ref(1, False, dc, fs.params, fr, fi, qn,
                                      arrs)[:2]
    before = dict(cuda_pic.LAUNCHES)
    got = cuda_pic.stage(stage_idx, first, dc, fs.params, fr, fi, qn, arrs,
                         vel_prev)
    torch.cuda.synchronize()
    assert cuda_pic.LAUNCHES["pic_stage"] == before["pic_stage"] + 1
    assert cuda_pic.LAUNCHES["pic_field"] == before["pic_field"] + 1
    ref = cuda_pic.stage_ref(stage_idx, first, dc, fs.params, fr, fi, qn,
                             arrs, vel_prev)
    names = ("vel_re", "vel_im", "eta", "w_re", "w_im", "field_re",
             "field_im")
    for name, a, b in zip(names, got, ref):
        assert a.is_cuda and bool(torch.isfinite(a).all()), name
        assert _rel(a, b) < 2e-5, name
    assert _within_ulp(got[2], ref[2])


@pytest.mark.cuda
def test_pic_mega_matches_stages(card):
    """K3 against K2 stage by stage over 8 steps at n=1024, 64 markers per
    cell, from one state: stats 1e-5, state 2e-5 (dc_pb 1e-4), eta
    bit-equal (one stage body)."""
    p, s0 = _pic_case(card, 1024, 64)
    st_k3, s_k3, _ = cuda_pic.run(p, 64, 8, 0.25, state=s0, launch="single")
    st_k2, s_k2, _ = cuda_pic.run(p, 64, 8, 0.25, state=s0, launch="stages")
    assert st_k3.shape == (8, 3) and bool(torch.isfinite(st_k3).all())
    assert _rel(st_k3, st_k2) < 1e-5
    for name, bar in (("weight", 2e-5), ("field", 2e-5), ("j0", 2e-5),
                      ("dc_pb", 1e-4)):
        assert _rel(getattr(s_k3, name), getattr(s_k2, name)) < bar, name
    assert torch.equal(s_k3.eta, s_k2.eta)


@pytest.mark.cuda
def test_grid_sync_probe(card):
    """K4 at K3's co-resident grid (one block of 1024 threads a SM): after
    grid.sync() every block sees every other block's writes; the self-check
    passes."""
    grid = cuda_pic.mega_grid(card, 1024, True)
    assert grid["cooperative"] and grid["grid"] == grid["sms"]
    assert grid["threads"] == cuda_pic.THREADS
    x = torch.rand((grid["grid"], cuda_pic.THREADS), device=card)
    before = cuda_pic.LAUNCHES["grid_sync_probe"]
    got = cuda_pic.grid_sync_probe(x)
    assert cuda_pic.LAUNCHES["grid_sync_probe"] == before + 1
    assert torch.equal(got, cuda_pic.grid_sync_probe_ref(x))
    ok, info = cuda_pic.grid_sync_selfcheck(card, 1024, True)
    assert ok, info


@pytest.mark.cuda
@pytest.mark.parametrize("rounds,slice_", [(1, 300), (2, 1024), (3, 7),
                                           (5, 300)])
def test_grid_sync_probe_rounds(card, rounds, slice_):
    """K4 against its plain version over round counts and slice lengths,
    one block a SM."""
    sms = cuda_pic.mega_grid(card, 1024, True)["sms"]
    x = torch.rand((sms, slice_), device=card)
    got = cuda_pic.grid_sync_probe(x, rounds)
    assert torch.equal(got, cuda_pic.grid_sync_probe_ref(x, rounds))


@pytest.mark.cuda
def test_default_device_is_the_card(card):
    """from_config, convert and the constructors that take a device land
    on the CUDA card when given none, and the solve from there runs on
    it."""
    p = et.from_config(_cfg("tokamak", 32), dtype=torch.float32)
    assert p.device.type == "cuda" and p.length.is_cuda
    st = convert.state_from_arrays(0j, 0j, np.eye(2), np.eye(2))
    assert st.M.is_cuda
    assert Grid.create(20.0, 33).eta.is_cuda
    assert singularity.singularity_coeff_matrix(8).is_cuda
    assert singularity.singularity_coeff_band(8, 2).is_cuda
    assert sparse.bsr_from_dense(np.eye(4), block=2).data.is_cuda
    assert sparse.bdia_from_dense(np.eye(4), block=2).data.is_cuda
    V, H = arnoldi.arnoldi_factorization(lambda x: x, 4, 2)
    assert V.is_cuda and H.is_cuda
    om, vec, _, state = eigen.solve(p, -0.8 + 0.25j, tol=1e-5)
    assert state.M.is_cuda and vec.is_cuda


@pytest.mark.cuda
def test_pic_mega_repeats(card):
    """K3 twice from one state: eta bit-equal (it never sees the field);
    weights, field and stats within the stage bars (the order of the
    shared-memory atomics inside a block is free).  K2's field reduce on
    the same partials repeats bit for bit: the cross-block order is
    fixed."""
    p, s0 = _pic_case(card, 1024, 64)
    st_a, s_a, _ = cuda_pic.run(p, 64, 8, 0.25, state=s0, launch="single")
    st_b, s_b, _ = cuda_pic.run(p, 64, 8, 0.25, state=s0, launch="single")
    assert torch.equal(s_a.eta, s_b.eta)
    assert _rel(st_a, st_b) < 1e-5
    for name in ("weight", "field"):
        assert _rel(getattr(s_a, name), getattr(s_b, name)) < 2e-5, name
    shape = cuda_pic.LAST_MEGA_GRID
    assert shape == cuda_pic.mega_grid(card, 1024, True)
    assert shape["partials"] == shape["grid"] == shape["sms"]
    fs = cuda_pic.FusedStep(p, 1024 * 64, 0.25)
    qn = pic.quasi_neutrality_coef(p, dtype=torch.float32)
    *_, partials = cuda_pic._launch_stage(
        0, False, True, fs.params, s_a.field.real.contiguous(),
        s_a.field.imag.contiguous(), cuda_pic.state_to_arrs(s_a), None)
    assert partials.dtype == torch.float64
    a, b = (cuda_pic._launch_field(partials, qn) for _ in range(2))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,dc", [(96, True), (96, False), (32, True),
                                  (2048, True)])
def test_pic_mega_matches_plain_at_other_sizes(card, n, dc):
    """K3 against mega_ref at grids other than 1024 and 128, among them
    npoints = 96 (an odd number of 32-column tiles a plane): per-step
    stats within 1e-5, weights and field within 2e-5 of scale, eta within
    1 ulp."""
    p, s0 = _pic_case(card, n, 64, dc)
    params = cuda_pic.FusedStep.params_vec(p, 0.25)
    qn = pic.quasi_neutrality_coef(p, dtype=torch.float32)
    arrs = cuda_pic.state_to_arrs(s0)
    field = (s0.field.real.contiguous(), s0.field.imag.contiguous())
    got = cuda_pic.mega(dc, params, *field, qn, arrs, 4)
    ref = cuda_pic.mega_ref(dc, params, *field, qn, arrs, 4)
    assert got[5].shape == (4, 3) and bool(torch.isfinite(got[5]).all())
    assert _rel(got[5], ref[5]) < 1e-5
    for a, b in zip(got[1:5], ref[1:5]):
        assert _rel(a, b) < 2e-5
    assert _within_ulp(got[0], ref[0])
    k2 = cuda_pic.stage(0, True, dc, params, *field, qn, arrs)
    k2_ref = cuda_pic.stage_ref(0, True, dc, params, *field, qn, arrs)
    for a, b in zip(k2[5:], k2_ref[5:]):
        assert _rel(a, b) < 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n,form,mpc", [
    (16384, cuda_pic.FORM_CLUSTER, 64), (32768, cuda_pic.FORM_CLUSTER, 64),
    (65536, cuda_pic.FORM_CLUSTER, 64), (131072, cuda_pic.FORM_CLUSTER, 16),
    (224256, cuda_pic.FORM_CLUSTER, 16), (229376, cuda_pic.FORM_GLOBAL, 16)])
def test_pic_large_grid_matches_plain(card, n, form, mpc):
    """Past the small-grid form: npoints 16,384 (the histogram in one
    block's shared memory, the field from device memory), 32,768, 65,536,
    131,072 and 224,256 (the histogram in a cluster's distributed shared
    memory, clusters of 2, 4 and 8; at 224,256, the cap, every rank's slice
    and the reduce's table fill a block's 232,448 bytes) and 229,376 (past
    the cluster form's cap: a scratch row a block), 64 or 16 markers per
    cell, dt 0.25 scaled with the cell width
    (at dt 0.25 the scheme's grid-scale mode grows past float32 at these
    grids, the sooner the fewer markers a cell, in emme_tpu too).  K3 over
    4 steps against mega_ref (stats 1e-5, weights and field 2e-5 of scale,
    eta within 1 ulp), K2's stages of one step against stage_ref (2e-5),
    eta bit-equal between two K3 runs and between K3 and K2 through the
    run entry point."""
    p, s0 = _pic_case(card, n, mpc)
    dt = 0.25 * 1024 / n
    shape = cuda_pic.mega_grid(card, n, True)
    cs = cuda_pic.cluster_size(n)
    assert shape["form"] == form and shape["cluster"] == cs
    assert shape["clusters"] >= 1 and shape["partials"] == shape["clusters"]
    assert shape["grid"] == shape["clusters"] * cs <= shape["sms"]
    if cs == 1:
        assert shape["grid"] == shape["sms"]
    params = cuda_pic.FusedStep.params_vec(p, dt)
    qn = pic.quasi_neutrality_coef(p, dtype=torch.float32)
    arrs = cuda_pic.state_to_arrs(s0)
    field = (s0.field.real.contiguous(), s0.field.imag.contiguous())
    got = cuda_pic.mega(True, params, *field, qn, arrs, 4)
    again = cuda_pic.mega(True, params, *field, qn, arrs, 4)
    ref = cuda_pic.mega_ref(True, params, *field, qn, arrs, 4)
    assert cuda_pic.LAST_MEGA_GRID == shape
    assert got[5].shape == (4, 3) and bool(torch.isfinite(got[5]).all())
    assert _rel(got[5], ref[5]) < 1e-5
    for a, b in zip(got[1:5], ref[1:5]):
        assert _rel(a, b) < 2e-5
    assert _within_ulp(got[0], ref[0]) and torch.equal(got[0], again[0])
    vel_prev = None
    for s in range(3):
        k2 = cuda_pic.stage(s, s == 0, True, params, *field, qn, arrs,
                            vel_prev)
        k2_ref = cuda_pic.stage_ref(s, s == 0, True, params, *field, qn,
                                    arrs, vel_prev)
        for a, b in zip(k2, k2_ref):
            assert _rel(a, b) < 2e-5
        vel_prev = k2[:2] if s == 1 else None
        arrs = dict(arrs, eta=k2[2], w_re=k2[3], w_im=k2[4])
        field = k2[5:]
    _, s_k2, _ = cuda_pic.run(p, mpc, 4, dt, state=s0, launch="stages")
    assert torch.equal(s_k2.eta, got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32768, 65536, 131072, 224256])
def test_grid_sync_probe_at_cluster_shape(card, n):
    """K4 at K3's launch shape in the cluster form (clusters of 2, 4, 8:
    the co-resident clusters times their size; 224,256, the cap, gives K3
    a full block of shared memory a rank): the runtime takes the
    cooperative and the cluster attributes together, and after grid.sync()
    every block sees every other block's writes; the self-check passes.
    A grid that is not a whole number of clusters is refused before any
    launch."""
    shape = cuda_pic.mega_grid(card, n, True)
    cs = cuda_pic.cluster_size(n)
    assert shape["cooperative"] and shape["cluster"] == cs > 1
    assert shape["grid"] == shape["clusters"] * cs >= cs
    x = torch.rand((shape["grid"], cuda_pic.THREADS), device=card)
    before = cuda_pic.LAUNCHES["grid_sync_probe"]
    for rounds in (1, cuda_pic.PROBE_ROUNDS, 5):
        got = cuda_pic.grid_sync_probe(x, rounds, cluster=cs)
        assert torch.equal(got, cuda_pic.grid_sync_probe_ref(x, rounds))
    assert cuda_pic.LAUNCHES["grid_sync_probe"] == before + 3
    with pytest.raises(ValueError, match="clusters"):
        cuda_pic.grid_sync_probe(x[:cs + 1], cluster=cs)
    cuda_pic._SELFCHECK.clear()
    ok, info = cuda_pic.grid_sync_selfcheck(card, n, True)
    assert ok, info
    assert info["cluster"] == cs and info["grid"] == shape["grid"]


@pytest.mark.cuda
def test_pic_kernels_refuse_a_tile_across_planes(card):
    """npoints = 48 (a reduce tile would span both planes) is refused by
    the wrappers on the card too, before any launch."""
    before = dict(cuda_pic.LAUNCHES)
    arrs = {k: torch.zeros(48 * 8, device=card) for k in cuda_pic.MARKERS}
    fr = torch.zeros(48, device=card)
    with pytest.raises(ValueError, match="npoints % 32"):
        cuda_pic.mega(True, np.zeros(cuda_pic.N_PARAMS, np.float32), fr, fr,
                      fr, arrs, 1)
    assert cuda_pic.LAUNCHES == before


@pytest.mark.cuda
def test_run_sorted_matches_run_on_card(card):
    """The sorted-window path on the card (npoints 128, 64 markers a cell,
    float32, windows of 32 cells over chunks of 512 markers) for 8 steps
    against pic.run from the same state: no violation, the stats within
    1e-4 relative and the field within 1e-3 of its scale (only float32
    rounding parts them: the unwrapped eta and the order of the sums; on
    CPU tensors 1.7e-6 to 4.6e-6 and 2.6e-5 to 6.6e-5 over three seeds)."""
    p, s0 = _pic_case(card, 128, 64)
    st, s, viols = pic.run_sorted(p, 64, 8, 0.25, state=s0, window=32,
                                  chunk_markers=512)
    st_r, s_r, _ = pic.run(p, 64, 8, 0.25, state=s0)
    assert s.field.is_cuda and st.shape == (8, 3)
    assert int(viols) == 0
    assert pic.LAST_SORTED["n_chunks"] == 16
    assert pic.LAST_SORTED["sorts"] * pic.LAST_SORTED["R"] == 8
    assert bool(torch.isfinite(st).all())
    assert _rel(st, st_r) < 1e-4
    assert _rel(s.field, s_r.field) < 1e-3


@pytest.mark.cuda
def test_pic_auto_takes_single_launch(card):
    """launch='auto' runs K3 once when the self-check passes."""
    p, s0 = _pic_case(card, 128, 8)
    before = cuda_pic.LAUNCHES["pic_mega"]
    stats, s, _ = cuda_pic.run(p, 8, 2, 0.25, state=s0)
    assert cuda_pic.LAST_LAUNCH == "single"
    assert cuda_pic.LAUNCHES["pic_mega"] == before + 1
    assert stats.is_cuda and bool(torch.isfinite(stats).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("r", [1, 16])
@pytest.mark.parametrize("dtype,bar", [(torch.complex64, 1e-5),
                                       (torch.complex128, 1e-12)])
def test_bsr_spmv_matches_plain(card, bs, r, dtype, bar):
    """K5 vs bsr_matvec_ref on a random banded operator with a dropped
    block diagonal: within 1e-5 of scale in complex64, 1e-12 in
    complex128; one launch counted per call."""
    n = 4 * 128
    rng = np.random.default_rng(bs + r)
    M = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    nb = n // bs
    off = np.subtract.outer(np.arange(nb), np.arange(nb))
    keep = (np.abs(off) <= 3) & (off != 2)
    M = np.where(np.kron(keep, np.ones((bs, bs), bool)), M, 0.0)
    M = M.astype(np.complex64 if dtype == torch.complex64 else np.complex128)
    bsr = sparse.bdia_to_bsr(sparse.bdia_from_dense(M, block=bs, device=card))
    assert bsr.data.dtype == dtype
    shape = (n,) if r == 1 else (n, r)
    x = torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape),
                        dtype=dtype, device=card)
    before = cuda_spmv.LAUNCHES
    y = sparse.bsr_matvec(bsr, x)
    torch.cuda.synchronize()
    assert cuda_spmv.LAUNCHES == before + 1
    ref = sparse.bsr_matvec_ref(bsr, x)
    assert y.is_cuda and y.shape == shape and y.dtype == dtype
    scale = float(ref.abs().max())
    assert float((y - ref).abs().max()) <= bar * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bar", [(torch.complex64, 1e-5),
                                       (torch.complex128, 1e-12)])
def test_bsr_spmv_element_loads(card, dtype, bar):
    """The r = 1 kernel's element-sized loads: an odd block (9) and an x
    that is not 16-byte aligned (a view one element into its buffer)."""
    rng = np.random.default_rng(3)
    for bs, n in ((9, 72), (16, 64)):
        M = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
        bsr = sparse.bsr_from_dense(M, block=bs, device=card)
        bsr = sparse.BSROperator(data=bsr.data.to(dtype), col_idx=bsr.col_idx,
                                 row_of=bsr.row_of, row_ptr=bsr.row_ptr,
                                 n=n, block=bs)
        buf = torch.as_tensor(rng.normal(size=n + 1) + 1j * rng.normal(
            size=n + 1), dtype=dtype, device=card)
        x = buf[1:]
        y = sparse.bsr_matvec(bsr, x)
        ref = sparse.bsr_matvec_ref(bsr, x)
        torch.cuda.synchronize()
        assert float((y - ref).abs().max()) <= bar * float(ref.abs().max())


def _banded_bsr(card, bs, nb, dtype, seed):
    """A random block-banded operator (half-width 3, one block diagonal and
    one whole block row dropped) as a BSROperator on the card."""
    n = bs * nb
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    off = np.subtract.outer(np.arange(nb), np.arange(nb))
    keep = (np.abs(off) <= 3) & (off != 2)
    keep[2, :] = False
    M = np.where(np.kron(keep, np.ones((bs, bs), bool)), M, 0.0)
    M = M.astype(np.complex64 if dtype == torch.complex64 else np.complex128)
    bsr = sparse.bsr_from_dense(M, block=bs, device=card)
    assert bsr.data.dtype == dtype
    assert int(bsr.row_ptr[3] - bsr.row_ptr[2]) == 0
    return bsr, rng


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [32, 128, 9])
@pytest.mark.parametrize("r", [2, 8, 16, 17, 40])
@pytest.mark.parametrize("dtype,bar", [(torch.complex64, 1e-5),
                                       (torch.complex128, 1e-12)])
def test_bsr_spmm_matches_plain(card, bs, r, dtype, bar):
    """K5 with several right-hand sides vs bsr_matvec_ref on a banded
    operator with a dropped block row: the ring kernel (complex64, even
    block) and the generic kernel (complex128, the odd block 9), r below, at
    and above the 16 a pass takes, within 1e-5 of scale in complex64 and
    1e-12 in complex128; the dropped row's y is exactly zero; two runs
    repeat bit for bit; one launch counted per call."""
    bsr, rng = _banded_bsr(card, bs, 8, dtype, 100 * bs + r)
    n = bsr.n
    x = torch.as_tensor(rng.normal(size=(n, r)) + 1j * rng.normal(size=(n, r)),
                        dtype=dtype, device=card)
    before = cuda_spmv.LAUNCHES
    y = sparse.bsr_matvec(bsr, x)
    again = sparse.bsr_matvec(bsr, x)
    torch.cuda.synchronize()
    assert cuda_spmv.LAUNCHES == before + 2
    ref = sparse.bsr_matvec_ref(bsr, x)
    assert y.is_cuda and y.shape == (n, r) and y.dtype == dtype
    assert float((y - ref).abs().max()) <= bar * float(ref.abs().max())
    assert float(y[2 * bs:3 * bs].abs().max()) == 0.0
    assert torch.equal(y, again)


@pytest.mark.cuda
def test_bsr_spmm_unaligned_and_large_blocks(card):
    """Shapes the ring kernel does not take go to the generic kernel and
    agree with the plain version: an operator whose blocks start 8 bytes off
    a 16-byte boundary, and a block of 192 (its ring would not fit in
    shared memory)."""
    bsr, rng = _banded_bsr(card, 32, 8, torch.complex64, 5)
    buf = torch.empty(bsr.data.numel() + 1, dtype=torch.complex64,
                      device=card)
    buf[1:] = bsr.data.reshape(-1)
    shifted = sparse.BSROperator(
        data=buf[1:].view(bsr.data.shape), col_idx=bsr.col_idx,
        row_of=bsr.row_of, row_ptr=bsr.row_ptr, n=bsr.n, block=bsr.block)
    big, _ = _banded_bsr(card, 192, 8, torch.complex64, 6)
    for op in (shifted, big):
        x = torch.as_tensor(rng.normal(size=(op.n, 16))
                            + 1j * rng.normal(size=(op.n, 16)),
                            dtype=torch.complex64, device=card)
        y = sparse.bsr_matvec(op, x)
        ref = sparse.bsr_matvec_ref(op, x)
        torch.cuda.synchronize()
        assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
def test_device_loop_matches_host_tok128(card):
    """eigen.solve at tok128 float32 on the card: loop="device" (the
    default there) returns the host loop's omega, step count and vector,
    with one blocking host read a solve against one a step and one."""
    p = et.from_config(_cfg("tokamak", 128), dtype=torch.float32, device=card)
    out, reads = {}, {}
    for loop in ("host", "device", None):
        eigen.HOST_READS.update(blocking=0, flag_polls=0)
        out[loop] = eigen.solve(p, -0.8 + 0.25j, tol=1e-5, loop=loop)
        reads[loop] = dict(eigen.HOST_READS)
    assert eigen.LAST_SOLVE["loop"] == "device"
    om_h, vec_h, n_h, st_h = out["host"]
    for loop in ("device", None):
        om_d, vec_d, n_d, st_d = out[loop]
        assert n_d == n_h
        assert abs(om_d - om_h) / abs(om_h) < 1e-6
        corr = torch.vdot(vec_h, vec_d).abs() / (
            torch.linalg.vector_norm(vec_h) * torch.linalg.vector_norm(vec_d))
        assert float(corr) > 1 - 1e-5
        assert reads[loop]["blocking"] == 1
    assert reads["host"]["blocking"] == n_h + 1
    # QRSecant's default stays the host loop: a masked step is a whole sweep
    eigen.solve(p, -0.8 + 0.25j, tol=1e-5, method="QRSecant")
    assert eigen.LAST_SOLVE["loop"] == "host"
    assert abs(om_h - GOLDEN_TOK128) / abs(GOLDEN_TOK128) < 1e-5


@pytest.mark.cuda
def test_device_loop_host_reads_are_spans(card):
    """Under a profiler, the device loop at tok128 on the card opens one
    ``layer.host_read`` for each flag poll (its event's synchronize), each
    blocking read, and the read of the grid length."""
    from torch.profiler import ProfilerActivity, profile
    p = et.from_config(_cfg("tokamak", 128), dtype=torch.float32, device=card)
    eigen.solve(p, -0.8 + 0.25j, tol=1e-5, loop="device")   # warm-up
    eigen.HOST_READS.update(blocking=0, flag_polls=0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eigen.solve(p, -0.8 + 0.25j, tol=1e-5, loop="device")
    reads = sum(1 for e in prof.profiler.kineto_results.events()
                if e.name() == "layer.host_read")
    assert eigen.HOST_READS["flag_polls"] >= 1
    assert reads == eigen.HOST_READS["blocking"] \
        + eigen.HOST_READS["flag_polls"] + 1


@pytest.mark.cuda
def test_bsr_spmv_rejects_bad_input(card):
    """The wrapper raises on a non-contiguous x or a dtype mismatch; it
    never falls back to the plain version."""
    M = np.eye(64, dtype=np.complex64)
    bsr = sparse.bsr_from_dense(M, block=16, device=card)
    x = torch.ones((64, 2), dtype=torch.complex64, device=card)
    before = cuda_spmv.LAUNCHES
    with pytest.raises(ValueError):
        sparse.bsr_matvec(bsr, x.t().contiguous().t())
    with pytest.raises(ValueError):
        sparse.bsr_matvec(bsr, x.to(torch.complex128))
    assert cuda_spmv.LAUNCHES == before


@pytest.mark.cuda
def test_banded_solve_f32_tok128_through_kernels(card):
    """The banded slice at n=128 on the card (m_krylov 8, spmv bsr): K5
    carries the Arnoldi stage's 8 matvecs and nothing else, K1 every assembly's kernel-table chunks, and omega lands within 1e-5 of
    golden tok128."""
    p = et.from_config(_cfg("tokamak", 128), dtype=torch.float32, device=card)
    k1, k5 = cuda_kappa.LAUNCHES, cuda_spmv.LAUNCHES
    stats = {}
    om, vec, n_steps, state = sparse_eigen.solve(
        p, -0.8 + 0.25j, tol=1e-5, m_krylov=8, spmv="bsr", stats=stats)
    assert cuda_spmv.LAUNCHES - k5 == 8
    grid = Grid.create(p.length, 128, dtype=torch.float32, device=card)
    h, bs = stats["h"], stats["block"]
    dx = 2.0 * float(p.length) / 127
    chunks = sum(1 for _ in sparse_eigen.table_pair_chunks(
        grid, min((h + 1) * bs - 1, 127), None,
        kernels.tier_thresholds_ij(dx, 128), sparse_eigen.FUSED_CHUNK))
    assert cuda_kappa.LAUNCHES - k1 == chunks * (4 + n_steps)
    assert stats["spmv_route"] == "bsr" and state.M.data.is_cuda
    assert vec.is_cuda and bool(torch.isfinite(vec).all())
    assert abs(om - GOLDEN_TOK128) / abs(GOLDEN_TOK128) < 1e-5


def _driver_result(cfg, out_dir, device, **kw):
    out = driver.run(cfg, output_dir=out_dir, device=device,
                     dtype=torch.float32, verbose=False, **kw)
    return out["result"]["(None)"]["scan_result"][0]


@pytest.mark.cuda
def test_driver_eigen_tok128_through_k1(card, tmp_path):
    """driver.run on tokamak npoints 128 in float32: on the card every
    assembly goes through K1 and the guard runs there; omega within 1e-5 of
    golden tok128 and of the same call on CPU tensors (K1's plain version),
    the same steps, the two dumps within 1e-5 of scale."""
    cfg = _cfg("tokamak", 128)
    before = cuda_kappa.LAUNCHES
    on_card = _driver_result(cfg, tmp_path / "card", None, chunk=16384)
    launched = cuda_kappa.LAUNCHES - before
    on_cpu = _driver_result(cfg, tmp_path / "cpu", "cpu", chunk=16384)
    assert launched > 0 and cuda_kappa.LAUNCHES - before == launched
    om, om_c = (complex(*r["eigenvalue"]) for r in (on_card, on_cpu))
    assert abs(om - GOLDEN_TOK128) / abs(GOLDEN_TOK128) < 1e-5
    assert abs(om - om_c) / abs(om_c) < 1e-5
    assert on_card["iteration_steps"] == on_cpu["iteration_steps"]
    assert on_card["quadrature_guard"]["n_sampled"] \
        == on_cpu["quadrature_guard"]["n_sampled"] == 4096
    assert abs(on_card["quadrature_guard"]["frac_flagged"]
               - on_cpu["quadrature_guard"]["frac_flagged"]) <= 0.01
    dumps = [np.fromfile(tmp_path / d / "eigenMatrics" / "eigenMatrix.bin",
                         dtype=np.complex128) for d in ("card", "cpu")]
    assert dumps[0].shape == (128 * 128,)
    assert np.abs(dumps[0] - dumps[1]).max() <= 1e-5 * np.abs(dumps[1]).max()


@pytest.mark.cuda
@pytest.mark.parametrize("launch,counts", [
    ("single", {"pic_mega": 1, "pic_stage": 0, "pic_field": 0}),
    ("stages", {"pic_mega": 0, "pic_stage": 12, "pic_field": 12})])
def test_driver_pic_fused_routes(card, tmp_path, monkeypatch, launch, counts):
    """driver.run with pic_backend 'fused' at npoints 128 (8 markers a
    cell, 4 steps): pic_launch 'single' is one launch of K3, 'stages' 3 x 4
    of K2; the final field within 2e-5 of scale of the same call on CPU
    tensors (the kernels' plain versions) from the same markers."""
    cfg = dict(_cfg("tokamak", 128), method="PIC", marker_per_cell=8,
               step_number=4, time_step=0.25, stream_fields=False,
               pic_backend="fused", pic_launch=launch)
    p = et.from_config(cfg, dtype=torch.float32, device="cpu")
    s0 = pic.init_state(p, 8, torch.Generator().manual_seed(0),
                        dtype=torch.float32)

    def same_markers(p, mpc, generator=None, state=None):
        return pic.PICState(**{k: getattr(s0, k).to(p.device)
                               for k in s0.__dataclass_fields__})

    monkeypatch.setattr(pic, "initial_state", same_markers)
    before = dict(cuda_pic.LAUNCHES)
    on_card = _driver_result(cfg, tmp_path / "card", None)
    got = {k: cuda_pic.LAUNCHES[k] - before[k] for k in counts}
    assert got == counts and cuda_pic.LAST_LAUNCH == launch
    on_cpu = _driver_result(cfg, tmp_path / "cpu", "cpu")
    assert {k: cuda_pic.LAUNCHES[k] - before[k] for k in counts} == counts
    fa, fb = (np.asarray(r["eigenvector"]) for r in (on_card, on_cpu))
    assert fa.shape == (128, 2) and np.isfinite(fa).all()
    assert np.abs(fa - fb).max() <= 2e-5 * np.abs(fb).max()
    assert np.isfinite(on_card["eigenvalue"]).all()


@pytest.mark.cuda
def test_driver_sparse_tok128_through_k5(card, tmp_path):
    """driver.run with eigen_backend 'sparse', m_krylov 8 and spmv_method
    'bsr' at tok128 float32: K5 carries the Arnoldi stage's 8 matvecs, K1
    the kernel tables; omega within 1e-5 of
    golden tok128 and of the same call on CPU tensors; the banded dump
    reads back."""
    cfg = dict(_cfg("tokamak", 128), eigen_backend="sparse", m_krylov=8,
               spmv_method="bsr", iteration_precision=1e-5)
    k1, k5 = cuda_kappa.LAUNCHES, cuda_spmv.LAUNCHES
    on_card = _driver_result(cfg, tmp_path / "card", None)
    assert cuda_spmv.LAUNCHES - k5 == 8
    assert cuda_kappa.LAUNCHES > k1
    k1, k5 = cuda_kappa.LAUNCHES, cuda_spmv.LAUNCHES
    on_cpu = _driver_result(cfg, tmp_path / "cpu", "cpu")
    assert (cuda_kappa.LAUNCHES, cuda_spmv.LAUNCHES) == (k1, k5)
    om, om_c = (complex(*r["eigenvalue"]) for r in (on_card, on_cpu))
    assert abs(om - GOLDEN_TOK128) / abs(GOLDEN_TOK128) < 1e-5
    assert abs(om - om_c) / abs(om_c) < 1e-5
    assert on_card["sparse_stats"]["spmv_route"] == "bsr"
    assert on_card["sparse_stats"]["nnz"] == on_cpu["sparse_stats"]["nnz"]
    op = sparse.load_bdia_dump(tmp_path / "card" / "eigenMatrics"
                               / "eigenMatrix.bin")
    assert op.data.is_cuda and op.n == 128
    assert op.nnz == on_card["sparse_stats"]["nnz"]


@pytest.mark.cuda
def test_k1_window_matches_plain(card):
    """K1 at the window shape of a 4-row layout (tok256 float32, tiered,
    band_deta 10): on each window's first 2^15 table pairs (the near tier,
    where the plain float32 version is the less accurate side) K1 within
    5e-7 max(scale, 1) of the plain math in float64 on the same inputs, or
    no further from it than the plain float32 version (chip_smoke.py phase
    13's rule); each window, one K1 launch a table chunk, within 1e-6 of
    scale of the same block rows of the single-device assemble_bdia
    through K1."""
    n, S = 256, 4
    p = et.from_config(_cfg("tokamak", n), dtype=torch.float32, device=card)
    grid = Grid.create(p.length, n, dtype=torch.float32, device=card)
    bs = sparse_eigen.pick_block(n // S)
    h = sparse_eigen.band_halfwidth(p, grid, bs, 10.0)
    de_max = (h + 1) * bs - 1
    cb = singularity.singularity_coeff_band(n, de_max, dtype=torch.float32,
                                            device=card)
    tiers = kernels.tier_thresholds_ij(2.0 * float(p.length) / (n - 1), n)
    om = torch.tensor(-0.8 + 0.25j, dtype=torch.complex64, device=card)
    whole = sparse_eigen.assemble_bdia(p, grid, cb, om, h, bs, tiers=tiers,
                                       fused=True).data
    nbl = (n // bs) // S
    scale = float(whole.abs().max())
    for s in range(S):
        i0, ncols = s * nbl * bs - de_max, nbl * bs + de_max
        lo, hi, q = sparse_eigen.table_sections(None, torch.float32, de_max,
                                                tiers)[0]
        ea, eb = sparse_eigen.table_pairs(grid, lo, 0, min(1 << 15, (
            hi - lo + 1) * ncols), i0, ncols)
        mid, halfw, pair, scal, order = cuda_kappa._prepare(p, ea, eb, om, q)
        got = cuda_kappa.kappa_pairs_fused(p, ea, eb, om, ms=(0,), quad=q)[0]
        plain = cuda_kappa.kappa_pairs_ref(p, ea, eb, om, ms=(0,), quad=q)[0]
        exact = cuda_kappa._finish(p, cuda_kappa._plain(
            mid.double(), halfw.double(), pair.double(), scal.double(),
            order, (0,)), (0,))[0]
        bar = max(5e-7 * max(float(exact.abs().max()), 1.0),
                  float((plain - exact).abs().max()))
        assert float((got - exact).abs().max()) <= bar
        chunks = sum(1 for _ in sparse_eigen.table_pair_chunks(
            grid, de_max, None, tiers, sparse_eigen.FUSED_CHUNK, i0, ncols))
        before = cuda_kappa.LAUNCHES
        win = sparse_eigen.assemble_bdia_window(p, grid, cb, om, h, bs,
                                                s * nbl, nbl, tiers=tiers,
                                                fused=True)
        torch.cuda.synchronize()
        assert cuda_kappa.LAUNCHES == before + chunks
        assert win.is_cuda and bool(torch.isfinite(win).all())
        rows = whole[:, s * nbl:(s + 1) * nbl]
        assert float((win - rows).abs().max()) <= 1e-6 * scale


@pytest.mark.cuda
def test_one_rank_nccl_mesh_solve_equals_single_device(card):
    """spike.solve over a one-rank NCCL mesh (a spawned rank on card 0)
    walks the single-device banded float32 solve: the same steps, omega
    within 1e-6, the same null vector, K1 launched in the rank."""
    import torch_mesh_worker as worker
    cfg = _cfg("tokamak", 128)
    kw = dict(tol=1e-5, band_deta=10.0)
    got = mesh_mod.launch(worker.spike_solve_card, 1, "cuda", deadline=300,
                          args=(cfg, 128, kw))[0]
    p = et.from_config(cfg, dtype=torch.float32, device=card)
    om, vec, steps, _ = sparse_eigen.solve(p, -0.8 + 0.25j, **kw)
    assert got["device"].startswith("cuda")
    assert got["steps"] == steps
    assert abs(got["omega"] - om) <= 1e-6 * abs(om)
    v, w = got["vec"].to(torch.complex128), vec.cpu().to(torch.complex128)
    corr = float(torch.vdot(v, w).abs() / (v.norm() * w.norm()))
    assert corr > 1 - 1e-5
    assert got["k1_launches"] > 0


def _adaptive_inputs(name, n, card):
    """Every (pair, moment) integral of the engine's n-point assembly on the
    card: pair rows, moments, scalars."""
    om = -0.8 + 0.25j if name == "tokamak" else -1.656 + 2.49j
    p = et.from_config(_cfg(name, n), device=card)
    iu, ju = torch.triu_indices(n, n, 1, device=card)
    rows, m, _, ph = native.pair_integrals(p, iu, ju)
    return rows, m, adaptive.scalars(ph, om)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tokamak", "stellarator"])
def test_adaptive_kernel_matches_plain(card, name):
    """N1 against its plain version on every integral of the 128-point
    assembly (tokamak m = 0, G7K15; stellarator m = 0, 1, 2, G15K31): on the
    card both call the same libdevice functions and N1 is built without
    contraction, so no integral splits differently or takes other Miller
    steps, and the values agree within 1e-12 of the largest; one launch."""
    rows, m, sc = _adaptive_inputs(name, 128, card)
    before = cuda_adaptive.LAUNCHES
    got, panels, miller = cuda_adaptive.integrate(rows, m, sc)
    torch.cuda.synchronize()
    assert cuda_adaptive.LAUNCHES == before + 1
    ref, rpanels, rmiller = adaptive.integrate_ref(rows, m, sc)
    assert got.is_cuda and bool(torch.isfinite(got).all())
    flips = int((panels != rpanels).sum())
    print(f"{name}128: {flips} of {m.numel()} integrals split differently")
    assert flips == 0 and bool((miller == rmiller).all())
    assert bool((panels >= 1).all()) and bool((miller > 0).all())
    d = torch.linalg.vector_norm(got - ref, dim=1)
    assert float(d.max()) < 1e-12 * float(ref.abs().max())


def _n1_holds_to_plain(rows, m, sc):
    """N1 in one launch against its plain version: no integral split
    differently or with other Miller steps, values within 1e-12 of the
    largest; returns the panel counts."""
    before = cuda_adaptive.LAUNCHES
    got, panels, miller = cuda_adaptive.integrate(rows, m, sc)
    torch.cuda.synchronize()
    assert cuda_adaptive.LAUNCHES == before + 1
    assert cuda_adaptive.LAST_LAUNCH["slots"] == (1 if sc.order == 31 else 2)
    ref, rpanels, rmiller = adaptive.integrate_ref(rows, m, sc)
    assert got.is_cuda and bool(torch.isfinite(got).all())
    assert int((panels != rpanels).sum()) == 0
    assert bool((miller == rmiller).all())
    d = torch.linalg.vector_norm(got - ref, dim=1)
    assert float(d.max()) <= 1e-12 * float(ref.abs().max())
    return panels


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tok_odd", "stel_odd", "one", "mixed",
                                  "deep700", "real_axis", "tiny_ratio"])
def test_adaptive_slots_match_plain(card, case):
    """N1's slots (two G7K15 integrals a warp, one G15K31) and its work
    counter: an odd integral count (a slot empty at the end), n = 1, a batch
    whose panel counts range widely (mixed d_eta: slots refill at different
    times), and max_subdivide 700 (its stacks past 48 KB of shared memory a
    block), each against the plain version in one launch.  And the Miller
    recurrence's dividing instance, which no assembly takes: beta1 = 0
    (lambda = 1, so every Bessel argument is real and its ratio 0) and
    beta1 = 1e-310 (|Im z| under 1e-307, so |ratio| is under 2^-250 and
    2k ratio / den reaches the subnormal range)."""
    name = "stellarator" if case == "stel_odd" else "tokamak"
    rows, m, sc = _adaptive_inputs(name, 128, card)
    if case in ("tok_odd", "stel_odd"):
        rows, m = rows[:2 * 4001 + 1], m[:2 * 4001 + 1]
    elif case == "one":
        rows, m = rows[5:6], m[5:6]
    elif case in ("real_axis", "tiny_ratio"):
        rows, m = rows[:2001].clone(), m[:2001]
        rows[:, 1] = 0.0 if case == "real_axis" else 1e-310
    else:
        p = et.from_config(_cfg("tokamak", 128), device=card)
        ph = adaptive.phys_from_params(p)
        g = torch.Generator().manual_seed(5)
        k = 512 if case == "mixed" else 64
        # eta in [-L, 0], d_eta from 1e-4 (39 panels) to 40 (1 panel)
        eta = -float(p.length) * torch.rand(k, generator=g,
                                            dtype=torch.float64)
        d_eta = 10.0 ** (torch.rand(k, generator=g, dtype=torch.float64)
                         * 5.6 - 4.0)
        rows = adaptive.pair_rows(ph, eta.to(card), (eta + d_eta).to(card))
        m = torch.zeros(k, dtype=torch.int32, device=card)
        if case == "deep700":
            sc = adaptive.Scalars(**{**sc.__dict__, "max_subdivide": 700})
    panels = _n1_holds_to_plain(rows, m, sc)
    assert int(panels.numel()) == rows.shape[0]
    if case == "mixed":
        assert int(panels.max()) >= 10 * int(panels.min())


@pytest.mark.cuda
def test_native_solve_tok32_on_card(card):
    """The reference-exact solve on the card: M complex128 on the card,
    every assembly one N1 launch, within 1e-9 of golden tok32 in 6 steps,
    and the first operator within tests/test_native.py's bars of the
    reference's matrix_tok32_guess."""
    goldens_dir = INPUTS.parent
    with open(goldens_dir / "eigenvalues.json") as f:
        gold = json.load(f)["tok32"]
    p = et.from_config(_cfg("tokamak", 32))
    assert p.device.type == "cuda"
    coeff = singularity.singularity_coeff_matrix(32)
    M0 = native.assemble(p, coeff, -0.8 + 0.25j)
    ref = np.fromfile(goldens_dir / "matrix_tok32_guess.bin",
                      dtype=np.complex128).reshape(32, 32)
    d = np.abs(M0.cpu().numpy() - ref)
    assert d.max() < 5e-9 and np.median(d) < 1e-11
    before = cuda_adaptive.LAUNCHES
    om, vec, steps, M = eigen_native.solve(p, -0.8 + 0.25j, tol=1e-6)
    assert cuda_adaptive.LAUNCHES - before == 2 + steps
    assert M.is_cuda and M.dtype == torch.complex128 and vec.is_cuda
    ref_om = complex(*gold["omega"])
    assert abs(om - ref_om) / abs(ref_om) < 1e-9
    assert steps == gold["steps"]


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["TraceSecant", "QRSecant"])
def test_exact_backend_tok128_on_card(card, method, monkeypatch):
    """The driver's exact backend on the card at tok128: every assembly
    one N1 launch, the golden tok128 omega at the engine's 1e-9, the null
    vector (one LU and inverse iteration on M^H M, counted once) within
    1e-11 up to a phase of the right singular vector of the card's SVD of
    the final M, and the eigenpair judged on 16 seeded rows of the
    benchmark's plain adaptive reference, computed on the card: the
    backward error and the omega shift the rows ask for at the float64
    floor of the Newton loop's last step (1e-14 on the CPU)."""
    from portbench.reference import adaptive as ref
    cfg = dict(_cfg("tokamak", 128), eigen_backend="exact",
               iteration_method=method)
    seen = []
    nsv = linalg.null_space_vector

    def recorded(M, method=None):
        v = nsv(M, method)
        seen.append((method, M, v))
        return v
    monkeypatch.setattr(linalg, "null_space_vector", recorded)
    before = cuda_adaptive.LAUNCHES
    routes = dict(linalg.NULL_VECTOR_ROUTE)
    res, om = driver.solve_once_eigen(cfg, -0.8 + 0.25j,
                                      dtype=torch.float64)
    steps = res["iteration_steps"]
    assert cuda_adaptive.LAUNCHES - before == 2 + steps
    assert linalg.NULL_VECTOR_ROUTE == dict(
        routes, singular=routes["singular"] + 1)
    (route, M, vec), = seen
    assert route == "singular" and M.is_cuda and vec.is_cuda
    ref_vec = torch.linalg.svd(M)[2][-1].conj()
    c = torch.vdot(ref_vec, vec)
    assert float(torch.linalg.vector_norm(vec - c / c.abs() * ref_vec)) \
        <= 1e-11
    assert abs(om - GOLDEN_TOK128) / abs(GOLDEN_TOK128) < 1e-9
    assert res["quadrature_guard"]["run"] is False
    v = np.array(res["eigenvector"])
    rows = np.random.default_rng(128).choice(128, 16, replace=False)
    got = ref.row_check(cfg, om, v[:, 0] + 1j * v[:, 1], rows, device=card)
    assert got["residual"] < 1e-10 and got["omega_gap"] < 1e-9, got


@pytest.mark.cuda
def test_exact_backend_stel128_on_card(card):
    """The driver's exact backend on the card at stel128 (electromagnetic,
    G15K31, three moments, a 256 x 256 operator): the golden stel128 omega
    at the engine's 1e-9, a 2N eigenvector, and the eigenpair judged on 16
    seeded rows of the plain adaptive electromagnetic reference computed on
    the card, 8 of the phi block and 8 of the A_par block: the backward
    error and the omega shift the rows ask for at the float64 floor of the
    Newton loop's last step."""
    from portbench.reference import adaptive_em as ref
    cfg = dict(_cfg("stellarator", 128), eigen_backend="exact")
    res, om = driver.solve_once_eigen(cfg, complex(*cfg["initial_guess"]),
                                      dtype=torch.float64)
    gold = complex(-0.8555738574280805, -0.3201251291856798)
    assert abs(om - gold) / abs(gold) < 1e-9
    v = np.array(res["eigenvector"])
    assert v.shape == (256, 2)
    rng = np.random.default_rng(128)
    rows = np.concatenate([rng.choice(128, 8, replace=False),
                           128 + rng.choice(128, 8, replace=False)])
    got = ref.row_check(cfg, om, v[:, 0] + 1j * v[:, 1], rows, device=card)
    assert got["residual"] < 1e-10 and got["omega_gap"] < 1e-9, got


@pytest.mark.cuda
def test_adaptive_kernel_refuses_a_deep_stack(card):
    """A depth limit past the shared-memory stack raises; nothing launches
    and nothing falls back."""
    rows, m, sc = _adaptive_inputs("tokamak", 8, card)
    deep = adaptive.Scalars(**{**sc.__dict__, "max_subdivide": 10000})
    before = cuda_adaptive.LAUNCHES
    with pytest.raises(ValueError):
        cuda_adaptive.integrate(rows, m, deep)
    assert cuda_adaptive.LAUNCHES == before


def _bits(t):
    return t.contiguous().view(torch.int64)


def _memo_holds_to_plain(rows, m, sc, memo):
    """One launch with the memo against a memo-free one at the same
    scalars: values bit for bit (signs of zero included) and panel counts
    equal; Miller steps equal where the launch ran every recurrence
    (plain, fill), fewer where it read; a memo launch's node counts add up
    to its panels' nodes.  Returns the launch's route and [nodes memoised,
    nodes in full] (None for a plain launch)."""
    ref, rpanels, rmiller = cuda_adaptive.integrate(rows, m, sc)
    stats_before = len(memo.stats)
    got, panels, miller = cuda_adaptive.integrate(rows, m, sc, memo=memo)
    assert torch.equal(_bits(got), _bits(ref))
    assert torch.equal(panels, rpanels)
    nodes = 2 * len(adaptive.gk_rule(sc.order)[0]) - 1
    if memo.last in ("fill", "read"):
        assert len(memo.stats) == stats_before + 1
        stats = memo.stats[-1].tolist()
        assert sum(stats) == int(panels.sum()) * nodes
    else:
        assert len(memo.stats) == stats_before
        stats = None
    if memo.last == "read":
        assert bool((miller <= rmiller).all())
        assert int(miller.sum()) < int(rmiller.sum()) or stats[0] == 0
    else:
        assert torch.equal(miller, rmiller)
    return memo.last, stats


@pytest.mark.cuda
@pytest.mark.parametrize("name,n", [("tokamak", 128), ("tokamak", 1024),
                                    ("stellarator", 128),
                                    ("stellarator", 1024)])
def test_adaptive_memo_along_a_solve_is_bit_equal(card, name, n):
    """N1's memo along a solve's omega sequence (0.99 omega_init, omega_init,
    then each step's omega): the first launch plain, the second filling,
    the later reading, each bit for bit the memo-free launch in values and
    panel counts.  The solve itself fills its plan's memo once and reads it
    at each step (``native.ASSEMBLY_ROUTE``).  At npoints 1024 the reads
    take 95 % of their nodes or more from the memo.  (The stellarator at
    npoints 128 walks from the file's guess to another root in some 24
    steps, so its trees move and many nodes miss.)"""
    p = et.from_config(_cfg(name, n), device=card)
    om0 = -0.8 + 0.25j if name == "tokamak" else -1.656 + 2.49j
    seq = [0.99 * om0, om0]
    route = dict(native.ASSEMBLY_ROUTE)
    _om, _vec, steps, _M = eigen_native.solve(
        p, om0, tol=1e-6, callback=lambda j, w, d: seq.append(w))
    assert native.ASSEMBLY_ROUTE == dict(
        route, plans=route["plans"] + 1,
        planned=route["planned"] + 2 + steps,
        memo_fills=route["memo_fills"] + 1,
        memo_reads=route["memo_reads"] + steps)
    iu, ju = torch.triu_indices(n, n, 1, device=card)
    rows, m, _, ph = native.pair_integrals(p, iu, ju)
    memo = cuda_adaptive.Memo()
    routes, hits = [], []
    for w in seq:
        r, stats = _memo_holds_to_plain(rows, m, adaptive.scalars(ph, w), memo)
        routes.append(r)
        if r == "read":
            hits.append(stats[0] / sum(stats))
    assert routes == ["first", "fill"] + ["read"] * steps
    assert memo.n == rows.shape[0] and memo.bytes > 0
    print(f"{name}{n}: {steps} steps, hit shares {hits}, "
          f"{memo.bytes / 1e9:.3f} GB")
    if n == 1024:
        assert min(hits) >= 0.95


def _at(sc, omega):
    """The scalars ``sc`` at another omega."""
    return adaptive.Scalars(**{**sc.__dict__, "om_r": omega.real,
                               "om_i": omega.imag})


@pytest.mark.cuda
def test_adaptive_memo_misses_stay_bit_equal(card):
    """Reads at an omega far from the fill's (the same sign of Re omega):
    the trees move, so nodes miss and are evaluated in full, and every
    value and panel count stays the memo-free launch's."""
    rows, m, sc = _adaptive_inputs("tokamak", 128, card)
    om = complex(sc.om_r, sc.om_i)
    memo = cuda_adaptive.Memo()
    for w in (0.99 * om, om):
        _memo_holds_to_plain(rows, m, _at(sc, w), memo)
    route, stats = _memo_holds_to_plain(rows, m, _at(sc, -0.3 + 0.6j), memo)
    assert route == "read" and stats[0] > 0 and stats[1] > 0
    print(f"tok128 at -0.3+0.6j: {stats[1] / sum(stats):.4f} of nodes missed")


@pytest.mark.cuda
def test_adaptive_memo_sign_flip_runs_plain(card):
    """A launch whose sign(Re omega) is not the first's runs plain (no memo
    launch, no node counts) and equals the memo-free launch; a later launch
    of the first sign reads again; a second launch of the other sign makes
    no memo for the solve."""
    rows, m, sc = _adaptive_inputs("tokamak", 128, card)
    om = complex(sc.om_r, sc.om_i)
    memo = cuda_adaptive.Memo()
    got = [_memo_holds_to_plain(rows, m, _at(sc, w), memo)[0]
           for w in (0.99 * om, om, -om.conjugate(), 1.01 * om)]
    assert got == ["first", "fill", "plain", "read"]
    memo = cuda_adaptive.Memo()
    got = [_memo_holds_to_plain(rows, m, _at(sc, w), memo)[0]
           for w in (0.99 * om, -om.conjugate(), om)]
    assert got == ["first", "plain", "plain"] and memo.n == 0


@pytest.mark.cuda
def test_adaptive_memo_small_share_memoises_a_prefix(card, monkeypatch):
    """A memory share that holds about half the places memoises a prefix of
    the integrals (the others run in full at every launch) and stays bit
    for bit the memo-free launch."""
    rows, m, sc = _adaptive_inputs("stellarator", 128, card)
    _v, panels, _mi = cuda_adaptive.integrate(rows, m, sc)
    need = int(panels.sum()) * cuda_adaptive.panel_bytes(sc.order)
    free, _total = torch.cuda.mem_get_info(card)
    free += torch.cuda.memory_reserved(card) - \
        torch.cuda.memory_allocated(card)
    monkeypatch.setattr(cuda_adaptive, "MEMO_SHARE",
                        0.5 * need * cuda_adaptive.MEMO_GROWTH / free)
    om = complex(sc.om_r, sc.om_i)
    memo = cuda_adaptive.Memo()
    got = [_memo_holds_to_plain(rows, m, _at(sc, w), memo)
           for w in (0.99 * om, om, om * (1 + 1e-3j), om * 1.001)]
    assert [r for r, _ in got] == ["first", "fill", "read", "read"]
    assert 0 < memo.n < rows.shape[0]
    assert got[-1][1][1] > 0
    print(f"stel128: {memo.n} of {rows.shape[0]} integrals memoised")


def _program_spans(fn):
    """[(name, start, end)] of the program's spans while ``fn()`` runs
    under a host profiler.  The tests that take it come last in this
    file, after every test that counts device events under a profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("layer.")]


@pytest.mark.cuda
def test_plans_open_their_span_once_a_solve_and_once_a_shift(card):
    """On the kernels' route ``eigen.assembly_plan`` opens
    ``layer.assembly.plan`` once a dense solve, inside its
    ``layer.solve.setup``, and once a shift of a survey, inside
    ``layer.survey.secant``."""
    p = et.from_config(_cfg("tokamak", 128), dtype=torch.float32, device=card)
    sigmas = -0.8 + 0.25j + 0.15 * np.array([0.3 - 0.2j, -0.5 + 0.9j,
                                             1.1 + 0.1j, -0.2 - 1.3j])
    eigen.solve(p, -0.8 + 0.25j, tol=1e-5)   # warm-up
    for fn, outer, plans in (
            (lambda: eigen.solve(p, -0.8 + 0.25j, tol=1e-5),
             "layer.solve.setup", 1),
            (lambda: arnoldi.solve_shifts_batched(p, sigmas, m_krylov=24),
             "layer.survey.secant", len(sigmas))):
        spans = _program_spans(fn)
        (o0, o1), = [(a, b) for n, a, b in spans if n == outer]
        got = [(a, b) for n, a, b in spans if n == "layer.assembly.plan"]
        assert len(got) == plans
        assert all(o0 <= a and b <= o1 for a, b in got)


@pytest.mark.cuda
def test_pic_request_reads_are_spans_on_the_card(card):
    """A PIC request on the card (``state_from_draws`` -> ``cuda_pic.run``
    through K3 -> ``calculate_omega``) opens nine ``layer.host_read``, as
    on the CPU (``tests/test_torch_trace.py``): eight of p's scalars in
    ``FusedStep.params_vec`` and the statistics' copy in the fit."""
    p = et.from_config(_cfg("tokamak", 128), dtype=torch.float32, device=card)
    gen = torch.Generator(device=card).manual_seed(1)
    kw = dict(generator=gen, device=card)
    n = 8 * 128
    draws = (torch.rand(n, **kw) * 2.0 * p.length - p.length,
             torch.randn(n, **kw), torch.randn(n, **kw),
             torch.rand(n, **kw) * 0.001)

    def request():
        state = pic.state_from_draws(p, *draws, dtype=torch.float32)
        stats, _, _ = cuda_pic.run(p, 8, 4, 0.25, state=state)
        return pic.calculate_omega(stats, 0.25)

    request()   # the K4 self-check, once a process
    spans = _program_spans(request)
    assert cuda_pic.LAST_LAUNCH == "single"
    assert sum(1 for n, _, _ in spans if n == "layer.host_read") == 9
