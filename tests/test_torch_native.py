"""emme_tpu_torch's reference-exact float64 engine (``native``,
``ops/adaptive``, ``solvers/eigen_native``) on the CPU, where it runs the
plain version of kernel N1, against the reference's goldens and against
``emme_tpu.native`` (the C++ engine it ports).

Every live call into ``emme_tpu.native`` goes through the ``engine``
fixture, which builds a private copy of ``native/`` in a temporary
directory, so no test here writes ``native/libemme_native.so``.
"""
import dataclasses
import hashlib
import json
import shutil

import numpy as np
import pytest
import scipy.special as sp
import torch

import emme_tpu
import emme_tpu.native
import emme_tpu_torch as et
from emme_tpu_torch import native
from emme_tpu_torch.ops import adaptive, cuda_adaptive, linalg
from emme_tpu_torch.ops.singularity import singularity_coeff_matrix
from emme_tpu_torch.solvers import eigen_native

torch.set_num_threads(2)

GEOMETRIES = ["tokamak", "stellarator", "cylinder", "cylinder_old",
              "taloyMagneticDrift"]
GUESS = -0.8 + 0.25j


def _load(goldens_dir, name):
    with open(goldens_dir / name) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    """``emme_tpu.native`` built from a private copy of ``native/``."""
    mod = emme_tpu.native
    src = mod._NATIVE_DIR
    dst = tmp_path_factory.mktemp("native")
    for name in ("emme_native.cpp", "Makefile"):
        shutil.copy2(src / name, dst / name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "_NATIVE_DIR", dst)
        mp.setattr(mod, "_LIB_PATH", dst / "libemme_native.so")
        mp.setattr(mod, "_lib", None)
        mod.load()
        yield mod


def _params(goldens_dir, name, **over):
    cfg = dict(_load(goldens_dir, f"inputs/{name}.json"), **over)
    return et.from_config(cfg, device="cpu"), emme_tpu.from_config(cfg)


@pytest.mark.parametrize("name", GEOMETRIES)
def test_g_bi_vs_micro_goldens(goldens_dir, engine, name):
    """g and b_i at 1e-14 of (1 + scale) from the C++ engine, b_i and g at
    the same bar from the reference's goldens; the cylinder's g no further
    from its golden than the engine is (both share the bisected
    cylinder_shat_coeff, 2.6e-9 from the reference's)."""
    p, pj = _params(goldens_dir, name)
    gold = _load(goldens_dir, f"micro_{name}.json")
    eta = np.array(gold["eta_samples"])
    g, bi = native.g_bi(p, eta)
    assert g.dtype == torch.float64 and g.device.type == "cpu"
    g, bi = g.numpy(), bi.numpy()
    g_ref, bi_ref = np.array(gold["g_integration_f"]), np.array(gold["bi"])
    g_eng, bi_eng = engine.g_bi(pj, eta)
    gbar = 1e-14 * (1 + np.abs(g_ref).max())
    bbar = 1e-14 * (1 + np.abs(bi_ref).max())
    assert np.abs(g - g_eng).max() <= gbar
    assert np.abs(bi - bi_eng).max() <= bbar
    assert np.abs(bi - bi_ref).max() <= bbar
    assert np.abs(g - g_ref).max() <= max(gbar,
                                          np.abs(g_eng - g_ref).max() + gbar)


def test_miller_bessel_vs_scipy(goldens_dir):
    """The engine's Miller I0/I1, brought to scipy's scaling: for Re z >= 0,
    I e^{-z} = ive e^{-i Im z}; for Re z < 0, I_n(z) = (-1)^n I_n(-z).
    1e-12 relative on the goldens' bessel_z and a seeded sample, |z| <= 50."""
    gz = np.array([complex(*z) for z in
                   _load(goldens_dir, "micro_tokamak.json")["bessel_z"]])
    rng = np.random.default_rng(12)
    r = 50.0 * np.sqrt(rng.uniform(0, 1, 400))
    th = rng.uniform(-np.pi, np.pi, 400)
    z = np.concatenate([gz, r * np.exp(1j * th)])
    zt = torch.tensor(z)
    i0r, i0i, i1r, i1i, zsr, zsi, steps = adaptive.bessel_i01(zt.real,
                                                              zt.imag)
    i0 = (i0r + 1j * i0i).numpy()
    i1 = (i1r + 1j * i1i).numpy()
    zs = (zsr + 1j * zsi).numpy()
    neg = z.real < 0
    w = np.where(neg, -z, z)
    assert np.array_equal(zs, np.where(neg, z, -z))
    phase = np.exp(-1j * w.imag)
    ref0 = sp.ive(0, w) * phase
    ref1 = np.where(neg, -1.0, 1.0) * sp.ive(1, w) * phase
    assert (np.abs(i0 - ref0) / np.abs(ref0)).max() < 1e-12
    assert (np.abs(i1 - ref1) / np.abs(ref1)).max() < 1e-12
    aw = np.abs(w)
    assert np.array_equal(steps.numpy(),
                          np.floor(aw + 9 * np.sqrt(aw)).astype(int) + 24)


def test_miller_bessel_vs_scipy_rescaled():
    """Where the recurrence passes 1e250 and rescales by 1e-250 (|I_k| grows
    as e^|Re z|): 80 seeded z with 700 <= |Re z| <= 1500, |Im z| <= 300, and
    z on the real axis at both signs, against scipy's ive at 1e-12 relative
    (scipy stays within 6e-16 of a 40-digit mpmath there)."""
    rng = np.random.default_rng(21)
    re = rng.uniform(700.0, 1500.0, 80) * rng.choice([-1.0, 1.0], 80)
    im = rng.uniform(-300.0, 300.0, 80)
    z = np.concatenate([re + 1j * im, [700.0, -900.0, 1500.0, -1500.0]])
    zt = torch.tensor(z)
    i0r, i0i, i1r, i1i, _, _, _ = adaptive.bessel_i01(zt.real, zt.imag)
    i0 = (i0r + 1j * i0i).numpy()
    i1 = (i1r + 1j * i1i).numpy()
    neg = z.real < 0
    w = np.where(neg, -z, z)
    phase = np.exp(-1j * w.imag)
    ref0 = sp.ive(0, w) * phase
    ref1 = np.where(neg, -1.0, 1.0) * sp.ive(1, w) * phase
    assert np.isfinite(i0).all() and np.isfinite(i1).all()
    assert (np.abs(i0 - ref0) / np.abs(ref0)).max() < 1e-12
    assert (np.abs(i1 - ref1) / np.abs(ref1)).max() < 1e-12


def _by_omega(cases):
    """The reference's kappa cases by omega: ((m, eta, eta', omega),
    kappa_i + kappa_e)."""
    for om in sorted({tuple(c["omega"]) for c in cases}):
        sel = [c for c in cases if tuple(c["omega"]) == om]
        yield ((np.array([c["m"] for c in sel]),
                np.array([c["eta"] for c in sel]),
                np.array([c["etap"] for c in sel]), complex(*om)),
               np.array([complex(*c["kappa_i"]) + complex(*c["kappa_e"])
                         for c in sel]))


def _rel(a, b):
    return np.abs(a - b) / (np.abs(b) + 1e-30)


@pytest.mark.parametrize("name", GEOMETRIES)
def test_kappa_batch_vs_micro_goldens(goldens_dir, engine, name):
    """kappa_i + kappa_e against the reference's kappa_cases: the tokamak at
    tests/test_native.py's bars (max relative < 1e-7, median < 1e-9), the
    other four no further than twice the C++ engine's own distance, or
    1e-9; the median distance to the engine below 1e-13 (the same
    algorithm: subdivision flips only where libm rounding differs)."""
    p, pj = _params(goldens_dir, name)
    cases = _load(goldens_dir, f"micro_{name}.json")["kappa_cases"]
    mine, eng, gold = [], [], []
    for args, ref in _by_omega(cases):
        k = native.kappa_batch(p, *args, with_electron=True)
        assert k.dtype == torch.complex128 and k.device.type == "cpu"
        mine.append(k.numpy())
        eng.append(engine.kappa_batch(pj, *args, with_electron=True))
        gold.append(ref)
    mine, eng, gold = (np.concatenate(v) for v in (mine, eng, gold))
    rels = _rel(mine, gold)
    if name == "tokamak":
        assert rels.max() < 1e-7
        assert np.median(rels) < 1e-9
    else:
        ref = _rel(eng, gold)
        assert rels.max() <= max(2 * ref.max(), 1e-9)
        assert np.median(rels) <= max(2 * np.median(ref), 1e-9)
    assert np.median(_rel(mine, eng)) < 1e-13


def test_assemble_tok32_vs_reference_matrix(goldens_dir):
    """tests/test_native.py's bars: max abs < 5e-9, median < 1e-11."""
    p, _ = _params(goldens_dir, "tokamak", npoints=32)
    coeff = singularity_coeff_matrix(32, device="cpu")
    M = native.assemble(p, coeff, GUESS)
    assert M.dtype == torch.complex128 and M.shape == (32, 32)
    ref = np.fromfile(goldens_dir / "matrix_tok32_guess.bin",
                      dtype=np.complex128).reshape(32, 32)
    d = np.abs(M.numpy() - ref)
    assert d.max() < 5e-9
    assert np.median(d) < 1e-11


def test_assemble_stel32_vs_reference_matrix(goldens_dir):
    """Electromagnetic 64 x 64 operator within 1e-10 of scale
    (tests/test_native.py)."""
    p, _ = _params(goldens_dir, "stellarator", npoints=32)
    coeff = singularity_coeff_matrix(32, device="cpu")
    M = native.assemble(p, coeff.numpy(), -1.656 + 2.49j)
    ref = np.fromfile(goldens_dir / "matrix_stel32_guess.bin",
                      dtype=np.complex128).reshape(64, 64)
    assert M.shape == (64, 64)
    assert np.abs(M.numpy() - ref).max() < 1e-10 * np.abs(ref).max()


def test_em_tokamak_n16_vs_engine(goldens_dir, engine):
    """Electromagnetic tokamak (beta_e 0.015), which no reference golden
    covers: the 32 x 32 operator within 5e-9 of scale of the C++ engine's."""
    p, pj = _params(goldens_dir, "tokamak", npoints=16, beta_e=0.015)
    assert p.electromagnetic
    coeff = singularity_coeff_matrix(16, device="cpu")
    M = native.assemble(p, coeff, GUESS).numpy()
    ref = engine.assemble(pj, coeff.numpy(), GUESS)
    assert M.shape == ref.shape == (32, 32)
    assert np.abs(M - ref).max() < 5e-9 * np.abs(ref).max()


def test_solve_tok32_vs_golden(goldens_dir, golden_eigenvalues):
    """Within 1e-9 of golden tok32 in its 6 steps, the null vector a unit
    vector of M's smallest singular value."""
    p, _ = _params(goldens_dir, "tokamak", npoints=32)
    om, vec, steps, M = eigen_native.solve(p, GUESS, tol=1e-6)
    ref = complex(*golden_eigenvalues["tok32"]["omega"])
    assert abs(om - ref) / abs(ref) < 1e-9
    assert steps == golden_eigenvalues["tok32"]["steps"]
    assert vec.shape == (32,) and M.dtype == torch.complex128
    assert abs(float(torch.linalg.vector_norm(vec)) - 1.0) < 1e-12
    smin = float(torch.linalg.svdvals(M)[-1])
    assert float(torch.linalg.vector_norm(M @ vec)) < 1e-8 + 2 * smin


@pytest.mark.parametrize("npoints", [32, 128])
def test_solve_null_vector_is_the_svds(goldens_dir, npoints):
    """The solve's null vector, one LU and inverse iteration on M^H M at
    the converged operator, is the SVD's right singular vector of the
    returned M: within 1e-12 of it up to a phase, a unit vector, ||M v|| at
    sigma_min to 1e-9 less a few ulps of ||M|| (the rounding of forming
    M v); the route counted once."""
    p, _ = _params(goldens_dir, "tokamak", npoints=npoints)
    before = dict(linalg.NULL_VECTOR_ROUTE)
    _, vec, _, M = eigen_native.solve(p, GUESS, tol=1e-6)
    assert linalg.NULL_VECTOR_ROUTE == dict(
        before, singular=before["singular"] + 1)
    _, s, vh = torch.linalg.svd(M)
    ref = vh[-1].conj()
    c = torch.vdot(ref, vec)
    assert float(torch.linalg.vector_norm(vec - c / c.abs() * ref)) <= 1e-12
    assert abs(float(torch.linalg.vector_norm(vec)) - 1.0) <= 1e-12
    eps = torch.finfo(torch.float64).eps
    assert float(torch.linalg.vector_norm(M @ vec)) \
        <= (1 + 1e-9) * float(s[-1]) + 4 * eps * float(s[0])


@pytest.mark.parametrize("method", ["TraceSecant", "QRSecant"])
def test_walk_tok32_vs_reference(goldens_dir, method):
    """The reference's per-step omega sequence at 1e-8 a step, as
    tests/test_trajectory.py holds the C++ engine."""
    p, _ = _params(goldens_dir, "tokamak", npoints=32)
    omegas = []
    eigen_native.solve(p, GUESS, tol=1e-6, method=method,
                       callback=lambda j, om, d: omegas.append(om))
    ref = [complex(a, b) for a, b in
           _load(goldens_dir, "trajectories.json")[f"tok32_{method}"]["steps"]]
    assert len(omegas) == len(ref)
    for k, (om, rf) in enumerate(zip(omegas, ref)):
        assert abs(om - rf) / abs(rf) < 1e-8, (k, om, rf)


def test_breadth_first_sum_is_depth_first_order(goldens_dir, engine):
    """Integrals that split many times (near pairs, G7K15, depth limit 100)
    come out bit for bit as the C++ engine's where no libm rounding moves a
    decision: the panel sum runs in the engine's depth-first order."""
    p, pj = _params(goldens_dir, "tokamak")
    eta = np.linspace(-2.0, 2.0, 9)
    etap = eta + 1e-3
    m = np.zeros(9, dtype=np.int32)
    ph = adaptive.phys_from_params(p)
    rows = adaptive.pair_rows(ph, torch.tensor(eta), torch.tensor(etap))
    vals, panels, miller = cuda_adaptive.integrate(
        rows, torch.tensor(m), adaptive.scalars(ph, GUESS))
    assert int(panels.min()) > 1 and bool((miller > 0).all())
    got = adaptive.ion_prefactor(ph, vals).numpy()
    ref = engine.kappa_batch(pj, m, eta, etap, GUESS)
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()


def _digest(t):
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()[:16]


# SHA-256 (first 16 hex digits) of M, N1's rows and moments at npoints 32,
# from the assembly before it took a plan
PARENT_ASSEMBLY = {
    ("tokamak", -0.8 + 0.25j): ("d3e269ddfe6d0835", "01838bcb180f5302",
                                "5b4a97decc57a483"),
    ("tokamak", -0.57 + 0.27j): ("eaaf0cc7b5052295", "01838bcb180f5302",
                                 "5b4a97decc57a483"),
    ("stellarator", -1.656 + 2.49j): ("34e32fb22bcf298f", "9669f65c65f02ff3",
                                      "a2d6fcfb8058e899"),
    ("stellarator", -1.6 + 2.5j): ("067bbd0355237ef8", "9669f65c65f02ff3",
                                   "a2d6fcfb8058e899"),
}


@pytest.mark.parametrize("name,omega", list(PARENT_ASSEMBLY))
def test_planned_assembly_is_the_unplanned(goldens_dir, monkeypatch, name,
                                           omega):
    """``native.assemble`` with a plan equals the call without one bit for
    bit: M, and N1's rows, moments and scalars; both equal the assembly's
    before the plan; the plan's parameters equal ``phys_from_params`` and a
    float() of each scalar, field by field; the routes counted."""
    p, _ = _params(goldens_dir, name, npoints=32)
    coeff = singularity_coeff_matrix(32, device="cpu")
    seen = []
    integrate = cuda_adaptive.integrate
    monkeypatch.setattr(cuda_adaptive, "integrate",
                        lambda rows, m, sc, memo=None:
                        seen.append((rows, m, sc, memo))
                        or integrate(rows, m, sc, memo))
    before = dict(native.ASSEMBLY_ROUTE)
    plan = native.assembly_plan(p, coeff)
    M_plan = native.assemble(p, coeff, omega, plan=plan)
    M_own = native.assemble(p, coeff, omega)
    assert native.ASSEMBLY_ROUTE == dict(before,
                                         plans=before["plans"] + 2,
                                         planned=before["planned"] + 1,
                                         unplanned=before["unplanned"] + 1)
    assert torch.equal(M_plan, M_own)
    (r1, m1, sc1, memo1), (r2, m2, sc2, memo2) = seen
    # N1's memo is the card's: a CPU plan has none
    assert plan.n1_memo is None and memo1 is None and memo2 is None
    assert r1 is plan.rows and torch.equal(r1, r2) and torch.equal(m1, m2)
    assert sc1 == sc2 == adaptive.scalars(plan.ph, omega)
    assert (_digest(M_plan), _digest(r1), _digest(m1)) \
        == PARENT_ASSEMBLY[(name, omega)]
    ph = adaptive.phys_from_params(p)
    for f in dataclasses.fields(adaptive.Phys):
        assert getattr(plan.ph, f.name) == getattr(ph, f.name), f.name
    for k in adaptive._PHYS_FLOATS:
        assert getattr(plan.ph, k) == float(getattr(p, k)), k
    with pytest.raises(ValueError, match="another operator"):
        native.assemble(_params(goldens_dir, name, npoints=16)[0], coeff,
                        omega, plan=plan)


def test_solve_makes_one_plan(goldens_dir):
    """``eigen_native.solve`` (tok32) makes one plan and hands it to each of
    its 2 + steps assemblies; omega, the null vector and M are the solve's
    before the plan, bit for bit."""
    p, _ = _params(goldens_dir, "tokamak", npoints=32)
    before = dict(native.ASSEMBLY_ROUTE)
    om, vec, steps, M = eigen_native.solve(p, GUESS, tol=1e-6)
    assert native.ASSEMBLY_ROUTE == dict(
        before, plans=before["plans"] + 1,
        planned=before["planned"] + 2 + steps)
    assert (om.real.hex(), om.imag.hex(), steps) == (
        "-0x1.260116889af97p-1", "0x1.18e3435f50767p-2", 6)
    assert (_digest(vec), _digest(M)) == ("c1e9793f0273f375",
                                          "9b9e5f690ba5d2b6")


def test_wrapper_checks_and_guards(goldens_dir):
    """The wrapper refuses what the kernel does not take; the plain version
    refuses an order the engine has no table for; available() is a bool."""
    p, _ = _params(goldens_dir, "tokamak")
    ph = adaptive.phys_from_params(p)
    sc = adaptive.scalars(ph, GUESS)
    rows = adaptive.pair_rows(ph, torch.tensor([0.5]), torch.tensor([0.1]))
    with pytest.raises(ValueError):
        cuda_adaptive.integrate(rows.float(), torch.zeros(1, dtype=torch.int32),
                                sc)
    with pytest.raises(ValueError):
        cuda_adaptive.integrate(rows, torch.zeros(2, dtype=torch.int32), sc)
    with pytest.raises(ValueError):
        adaptive.gk_rule(21)
    assert isinstance(native.available(), bool)
    assert cuda_adaptive.flop_count(torch.tensor([1]), torch.tensor([0]),
                                    15) == 15 * 181 + 19
