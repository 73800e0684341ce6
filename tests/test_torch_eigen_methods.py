"""The rest of emme_tpu_torch's dense solver against emme_tpu on the CPU:
the pivoted QR and the QR-secant update, the bordered update and the
inverse-iteration null vector, ``solve`` with ``method=``, ``host64=`` and
``loop=``, and the quadrature guard.  n = 32, float64 unless said; inputs
from numpy seeds and the goldens; the JAX functions run as their own tests
run them."""
import json

import numpy as np
import pytest
import scipy.linalg
import torch
import jax.numpy as jnp

import emme_tpu
from emme_tpu.grid import Grid as JGrid
from emme_tpu.ops import linalg as jlinalg
from emme_tpu.solvers import eigen as jeigen
import emme_tpu_torch as et
from emme_tpu_torch.grid import Grid
from emme_tpu_torch.ops import cuda_kappa, linalg
from emme_tpu_torch.solvers import eigen
from emme_tpu_torch.utils.timer import Timer

torch.set_num_threads(2)

GUESS = -0.8 + 0.25j
CHUNK = 64   # pairs per step of the float64 integrand (any size gives the same values)
GOLDEN_OMEGA = -0.574227 + 0.274304j   # tests/test_eigen.py:114
BAD_OMEGA = -6.0 + 0.001j              # tests/test_eigen.py:128


def _vec_corr(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))


def _rel(a, b):
    return abs(complex(a) - complex(b)) / abs(complex(b))


def _matrix(case, goldens_dir):
    if case == "seeded24":
        rng = np.random.default_rng(24)
        return rng.normal(size=(24, 24)) + 1j * rng.normal(size=(24, 24))
    return np.fromfile(goldens_dir / "matrix_tok32_guess.bin",
                       dtype=np.complex128).reshape(32, 32)


def _jax_qr(M):
    Vr, Vi, tr, ti, Rr, Ri, perm = (np.asarray(a) for a in
                                    jlinalg.qr_column_pivoted(jnp.asarray(M)))
    return Vr + 1j * Vi, tr + 1j * ti, Rr + 1j * Ri, perm


@pytest.mark.parametrize("case", ["seeded24", "tok32"])
def test_qr_column_pivoted(case, goldens_dir):
    """Same pivots as emme_tpu's sweep, R, V and tau within 1e-12 of its
    scale, M[:, perm] = Q R, and |diag R| within 1e-10 of LAPACK's pivoted
    QR (scipy.linalg.qr(pivoting=True))."""
    M = _matrix(case, goldens_dir)
    n = M.shape[0]
    V, tau, R, perm = (t.numpy() for t in
                       linalg.qr_column_pivoted(torch.as_tensor(M)))
    Vj, tj, Rj, pj = _jax_qr(M)
    scale = np.abs(M).max()
    assert perm.tolist() == pj.tolist()
    assert np.abs(np.abs(R) - np.abs(Rj)).max() <= 1e-12 * scale
    assert np.abs(R - Rj).max() <= 1e-12 * scale
    assert np.abs(V - Vj).max() <= 1e-12 and np.abs(tau - tj).max() <= 1e-12
    assert np.abs(np.tril(R, -1)).max() == 0.0
    Q = np.eye(n, dtype=complex)
    for k in range(n):
        Q = Q @ (np.eye(n) - tau[k] * np.outer(V[:, k], V[:, k].conj()))
    assert np.abs(Q @ R - M[:, perm]).max() <= 1e-12 * scale
    _, Rs, ps = scipy.linalg.qr(M, pivoting=True)
    assert perm.tolist() == ps.tolist()
    assert np.abs(np.abs(np.diag(R)) - np.abs(np.diag(Rs))).max() \
        <= 1e-10 * scale


@pytest.mark.parametrize("case", ["seeded24", "tok32"])
def test_qr_secant_delta_and_bilinear(case, goldens_dir):
    """qr_secant_delta and complex_bilinear within 1e-10 (relative) of
    emme_tpu's on the same M, dM and v."""
    M = _matrix(case, goldens_dir)
    n = M.shape[0]
    rng = np.random.default_rng(7)
    dM = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    v = rng.normal(size=n) + 1j * rng.normal(size=n)
    got = complex(linalg.qr_secant_delta(torch.as_tensor(M),
                                         torch.as_tensor(dM)))
    ref = complex(jlinalg.qr_secant_delta(jnp.asarray(M), jnp.asarray(dM)))
    assert _rel(got, ref) < 1e-10
    got = complex(linalg.complex_bilinear(torch.as_tensor(v),
                                          torch.as_tensor(M)))
    ref = complex(jlinalg.complex_bilinear(jnp.asarray(v), jnp.asarray(M)))
    assert _rel(got, ref) < 1e-10
    assert _rel(got, v @ M @ v) < 1e-12   # unconjugated


def test_null_space_vector_inverse(goldens_dir):
    """Inverse iteration on a near-singular operator (the tok32 matrix less
    its smallest singular triple, times 1 - 1e-9): correlation > 1 - 1e-10
    with emme_tpu's inverse iteration and with the SVD's vector; the CPU
    default is the SVD, an unknown method raises."""
    M = _matrix("tok32", goldens_dir)
    U, sv, Vh = np.linalg.svd(M)
    M = M - (1.0 - 1e-9) * sv[-1] * np.outer(U[:, -1], Vh[-1])
    Mt = torch.as_tensor(M)
    got = linalg.null_space_vector(Mt, method="inverse").numpy()
    ref = np.asarray(jlinalg.null_space_vector(jnp.asarray(M),
                                               method="inverse"))
    assert _vec_corr(got, ref) > 1 - 1e-10
    assert abs(np.linalg.norm(got) - 1.0) < 1e-12
    svd = linalg.null_space_vector(Mt, method="svd").numpy()
    assert _vec_corr(got, svd) > 1 - 1e-10
    assert np.array_equal(linalg.null_space_vector(Mt).numpy(), svd)
    with pytest.raises(ValueError):
        linalg.null_space_vector(Mt, method="qr")


def _phase_dist(a, b):
    """min over theta of ||a - e^{i theta} b|| for unit vectors a, b."""
    c = np.vdot(b, a)
    return float(np.linalg.norm(a - (c / abs(c)) * b))


def test_null_space_vector_singular(goldens_dir):
    """Inverse iteration on M^H M on the same near-singular operator: the
    SVD's vector to 1e-12 up to a phase, a unit vector, ||M v|| at
    sigma_min to 1e-9 less the rounding of forming M v (a few ulps of
    ||M||; the SVD's own vector reads 0.34 of one); one count a call; an
    unknown method raises and counts nothing."""
    M = _matrix("tok32", goldens_dir)
    U, sv, Vh = np.linalg.svd(M)
    Mt = torch.as_tensor(M - (1.0 - 1e-9) * sv[-1] *
                         np.outer(U[:, -1], Vh[-1]))
    before = dict(linalg.NULL_VECTOR_ROUTE)
    got = linalg.null_space_vector(Mt, method="singular")
    assert linalg.NULL_VECTOR_ROUTE == dict(before, singular=before[
        "singular"] + 1)
    svd = linalg.null_space_vector(Mt, method="svd").numpy()
    assert _phase_dist(got.numpy(), svd) <= 1e-12
    assert abs(float(torch.linalg.vector_norm(got)) - 1.0) <= 1e-12
    s = torch.linalg.svdvals(Mt)
    eps = np.finfo(np.float64).eps
    assert float(torch.linalg.vector_norm(Mt @ got)) \
        <= (1 + 1e-9) * float(s[-1]) + 4 * eps * float(s[0])
    before = dict(linalg.NULL_VECTOR_ROUTE)
    with pytest.raises(ValueError):
        linalg.null_space_vector(Mt, method="qr")
    assert linalg.NULL_VECTOR_ROUTE == before


@pytest.fixture(scope="module")
def tok32(tokamak_cfg):
    cfg = dict(tokamak_cfg, npoints=32)
    return emme_tpu.from_config(cfg), et.from_config(cfg, device="cpu")


@pytest.mark.parametrize("method", ["QRSecant", "BorderedSecant"])
def test_solve_methods_tok32(method, tok32, goldens_dir, golden_eigenvalues):
    """solve(method=...) at tok32, float64: the step count of emme_tpu's
    solve, omega within 1e-10 of its omega and 2e-6 of golden tok32; the
    QRSecant walk within 5e-5 of trajectories.json["tok32_QRSecant"]
    (tests/test_trajectory.py:75-87), which the BorderedSecant walk misses
    by more than 1e-3 (:91-102)."""
    pj, pt = tok32
    walk = []
    om, vec, nsteps, state = eigen.solve(
        pt, GUESS, tol=1e-6, chunk=CHUNK, method=method,
        callback=lambda j, s: walk.append(complex(s.omega)))
    om_j, _, nsteps_j, _ = jeigen.solve(pj, GUESS, tol=1e-6, method=method)
    assert nsteps == nsteps_j
    assert _rel(om, om_j) < 1e-10
    ref = complex(*golden_eigenvalues["tok32"]["omega"])
    assert _rel(om, ref) < 2e-6
    gv = np.fromfile(goldens_dir / "eigenvector_tok32.bin",
                     dtype=np.complex128)
    assert _vec_corr(gv, vec.numpy()) > 1 - 1e-7
    with open(goldens_dir / "trajectories.json") as f:
        steps = [complex(a, b)
                 for a, b in json.load(f)["tok32_QRSecant"]["steps"]]
    if method == "QRSecant":
        assert len(walk) == len(steps) == nsteps
        for k, (w, r) in enumerate(zip(walk, steps)):
            assert _rel(w, r) < 5e-5, (k, w, r)
    else:
        k = min(len(walk), len(steps))
        assert max(_rel(w, r) for w, r in zip(walk[:k], steps[:k])) > 1e-3


def test_solve_rejects_bad_arguments(tok32):
    _, pt = tok32
    with pytest.raises(ValueError, match="method"):
        eigen.solve(pt, GUESS, method="Newton")
    with pytest.raises(ValueError, match="loop"):
        eigen.solve(pt, GUESS, loop="graph")
    with pytest.raises(ValueError, match="callback"):
        eigen.solve(pt, GUESS, loop="device", callback=lambda j, s: None)


def test_solve_host64_polish_tok32(tokamak_cfg, goldens_dir,
                                   golden_eigenvalues):
    """host64=True from float32 parameters (tiered meshes, K1's plain
    version on the CPU): omega within 2e-6 of golden tok32, eigenvector
    correlation > 1 - 1e-7 (tests/test_eigen.py:81-93); the vector is
    complex128 of unit norm and the step count includes the polish."""
    p = et.from_config(dict(tokamak_cfg, npoints=32), dtype=torch.float32,
                       device="cpu")
    before = cuda_kappa.LAUNCHES
    om, vec, nsteps, state = eigen.solve(p, GUESS, tol=1e-6, host64=True)
    assert cuda_kappa.LAUNCHES == before
    ref = complex(*golden_eigenvalues["tok32"]["omega"])
    assert _rel(om, ref) < 2e-6
    assert vec.dtype == torch.complex128 and state.M.dtype == torch.complex64
    assert abs(float(torch.linalg.vector_norm(vec)) - 1.0) < 1e-12
    gv = np.fromfile(goldens_dir / "eigenvector_tok32.bin",
                     dtype=np.complex128)
    assert _vec_corr(gv, vec.numpy()) > 1 - 1e-7
    _, _, loop_steps, _ = eigen.solve(p, GUESS, tol=1e-6)
    assert nsteps > loop_steps


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_solve_device_loop_matches_host(dtype, tokamak_cfg,
                                        golden_eigenvalues):
    """loop="device" (tests on device tensors, masked with torch.where, the
    flag read one step late) walks the host loop's states: equal steps,
    omega within 1e-12, vectors > 1 - 1e-10 (tests/test_eigen.py:53-66).
    float32 with a tolerance under its floor ends through the stagnation
    counter in both.  The host loop reads the done flag every step, the
    device loop nothing inside the loop; after it both read the step count
    and omega in one read."""
    f64 = dtype == "float64"
    p = et.from_config(dict(tokamak_cfg, npoints=32),
                       dtype=getattr(torch, dtype), device="cpu")
    # tiered meshes also for float64: the loops are compared, and the solve
    # is 13x shorter at the same omega to 1e-12
    kw = dict(tol=1e-6, chunk=CHUNK, tiered=True) if f64 else dict(tol=1e-9)
    reads = {}
    out = {}
    for loop in ("host", "device"):
        eigen.HOST_READS.update(blocking=0, flag_polls=0)
        out[loop] = eigen.solve(p, GUESS, loop=loop, **kw)
        reads[loop] = dict(eigen.HOST_READS)
    (om_h, vec_h, n_h, st_h), (om_d, vec_d, n_d, st_d) = out["host"], \
        out["device"]
    assert n_d == n_h
    assert _rel(om_d, om_h) < 1e-12
    assert _vec_corr(vec_h.numpy(), vec_d.numpy()) > 1 - 1e-10
    assert torch.equal(st_h.M, st_d.M)
    ref = complex(*golden_eigenvalues["tok32"]["omega"])
    assert _rel(om_d, ref) < (2e-6 if f64 else 1e-4)
    assert n_h < p.iteration_step_limit
    assert reads["host"] == {"blocking": n_h + 1, "flag_polls": 0}
    assert reads["device"]["blocking"] == 1
    assert reads["device"]["flag_polls"] <= n_d + 1
    if not f64:   # the CPU default is the host loop
        eigen.HOST_READS.update(blocking=0, flag_polls=0)
        assert eigen.solve(p, GUESS, **kw)[2] == n_h
        assert eigen.HOST_READS == reads["host"]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_solve_timed_matches_host_loop(dtype, tokamak_cfg,
                                       golden_eigenvalues):
    """timed=True (the host loop with the per-phase sections,
    tests/test_driver.py:247-263) walks the host loop's states: the same
    omega, steps and operator, with " - linear solve", " - integration"
    and " - differential" in the timer's report, entered once a step;
    other methods and the device loop raise."""
    f64 = dtype == "float64"
    p = et.from_config(dict(tokamak_cfg, npoints=32),
                       dtype=getattr(torch, dtype), device="cpu")
    kw = dict(tol=1e-6, chunk=CHUNK, tiered=True) if f64 else dict(tol=1e-9)
    om_h, vec_h, n_h, st_h = eigen.solve(p, GUESS, loop="host", **kw)
    timer = Timer.get_timer()
    timer.reset()
    eigen.HOST_READS.update(blocking=0, flag_polls=0)
    om_t, vec_t, n_t, st_t = eigen.solve(p, GUESS, timed=True, **kw)
    assert eigen.LAST_SOLVE["loop"] == "host" and eigen.LAST_SOLVE["timed"]
    assert eigen.HOST_READS == {"blocking": n_h + 1, "flag_polls": 0}
    assert (om_t, n_t) == (om_h, n_h)
    assert torch.equal(st_t.M, st_h.M) and torch.equal(vec_t, vec_h)
    ref = complex(*golden_eigenvalues["tok32"]["omega"])
    assert _rel(om_t, ref) < (2e-6 if f64 else 1e-4)
    sections = (" - linear solve", " - integration", " - differential")
    assert timer.entries == list(sections)
    assert all(timer.timings()[s] > 0 for s in sections)
    assert all(s in timer.report() for s in sections)
    with pytest.raises(ValueError, match="TraceSecant only"):
        eigen.solve(p, GUESS, timed=True, method="QRSecant")
    with pytest.raises(ValueError, match="timed"):
        eigen.solve(p, GUESS, timed=True, loop="device")


@pytest.fixture(scope="module")
def guard_case(tokamak_cfg):
    cfg = dict(tokamak_cfg, npoints=32)
    pj, pt = emme_tpu.from_config(cfg), et.from_config(cfg, device="cpu")
    return (pj, JGrid.create(pj.length, 32)), \
        (pt, Grid.create(pt.length, 32, device="cpu"))


def _guard_matches(g, gj):
    """The port's guard against emme_tpu's: the same counts, the largest
    error within 1e-8 relative plus 1e-16 (the embedded error is the
    difference of two quadrature sums of size up to 1, so their float64
    rounding enters it absolutely)."""
    assert g["n_sampled"] == gj["n_sampled"]
    assert g["frac_flagged"] == gj["frac_flagged"]
    assert abs(g["max_abs_err"] - gj["max_abs_err"]) \
        <= 1e-8 * gj["max_abs_err"] + 1e-16
    assert set(g) == set(gj)


def test_quadrature_guard_silent_on_golden(guard_case):
    """At the converged golden omega the static mesh passes on every
    sampled pair (tests/test_eigen.py:108-116), with emme_tpu's counts."""
    (pj, gj), (pt, gt) = guard_case
    g = eigen.quadrature_guard(pt, gt, GOLDEN_OMEGA, sample=496, chunk=CHUNK)
    assert g["frac_flagged"] == 0.0
    assert g["max_abs_err"] < 1e-9
    _guard_matches(g, jeigen.quadrature_guard(pj, gj, GOLDEN_OMEGA,
                                              sample=496))


def test_quadrature_guard_catches_underresolved_regime(guard_case):
    """omega = -6 + 0.001i outpaces the oscillatory panels: the guard fires
    as emme_tpu's does, and refine_quad's denser mesh cuts the error
    five-fold (tests/test_eigen.py:119-135)."""
    (pj, gj), (pt, gt) = guard_case
    g = eigen.quadrature_guard(pt, gt, BAD_OMEGA, sample=496, chunk=CHUNK)
    assert g["frac_flagged"] > 0.01
    assert g["max_abs_err"] > 1e-6
    _guard_matches(g, jeigen.quadrature_guard(pj, gj, BAD_OMEGA, sample=496))
    quad2 = eigen.refine_quad(None, gt.eta.dtype)
    assert quad2 == jeigen.refine_quad(None, gj.eta.dtype)
    assert eigen.refine_quad({"n_osc": 10, "order": 15}, torch.float32, 3) \
        == jeigen.refine_quad({"n_osc": 10, "order": 15}, jnp.float32, 3)
    g2 = eigen.quadrature_guard(pt, gt, BAD_OMEGA, quad=quad2, sample=496,
                                chunk=CHUNK)
    assert g2["max_abs_err"] < 0.2 * g["max_abs_err"]


def test_quadrature_guard_tiers_and_band(guard_case):
    """With the tier table the guard evaluates each pair on the mesh the
    assembly would use, as emme_tpu's does; max_dij restricts the sample
    to the kept band (tests/test_eigen.py:196-204) with emme_tpu's draw."""
    from emme_tpu_torch.ops import kernels
    (pj, gj), (pt, gt) = guard_case
    tiers = kernels.tier_thresholds_ij(float(gt.dx), 32)
    g = eigen.quadrature_guard(pt, gt, GOLDEN_OMEGA, sample=200, seed=3,
                               tiers=tiers, max_dij=20, chunk=CHUNK)
    assert g["frac_flagged"] == 0.0 and g["n_sampled"] == 200
    _guard_matches(g, jeigen.quadrature_guard(
        pj, gj, GOLDEN_OMEGA, sample=200, seed=3, tiers=tiers, max_dij=20))
    iu, ju = eigen._sample_pairs(256, 512, seed=0, max_dij=16)
    assert (ju - iu).max() <= 16 and (ju - iu).min() >= 1
    assert ju.max() < 256
    ij, jj = jeigen._sample_pairs(256, 512, seed=0, max_dij=16)
    assert np.array_equal(iu, ij) and np.array_equal(ju, jj)
