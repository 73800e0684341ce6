"""emme_tpu_torch.solvers.sparse_eigen and solvers.arnoldi (the banded,
never-dense eigensolve) vs emme_tpu and the reference goldens on the CPU:
the direct-to-BDIA assembly (electrostatic, electromagnetic, float32 tiered
through K1's plain version), Arnoldi, one Newton step from a JAX state, and
the whole slice at tok32 with the Arnoldi stage on the BSR route."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import emme_tpu
from emme_tpu.grid import Grid as JGrid
from emme_tpu.ops import kernels as jkernels
from emme_tpu.ops.singularity import singularity_coeff_band as jcoeff_band
from emme_tpu.solvers import arnoldi as jarnoldi
from emme_tpu.solvers import sparse_eigen as jse
import emme_tpu_torch as et
from emme_tpu_torch import convert
from emme_tpu_torch.grid import Grid
from emme_tpu_torch.ops import cuda_kappa, cuda_spmv, kernels
from emme_tpu_torch.ops.singularity import singularity_coeff_band
from emme_tpu_torch.solvers import arnoldi, newton, sparse_eigen as se

torch.set_num_threads(2)

GUESS = -0.8 + 0.25j
# a coarse panel mesh given to both packages where only the assembly and
# iteration logic is compared (tests/test_sparse_eigen.py:237 uses it too)
QUAD = {"n_shoulder": 8, "n_osc": 16, "n_tail": 4}
SLICE = dict(tol=1e-6, block=8, band_deta=20.0, m_krylov=8, spmv="bsr")


def _planes(t):
    return np.stack([t.real.numpy(), t.imag.numpy()], axis=-3)


def _corr(a, b):
    return abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))


def _jax_assemble(pj, gj, cj, om, h, bs, **kw):
    """emme_tpu's assemble_bdia as one compiled program (its eager form
    dispatches op by op)."""
    return jax.jit(lambda p, g, cb: jse.assemble_bdia(p, g, cb, om, h, bs,
                                                       **kw))(pj, gj, cj)


def _setup(cfg, n, dtype, h_el):
    cfg = dict(cfg, npoints=n)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    pj = emme_tpu.from_config(cfg, dtype=jdt)
    pt = et.from_config(cfg, dtype=tdt, device="cpu")
    return ((pj, JGrid.create(pj.length, n, dtype=jdt),
             jcoeff_band(n, h_el, dtype=jdt)),
            (pt, Grid.create(pt.length, n, dtype=tdt, device="cpu"),
             singularity_coeff_band(n, h_el, dtype=tdt, device="cpu")))


def test_assemble_bdia_es_tok64(tokamak_cfg):
    """Electrostatic tok64, bs 16, h 2, float64: the BDIA operator equal to
    emme_tpu's within 1e-13."""
    bs, h = 16, 2
    (pj, gj, cj), (pt, gt, ct) = _setup(tokamak_cfg, 64, "float64",
                                        (h + 1) * bs - 1)
    op = se.assemble_bdia(pt, gt, ct, torch.tensor(GUESS, dtype=torch.complex128),
                          h, bs, quad=QUAD)
    jop = _jax_assemble(pj, gj, cj, jnp.complex128(GUESS), h, bs, quad=QUAD)
    assert op.offsets == jop.offsets == tuple(range(-h, h + 1))
    assert (op.n, op.block, op.nnz) == (jop.n, jop.block, jop.nnz)
    assert np.abs(_planes(op.data) - np.asarray(jop.data)).max() <= 1e-13


def test_assemble_bdia_em_stel32(stellarator_cfg):
    """Electromagnetic stel32 in the interleaved ordering, bs 16, h 2,
    float64: equal to emme_tpu's within 1e-12 of the scale; deinterleave
    agrees with emme_tpu's."""
    bs, h = 16, 2
    de_max = se.em_de_max(32, h, bs)
    assert de_max == jse.em_de_max(32, h, bs)
    (pj, gj, cj), (pt, gt, ct) = _setup(stellarator_cfg, 32, "float64",
                                        de_max)
    assert pt.electromagnetic
    om = -1.656 + 2.49j
    op = se.assemble_bdia(pt, gt, ct, torch.tensor(om, dtype=torch.complex128),
                          h, bs, quad=QUAD)
    jop = _jax_assemble(pj, gj, cj, jnp.complex128(om), h, bs, quad=QUAD)
    assert op.n == jop.n == 64 and op.offsets == jop.offsets
    want = np.asarray(jop.data)
    assert np.abs(_planes(op.data) - want).max() <= 1e-12 * np.abs(want).max()
    v = np.arange(64) + 0.5j
    np.testing.assert_array_equal(se.deinterleave(torch.as_tensor(v)).numpy(),
                                  jse.deinterleave(v))


def test_assemble_bdia_f32_tiered_fused(tokamak_cfg):
    """float32, tiered meshes, kernel table through K1's plain version (no
    launch on the CPU) vs emme_tpu's float32 tiered XLA operator: within
    1e-6, the bar of the fused dense matrix in tests/test_torch_eigen.py."""
    bs, h = 16, 2
    (pj, gj, cj), (pt, gt, ct) = _setup(tokamak_cfg, 64, "float32",
                                        (h + 1) * bs - 1)
    tiers = kernels.tier_thresholds_ij(float(gt.dx), 64)
    assert tiers == jkernels.tier_thresholds_ij(float(gj.dx), 64)
    om = -0.574227 + 0.274304j
    before = cuda_kappa.LAUNCHES
    op = se.assemble_bdia(pt, gt, ct, torch.tensor(om, dtype=torch.complex64),
                          h, bs, tiers=tiers, fused=True)
    assert cuda_kappa.LAUNCHES == before and op.data.dtype == torch.complex64
    jop = _jax_assemble(pj, gj, cj, jnp.complex64(om), h, bs, tiers=tiers)
    assert np.abs(_planes(op.data) - np.asarray(jop.data)).max() < 1e-6
    # the kernel table's chunking does not change a value
    small = se.assemble_bdia(pt, gt, ct, torch.tensor(om, dtype=torch.complex64),
                             h, bs, tiers=tiers, fused=True, chunk=1000)
    assert torch.equal(small.data, op.data)


def test_arnoldi_matches_jax():
    """arnoldi_factorization on a fixed 40 x 40 complex operator: H and V
    within 1e-12 of emme_tpu's; the Ritz values equal."""
    rng = np.random.default_rng(0)
    n, m = 40, 10
    A = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    At = torch.as_tensor(A)
    V, H = arnoldi.arnoldi_factorization(lambda x: At @ x, n, m,
                                         device="cpu")
    Ar, Ai = jnp.asarray(A.real), jnp.asarray(A.imag)
    (Vr, Vi), (Hr, Hi) = jarnoldi.arnoldi_factorization(
        lambda xr, xi: (Ar @ xr - Ai @ xi, Ar @ xi + Ai @ xr), n, m)
    Hj = np.asarray(Hr) + 1j * np.asarray(Hi)
    assert H.shape == (m + 1, m) and V.shape == (m + 1, n)
    assert np.abs(H.numpy() - Hj).max() <= 1e-12 * np.abs(Hj).max()
    assert np.abs(V.numpy() - (np.asarray(Vr) + 1j * np.asarray(Vi))).max() \
        <= 1e-12
    om, _ = arnoldi.ritz_from_hessenberg(H, 0.5 + 0.1j, m)
    omj, _ = jarnoldi.ritz_from_hessenberg((Hr, Hi), 0.5 + 0.1j, m)
    assert np.abs(om - omj).max() <= 1e-10 * np.abs(omj).max()


@pytest.fixture(scope="module")
def tok32_jax_state(tokamak_cfg):
    """emme_tpu's initial banded state at tok32 (bs 8, h 2, float64) and
    both packages' (params, grid, coefficient band)."""
    bs, h = 8, 2
    (pj, gj, cj), port = _setup(tokamak_cfg, 32, "float64", (h + 1) * bs - 1)
    sj = jax.jit(lambda p, g, cb: jse.init_state(
        p, g, cb, jnp.complex128(GUESS), h, bs, quad=QUAD))(pj, gj, cj)
    return (pj, gj, cj), port, sj


@pytest.mark.parametrize("step", ["bordered_newton_step", "trace_newton_step"])
def test_newton_step_from_jax_state(tok32_jax_state, step):
    """One banded Newton step from the state emme_tpu built (carried across
    by convert.sparse_state_from_arrays): d_omega within 1e-10 relative,
    the new operator within 1e-12 of its scale."""
    bs, h = 8, 2
    (pj, gj, cj), (pt, gt, ct), sj = tok32_jax_state
    nj = jax.jit(lambda p, g, cb, s: getattr(jse, step)(
        p, g, cb, s, h, bs, quad=QUAD))(pj, gj, cj, sj)

    def arrays(op):
        return np.asarray(op.data), op.offsets, op.n, op.block

    st = convert.sparse_state_from_arrays(
        np.asarray(sj.omega), np.asarray(sj.d_omega), arrays(sj.M),
        arrays(sj.dM), device="cpu")
    assert st.M.data.dtype == torch.complex128
    nt = getattr(se, step)(pt, gt, ct, st, h, bs, quad=QUAD)
    dj = complex(np.asarray(nj.d_omega))
    assert abs(complex(nt.d_omega) - dj) <= 1e-10 * abs(dj)
    want = np.asarray(nj.M.data)
    assert np.abs(_planes(nt.M.data) - want).max() <= 1e-12 * np.abs(want).max()


@pytest.fixture(scope="module")
def tok32_slice(tokamak_cfg):
    """The slice at tok32, float64, once in each package: (port result,
    port stats, JAX result, JAX stats)."""
    cfg = dict(tokamak_cfg, npoints=32)
    before = cuda_spmv.LAUNCHES
    st, sj = {}, {}
    port = se.solve(et.from_config(cfg, device="cpu"), GUESS, stats=st,
                    **SLICE)
    assert cuda_spmv.LAUNCHES == before
    ref = jse.solve(emme_tpu.from_config(cfg), GUESS, stats=sj, **SLICE)
    return port, st, ref, sj


def test_slice_matches_jax(tok32_slice):
    """tok32, block 8, band_deta 20, Arnoldi (m 8) on the BSR route: the
    same step count as emme_tpu, omega within 1e-10 relative, the Arnoldi
    estimate within 1e-8, eigenvector correlation > 1 - 1e-10, the same
    operator stats; the port times nothing in the solve (no SpMV rate, no
    Arnoldi seconds: a trace's spans measure those)."""
    (om, vec, steps, state), st, (omj, vecj, stepsj, _), sj = tok32_slice
    assert steps == stepsj
    assert abs(om - omj) / abs(omj) < 1e-10
    assert abs(st["arnoldi_omega"] - sj["arnoldi_omega"]) < 1e-8
    assert vec.shape == (32,) and vec.dtype == torch.complex128
    assert _corr(vec.numpy(), vecj) > 1 - 1e-10
    for key in ("nnz", "block", "h", "band_fraction", "spmv_route"):
        assert st[key] == sj[key], key
    assert st["spmv_route"] == "bsr"
    assert "spmv_nnz_per_s" not in st and "arnoldi_s" not in st
    assert state.M.nnz < 32 * 32


def test_slice_golden(tok32_slice, golden_eigenvalues, goldens_dir):
    """The slice's omega within 2e-6 of golden tok32
    (tests/test_sparse_eigen.py:56) and its eigenvector correlated with
    eigenvector_tok32.bin to 1 - 1e-5."""
    (om, vec, _, _), _, _, _ = tok32_slice
    ref = complex(*golden_eigenvalues["tok32"]["omega"])
    assert abs(om - ref) / abs(ref) < 2e-6
    gv = np.fromfile(goldens_dir / "eigenvector_tok32.bin", np.complex128)
    assert _corr(gv, vec.numpy()) > 1 - 1e-5


def test_host64_golden(tok32_slice, tokamak_cfg, golden_eigenvalues):
    """host64=True (the complex128 polish on the parameters' device),
    seeded at the slice's omega: within 2e-6 of golden tok32, a unit
    complex128 eigenvector."""
    (om0, _, _, _), _, _, _ = tok32_slice
    p = et.from_config(dict(tokamak_cfg, npoints=32), device="cpu")
    om, vec, steps, _ = se.solve(p, om0, tol=1e-6, block=8, band_deta=20.0,
                                 host64=True)
    ref = complex(*golden_eigenvalues["tok32"]["omega"])
    assert abs(om - ref) / abs(ref) < 2e-6
    assert vec.dtype == torch.complex128 and steps >= 2
    assert float(torch.linalg.vector_norm(vec)) == pytest.approx(1.0,
                                                                 rel=1e-12)


def test_solve_shifts_and_argument_checks(tokamak_cfg):
    """solve_shifts runs each shift in order and gives solve's result; a
    shift that raises yields (nan, None, 0) with a warning; an unknown
    loop, an unknown method and fused float64 raise."""
    p = et.from_config(dict(tokamak_cfg, npoints=32), device="cpu")
    kw = dict(tol=1e-6, block=8, band_deta=20.0, quad=QUAD, m_krylov=4)
    om, vec, steps, _ = se.solve(p, GUESS, **kw)
    out = se.solve_shifts(p, [GUESS], **kw)
    assert out[0][0] == om and out[0][2] == steps
    assert torch.equal(out[0][1], vec)
    with pytest.warns(UserWarning, match="failed"):
        bad = se.solve_shifts(p, [GUESS], spmv="csr", **kw)
    assert np.isnan(bad[0][0].real) and bad[0][1] is None
    for extra in (dict(loop="graph"), dict(method="Secant"),
                  dict(fused=True)):
        with pytest.raises(ValueError):
            se.solve(p, GUESS, **extra)


@pytest.mark.parametrize("method", ["TraceSecant", "QRSecant"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_device_loop_matches_host(dtype, method, tokamak_cfg):
    """loop="device" walks the host loop's states through the one loop body
    every backend has (``newton.py``): equal steps, omega and vector at tok32, both
    methods, float64 and float32 (a tolerance under the float32 floor ends
    through the stagnation rule in both).  The host loop reads the flag
    every step, the device loop nothing inside the loop; after it each
    reads the step count and omega once."""
    f64 = dtype == "float64"
    p = et.from_config(dict(tokamak_cfg, npoints=32),
                       dtype=getattr(torch, dtype), device="cpu")
    kw = dict(tol=1e-6 if f64 else 1e-9, block=8, band_deta=20.0, quad=QUAD,
              method=method)
    out, reads, did = {}, {}, {}
    for loop in ("host", "device"):
        newton.HOST_READS.update(blocking=0, flag_polls=0)
        out[loop] = se.solve(p, GUESS, loop=loop, **kw)
        reads[loop] = dict(newton.HOST_READS)
        did[loop] = dict(newton.LAST_SOLVE)
    (om_h, vec_h, n_h, st_h), (om_d, vec_d, n_d, st_d) = out["host"], \
        out["device"]
    assert n_d == n_h and n_h < p.iteration_step_limit
    assert om_d == om_h
    assert torch.equal(st_d.M.data, st_h.M.data)
    assert torch.equal(st_d.dM.data, st_h.dM.data)
    assert st_d.M.offsets == st_h.M.offsets and st_d.M.block == 8
    assert torch.equal(vec_d, vec_h)
    assert did["host"] == dict(loop="host", method=method, steps=n_h,
                               queued_steps=n_h)
    assert did["device"]["loop"] == "device"
    assert did["device"]["queued_steps"] in (n_h, n_h + 1)
    assert reads["host"] == {"blocking": n_h + 1, "flag_polls": 0}
    assert reads["device"]["blocking"] == 1
    assert reads["device"]["flag_polls"] <= n_d + 1
    # the default is the host loop
    newton.HOST_READS.update(blocking=0, flag_polls=0)
    assert se.solve(p, GUESS, **kw)[2] == n_h
    assert newton.LAST_SOLVE["loop"] == "host"


def test_solve_shifts_survives_keyerror(tokamak_cfg, monkeypatch):
    """One shift of three made to fail with the KeyError that
    kernels.scaled_quad raises on a tier spec it does not know (as
    emme_tpu's does): that shift yields (nan, None, 0) after a warning
    naming the shift and the exception's type, the others their solves."""
    p = et.from_config(dict(tokamak_cfg, npoints=32), device="cpu")
    kw = dict(tol=1e-6, block=8, band_deta=20.0, quad=QUAD, m_krylov=0,
              tiered=True)
    good = se.solve(p, GUESS, **kw)
    real = kernels.tier_thresholds_ij
    calls = []

    def tiers(dx, n):
        calls.append(1)
        t = real(dx, n)
        if len(calls) == 2:   # the second shift's table
            return tuple((ub, (("n_bogus", 3),)) for ub, _ in t)
        return t

    monkeypatch.setattr(kernels, "tier_thresholds_ij", tiers)
    sigmas = [GUESS, -0.7 + 0.2j, GUESS]
    with pytest.warns(UserWarning, match=r"shift \(-0.7\+0.2j\) failed: "
                                         "KeyError: 'n_bogus'"):
        out = se.solve_shifts(p, sigmas, **kw)
    assert len(out) == 3 and len(calls) == 3
    assert np.isnan(out[1][0].real) and out[1][1] is None and out[1][2] == 0
    for k in (0, 2):
        assert out[k][0] == good[0] and out[k][2] == good[2]
        assert torch.equal(out[k][1], good[1])
