"""The dense shift-invert Arnoldi of the port (emme_tpu_torch.solvers.arnoldi)
against emme_tpu.solvers.arnoldi at tok32, float64, on the CPU, at the bars
of tests/test_sparse_arnoldi.py:129-156."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import emme_tpu
from emme_tpu.grid import Grid as JGrid
from emme_tpu.ops import linalg as jlinalg
from emme_tpu.ops.singularity import singularity_coeff_matrix as jcoeff
from emme_tpu.solvers import arnoldi as jarnoldi
import emme_tpu_torch as et
from emme_tpu_torch.grid import Grid
from emme_tpu_torch.ops.singularity import singularity_coeff_matrix
from emme_tpu_torch.solvers import arnoldi

torch.set_num_threads(2)

SIGMA = -0.8 + 0.25j
M_KRYLOV = 24
N = 32


@pytest.fixture(scope="module")
def tok32(tokamak_cfg):
    cfg = dict(tokamak_cfg, npoints=N)
    pt = et.from_config(cfg, device="cpu")
    grid = Grid.create(pt.length, N, dtype=torch.float64, device="cpu")
    coeff = singularity_coeff_matrix(N, dtype=torch.float64, device="cpu")
    return emme_tpu.from_config(cfg), pt, grid, coeff


@pytest.fixture(scope="module")
def golden(golden_eigenvalues):
    return complex(*golden_eigenvalues["tok32"]["omega"])


@pytest.fixture(scope="module")
def operator(tok32):
    """M(SIGMA) and its secant M' as the factorization assembles them."""
    _, pt, grid, coeff = tok32
    sigma = torch.tensor(SIGMA, dtype=torch.complex128)
    return arnoldi._secant_pair(pt, grid, coeff, sigma, None, 2048, 0.01)


def _jax_hessenberg_on(M, dM):
    """emme_tpu's Arnoldi on the given M, M': its real-embedding LU and its
    (re, im) plane sweep (emme_tpu/solvers/arnoldi.py:105-117)."""
    M, dM = M.numpy(), dM.numpy()
    lu = jax.scipy.linalg.lu_factor(jlinalg.real_embedding(jnp.asarray(M)))
    dr, di = jnp.asarray(dM.real), jnp.asarray(dM.imag)

    def solve_B(xr, xi):
        z = jax.scipy.linalg.lu_solve(lu, jnp.concatenate(
            [dr @ xr - di @ xi, dr @ xi + di @ xr]))
        return z[:N], z[N:]

    (Vr, Vi), (Hr, Hi) = jarnoldi.arnoldi_factorization(solve_B, N, M_KRYLOV,
                                                        jnp.float64)
    return np.asarray(Vr) + 1j * np.asarray(Vi), (Hr, Hi)


def test_factorization_matches_jax_on_one_operator(tok32, operator):
    """On one assembled M(sigma), M'(sigma): the port's complex LU and
    sweep give H and V within 1e-12 of emme_tpu's real-embedding LU and
    plane sweep, the Ritz values within 1e-10 of scale (as
    test_torch_sparse_eigen.py::test_arnoldi_matches_jax) and the leading
    one, the estimate, within 1e-12; shift_invert_factorization is that
    computation."""
    _, pt, grid, coeff = tok32
    M, dM = operator
    solve_B, _ = arnoldi._lu_solver(M, dM)
    V, H = arnoldi.arnoldi_factorization(solve_B, N, M_KRYLOV, device="cpu")
    Vj, (Hr, Hi) = _jax_hessenberg_on(M, dM)
    Hj = np.asarray(Hr) + 1j * np.asarray(Hi)
    assert np.abs(H.numpy() - Hj).max() <= 1e-12 * np.abs(Hj).max()
    assert np.abs(V.numpy() - Vj).max() <= 1e-12
    om, _ = arnoldi.ritz_from_hessenberg(H, SIGMA, M_KRYLOV)
    omj, _ = jarnoldi.ritz_from_hessenberg((Hr, Hi), SIGMA, M_KRYLOV)
    assert np.abs(om - omj).max() <= 1e-10 * np.abs(omj).max()
    assert abs(om[0] - omj[0]) <= 1e-12 * abs(omj[0])
    V2, H2, (lu, piv) = arnoldi.shift_invert_factorization(
        pt, grid, coeff, SIGMA, M_KRYLOV)
    assert torch.equal(H2, H) and torch.equal(V2, V)
    assert lu.shape == (N, N) and lu.dtype == torch.complex128


def test_shift_invert_factorization_matches_jax(tok32, operator):
    """Each package's own assemblies: the port's shift_invert_factorization
    against emme_tpu's.  The two M(sigma) part by 8e-16 of scale, but the
    secant M' = (M(1.01 sigma) - M(sigma)) / (0.01 sigma) carries that
    difference a hundredfold, and the 24 steps of the sweep amplify it
    again: H parts by 9.9e-13 of max |H|, where the same operator gives
    2e-14 (test above).  So H is held to 1e-11 of max |H|; the estimate,
    the leading Ritz value, to 1e-12, and M(sigma) to 1e-14 of scale."""
    pj, pt, grid, coeff = tok32
    _, (Hr, Hi), _ = jax.jit(jarnoldi.shift_invert_factorization,
                             static_argnums=(4,))(
        pj, JGrid.create(pj.length, N), jcoeff(N), jnp.complex128(SIGMA),
        M_KRYLOV)
    _, H, _ = arnoldi.shift_invert_factorization(pt, grid, coeff, SIGMA,
                                                 M_KRYLOV)
    Hj = np.asarray(Hr) + 1j * np.asarray(Hi)
    assert np.abs(H.numpy() - Hj).max() <= 1e-11 * np.abs(Hj).max()
    om, _ = arnoldi.ritz_from_hessenberg(H, SIGMA, M_KRYLOV)
    omj, _ = jarnoldi.ritz_from_hessenberg((Hr, Hi), SIGMA, M_KRYLOV)
    assert abs(om[0] - omj[0]) <= 1e-12 * abs(omj[0])
    from emme_tpu.solvers import eigen as jeigen
    Mj = np.asarray(jeigen.assemble_matrix(pj, JGrid.create(pj.length, N),
                                           jcoeff(N), jnp.complex128(SIGMA)))
    M, _ = operator
    assert np.abs(M.numpy() - Mj).max() <= 1e-14 * np.abs(Mj).max()


def test_solve_polished_matches_golden(tok32, golden):
    """arnoldi.solve with newton_polish=6 (tests/test_sparse_arnoldi.py:131):
    within 2e-6 of golden tok32, a null vector of unit norm."""
    _, pt, _, _ = tok32
    om, vec, steps = arnoldi.solve(pt, SIGMA, m_krylov=M_KRYLOV,
                                   newton_polish=6)
    assert isinstance(om, complex) and 1 <= steps <= 6
    assert abs(om - golden) / abs(golden) < 2e-6
    assert vec.shape == (N,) and vec.dtype == torch.complex128
    assert abs(float(torch.linalg.vector_norm(vec)) - 1.0) < 1e-12


def test_raw_estimate_in_neighbourhood(tok32, golden):
    """newton_polish=0 returns the linearized estimate and its Ritz vector
    (host, unit norm): within 0.15 of golden tok32 from -0.6 + 0.28i
    (tests/test_sparse_arnoldi.py:141)."""
    _, pt, _, _ = tok32
    om, vec, steps = arnoldi.solve(pt, -0.6 + 0.28j, m_krylov=M_KRYLOV,
                                   newton_polish=0)
    assert steps == 0 and abs(om - golden) < 0.15
    assert isinstance(vec, np.ndarray) and vec.shape == (N,)
    assert abs(np.linalg.norm(vec) - 1.0) < 1e-12


def test_batched_shifts_equal_unbatched(tok32, golden):
    """solve_shifts_batched over two shifts (tests/test_sparse_arnoldi.py:
    149): each estimate within 0.2 of golden tok32, and equal to the
    unbatched solve_one_shift at that shift to 1e-12 (one batched LU and
    sweep against one each)."""
    _, pt, grid, coeff = tok32
    sigmas = np.array([-0.7 + 0.3j, -0.5 + 0.25j])
    ests = arnoldi.solve_shifts_batched(pt, sigmas, m_krylov=M_KRYLOV)
    assert ests.shape == (2,)
    assert all(abs(e - golden) < 0.2 for e in ests)
    for s, e in zip(sigmas, ests):
        one, _, _ = arnoldi.solve_one_shift(pt, grid, coeff, s, M_KRYLOV)
        assert abs(e - one) <= 1e-12 * abs(one)


def test_mesh_raises(tok32):
    """mesh= takes a parallel.mesh.Mesh (the shift axis over its scan
    groups, tests/test_torch_mesh_sparse.py); anything else raises a
    TypeError naming the type it wants."""
    _, pt, _, _ = tok32
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        arnoldi.solve_shifts_batched(pt, [SIGMA], mesh=object())
