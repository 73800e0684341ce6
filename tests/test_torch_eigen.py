"""emme_tpu_torch.solvers.eigen (the dense path) vs emme_tpu and the reference
goldens on the CPU: assembly, one Newton step from a shared state, the
float64 solve and its walk, and the float32 tiered solve through K1's plain
version."""
import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import emme_tpu
from emme_tpu.grid import Grid as JGrid
from emme_tpu.ops import kernels as jkernels
from emme_tpu.ops.singularity import singularity_coeff_matrix as jcoeff
from emme_tpu.solvers import eigen as jeigen
import emme_tpu_torch as et
from emme_tpu_torch import convert
from emme_tpu_torch.grid import Grid
from emme_tpu_torch.ops import cuda_kappa, kernels
from emme_tpu_torch.ops.singularity import singularity_coeff_matrix
from emme_tpu_torch.solvers import eigen

torch.set_num_threads(2)

GUESS = -0.8 + 0.25j
CHUNK = 64   # pairs per step of the float64 integrand (any size gives the same values)


def _vec_corr(a, b):
    return abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))


def _setup(cfg, n, dtype):
    cfg = dict(cfg, npoints=n)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    pj = emme_tpu.from_config(cfg, dtype=jdt)
    pt = et.from_config(cfg, dtype=tdt)
    jax_side = (pj, JGrid.create(pj.length, n, dtype=jdt), jcoeff(n, dtype=jdt))
    port = (pt, Grid.create(pt.length, n, dtype=tdt),
            singularity_coeff_matrix(n, dtype=tdt))
    return jax_side, port


@pytest.fixture(scope="module")
def tok32(tokamak_cfg):
    return _setup(tokamak_cfg, 32, "float64")


def test_assembled_matrix_tok32(goldens_dir, tok32):
    """float64 M(-0.8+0.25i) vs golden matrix_tok32_guess.bin at the bars of
    tests/test_eigen.py:27-40 (max 2e-5 scale, median 1e-9 scale), and vs
    emme_tpu's within 1e-12 of the scale."""
    (pj, gj, cj), (pt, gt, ct) = tok32
    M = eigen.assemble_matrix(pt, gt, ct,
                              torch.tensor(GUESS, dtype=torch.complex128),
                              chunk=CHUNK).numpy()
    ref = np.fromfile(goldens_dir / "matrix_tok32_guess.bin",
                      dtype=np.complex128).reshape(32, 32)
    scale = np.abs(ref).max()
    assert np.abs(M - ref).max() < 2e-5 * scale
    assert np.median(np.abs(M - ref)) < 1e-9 * scale
    Mj = np.asarray(jeigen.assemble_matrix(pj, gj, cj, jnp.complex128(GUESS)))
    assert np.abs(M - Mj).max() <= 1e-12 * scale


def test_em_assembly_matches_emme_tpu(stellarator_cfg):
    """Electromagnetic 2n x 2n operator (stellarator, n=16, float64): the
    phi/A_par blocks within 1e-12 of the scale of emme_tpu's."""
    (pj, gj, cj), (pt, gt, ct) = _setup(stellarator_cfg, 16, "float64")
    assert pt.electromagnetic
    om = -1.656 + 2.49j
    M = eigen.assemble_matrix(pt, gt, ct,
                              torch.tensor(om, dtype=torch.complex128),
                              chunk=CHUNK).numpy()
    Mj = np.asarray(jeigen.assemble_matrix(pj, gj, cj, jnp.complex128(om)))
    assert M.shape == Mj.shape == (32, 32)
    assert np.abs(M - Mj).max() <= 1e-12 * np.abs(Mj).max()


def test_tiered_fused_f32_assembly_matches_jax_xla(tokamak_cfg):
    """float32 tiered assembly through kappa_pairs_fused (its plain version
    on the CPU) vs the JAX XLA float32 tiered matrix: within 1e-6
    (tests/test_pallas_kappa.py:69)."""
    (pj, gj, cj), (pt, gt, ct) = _setup(tokamak_cfg, 32, "float32")
    om = -0.574227 + 0.274304j
    tiers = kernels.tier_thresholds_ij(float(gt.dx), 32)
    assert tiers == jkernels.tier_thresholds_ij(float(gj.dx), 32)
    before = cuda_kappa.LAUNCHES
    M = eigen.assemble_matrix(pt, gt, ct,
                              torch.tensor(om, dtype=torch.complex64),
                              tiers=tiers, fused=True)
    assert M.dtype == torch.complex64 and cuda_kappa.LAUNCHES == before
    Mj = np.asarray(jeigen.assemble_matrix(pj, gj, cj, jnp.complex64(om),
                                           tiers=tiers))
    assert np.abs(M.numpy() - Mj).max() < 1e-6


def test_newton_trace_step_from_jax_state(tok32):
    """One step from the state emme_tpu built (handed over as arrays): the
    new omega equal to emme_tpu's within 1e-12 relative, and the new
    operator within 1e-12 of its scale."""
    (pj, gj, cj), (pt, gt, ct) = tok32
    sj = jeigen.init_state(pj, gj, cj, jnp.complex128(GUESS))
    nj = jeigen.newton_trace_step(pj, gj, cj, sj)
    st = convert.state_from_arrays(*(np.asarray(getattr(sj, f))
                                     for f in ("omega", "d_omega", "M", "dM")))
    assert st.M.dtype == torch.complex128
    nt = eigen.newton_trace_step(pt, gt, ct, st, chunk=CHUNK)
    om_j = complex(np.asarray(nj.omega))
    assert abs(complex(nt.omega) - om_j) <= 1e-12 * abs(om_j)
    Mj = np.asarray(nj.M)
    assert np.abs(nt.M.numpy() - Mj).max() <= 1e-12 * np.abs(Mj).max()


def test_solve_f64_tok32(goldens_dir, tok32, golden_eigenvalues):
    """float64 TraceSecant solve of tok32: omega within 2e-6 of golden tok32,
    eigenvector correlation > 1 - 1e-7 with eigenvector_tok32.bin, the same
    step count as emme_tpu, and the per-step walk within 5e-5 of
    trajectories.json["tok32_TraceSecant"] (tests/test_trajectory.py:75-87)."""
    (pj, _, _), (pt, _, _) = tok32
    walk = []
    om, vec, nsteps, state = eigen.solve(
        pt, GUESS, tol=1e-6, chunk=CHUNK,
        callback=lambda j, s: walk.append(complex(s.omega)))
    ref = complex(*golden_eigenvalues["tok32"]["omega"])
    assert abs(om - ref) / abs(ref) < 2e-6
    gv = np.fromfile(goldens_dir / "eigenvector_tok32.bin", dtype=np.complex128)
    assert _vec_corr(gv, vec.numpy()) > 1 - 1e-7
    _, _, nsteps_j, _ = jeigen.solve(pj, GUESS, tol=1e-6)
    assert nsteps == nsteps_j
    with open(goldens_dir / "trajectories.json") as f:
        golden = json.load(f)["tok32_TraceSecant"]
    steps = [complex(a, b) for a, b in golden["steps"]]
    assert len(walk) == len(steps) == nsteps
    for k, (w, r) in enumerate(zip(walk, steps)):
        assert abs(w - r) / abs(r) < 5e-5, (k, w, r)


def test_solve_f32_tiered_fused_tok32(tokamak_cfg, golden_eigenvalues):
    """float32 solve on the main path's settings (tiered meshes, K1 -- its
    plain version on the CPU): within 5e-4 of golden tok32 at tol=2e-4
    (tests/test_pallas_kappa.py:72-78)."""
    p = et.from_config(dict(tokamak_cfg, npoints=32), dtype=torch.float32)
    before = cuda_kappa.LAUNCHES
    om, vec, nsteps, state = eigen.solve(p, GUESS, tol=2e-4)
    assert cuda_kappa.LAUNCHES == before
    assert state.M.dtype == torch.complex64 and vec.shape == (32,)
    ref = complex(*golden_eigenvalues["tok32"]["omega"])
    assert abs(om - ref) / abs(ref) < 5e-4
    with pytest.raises(ValueError):
        eigen.solve(et.from_config(dict(tokamak_cfg, npoints=32)), GUESS,
                    fused=True)


def test_f32_floor_detection_terminates(tokamak_cfg):
    """With a tolerance below the float32 rounding floor the loop stops at
    its run-time detected floor, not the step limit
    (tests/test_eigen.py:275-292)."""
    cfg = dict(tokamak_cfg, npoints=32, iteration_step_limit=12)
    p = et.from_config(cfg, dtype=torch.float32)
    om, vec, nsteps, _ = eigen.solve(
        p, GUESS, tol=1e-9, quad={"n_shoulder": 8, "n_osc": 16, "n_tail": 4})
    assert nsteps <= p.iteration_step_limit
    ref = complex(-0.57422705089888304, 0.27430444022089473)
    assert abs(om - ref) / abs(ref) < 1e-4
