"""The distributed solves of emme_tpu_torch.parallel on gloo ranks, against
emme_tpu and against the port's single-device solves: spike.solve
(TraceSecant and the bordered QRSecant; tests/test_spike.py:137-155,
:342-355), the pair-sharded dense assembly and solve
(tests/test_sharded.py:22-50), one marker-sharded PIC step
(tests/test_sharded.py:54-66)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import emme_tpu
from emme_tpu.grid import Grid as JGrid
from emme_tpu.ops.singularity import singularity_coeff_matrix as jcoeff
from emme_tpu.parallel import mesh as jmesh_mod
from emme_tpu.parallel import sharded as jsharded
from emme_tpu.parallel import spike as jspike
from emme_tpu.solvers import pic as jpic
import emme_tpu_torch as et
from emme_tpu_torch import convert
from emme_tpu_torch.grid import Grid
from emme_tpu_torch.ops.singularity import singularity_coeff_matrix
from emme_tpu_torch.parallel import mesh as mesh_mod
from emme_tpu_torch.solvers import eigen, pic
from emme_tpu_torch.solvers import sparse_eigen as se

import torch_mesh_worker as worker

torch.set_num_threads(2)

QUAD = {"n_shoulder": 8, "n_osc": 16, "n_tail": 4}
GUESS = -0.8 + 0.25j
SPIKE_KW = dict(tol=1e-6, quad=QUAD, block=8, band_deta=10.0)


def _corr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))


@pytest.fixture(scope="module")
def solves(tokamak_cfg):
    """One spawn of 4 ranks: spike.solve at tok64 with both methods."""
    return mesh_mod.launch(worker.spike_solves, 4, "cpu", deadline=300,
                           args=(tokamak_cfg, QUAD, 64))[0]


@pytest.mark.parametrize("method", ["TraceSecant", "QRSecant"])
def test_spike_solve_matches_single_device(solves, tokamak_cfg, method):
    """The whole distributed Newton walk equals the port's single-device
    banded solve: the same steps, omega within 1e-11 (TraceSecant) or 1e-9
    (the bordered update, test_spike.py:342-355), the same null vector;
    stats carry the mesh, block, h and nnz; M is the gathered operator."""
    om, vec, steps, stats, M = solves[method]
    p = et.from_config(dict(tokamak_cfg, npoints=64), device="cpu")
    st = {}
    om_ref, vec_ref, steps_ref, state = se.solve(p, GUESS, method=method,
                                                 stats=st, **SPIKE_KW)
    assert steps == steps_ref
    bar = 1e-11 if method == "TraceSecant" else 1e-9
    assert abs(om - om_ref) / abs(om_ref) < bar
    assert _corr(vec.numpy(), vec_ref.numpy()) > 1 - 1e-9
    assert stats == dict(mesh_rows=4, block=8, h=st["h"], nnz=st["nnz"])
    assert M.shape == state.M.data.shape


def test_spike_solve_matches_jax_mesh(solves, tokamak_cfg):
    """TraceSecant against emme_tpu's spike.solve on its 4-device mesh:
    omega within 1e-11, the same steps, the same vector
    (test_spike.py:137-155)."""
    om, vec, steps, _, _ = solves["TraceSecant"]
    pj = emme_tpu.from_config(dict(tokamak_cfg, npoints=64))
    mesh = jmesh_mod.make_mesh(n_rows=4, n_scan=1,
                               devices=jax.devices("cpu")[:4])
    om_j, vec_j, steps_j, _ = jspike.solve(pj, GUESS, mesh, **SPIKE_KW)
    assert steps == steps_j
    assert abs(om - om_j) / abs(om_j) < 1e-11
    assert _corr(vec.numpy(), vec_j) > 1 - 1e-9


@pytest.fixture(scope="module")
def jstate(tokamak_cfg):
    """emme_tpu's 1024 tok64 markers (16 a cell, divisible by 8)."""
    pj = emme_tpu.from_config(dict(tokamak_cfg, npoints=64))
    return pj, jpic.init_state(pj, 16, jax.random.PRNGKey(7))


@pytest.fixture(scope="module")
def dense(tokamak_cfg, jstate):
    """One spawn of 8 ranks: the dense assembly and solve at tok32 and one
    PIC step of emme_tpu's markers."""
    _, s0 = jstate
    st = convert.pic_state_from_arrays(
        {k: np.asarray(getattr(s0, k)) for k in s0.__dataclass_fields__},
        device="cpu")
    return mesh_mod.launch(worker.dense_suite, 8, "cpu", deadline=300,
                           args=(tokamak_cfg, QUAD, 32, vars(st)))[0]


def test_sharded_assembly_matches_single(dense, tokamak_cfg):
    """The pair-sharded M(-0.8+0.25j) over 8 ranks equals emme_tpu's
    sharded_assemble on its 8-device mesh and the port's
    assemble_matrix, 1e-12 (test_sharded.py:22-32)."""
    pj = emme_tpu.from_config(dict(tokamak_cfg, npoints=32))
    gj = JGrid.create(pj.length, 32)
    mesh = jmesh_mod.make_mesh()
    want = np.asarray(jax.jit(lambda: jsharded.sharded_assemble(
        pj, gj, jcoeff(32), jnp.complex128(GUESS), mesh, quad=QUAD))())
    got = dense["assembly"].numpy()
    assert np.abs(got - want).max() < 1e-12
    p = et.from_config(dict(tokamak_cfg, npoints=32), device="cpu")
    M = eigen.assemble_matrix(p, Grid.create(p.length, 32, device="cpu"),
                              singularity_coeff_matrix(32, device="cpu"),
                              torch.tensor(GUESS, dtype=torch.complex128),
                              quad=QUAD)
    assert np.abs(got - M.numpy()).max() < 1e-12


def test_sharded_dense_solve_matches_single(dense, tokamak_cfg):
    """sharded.solve over 8 ranks walks eigen.solve's trajectory (untiered
    float64, the host loop): the same steps, omega within 1e-12, the same
    null vector."""
    om, vec, steps = dense["solve"]
    p = et.from_config(dict(tokamak_cfg, npoints=32), device="cpu")
    om_ref, vec_ref, steps_ref, _ = eigen.solve(p, GUESS, tol=1e-6,
                                                quad=QUAD, tiered=False)
    assert steps == steps_ref
    assert abs(om - om_ref) / abs(om_ref) < 1e-12
    assert _corr(vec.numpy(), vec_ref.numpy()) > 1 - 1e-9


def test_pic_sharded_deposition_matches_single(dense, jstate, tokamak_cfg):
    """One RK3 step with the markers over 8 ranks and the density summed
    before each field solve: the field of emme_tpu's single-device step
    and of the port's, within 1e-10 of scale (test_sharded.py:54-66)."""
    pj, s0 = jstate
    want = np.asarray(jpic.rk3_step(pj, s0, 0.25,
                                    jpic.quasi_neutrality_coef(pj))[0].field)
    got = dense["pic_field"].numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 1e-10 * scale
    p = et.from_config(dict(tokamak_cfg, npoints=64), device="cpu")
    st = convert.pic_state_from_arrays(
        {k: np.asarray(getattr(s0, k)) for k in s0.__dataclass_fields__},
        device="cpu")
    mine = pic.rk3_step(p, st, 0.25, pic.quasi_neutrality_coef(p))[0].field
    assert np.abs(got - mine.numpy()).max() < 1e-10 * scale
