"""emme_tpu_torch.parallel.spike and the banded half of parallel.sharded on
gloo ranks, against emme_tpu.parallel on its virtual CPU mesh (conftest:
8 devices): the sharded window assembly, the SPIKE trace, solve and null
vector at 4 ranks (tests/test_spike.py:82-133, :207-222), the bordered
update, the halo-exchange matvec, the batched Arnoldi shifts over the scan
axis, and the trace and solve at 8 ranks (tests/test_distributed.py:70-85).
One spawn per rank count computes every quantity (module fixtures)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import emme_tpu
from emme_tpu.grid import Grid as JGrid
from emme_tpu.ops.singularity import singularity_coeff_band as jcb
from emme_tpu.ops.sparse import BDIAOperator as JBDIA
from emme_tpu.parallel import mesh as jmesh_mod
from emme_tpu.parallel import spike as jspike
import emme_tpu_torch as et
from emme_tpu_torch.grid import Grid
from emme_tpu_torch.ops import banded
from emme_tpu_torch.ops.singularity import singularity_coeff_band
from emme_tpu_torch.ops.sparse import BDIAOperator, bdia_matvec
from emme_tpu_torch.parallel import mesh as mesh_mod
from emme_tpu_torch.solvers import arnoldi, eigen
from emme_tpu_torch.solvers import sparse_eigen as se

import torch_mesh_worker as worker

torch.set_num_threads(2)

QUAD = {"n_shoulder": 8, "n_osc": 16, "n_tail": 4}
GUESS = -0.8 + 0.25j


def _operators(cfg, n, bs, h):
    """The tok``n`` operator at GUESS and its secant from -0.81+0.26j
    (test_spike.py:105-110), float64, by the port's assemble_bdia."""
    p = et.from_config(dict(cfg, npoints=n), device="cpu")
    grid = Grid.create(p.length, n, device="cpu")
    cb = singularity_coeff_band(n, (h + 1) * bs - 1, device="cpu")

    def asm(om):
        return se.assemble_bdia(p, grid, cb,
                                torch.tensor(om, dtype=torch.complex128), h,
                                bs, quad=QUAD)

    M = asm(GUESS)
    dM = se.bdia_secant(asm(-0.81 + 0.26j), M,
                        torch.tensor(0.01 + 0.01j, dtype=torch.complex128))
    return M, dM


def _planes(op):
    return JBDIA(data=jnp.asarray(np.stack([op.data.real.numpy(),
                                            op.data.imag.numpy()], axis=2)),
                 offsets=op.offsets, n=op.n, block=op.block)


def _jmesh(rows):
    return jmesh_mod.make_mesh(n_rows=rows, n_scan=1,
                               devices=jax.devices("cpu")[:rows])


@pytest.fixture(scope="module")
def ops(tokamak_cfg):
    return _operators(tokamak_cfg, 64, 8, 2)


@pytest.fixture(scope="module")
def f64():
    return torch.linspace(-1.0, 1.0, 64, dtype=torch.float64).to(
        torch.complex128) * (1 + 0.5j)


@pytest.fixture(scope="module")
def wide():
    """A random complex BDIA operator, n 64, bs 4, offsets -6..6: at 4
    ranks (4 block rows each) its band reaches two shards away."""
    gen = torch.Generator().manual_seed(5)
    nb, h = 16, 6
    data = torch.randn((2 * h + 1, nb, 4, 4), dtype=torch.complex128,
                       generator=gen)
    i = torch.arange(nb)
    for k, d in enumerate(range(-h, h + 1)):
        data[k, (i + d < 0) | (i + d >= nb)] = 0   # the zero padding
    return BDIAOperator(data=data, offsets=tuple(range(-h, h + 1)), n=64,
                        block=4)


@pytest.fixture(scope="module")
def r4(tokamak_cfg, ops, f64, wide):
    M, dM = ops
    return mesh_mod.launch(worker.sparse_suite, 4, "cpu", deadline=300,
                           args=(tokamak_cfg, QUAD, M.data, dM.data,
                                 M.offsets, M.n, M.block, f64, wide))[0]


def test_sharded_assembly_matches(r4, ops, tokamak_cfg):
    """The gathered windows of 4 ranks equal the port's assemble_bdia and
    emme_tpu's sharded_assemble_bdia on its 4-device mesh, 1e-12."""
    M, _ = ops
    assert float((r4["assembly"] - M.data).abs().max()) <= 1e-12
    pj = emme_tpu.from_config(dict(tokamak_cfg, npoints=64))
    gj = JGrid.create(pj.length, 64)
    cj = jcb(64, 23)
    mesh = _jmesh(4)
    with mesh:
        data = np.asarray(jax.device_get(jax.jit(
            lambda: jspike.sharded_assemble_bdia(
                pj, gj, cj, GUESS, 2, 8, mesh, quad=QUAD))().data))
    want = data[:, :, 0] + 1j * data[:, :, 1]
    assert np.abs(r4["assembly"].numpy() - want).max() <= 1e-12


def test_spike_trace_matches(r4, ops):
    """d_omega = -1 / tr(M^{-1} dM) over 4 ranks against the port's
    single-device Takahashi trace and emme_tpu's 4-device SPIKE trace,
    1e-10 relative (test_spike.py:103-121)."""
    M, dM = ops
    tr = banded.banded_trace_product(
        banded.banded_selected_inverse(banded.banded_lu(M)), dM).item()
    got = -1.0 / complex(r4["d_omega"])
    assert abs(got - tr) / abs(tr) < 1e-10
    mesh = _jmesh(4)
    with mesh:
        dr, di = jax.jit(lambda a, b: jspike.sharded_trace_d_omega(
            JBDIA(data=a, offsets=M.offsets, n=M.n, block=M.block),
            JBDIA(data=b, offsets=M.offsets, n=M.n, block=M.block), mesh))(
                _planes(M).data, _planes(dM).data)
    want = complex(float(dr), float(di))
    assert abs(complex(r4["d_omega"]) - want) / abs(want) < 1e-10


def test_one_shard_is_the_banded_path(r4, ops, f64):
    """A rows axis of one shard has no interface: its trace and solve are
    the single-device banded ones, 1e-12."""
    M, dM = ops
    lu = banded.banded_lu(M)
    tr = banded.banded_trace_product(banded.banded_selected_inverse(lu),
                                     dM).item()
    assert abs(-1.0 / complex(r4["d_omega_one"]) - tr) <= 1e-12 * abs(tr)
    ref = banded.banded_solve(lu, f64)
    assert float((r4["solve_one"] - ref).abs().max()) <= \
        1e-12 * float(ref.abs().max())


def test_spike_solve_matches(r4, ops, f64):
    """z = M^{-1} f over 4 ranks (one right-hand side and two) against the
    banded solve and emme_tpu's sharded_solve_vec, 1e-10 of scale
    (test_spike.py:82-100)."""
    M, _ = ops
    lu = banded.banded_lu(M)
    ref = banded.banded_solve(lu, f64)
    scale = float(ref.abs().max())
    assert float((r4["solve"] - ref).abs().max()) <= 1e-10 * scale
    ref2 = banded.banded_solve(lu, torch.stack([f64, 2j * f64], 1))
    assert float((r4["solve_multi"] - ref2).abs().max()) <= 2e-10 * scale
    mesh = _jmesh(4)
    with mesh:
        zr, zi = jax.jit(lambda d, a, b: jspike.sharded_solve_vec(
            JBDIA(data=d, offsets=M.offsets, n=M.n, block=M.block), mesh,
            a, b))(_planes(M).data, f64.real.numpy(), f64.imag.numpy())
    want = np.asarray(zr) + 1j * np.asarray(zi)
    assert np.abs(r4["solve"].numpy() - want).max() <= 1e-10 * scale


def test_sharded_nullspace(r4, ops):
    """The SPIKE inverse-iteration vector is the single-device one and
    emme_tpu's sharded one (correlation > 1 - 1e-9, test_spike.py:207-222)."""
    M, _ = ops
    w = se._null_vector(banded.banded_lu(M), M.n, M.data.dtype,
                        iters=3).numpy()
    v = r4["nullspace"].numpy()
    mesh = _jmesh(4)
    with mesh:
        vr, vi = jax.jit(lambda d: jspike.sharded_nullspace(
            JBDIA(data=d, offsets=M.offsets, n=M.n, block=M.block), mesh))(
                _planes(M).data)
    jv = np.asarray(vr) + 1j * np.asarray(vi)
    for ref in (w, jv):
        corr = abs(np.vdot(v, ref)) / (np.linalg.norm(v) * np.linalg.norm(ref))
        assert corr > 1 - 1e-9
    assert abs(np.linalg.norm(v) - 1.0) < 1e-12


def test_bordered_update_matches_single_device(r4, ops):
    """-(v^T M v) / (v^T dM v) with the SPIKE null vector and the halo
    matvecs equals the single-device bordered update, 1e-9."""
    M, dM = ops
    v = se._null_vector(banded.banded_lu(M), M.n, M.data.dtype, iters=3)
    want = complex(-((v * bdia_matvec(M, v)).sum()
                     / (v * bdia_matvec(dM, v)).sum()))
    assert abs(complex(r4["bordered"]) - want) / abs(want) < 1e-9


@pytest.mark.parametrize("which", ["matvec", "matvec_wide"])
def test_halo_matvec_matches(r4, ops, wide, f64, which):
    """The ppermute stripe-relay matvec equals bdia_matvec, 1e-13: one hop
    (the tok64 band) and two hops (``wide``)."""
    op = ops[0] if which == "matvec" else wide
    ref = bdia_matvec(op, f64)
    assert float((r4[which] - ref).abs().max()) <= \
        1e-13 * float(ref.abs().max())


def test_batched_shifts_over_the_scan_axis(r4, tokamak_cfg):
    """solve_shifts_batched(mesh=) on a 2 x 2 mesh: the two shifts split
    over the scan axis give the estimates of the single-device batched
    call, 1e-12."""
    p = et.from_config(dict(tokamak_cfg, npoints=32), device="cpu")
    want = arnoldi.solve_shifts_batched(p, [-0.8 + 0.25j, -0.75 + 0.3j], 8,
                                        QUAD)
    got = r4["shifts_mesh"]
    assert got.shape == (2,)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("backend", ["sparse", "dense"])
def test_host64_polish_on_rank0_matches_single(r4, tokamak_cfg, backend):
    """host64=True on a 2-rank rows axis (the polish on rank 0, broadcast):
    the single-device polished solve's omega within 1e-12, its steps, a
    complex128 unit vector with the same direction."""
    om, vec, steps = r4["host64"][backend]
    p = et.from_config(dict(tokamak_cfg, npoints=32), device="cpu")
    if backend == "sparse":
        ref = se.solve(p, GUESS, tol=1e-6, quad=QUAD, block=8,
                       band_deta=10.0, host64=True)
    else:
        ref = eigen.solve(p, GUESS, tol=1e-6, quad=QUAD, tiered=False,
                          host64=True)
    assert steps == ref[2]
    assert abs(om - ref[0]) <= 1e-12 * abs(ref[0])
    assert vec.dtype == torch.complex128
    v, w = vec.numpy(), ref[1].numpy()
    assert abs(np.vdot(v, w)) / (np.linalg.norm(v) * np.linalg.norm(w)) > \
        1 - 1e-9


@pytest.fixture(scope="module")
def dist_case(tokamak_cfg):
    """tests/distributed_worker.py's operator: tok64, bs 2, h 4 (nb 32,
    four block rows a shard at 8 ranks)."""
    # distributed_worker.build_op: the secant from 0.99 * GUESS
    p = et.from_config(dict(tokamak_cfg, npoints=64), device="cpu")
    grid = Grid.create(p.length, 64, device="cpu")
    cb = singularity_coeff_band(64, 9, device="cpu")
    om = torch.tensor(GUESS, dtype=torch.complex128)
    M = se.assemble_bdia(p, grid, cb, om, 4, 2, quad=QUAD)
    M_old = se.assemble_bdia(p, grid, cb, 0.99 * om, 4, 2, quad=QUAD)
    dM = se.bdia_secant(M, M_old, 0.01 * om)
    f = torch.linspace(-1.0, 1.0, 64, dtype=torch.float64)
    f = torch.complex(f, 0.5 * f)
    got = mesh_mod.launch(worker.distributed_suite, 8, "cpu", deadline=300,
                          args=(M.data, dM.data, M.offsets, M.n, M.block,
                                f))[0]
    return M, dM, f, got


def test_eight_ranks_match_jax_eight_devices(dist_case):
    """The SPIKE trace and solve over 8 gloo ranks against emme_tpu's over
    its 8-device mesh (test_distributed.py:70-85): d_omega within 1e-12,
    the solve's squared norm within 1e-9."""
    M, dM, f, got = dist_case
    mesh = _jmesh(8)
    with mesh:
        dr, di = jax.jit(lambda a, b: jspike.sharded_trace_d_omega(
            JBDIA(data=a, offsets=M.offsets, n=M.n, block=M.block),
            JBDIA(data=b, offsets=M.offsets, n=M.n, block=M.block), mesh))(
                _planes(M).data, _planes(dM).data)
        zr, zi = jax.jit(lambda d, a, b: jspike.sharded_solve_vec(
            JBDIA(data=d, offsets=M.offsets, n=M.n, block=M.block), mesh,
            a, b))(_planes(M).data, f.real.numpy(), f.imag.numpy())
    d = complex(got["d_omega"])
    assert abs(d.real - float(dr)) < 1e-12 * max(1.0, abs(float(dr)))
    assert abs(d.imag - float(di)) < 1e-12 * max(1.0, abs(float(di)))
    nrm = float((got["solve"].abs() ** 2).sum())
    jnrm = float(np.sum(np.asarray(zr) ** 2 + np.asarray(zi) ** 2))
    assert abs(nrm - jnrm) < 1e-9 * max(1.0, abs(jnrm))
