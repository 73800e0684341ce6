"""emme_tpu_torch.parallel.mesh (SPMD over torch.distributed, gloo ranks on
the CPU) and the pieces of the SPIKE solve that need no spawn: the
collectives at 2 and 4 ranks against their definitions, a failing rank and
the deadline ending a launch, the window assembly against emme_tpu's and
against the port's assemble_bdia, and the block-tridiagonal reduced algebra
against the dense inverse and emme_tpu's (tests/test_spike.py:47-79,
:272-322)."""
import json
import time

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import emme_tpu
from emme_tpu.grid import Grid as JGrid
from emme_tpu.ops.singularity import singularity_coeff_band as jcoeff_band
from emme_tpu.parallel import spike as jspike
from emme_tpu.solvers import sparse_eigen as jse
import emme_tpu_torch as et
from emme_tpu_torch.grid import Grid
from emme_tpu_torch.ops.singularity import singularity_coeff_band
from emme_tpu_torch.parallel import mesh as mesh_mod
from emme_tpu_torch.parallel import spike
from emme_tpu_torch.solvers import sparse_eigen as se

import torch_mesh_worker as worker

torch.set_num_threads(2)

# light panel meshes, as tests/test_spike.py:21: the comparisons hold the
# same operator, so the quadrature depth only sets the cost
QUAD = {"n_shoulder": 8, "n_osc": 16, "n_tail": 4}


@pytest.fixture(scope="module")
def coll():
    """One spawn of 4 ranks: the collectives over a 4 x 1 and a 2 x 2
    mesh."""
    return mesh_mod.launch(worker.collectives, 4, "cpu", deadline=120)[0]


def _x(rank, dtype):
    return torch.arange(3).to(dtype) + complex(rank, 1)


@pytest.mark.parametrize("layout", ["4x1", "2x2"])
def test_mesh_coordinates(coll, layout):
    """Rank scan * n_rows + row holds (row, scan); axis_index agrees."""
    rows = 4 if layout == "4x1" else 2
    got = coll[layout][0]["coords"]
    assert got == [(r, r % rows, r // rows, r % rows, r // rows)
                   for r in range(4)]


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128],
                         ids=["complex64", "complex128"])
@pytest.mark.parametrize("layout,axis", [("4x1", "rows"), ("2x2", "rows"),
                                         ("2x2", "scan")])
def test_collectives_match_definitions(coll, layout, axis, dtype):
    """On every rank: all_gather stacks (tiled: concatenates) the axis'
    shards in axis order, psum sums them, broadcast gives index 0's, and
    ppermute(+1) / (-1) give the left / right neighbour's shard with zeros
    at the global edges -- exactly, on complex64 and complex128."""
    rows = 4 if layout == "4x1" else 2
    for rank, got in enumerate(coll[layout]):
        row, scan = rank % rows, rank // rows
        if axis == "rows":
            members = [scan * rows + r for r in range(rows)]
            i = row
        else:
            members = [s * rows + row for s in range(4 // rows)]
            i = scan
        xs = [_x(r, dtype) for r in members]
        g = got[f"{dtype}/{axis}"]
        assert all(t.dtype == dtype for t in g.values())
        assert torch.equal(g["gather"], torch.stack(xs))
        assert torch.equal(g["tiled"], torch.cat(xs))
        assert torch.equal(g["psum"], sum(xs))
        assert torch.equal(g["bcast"], xs[0])
        zero = torch.zeros(3, dtype=dtype)
        assert torch.equal(g["right"], xs[i - 1] if i > 0 else zero)
        assert torch.equal(g["left"], xs[i + 1] if i + 1 < len(xs) else zero)


def test_failing_rank_ends_the_launch_with_its_traceback():
    """Rank 1 raises while ranks 0 and 2 wait in a collective: the launch
    ends well inside the group timeout, kills the ranks still running and
    re-raises rank 1's exception, caused by a RuntimeError with rank 1's
    traceback (a waiting rank whose collective broke first may add its
    own)."""
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="rank 1 fails on purpose") as err:
        mesh_mod.launch(worker.fail_on_row, 3, "cpu", args=(1,), deadline=60)
    assert time.monotonic() - t0 < 30
    msg = str(err.value.__cause__)
    assert isinstance(err.value.__cause__, RuntimeError)
    assert "a rank failed" in msg and "--- rank 1 ---" in msg
    assert "ValueError: rank 1 fails on purpose" in msg


def test_deadline_kills_every_rank():
    """Ranks still running at the deadline are killed and named."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"ranks \[0, 1\] still running "
                                           r"after the deadline of 3 s"):
        mesh_mod.launch(worker.sleep, 2, "cpu", args=(600,), deadline=3)
    assert time.monotonic() - t0 < 30


def test_cuda_mesh_needs_one_card_a_rank():
    """On CUDA a launch never takes more ranks than cards, and never falls
    back to the CPU."""
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"{have + 1} ranks on CUDA need "
                                         f"{have + 1} cards .* {have} visible"):
        mesh_mod.launch(worker.sleep, have + 1, "cuda", args=(0,))


def test_make_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="initialized process group"):
        mesh_mod.make_mesh(2)


# ---------------------------------------------------------------------------
# the window assembly (no spawn: the windows of a 4-row layout, one by one)
# ---------------------------------------------------------------------------

WINDOW_CASES = {
    # name: (input, n, block, h, shards, omega)
    "tokamak": ("tokamak.json", 64, 8, 2, 4, -0.8 + 0.25j),
    "electromagnetic": ("stellarator.json", 32, 8, 3, 2, -1.656 + 2.490j),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_windows_match_global_and_jax(goldens_dir, case):
    """The windows of an S-row layout tile the port's assemble_bdia
    operator, and each equals emme_tpu's assemble_bdia_window, within
    1e-12 of the scale (test_spike.py:47-79), float64."""
    name, n, bs, h, S, om = WINDOW_CASES[case]
    cfg = dict(json.loads((goldens_dir / "inputs" / name).read_text()),
               npoints=n)
    p = et.from_config(cfg, device="cpu")
    grid = Grid.create(p.length, n, device="cpu")
    w_el = se.em_de_max(n, h, bs) if p.electromagnetic else (h + 1) * bs - 1
    cb = singularity_coeff_band(n, w_el, device="cpu")
    omt = torch.tensor(om, dtype=torch.complex128)
    op = se.assemble_bdia(p, grid, cb, omt, h, bs, quad=QUAD)
    nbl = (op.n // bs) // S
    parts = [se.assemble_bdia_window(p, grid, cb, omt, h, bs, s * nbl, nbl,
                                     quad=QUAD) for s in range(S)]
    scale = float(op.data.abs().max())
    assert float((torch.cat(parts, 1) - op.data).abs().max()) <= 1e-12 * scale

    pj = emme_tpu.from_config(cfg)
    gj = JGrid.create(pj.length, n)
    cj = jcoeff_band(n, w_el)
    for s in range(S):
        jw = np.asarray(jax.jit(lambda p_, g_, c_, s=s: jse.assemble_bdia_window(
            p_, g_, c_, jnp.complex128(om), h, bs, s * nbl, nbl, quad=QUAD))(
                pj, gj, cj))
        want = jw[:, :, 0] + 1j * jw[:, :, 1]
        assert np.abs(parts[s].numpy() - want).max() <= 1e-12 * scale


def test_window_table_chunks_cover_the_window(tokamak_cfg):
    """The window's kernel table: columns i0 .. i0 + ncols - 1, dummy pairs
    (finite, never read) where i < 0 or i + de > n - 1; with i0 = 0 and
    ncols = n the padded whole table of assemble_bdia."""
    p = et.from_config(dict(tokamak_cfg, npoints=32), device="cpu")
    grid = Grid.create(p.length, 32, device="cpu")
    a, b, _ = next(se.table_pair_chunks(grid, 5, None, None, 10 ** 6, i0=-3,
                                        ncols=12))
    assert a.shape == (5 * 12,)
    i = torch.arange(12) - 3
    eta = grid.eta
    assert torch.equal(a[:12], eta[i.clamp(0, 31)])
    assert torch.equal(b[3:12], eta[i[3:] + 1])
    assert torch.equal(b[:3], eta[0].expand(3) + grid.dx)
    whole = next(se.table_pair_chunks(grid, 5, None, None, 10 ** 6))
    same = next(se.table_pair_chunks(grid, 5, None, None, 10 ** 6, i0=0,
                                     ncols=32))
    assert all(torch.equal(x, y) for x, y in zip(whole[:2], same[:2]))


# ---------------------------------------------------------------------------
# the block-tridiagonal reduced algebra
# ---------------------------------------------------------------------------

def test_block_tridiag_selected_inverse():
    """_bt_factor / _bt_solve / _bt_z_band on a random unit-diagonal
    block-tridiagonal complex matrix (S = 5 blocks of 6) against the dense
    inverse and emme_tpu's plane form, 1e-10 (test_spike.py:272-322)."""
    rng = np.random.default_rng(3)
    S, n2 = 5, 6

    def cplx(shape):
        return 0.3 * rng.normal(size=shape) + 0.3j * rng.normal(size=shape)

    Rsup, Rsub = cplx((S - 1, n2, n2)), cplx((S - 1, n2, n2))
    b = cplx((S, n2, 3)) / 0.3
    t = [torch.as_tensor(a) for a in (Rsup, Rsub, b)]
    D, Ebar = spike._bt_factor(t[0], t[1])
    x = spike._bt_solve(t[0], t[1], D, t[2]).numpy()
    Z = [z.numpy() for z in spike._bt_z_band(t[0], t[1], D, Ebar)]

    Rd = np.eye(S * n2, dtype=np.complex128)
    for s in range(S - 1):
        Rd[s * n2:(s + 1) * n2, (s + 1) * n2:(s + 2) * n2] = Rsup[s]
        Rd[(s + 1) * n2:(s + 2) * n2, s * n2:(s + 1) * n2] = Rsub[s]
    inv = np.linalg.inv(Rd)

    def blk(i, j):
        return inv[i * n2:(i + 1) * n2, j * n2:(j + 1) * n2]

    assert np.abs(x.reshape(-1, 3) - np.linalg.solve(
        Rd, b.reshape(-1, 3))).max() < 1e-10
    Zd, Zsup1, Zsub1, Zsup2, Zsub2 = Z
    for s in range(S):
        assert np.abs(Zd[s] - blk(s, s)).max() < 1e-10
    for s in range(S - 1):
        assert np.abs(Zsup1[s] - blk(s, s + 1)).max() < 1e-10
        assert np.abs(Zsub1[s] - blk(s + 1, s)).max() < 1e-10
    for s in range(S - 2):
        assert np.abs(Zsup2[s] - blk(s, s + 2)).max() < 1e-10
        assert np.abs(Zsub2[s] - blk(s + 2, s)).max() < 1e-10

    def planes(a):
        return [np.stack([z.real, z.imag]) for z in a]

    jD, jE = jspike._bt_factor(planes(Rsup), planes(Rsub), S, n2,
                               jnp.float64)
    jZ = jspike._bt_z_band(planes(Rsup), planes(Rsub), jD, jE, S)
    jx = jspike._bt_solve(planes(Rsup), planes(Rsub), jD, planes(b), S)
    jx = np.asarray(jx)
    assert np.abs(x - (jx[:, 0] + 1j * jx[:, 1])).max() < 1e-10
    for mine, ref in zip(Z, jZ):
        ref = np.asarray(ref)
        assert np.abs(mine - (ref[:, 0] + 1j * ref[:, 1])).max() < 1e-10


def test_reduced_algebra_one_shard_is_identity():
    """With one shard there is no interface: R = I, the correction solve
    returns its right-hand side and the selected inverse is I."""
    E = torch.zeros((1, 4, 4), dtype=torch.complex128)
    G = torch.randn((1, 8, 8), dtype=torch.complex128)
    Rsup, Rsub = spike._reduced_tridiag(E, G, 1, 4)
    assert Rsup.shape == Rsub.shape == (0, 8, 8)
    D, Ebar = spike._bt_factor(Rsup, Rsub)
    b = torch.randn((1, 8, 2), dtype=torch.complex128)
    assert torch.equal(spike._bt_solve(Rsup, Rsub, D, b), b)
    Zd, *rest = spike._bt_z_band(Rsup, Rsub, D, Ebar)
    assert torch.equal(Zd[0], torch.eye(8, dtype=torch.complex128))
    assert all(z.shape[0] == 0 for z in rest)
