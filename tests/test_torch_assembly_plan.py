"""The dense assembly's routes on the CPU: the kernels' plan
(``eigen.assembly_plan``, ``ops/cuda_assembly.py``) against the torch it
replaces, the CPU's torch route and its counter, and the mesh-sharded
assembly, which keeps the torch route's parts.  Kernels P and Q themselves
run on a card only (``tests/test_torch_cuda.py``)."""
import json
import pathlib

import pytest
import torch

import emme_tpu_torch as et
from emme_tpu_torch.grid import Grid
from emme_tpu_torch.ops import cuda_assembly, cuda_kappa, kernels
from emme_tpu_torch.ops.singularity import singularity_coeff_matrix
from emme_tpu_torch.parallel import sharded
from emme_tpu_torch.solvers import eigen

torch.set_num_threads(2)

INPUTS = pathlib.Path(__file__).resolve().parent / "goldens" / "inputs"
CASES = {"tokamak": (-0.8 + 0.25j, 64), "stellarator": (-1.656 + 2.49j, 48)}


def _case(name, dtype=torch.float32, n=None):
    om, n_default = CASES[name]
    n = n or n_default
    with open(INPUTS / f"{name}.json") as f:
        cfg = dict(json.load(f), npoints=n)
    p = et.from_config(cfg, dtype=dtype, device="cpu")
    grid = Grid.create(p.length, n, dtype=dtype, device="cpu")
    coeff = singularity_coeff_matrix(n, dtype=dtype, device="cpu")
    tiers = kernels.tier_thresholds_ij(float(grid.dx), n)
    return p, grid, coeff, tiers, torch.tensor(om, dtype=torch.complex64)


def _pair_rows(plan, t):
    """Tier ``t``'s pair rows [d_eta, beta1, bi(eta), bi(eta')] gathered
    from the plan's point rows, as kernel P forms them."""
    eta, g, bi = plan.points
    beta1 = plan.scalars[cuda_assembly.SCALARS.index("beta1")]
    return torch.stack([eta[t.iu] - eta[t.ju], beta1 * (g[t.iu] - g[t.ju]),
                        bi[t.iu], bi[t.ju]], dim=1)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_pair_rows_equal_prepare(name):
    """Each tier's pair rows gathered from the plan's point rows (g(eta)
    and bi(eta) at the grid's points, beta1's factor) equal
    ``cuda_kappa._prepare``'s bit for bit; the plan keeps the tiers'
    pairs, G-K order and panel counts, and 16-byte pair rows."""
    p, grid, _coeff, tiers, om = _case(name)
    plan = eigen.assembly_plan(p, grid, None, tiers)
    groups = eigen.pair_plan(grid.npoints, tiers, "cpu")["groups"]
    assert len(plan.tiers) == len(groups) >= 2
    assert plan.ms == ((0, 1, 2) if name == "stellarator" else (0,))
    for t, (iu, ju, spec) in zip(plan.tiers, groups):
        quad = kernels.scaled_quad(None, torch.float32, spec)
        mid, halfw, pair, scal, order = cuda_kappa._prepare(
            p, grid.eta[iu], grid.eta[ju], om, quad)
        assert torch.equal(t.iu, iu) and torch.equal(t.ju, ju)
        assert t.order == order and mid.shape == (t.npairs, t.n_panels)
        assert t.counts == tuple(quad[k] for k in ("n_shoulder", "n_osc",
                                                   "n_tail"))
        assert t.pair % 4 == 0 and t.halfw == t.mid + t.npairs * t.n_panels
        assert torch.equal(_pair_rows(plan, t), pair)
        assert torch.equal(plan.scalars[:5], scal[2:7])
    ends = [t.pair + 4 * t.npairs for t in plan.tiers]
    assert plan.size == ends[-1]
    assert all(b.mid == e for b, e in zip(plan.tiers[1:], ends))


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_route_counts_torch_and_keeps_m(name):
    """On the CPU every dense assembly takes the torch route, counted once
    in ``ASSEMBLY_ROUTE["torch"]``, and M is the torch route's, bit for
    bit: ``_tiered_pair_values`` (K1's plain version) placed by
    ``_materialize_from_pairs``."""
    p, grid, coeff, tiers, om = _case(name)
    assert not eigen.kernel_route(p, grid, True)
    before = dict(eigen.ASSEMBLY_ROUTE)
    M = eigen.assemble_matrix(p, grid, coeff, om, tiers=tiers, fused=True)
    assert eigen.ASSEMBLY_ROUTE == {"kernels": before["kernels"],
                                    "torch": before["torch"] + 1}
    pp = eigen.pair_plan(grid.npoints, tiers, "cpu")
    iu, ju = pp["iu"], pp["ju"]
    ms = (0, 1, 2) if p.electromagnetic else (0,)
    vals = eigen._tiered_pair_values(p, grid, om, pp, ms, None, 2048, True)
    want = eigen._materialize_from_pairs(p, grid, coeff, vals,
                                         (grid.eta[iu], grid.eta[ju]),
                                         (iu, ju), om)
    assert M.dtype == torch.complex64 and torch.equal(M, want)


def test_kernel_route_needs_card_float32_and_k1():
    """The kernels take an assembly only with K1 (``fused``), a CUDA grid
    and float32 grid and parameters; here, on the CPU, never, and P
    refuses a plan on the CPU."""
    p, grid, _coeff, _tiers, om = _case("tokamak", n=16)
    p64, grid64, *_ = _case("tokamak", torch.float64, n=16)
    assert not eigen.kernel_route(p, grid, True)
    assert not eigen.kernel_route(p, grid, False)
    assert not eigen.kernel_route(p64, grid64, True)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_assembly.inputs(eigen.assembly_plan(p, grid), om)


@pytest.mark.parametrize("name", sorted(CASES))
def test_untiered_plan_is_one_tier_on_quad(name):
    """Without tiers (``arnoldi``, ``host64_polish`` through a solve
    without them) the plan is one tier of every pair on ``quad``'s mesh,
    as ``_prepare`` reads it."""
    p, grid, _coeff, _tiers, om = _case(name, n=24)
    quad = {"n_osc": 20, "n_tail": 3}
    plan = eigen.assembly_plan(p, grid, quad, None)
    (t,) = plan.tiers
    assert t.npairs == 24 * 23 // 2
    mid, _halfw, pair, _scal, order = cuda_kappa._prepare(
        p, grid.eta[t.iu], grid.eta[t.ju], om, quad)
    assert t.counts == (8, 20, 3) and t.order == order
    assert mid.shape == (t.npairs, t.n_panels)
    assert torch.equal(_pair_rows(plan, t), pair)
    with pytest.raises(ValueError, match="tiers"):
        cuda_assembly.build_plan(p, grid, [])


class _OneRank:
    """A one-rank mesh: its gather of a rank's share is the share."""
    n_rows = 1
    row = 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_assembly_keeps_torch_parts(name, monkeypatch):
    """``parallel/sharded.py`` assembles from ``eigen._pair_values`` and
    ``_materialize_from_pairs`` itself: on one rank its M equals the
    untiered torch route's bit for bit, and no assembly is counted."""
    p, grid, coeff, _tiers, om = _case(name, n=24)
    monkeypatch.setattr(sharded.mesh_mod, "all_gather",
                        lambda x, mesh, tiled=False: x)
    before = dict(eigen.ASSEMBLY_ROUTE)
    M = sharded.sharded_assemble(p, grid, coeff, om, _OneRank(), fused=True)
    assert eigen.ASSEMBLY_ROUTE == before
    want = eigen.assemble_matrix(p, grid, coeff, om, fused=True)
    assert torch.equal(M, want)
