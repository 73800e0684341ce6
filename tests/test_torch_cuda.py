"""Kernel K1 on an NVIDIA GPU: the CUDA kernel vs its plain PyTorch version,
and the float32 solve through it.  Every test here needs a card and skips
without one.

This file imports torch, numpy and the port only, so it also runs on a
machine with a card and without JAX (tests/conftest.py imports JAX):

    python -m pytest --noconftest -o addopts="" -q tests/test_torch_cuda.py -m cuda
"""
import json
import pathlib

import pytest
import torch

import emme_tpu_torch as et
from emme_tpu_torch.grid import Grid
from emme_tpu_torch.ops import cuda_kappa, kernels
from emme_tpu_torch.solvers import eigen

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
    through K1 (tiers x (2 + steps) launches) and omega lands within 1e-5
    of golden tok128."""
    p = et.from_config(_cfg("tokamak", 128), dtype=torch.float32, device=card)
    dx = 2.0 * float(p.length) / (p.npoints - 1)
    n_tiers = len(kernels.tier_thresholds_ij(dx, p.npoints))
    before = cuda_kappa.LAUNCHES
    om, vec, n_steps, state = eigen.solve(p, -0.8 + 0.25j, tol=1e-5)
    assert cuda_kappa.LAUNCHES - before == n_tiers * (2 + n_steps)
    assert state.M.is_cuda and vec.is_cuda
    assert abs(om - GOLDEN_TOK128) / abs(GOLDEN_TOK128) < 1e-5
