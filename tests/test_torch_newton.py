"""The eigen backends' shared pieces on the CPU: ``eigen.discretization``
(the tier table and K1 route every backend assembles with) and the
complex128 polish of ``newton.py`` through its dense and banded adapters,
held to pinned values."""
import json

import pytest
import torch

import emme_tpu_torch as et
from emme_tpu_torch.grid import Grid
from emme_tpu_torch.ops import kernels
from emme_tpu_torch.ops.singularity import (singularity_coeff_band,
                                            singularity_coeff_matrix)
from emme_tpu_torch.solvers import eigen, newton, sparse_eigen as se


@pytest.fixture(scope="module")
def tok32(goldens_dir):
    with open(goldens_dir / "inputs" / "tokamak.json") as f:
        cfg = dict(json.load(f), npoints=32)
    return et.from_config(cfg, dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("dtype, tiered, fused, want_tiers, want_fused", [
    (torch.float32, None, None, True, True),
    (torch.float64, None, None, False, False),
    (torch.float32, False, False, False, False),
    (torch.float32, True, False, True, False),
    (torch.float64, True, None, True, False),
    (torch.float64, False, False, False, False),
    (torch.float64, None, True, None, None),
])
def test_discretization(tok32, dtype, tiered, fused, want_tiers,
                        want_fused):
    """Both switches default on for float32 and off for float64; the tier
    table is ``tier_thresholds_ij`` at 2 length / (n - 1); K1 asked for
    with float64 raises."""
    if want_tiers is None:
        with pytest.raises(ValueError, match="float32-only"):
            eigen.discretization(tok32, dtype, tiered, fused)
        return
    reads = newton.HOST_READS["blocking"]
    tiers, got_fused = eigen.discretization(tok32, dtype, tiered, fused)
    assert got_fused is want_fused
    dx = 2.0 * float(tok32.length) / (32 - 1)
    assert tiers == (kernels.tier_thresholds_ij(dx, 32) if want_tiers
                     else None)
    assert newton.HOST_READS["blocking"] == reads


# (omega, steps, v[0], v[7], v[-1], sum(v)) of each polish from the float32
# tok32 state seeded at -0.574 + 0.274i, K1's plain version, tol 1e-6
PINNED = {
    "dense": ((-0.5742271224833405 + 0.2743043409691774j), 4,
              (-1.576186374741837e-05 + 1.6291887031552682e-05j),
              (0.0016924943118197208 - 5.879543281615365e-05j),
              (-8.771283026973729e-06 + 7.628792136084691e-06j),
              (2.0353435921061083 + 0.28993702988329106j)),
    "banded": ((-0.5742261238507423 + 0.27430482031375975j), 4,
               (-2.2847737070293312e-05 + 5.258058632741282e-06j),
               (0.0015303635180591553 + 0.0007318027928620223j),
               (-1.1753462939234192e-05 + 2.1093019275656636e-06j),
               (1.4248458568728894 + 1.4808275298897529j)),
}


@pytest.mark.parametrize("backend", sorted(PINNED))
def test_polish_adapters_keep_their_answers(tok32, backend):
    """``eigen.host64_polish`` and ``sparse_eigen.host64_polish_banded`` at
    tok32: the pinned omega (1e-13 relative), step count and complex128
    unit vector (1e-12); each counts its assemblies and blocking reads."""
    p = tok32
    f32 = torch.float32
    grid = Grid.create(p.length, 32, dtype=f32, device="cpu")
    om0 = torch.tensor(-0.574 + 0.274j, dtype=torch.complex64)
    if backend == "dense":
        coeff = singularity_coeff_matrix(32, dtype=f32, device="cpu")
        state = eigen.init_state(p, grid, coeff, om0, fused=True)
        assemble = eigen.assembler(p, grid, coeff, fused=True)
        polish = eigen.host64_polish
    else:
        cb = singularity_coeff_band(32, 15, dtype=f32, device="cpu")
        state = se.init_state(p, grid, cb, om0, 1, 8, fused=True)
        assemble = se.assembler(p, grid, cb, 1, 8, fused=True)
        polish = se.host64_polish_banded
    newton.HOST_READS.update(blocking=0, flag_polls=0)
    omega, v, steps = polish(state, assemble, 1e-6)
    om_want, steps_want, *entries = PINNED[backend]
    assert abs(omega - om_want) <= 1e-13 * abs(om_want)
    assert steps == steps_want
    assert v.dtype == torch.complex128 and v.shape == (32,)
    assert abs(float(torch.linalg.vector_norm(v)) - 1.0) < 1e-12
    for got, want in zip((v[0], v[7], v[-1], v.sum()), entries):
        assert abs(complex(got) - want) <= 1e-12
    # one read of omega, one of the bilinears a step
    assert newton.HOST_READS == {"blocking": 1 + steps, "flag_polls": 0}
    assert newton.LAST_SOLVE["polish_assemblies"] == steps - 1
