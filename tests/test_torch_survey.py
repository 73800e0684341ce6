"""The multi-shift survey of the port (``arnoldi.solve_shifts_batched``) at
tok32 on the CPU: against the benchmark's plain reference
(``portbench/reference/survey.py``), against the estimates it gave before
it opened spans and counted its work, and its counter
(``arnoldi.SURVEY_ROUTE``)."""
import hashlib

import numpy as np
import pytest
import torch

import emme_tpu_torch as et
from emme_tpu_torch.solvers import arnoldi, eigen
from portbench.reference import operator as ref_op
from portbench.reference import survey as ref

N = 32
M_KRYLOV = 24

# a seeded scan point and four seeded shifts around the ITG branch, drawn
# as the survey cell draws them (eta_i on [2.9, 3.4], shifts -0.8+0.25j +
# 0.15 (N(0,1) + i N(0,1)))
_RNG = np.random.default_rng(23)
ETA_I = float(2.9 + 0.5 * _RNG.random())
SHIFTS = -0.8 + 0.25j + 0.15 * (_RNG.normal(size=4) + 1j * _RNG.normal(size=4))

# SHA-256 (first 16 hex digits) of the estimates (complex128) at ETA_I and
# SHIFTS, from the survey before it opened spans and counted its work
PARENT_ESTIMATES = {torch.float64: "41488198312457be",
                    torch.float32: "e92df49ba8fcb820"}


def _cfg(tokamak_cfg):
    return dict(tokamak_cfg, npoints=N, eta_i=ETA_I)


@pytest.fixture(scope="module")
def surveys(tokamak_cfg):
    """One survey of SHIFTS at tok32 a dtype: {dtype: (estimates, the
    counters' increments)}."""
    out = {}
    for dtype in PARENT_ESTIMATES:
        p = et.from_config(_cfg(tokamak_cfg), dtype=dtype, device="cpu")
        route = dict(arnoldi.SURVEY_ROUTE)
        assemblies = dict(eigen.ASSEMBLY_ROUTE)
        ests = arnoldi.solve_shifts_batched(p, SHIFTS, m_krylov=M_KRYLOV)
        out[dtype] = (ests,
                      {k: arnoldi.SURVEY_ROUTE[k] - route[k] for k in route},
                      {k: eigen.ASSEMBLY_ROUTE[k] - assemblies[k]
                       for k in assemblies})
    return out


DTYPES = pytest.mark.parametrize("dtype", list(PARENT_ESTIMATES),
                                 ids=["float64", "float32"])


@DTYPES
def test_survey_estimates_are_the_parents(surveys, dtype):
    """Bit for bit the estimates of the survey before its spans and its
    counter, in float64 (the torch integrand) and float32 (K1's plain
    version on the CPU)."""
    ests = surveys[dtype][0]
    assert ests.dtype == np.complex128 and ests.shape == (len(SHIFTS),)
    digest = hashlib.sha256(np.ascontiguousarray(ests).tobytes())
    assert digest.hexdigest()[:16] == PARENT_ESTIMATES[dtype]


@DTYPES
def test_survey_route_counts_its_work(surveys, dtype):
    """One survey of S shifts counts 1 / S / 2S / S (surveys, shifts,
    assemblies, plans asked for), and the dense assembly counts its 2S
    assemblies on the torch route, the CPU's."""
    _, route, assemblies = surveys[dtype]
    s = len(SHIFTS)
    assert route == {"surveys": 1, "shifts": s, "assemblies": 2 * s,
                     "plans": s}
    assert assemblies == {"kernels": 0, "torch": 2 * s}


def test_survey_matches_the_plain_reference(surveys, tokamak_cfg):
    """The float64 survey against the plain reference's on the same graded
    float64 panel mesh (``operator.MESH["float64"]``, the mesh the
    program's torch integrand takes): the two differ in the order of their
    operations alone, which the secant carries a hundredfold and the
    shift-invert sweep by the nearest eigenvalue's distance; they part by
    2e-15 relative, so 1e-12 holds them to rounding, far under the check's
    float32 readings and its TF32 control (1e-3)."""
    ests = surveys[torch.float64][0]
    cfg = _cfg(tokamak_cfg)
    for s, e in zip(SHIFTS, ests):
        want = ref.estimate(cfg, s, M_KRYLOV, dtype=torch.float64,
                            mesh=ref_op.MESH["float64"])
        assert abs(e - want) <= 1e-12 * abs(want), (s, e, want)
