"""Newton-walk trajectory parity of the port against the C++ reference
(tests/goldens/trajectories.json), as tests/test_trajectory.py holds the
JAX package: the electromagnetic stellarator's QRSecant walk, step for
step."""
import json

import pytest
import torch

import emme_tpu_torch as et
from emme_tpu_torch.solvers import eigen

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def trajectories(goldens_dir):
    with open(goldens_dir / "trajectories.json") as f:
        return json.load(f)


def test_stellarator_em_qr_secant_walk(stellarator_cfg, trajectories):
    """stel32, float64, method="QRSecant" from the golden's guess (near the
    fixed point: from the canonical guess the reference itself diverges at
    n = 32): every step within 1e-4 of the reference walk, the JAX bar
    (tests/test_trajectory.py:118-131, 140-144), and as many steps."""
    golden = trajectories["stel32_QRSecant"]
    p = et.from_config(dict(stellarator_cfg, npoints=32), device="cpu")
    walk = []
    om, _, n_steps, _ = eigen.solve(
        p, complex(*golden["guess"]), tol=1e-6, chunk=64, method="QRSecant",
        callback=lambda j, s: walk.append(complex(s.omega)))
    ref = [complex(a, b) for a, b in golden["steps"]]
    assert len(walk) == len(ref) == n_steps
    for k, (w, r) in enumerate(zip(walk, ref)):
        assert abs(w - r) / abs(r) < 1e-4, (k, w, r)
    assert om == walk[-1]
