"""The driver's reference-exact backend on EMME's electromagnetic
stellarator input (``eigen_backend`` "exact": G15K31, moments 0, 1 and 2,
the electron closed forms, a 2N x 2N operator) on the CPU, where kernel
N1's plain version runs, and the benchmark's plain adaptive
electromagnetic reference (``portbench/reference/adaptive_em.py``) that
judges it: against the reference's golden stel32 operator, against the
program's own adaptive assembly, the reference's own Newton iteration, and
the dense backend's eigenvector convention.  npoints 32 throughout, from a
guess 0.01 off the stel32 root in Re and Im (the input's own guess takes
17 steps there)."""
import json

import numpy as np
import pytest
import torch

import emme_tpu_torch as et
from emme_tpu_torch import driver, native
from emme_tpu_torch.ops import adaptive, cuda_adaptive
from emme_tpu_torch.ops.singularity import singularity_coeff_matrix
from portbench.reference import adaptive_em as ref

GUESS = complex(-0.474, 0.627)
INPUT_GUESS = complex(-1.656, 2.49)


@pytest.fixture
def cfg(stellarator_cfg):
    return dict(stellarator_cfg, npoints=32, eigen_backend="exact")


@pytest.fixture(scope="module")
def reference_root(stellarator_cfg):
    """The reference's own float64 TraceSecant from ``GUESS``."""
    inp = dict(stellarator_cfg, npoints=32)
    omega, _v, steps = ref.trace_secant(inp, GUESS, 1e-6, 100)
    return omega, steps


def _exact(cfg, guess=GUESS, **kw):
    return driver.solve_once_eigen(cfg, guess, dtype=torch.float64,
                                   device="cpu", **kw)


def _vec(res):
    v = np.array(res["eigenvector"])
    return v[:, 0] + 1j * v[:, 1]


def test_reference_matches_the_golden_operator(goldens_dir, cfg):
    """The whole 64 x 64 stel32 operator at the input's guess within 1e-10
    of its scale, the bar the port's own engine meets there
    (tests/test_torch_native.py).  Every integral of stel32 accepts its
    first panel, in the reference as in the engine, so no acceptance test
    is near its threshold and no entry needs another bar."""
    M, (_a, _b, _m, panels) = ref.rows(cfg, range(64), INPUT_GUESS,
                                       with_panels=True)
    gold = np.fromfile(goldens_dir / "matrix_stel32_guess.bin",
                       dtype=np.complex128).reshape(64, 64)
    assert M.shape == (64, 64) and len(panels) == 3 * 32 * 31 // 2
    assert bool((panels == 1).all())
    assert np.abs(M.numpy() - gold).max() < 1e-10 * np.abs(gold).max()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_rows_match_the_program_assembly(cfg, seed):
    """Seeded omega near the guess: the reference's rows from both blocks
    (4 phi rows, 4 A_par rows) against the program's ``native.assemble``.
    Both run the engine's integrals to the same tolerances and take the
    same panels, so they differ by rounding alone: 1e-12 of the operator's
    scale."""
    rng = np.random.default_rng(seed)
    omega = GUESS + complex(rng.uniform(-0.05, 0.05),
                            rng.uniform(-0.05, 0.05))
    rows = np.concatenate([rng.choice(32, 4, replace=False),
                           32 + rng.choice(32, 4, replace=False)])
    got = ref.rows(cfg, rows, omega)
    p = et.from_config(cfg, device="cpu")
    M = native.assemble(p, singularity_coeff_matrix(32, device="cpu"), omega)
    want = M[torch.as_tensor(rows)]
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-12 * scale


def test_reference_takes_the_programs_panels(cfg):
    """Each (pair, moment) integral's panel count in the reference equals
    that of N1's plain version at the same point: no acceptance flip."""
    rows = [0, 7, 31, 32, 40, 63]
    _M, (a, b, m, panels) = ref.rows(cfg, rows, GUESS, with_panels=True)
    assert set(m.tolist()) == {0, 1, 2}
    p = et.from_config(cfg, device="cpu")
    pr, pm, _grid, ph = native.pair_integrals(p, a, b)
    _v, got, _miller = cuda_adaptive.integrate(pr, pm,
                                               adaptive.scalars(ph, GUESS))
    got = got.reshape(-1, 3).gather(1, m[:, None])[:, 0]
    assert torch.equal(got.to(panels.dtype), panels)


def test_reference_rows_use_each_blocks_moments():
    """A phi row uses moments 0 and 1 of its pairs, an A_par row 1 and 2;
    the integrals of two rows of one grid point are shared."""
    (_a, _b, m), _ = ref.row_items(8, [3])
    assert sorted(m.tolist()) == [0] * 7 + [1] * 7
    (_a, _b, m), _ = ref.row_items(8, [11])
    assert sorted(m.tolist()) == [1] * 7 + [2] * 7
    (_a, _b, m), _ = ref.row_items(8, [3, 11])
    assert sorted(m.tolist()) == [0] * 7 + [1] * 7 + [2] * 7


def test_reference_refuses_an_electrostatic_input(tokamak_cfg):
    with pytest.raises(ValueError, match="electrostatic"):
        ref.rows(dict(tokamak_cfg, npoints=8), [0], -0.8 + 0.25j)


def test_exact_backend_meets_the_references_newton(cfg, reference_root):
    """Through the driver from the same guess: the reference's own omega
    to 1e-9 relative, the dense backend's result fields with a 2N
    eigenvector, and the eigenpair at the float64 floor of 8 rows of both
    blocks of the reference's operator."""
    res, omega = _exact(cfg)
    want, steps = reference_root
    assert abs(omega - want) / abs(want) < 1e-9
    assert abs(res["iteration_steps"] - steps) <= 1
    assert set(res) == {"eigenvalue", "eigenvector", "iteration_steps",
                        "quadrature_guard"}
    v = _vec(res)
    assert v.shape == (64,)
    got = ref.row_check(cfg, omega, v, [0, 9, 17, 30, 33, 41, 50, 62])
    assert got["residual"] < 1e-12 and got["omega_gap"] < 1e-10, got


def test_exact_backend_from_an_input_file(tmp_path, cfg, reference_root):
    """``driver.run`` reaches the engine from an input file that sets the
    key, and writes the result and the 64 x 64 complex128 operator."""
    path = tmp_path / "input.json"
    path.write_text(json.dumps(dict(cfg, initial_guess=[GUESS.real,
                                                        GUESS.imag])))
    out = driver.run(str(path), output_dir=tmp_path, device="cpu",
                     verbose=False)
    res = out["result"]["(None)"]["scan_result"][0]
    omega = complex(*res["eigenvalue"])
    want, _steps = reference_root
    assert abs(omega - want) / abs(want) < 1e-9
    assert len(res["eigenvector"]) == 64
    assert res["quadrature_guard"]["run"] is False
    M = np.fromfile(tmp_path / "eigenMatrics" / "eigenMatrix.bin",
                    dtype=np.complex128)
    assert M.size == 64 * 64


def test_exact_eigenvector_is_the_dense_backends(cfg):
    """The 2N eigenvector in the dense backend's convention (phi then
    A_par, the reference's conjugated null vector): the dense float64
    backend (its tiered panel meshes, no guard) from the exact omega gives
    the same vector up to a phase, to the two operators' quadrature
    difference (~3e-5); its conjugate is far."""
    res, omega = _exact(cfg)
    dense, _ = driver.solve_once_eigen(
        dict(cfg, eigen_backend="dense", quad_tiered=True, quad_guard="off"),
        omega, dtype=torch.float64, device="cpu")
    a, b = _vec(res), _vec(dense)
    assert abs(np.linalg.norm(a) - 1.0) < 1e-12
    assert abs(np.linalg.norm(b) - 1.0) < 1e-12
    c = np.vdot(b, a)
    assert np.linalg.norm(a - c / abs(c) * b) < 1e-3
    c = np.vdot(b.conj(), a)
    assert np.linalg.norm(a - c / abs(c) * b.conj()) > 0.1
