"""The driver's reference-exact backend (``eigen_backend`` "exact":
``driver.solve_once_eigen`` -> ``eigen_native.solve``) on the CPU, where
kernel N1's plain version runs, and the benchmark's plain adaptive
reference (``portbench/reference/adaptive.py``) that judges it: against
the reference's golden tok32 operator and eigenvalue, against the
program's own adaptive assembly, and the backend's rules (float64 only, no
mesh, no quadrature guard, the dense backend's result and eigenvector
convention).  npoints 32 throughout."""
import json

import numpy as np
import pytest
import torch

import emme_tpu_torch as et
from emme_tpu_torch import driver, native
from emme_tpu_torch.ops import linalg
from emme_tpu_torch.ops.singularity import singularity_coeff_matrix
from emme_tpu_torch.parallel import mesh as mesh_mod
from emme_tpu_torch.solvers import eigen
from portbench.reference import adaptive as ref

GUESS = -0.8 + 0.25j


@pytest.fixture
def cfg(tokamak_cfg):
    return dict(tokamak_cfg, npoints=32, eigen_backend="exact")


def _exact(cfg, **kw):
    return driver.solve_once_eigen(cfg, GUESS, dtype=torch.float64,
                                   device="cpu", **kw)


def test_reference_matches_the_golden_operator(goldens_dir, cfg):
    """The whole tok32 operator at the guess within the bars the port's
    own engine is held to there (tests/test_torch_native.py)."""
    M = ref.assemble(cfg, GUESS).numpy()
    gold = np.fromfile(goldens_dir / "matrix_tok32_guess.bin",
                       dtype=np.complex128).reshape(32, 32)
    d = np.abs(M - gold)
    assert d.max() < 5e-9
    assert np.median(d) < 1e-11


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_rows_match_the_program_assembly(cfg, seed):
    """Seeded eta_i and omega: the reference's rows against the program's
    ``native.assemble``.  Both run the engine's adaptive integrals to the
    same tolerances, so they take the same panels and differ by rounding
    alone (summation order, torch's against the engine's complex
    arithmetic): 1e-12 of the operator's scale.  One acceptance decision
    taken the other way moves an entry by ~1e-7 and would fail it."""
    rng = np.random.default_rng(seed)
    cfg = dict(cfg, eta_i=float(rng.uniform(2.9, 3.4)))
    omega = complex(rng.uniform(-0.9, -0.5), rng.uniform(0.2, 0.35))
    rows = rng.choice(32, 6, replace=False)
    got = ref.rows(cfg, rows, omega)
    p = et.from_config(cfg, device="cpu")
    M = native.assemble(p, singularity_coeff_matrix(32, device="cpu"), omega)
    want = M[torch.as_tensor(rows)]
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("method", ["TraceSecant", "QRSecant"])
def test_exact_backend_reaches_the_golden(cfg, golden_eigenvalues, method):
    """Through the driver, the tok32 golden omega at the engine's bar (1e-9
    relative, tests/test_torch_native.py), with the dense backend's
    result fields and a null vector of the converged operator."""
    res, omega = _exact(dict(cfg, iteration_method=method))
    gold = golden_eigenvalues["tok32"]
    assert abs(omega - complex(*gold["omega"])) / abs(omega) < 1e-9
    assert res["eigenvalue"] == [omega.real, omega.imag]
    assert res["iteration_steps"] <= gold["steps"] + 1
    dense, _ = driver.solve_once_eigen(dict(cfg, eigen_backend="dense"),
                                       GUESS, dtype=torch.float64,
                                       device="cpu")
    assert set(res) == set(dense)
    v = np.array(res["eigenvector"])
    assert v.shape == (32, 2)
    checked = ref.row_check(cfg, omega, v[:, 0] + 1j * v[:, 1], range(32))
    assert checked["residual"] < 1e-10 and checked["omega_gap"] < 1e-10


def test_exact_backend_from_an_input_file(tmp_path, cfg, golden_eigenvalues):
    """``driver.run`` reaches the engine from an input file that sets the
    key, and writes the result and the complex128 operator."""
    path = tmp_path / "input.json"
    path.write_text(json.dumps(cfg))
    out = driver.run(str(path), output_dir=tmp_path, device="cpu",
                     verbose=False)
    res = out["result"]["(None)"]["scan_result"][0]
    omega = complex(*res["eigenvalue"])
    gold = complex(*golden_eigenvalues["tok32"]["omega"])
    assert abs(omega - gold) / abs(gold) < 1e-9
    assert res["quadrature_guard"]["run"] is False
    assert (tmp_path / "output.json").exists()
    M = np.fromfile(tmp_path / "eigenMatrics" / "eigenMatrix.bin",
                    dtype=np.complex128)
    assert M.size == 32 * 32


def test_exact_eigenvector_is_the_dense_backends(cfg, monkeypatch):
    """Both backends take the null vector through
    ``linalg.null_space_vector`` (the exact one by inverse iteration on
    M^H M, the dense one by its CPU default, the SVD), in the reference's
    conjugated convention: the exact and the dense float64 eigenvectors
    agree up to a phase, to the dense backend's quadrature error."""
    calls = []
    nsv = linalg.null_space_vector

    def counted(M, method=None):
        calls.append(method)
        return nsv(M, method)
    monkeypatch.setattr(linalg, "null_space_vector", counted)
    res, _ = _exact(cfg)
    dense, _ = driver.solve_once_eigen(dict(cfg, eigen_backend="dense"),
                                       GUESS, dtype=torch.float64,
                                       device="cpu")
    assert calls == ["singular", None]
    a, b = (np.array(r["eigenvector"]) for r in (res, dense))
    a, b = a[:, 0] + 1j * a[:, 1], b[:, 0] + 1j * b[:, 1]
    assert abs(np.linalg.norm(a) - 1.0) < 1e-12
    assert abs(np.linalg.norm(b) - 1.0) < 1e-12
    assert abs(abs(np.vdot(a, b)) - 1.0) < 1e-6


def test_exact_backend_is_float64_only(cfg):
    with pytest.raises(ValueError, match="float64"):
        driver.solve_once_eigen(cfg, GUESS, dtype=torch.float32,
                                device="cpu")


def test_exact_backend_has_no_mesh_form(cfg):
    mesh = mesh_mod.Mesh(1, 1, 0, 0, None, None, (0,), (0,),
                         torch.device("cpu"))
    with pytest.raises(ValueError, match="mesh"):
        driver.solve_once_eigen(cfg, GUESS, dtype=torch.float64,
                                device="cpu", mesh=mesh)


def test_exact_backend_runs_no_guard(cfg, monkeypatch):
    """Whatever ``quad_guard`` says: the guard tests static panel meshes,
    which the adaptive backend never uses; the result says it did not
    run."""
    def refuse(*_a, **_k):
        raise AssertionError("the quadrature guard ran")
    monkeypatch.setattr(eigen, "quadrature_guard", refuse)
    for mode in ("warn", "refine"):
        res, _ = _exact(dict(cfg, quad_guard=mode))
        assert res["quadrature_guard"]["run"] is False
