"""emme_tpu_torch.driver against emme_tpu.driver and the reference goldens
on the CPU: the scan walk, fault capture, checkpoint / resume, the parallel
scan, one whole run of both packages at tok32, the eta_i scan, the sparse
backend, PIC through the driver, what the port does not take
(pic_sorted) and the mesh's argument checks (the mesh paths themselves:
tests/test_torch_mesh_*.py).  float64 unless said; every call of the port names the CPU."""
import json
import warnings

import numpy as np
import pytest
import torch
import jax
from hypothesis import given, settings, strategies as st

import emme_tpu
from emme_tpu import driver as jdriver
from emme_tpu.ops import sparse as jsparse
from emme_tpu.solvers import pic as jpic
import emme_tpu_torch as et
from emme_tpu_torch import convert, driver
from emme_tpu_torch.ops import kernels, sparse
from emme_tpu_torch.solvers import cuda_pic, pic
from emme_tpu_torch.utils import debug
from emme_tpu_torch.utils.timer import Timer

torch.set_num_threads(2)

SCAN_SPECS = [
    {"head": 1.0, "step": 0.5, "tail": 2.0},
    {"head": 1.01, "step": 0.1, "tail": [0.81, 1.21]},
    {"head": 0.0, "step": -0.5, "tail": 1.0},
    {"head": 0.02, "step": -0.001, "tail": [0.02, 0.02]},
    {"head": 3.0, "step": 0.25, "tail": [2.5, 3.5]},
]


@pytest.mark.parametrize("spec", SCAN_SPECS, ids=[str(i) for i in range(5)])
def test_scan_values_equal_jax_package(spec):
    """The cases of tests/test_driver.py:11-33: the same values and turning
    flags as emme_tpu.driver."""
    assert driver.scan_values(spec) == jdriver.scan_values(spec)


def test_scan_values_walk_order():
    vals, turns = driver.scan_values(SCAN_SPECS[1])
    assert [round(v, 2) for v in vals] == [1.01, 0.91, 0.81, 1.11, 1.21]
    assert turns == [False, False, False, True, False]
    assert driver.scan_values(SCAN_SPECS[3]) == ([0.02], [False])


_num = st.floats(-50.0, 50.0, allow_nan=False)
_step = st.floats(0.05, 5.0).flatmap(
    lambda s: st.sampled_from([s, -s]))


@settings(max_examples=200, deadline=None, database=None)
@given(head=_num, step=_step,
       tail=st.one_of(_num, st.lists(_num, min_size=2, max_size=2)))
def test_scan_values_hypothesis(head, step, tail):
    """Drawn specs (head, step != 0, one or two tails) whose walk stays
    under 2,000 points: equal lists in both packages."""
    far = max(abs(t - head) for t in (tail if isinstance(tail, list)
                                      else [tail]))
    if far / abs(step) > 1000:
        return
    spec = {"head": head, "step": step, "tail": tail}
    assert driver.scan_values(spec) == jdriver.scan_values(spec)


def test_filter_input():
    cfg = {"a": 1, "b": {"head": 2.0, "step": 1.0, "tail": 5.0},
           "c": {"head": 1.0}, "mesh": {"rows": 2}}
    out = driver.filter_input(cfg)
    assert out == jdriver.filter_input(cfg)
    assert out["a"] == 1 and out["b"] == 2.0 and out["c"] == {"head": 1.0}
    assert cfg["b"]["head"] == 2.0   # the input is not changed


# ---------------------------------------------------------------------------
# fake-solver tests: the walk, faults, checkpoints (tests/test_driver.py)
# ---------------------------------------------------------------------------

def _fake_solver(fail_on=None, error=RuntimeError("synthetic failure")):
    calls = []

    def solver(cfg, omega, matrix_file=None, **kw):
        v = cfg["x"]
        calls.append((v, omega))
        if fail_on is not None and abs(v - fail_on) < 1e-12:
            raise error
        om = complex(v, 0.1)
        return {"eigenvalue": [om.real, om.imag]}, om

    return solver, calls


@pytest.fixture
def scan_cfg():
    return {
        "method": "eigen",
        "initial_guess": [-0.8, 0.25],
        "x": {"head": 1.0, "step": 1.0, "tail": 3.0},
    }


def test_scan_fault_capture_and_output(tmp_path, scan_cfg, monkeypatch):
    solver, calls = _fake_solver(fail_on=2.0)
    monkeypatch.setitem(driver._SOLVERS, "eigen", solver)
    res = driver.run(scan_cfg, output_dir=tmp_path, device="cpu",
                     verbose=False)
    unit = res["result"]["x"]
    assert unit["scan_values"] == [1.0, 2.0, 3.0]
    evs = [r["eigenvalue"] for r in unit["scan_result"]]
    assert evs[0] == [1.0, 0.1]
    assert evs[1] == "NaN"
    assert unit["scan_result"][1]["reason"] == "synthetic failure"
    assert evs[2] == [3.0, 0.1]
    # continuation: the guess, the first result, and the guess again after
    # the failed point
    assert [om for _, om in calls] == [-0.8 + 0.25j, 1.0 + 0.1j,
                                       -0.8 + 0.25j]
    out = json.loads((tmp_path / "output.json").read_text())
    assert out["result"]["x"]["scan_result"][1]["eigenvalue"] == "NaN"
    assert out["run_time"] and out["framework"] == "emme_tpu_torch"
    assert not (tmp_path / "checkpoint.json").exists()  # cleaned on success


def test_checkpoint_resume(tmp_path, scan_cfg, monkeypatch):
    crash = {"armed": True}

    def solver1(cfg, omega, matrix_file=None, **kw):
        if cfg["x"] == 3.0 and crash["armed"]:
            raise KeyboardInterrupt  # not caught by fault capture
        om = complex(cfg["x"], 0.1)
        return {"eigenvalue": [om.real, om.imag]}, om

    monkeypatch.setitem(driver._SOLVERS, "eigen", solver1)
    with pytest.raises(KeyboardInterrupt):
        driver.run(scan_cfg, output_dir=tmp_path, device="cpu", verbose=False)
    assert (tmp_path / "checkpoint.json").exists()
    assert set(json.loads((tmp_path / "checkpoint.json").read_text())) \
        == {"x=1.0", "x=2.0"}

    crash["armed"] = False
    solver2, recomputed = _fake_solver()
    monkeypatch.setitem(driver._SOLVERS, "eigen", solver2)
    res = driver.run(scan_cfg, output_dir=tmp_path, device="cpu",
                     verbose=False)
    # only x=3 is solved again, seeded from the checkpoint's x=2
    assert recomputed == [(3.0, 2.0 + 0.1j)]
    assert [r["eigenvalue"][0] for r in res["result"]["x"]["scan_result"]] \
        == [1.0, 2.0, 3.0]


def test_unsupported_method():
    with pytest.raises(ValueError, match="not supported"):
        driver.run({"method": "magic"}, device="cpu", verbose=False)
    with pytest.raises(ValueError, match="scan_mode"):
        driver.run({"method": "eigen"}, device="cpu", scan_mode="random")


def test_driver_bad_backend_raises(tokamak_cfg, tmp_path):
    cfg = dict(tokamak_cfg, npoints=32)
    cfg["eigen_backend"] = "magic"
    with pytest.raises(ValueError, match="eigen_backend"):
        driver.run(cfg, output_dir=tmp_path, device="cpu", verbose=False)


@pytest.mark.parametrize("mode", ["wavefront", "independent"])
def test_parallel_scan_order_faults_and_checkpoint(tmp_path, scan_cfg,
                                                   monkeypatch, mode):
    """scan_workers > 1: results come back in walk order, per-point fault
    capture still applies, the checkpoint is cleaned; wavefront seeds a
    batch from the batch before it, independent from the guess."""
    solver, calls = _fake_solver(fail_on=2.0)
    monkeypatch.setitem(driver._SOLVERS, "eigen", solver)
    cfg = dict(scan_cfg, x={"head": 1.0, "step": 1.0, "tail": 4.0})
    res = driver.run(cfg, output_dir=tmp_path, device="cpu", verbose=False,
                     scan_workers=2, scan_mode=mode)
    unit = res["result"]["x"]
    assert unit["scan_values"] == [1.0, 2.0, 3.0, 4.0]
    evs = [r["eigenvalue"] for r in unit["scan_result"]]
    assert evs == [[1.0, 0.1], "NaN", [3.0, 0.1], [4.0, 0.1]]
    assert unit["scan_result"][1]["reason"] == "synthetic failure"
    seeds = dict(calls)
    assert sorted(seeds) == [1.0, 2.0, 3.0, 4.0]
    guess = -0.8 + 0.25j
    if mode == "wavefront":   # the second batch follows a failed point
        assert seeds == {1.0: guess, 2.0: guess, 3.0: guess, 4.0: guess}
    else:
        assert set(seeds.values()) == {guess}
    assert not (tmp_path / "checkpoint.json").exists()


def test_parallel_scan_wavefront_seeds_and_turn(tmp_path, monkeypatch):
    """Wavefront batches on a two-tail walk: a batch is seeded from the last
    point of the batch before it, and the turn re-seeds from the first
    result, as emme_tpu's wavefront does with the same fake solver."""
    cfg = {"method": "eigen", "initial_guess": [-0.8, 0.25],
           "x": {"head": 3.0, "step": 1.0, "tail": [1.0, 5.0]}}
    seeds = {}
    for name, mod in (("port", driver), ("jax", jdriver)):
        solver, calls = _fake_solver()
        monkeypatch.setitem(mod._SOLVERS, "eigen", solver)
        kw = dict(device="cpu") if mod is driver else {}
        res = mod.run(cfg, output_dir=tmp_path / name, verbose=False,
                      scan_workers=2, **kw)
        assert res["result"]["x"]["scan_values"] == [3.0, 2.0, 1.0, 4.0, 5.0]
        seeds[name] = dict(calls)
    g = -0.8 + 0.25j
    assert seeds["port"] == {3.0: g, 2.0: g, 1.0: 2.0 + 0.1j,
                             4.0: 3.0 + 0.1j, 5.0: 3.0 + 0.1j}
    assert seeds["port"] == seeds["jax"]


def test_parallel_scan_resumes_from_checkpoint(tmp_path, scan_cfg,
                                               monkeypatch):
    solver1, _ = _fake_solver()
    monkeypatch.setitem(driver._SOLVERS, "eigen", solver1)
    (tmp_path / "eigenMatrics").mkdir(parents=True)
    with open(tmp_path / "checkpoint.json", "w") as f:
        json.dump({"x=1.0": {"eigenvalue": [9.0, 9.0]}}, f)
    res = driver.run(scan_cfg, output_dir=tmp_path, device="cpu",
                     verbose=False, scan_workers=2)
    evs = [r["eigenvalue"] for r in res["result"]["x"]["scan_result"]]
    assert evs == [[9.0, 9.0], [2.0, 0.1], [3.0, 0.1]]  # x=1 from checkpoint


def test_two_tail_walk_order_and_reseed(tmp_path, goldens_dir, monkeypatch):
    """The two-tail walk gives scan_eta_i_twotail_tok32.json's scan_values,
    and the turn re-seeds from the first result (main.cpp:281-291)."""
    with open(goldens_dir / "scan_eta_i_twotail_tok32.json") as f:
        gold = json.load(f)
    calls = []

    def solver(cfg, omega, matrix_file=None, **kw):
        calls.append(omega)
        om = complex(cfg["eta_i"], 0.1)
        return {"eigenvalue": [om.real, om.imag]}, om

    monkeypatch.setitem(driver._SOLVERS, "eigen", solver)
    cfg = {"method": "eigen", "initial_guess": [-0.8, 0.25],
           "eta_i": {"head": 3.0, "step": 0.25, "tail": [2.5, 3.5]}}
    res = driver.run(cfg, output_dir=tmp_path, device="cpu", verbose=False)
    assert res["result"]["eta_i"]["scan_values"] == gold["scan_values"]
    assert calls == [-0.8 + 0.25j, 3.0 + 0.1j, 2.75 + 0.1j, 3.0 + 0.1j,
                     3.25 + 0.1j]


def test_shifts_fault_capture_and_resume(tmp_path, monkeypatch):
    """"shifts": results in shift order with the shift recorded, a failed
    shift (here a KeyError) captured with its reason, the checkpoint read on
    resume; shifts with a scan dimension or with PIC raise."""
    def solver(cfg, omega, matrix_file=None, **kw):
        if omega.real == 2.0:
            raise KeyError("n_bogus")
        return {"eigenvalue": [omega.real, omega.imag]}, omega

    monkeypatch.setitem(driver._SOLVERS, "eigen", solver)
    cfg = {"method": "eigen", "shifts": [[1.0, 0.5], [2.0, 0.5], [3.0, 0.5]]}
    (tmp_path / "eigenMatrics").mkdir(parents=True)
    with open(tmp_path / "checkpoint.json", "w") as f:
        json.dump({"shift=2": {"eigenvalue": [7.0, 7.0],
                               "shift": [3.0, 0.5]}}, f)
    for workers in (1, 2):
        res = driver.run(cfg, output_dir=tmp_path, device="cpu",
                         verbose=False, scan_workers=workers)
        unit = res["result"]["shifts"]
        assert unit["scan_values"] == cfg["shifts"]
        if workers == 1:
            assert [r["eigenvalue"] for r in unit["scan_result"]] \
                == [[1.0, 0.5], "NaN", [7.0, 7.0]]
        assert unit["scan_result"][1]["reason"] == "'n_bogus'"
        assert unit["scan_result"][1]["shift"] == [2.0, 0.5]
    with pytest.raises(ValueError, match="mutually exclusive"):
        driver.run(dict(cfg, x={"head": 1, "step": 1, "tail": 2}),
                   output_dir=tmp_path, device="cpu", verbose=False)
    with pytest.raises(ValueError, match='requires method "eigen"'):
        driver.run(dict(cfg, method="PIC"), output_dir=tmp_path,
                   device="cpu", verbose=False)


def test_scan_point_fails_with_keyerror_from_scaled_quad(tmp_path,
                                                         tokamak_cfg,
                                                         monkeypatch):
    """A tier spec naming a panel key the preset lacks makes
    kernels.scaled_quad raise KeyError, as in emme_tpu; the scan records it
    as that point's reason and goes on.  Run in debug mode, which passes a
    healthy point and leaves the finiteness checks off afterwards."""
    real = kernels.tier_thresholds_ij
    solves = []

    def tiers(dx, n):
        t = real(dx, n)
        if len(solves) == 2:   # the second scan point's table
            return tuple((ub, (("n_bogus", 3),)) for ub, _ in t)
        return t

    real_solve = driver.eigen.solve

    def counting_solve(*a, **kw):
        solves.append(1)
        return real_solve(*a, **kw)

    monkeypatch.setattr(kernels, "tier_thresholds_ij", tiers)
    monkeypatch.setattr(driver.eigen, "solve", counting_solve)
    cfg = dict(tokamak_cfg, npoints=16, quad_tiered=True, quad_guard="off",
               eta_i={"head": 3.0, "step": 0.25, "tail": 3.5})
    res = driver.run(cfg, output_dir=tmp_path, device="cpu", verbose=False,
                     debug=True)
    out = res["result"]["eta_i"]["scan_result"]
    assert isinstance(out[0]["eigenvalue"], list)
    assert out[1] == {"eigenvalue": "NaN", "reason": "'n_bogus'"}
    assert isinstance(out[2]["eigenvalue"], list)
    assert not debug.nan_checks_enabled()


# ---------------------------------------------------------------------------
# whole runs against emme_tpu and the goldens
# ---------------------------------------------------------------------------

def _key_tree(doc):
    """The nested key structure of a JSON document, values dropped (a list
    is described by its first element)."""
    if isinstance(doc, dict):
        return {k: _key_tree(v) for k, v in doc.items()}
    if isinstance(doc, list) and doc and isinstance(doc[0], (dict, list)):
        return [_key_tree(doc[0])]
    return type(doc).__name__ if not isinstance(doc, (int, float)) \
        else "number"


def _corr(a, b):
    a, b = (np.asarray(x)[:, 0] + 1j * np.asarray(x)[:, 1] for x in (a, b))
    return abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))


def test_run_matches_jax_package_tok32(tmp_path, tokamak_cfg,
                                       golden_eigenvalues):
    """One driver.run of both packages on tokamak npoints 32 (quad_guard
    "warn"): the same key tree in output.json, omega within 2e-6 of golden
    tok32 (the bar of tests/test_torch_eigen.py) and within 1e-8 of
    emme_tpu's, eigenvectors correlated to 1 - 1e-8, equal
    iteration_steps, quadrature_guard fields equal to 1e-6, the two matrix
    dumps equal to 1e-10 of scale."""
    cfg = dict(tokamak_cfg, npoints=32)
    mine = driver.run(cfg, output_dir=tmp_path / "port", device="cpu",
                      verbose=False)
    ref = jdriver.run(cfg, output_dir=tmp_path / "jax", verbose=False)
    docs = [json.loads((tmp_path / d / "output.json").read_text())
            for d in ("port", "jax")]
    assert _key_tree(docs[0]) == _key_tree(docs[1])
    assert docs[0]["framework"] == "emme_tpu_torch"
    assert docs[0]["input"] == docs[1]["input"] == cfg
    assert docs[0]["git_commit_hash"] == docs[1]["git_commit_hash"]
    a = mine["result"]["(None)"]["scan_result"][0]
    b = ref["result"]["(None)"]["scan_result"][0]
    om, omj = complex(*a["eigenvalue"]), complex(*b["eigenvalue"])
    gold = complex(*golden_eigenvalues["tok32"]["omega"])
    assert abs(om - gold) / abs(gold) < 2e-6
    assert abs(om - omj) / abs(omj) < 1e-8
    assert a["iteration_steps"] == b["iteration_steps"]
    assert len(a["eigenvector"]) == 32
    assert _corr(a["eigenvector"], b["eigenvector"]) > 1 - 1e-8
    ga, gb = a["quadrature_guard"], b["quadrature_guard"]
    assert set(ga) == set(gb)
    assert ga["n_sampled"] == gb["n_sampled"]
    for k in ("frac_flagged", "max_abs_err", "max_rel_err"):
        assert abs(ga[k] - gb[k]) <= 1e-6 * max(abs(gb[k]), 1e-30) + 1e-16, k
    dumps = [np.fromfile(tmp_path / d / "eigenMatrics" / "eigenMatrix.bin",
                         dtype=np.complex128) for d in ("port", "jax")]
    assert dumps[0].shape == dumps[1].shape == (32 * 32,)
    assert np.abs(dumps[0] - dumps[1]).max() \
        <= 1e-10 * np.abs(dumps[1]).max()
    assert not (tmp_path / "port" / "checkpoint.json").exists()


def test_scan_eigenvalues_match_reference_golden(tmp_path, tokamak_cfg,
                                                 goldens_dir):
    """The 3-point eta_i scan with continuation against the C++
    reference's scan (scan_eta_i_tok32.json, 6 printed digits) at 2e-5;
    every point has its dump."""
    with open(goldens_dir / "scan_eta_i_tok32.json") as f:
        gold = json.load(f)
    cfg = dict(tokamak_cfg, npoints=32, quad_guard="off")
    cfg["eta_i"] = {"head": 3.0, "step": 0.25, "tail": 3.5}
    out = driver.run(cfg, output_dir=tmp_path, device="cpu", verbose=False)
    res = out["result"]["eta_i"]
    assert res["scan_values"] == gold["scan_values"]
    for mine, ref, val in zip(res["scan_result"], gold["eigenvalues"],
                              res["scan_values"]):
        om = complex(*mine["eigenvalue"])
        rom = complex(*ref)
        assert abs(om - rom) / abs(rom) < 2e-5
        assert mine["scan_value"] == val
        dump = np.fromfile(mine["eigenMatrix"], dtype=np.complex128)
        assert dump.shape == (32 * 32,) and np.isfinite(dump).all()
    # continuation pays: no later point takes more steps than the first
    steps = [r["iteration_steps"] for r in res["scan_result"]]
    assert max(steps[1:]) <= steps[0]


def test_driver_sparse_backend_matches_golden(tmp_path, tokamak_cfg,
                                              golden_eigenvalues):
    """eigen_backend='sparse' at npoints 32, band_block 8: within 2e-6 of
    golden tok32, nnz < 1024, and the banded dump with its sidecar read back
    by both packages' load_bdia_dump to the same operator."""
    cfg = dict(tokamak_cfg, npoints=32, eigen_backend="sparse", band_block=8)
    out = driver.run(cfg, output_dir=tmp_path, device="cpu", verbose=False)
    res = out["result"]["(None)"]["scan_result"][0]
    om = complex(*res["eigenvalue"])
    ref = complex(*golden_eigenvalues["tok32"]["omega"])
    assert abs(om - ref) / abs(ref) < 2e-6
    stats = res["sparse_stats"]
    assert stats["nnz"] < 32 * 32 and stats["block"] == 8
    assert stats["spmv_route"] == "bdia"
    assert res["quadrature_guard"]["frac_flagged"] == 0.0
    path = tmp_path / "eigenMatrics" / "eigenMatrix.bin"
    assert path.exists() and (tmp_path / "eigenMatrics"
                              / "eigenMatrix.bin.json").exists()
    op = sparse.load_bdia_dump(path, device="cpu")
    jop = jsparse.load_bdia_dump(path)
    assert (op.n, op.block, op.offsets) == (32, 8, tuple(jop.offsets))
    planes = np.stack([op.data.real.numpy(), op.data.imag.numpy()], axis=2)
    assert np.array_equal(planes, np.asarray(jop.data))
    x = torch.ones(32, dtype=torch.complex128)
    y = sparse.bdia_matvec(op, x)
    assert bool(torch.isfinite(y).all()) and float(y.abs().max()) > 0


def test_sparse_backend_chunk_and_keys(tokamak_cfg, monkeypatch):
    """The input's keys reach sparse_eigen.solve under its argument names.
    ``chunk`` sizes the torch integrand's pair chunks only: through K1
    (float32, or fused_assembly) the kernel table keeps its own call
    size."""
    seen = []

    class Stop(Exception):
        pass

    def fake(p, omega, **kw):
        seen.append(kw)
        raise Stop

    monkeypatch.setattr(driver.sparse_eigen, "solve", fake)
    cfg = dict(tokamak_cfg, npoints=32, eigen_backend="sparse", band_block=8,
               band_deta=12.0, m_krylov=4, spmv_method="bsr",
               iteration_method="QRSecant", quad_tiered=True)
    for dtype, extra in ((torch.float64, {}), (torch.float32, {}),
                         (torch.float32, {"fused_assembly": False})):
        with pytest.raises(Stop):
            driver.solve_once_eigen(dict(cfg, **extra), -0.8 + 0.25j,
                                    dtype=dtype, device="cpu", chunk=512,
                                    host64=True)
    assert [(kw["chunk"], kw["fused"]) for kw in seen] \
        == [(512, False), (None, True), (512, False)]
    stats = seen[0].pop("stats")
    assert stats == {} and seen[0] == dict(
        tol=1e-6, quad=None, chunk=512, host64=True, band_deta=12.0, block=8,
        m_krylov=4, method="QRSecant", tiered=True, spmv="bsr", fused=False)


# ---------------------------------------------------------------------------
# PIC through the driver
# ---------------------------------------------------------------------------

PIC_KEYS = dict(method="PIC", marker_per_cell=16, step_number=8,
                time_step=0.25, initial_guess=[-0.8, 0.25])


@pytest.fixture
def pic_cfg(tokamak_cfg):
    return dict(tokamak_cfg, npoints=32, **PIC_KEYS)


@pytest.fixture
def jax_state(pic_cfg, monkeypatch):
    """The state emme_tpu's driver draws for ``pic_cfg`` (seed 0), carried
    across and handed to every PIC entry point of the port in place of its
    own draw."""
    pj = emme_tpu.from_config(pic_cfg)
    sj = jpic.init_state(pj, 16, jax.random.PRNGKey(0))
    state = convert.pic_state_from_arrays(
        {k: np.asarray(getattr(sj, k)) for k in sj.__dataclass_fields__},
        device="cpu")
    monkeypatch.setattr(pic, "initial_state",
                        lambda p, mpc, generator=None, state_=None: state)
    return state


def _pic_result(out):
    return out["result"]["(None)"]["scan_result"][0]


def test_pic_run_matches_jax_package(tmp_path, pic_cfg, jax_state):
    """PIC through both drivers from one state (the default streaming
    path): the fit and the final field within 1e-10 relative (the bar of
    tests/test_torch_pic.py), and the streamed dumps, every step's field,
    too; the port's streamed dump equals its buffered one bit for bit."""
    mine = _pic_result(driver.run(pic_cfg, output_dir=tmp_path / "port",
                                  device="cpu", verbose=False))
    ref = _pic_result(jdriver.run(pic_cfg, output_dir=tmp_path / "jax",
                                  verbose=False))
    assert set(mine) == set(ref) == {"eigenvalue", "eigenvector"}
    assert abs(complex(*mine["eigenvalue"]) - complex(*ref["eigenvalue"])) \
        <= 1e-9 * abs(complex(*ref["eigenvalue"]))
    fa, fb = (np.asarray(r["eigenvector"]) for r in (mine, ref))
    assert fa.shape == (32, 2)
    assert np.abs(fa - fb).max() <= 1e-10 * np.abs(fb).max()
    dumps = [np.fromfile(tmp_path / d / "eigenMatrics" / "eigenMatrix.bin",
                         dtype=np.complex128) for d in ("port", "jax")]
    assert dumps[0].shape == dumps[1].shape == (8 * 32,)
    assert np.abs(dumps[0] - dumps[1]).max() \
        <= 1e-10 * np.abs(dumps[1]).max()
    buffered = dict(pic_cfg, stream_fields=False, pic_backend="xla")
    again = _pic_result(driver.run(buffered, output_dir=tmp_path / "buf",
                                   device="cpu", verbose=False))
    assert again["eigenvalue"] == mine["eigenvalue"]
    assert np.array_equal(
        np.fromfile(tmp_path / "buf" / "eigenMatrics" / "eigenMatrix.bin",
                    dtype=np.complex128), dumps[0])


def test_pic_streaming_chunks_and_flush(tmp_path, pic_cfg, jax_state):
    """run_streaming appends a segment every chunk_steps steps (3 + 3 + 2
    here) with the same bytes as one segment, and returns run's stats."""
    p = et.from_config(pic_cfg, device="cpu")
    stats, s, fields = pic.run(p, 16, 8, 0.25, record_fields=True)
    for chunk in (3, 16):
        path = tmp_path / f"stream{chunk}.bin"
        st_s, s_s = pic.run_streaming(p, 16, 8, 0.25, path,
                                      chunk_steps=chunk)
        assert torch.equal(st_s, stats) and torch.equal(s_s.field, s.field)
        assert np.array_equal(np.fromfile(path, dtype=np.complex128),
                              fields.numpy().reshape(-1))


def test_pic_timers_adaptive_and_fits(tmp_path, pic_cfg, jax_state):
    """pic_timers leaves the four sections in the timer's report and the
    run's result unchanged; adaptive runs report adaptive_steps; every
    omega_fit is accepted and an unknown one raises."""
    base = _pic_result(driver.run(dict(pic_cfg, omega_fit="fft"),
                                  output_dir=tmp_path / "a", device="cpu",
                                  verbose=False))
    Timer.get_timer().reset()
    timed = _pic_result(driver.run(dict(pic_cfg, pic_timers=True,
                                        omega_fit="fft"),
                                   output_dir=tmp_path / "b", device="cpu",
                                   verbose=False))
    report = Timer.get_timer().report()
    for sec in ("Initial", "Particle Pushing", "Field Solve", "Diagnostics",
                "PIC run", "All"):
        assert sec in report
    assert abs(complex(*timed["eigenvalue"]) - complex(*base["eigenvalue"])) \
        <= 1e-12 * abs(complex(*base["eigenvalue"]))
    assert np.array_equal(
        np.fromfile(tmp_path / "b" / "eigenMatrics" / "eigenMatrix.bin"),
        np.fromfile(tmp_path / "a" / "eigenMatrics" / "eigenMatrix.bin"))
    views = _pic_result(driver.run(dict(pic_cfg, omega_fit="peak_views"),
                                   output_dir=tmp_path / "v", device="cpu",
                                   verbose=False))
    assert np.isfinite(views["eigenvalue"]).all()
    ad = _pic_result(driver.run(
        dict(pic_cfg, time_step_adaptive=True, step_number=2,
             adaptive_upper_err=1e-2, adaptive_lower_err=1e-3),
        output_dir=tmp_path / "c", device="cpu", verbose=False))
    assert ad["adaptive_steps"] >= 2
    assert ad["adaptive_final_time"] == pytest.approx(0.5, abs=1e-12)
    with pytest.raises(ValueError, match="omega_fit"):
        driver.run(dict(pic_cfg, omega_fit="wavelet"),
                   output_dir=tmp_path / "d", device="cpu", verbose=False)


def test_pic_backend_fused(tmp_path, tokamak_cfg):
    """pic_backend 'fused' in float32 at npoints 128 takes cuda_pic.run
    (the kernels' plain versions on the CPU) and gives its result; with the
    default stream_fields the streaming plain path keeps the dump; float64
    and an unknown backend raise."""
    cfg = dict(dict(tokamak_cfg, **PIC_KEYS), npoints=128, marker_per_cell=8,
               step_number=4, stream_fields=False, pic_backend="fused")
    cuda_pic.LAST_LAUNCH = None
    before = dict(cuda_pic.LAUNCHES)
    res = _pic_result(driver.run(cfg, output_dir=tmp_path, device="cpu",
                                 dtype=torch.float32, verbose=False))
    assert cuda_pic.LAST_LAUNCH in ("single", "stages")
    assert cuda_pic.LAUNCHES == before   # CPU tensors launch nothing
    p = et.from_config(cfg, dtype=torch.float32, device="cpu")
    stats, s, _ = cuda_pic.run(p, 8, 4, 0.25,
                               generator=torch.Generator().manual_seed(0))
    field = s.field.numpy()
    assert np.array_equal(np.asarray(res["eigenvector"], np.float32),
                          np.stack([field.real, field.imag], axis=1))
    # 'fused' writes no dump; 'stages' is passed on
    assert not (tmp_path / "eigenMatrics" / "eigenMatrix.bin").exists()
    driver.run(dict(cfg, pic_launch="stages"), output_dir=tmp_path,
               device="cpu", dtype=torch.float32, verbose=False)
    assert cuda_pic.LAST_LAUNCH == "stages"
    # the default streaming path wins over the backend key
    cuda_pic.LAST_LAUNCH = None
    driver.run(dict(cfg, stream_fields=True), output_dir=tmp_path,
               device="cpu", dtype=torch.float32, verbose=False)
    assert cuda_pic.LAST_LAUNCH is None
    assert np.fromfile(tmp_path / "eigenMatrics" / "eigenMatrix.bin",
                       dtype=np.complex128).shape == (4 * 128,)
    with pytest.raises(ValueError, match="needs f32"):
        driver.run(cfg, output_dir=tmp_path, device="cpu", verbose=False)
    with pytest.raises(ValueError, match="auto|fused|xla"):
        driver.run(dict(cfg, pic_backend="pallas"), output_dir=tmp_path,
                   device="cpu", dtype=torch.float32, verbose=False)


# ---------------------------------------------------------------------------
# what the port does not take, and debug mode
# ---------------------------------------------------------------------------

def test_pic_sorted_and_mesh_raise(tmp_path, tokamak_cfg, pic_cfg):
    """A mesh on the card (the default device) needs one card a rank and
    never falls back to the CPU; a scan axis needs rows; the solvers take
    only a parallel.mesh.Mesh.  (pic_sorted runs since the sorted-window
    path was ported: tests/test_torch_pic_sorted.py.)"""
    cfg = dict(tokamak_cfg, npoints=32, method="eigen")
    have = torch.cuda.device_count()
    for kw, extra in ((dict(mesh_rows=have + 2), {}),
                      ({}, {"mesh": {"rows": have + 2}})):
        with pytest.raises(ValueError,
                           match=f"{have + 2} ranks on CUDA need "
                                 f"{have + 2} cards .* {have} visible"):
            driver.run(dict(cfg, **extra), output_dir=tmp_path,
                       verbose=False, **kw)
    with pytest.raises(ValueError, match="needs mesh rows"):
        driver.run(cfg, output_dir=tmp_path, device="cpu", verbose=False,
                   mesh_scan=2)
    for solve in (driver.solve_once_eigen, driver.solve_once_pic):
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            solve(dict(pic_cfg), -0.8 + 0.25j, device="cpu", mesh=object())


def test_debug_mode_validates_and_catches(tmp_path, tokamak_cfg):
    """The EMME_DEBUG analogue (tests/test_driver.py:294-312): a bad
    band_block and a negative marker count are rejected by name before any
    solve runs, from the argument or from the input key."""
    base = dict(tokamak_cfg, npoints=32, method="eigen",
                initial_guess=[-0.8, 0.25], quad_guard="off")
    bad = dict(base, eigen_backend="sparse", band_block=7, debug=True)
    with pytest.raises(ValueError, match="band_block"):
        driver.run(bad, output_dir=tmp_path / "bad", device="cpu",
                   verbose=False)
    bad2 = dict(base, method="PIC", marker_per_cell=-4, step_number=2,
                time_step=0.25)
    with pytest.raises(ValueError, match="marker_per_cell"):
        driver.run(bad2, output_dir=tmp_path / "bad2", device="cpu",
                   verbose=False, debug=True)
    assert not debug.nan_checks_enabled()


def test_debug_mode_names_a_non_finite_result(tmp_path, tokamak_cfg,
                                              monkeypatch):
    """In debug mode a NaN in a PIC field raises FloatingPointError naming
    the stage; in a scan it becomes the point's reason."""
    cfg = dict(dict(tokamak_cfg, **PIC_KEYS), npoints=32, marker_per_cell=4,
               step_number=4)
    real = pic.quasi_neutrality_coef

    def poisoned(p, dtype=torch.float64):
        qn = real(p, dtype=dtype)
        qn[3] = float("nan")
        return qn

    monkeypatch.setattr(pic, "quasi_neutrality_coef", poisoned)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        driver.run(cfg, output_dir=tmp_path, device="cpu", verbose=False)
        with pytest.raises(FloatingPointError, match="PIC field"):
            driver.run(cfg, output_dir=tmp_path, device="cpu", verbose=False,
                       debug=True)
        scan = dict(cfg, eta_i={"head": 3.0, "step": 0.5, "tail": 3.5})
        out = driver.run(scan, output_dir=tmp_path, device="cpu",
                         verbose=False, debug=True)
    assert all("PIC field" in r["reason"]
               for r in out["result"]["eta_i"]["scan_result"])
    assert not debug.nan_checks_enabled()
