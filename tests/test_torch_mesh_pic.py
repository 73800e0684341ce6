"""The PIC mesh paths of emme_tpu_torch.driver on gloo ranks (markers over
the rows axis, the deposit summed before every field solve): the plain,
timed and streamed runs against the port's single-process run from the same
markers (tests/test_sharded.py:107-136, tests/test_spike.py:190-198,
:302-316), the rows x scan PIC scan; the command line's --mesh-rows; and
sparse_eigen.solve_shifts with two worker threads."""
import json

import numpy as np
import pytest
import torch

from emme_tpu_torch import cli, driver
from emme_tpu_torch.parallel import mesh as mesh_mod
from emme_tpu_torch.solvers import sparse_eigen as se
import emme_tpu_torch as et

torch.set_num_threads(2)

QUAD = {"n_shoulder": 8, "n_osc": 16, "n_tail": 4}


@pytest.fixture(autouse=True)
def _deadline(monkeypatch):
    """The driver's spawns here end within 300 s whatever happens (its
    default deadline is an hour)."""
    monkeypatch.setattr(mesh_mod, "DEADLINE_S", 300.0)
GUESS = -0.8 + 0.25j


def _ev(res, key="(None)"):
    return [complex(*r["eigenvalue"]) for r in res["result"][key]["scan_result"]]


def _field(res):
    return np.array(res["result"]["(None)"]["scan_result"][0]["eigenvector"])


@pytest.fixture(scope="module")
def pic_base(tokamak_cfg):
    return dict(tokamak_cfg, method="PIC", npoints=32, marker_per_cell=16,
                step_number=8, time_step=0.25, initial_guess=[-0.8, 0.25])


@pytest.fixture(scope="module")
def single(pic_base, tmp_path_factory):
    return driver.run(dict(pic_base, stream_fields=False),
                      output_dir=tmp_path_factory.mktemp("single"),
                      device="cpu", verbose=False, checkpoint=False)


@pytest.mark.parametrize("form", ["plain", "timed", "streamed"])
def test_driver_mesh_pic_matches_single(tmp_path, pic_base, single, form):
    """The three PIC forms over "mesh": {"rows": 2}: the same markers as the
    meshless run (one seed, every rank loads all and keeps its share), so
    the final field within 1e-12 of scale and the fit within 1e-9; the
    streamed run's dump holds the 8 steps' fields (test_sharded.py:107-136)."""
    extra = {"plain": dict(stream_fields=False),
             "timed": dict(stream_fields=False, pic_timers=True),
             "streamed": {}}[form]
    res = driver.run(dict(pic_base, mesh={"rows": 2}, **extra),
                     output_dir=tmp_path, device="cpu", verbose=False,
                     checkpoint=False)
    (e1,), (e0,) = _ev(res), _ev(single)
    assert abs(e1 - e0) <= 1e-9 * abs(e0)
    f1, f0 = _field(res), _field(single)
    assert np.abs(f1 - f0).max() <= 1e-12 * np.abs(f0).max()
    if form == "streamed":
        dump = np.fromfile(tmp_path / "eigenMatrics" / "eigenMatrix.bin",
                           dtype=np.complex128)
        assert dump.size == 8 * 32
        assert np.abs(dump[-32:] - (f0[:, 0] + 1j * f0[:, 1])).max() <= \
            1e-12 * np.abs(f0).max()


def test_driver_mesh_pic_restrictions(tmp_path, pic_base):
    """time_step_adaptive raises the JAX package's error on a mesh, and
    markers that do not divide over the ranks raise."""
    with pytest.raises(ValueError, match="time_step_adaptive"):
        driver.run(dict(pic_base, mesh={"rows": 2}, time_step_adaptive=True),
                   output_dir=tmp_path / "a", device="cpu", verbose=False)
    with pytest.raises(ValueError, match="do not divide over 3 ranks"):
        driver.run(dict(pic_base, mesh={"rows": 3}, stream_fields=False),
                   output_dir=tmp_path / "b", device="cpu", verbose=False)


def test_driver_mesh_rows_scan_pic(tmp_path, pic_base):
    """PIC through the 2 x 2 topology: the two scan points run at once,
    each marker-sharded over its group; finite fits equal to the meshless
    scan's (test_spike.py:302-316)."""
    cfg = dict(pic_base, stream_fields=False,
               eta_i={"head": 3.13, "step": 0.1, "tail": 3.23})
    r = driver.run(dict(cfg, mesh={"rows": 2, "scan": 2}),
                   output_dir=tmp_path / "m", device="cpu", verbose=False)
    r0 = driver.run(cfg, output_dir=tmp_path / "s", device="cpu",
                    verbose=False)
    e, e0 = _ev(r, "eta_i"), _ev(r0, "eta_i")
    assert len(e) == 2 and np.isfinite(e).all()
    assert np.allclose(e, e0, rtol=1e-9, atol=0)


@pytest.fixture(scope="module")
def base(tokamak_cfg):
    return dict(tokamak_cfg, npoints=32, method="eigen",
                initial_guess=[-0.8, 0.25], iteration_precision=1e-6,
                quad_guard="off")


def test_cli_mesh_rows_on_the_cpu(tmp_path, base):
    """`emme_tpu_torch.cli input.json --device cpu --mesh-rows 2` (tok16,
    the default panel mesh): the meshless run's omega within 1e-12,
    output.json written."""
    base = dict(base, npoints=16)
    path = tmp_path / "in.json"
    path.write_text(json.dumps(base))
    assert cli.main([str(path), "-o", str(tmp_path / "out"), "--device",
                     "cpu", "--mesh-rows", "2", "-q"]) == 0
    got = json.loads((tmp_path / "out" / "output.json").read_text())
    r0 = driver.run(base, output_dir=tmp_path / "single", device="cpu",
                    verbose=False)
    (e1,), (e0,) = _ev(got), _ev(r0)
    assert abs(e1 - e0) / abs(e0) < 1e-12


def test_solve_shifts_workers_equal_one_worker(tokamak_cfg):
    """sparse_eigen.solve_shifts with two worker threads returns what one
    worker returns, shift by shift, in shift order."""
    p = et.from_config(dict(tokamak_cfg, npoints=32), device="cpu")
    sigmas = [GUESS, -0.75 + 0.3j, -0.7 + 0.2j]
    kw = dict(tol=1e-6, m_krylov=4, quad=QUAD, block=8, band_deta=10.0)
    one = se.solve_shifts(p, sigmas, **kw)
    two = se.solve_shifts(p, sigmas, workers=2, **kw)
    assert len(one) == len(two) == 3
    for (o1, v1, n1), (o2, v2, n2) in zip(one, two):
        assert (o1, n1) == (o2, n2)
        assert torch.equal(v1, v2)
