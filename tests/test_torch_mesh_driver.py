"""The mesh paths of emme_tpu_torch.driver and its command line on gloo
ranks (``device="cpu"``): the dense and sparse backends over a rows mesh,
the rows x scan topology for a scan and for shifts, and the mesh x method
combinations (tests/test_spike.py:159-204, :226-269, :326-378), against
the port's single-process driver and emme_tpu's driver (PIC and the command
line: tests/test_torch_mesh_pic.py).  Every run spawns its ranks through
parallel.mesh.launch; only rank 0 writes output.json."""
import json

import numpy as np
import pytest
import torch

from emme_tpu import driver as jdriver
from emme_tpu_torch import driver
from emme_tpu_torch.ops.sparse import load_bdia_dump
from emme_tpu_torch.parallel import mesh as mesh_mod

torch.set_num_threads(2)

QUAD = {"n_shoulder": 8, "n_osc": 16, "n_tail": 4}


@pytest.fixture(autouse=True)
def _deadline(monkeypatch):
    """The driver's spawns here end within 300 s whatever happens (its
    default deadline is an hour)."""
    monkeypatch.setattr(mesh_mod, "DEADLINE_S", 300.0)


def _ev(res, key="(None)"):
    return [complex(*r["eigenvalue"]) for r in res["result"][key]["scan_result"]]


def _run(cfg, out, **kw):
    return driver.run(cfg, output_dir=out, device="cpu", verbose=False,
                      quad=QUAD, **kw)


@pytest.fixture(scope="module")
def base(tokamak_cfg):
    return dict(tokamak_cfg, npoints=32, method="eigen",
                initial_guess=[-0.8, 0.25], iteration_precision=1e-6,
                quad_guard="off")


def test_driver_mesh_dense_matches_jax_mesh(tmp_path, base):
    """"mesh": {"rows": 4} on the dense backend (the pair-sharded
    assembly): omega of the port's meshless run within 1e-12 and of
    emme_tpu's 4-device mesh run within 1e-10 (test_spike.py:190-204);
    one output.json, the dense dump of 32 x 32 complex128."""
    r1 = _run(dict(base, mesh={"rows": 4}), tmp_path / "mesh")
    r0 = _run(base, tmp_path / "single")
    rj = jdriver.run(dict(base, mesh={"rows": 4}), output_dir=tmp_path / "j",
                     verbose=False, quad=QUAD)
    (e1,), (e0,), (ej,) = _ev(r1), _ev(r0), _ev(rj)
    assert abs(e1 - e0) / abs(e0) < 1e-12
    assert abs(e1 - ej) / abs(ej) < 1e-10
    assert json.loads((tmp_path / "mesh" / "output.json").read_text()) == r1
    dump = tmp_path / "mesh" / "eigenMatrics" / "eigenMatrix.bin"
    assert np.fromfile(dump, dtype=np.complex128).size == 32 * 32
    assert r1["result"]["(None)"]["scan_result"][0]["iteration_steps"] == \
        r0["result"]["(None)"]["scan_result"][0]["iteration_steps"]


def test_driver_mesh_sparse_end_to_end(tmp_path, base):
    """The sparse backend over "mesh": {"rows": 2} runs the SPIKE solve:
    omega of the meshless run within 1e-11 (test_spike.py:159-187), its
    sparse_stats name the mesh, and the BDIA dump of the gathered operator
    loads back."""
    sp = dict(base, eigen_backend="sparse", band_block=8, band_deta=10.0)
    r1 = _run(dict(sp, mesh={"rows": 2}), tmp_path / "mesh")
    r0 = _run(sp, tmp_path / "single")
    (e1,), (e0,) = _ev(r1), _ev(r0)
    assert abs(e1 - e0) / abs(e0) < 1e-11
    stats = r1["result"]["(None)"]["scan_result"][0]["sparse_stats"]
    assert stats["mesh_rows"] == 2 and stats["block"] == 8
    op = load_bdia_dump(tmp_path / "mesh" / "eigenMatrics" /
                        "eigenMatrix.bin", device="cpu")
    assert op.n == 32 and op.block == 8


def test_driver_mesh_method_combos(tmp_path, base):
    """Every mesh x iteration_method combination works or fails as
    emme_tpu's (test_spike.py:357-378): dense + mesh + QRSecant raises the
    JAX package's ValueError; sparse + mesh + QRSecant runs the distributed
    bordered update and lands on the meshless bordered solve's omega,
    1e-9."""
    cfg = dict(base, iteration_method="QRSecant", mesh={"rows": 2})
    with pytest.raises(ValueError, match="single-device") as mine:
        driver.run(dict(cfg, eigen_backend="dense"), output_dir=tmp_path / "d",
                   device="cpu", verbose=False, checkpoint=False)
    with pytest.raises(ValueError, match="single-device") as ref:
        jdriver.run(dict(cfg, eigen_backend="dense"),
                    output_dir=tmp_path / "jd", verbose=False,
                    checkpoint=False)
    assert str(mine.value) == str(ref.value)
    sp = dict(cfg, eigen_backend="sparse", band_block=8, band_deta=10.0)
    out = _run(sp, tmp_path / "s", checkpoint=False)
    single = dict(sp)
    del single["mesh"]
    (e1,), (e0,) = _ev(out), _ev(_run(single, tmp_path / "s0"))
    assert abs(e1 - e0) / abs(e0) < 1e-9


def test_driver_mesh_rows_scan_end_to_end(tmp_path, base):
    """The 2 x 2 topology from the input file: a 4-point eta_i scan runs
    two points at a time, each over its 2-rank group, in wavefront batches;
    every omega within 1e-5 of the sequential meshless walk
    (test_spike.py:226-250), the checkpoint gone at the end."""
    sc = dict(base, eigen_backend="sparse", band_block=8, band_deta=10.0,
              eta_i={"head": 3.13, "step": 0.1, "tail": 3.43})
    r0 = _run(sc, tmp_path / "seq")
    r1 = _run(dict(sc, mesh={"rows": 2, "scan": 2}), tmp_path / "mesh")
    assert r1["result"]["eta_i"]["scan_values"] == \
        r0["result"]["eta_i"]["scan_values"]
    e0, e1 = _ev(r0, "eta_i"), _ev(r1, "eta_i")
    assert len(e0) == len(e1) == 4
    for a, b in zip(e0, e1):
        assert abs(a - b) / abs(a) < 1e-5
    assert not (tmp_path / "mesh" / "checkpoint.json").exists()
    assert len(list((tmp_path / "mesh" / "eigenMatrics").glob("*.bin"))) == 4


def test_driver_shifts_rows_scan(tmp_path, base):
    """"shifts" fan out over the scan groups, each solve over its group's
    rows (test_spike.py:253-269): both shifts land on the banded tok32
    eigenvalue of the meshless run, in shift order."""
    sh = dict(base, eigen_backend="sparse", band_block=8, band_deta=10.0,
              shifts=[[-0.8, 0.25], [-0.75, 0.3]])
    del sh["initial_guess"]
    r = _run(dict(sh, mesh={"rows": 2, "scan": 2}), tmp_path / "shifts")
    r0 = _run(sh, tmp_path / "single")
    out = r["result"]["shifts"]["scan_result"]
    assert [o["shift"] for o in out] == [[-0.8, 0.25], [-0.75, 0.3]]
    for a, b in zip(_ev(r, "shifts"), _ev(r0, "shifts")):
        assert abs(a - b) / abs(b) < 1e-9
