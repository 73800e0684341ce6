"""The electromagnetic exact cell (``stellarator_em.exact_f64.guess_scan.
n1024``): its traffic resolves, its check tells the program's answer from
the controls and from an assembly without the electron terms on the CPU
at npoints 32, and its two readers read synthetic traces."""

import copy
import json
import pathlib
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import calibrate_exact_em, harness
from portbench.reference import adaptive_em as ref

BENCH = json.loads((pathlib.Path(harness.ROOT) / "BENCHMARK.json")
                   .read_text())
CPU = torch.device("cpu")
CELL = calibrate_exact_em.WORKLOAD
# 0.01 off the stel32 root in Re and Im: the input's own guess takes 17
# steps at npoints 32
GUESS = [-0.474, 0.627]
_BRANCH = {}


def small():
    """The cell at npoints 32 from ``GUESS``, its branch worked out again
    there by the reference's own float64 TraceSecant, once a test run."""
    cell = harness.Cell(BENCH, CELL)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["set"]["npoints"] = 32
    cell.traffic["guess"] = GUESS
    cell.traffic["warmup"] = 1
    cell.traffic["check"]["rows"] = 8
    if "branch" not in _BRANCH:
        inp = dict(cell.config["input"], **cell.traffic["set"])
        w, _v, _s = ref.trace_secant(inp, complex(*GUESS), 1e-6, 100)
        _BRANCH["branch"] = {"omega": [[w.real, w.imag]]}
    cell.traffic["branch"] = _BRANCH["branch"]
    return cell


def test_the_traffic_resolves():
    cell = harness.Cell(BENCH, CELL)
    t = cell.traffic
    assert t["entry"] == "exact_em" and t["dtype"] == "float64"
    assert t["set"]["eigen_backend"] == "exact"
    assert t["set"]["npoints"] == 1024
    assert t["guess"] == "input" and t["guess_offset"] == 0.01
    inp = dict(cell.config["input"], **t["set"])
    assert inp == dict(cell.config["input"], npoints=1024,
                       eigen_backend="exact")   # the file's own keys
    assert ref.es.tolerances(inp) == (1e-5, 1e-2, 20)
    assert inp["integration_start_points"] == 31
    assert inp["beta_e"] != 0.0
    assert t["check"]["requests"] == 3 and t["check"]["rows"] == 16
    assert len(t["branch"]["omega"]) == 1 and "at" not in t["branch"]
    names = {m["name"] for m in cell.per_layer}
    assert {"n1_roofline.eigen", "electron_share.eigen",
            "n1_panels_per_integral.eigen"} <= names
    assert not names & {"guard_share.eigen", "k1_roofline.eigen"}
    entry = cell.entry(2**33 + 17, CPU)
    assert [s for _m, _a, s, _k in entry.spans()] == ["solver", "assembly"]
    rows = entry.check_rows()
    assert len(rows) == 16 and (rows < 1024).sum() == 8
    assert len(set(rows.tolist())) == 16 and rows.max() < 2048
    on_card = cell.entry(1, torch.device("cuda"))
    assert [s for _m, _a, s, _k in on_card.spans()][-1] == "n1"


def test_the_n1_keep_counts_integrals():
    entry = harness.Cell(BENCH, CELL).entry(1, torch.device("cuda"))
    keep = entry.spans()[-1][3]
    rows = torch.zeros(6, 4, dtype=torch.float64)
    out = (None, torch.tensor([1, 1, 2, 1, 1, 3]), torch.arange(6))
    kept = keep("window", (rows, None, SimpleNamespace(order=31)), {}, out)
    assert kept["integrals"] == 6 and int(kept["panels"]) == 9
    assert kept["order"] == 31
    assert keep("setup", (rows, None, None), {}, out) is None


def _limits_beaten(checks):
    return [c for c in checks if c["value"] > c["limit"]]


def test_a_sound_run_is_correct():
    res = harness.run_cell(small(), 2**33 + 3, 1.0, False, CPU,
                           time.perf_counter(), log=lambda _m: None)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("kind", ["program_dense_f32", "omega_1e-8"])
def test_a_control_fails_the_check(kind):
    cell = small()
    entry = cell.entry(2**33 + 11, CPU)
    records = calibrate_exact_em.control_answers(entry, kind, [0, 1, 2])
    assert _limits_beaten(entry.check(records))


def test_an_assembly_without_the_electron_terms(monkeypatch):
    """The electron closed forms of moments 1 and 2 left out of the
    program's assembly: one request's answer misses the check."""
    from emme_tpu_torch import native
    monkeypatch.setattr(native.adaptive, "kappa_electron",
                        lambda ph, m, eta, eta_p, omega: torch.zeros(
                            torch.broadcast_shapes(m.shape, eta.shape),
                            dtype=torch.complex128))
    entry = small().entry(2**33 + 3, CPU)
    records = [entry.request(0)]
    assert records[0]["failed"] or _limits_beaten(entry.check(records))


def _reader(name):
    return harness.load_module(harness.PKG / "layers" / f"{name}.py",
                               f"x_{name.replace('.', '_')}")


def test_electron_share_reads_a_synthetic_trace(monkeypatch):
    """Three device operations of 100, 50 and 10 ns, the second launched
    inside ``layer.assembly.electron``: 50 / 160.  Nothing from a program
    whose ``SPANS`` lacks the span; raises where it names it and it never
    opened."""
    from emme_tpu_torch.utils import timer
    reader = _reader("electron_share.eigen")
    summary = {"durs": np.array([100, 50, 10], dtype=np.int64),
               "launch": np.array([5, 25, -1], dtype=np.int64),
               "spans": {"layer.assembly.electron":
                         np.array([[20, 30]], dtype=np.int64)}}
    ctx = SimpleNamespace(summary=summary)
    assert reader.read(ctx) == pytest.approx(100.0 * 50 / 160)
    monkeypatch.setattr(timer, "SPANS", tuple(
        s for s in timer.SPANS if s != "layer.assembly.electron"))
    assert reader.read(ctx) is None
    monkeypatch.undo()
    summary["spans"] = {}
    with pytest.raises(RuntimeError, match="never opened"):
        reader.read(ctx)


def test_n1_panels_per_integral_reads_a_synthetic_trace():
    """Two launches: 1,000 integrals in 1,050 panels and 10 in 30."""
    reader = _reader("n1_panels_per_integral.eigen")
    kept = {("n1", "window"): [
        {"panels": torch.tensor(1050), "miller": torch.tensor(1),
         "order": 31, "integrals": 1000},
        {"panels": torch.tensor(30), "miller": torch.tensor(1),
         "order": 31, "integrals": 10}]}
    ctx = SimpleNamespace(spans=SimpleNamespace(kept=kept))
    assert reader.read(ctx) == pytest.approx(1080 / 1010)
    ctx.spans.kept = {}
    assert reader.read(ctx) is None
    # the exact entry's keep, without the count: nothing to read
    ctx.spans.kept = {("n1", "window"): [{"panels": torch.tensor(1),
                                           "miller": torch.tensor(1),
                                           "order": 15}]}
    assert reader.read(ctx) is None
