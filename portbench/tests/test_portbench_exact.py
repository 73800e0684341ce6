"""The exact cell (``tokamak_itg.exact_f64.eta_scan.n1024``): its traffic
resolves, its check tells the program's answer from the controls and from
a broken Newton step on the CPU at a small npoints, and its N1 roofline
reads a synthetic trace."""

import copy
import json
import math
import pathlib
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import calibrate_exact, harness
from portbench.reference import adaptive as ref

BENCH = json.loads((pathlib.Path(harness.ROOT) / "BENCHMARK.json")
                   .read_text())
CPU = torch.device("cpu")
EXACT = calibrate_exact.WORKLOAD
_BRANCH = {}


def small():
    """The cell at npoints 32, its branch worked out again there by the
    reference's own float64 TraceSecant at three nodes, once a test run."""
    cell = harness.Cell(BENCH, EXACT)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["set"]["npoints"] = 32
    cell.traffic["warmup"] = 1
    cell.traffic["check"]["rows"] = 8
    if "branch" not in _BRANCH:
        (key, (lo, hi)), = cell.traffic["draw"].items()
        at = [0.5 * (lo + hi) - 0.5 * (hi - lo) * math.cos(math.pi * (i + 0.5)
                                                             / 3)
              for i in range(3)]
        inp = dict(cell.config["input"], **cell.traffic["set"])
        om = []
        for x in at:
            w, _v, _s = ref.trace_secant(dict(inp, **{key: x}),
                                         complex(*inp["initial_guess"]),
                                         1e-6, 20)
            om.append([w.real, w.imag])
        _BRANCH["branch"] = {"at": at, "omega": om}
    cell.traffic["branch"] = _BRANCH["branch"]
    return cell


def test_the_traffic_resolves():
    cell = harness.Cell(BENCH, EXACT)
    t = cell.traffic
    assert t["entry"] == "exact" and t["dtype"] == "float64"
    assert t["set"]["eigen_backend"] == "exact"
    assert t["set"]["npoints"] == 1024
    inp = dict(cell.config["input"], **t["set"])
    assert ref.tolerances(inp) == (1e-6, 1e-6, 100)
    assert inp["integration_start_points"] == 15
    assert inp["iteration_precision"] == 1e-6
    assert len(t["branch"]["at"]) == len(t["branch"]["omega"]) == 5
    names = {m["name"] for m in cell.per_layer}
    assert "n1_roofline.eigen" in names
    assert not names & {"guard_share.eigen", "k1_roofline.eigen"}
    entry = cell.entry(2**33 + 17, CPU)
    assert [s for _m, _a, s, _k in entry.spans()] == ["solver", "assembly"]
    on_card = cell.entry(1, torch.device("cuda"))
    assert [s for _m, _a, s, _k in on_card.spans()][-1] == "n1"


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
    records = calibrate_exact.control_answers(entry, kind, [0, 1, 2])
    assert _limits_beaten(entry.check(records))


def test_a_newton_step_keeping_its_state(monkeypatch):
    """The step's update computed as zero: omega stays at the start and
    the loop stops there."""
    from emme_tpu_torch.solvers import eigen_native
    monkeypatch.setattr(eigen_native.linalg, "complex_solve_trace",
                        lambda M, dM: torch.tensor(math.inf,
                                                   dtype=M.dtype))
    res = harness.run_cell(small(), 2**33 + 3, 1.0, False, CPU,
                           time.perf_counter(), log=lambda _m: None)
    assert not res["correct"]


def test_a_program_without_the_backend_stops_in_setup(monkeypatch):
    from emme_tpu_torch import driver

    def refuse(cfg, *a, **k):
        raise ValueError(f"eigen_backend must be 'dense' or 'sparse', got "
                         f"{cfg['eigen_backend']!r}")
    monkeypatch.setattr(driver, "solve_once_eigen", refuse)
    with pytest.raises(RuntimeError, match="warm-up"):
        harness.run_cell(small(), 5, 1.0, False, CPU, time.perf_counter(),
                         log=lambda _m: None)


def test_n1_roofline_reads_a_synthetic_trace():
    """Two launches of 10 panels and 100 Miller steps each under G7K15 in
    2 ms of ``adaptive_kernel``: their operations over the peak over 2 ms."""
    from portbench.roofline import n1
    reader = harness.load_module(harness.PKG / "layers"
                                 / "n1_roofline.eigen.py", "x_n1")
    kept = {("n1", "window"): [{"panels": torch.tensor(10),
                                "miller": torch.tensor(100),
                                "order": 15}] * 2}
    summary = {"names": ["adaptive_kernel<true>", "other",
                         "adaptive_kernel<true>"],
               "durs": np.array([1_000_000, 5, 1_000_000], dtype=np.int64)}
    ctx = SimpleNamespace(spans=SimpleNamespace(kept=kept), summary=summary,
                          kernels=lambda s: [i for i, n in
                                             enumerate(summary["names"])
                                             if s in n])
    want = 100.0 * 2 * n1.flop(10, 100, 15) / n1.PEAK_F64_FLOP_PER_S / 2e-3
    assert reader.read(ctx) == pytest.approx(want)
    ctx.spans.kept = {}
    assert reader.read(ctx) is None
