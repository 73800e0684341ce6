"""The survey cell (``tokamak_itg.dense_f32.arnoldi_shifts16.n1024``): its
configuration and traffic resolve, its check tells a sound survey from the
controls and from faults on the CPU at a small npoints, and its readers
read synthetic traces."""

import copy
import json
import math
import pathlib
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import calibrate_survey, harness, tracing
from portbench.entries.eigen import STRATA
from portbench.reference import operator as ref_op
from portbench.roofline import common, lu

BENCH = json.loads((pathlib.Path(harness.ROOT) / "BENCHMARK.json")
                   .read_text())
CPU = torch.device("cpu")
CELL = calibrate_survey.WORKLOAD
SEEDS = (5, 2**33 + 17)
NEW = ("survey_lu_share.survey", "survey_sweep_share.survey",
       "launches_per_shift.survey", "shift_lu_roofline.survey")
# the dense cells' readers, under the names of this cell's end-to-end
# metric (theirs move eigenpairs_per_s, which a survey does not report)
TWINS = ("device_idle", "k1_roofline", "assembly_share",
         "assembly_idle_share")
_BRANCH = {}


def bench_arnoldi_shifts():
    """benchmarks/bench_arnoldi.py's sixteen shifts."""
    rng = np.random.default_rng(0)
    return (-0.8 + 0.25j) + 0.15 * (rng.normal(size=16)
                                    + 1j * rng.normal(size=16))


def test_the_configuration_and_traffic_resolve():
    cell = harness.Cell(BENCH, CELL)
    assert cell.config["name"] == "tokamak_itg_survey"
    assert cell.config["reduced"] == ["hosts"] and "hosts" in \
        cell.config["assumed"]
    t = cell.traffic
    assert t["entry"] == "survey" and t["dtype"] == "float32"
    assert t["set"] == {"npoints": 1024} and t["m_krylov"] == 24
    assert t["draw"] == {"eta_i": [2.9, 3.4]} and t["warmup"] == 2
    shifts = np.array([complex(*s) for s in t["shifts"]])
    assert np.array_equal(shifts, bench_arnoldi_shifts())
    dense = harness.Cell(BENCH, "tokamak_itg.dense_f32.eta_scan.n1024")
    assert t["branch"] == dense.traffic["branch"]
    assert set(t["control"]) == set(calibrate_survey.CONTROLS)
    assert {m["name"] for m in cell.end_to_end} == {"solve_p90_s",
                                                    "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert names == set(NEW) | {f"{t}.survey" for t in TWINS}
    assert all(m["moves"] == "solve_p90_s" for m in cell.per_layer)
    entry = cell.entry(2**33 + 17, CPU)
    assert [s for _m, _a, s, _k in entry.spans()] == ["solver", "assembly"]
    on_card = cell.entry(1, torch.device("cuda"))
    assert [s for _m, _a, s, _k in on_card.spans()] == ["solver", "assembly",
                                                         "k1"]


@pytest.mark.parametrize("seed", SEEDS)
def test_requests_repeat_for_a_seed_and_keep_the_strata(seed):
    cell = harness.Cell(BENCH, CELL)
    a = [cell.entry(seed, CPU).inputs(k)["eta_i"] for k in range(STRATA)]
    b = [cell.entry(seed, CPU).inputs(k)["eta_i"] for k in range(STRATA)]
    other = [cell.entry(SEEDS[0] + SEEDS[1] - seed, CPU).inputs(k)["eta_i"]
             for k in range(STRATA)]
    assert a == b and a != other
    cells = sorted(int((v - 2.9) / 0.5 * STRATA) for v in a)
    assert cells == list(range(STRATA))   # one value a stratum
    assert cell.entry(seed, CPU).inputs(-1)["eta_i"] == pytest.approx(3.15)


# the limits at npoints 32, float32 on the CPU, from the readings there: a
# sound survey's estimates lie within 9.6e-6 of the reference's and its
# nearest within 0.026 of the mode; the faults below read 8e-4 (a 2-step
# sweep) to 0.58 (the mode missed)
SMALL_LIMITS = {"estimate_gap": 5e-5, "mode_gap": 0.1}


def small():
    """The cell at npoints 32, one warm-up, one sampled request, the limits
    of that size; its branch worked out again there by the reference's
    float64 TraceSecant at three nodes, once a test run."""
    cell = harness.Cell(BENCH, CELL)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["set"]["npoints"] = 32
    cell.traffic["warmup"] = 1
    cell.traffic["check"]["requests"] = 1
    cell.traffic["check"]["limits"] = dict(SMALL_LIMITS)
    if "branch" not in _BRANCH:
        inp = dict(cell.config["input"], npoints=32)
        at = [2.95, 3.15, 3.35]
        om = []
        for x in at:
            w, _v, _s = ref_op.trace_secant(dict(inp, eta_i=x),
                                            complex(*inp["initial_guess"]),
                                            1e-6, 20, dtype=torch.float64)
            om.append([w.real, w.imag])
        _BRANCH["branch"] = {"at": at, "omega": om}
    cell.traffic["branch"] = _BRANCH["branch"]
    return cell


def run(cell=None, trace=False):
    return harness.run_cell(cell or small(), 2**33 + 3, 1.0, trace, CPU,
                            time.perf_counter(), log=lambda _m: None)


def _beaten(res):
    return [k for k, c in res["checks"].items() if c["value"] > c["limit"]]


def test_a_sound_traced_run_is_correct():
    res = run(trace=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["checks"]) == {"estimate_gap", "mode_gap"}


def _patched_survey(monkeypatch, fault):
    from emme_tpu_torch.solvers import arnoldi
    survey = arnoldi.solve_shifts_batched

    def broken(p, sigmas, m_krylov=24, **kw):
        sigmas = np.asarray(sigmas)
        if fault == "sweep_2":
            return survey(p, sigmas, m_krylov=2, **kw)
        if fault == "shifts_re_-0.5":
            return survey(p, sigmas - 0.5, m_krylov=m_krylov, **kw)
        ests = survey(p, sigmas, m_krylov=m_krylov, **kw).copy()
        ests[:16] = ests[:16].reshape(-1, 2)[:, ::-1].reshape(-1)
        return ests
    monkeypatch.setattr(arnoldi, "solve_shifts_batched", broken)


# what each fault moves past its limit.  A 12-step sweep is no fault: the
# leading Ritz value of every shift has converged by the sixth step (at
# npoints 32 here and at 1024 on the card), so its estimates are the
# 24-step sweep's; a 2-step sweep is the short one.  The shifts move 0.5
# away from tok32's mode, which lies 0.25 to the right of them (0.5 to the
# right lands on it; at npoints 1024 the card's M(sigma) there is singular)
FAULTS = {"neighbours_swapped": {"estimate_gap"},
          "sweep_2": {"estimate_gap"},
          "shifts_re_-0.5": {"estimate_gap", "mode_gap"}}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_fails_the_check(fault, monkeypatch):
    _patched_survey(monkeypatch, fault)
    res = run()
    assert not res["correct"]
    assert FAULTS[fault] <= set(_beaten(res)), res["checks"]


def test_the_controls_fail_the_check():
    """The TF32 reference in the program's place, and the controls that
    stand for the faults above, each beat a limit."""
    cell = small()
    n = int(cell.traffic["check"]["requests"])
    for kind in ("reference_tf32", "sweep_2", "neighbours_swapped",
                 "shifts_re_-0.5"):
        entry = cell.entry(2**33 + 11, CPU)
        records = calibrate_survey.control_answers(entry, kind,
                                                   list(range(n)))
        checks = entry.check(records)
        assert any(c["value"] > c["limit"] for c in checks), (kind, checks)


def test_a_failed_survey_is_counted_and_not_judged(monkeypatch):
    from emme_tpu_torch.solvers import arnoldi
    monkeypatch.setattr(arnoldi, "solve_shifts_batched",
                        lambda p, s, **kw: np.full(len(s), np.nan + 0j))
    entry = small().entry(1, CPU)
    rec = entry.request(0)
    assert rec["failed"]
    with pytest.raises(RuntimeError, match="warm-up survey failed"):
        entry.setup()
    checks = {c["name"]: c["value"] for c in entry.check([rec])}
    assert checks == {"estimate_gap": math.inf, "mode_gap": math.inf}


# -- the readers -------------------------------------------------------------

def reader(name):
    return harness.load_module(harness.PKG / "layers" / f"{name}.py",
                               f"portbench_layer_{name.replace('.', '_')}")


def iv(*pairs):
    return np.array(pairs, dtype=np.int64).reshape(-1, 2)


def survey_summary():
    """Six device operations, 400 ns in all, two of them copies: launched
    at 15 and 25 (inside ``layer.survey.secant``), 55 and 65 (inside
    ``layer.survey.lu``), 85 (``layer.survey.sweep``) and never (-1)."""
    return {
        "window_s": 1e-6,
        "starts": np.arange(6, dtype=np.int64) * 100,
        "durs": np.array([50, 50, 100, 60, 40, 100], dtype=np.int64),
        "launch": np.array([15, 25, 55, 65, 85, -1], dtype=np.int64),
        "copy": np.array([False, True, False, False, True, False]),
        "spans": {"layer.survey.secant": iv((10, 30)),
                  "layer.survey.lu": iv((50, 70)),
                  "layer.survey.sweep": iv((80, 90)),
                  "layer.survey.ritz": iv((95, 99))}}


def survey_ctx(summary=None):
    kept = {("solver", "window"): [{"shifts": 16, "n": 1024},
                                   {"shifts": 16, "n": 1024}]}
    records = [{"failed": False, "shifts": 16}, {"failed": False,
                                                 "shifts": 16},
               {"failed": True}]
    summary = summary or survey_summary()
    return tracing.Context(cell=None, entry=None, records=records,
                           summary=summary,
                           spans=SimpleNamespace(kept=kept),
                           window_s=summary["window_s"])


WANT = {"survey_lu_share.survey": 100.0 * 160 / 400,
        "survey_sweep_share.survey": 100.0 * 40 / 400,
        "launches_per_shift.survey": 4 / 32,
        "shift_lu_roofline.survey": 100.0 * 2 * lu.least_s(1024, 16)
        / 160e-9}
SPAN = {"survey_lu_share.survey": "layer.survey.lu",
        "survey_sweep_share.survey": "layer.survey.sweep",
        "shift_lu_roofline.survey": "layer.survey.lu"}


@pytest.mark.parametrize("name", NEW)
def test_reader_value(name):
    assert reader(name).read(survey_ctx()) == pytest.approx(WANT[name],
                                                            rel=1e-12)


@pytest.mark.parametrize("name", sorted(SPAN))
def test_reader_raises_naming_an_absent_span(name):
    c = survey_ctx()
    del c.summary["spans"][SPAN[name]]
    with pytest.raises(RuntimeError, match=SPAN[name].replace(".", r"\.")):
        reader(name).read(c)


@pytest.mark.parametrize("name", sorted(SPAN))
def test_reader_reads_nothing_from_a_program_before_the_span(name,
                                                            monkeypatch):
    """A program whose ``SPANS`` lacks the survey's spans (or that has no
    ``SPANS``) reads as no value, and raises nothing: the traced run of
    such a program leaves the metric out of its line."""
    from emme_tpu_torch.utils import timer
    monkeypatch.setattr(timer, "SPANS", tuple(
        s for s in timer.SPANS if not s.startswith("layer.survey.")))
    c = survey_ctx()
    del c.summary["spans"][SPAN[name]]
    assert reader(name).read(c) is None
    monkeypatch.delattr(timer, "SPANS")
    assert reader(name).read(survey_ctx()) is None


def test_launches_per_shift_reads_without_program_spans(monkeypatch):
    from emme_tpu_torch.utils import timer
    monkeypatch.delattr(timer, "SPANS")
    assert reader("launches_per_shift.survey").read(survey_ctx()) == 4 / 32


@pytest.mark.parametrize("twin", TWINS)
def test_twin_reads_as_the_eigen_reader(twin):
    """Each ``<metric>.survey`` reads what ``<metric>.eigen`` reads."""
    summary = survey_summary()
    summary.update(busy_s=3e-7, spans=dict(
        summary["spans"], **{"layer.assembly": iv((10, 30)),
                             "layer.assembly.pairs": iv((12, 20)),
                             "layer.assembly.place": iv((21, 29))}))
    summary["names"] = ["kappa_pairs_kernel", "copy", "getrf", "getrf",
                        "copy", "gemv"]
    c = survey_ctx(summary)
    c.spans.kept[("k1", "window")] = [{"shape": (64, 44, 15, 1)}]
    c.spans.kept[("k1", "setup")] = [{"shape": (64, 44, 15, 1),
                                      "asym": 0.25}]
    got = reader(f"{twin}.survey").read(c)
    assert got is not None and got == reader(f"{twin}.eigen").read(c)


def test_lu_count_by_hand():
    # (2/3) n^3 complex multiply-adds of 8 real operations a matrix, the
    # matrix read and written once as complex64
    flop, nbytes = lu.work(3, 2)
    assert flop == pytest.approx(2 * (2 / 3) * 27 * 8)
    assert nbytes == 2 * 2 * 8 * 9
    assert lu.least_s(1024, 16) == pytest.approx(
        16 * (2 / 3) * 1024 ** 3 * 8 / common.PEAK_F32_FLOP_PER_S)
