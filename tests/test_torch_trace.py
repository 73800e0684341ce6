"""The program's spans (``emme_tpu_torch.utils.timer``): on each path they
open under a torch profiler, their names, and their cost with no profiler.

Each path runs on CPU tensors under ``torch.profiler.profile`` (host
activity only) and is held to three rules: every span the path reaches
opens, every span that opens is in ``SPANS``, and no span opens inside a
span of its own name (the trace's reading of idle gaps takes the innermost
open span and relies on that).
"""

import collections
import json
import pathlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import emme_tpu_torch as et
from emme_tpu_torch import driver
from emme_tpu_torch.grid import Grid
from emme_tpu_torch.ops.singularity import singularity_coeff_matrix
from emme_tpu_torch.solvers import (arnoldi, cuda_pic, eigen, eigen_native,
                                    pic, sparse_eigen)
from emme_tpu_torch.utils.timer import SPANS, Timer, host_read, section, span

ROOT = pathlib.Path(__file__).resolve().parents[1]
GUESS = -0.8 + 0.25j


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread while this module runs: the suite's workers share
    the host's cores, and torch's pools in each of them starve the others
    (this module took minutes instead of seconds beside another worker)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _traced(fn):
    """Run ``fn()`` under a host profiler: (its result, [(name, start,
    end)] of every program span, in start order)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("layer."))
    return out, sorted(spans, key=lambda s: s[1])


def _nested_in_own_name(spans):
    """Spans that start inside an earlier span of the same name."""
    last_end = {}
    bad = []
    for name, t0, t1 in spans:
        if name in last_end and t0 < last_end[name]:
            bad.append(name)
        last_end[name] = max(last_end.get(name, t0), t1)
    return bad


def _input(name, **kw):
    with open(ROOT / "tests" / "goldens" / "inputs" / name) as f:
        return dict(json.load(f), **kw)


def _dense():
    return driver.solve_once_eigen(_input("tokamak.json", npoints=64), GUESS,
                                   dtype=torch.float32, device="cpu")


def _stellarator():
    cfg = _input("stellarator.json", npoints=16)
    return driver.solve_once_eigen(cfg, complex(*cfg["initial_guess"]),
                                   dtype=torch.float32, device="cpu")


def _banded():
    cfg = _input("tokamak.json", npoints=64, eigen_backend="sparse",
                 band_deta=10.0, band_block=16, m_krylov=4, spmv_method="bsr",
                 iteration_precision=1e-5)
    return driver.solve_once_eigen(cfg, GUESS, dtype=torch.float32,
                                   device="cpu")


def _pic(launch="auto"):
    p = et.from_config(_input("tokamak.json", npoints=128),
                       dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(0)
    return cuda_pic.run(p, 8, 2, 0.25, generator=gen, launch=launch)


def _survey():
    p = et.from_config(_input("tokamak.json", npoints=16),
                       dtype=torch.float32, device="cpu")
    return arnoldi.solve_shifts_batched(p, [GUESS, -0.7 + 0.3j], m_krylov=4)


SURVEY = {"layer.survey.secant", "layer.survey.lu", "layer.survey.sweep",
          "layer.survey.ritz"}
EIGEN = {"layer.driver.params", "layer.driver.guard", "layer.solve.setup",
         "layer.assembly.pairs", "layer.assembly.place", "layer.linalg.step",
         "layer.linalg.vector", "layer.host_read"}
PIC_SETUP = ("layer.pic.params", "layer.pic.qn", "layer.pic.arrs")
PATHS = {
    "dense": (_dense, EIGEN),
    "stellarator": (_stellarator, EIGEN),
    "banded": (_banded, EIGEN | {"layer.linalg.arnoldi"}),
    "pic": (_pic, {"layer.pic.setup", "layer.pic.k3", "layer.pic.state",
                   "layer.host_read", *PIC_SETUP}),
    "survey": (_survey, SURVEY | {"layer.assembly.pairs",
                                  "layer.assembly.place", "layer.host_read"}),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_path_opens_its_spans(path):
    fn, reached = PATHS[path]
    _, spans = _traced(fn)
    opened = {name for name, _, _ in spans}
    assert reached <= opened, sorted(reached - opened)
    assert opened <= set(SPANS), sorted(opened - set(SPANS))
    assert not _nested_in_own_name(spans)
    if path != "survey":   # the banded Arnoldi stage opens none of them
        assert not opened & SURVEY, sorted(opened & SURVEY)


def test_survey_spans_its_stages():
    """A survey opens each of its four spans once, in order; its 2S
    assemblies (their pairs and place spans) lie inside
    ``layer.survey.secant`` and its one host read, of the Hessenbergs,
    inside ``layer.survey.ritz``."""
    _, spans = _traced(_survey)
    names = collections.Counter(name for name, _, _ in spans)
    assert all(names[n] == 1 for n in SURVEY)
    assert [n for n, _, _ in spans if n in SURVEY] == [
        "layer.survey.secant", "layer.survey.lu", "layer.survey.sweep",
        "layer.survey.ritz"]
    at = {n: (t0, t1) for n, t0, t1 in spans if n in SURVEY}

    def within(name, outer):
        return all(at[outer][0] <= t0 and t1 <= at[outer][1]
                   for n, t0, t1 in spans if n == name)
    assert names["layer.assembly.pairs"] == names["layer.assembly.place"] == 4
    assert within("layer.assembly.pairs", "layer.survey.secant")
    assert within("layer.assembly.place", "layer.survey.secant")
    assert names["layer.host_read"] == 1
    assert within("layer.host_read", "layer.survey.ritz")
    assert not _nested_in_own_name(spans)


def test_pic_stages_path_spans_its_step_loop():
    """On K2's path ``layer.pic.k3`` covers the step loop, between the
    set-up and the state; every other span lies inside the set-up."""
    _, spans = _traced(lambda: _pic(launch="stages"))
    assert cuda_pic.LAST_LAUNCH == "stages"
    outer = [s for s in spans if s[0] in ("layer.pic.setup", "layer.pic.k3",
                                          "layer.pic.state")]
    assert [name for name, _, _ in outer] == [
        "layer.pic.setup", "layer.pic.k3", "layer.pic.state"]
    (_, s0, s1), (_, k0, k1), (_, t0, _) = outer
    assert s1 <= k0 and k1 <= t0
    assert all(s0 <= a and b <= s1 for n, a, b in spans
               if (n, a, b) not in outer)


def _inside(spans, inner, outer):
    """How many spans named ``inner`` lie inside a span named ``outer``."""
    boxes = [(t0, t1) for n, t0, t1 in spans if n == outer]
    return sum(any(a <= t0 and t1 <= b for a, b in boxes)
               for n, t0, t1 in spans if n == inner)


def _within(spans, inner, outer):
    """Each span named ``inner`` lies inside a span named ``outer``."""
    return _inside(spans, inner, outer) == sum(1 for n, _, _ in spans
                                               if n == inner)


# a PIC request's blocking reads: ``FusedStep.params_vec``'s copies of p's
# scalars (length, cell width twice, vt, b_theta, shat, omega_d_bar, q R)
# and ``pic.calculate_omega``'s copy of the statistics
PARAMS_READS = 8
PIC_REQUEST_READS = PARAMS_READS + 1


@pytest.mark.parametrize("launch", ["auto", "stages"])
def test_pic_setup_opens_its_three_parts(launch):
    """``cuda_pic.run`` opens ``layer.pic.params`` (``FusedStep``),
    ``.qn`` and ``.arrs`` once each, in that order, inside
    ``layer.pic.setup``; ``params_vec``'s eight reads of p's scalars lie
    inside ``layer.pic.params``."""
    _pic(launch=launch)   # the K4 self-check's read, once a process
    _, spans = _traced(lambda: _pic(launch=launch))
    names = collections.Counter(name for name, _, _ in spans)
    assert [n for n, _, _ in spans if n in PIC_SETUP] == list(PIC_SETUP)
    assert all(_within(spans, n, "layer.pic.setup") for n in PIC_SETUP)
    assert names["layer.pic.setup"] == 1
    assert names["layer.host_read"] == PARAMS_READS
    assert _within(spans, "layer.host_read", "layer.pic.params")
    assert not _nested_in_own_name(spans)


@pytest.mark.parametrize("launch", ["auto", "stages"])
def test_pic_request_reads_are_spans(launch):
    """A PIC request as the benchmark makes one (``state_from_draws`` ->
    ``cuda_pic.run`` -> ``calculate_omega``) opens one ``layer.host_read``
    a blocking read: ``PIC_REQUEST_READS``, the K4 self-check's read made
    once a process before it."""
    p = et.from_config(_input("tokamak.json", npoints=128),
                       dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(1)
    n = 8 * 128
    draws = (torch.rand(n, generator=gen) * 2.0 * p.length - p.length,
             torch.randn(n, generator=gen), torch.randn(n, generator=gen),
             torch.rand(n, generator=gen) * 0.001)

    def request():
        state = pic.state_from_draws(p, *draws, dtype=torch.float32)
        stats, _, _ = cuda_pic.run(p, 8, 4, 0.25, state=state, launch=launch)
        return pic.calculate_omega(stats, 0.25)

    request()
    _, spans = _traced(request)
    names = collections.Counter(name for name, _, _ in spans)
    assert names["layer.host_read"] == PIC_REQUEST_READS
    assert _inside(spans, "layer.host_read", "layer.pic.params") \
        == PARAMS_READS


def _solve_tok32(backend):
    """One tok32 solve through ``backend``'s own solve function."""
    if backend == "exact":
        p = et.from_config(_input("tokamak.json", npoints=32),
                           dtype=torch.float64, device="cpu")
        return eigen_native.solve(p, GUESS)
    p = et.from_config(_input("tokamak.json", npoints=32),
                       dtype=torch.float32, device="cpu")
    if backend == "banded":
        return sparse_eigen.solve(p, GUESS, tol=1e-5, band_deta=10.0,
                                  block=16)
    return eigen.solve(p, GUESS, tol=1e-5)


@pytest.mark.parametrize("backend", ["dense", "banded", "exact"])
def test_solve_opens_its_setup_before_its_assemblies(backend):
    """``eigen.solve``, ``sparse_eigen.solve`` and ``eigen_native.solve``
    each open ``layer.solve.setup`` once a solve, and every assembly's
    spans after it ends; only the exact plan's ``layer.assembly.pairs``
    (and its ``layer.assembly.plan``) lie inside it."""
    _, spans = _traced(lambda: _solve_tok32(backend))
    setup = [(t0, t1) for n, t0, t1 in spans if n == "layer.solve.setup"]
    assert len(setup) == 1
    (s0, s1), = setup
    assembly = [(n, t0, t1) for n, t0, t1 in spans
                if n.startswith("layer.assembly.")]
    inside = collections.Counter(n for n, t0, t1 in assembly
                                 if s0 <= t0 and t1 <= s1)
    assert inside == ({"layer.assembly.pairs": 1, "layer.assembly.plan": 1}
                      if backend == "exact" else {})
    later = [t0 for n, t0, t1 in assembly if not (s0 <= t0 and t1 <= s1)]
    assert later and min(later) >= s1
    assert not _nested_in_own_name(spans)


@pytest.mark.parametrize("method", ["TraceSecant", "QRSecant",
                                    "BorderedSecant"])
def test_every_newton_step_opens_its_linear_algebra(method):
    """One ``layer.linalg.step`` a Newton step, before the step's assembly,
    whichever update the step takes; the host loop reads the done flag
    once a step under ``layer.host_read``."""
    p = et.from_config(_input("tokamak.json", npoints=32),
                       dtype=torch.float32, device="cpu")
    (_, _, steps, _), spans = _traced(
        lambda: eigen.solve(p, GUESS, tol=1e-5, method=method))
    names = collections.Counter(name for name, _, _ in spans)
    queued = eigen.LAST_SOLVE["queued_steps"]
    assert names["layer.linalg.step"] == queued >= steps
    assert names["layer.assembly.pairs"] == names["layer.assembly.place"] \
        == 2 + queued
    assert names["layer.linalg.vector"] == 1
    assert not _nested_in_own_name(spans)


@pytest.mark.parametrize("method", ["TraceSecant", "QRSecant"])
def test_exact_backend_opens_the_dense_paths_spans(method):
    """The driver's exact backend (``eigen_native.solve`` on
    ``native.assemble``): an assembly's two spans each assembly and the
    plan's ``layer.assembly.pairs`` once a solve, one ``layer.linalg.step``
    and one ``layer.host_read`` of d_omega a Newton step, one
    ``layer.linalg.vector``, the plan's read of the parameters, the result's
    copy read, and no guard; none nests in its own name."""
    cfg = _input("tokamak.json", npoints=32, eigen_backend="exact",
                 iteration_method=method)
    (res, _), spans = _traced(lambda: driver.solve_once_eigen(
        cfg, GUESS, dtype=torch.float64, device="cpu"))
    steps = res["iteration_steps"]
    names = collections.Counter(name for name, _, _ in spans)
    assert names["layer.assembly.pairs"] - 1 == names["layer.assembly.place"] \
        == steps + 2
    assert names["layer.linalg.step"] == steps
    assert names["layer.linalg.vector"] == 1
    assert names["layer.host_read"] == steps + 2
    assert names["layer.driver.params"] == 1
    assert names["layer.solve.setup"] == names["layer.assembly.plan"] == 1
    assert _within(spans, "layer.assembly.plan", "layer.assembly.pairs")
    assert "layer.driver.guard" not in names
    assert set(names) <= set(SPANS)
    assert not _nested_in_own_name(spans)


@pytest.mark.parametrize("conf", ["stellarator", "tokamak"])
def test_exact_backend_electron_span(conf):
    """``layer.assembly.electron``: once an assembly of the electromagnetic
    exact solve (stel32, from near its root), between the assembly's pairs
    and place spans, after the plan's pairs span; never on the
    electrostatic one (tok32)."""
    guess = {"stellarator": complex(-0.474, 0.627), "tokamak": GUESS}[conf]
    cfg = _input(f"{conf}.json", npoints=32, eigen_backend="exact")
    (res, _), spans = _traced(lambda: driver.solve_once_eigen(
        cfg, guess, dtype=torch.float64, device="cpu"))
    names = collections.Counter(name for name, _, _ in spans)
    assemblies = res["iteration_steps"] + 2
    assert names["layer.assembly.pairs"] == assemblies + 1
    assert names["layer.assembly.electron"] == (
        assemblies if conf == "stellarator" else 0)
    order = [n for n, _, _ in spans if n.startswith("layer.assembly.")]
    if conf == "stellarator":
        assert order == ["layer.assembly.pairs", "layer.assembly.plan"] + [
            "layer.assembly.pairs", "layer.assembly.electron",
            "layer.assembly.place"] * assemblies
    assert set(names) <= set(SPANS)
    assert not _nested_in_own_name(spans)


@pytest.mark.parametrize("loop", ["host", "device"])
def test_every_host_read_is_a_span(loop):
    """``layer.host_read`` spans a solve's reads: each counted blocking read
    (``eigen.HOST_READS``) and the read of the grid length that sizes the
    tiers.  On CPU tensors the device loop's flag polls wait for nothing
    (no event to synchronize), so they are counted and open no span."""
    p = et.from_config(_input("tokamak.json", npoints=32),
                       dtype=torch.float32, device="cpu")
    eigen.HOST_READS.update(blocking=0, flag_polls=0)
    _, spans = _traced(lambda: eigen.solve(p, GUESS, tol=1e-5, loop=loop))
    reads = sum(1 for name, _, _ in spans if name == "layer.host_read")
    assert reads == eigen.HOST_READS["blocking"] + 1
    queued = eigen.LAST_SOLVE["queued_steps"]
    assert eigen.HOST_READS == (
        {"blocking": queued + 1, "flag_polls": 0} if loop == "host"
        else {"blocking": 1, "flag_polls": queued - 1})


def _harness_span_names():
    """The span names the benchmark's harness wraps around entry points
    (the ``spans()`` tables of ``portbench/entries/*.py``), for every cell
    and with a card's table, which adds K1."""
    from portbench import harness
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = set()
    for w in bench["workloads"]:
        entry = harness.Cell(bench, w["name"]).entry(1, torch.device("cuda"))
        names |= {"layer." + s for _m, _a, s, _k in entry.spans()}
    return names


def test_span_names_keep_clear_of_the_harness():
    harness = _harness_span_names()
    assert {"layer.solver", "layer.assembly", "layer.k1", "layer.pic_state",
            "layer.pic_run", "layer.pic_fit"} <= harness
    assert {"layer.solve.setup", "layer.assembly.plan",
            *PIC_SETUP} <= set(SPANS)
    assert len(set(SPANS)) == len(SPANS)
    assert all(name.startswith("layer.") for name in SPANS)
    assert not set(SPANS) & harness


def test_no_profiler_no_record_function(monkeypatch):
    """With no profiler recording, a span enters no ``record_function`` and
    leaves the Timer table as it was; a host read still returns its value."""
    def refuse(*_a, **_k):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    before = (list(Timer.get_timer().entries), Timer.get_timer().timings())
    with span("assembly.pairs"), span("assembly.pairs"):
        pass
    assert host_read(torch.tensor(2.5).item) == 2.5
    p = et.from_config(_input("tokamak.json", npoints=16),
                       dtype=torch.float32, device="cpu")
    grid = Grid.create(p.length, 16, dtype=torch.float32, device="cpu")
    coeff = singularity_coeff_matrix(16, dtype=torch.float32, device="cpu")
    M = eigen.assemble_matrix(p, grid, coeff,
                              torch.tensor(GUESS, dtype=torch.complex64),
                              fused=True)
    assert M.shape == (16, 16)
    assert (list(Timer.get_timer().entries),
            Timer.get_timer().timings()) == before


def test_span_under_a_profiler_names_its_layer():
    _, spans = _traced(lambda: host_read(torch.ones(3).sum().item))
    assert [name for name, _, _ in spans] == ["layer.host_read"]
    with span("driver.guard"):
        pass   # no profiler: nothing recorded, nothing raised


def test_section_keeps_the_timer_table_and_pushes_no_nvtx(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("NVTX range pushed")
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", refuse)
    def output():
        with section("Output"):
            torch.ones(4).sum()

    t = Timer.get_timer()
    t.reset()
    try:
        with section("Iteration"):
            torch.ones(4).sum()
        _, spans = _traced(output)
        assert t.entries == ["Iteration", "Output"]
        assert all(v > 0 for v in t.timings().values())
        assert spans == []   # a section opens no span of its own
    finally:
        t.reset()
