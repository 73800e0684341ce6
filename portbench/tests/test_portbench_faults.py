"""``correct`` against faults and against the control, at sizes a CPU test
run holds.

Each test skips the harness's look for a card and drives the rest of a run
(``harness.run_cell``) on the CPU at a small npoints, where the kernels'
plain versions stand in for them.  A sound run comes out correct; with the
timed path broken underneath, or with the control in the program's place,
``correct`` comes out false.  The faults a cell can have:

* a step that returns its state unchanged;
* half of the batch left out, the mean taken over the rest (the PIC
  markers; an eigen request is one operator, with no batch);
* an answer altered where it is produced, and an eigenpair of another mode
  than the scan's.

No cell runs on more than one card, so no exchange between cards can be
left out.
"""

import copy
import json
import pathlib
import time

import pytest
import torch

from portbench import calibrate, harness

BENCH = json.loads((pathlib.Path(harness.ROOT) / "BENCHMARK.json")
                   .read_text())
CPU = torch.device("cpu")
DENSE = "tokamak_itg.dense_f32.eta_scan.n1024"
STEL = "stellarator_em.dense_f32.guess_scan.n1024"
PIC = "tokamak_itg.pic.marker_ensemble.n1024"
SMALL = {DENSE: dict(npoints=32), STEL: dict(npoints=16),
         PIC: dict(npoints=128, marker_per_cell=8, step_number=40)}


_BRANCH = {}


def small(name):
    """The cell at a small size, its branch worked out again there by the
    reference (``calibrate.branch_table``), once a session."""
    cell = harness.Cell(BENCH, name)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["set"].update(SMALL[name])
    cell.traffic["warmup"] = 1
    if cell.traffic["entry"] == "eigen":
        cell.traffic["check"]["rows"] = 8
        if name not in _BRANCH:
            table = calibrate.branch_table(cell.entry(0, CPU), 3)
            _BRANCH[name] = {k: table[k] for k in ("at", "omega")
                             if k in table}
        cell.traffic["branch"] = _BRANCH[name]
    return cell


def run(name, seed=2**33 + 3, seconds=1.0):
    return harness.run_cell(small(name), seed, seconds, False, CPU,
                            time.perf_counter(), log=lambda _m: None)


@pytest.mark.parametrize("name", [DENSE, STEL, PIC])
def test_a_sound_run_is_correct(name):
    res = run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("name", [DENSE, STEL])
def test_eigen_step_that_keeps_its_state(name, monkeypatch):
    from emme_tpu_torch.solvers import eigen
    monkeypatch.setitem(eigen._STEP_FNS, "TraceSecant",
                        lambda p, grid, coeff, state, **kw: state)
    assert not run(name)["correct"]


@pytest.mark.parametrize("name", [DENSE, STEL])
def test_eigen_answer_altered(name, monkeypatch):
    from emme_tpu_torch.solvers import eigen
    solve = eigen.solve

    def altered(*a, **kw):
        omega, vec, steps, state = solve(*a, **kw)
        return omega * (1.0 + 1e-3), vec, steps, state
    monkeypatch.setattr(eigen, "solve", altered)
    assert not run(name)["correct"]


@pytest.mark.parametrize("name", [DENSE, STEL])
def test_eigen_answer_on_another_root(name, monkeypatch):
    """A true eigenpair of another mode: its residual and omega shift are
    those of a sound answer, and only its distance from the branch tells."""
    from emme_tpu_torch.solvers import eigen
    solve = eigen.solve

    def elsewhere(p, omega_init, *a, **kw):
        return solve(p, complex(-1.2, 0.3), *a, **kw)
    monkeypatch.setattr(eigen, "solve", elsewhere)
    res = run(name)
    assert not res["correct"]
    assert res["checks"]["branch_gap"]["value"] > 0.1, res["checks"]


def _mega_patch(monkeypatch, fault):
    from emme_tpu_torch.solvers import cuda_pic
    mega = cuda_pic.mega

    def broken(dc, params, fr, fi, qn, arrs, n_steps):
        if fault == "unchanged":
            stats = torch.stack([cuda_pic.plane_stats(fr, fi)] * n_steps)
            return arrs["eta"], arrs["w_re"], arrs["w_im"], fr, fi, stats
        if fault == "half":
            half = {k: v[: v.shape[0] // 2] for k, v in arrs.items()}
            eta, wre, wim, r, i, stats = mega(dc, params, fr, fi, 2.0 * qn,
                                              half, n_steps)
            return (torch.cat([eta, arrs["eta"][eta.shape[0]:]]),
                    torch.cat([wre, arrs["w_re"][wre.shape[0]:]]),
                    torch.cat([wim, arrs["w_im"][wim.shape[0]:]]),
                    r, i, stats)
        out = mega(dc, params, fr, fi, qn, arrs, n_steps)
        return (*out[:5], out[5] * 1.1)
    monkeypatch.setattr(cuda_pic, "mega", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_pic_faults(fault, monkeypatch):
    _mega_patch(monkeypatch, fault)
    assert not run(PIC)["correct"]


def test_pic_fit_altered(monkeypatch):
    """The growth rate altered where the fit produces it: only the fit's
    own check (``fit_gap``) is fine enough to see 1e-3."""
    from emme_tpu_torch.solvers import pic
    fit = pic.calculate_omega

    def altered(stats, dt, *a, **kw):
        omega = fit(stats, dt, *a, **kw)
        return complex(omega.real, omega.imag * (1.0 + 1e-3))
    monkeypatch.setattr(pic, "calculate_omega", altered)
    res = run(PIC)
    assert not res["correct"]
    assert res["checks"]["fit_gap"]["value"] > \
        res["checks"]["fit_gap"]["limit"], res["checks"]


@pytest.mark.parametrize("name", [DENSE, STEL, PIC])
def test_the_control_fails_the_check(name):
    cell = small(name)
    entry = cell.entry(2**33 + 11, CPU)
    entry.setup()
    n = int(cell.traffic["check"]["requests"])
    records = calibrate.control_answers(entry, cell.traffic["control"],
                                        list(range(n)))
    checks = entry.check(records)
    assert any(c["value"] > c["limit"] for c in checks), checks
