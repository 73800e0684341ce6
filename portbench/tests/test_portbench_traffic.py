"""Each traffic mix's generator is a function of the seed alone, and every
seed draws the same set of work in its own order."""

import json
import pathlib

import pytest
import torch

from portbench import harness
from portbench.entries.eigen import STRATA

BENCH = json.loads((pathlib.Path(harness.ROOT) / "BENCHMARK.json")
                   .read_text())
CPU = torch.device("cpu")
SEEDS = (5, 2**33 + 17)   # a seed past 32 signed bits


def _cell(name):
    return harness.Cell(BENCH, name)


EIGEN = [w["name"] for w in BENCH["workloads"]
         if _cell(w["name"]).traffic["entry"] == "eigen"]
PIC = [w["name"] for w in BENCH["workloads"]
       if _cell(w["name"]).traffic["entry"] == "pic"]


def _requests(name, seed, n=64):
    e = _cell(name).entry(seed, CPU)
    return [e.inputs(k) for k in range(n)]


@pytest.mark.parametrize("name", EIGEN)
@pytest.mark.parametrize("seed", SEEDS)
def test_eigen_requests_repeat_for_a_seed(name, seed):
    assert _requests(name, seed) == _requests(name, seed)


@pytest.mark.parametrize("name", EIGEN)
def test_eigen_seeds_change_the_order_not_the_strata(name):
    traffic = _cell(name).traffic
    a, b = _requests(name, SEEDS[0]), _requests(name, SEEDS[1])
    assert a != b
    strata = STRATA
    for key, (lo, hi) in traffic["draw"].items():
        for reqs in (a, b):
            vals = [cfg[key] for cfg, _g in reqs]
            assert all(lo <= v < hi for v in vals)
            cells = sorted(int((v - lo) / (hi - lo) * strata) for v in vals)
            assert cells == list(range(strata))   # one value a stratum
    off = traffic["guess_offset"]
    base = complex(*(traffic["guess"] if traffic["guess"] != "input"
                     else _cell(name).config["input"]["initial_guess"]))
    for _cfg, g in a:
        assert abs((g - base).real) <= off and abs((g - base).imag) <= off


@pytest.mark.parametrize("name", PIC)
def test_pic_draws_repeat_for_a_seed_and_differ_across(name):
    cell = _cell(name)
    small = dict(cell.traffic, set=dict(cell.traffic["set"], npoints=128,
                                        marker_per_cell=8))
    cell.traffic = small

    def draws(seed, k):
        return cell.entry(seed, CPU).draws(k)
    a, b, c = draws(SEEDS[1], 3), draws(SEEDS[1], 3), draws(SEEDS[0], 3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    assert not torch.equal(a[0], draws(SEEDS[1], 4)[0])
    eta, z_para, _z_perp, w0 = a
    L = float(cell.config["input"]["length"])
    assert bool((eta >= -L).all() and (eta < L).all())
    assert bool((z_para != 0).all())
    assert bool((w0 >= 0).all() and (w0 < 1e-3).all())
