"""BENCHMARK.json against the benchmark's contract, and every cell found by
name: its configuration, traffic, entry and per-layer readers."""

import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert (ROOT / BENCH["command"][1]).is_file()
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_the_contract_keys(section):
    for e in BENCH[section]:
        extra = set(e) - KEYS[section]
        assert extra <= ({"workloads"} if section in ("end_to_end",
                                                      "per_layer") else set())
        assert KEYS[section] <= set(e)


def test_names_and_units_use_the_allowed_characters():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[section]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200
                    assert "\n" not in e[text] and "\t" not in e[text]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    assert len(set(names)) == len(names)


def test_bounds_and_sources():
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_resolves_by_name(w):
    from portbench import harness
    cell = harness.Cell(BENCH, w["name"])
    assert cell.config["name"] == w["config"]
    assert (PKG / "entries" / f"{cell.traffic['entry']}.py").is_file()
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert hasattr(cell.reader(m["name"]), "read")
        assert m["moves"] in e2e


def test_every_config_file_is_used_and_holds_its_input():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        files.add(c["file"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and "input" in data
        upstream = json.loads((ROOT / "tests" / "goldens" / "inputs"
                               / f"{data['input']['conf']}.json").read_text())
        assert data["input"] == upstream   # the input file, unchanged
    assert len(files) == len(BENCH["configs"])


def test_a_pair_of_config_and_traffic_appears_once():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
