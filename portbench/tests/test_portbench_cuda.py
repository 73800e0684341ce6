"""Each cell for a few seconds on the card, through the command that the
benchmark's contract runs.  Skips where there is no CUDA card."""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_runs_correct_on_the_card(w):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run on an H100")
    out = subprocess.run(
        [sys.executable, *BENCH["command"][1:], "--workload", w["name"],
         "--seed", "4000000001", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    names = {m["name"] for m in BENCH["end_to_end"]
             if "workloads" not in m or w["name"] in m["workloads"]}
    assert set(result["metrics"]) == names
