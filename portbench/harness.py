"""The benchmark of emme_tpu_torch: one cell, one run.

``main`` reads ``BENCHMARK.json`` and finds everything of the cell by name:
the configuration ``configs/<config>.json``, the traffic mix
``traffic/<traffic>.json`` (data read by the entry it names in
``entries/``), and each per-layer metric's reader ``layers/<metric>.py``.
A run:

1. refuses to start without as many CUDA cards as the cell asks for;
2. sets up: imports, loads the kernels (built once into the checkout),
   runs the mix's warm-up requests; ``setup_s`` ends when the first timed
   request is issued;
3. measures for ``--seconds``: one caller, each request issued when the one
   before it has finished, each timed from its issue to a
   ``torch.cuda.synchronize()`` after its result; with ``--trace 1`` under
   ``torch.profiler`` with spans around the program's layers;
4. reads the device's peak memory, frees the program's state, and judges a
   seeded sample of the window's answers against the plain reference;
5. prints the numbers compared, each beside its limit, as the last lines of
   standard error, and the result as the last line of standard output.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import pathlib
import sys
import time

PKG = pathlib.Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "emme_tpu")


def load_module(path: pathlib.Path, name: str):
    """Import the file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: pathlib.Path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic,
    metrics and per-layer readers, all found by name."""

    def __init__(self, bench: dict, name: str, root: pathlib.Path = ROOT):
        found = [w for w in bench["workloads"] if w["name"] == name]
        if len(found) != 1:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        self.chips = int(self.workload["chips"])
        conf = [c for c in bench["configs"]
                if c["name"] == self.workload["config"]][0]
        self.config = load_json(root / conf["file"])
        self.traffic = load_json(
            PKG / "traffic" / f"{self.workload['traffic']}.json")

        def mine(m):
            return "workloads" not in m or name in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def entry(self, seed: int, device):
        mod = load_module(PKG / "entries" / f"{self.traffic['entry']}.py",
                          f"portbench_entry_{self.traffic['entry']}")
        return mod.Entry(self.config, self.traffic, seed, device)

    def reader(self, metric: str):
        return load_module(PKG / "layers" / f"{metric}.py",
                           f"portbench_layer_{metric.replace('.', '_')}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's, its libraries' or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between the closest ranks."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def power_limit_w():
    """The card's power limit in W from ``nvidia-smi``, or None."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_window(entry, seconds: float, t_start_process: float,
               profiler=None, record=None):
    """Closed loop for ``seconds``; returns (records, window start, window
    end = last completion, setup_s)."""
    records = []
    if profiler is not None:
        profiler.start()
    t0 = time.perf_counter()
    setup_s = t0 - t_start_process
    end = t0 + seconds
    k = 0
    while time.perf_counter() < end:
        entry.before(k)
        if record is not None:
            with record("portbench.request"):
                records.append(entry.request(k))
        else:
            records.append(entry.request(k))
        k += 1
    t1 = time.perf_counter()
    if profiler is not None:
        profiler.stop()
    return records, t0, t1, setup_s


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start_process: float, log=print) -> dict:
    """One run of ``cell`` on ``device``; returns the result object."""
    import torch

    from . import tracing
    entry = cell.entry(seed, device)
    spans = None
    if trace:
        spans = tracing.Spans(entry.spans())
        spans.install()
    try:
        entry.setup()
        profiler = tracing.profiler(device) if trace else None
        if spans is not None:
            spans.phase = "window"
        records, t0, t1, setup_s = run_window(
            entry, seconds, t_start_process, profiler,
            tracing.record_function if trace else None)
        if spans is not None:
            spans.check_fired()
    finally:
        if spans is not None:
            spans.uninstall()
    cuda = device.type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    window = max(r["t1"] for r in records) - t0
    summary = tracing.summarize(profiler, t0, t1) if trace else None
    if trace:
        log(f"trace: {len(summary['names'])} device operations, "
            f"{summary['launch_found']} with their launch; left out "
            f"(span images, empty): {summary['skipped_kinds'][:8]}")
    entry.free()
    if cuda:
        torch.cuda.empty_cache()

    failed = sum(1 for r in records if r["failed"])
    checks = entry.check(records)
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks)

    if trace:
        ctx = tracing.Context(cell=cell, entry=entry, records=records,
                              summary=summary, spans=spans, window_s=window)
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = entry.metrics(records, window)
        values["setup_s"] = setup_s
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    result = {"correct": bool(correct), "attempted": len(records),
              "failed": failed, "metrics": metrics}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak,
           "power_limit_w": power_limit_w() if cuda else None}
    if trace:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = summary["breakdown"]
    result["device"] = dev
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    for c in checks:
        log(f"check {c['name']} {c['value']!r} limit {c['limit']!r}")
    return result


def main(argv, t_start_process: float) -> int:
    ap = argparse.ArgumentParser(prog="portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's kernel builds live in the checkout
    # (emme_tpu_torch/_build); torch's own caches, should anything use
    # them, go to fixed directories beside it
    cache = ROOT / ".portbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")

    bench = load_json(ROOT / "BENCHMARK.json")
    cell = Cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, t_start_process, log=log)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0
