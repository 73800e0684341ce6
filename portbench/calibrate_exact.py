"""Readings that the limits of the exact cell's ``correct`` are set from, on
the card:

    python3 portbench/calibrate_exact.py --seeds 12 --seconds 4 \
        --controls 3 --out <file>.json

First the sound readings: as ``calibrate.py`` takes them, a window of
``--seconds`` of the cell's own traffic through the program on each of
``--seeds`` seeds, judged by the cell's check.  Then each control in the
program's place, on ``--controls`` seeds at the cell's own size, through
the same check (the upper readings):

* ``program_dense_f32``: the program's dense float32 path (K1's fixed
  tiered panels, complex64 LU) to tol 1e-5, as the dense cell runs it;
* ``omega_1e-8``: the program's exact answer with omega altered by 1e-8
  relative, the vector kept;
* ``program_dense_f64``: the program's dense float64 path (the torch
  integrand on its fixed panel mesh, complex128 LU) to the file's tol.

Before those, ``--branch K``: the table of the mode the scan follows by
the plain adaptive reference's own float64 TraceSecant
(``reference/adaptive.trace_secant``) from the mix's guess at K Chebyshev
nodes of the drawn range, printed and saved; it replaces the traffic
file's table for what follows.

The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402

WORKLOAD = "tokamak_itg.exact_f64.eta_scan.n1024"
CONTROLS = ("program_dense_f32", "omega_1e-8", "program_dense_f64")


def control_answers(entry, kind: str, ks):
    """Records as the entry's ``request`` makes them, from the control."""
    import torch

    from emme_tpu_torch import driver
    if kind not in CONTROLS:
        raise ValueError(f"unknown control {kind!r}")
    out = []
    for k in ks:
        cfg, guess = entry.inputs(k)
        dtype = torch.float64
        if kind == "program_dense_f32":
            cfg = dict(cfg, eigen_backend="dense", iteration_precision=1e-5)
            dtype = torch.float32
        elif kind == "program_dense_f64":
            cfg = dict(cfg, eigen_backend="dense")
        t0 = time.perf_counter()
        res, omega = driver.solve_once_eigen(cfg, guess, dtype=dtype,
                                             device=entry.device)
        if kind == "omega_1e-8":
            omega = omega * (1.0 + 1e-8)
        out.append({"k": k, "t0": t0, "t1": time.perf_counter(),
                    "failed": False, "omega": omega,
                    "vec": res["eigenvector"],
                    "steps": int(res["iteration_steps"])})
    return out


def branch_table(cell, nodes: int, device) -> dict:
    """The branch by the plain adaptive reference at ``nodes`` Chebyshev
    nodes of the drawn range."""
    import math

    from portbench.reference import adaptive as ref
    (key, (lo, hi)), = cell.traffic["draw"].items()
    inp = dict(cell.config["input"], **cell.traffic["set"])
    guess = complex(*inp["initial_guess"])
    table = {"at": [], "omega": [], "steps": []}
    for i in range(nodes):
        x = 0.5 * (lo + hi) - 0.5 * (hi - lo) * math.cos(math.pi * (i + 0.5)
                                                          / nodes)
        t = time.perf_counter()
        omega, _v, steps = ref.trace_secant(
            dict(inp, **{key: x}), guess, float(inp["iteration_precision"]),
            int(inp.get("iteration_step_limit", 20)), device=device)
        table["at"].append(x)
        table["omega"].append([omega.real, omega.imag])
        table["steps"].append(steps)
        print(json.dumps({"branch_node": x, "omega": [omega.real,
                                                      omega.imag],
                          "steps": steps,
                          "seconds": time.perf_counter() - t}), flush=True)
    return table


def judged(entry, records, **extra) -> dict:
    """The check's numbers of ``records``, printed as one JSON line."""
    tc = time.perf_counter()
    checks = entry.check(records)
    row = {**extra, "check_s": time.perf_counter() - tc,
           **{c["name"]: c["value"] for c in checks}}
    print(json.dumps(row), flush=True)
    return row


def main(argv):
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=7_000_000_001)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--branch", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate_exact: no CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = harness.Cell(harness.load_json(harness.ROOT / "BENCHMARK.json"),
                        WORKLOAD)
    out = {"workload": WORKLOAD, "card": torch.cuda.get_device_name(0),
           "power_limit_w": harness.power_limit_w(), "sound": [],
           "control": []}
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    if args.branch:
        out["branch"] = branch_table(cell, args.branch, device)
        cell.traffic["branch"] = {k: out["branch"][k] for k in ("at",
                                                               "omega")}
        path.write_text(json.dumps(out, indent=1))
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        entry = cell.entry(seed, device)
        entry.setup()
        records, _t0, _t1, _s = harness.run_window(entry, args.seconds,
                                                   T_START)
        entry.free()
        out["sound"].append(judged(
            entry, records, seed=seed, requests=len(records),
            failed=sum(r["failed"] for r in records),
            steps=[r.get("steps") for r in records]))
        path.write_text(json.dumps(out, indent=1))
    n = int(cell.traffic["check"]["requests"])
    for i in range(args.controls):
        seed = args.first_seed + 104729 * (i + 1)
        for kind in CONTROLS:
            entry = cell.entry(seed, device)   # the same rows each control
            records = control_answers(entry, kind, list(range(n)))
            out["control"].append(judged(entry, records, seed=seed,
                                         control=kind))
            path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
