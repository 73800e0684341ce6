"""Readings that the limits of ``correct`` are set from, on the card:

    python3 portbench/calibrate.py --workload <name> --seeds 12 --seconds 4 \
        --controls 3 --out chiprun_out/<file>.json

For each of ``--seeds`` seeds, a short window of the cell's own traffic
through the program and the numbers its check compares (the lower
readings); then the control on ``--controls`` seeds, at the cell's own
size, through the same check (the upper readings).  All in one process, so
set-up is paid once.  The control is named by the traffic file's
``control``:

* ``reference_tf32``: the plain reference in the program's place, its
  operator assembled in float32 with every kernel value kept to TF32's 10
  mantissa bits, the reference's own Newton iteration from the request's
  guess, and the null vector of its last operator;
* ``reference_bf16_state``: the plain reference in the program's place,
  float32 arithmetic with the markers' state and the field kept in
  bfloat16;
* ``program_bf16`` (``--control``, for the record): the program's own PIC
  run with its bfloat16 CIC gather and deposit.

An eigen mix's branch, before those (each step optional, in this order):

* ``--branch K``: the table of the mode the scan follows, by the plain
  reference (``operator.trace_secant`` in float32 from the mix's guess) at
  K Chebyshev nodes of the drawn range, or once where nothing is drawn;
  the table found replaces the traffic file's for what follows;
* ``--requests N``: N requests of the first seed through the program, each
  with its drawn value, omega, steps, distance from the branch, and the row
  check's numbers on the first ``--row-checks`` of them;
* ``--guesses "re,im re,im ..."``: the program from other starting
  guesses at the middle of the drawn range, for the other roots of
  det M = 0 near the branch.

The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def control_answers(entry, kind: str, ks):
    """Records as the entry's ``request`` makes them, from the control."""
    import torch
    out = []
    for k in ks:
        t0 = time.perf_counter()
        if kind == "reference_tf32":
            from portbench.reference import operator as ref
            cfg, guess = entry.inputs(k)
            omega, vec, steps = ref.trace_secant(
                cfg, guess, float(cfg["iteration_precision"]),
                int(cfg.get("iteration_step_limit", 20)),
                dtype=torch.float32, device=entry.device, round_bits=10)
            v = vec.detach().cpu().numpy()
            rec = {"omega": omega, "steps": steps,
                   "vec": [[float(x.real), float(x.imag)] for x in v]}
        elif kind == "program_bf16":
            from emme_tpu_torch.solvers import pic
            eta, zp, zq, w0 = entry.draws(k)
            state = pic.state_from_draws(entry.p, eta, zp, zq, w0,
                                         dtype=entry.dtype)
            stats, _s, _ = pic.run(entry.p, entry.mpc, entry.n_steps,
                                   entry.dt, state=state,
                                   gather_method="bf16",
                                   deposit_method="bf16")
            rec = {"stats": stats.detach().cpu().numpy().astype("float64"),
                   "omega": pic.calculate_omega(stats, entry.dt)}
        elif kind == "reference_bf16_state":
            from portbench.reference import pic as ref_pic
            draws = entry.draws(k)
            stats, _f = ref_pic.run(entry.input, draws, entry.n_steps,
                                    entry.dt, dtype=torch.float32,
                                    keep=torch.bfloat16)
            rec = {"stats": stats, "omega": ref_pic.fit(stats, entry.dt)}
        else:
            raise ValueError(f"unknown control {kind!r}")
        rec.update(k=k, t0=t0, t1=time.perf_counter(), failed=False)
        out.append(rec)
    return out


def branch_table(entry, nodes: int) -> dict:
    """The branch by the plain reference: omega at ``nodes`` Chebyshev
    nodes of the drawn range from the mix's guess (once, with nothing
    drawn)."""
    import torch

    from portbench.reference import operator as ref
    draw = entry.traffic.get("draw", {})
    cfg = dict(entry.input)
    tol = float(cfg["iteration_precision"])
    limit = min(int(cfg.get("iteration_step_limit", 20)), 20)
    if not draw:
        omega, _v, steps = ref.trace_secant(cfg, entry.guess, tol, limit,
                                            dtype=torch.float32,
                                            device=entry.device)
        return {"omega": [[omega.real, omega.imag]], "steps": [steps]}
    (key, (lo, hi)), = draw.items()
    at = [0.5 * (lo + hi) - 0.5 * (hi - lo) * math.cos(math.pi * (i + 0.5)
                                                         / nodes)
          for i in range(nodes)]
    table = {"at": at, "omega": [], "steps": []}
    for x in at:
        cfg[key] = x
        omega, _v, steps = ref.trace_secant(cfg, entry.guess, tol, limit,
                                            dtype=torch.float32,
                                            device=entry.device)
        table["omega"].append([omega.real, omega.imag])
        table["steps"].append(steps)
        print(json.dumps({"branch_node": x, "omega": [omega.real,
                                                      omega.imag],
                          "steps": steps}), flush=True)
    return table


def fixed_requests(entry, n: int, row_checks: int):
    """``n`` requests through the program, each judged on its own."""
    import numpy as np

    from portbench.entries.eigen import ROW_CHUNK
    from portbench.reference import operator as ref
    key = next(iter(entry.traffic.get("draw", {})), None)
    dim = entry.input["npoints"] * (2 if float(entry.input["beta_e"]) else 1)
    rows_rng = np.random.default_rng([entry.seed, 5])
    out = []
    for k in range(n):
        r = entry.request(k)
        cfg, guess = entry.inputs(k)
        row = {"k": k, "x": cfg[key] if key else None,
               "guess": [guess.real, guess.imag], "failed": r["failed"],
               "seconds": r["t1"] - r["t0"]}
        if not r["failed"]:
            row.update(omega=[r["omega"].real, r["omega"].imag],
                       steps=r["steps"], branch_gap=entry.branch_gap(r))
            if k < row_checks:
                vec = np.array(r["vec"], dtype=np.float64)
                got = ref.row_check(cfg, r["omega"], vec[:, 0] + 1j
                                    * vec[:, 1],
                                    rows_rng.choice(dim, 16, replace=False),
                                    device=entry.device, chunk=ROW_CHUNK)
                row.update(got)
        out.append(row)
        print(json.dumps(row), flush=True)
    return out


def other_guesses(entry, guesses):
    """The program from each of ``guesses`` at the middle of the drawn
    range: the roots it finds and their distance from the branch."""
    from emme_tpu_torch import driver
    from portbench.entries.eigen import branch_omega
    cfg, _g = entry.inputs(-1)
    key = next(iter(entry.traffic.get("draw", {})), None)
    want = branch_omega(entry.traffic["branch"], cfg[key] if key else None)
    out = []
    for g in guesses:
        row = {"guess": [g.real, g.imag]}
        try:
            _res, omega = driver.solve_once_eigen(
                cfg, g, dtype=entry.dtype, device=entry.device)
            row.update(omega=[omega.real, omega.imag],
                       branch_gap=abs(omega - want) / abs(want))
        except (RuntimeError, ValueError, ArithmeticError) as e:
            row["error"] = f"{type(e).__name__}: {e}"
        out.append(row)
        print(json.dumps(row), flush=True)
    return out


def main(argv):
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=7_000_000_001)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--control", default=None,
                    help="a control other than the traffic file's")
    ap.add_argument("--branch", type=int, default=0)
    ap.add_argument("--requests", type=int, default=0)
    ap.add_argument("--row-checks", type=int, default=0)
    ap.add_argument("--guesses", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.Cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = args.control or cell.traffic["control"]
    out = {"workload": args.workload, "card": torch.cuda.get_device_name(0),
           "power_limit_w": harness.power_limit_w(), "sound": [],
           "control": []}
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)

    def save():
        path.write_text(json.dumps(out, indent=1))

    first = cell.entry(args.first_seed, device)
    if args.branch:
        t = time.perf_counter()
        table = branch_table(first, args.branch)
        out["branch"] = dict(table, seconds=time.perf_counter() - t)
        cell.traffic["branch"] = {k: table[k] for k in ("at", "omega")
                                  if k in table}
        first = cell.entry(args.first_seed, device)
        save()
    if args.requests or args.guesses:
        first.setup()
    if args.requests:
        out["requests"] = fixed_requests(first, args.requests,
                                         args.row_checks)
        save()
    if args.guesses:
        out["guesses"] = other_guesses(
            first, [complex(*map(float, g.split(",")))
                    for g in args.guesses.split()])
        save()
    del first
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        entry = cell.entry(seed, device)
        entry.setup()
        records, t0, _t1, _s = harness.run_window(entry, args.seconds,
                                                  T_START)
        entry.free()
        tc = time.perf_counter()
        checks = entry.check(records)
        row = {"seed": seed, "requests": len(records),
               "failed": sum(r["failed"] for r in records),
               "check_s": time.perf_counter() - tc,
               **{c["name"]: c["value"] for c in checks}}
        if getattr(entry, "last_gaps", None):
            row["step_gaps"] = [list(map(float, g)) for g in entry.last_gaps]
        out["sound"].append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "step_gaps"}),
              flush=True)
        save()
    for i in range(args.controls):
        seed = args.first_seed + 104729 * (i + 1)
        entry = cell.entry(seed, device)
        entry.setup()
        n = int(cell.traffic["check"]["requests"])
        tc = time.perf_counter()
        records = control_answers(entry, kind, list(range(n)))
        checks = entry.check(records)
        row = {"seed": seed, "control": kind,
               "seconds": time.perf_counter() - tc,
               **{c["name"]: c["value"] for c in checks}}
        if getattr(entry, "last_gaps", None):
            row["step_gaps"] = [list(map(float, g)) for g in entry.last_gaps]
        out["control"].append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "step_gaps"}),
              flush=True)
        save()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
