"""Readings that the limits of the electromagnetic exact cell's ``correct``
are set from, on the card:

    python3 portbench/calibrate_exact_em.py --branch --stay 50 --seeds 12 \
        --seconds 4 --controls 3 --out <file>.json

``--branch``: the mode the scan follows, by the plain adaptive
electromagnetic reference's own float64 TraceSecant
(``reference/adaptive_em.trace_secant``) from the input's guess, printed
and saved; it replaces the traffic file's branch for what follows.

``--stay K``: K seeded requests of the cell through the program (the
offsets of one seed), each one's distance from the branch; and, from the
guesses of the three farthest, the reference's own TraceSecant, to tell
the operator's own basin from a fault of the program.

Then the sound readings, as ``calibrate_exact.py`` takes them: a window of
``--seconds`` of the cell's own traffic on each of ``--seeds`` seeds,
judged by the cell's check, with the acceptance flips on the check's rows
(integrals whose panel count differs between the reference and kernel N1,
at omega and at the check's omega +- h).  Then each control in the
program's place on ``--controls`` seeds (the upper readings):

* ``program_dense_f32``: the program's dense float32 path (K1's fixed
  tiered panels, complex64 LU) to the file's 1e-6, as the float32 twin
  cell runs it;
* ``omega_1e-8``: the program's exact answer with omega altered by 1e-8
  relative, the vector kept;
* ``program_dense_f64``: the program's dense float64 path (the torch
  integrand on its fixed panel mesh, complex128 LU) to the file's tol.

The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from portbench import calibrate_exact, harness  # noqa: E402

WORKLOAD = "stellarator_em.exact_f64.guess_scan.n1024"
CONTROLS = calibrate_exact.CONTROLS


def control_answers(entry, kind: str, ks):
    """Records as the entry's ``request`` makes them, from the control;
    the float32 control keeps the file's 1e-6, as the float32 twin does."""
    if kind != "program_dense_f32":
        return calibrate_exact.control_answers(entry, kind, ks)
    import torch

    from emme_tpu_torch import driver
    out = []
    for k in ks:
        cfg, guess = entry.inputs(k)
        t0 = time.perf_counter()
        res, omega = driver.solve_once_eigen(
            dict(cfg, eigen_backend="dense"), guess, dtype=torch.float32,
            device=entry.device)
        out.append({"k": k, "t0": t0, "t1": time.perf_counter(),
                    "failed": False, "omega": omega,
                    "vec": res["eigenvector"],
                    "steps": int(res["iteration_steps"])})
    return out


def branch(cell, device) -> dict:
    """The branch by the reference's own TraceSecant from the input's
    guess."""
    from portbench.reference import adaptive_em as ref
    inp = dict(cell.config["input"], **cell.traffic["set"])
    t = time.perf_counter()
    omega, _v, steps = ref.trace_secant(
        inp, complex(*inp["initial_guess"]),
        float(inp["iteration_precision"]),
        int(inp.get("iteration_step_limit", 20)), device=device)
    row = {"omega": [[omega.real, omega.imag]], "steps": steps,
           "seconds": time.perf_counter() - t}
    print(json.dumps(row), flush=True)
    return row


def stay(cell, seed: int, count: int, device) -> dict:
    """``count`` requests of one seed: each one's branch gap; the
    reference's own TraceSecant from the guesses of the three farthest."""
    from portbench.reference import adaptive_em as ref
    entry = cell.entry(seed, device)
    gaps = []
    for k in range(count):
        r = entry.request(k)
        gaps.append(entry.branch_gap(r) if not r["failed"] else None)
    far = sorted(range(count), key=lambda k: -(gaps[k] or 0.0))[:3]
    ref_gaps = []
    for k in far:
        cfg, guess = entry.inputs(k)
        om, _v, _s = ref.trace_secant(
            cfg, guess, float(cfg["iteration_precision"]),
            int(cfg.get("iteration_step_limit", 20)), device=device)
        ref_gaps.append(entry.branch_gap({"k": k, "omega": om}))
    row = {"stay_seed": seed, "requests": count,
           "failed": sum(g is None for g in gaps),
           "max_gap": max(g for g in gaps if g is not None),
           "far_k": far, "reference_gaps_from_far_guesses": ref_gaps}
    print(json.dumps(row), flush=True)
    return row


def flips(cell, seed: int, records, device) -> dict:
    """Integrals on the check's rows (drawn again from the check's seeded
    generator, in the check's order) whose panel count differs between the
    reference and kernel N1, at each omega the check assembles them."""
    import torch

    from emme_tpu_torch import native, params
    from emme_tpu_torch.ops import adaptive, cuda_adaptive
    from portbench.reference import adaptive_em as ref
    entry = cell.entry(seed, device)
    spec = cell.traffic["check"]
    done = [r for r in records if not r["failed"]]
    pick = entry.check_rng.choice(len(done), min(len(done),
                                                 spec["requests"]),
                                  replace=False) if done else []
    counted = differ = most = 0
    for i in sorted(pick):
        rec = done[int(i)]
        cfg, _ = entry.inputs(rec["k"])
        which = entry.check_rows()
        p = params.from_config(cfg, dtype=torch.float64, device=device)
        h = 1e-4 * abs(rec["omega"])
        for om in (rec["omega"], rec["omega"] + h, rec["omega"] - h):
            _M, (ua, ub, um, pops) = ref.rows(cfg, which, om, device,
                                              with_panels=True)
            rows, m, _g, ph = native.pair_integrals(p, ua, ub)
            _v, pan, _mi = cuda_adaptive.integrate(
                rows, m, adaptive.scalars(ph, om))
            pan = pan.reshape(-1, 3).gather(1, um[:, None])[:, 0]
            counted += len(pops)
            differ += int((pan.to(pops.dtype) != pops).sum())
            most = max(most, int(pops.max()))
    return {"flip_integrals": counted, "flips": differ,
            "most_panels": most}


def main(argv):
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=7_100_000_003)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--branch", action="store_true")
    ap.add_argument("--stay", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate_exact_em: no CUDA card", file=sys.stderr)
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
        out["branch"] = branch(cell, device)
        cell.traffic["branch"] = {"omega": out["branch"]["omega"]}
        path.write_text(json.dumps(out, indent=1))
    if args.stay:
        out["stay"] = stay(cell, args.first_seed - 1, args.stay, device)
        path.write_text(json.dumps(out, indent=1))
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        entry = cell.entry(seed, device)
        entry.setup()
        records, _t0, _t1, _s = harness.run_window(entry, args.seconds,
                                                   T_START)
        entry.free()
        out["sound"].append(calibrate_exact.judged(
            entry, records, seed=seed, requests=len(records),
            failed=sum(r["failed"] for r in records),
            steps=[r.get("steps") for r in records],
            **flips(cell, seed, records, device)))
        path.write_text(json.dumps(out, indent=1))
    n = int(cell.traffic["check"]["requests"])
    for i in range(args.controls):
        seed = args.first_seed + 104729 * (i + 1)
        for kind in CONTROLS:
            entry = cell.entry(seed, device)   # the same rows each control
            records = control_answers(entry, kind, list(range(n)))
            out["control"].append(calibrate_exact.judged(
                entry, records, seed=seed, control=kind))
            path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
