"""Readings that the limits of the survey cell's ``correct`` are set from,
on the card:

    python3 portbench/calibrate_survey.py --seeds 12 --seconds 4 \
        --controls 3 --out <file>.json

First, with ``--detail K``, the first K shifts of one request at the
middle of the drawn range, each on its own: the program's estimate, the
check's reference, the TF32 control's and shorter sweeps', each gap and
each reference's seconds.  Then the sound readings: as ``calibrate.py`` takes
them, a window of ``--seconds`` of the cell's own traffic through the
program on each of ``--seeds`` seeds, judged by the cell's check.  Then
each control in the program's place, on ``--controls`` seeds at the
cell's own size, through the same check (the upper readings):

* ``reference_tf32``: the plain reference's survey in float32 with every
  kernel value kept to TF32's 10 mantissa bits;
* ``sweep_2``: the program's survey with a 2-step Arnoldi sweep
  (``--kinds`` takes ``sweep_<m>`` for any m: the leading Ritz value of
  every shift has converged by the sixth step, so 6 to 23 steps give the
  24-step estimates);
* ``neighbours_swapped``: the program's estimates with each even-odd pair
  of neighbouring shifts' estimates swapped;
* ``shifts_re_-0.5``, ``shifts_re_0.5``: the program's survey with every
  shift 0.5 off in Re (the mode-gap's fault: the survey misses the scan's
  mode; ``--kinds`` takes ``shifts_re_<d>`` for any d).  A control that
  raises, as a singular M(sigma) makes the batched LU raise, is a failed
  request.

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

WORKLOAD = "tokamak_itg.dense_f32.arnoldi_shifts16.n1024"
CONTROLS = ("reference_tf32", "sweep_2", "neighbours_swapped",
            "shifts_re_-0.5", "shifts_re_0.5")


def control_estimates(entry, kind: str, cfg: dict):
    """A survey's estimates of ``cfg`` from the control ``kind``."""
    import numpy as np
    import torch

    from portbench.reference import survey as ref
    shifts, m = entry.shifts, entry.m_krylov
    if kind == "reference_tf32":
        return [ref.estimate(cfg, s, m, dtype=torch.float32,
                             device=entry.device, round_bits=10)
                for s in shifts]
    if kind.startswith("sweep_"):
        return entry.survey(cfg, shifts, int(kind.removeprefix("sweep_")))
    if kind == "neighbours_swapped":
        ests = np.asarray(entry.survey(cfg, shifts, m)).copy()
        pairs = len(ests) // 2 * 2
        ests[:pairs] = ests[:pairs].reshape(-1, 2)[:, ::-1].reshape(-1)
        return ests
    if kind.startswith("shifts_re_"):
        return entry.survey(cfg, shifts + float(kind.removeprefix(
            "shifts_re_")), m)
    raise ValueError(f"unknown control {kind!r}")


def control_answers(entry, kind: str, ks):
    """Records as the entry's ``request`` makes them, from the control: a
    control that raises (a singular operator) is a failed request."""
    import numpy as np
    out = []
    for k in ks:
        t0 = time.perf_counter()
        try:
            ests = [complex(e) for e in np.asarray(
                control_estimates(entry, kind, entry.inputs(k))).reshape(-1)]
        except RuntimeError as e:
            out.append({"k": k, "t0": t0, "t1": time.perf_counter(),
                        "failed": True, "reason": f"{type(e).__name__}: {e}"})
            continue
        out.append({"k": k, "t0": t0, "t1": time.perf_counter(),
                    "failed": False, "estimates": ests,
                    "shifts": len(ests)})
    return out


def detail(entry, count: int, sweeps=(12, 8, 6, 4)) -> list[dict]:
    """Each of the first ``count`` shifts of the warm-up's input alone: the
    program's estimate and, against the check's reference, its gap, the
    TF32 control's and those of shorter sweeps."""
    import torch

    from portbench.reference import survey as ref
    cfg = entry.inputs(-1)
    ests = entry.survey(cfg, entry.shifts, entry.m_krylov)
    rows = []
    for j in range(count):
        s = entry.shifts[j]
        t = time.perf_counter()
        want = entry.reference_estimate(cfg, s)
        row = {"shift": j, "reference": [want.real, want.imag],
               "reference_s": time.perf_counter() - t,
               "program": [ests[j].real, ests[j].imag]}
        t = time.perf_counter()
        got = {"program": complex(ests[j]),
               "reference_tf32": ref.estimate(cfg, s, entry.m_krylov,
                                              dtype=torch.float32,
                                              device=entry.device,
                                              round_bits=10)}
        row["reference_tf32_s"] = time.perf_counter() - t
        for m in sweeps:
            got[f"sweep_{m}"] = complex(
                entry.survey(cfg, entry.shifts[j:j + 1], m)[0])
        for name, v in got.items():
            row[f"{name}_gap"] = abs(v - want) / abs(want)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def _cached(fn, known: dict):
    """``fn(cfg, sigma)`` kept in ``known`` by its input and shift."""
    def cached(cfg, sigma):
        key = (json.dumps(cfg, sort_keys=True), complex(sigma))
        if key not in known:
            known[key] = fn(cfg, sigma)
        return known[key]
    return cached


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
    ap.add_argument("--first-seed", type=int, default=9_000_000_001)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--detail", type=int, default=0)
    ap.add_argument("--kinds", default=",".join(CONTROLS),
                    help="the controls to read, comma-separated (a sweep "
                         "of m steps: sweep_<m>)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate_survey: no CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = harness.Cell(harness.load_json(harness.ROOT / "BENCHMARK.json"),
                        WORKLOAD)
    out = {"workload": WORKLOAD, "card": torch.cuda.get_device_name(0),
           "power_limit_w": harness.power_limit_w(), "detail": [],
           "sound": [], "control": []}
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    if args.detail:
        entry = cell.entry(args.first_seed, device)
        entry.setup()
        out["detail"] = detail(entry, args.detail)
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
            seconds=[r["t1"] - r["t0"] for r in records]))
        path.write_text(json.dumps(out, indent=1))
    n = int(cell.traffic["check"]["requests"])
    for i in range(args.controls):
        seed = args.first_seed + 104729 * (i + 1)
        known = {}   # the reference's estimates, the same picks each control
        for kind in args.kinds.split(","):
            entry = cell.entry(seed, device)
            entry.reference_estimate = _cached(entry.reference_estimate,
                                               known)
            records = control_answers(entry, kind, list(range(n)))
            out["control"].append(judged(
                entry, records, seed=seed, control=kind,
                failed=sum(r["failed"] for r in records),
                reasons=[r["reason"][:200] for r in records
                         if r["failed"]]))
            path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
