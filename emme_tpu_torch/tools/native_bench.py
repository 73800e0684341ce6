"""Times of kernel N1 (the reference-exact engine's float64 adaptive
Gauss-Kronrod integrals), of ``native.assemble`` and of
``eigen_native.solve`` at npoints 1024 on one NVIDIA GPU, one JSON line per
measurement.

    python3 emme_tpu_torch/tools/native_bench.py [--root DIR ...]

``--root DIR`` measures the ``emme_tpu_torch`` package of another checkout
(for example the parent commit unpacked beside this one); several roots run
in turn, each in a process of its own, on the same card: give
``--root old --root . --root . --root old`` to compare two versions.  Each
line carries the root and the card's name and power limit.  N1's lines
carry SHA-256 digests of its outputs (the values with -0 read as +0, so
that equal digests mean values equal as numbers; the panel counts; the
Miller steps; the pair rows' bits), so that two versions can be compared
bit for bit; the assembly's lines carry the bits' digest of M, and where
the root has ``native.assembly_plan`` the times of a plan and of an
assembly given one (where the plan carries N1's memo, its calls after the
first two read the memo); the solves' lines carry omega, the steps and the
null vector's digest.

Cases: every integral of one tok1024 assembly (523,776, m = 0, G7K15) and
one stel1024 assembly (1,571,328, m = 0, 1, 2, G15K31) at chip_smoke.py's
guesses; N1 and the assembly by CUDA events, the median of 5 calls after a
warm-up; the solve (``tol=1e-6``) by the host clock ended by a synchronize,
the median of 3 after a warm-up.
"""

import argparse
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve()
NPOINTS = 1024
CASES = (("tok", "tokamak", -0.8 + 0.25j), ("stel", "stellarator",
                                             -1.656 + 2.490j))
REPS, SOLVE_REPS = 5, 3


def emit(**fields):
    print(json.dumps(fields), flush=True)


def digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        if t.is_floating_point():
            t = t + 0.0     # -0 -> +0
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def event_ms(fn, torch, reps):
    """Device ms of each of ``reps`` calls of ``fn()`` after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def summary(times, unit="ms"):
    return {f"{unit}_min": min(times), f"{unit}_median": statistics.median(
        times), f"{unit}_max": max(times), "reps": len(times)}


def measure(root):
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("native_bench: needs an NVIDIA GPU")
    sys.path.insert(0, str(root))
    import emme_tpu_torch
    from emme_tpu_torch import from_config, native
    from emme_tpu_torch.ops import adaptive, cuda_adaptive
    from emme_tpu_torch.ops.singularity import singularity_coeff_matrix
    from emme_tpu_torch.solvers import eigen_native
    if not pathlib.Path(emme_tpu_torch.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"native_bench: emme_tpu_torch was not imported "
                         f"from {root}")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    tag = dict(root=str(root), card=card)
    rec = cuda_adaptive.build()
    emit(what="build", seconds=rec["seconds"],
         ptxas=[ln.strip() for ln in rec["log"].splitlines()
                if "registers" in ln or "spill" in ln], **tag)
    coeff = singularity_coeff_matrix(NPOINTS)
    for case, name, om in CASES:
        with open(root / "tests" / "goldens" / "inputs" / f"{name}.json") as f:
            p = from_config(dict(json.load(f), npoints=NPOINTS))
        iu, ju = torch.triu_indices(NPOINTS, NPOINTS, 1, device=p.device)
        rows, m, _, ph = native.pair_integrals(p, iu, ju)
        sc = adaptive.scalars(ph, om)
        out = cuda_adaptive.integrate(rows, m, sc)
        torch.cuda.synchronize()
        n1 = event_ms(lambda: cuda_adaptive.integrate(rows, m, sc), torch,
                      REPS)
        vals, panels, miller = out
        emit(what="n1", case=f"{case}{NPOINTS}", integrals=int(m.numel()),
             **summary(n1), rows_bits_digest=digest(rows.view(torch.int64)),
             values_digest=digest(vals),
             panels_digest=digest(panels), miller_digest=digest(miller),
             panels=int(panels.sum()), miller_steps=int(miller.sum()),
             launch=dict(getattr(cuda_adaptive, "LAST_LAUNCH", {})), **tag)
        del out, vals, panels, miller, rows, m
        asm = event_ms(lambda: native.assemble(p, coeff, om), torch, REPS)
        M = native.assemble(p, coeff, om)
        planned = {}
        if hasattr(native, "assembly_plan"):
            plan_ms = event_ms(lambda: native.assembly_plan(p, coeff), torch,
                               REPS)
            plan = native.assembly_plan(p, coeff)
            planned = dict(
                plan_ms_median=statistics.median(plan_ms),
                planned_ms_median=statistics.median(event_ms(
                    lambda: native.assemble(p, coeff, om, plan=plan), torch,
                    REPS)))
            del plan
        emit(what="assemble", case=f"{case}{NPOINTS}", **summary(asm),
             M_bits_digest=digest(torch.view_as_real(M).view(torch.int64)),
             **planned, **tag)
        del M
        secs = []
        for rep in range(SOLVE_REPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w, vec, steps, _M = eigen_native.solve(p, om, tol=1e-6)
            torch.cuda.synchronize()
            if rep:
                secs.append(time.perf_counter() - t0)
            del _M
        emit(what="solve", case=f"{case}{NPOINTS}", **summary(secs, "s"),
             omega=[w.real, w.imag], steps=steps,
             vector_bits_digest=digest(torch.view_as_real(vec).view(
                 torch.int64)), **tag)
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", type=pathlib.Path)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    roots = [r.resolve() for r in args.root or [HERE.parents[2]]]
    if args.one:
        return measure(roots[0])
    for root in roots:
        proc = subprocess.run([sys.executable, str(HERE), "--one", "--root",
                               str(root)])
        if proc.returncode != 0:
            raise SystemExit(f"native_bench: {root} failed ({proc.returncode})")


if __name__ == "__main__":
    main()
