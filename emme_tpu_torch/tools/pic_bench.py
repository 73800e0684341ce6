"""Times of the PIC kernels K2, K3, K4, and of 8 steps of the plain and the
sorted-window paths, at the canonical size on one NVIDIA GPU, one JSON line
per measurement.

    python3 emme_tpu_torch/tools/pic_bench.py [--root DIR ...] [--sweep]
        [--large]

``--root DIR`` measures the ``emme_tpu_torch`` package of another checkout
(for example the parent commit unpacked beside this one); several roots run
in turn, each in a process of its own, on the same card: give
``--root old --root . --root . --root old`` to compare two versions.  Each
line carries the root, the card's name and power limit, and SHA-256 digests
of the kernels' outputs, so that two versions can be compared bit for bit.

``--sweep`` also times K3's canonical run with the marker pass or the field
reduce left out, and K4 without its copies at 1 and 1081 rounds (the cost
of a grid barrier at K3's grid).

``--large`` also times K3 over 8 steps at npoints 16,384, 32,768 and 65,536
(1024 markers per cell, dt 0.25 x 1024 / npoints), with its launch shape,
its output digests and, where the root has it, K3 without its deposit; and
K2's stage 1 at 32,768.
"""

import argparse
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve()
CASE = dict(npoints=1024, mpc=1024, steps=180, dt=0.25)   # benchmarks/bench_pic.py
BARRIER_ROUNDS = 1081   # two barriers a stage, 540 stages, and one
LARGE_NF = (16384, 32768, 65536)
LARGE_STEPS = 8
K2_LARGE_NF = 32768


def emit(**fields):
    print(json.dumps(fields), flush=True)


def digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
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


def summary(times):
    return {"ms_min": min(times), "ms_median": statistics.median(times),
            "reps": len(times)}


def measure(root, sweep, large):
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("pic_bench: needs an NVIDIA GPU")
    sys.path.insert(0, str(root))
    import emme_tpu_torch
    from emme_tpu_torch import from_config
    from emme_tpu_torch.solvers import cuda_pic, pic
    if not pathlib.Path(emme_tpu_torch.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"pic_bench: emme_tpu_torch was not imported from {root}")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    tag = dict(root=str(root), card=card)
    dev, f32 = torch.device("cuda"), torch.float32
    with open(root / "tests" / "goldens" / "inputs" / "tokamak.json") as f:
        cfg = dict(json.load(f), npoints=CASE["npoints"])
    p = from_config(cfg, dtype=f32, device=dev)
    m = CASE["mpc"] * CASE["npoints"]
    s0 = pic.init_state(p, CASE["mpc"],
                        torch.Generator(device=dev).manual_seed(1), dtype=f32)
    fs = cuda_pic.FusedStep(p, m, CASE["dt"])
    qn = pic.quasi_neutrality_coef(p, dtype=f32)
    arrs = cuda_pic.state_to_arrs(s0)
    field = (s0.field.real.contiguous(), s0.field.imag.contiguous())

    # K3: the canonical run and, for the digests, 8 steps
    out8 = cuda_pic.mega(fs.dc, fs.params, *field, qn, arrs, 8)
    torch.cuda.synchronize()
    k3 = event_ms(lambda: cuda_pic.mega(fs.dc, fs.params, *field, qn, arrs,
                                        CASE["steps"]), torch, 5)
    emit(what="k3_canonical", steps=CASE["steps"], markers=m, **summary(k3),
         eta_digest=digest(out8[0]), state_digest=digest(*out8[1:]),
         shape=getattr(cuda_pic, "LAST_MEGA_GRID", None), **tag)

    # the plain path over 8 steps and, where the root has it, the
    # sorted-window path at the driver's defaults (device span of the whole
    # host-driven chain; the atomics' order varies, so no digest)
    plain8 = event_ms(lambda: pic.run(p, CASE["mpc"], 8, CASE["dt"],
                                      state=s0), torch, 5)
    emit(what="plain_8_steps", **summary(plain8), **tag)
    if hasattr(pic, "run_sorted"):
        sorted8 = event_ms(lambda: pic.run_sorted(
            p, CASE["mpc"], 8, CASE["dt"], state=s0, resort_every=30),
            torch, 5)
        emit(what="sorted_8_steps", **summary(sorted8),
             chose=dict(pic.LAST_SORTED), **tag)

    # K2: stage 1 after two plain stages, then the field reduce
    arrs1, field1 = arrs, field
    for s in (0, 1):
        o = cuda_pic.stage_ref(s, False, fs.dc, fs.params, *field1, qn, arrs1)
        arrs1 = dict(arrs1, eta=o[2], w_re=o[3], w_im=o[4])
        field1 = o[5:]
    got = cuda_pic._launch_stage(1, False, fs.dc, fs.params, *field1, arrs1,
                                 None)
    fld = cuda_pic._launch_field(got[-1], qn)
    torch.cuda.synchronize()
    k2s = event_ms(lambda: cuda_pic._launch_stage(
        1, False, fs.dc, fs.params, *field1, arrs1, None), torch, 20)
    k2f = event_ms(lambda: cuda_pic._launch_field(got[-1], qn), torch, 20)
    emit(what="k2_stage", stage=1, **summary(k2s), vel_digest=digest(*got[:2]),
         eta_digest=digest(got[2]), weight_digest=digest(*got[3:5]),
         partials=list(got[-1].shape), **tag)
    emit(what="k2_field", **summary(k2f), field_digest=digest(*fld),
         repeat_bit_equal=bool(all(torch.equal(a, b) for a, b in zip(
             fld, cuda_pic._launch_field(got[-1], qn)))), **tag)

    # K4 at K3's grid, as the self-check launches it
    cuda_pic._SELFCHECK.clear()
    ok, info = cuda_pic.grid_sync_selfcheck(dev, p.npoints, fs.dc)
    shape = {k: info.get(k) for k in ("grid", "threads", "smem")}
    x = torch.rand((info["grid"], cuda_pic.THREADS), device=dev)
    probe = lambda **kw: cuda_pic.grid_sync_probe(x, **kw)   # noqa: E731
    k4 = event_ms(probe, torch, 50)
    plain = event_ms(lambda: cuda_pic.grid_sync_probe_ref(x), torch, 50)
    emit(what="k4_probe", selfcheck=ok, rounds=cuda_pic.PROBE_ROUNDS,
         **summary(k4), plain_ms_median=statistics.median(plain), **shape,
         **tag)
    if large:
        for n in LARGE_NF:
            measure_large(torch, cfg, n, tag)
    if not sweep:
        return

    # K4 without its copies: the launch alone, and the grid barrier's cost
    floor = event_ms(lambda: probe(copy=False), torch, 50)
    one = event_ms(lambda: probe(rounds=1, copy=False), torch, 20)
    many = event_ms(lambda: probe(rounds=BARRIER_ROUNDS, copy=False), torch,
                    10)
    emit(what="k4_floor", **summary(floor), **shape, **tag)
    emit(what="grid_barrier", rounds=[1, BARRIER_ROUNDS],
         ms_median=[statistics.median(one), statistics.median(many)],
         us_per_barrier=1e3 * (statistics.median(many) - statistics.median(
             one)) / (BARRIER_ROUNDS - 1), **shape, **tag)

    # K3 with a part of the stage left out
    for parts, name in ((3, "all"), (1, "no_reduce"), (2, "no_markers"),
                        (0, "barriers_only")):
        t = event_ms(lambda: cuda_pic._launch_mega(
            fs.dc, fs.params, *field, qn, arrs, CASE["steps"], parts=parts),
            torch, 3)
        emit(what="k3_parts", parts=name, **summary(t),
             us_per_stage=1e3 * statistics.median(t) / (3 * CASE["steps"]),
             **tag)


def measure_large(torch, cfg, n, tag):
    """K3 over LARGE_STEPS at npoints n (and K2's stage 1 at K2_LARGE_NF),
    1024 markers per cell, in the root's package."""
    from emme_tpu_torch import from_config
    from emme_tpu_torch.solvers import cuda_pic, pic
    dev, f32 = torch.device("cuda"), torch.float32
    mpc = CASE["mpc"]
    p = from_config(dict(cfg, npoints=n), dtype=f32, device=dev)
    m, dt = mpc * n, CASE["dt"] * CASE["npoints"] / n
    s0 = pic.init_state(p, mpc, torch.Generator(device=dev).manual_seed(1),
                        dtype=f32)
    fs = cuda_pic.FusedStep(p, m, dt)
    qn = pic.quasi_neutrality_coef(p, dtype=f32)
    arrs = cuda_pic.state_to_arrs(s0)
    field = (s0.field.real.contiguous(), s0.field.imag.contiguous())
    del s0
    out = cuda_pic.mega(fs.dc, fs.params, *field, qn, arrs, LARGE_STEPS)
    torch.cuda.synchronize()
    k3 = event_ms(lambda: cuda_pic.mega(fs.dc, fs.params, *field, qn, arrs,
                                        LARGE_STEPS), torch, 5)
    emit(what="k3_large", npoints=n, steps=LARGE_STEPS, markers=m,
         **summary(k3), eta_digest=digest(out[0]),
         state_digest=digest(*out[1:]), shape=cuda_pic.LAST_MEGA_GRID, **tag)
    del out
    no_dep = getattr(cuda_pic, "PART_NO_DEPOSIT", None)
    if no_dep is not None:
        t = event_ms(lambda: cuda_pic._launch_mega(
            fs.dc, fs.params, *field, qn, arrs, LARGE_STEPS,
            parts=3 | no_dep), torch, 3)
        emit(what="k3_large_no_deposit", npoints=n, steps=LARGE_STEPS,
             **summary(t), deposit_share=1.0 - statistics.median(t)
             / statistics.median(k3), **tag)
    if n == K2_LARGE_NF:
        # stage 1 after two plain stages, as at the canonical size
        for s in (0, 1):
            o = cuda_pic.stage_ref(s, False, fs.dc, fs.params, *field, qn,
                                   arrs)
            arrs = dict(arrs, eta=o[2], w_re=o[3], w_im=o[4])
            field = o[5:]
            del o
        got = cuda_pic._launch_stage(1, False, fs.dc, fs.params, *field,
                                     arrs, None)
        torch.cuda.synchronize()
        k2s = event_ms(lambda: cuda_pic._launch_stage(
            1, False, fs.dc, fs.params, *field, arrs, None), torch, 10)
        k2f = event_ms(lambda: cuda_pic._launch_field(got[-1], qn), torch,
                       10)
        emit(what="k2_stage_large", npoints=n, stage=1, markers=m,
             **summary(k2s), field_ms_median=statistics.median(k2f),
             eta_digest=digest(got[2]), partials=list(got[-1].shape), **tag)
        del got
    del arrs, field
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", type=pathlib.Path)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--large", action="store_true")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    roots = [r.resolve() for r in args.root or [HERE.parents[2]]]
    if args.one:
        return measure(roots[0], args.sweep, args.large)
    for root in roots:
        cmd = [sys.executable, str(HERE), "--one", "--root", str(root)]
        if args.large:
            cmd.append("--large")
        if args.sweep and root == HERE.parents[2]:
            cmd.append("--sweep")
        proc = subprocess.run(cmd)
        if proc.returncode != 0:
            raise SystemExit(f"pic_bench: {root} failed ({proc.returncode})")


if __name__ == "__main__":
    main()
