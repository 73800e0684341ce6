"""Smoke run of the PyTorch / CUDA port (emme_tpu_torch) on one NVIDIA GPU.

Usage, from the repository root:

    python3 chip_smoke.py

It needs one CUDA card and the CUDA toolkit (nvcc); without a card it exits
non-zero before printing any result.  Phases, one JSON line each; a failed
check exits non-zero:

1. device: the card's name and power limit (nvidia-smi), TF32 off.
2. build:  kernel K1 compiled with nvcc from emme_tpu_torch/csrc/ into
   emme_tpu_torch/_build/.
3. kernel vs plain: K1 against its plain PyTorch version on the card, on
   every |i - j| tier of the n=1024 tokamak pairs (ms=(0,), bar 5e-7
   max(scale, 1)) and on the n=128 stellarator pairs (ms=(0,1,2), bar
   5e-6 max(scale, 1)); median of 3 timed calls of each after a warm-up.
4. slice: the main path, from_config(tokamak, npoints=1024, float32, cuda)
   -> eigen.solve(p, -0.8+0.25j, tol=1e-5, chunk=16384), twice; the second
   run is timed, counted (K1 launches must equal tiers x (2 + steps)) and
   checked against golden tok1024 (relative error < 1e-5).
5. breakdown: one assembly, one trace solve and one SVD at n=1024, timed.
6. build_pic: kernels K2, K3, K4 compiled from csrc/pic.cu (started in
   parallel with K1's build in phase 2).
7. grid_sync_probe: the cooperative-launch attribute, K3's co-resident grid
   and K4 at that grid, which must see every block's writes.
8. pic_stage_vs_plain: at the canonical size (tok1024, 1024 markers per
   cell, drift-center on, f32) one step of K2 with the first-stage quirk
   and one without, each stage against stage_ref on the same inputs (bars
   2e-5 of scale, eta within 1 ulp); kernel, field and plain ms per stage.
9. pic_mega_vs_stages: 8 steps of K3 (launch="single") against 8 steps of
   K2 (launch="stages") and the plain mega_ref from one state: stats 1e-5,
   state 2e-5 (dc_pb 1e-4), eta bit-equal between K3 and K2.
10. pic_slice: the canonical run cuda_pic.run(p, 1024, 180, 0.25) with
   launch="auto", twice, the second timed and counted: it must take K3, and
   its (omega, gamma) fit must land within 5 % / 10 % of golden
   pic_tok1024; the plain path (pic.run) from the same initial state must
   fit within 1 % of it.

The last three lines are the kernels JSON, the nvidia-smi line and
{"ok": true, "device": {...}}.
"""

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = pathlib.Path(__file__).resolve().parent
# tests/goldens/eigenvalues.json "tok1024" (the C++ reference, float64)
GOLDEN_TOK1024 = complex(-0.8323805740805391, 0.2565467084687576)
GUESS = -0.8 + 0.25j
ES_BAR = 5e-7      # tests/test_pallas_kappa.py:35, electrostatic moment
EM_BAR = 5e-6      # tests/test_pallas_kappa.py:53, electromagnetic moments
SOLVE_BAR = 1e-5   # relative error of omega vs golden tok1024
RESIDUAL_BAR = 1e-4  # ||M v|| / ||M||_F at the converged float32 operator
N_TOK = 1024       # the main path's grid (bench.py: tok1024)
N_STEL = 128       # the electromagnetic kernel check's grid
# tests/goldens/eigenvalues.json "pic_tok1024": the C++ reference's fit of
# the canonical PIC run (its RNG differs, so the check is statistical)
GOLDEN_PIC = complex(0.837758, 0.203384)
PIC_MPC, PIC_STEPS, PIC_DT = 1024, 180, 0.25   # benchmarks/bench_pic.py
PIC_BARS = {"weight": 2e-5, "field": 2e-5, "j0": 2e-5, "dc_pb": 1e-4}
STAGE_BAR = 2e-5   # tests/test_pallas_pic.py:48, state relative to scale
STATS_BAR = 1e-5   # tests/test_pallas_pic.py:39


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def timed(fn, torch, repeats=3):
    """Median wall time in ms of ``fn()`` over ``repeats`` calls after one
    warm-up, each bracketed by torch.cuda.synchronize(); returns
    (median ms, last result)."""
    out = fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def load_cfg(name, npoints):
    with open(REPO / "tests" / "goldens" / "inputs" / f"{name}.json") as f:
        return dict(json.load(f), npoints=npoints)


def compare(p, eta_a, eta_b, omega, ms, quad, bar, torch, cuda_kappa):
    """K1 vs the plain version on one pair set: errors, scale, and core
    times (inputs prepared once; kernel launch vs plain arithmetic)."""
    got = cuda_kappa.kappa_pairs_fused(p, eta_a, eta_b, omega, ms=ms, quad=quad)
    ref = cuda_kappa.kappa_pairs_ref(p, eta_a, eta_b, omega, ms=ms, quad=quad)
    torch.cuda.synchronize()
    errs, scales = [], []
    for a, b in zip(got, ref):
        check(a.is_cuda and bool(torch.isfinite(a).all()),
              "kernel output on the card and finite")
        errs.append(float((a - b).abs().max()))
        scales.append(float(b.abs().max()))
        check(errs[-1] <= bar * max(scales[-1], 1.0),
              f"kernel vs plain {errs[-1]:.3e} > {bar} max({scales[-1]:.3e}, 1)")
    args = cuda_kappa._prepare(p, eta_a, eta_b, omega, quad)
    mid, halfw, pair, scal, order = args
    k_ms, _ = timed(lambda: cuda_kappa._launch(mid, halfw, pair, scal, order,
                                               ms), torch)
    p_ms, _ = timed(lambda: cuda_kappa._plain(mid, halfw, pair, scal, order,
                                              ms), torch)
    w_ms, _ = timed(lambda: cuda_kappa.kappa_pairs_fused(
        p, eta_a, eta_b, omega, ms=ms, quad=quad), torch)
    return {"npairs": int(eta_a.shape[0]), "n_panels": int(mid.shape[1]),
            "order": order, "max_abs_err": max(errs), "scale": max(scales),
            "kernel_ms": k_ms, "plain_ms": p_ms, "wrapper_ms": w_ms}


def rel_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def within_ulp(a, b, torch):
    inf = torch.full_like(b, float("inf"))
    return bool(((a == b) | (a == torch.nextafter(b, inf))
                 | (a == torch.nextafter(b, -inf))).all())


def pic_stage_phase(torch, cuda_pic, fs, qn, arrs, field, card):
    """Phase 8: one step of K2 with the first-stage quirk and one without,
    each stage against stage_ref on the same inputs; returns the kernel
    entry's numbers."""
    names = ("vel_re", "vel_im", "eta", "w_re", "w_im", "field_re",
             "field_im")
    errs, k_ms, f_ms, p_ms = [], [], [], []
    for first_step in (True, False):
        vel_prev = None
        for s in range(3):
            first = first_step and s == 0
            args = (s, first, fs.dc, fs.params, *field, qn, arrs, vel_prev)
            got = cuda_pic.stage(*args)
            ref = cuda_pic.stage_ref(*args)
            torch.cuda.synchronize()
            for name, a, b in zip(names, got, ref):
                check(a.is_cuda and bool(torch.isfinite(a).all()),
                      f"K2 {name} on the card and finite")
                check(rel_err(a, b) < STAGE_BAR,
                      f"K2 stage {s} first={first} {name} "
                      f"{rel_err(a, b):.3e} < {STAGE_BAR}")
            check(within_ulp(got[2], ref[2], torch),
                  f"K2 stage {s} eta within 1 ulp of the plain version")
            err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
            errs.append(err)
            km, (*outs, partials) = timed(lambda: cuda_pic._launch_stage(
                s, first, fs.dc, fs.params, *field, arrs, vel_prev), torch)
            fm, _ = timed(lambda: cuda_pic._launch_field(partials, qn), torch)
            pm, _ = timed(lambda: cuda_pic.stage_ref(*args), torch)
            k_ms.append(km)
            f_ms.append(fm)
            p_ms.append(pm)
            emit("pic_stage_vs_plain", stage=s, first=first,
                 markers=int(arrs["eta"].shape[0]), max_abs_err=err,
                 eta_bit_equal=bool(torch.equal(got[2], ref[2])),
                 stage_ms=km, field_ms=fm, plain_ms=pm, card=card)
            if s == 1:
                vel_prev = got[:2]
            arrs = dict(arrs, eta=got[2], w_re=got[3], w_im=got[4])
            field = got[5:]
    return {"max_abs_err": max(errs), "ms": sum(k_ms) + sum(f_ms),
            "plain_ms": sum(p_ms)}


def pic_phases(torch, build_rec, card):
    """Phases 6-10 (PIC: kernels K2, K3, K4); returns their entries of the
    kernels line."""
    from emme_tpu_torch import from_config
    from emme_tpu_torch.solvers import cuda_pic, pic

    dev = torch.device("cuda")
    f32 = torch.float32

    # 6. build_pic
    ptxas = [ln.strip() for ln in build_rec["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build_pic", library=str(pathlib.Path(build_rec["path"]).relative_to(REPO)),
         seconds=build_rec["seconds"], ptxas=ptxas)

    p = from_config(load_cfg("tokamak", 1024), dtype=f32, device=dev)
    check(p.drift_center_transformation_switch, "canonical case is dc on")
    m = PIC_MPC * p.npoints

    # 7. grid_sync_probe
    grid = cuda_pic.mega_grid(dev, p.npoints, True)
    x = torch.rand((grid["grid"], cuda_pic.THREADS), device=dev)
    probe = cuda_pic.grid_sync_probe(x)
    probe_ref = cuda_pic.grid_sync_probe_ref(x)
    torch.cuda.synchronize()
    probe_ok = bool(torch.equal(probe, probe_ref))
    check(grid["cooperative"], "the device supports cooperative launch")
    check(grid["blocks_per_sm"] >= 1, "K3 fits one block per SM")
    check(probe_ok, "grid-sync probe: every block saw every block's writes")
    probe_ms, _ = timed(lambda: cuda_pic.grid_sync_probe(x), torch)
    probe_plain_ms, _ = timed(lambda: cuda_pic.grid_sync_probe_ref(x), torch)
    emit("grid_sync_probe", cooperative_launch=grid["cooperative"],
         blocks_per_sm=grid["blocks_per_sm"], sms=grid["sms"],
         grid=grid["grid"], threads=cuda_pic.THREADS,
         rounds=cuda_pic.PROBE_ROUNDS, ok=probe_ok, ms=probe_ms,
         plain_ms=probe_plain_ms, card=card)

    # 8. pic_stage_vs_plain, from a seeded state at the canonical size
    s0 = pic.init_state(p, PIC_MPC, torch.Generator(device=dev).manual_seed(0),
                        dtype=f32)
    fs = cuda_pic.FusedStep(p, m, PIC_DT)
    qn = pic.quasi_neutrality_coef(p, dtype=f32)
    field0 = (s0.field.real.contiguous(), s0.field.imag.contiguous())
    k2 = pic_stage_phase(torch, cuda_pic, fs, qn, cuda_pic.state_to_arrs(s0),
                         field0, card)

    # 9. pic_mega_vs_stages: the run entry point both ways, and mega_ref
    n9 = 8
    for k in cuda_pic.LAUNCHES:
        cuda_pic.LAUNCHES[k] = 0
    st_k2, s_k2, _ = cuda_pic.run(p, PIC_MPC, n9, PIC_DT, state=s0,
                                  launch="stages")
    torch.cuda.synchronize()
    k2_launches = dict(cuda_pic.LAUNCHES)
    check(k2_launches["pic_stage"] == 3 * n9
          and k2_launches["pic_field"] == 3 * n9,
          f"launch='stages' ran K2 3 x {n9} times: {k2_launches}")
    st_k3, s_k3, _ = cuda_pic.run(p, PIC_MPC, n9, PIC_DT, state=s0,
                                  launch="single")
    arrs0 = cuda_pic.state_to_arrs(s0)
    ref9 = cuda_pic.mega_ref(True, fs.params, *field0, qn, arrs0, n9)
    torch.cuda.synchronize()
    check(st_k3.shape == (n9, 3) and st_k3.is_cuda
          and bool(torch.isfinite(st_k3).all()), "K3 stats finite on the card")
    check(rel_err(st_k3, st_k2) < STATS_BAR,
          f"K3 vs K2 stats {rel_err(st_k3, st_k2):.3e} < {STATS_BAR}")
    check(rel_err(st_k3, ref9[5]) < STATS_BAR,
          f"K3 vs plain stats {rel_err(st_k3, ref9[5]):.3e} < {STATS_BAR}")
    state_errs = {}
    for name, bar in PIC_BARS.items():
        state_errs[name] = rel_err(getattr(s_k3, name), getattr(s_k2, name))
        check(state_errs[name] < bar,
              f"K3 vs K2 {name} {state_errs[name]:.3e} < {bar}")
    check(torch.equal(s_k3.eta, s_k2.eta), "K3 and K2 eta bit-equal")
    k3_vs_plain = [(s_k3.eta, ref9[0]), (s_k3.weight.real, ref9[1]),
                   (s_k3.weight.imag, ref9[2]), (s_k3.field.real, ref9[3]),
                   (s_k3.field.imag, ref9[4]), (st_k3, ref9[5])]
    for a, b in k3_vs_plain[1:]:
        check(rel_err(a, b) < STAGE_BAR,
              f"K3 vs plain {rel_err(a, b):.3e} < {STAGE_BAR}")
    check(within_ulp(s_k3.eta, ref9[0], torch), "K3 eta within 1 ulp of plain")
    k3_err = max(float((a - b).abs().max()) for a, b in k3_vs_plain)
    arrs0 = cuda_pic.state_to_arrs(s0)
    k3_ms, _ = timed(lambda: cuda_pic.mega(True, fs.params, *field0, qn,
                                           arrs0, n9), torch)
    k2_ms, _ = timed(lambda: cuda_pic.run(p, PIC_MPC, n9, PIC_DT, state=s0,
                                          launch="stages"), torch)
    plain_ms, _ = timed(lambda: cuda_pic.mega_ref(True, fs.params, *field0,
                                                  qn, arrs0, n9), torch)
    emit("pic_mega_vs_stages", steps=n9, markers=m, grid=grid["grid"],
         stats_rel_err=rel_err(st_k3, st_k2),
         stats_bit_equal=bool(torch.equal(st_k3, st_k2)),
         eta_bit_equal=True, state_rel_err=state_errs,
         k3_vs_plain_max_abs_err=k3_err, k3_ms=k3_ms, k2_run_ms=k2_ms,
         plain_ms=plain_ms, k2_launches=k2_launches, card=card)

    # 10. pic_slice: the canonical run through launch="auto"
    def canonical():
        gen = torch.Generator(device=dev).manual_seed(1)
        return cuda_pic.run(p, PIC_MPC, PIC_STEPS, PIC_DT, generator=gen)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    canonical()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    # as in a fresh process: the once-per-process self-check runs again
    cuda_pic._SELFCHECK.clear()
    for k in cuda_pic.LAUNCHES:
        cuda_pic.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats, s_end, _ = canonical()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(cuda_pic.LAUNCHES)
    check(cuda_pic.LAST_LAUNCH == "single", "the canonical run took K3")
    check(launches["pic_mega"] == 1 and launches["grid_sync_probe"] >= 1,
          f"the canonical run launched K3 once and K4: {launches}")
    check(stats.is_cuda and stats.shape == (PIC_STEPS, 3)
          and bool(torch.isfinite(stats).all()), "stats finite on the card")
    check(bool(torch.isfinite(s_end.field).all()), "final field finite")
    om = pic.calculate_omega(stats, PIC_DT)
    d_om = abs(om.real - GOLDEN_PIC.real) / abs(GOLDEN_PIC.real)
    d_gam = abs(om.imag - GOLDEN_PIC.imag) / abs(GOLDEN_PIC.imag)
    check(d_om < 0.05 and d_gam < 0.10,
          f"fit {om} within 5 % / 10 % of golden pic_tok1024 {GOLDEN_PIC}")

    s_init = pic.init_state(p, PIC_MPC,
                            torch.Generator(device=dev).manual_seed(1),
                            dtype=f32)
    # K3 alone over the run (wrapper included), against the run's wall time
    arrs_c = cuda_pic.state_to_arrs(s_init)
    field_c = (s_init.field.real.contiguous(), s_init.field.imag.contiguous())
    k3_run_ms, _ = timed(lambda: cuda_pic.mega(True, fs.params, *field_c, qn,
                                               arrs_c, PIC_STEPS), torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats_plain, _, _ = pic.run(p, PIC_MPC, PIC_STEPS, PIC_DT, state=s_init)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    om_plain = pic.calculate_omega(stats_plain, PIC_DT)
    agree = (abs(om.real - om_plain.real) / abs(om_plain.real),
             abs(om.imag - om_plain.imag) / abs(om_plain.imag))
    step_diff = float(((stats - stats_plain).norm(dim=1)
                       / stats_plain.norm(dim=1)).max())
    emit("pic_slice", case="tok1024 x 1024 markers/cell, 180 steps, dt 0.25, "
         "f32, drift-center", markers=m, seconds=run_s,
         first_run_seconds=first_s, k3_ms=k3_run_ms,
         k3_share_of_wall=k3_run_ms / 1e3 / run_s, path=cuda_pic.LAST_LAUNCH,
         launches=launches, omega=[om.real, om.imag],
         golden=[GOLDEN_PIC.real, GOLDEN_PIC.imag], rel_err=[d_om, d_gam],
         plain_seconds=plain_s, plain_omega=[om_plain.real, om_plain.imag],
         kernel_vs_plain_fit=list(agree), max_step_stats_rel_diff=step_diff,
         card=card)
    check(max(agree) < 0.01, f"kernel and plain fits agree to 1 %: {agree}")
    check(all(math.isfinite(v) for v in (om.real, om.imag)), "finite fit")

    src, rep = "emme_tpu_torch/csrc/pic.cu", "emme_tpu/solvers/pallas_pic.py"
    return [
        {"name": "pic_stage", "route": "cuda", "source": src,
         "replaces": f"{rep}:148", "launches": k2_launches["pic_stage"],
         "launches_from": f"cuda_pic.run(launch='stages'), {n9} steps",
         **k2},
        {"name": "pic_mega", "route": "cuda", "source": src,
         "replaces": f"{rep}:438", "launches": launches["pic_mega"],
         "launches_from": "cuda_pic.run(launch='auto'), canonical run",
         "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": plain_ms,
         "steps": n9},
        {"name": "grid_sync_probe", "route": "cuda", "source": src,
         "replaces": f"{rep}:621", "launches": launches["grid_sync_probe"],
         "launches_from": "cuda_pic.run(launch='auto'), canonical run",
         "max_abs_err": float((probe - probe_ref).abs().max()),
         "ms": probe_ms, "plain_ms": probe_plain_ms},
    ]


def main():
    import torch

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on an NVIDIA GPU")
    sys.path.insert(0, str(REPO))
    from emme_tpu_torch import _build, from_config
    from emme_tpu_torch.grid import Grid
    from emme_tpu_torch.ops import cuda_kappa, kernels, linalg
    from emme_tpu_torch.ops.singularity import singularity_coeff_matrix
    from emme_tpu_torch.solvers import eigen

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count(),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # 2. build: every kernel source compiles at once, one nvcc each
    with ThreadPoolExecutor(2) as pool:
        builds = {name: pool.submit(_build.build, name)
                  for name in ("kappa", "pic")}
        builds = {name: f.result() for name, f in builds.items()}
    rec = builds["kappa"]
    ptxas = [ln.strip() for ln in rec["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", library=str(pathlib.Path(rec["path"]).relative_to(REPO)),
         seconds=rec["seconds"], ptxas=ptxas)

    dev = torch.device("cuda")
    f32 = torch.float32

    # 3. kernel vs plain
    p = from_config(load_cfg("tokamak", N_TOK), dtype=f32, device=dev)
    grid = Grid.create(p.length, p.npoints, dtype=f32, device=dev)
    tiers = kernels.tier_thresholds_ij(2.0 * float(p.length) / (p.npoints - 1),
                                       p.npoints)
    groups = eigen.pair_plan(p.npoints, tiers, str(grid.eta.device))["groups"]
    omega = torch.tensor(GUESS, dtype=torch.complex64, device=dev)
    rows = []
    for t, (iu, ju, spec) in enumerate(groups):
        quad = kernels.scaled_quad(None, f32, spec)
        r = compare(p, grid.eta[iu], grid.eta[ju], omega, (0,), quad, ES_BAR,
                    torch, cuda_kappa)
        rows.append(r)
        emit("kernel_vs_plain", case=f"tok{N_TOK}", tier=t, ms_moments=[0], **r)
    ps = from_config(load_cfg("stellarator", N_STEL), dtype=f32, device=dev)
    gs = Grid.create(ps.length, ps.npoints, dtype=f32, device=dev)
    iu, ju = torch.triu_indices(ps.npoints, ps.npoints, 1, device=dev)
    r_em = compare(ps, gs.eta[iu], gs.eta[ju],
                   torch.tensor(-1.656 + 2.49j, dtype=torch.complex64,
                                device=dev),
                   (0, 1, 2), None, EM_BAR, torch, cuda_kappa)
    emit("kernel_vs_plain", case=f"stel{N_STEL}", tier=None, ms_moments=[0, 1, 2],
         **r_em)

    # 4. the slice: the dense float32 TraceSecant solve at n=1024
    def solve():
        return eigen.solve(p, GUESS, tol=1e-5, chunk=16384)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    cuda_kappa.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    om, vec, n_steps, state = solve()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = cuda_kappa.LAUNCHES
    rel = abs(om - GOLDEN_TOK1024) / abs(GOLDEN_TOK1024)
    M = state.M
    residual = float(torch.linalg.vector_norm(M @ vec)
                     / torch.linalg.matrix_norm(M))
    check(launches == len(groups) * (2 + n_steps),
          f"K1 launches {launches} == {len(groups)} tiers x (2 + {n_steps})")
    check(M.is_cuda and vec.is_cuda and state.omega.is_cuda,
          "M, eigenvector and omega on the card")
    check(M.shape == (N_TOK, N_TOK) and vec.shape == (N_TOK,)
          and M.dtype == torch.complex64, "shapes and dtype")
    check(bool(torch.isfinite(M).all()) and bool(torch.isfinite(vec).all()),
          "finite M and eigenvector")
    check(rel < SOLVE_BAR, f"omega rel err {rel:.3e} < {SOLVE_BAR}")
    check(residual < RESIDUAL_BAR, f"||M v||/||M|| {residual:.3e} < {RESIDUAL_BAR}")
    emit("slice", case=f"tok{N_TOK} float32 dense TraceSecant", omega=[om.real, om.imag],
         golden=[GOLDEN_TOK1024.real, GOLDEN_TOK1024.imag], rel_err=rel,
         steps=n_steps, seconds=solve_s, first_run_seconds=first_s,
         launches=launches, tiers=len(groups), residual=residual, card=card)

    # 5. breakdown of one step's parts at n=1024
    coeff = singularity_coeff_matrix(p.npoints, dtype=f32, device=dev)
    asm_ms, _ = timed(lambda: eigen.assemble_matrix(
        p, grid, coeff, state.omega, None, 16384, tiers, True), torch)
    lin_ms, _ = timed(lambda: linalg.complex_solve_trace(M, state.dM),
                      torch)
    svd_ms, _ = timed(lambda: eigen.null_space(M), torch)
    emit("breakdown", assembly_ms=asm_ms, kernel_ms_per_assembly=sum(
        r["kernel_ms"] for r in rows), trace_solve_ms=lin_ms, svd_ms=svd_ms,
         card=card)

    pic_kernels = pic_phases(torch, builds["pic"], card)

    kernels_line = {"kernels": [{
        "name": "kappa_pairs",
        "route": "cuda",
        "source": "emme_tpu_torch/csrc/kappa.cu",
        "replaces": "emme_tpu/ops/pallas_kappa.py:241",
        "launches": launches,
        "max_abs_err": max([r["max_abs_err"] for r in rows] + [r_em["max_abs_err"]]),
        "ms": sum(r["kernel_ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
    }] + pic_kernels}
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
