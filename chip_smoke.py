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

The last three lines are the kernels JSON, the nvidia-smi line and
{"ok": true, "device": {...}}.
"""

import json
import pathlib
import statistics
import subprocess
import sys
import time

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

    # 2. build
    rec = _build.build("kappa")
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

    kernels_line = {"kernels": [{
        "name": "kappa_pairs",
        "route": "cuda",
        "source": "emme_tpu_torch/csrc/kappa.cu",
        "replaces": "emme_tpu/ops/pallas_kappa.py:241",
        "launches": launches,
        "max_abs_err": max([r["max_abs_err"] for r in rows] + [r_em["max_abs_err"]]),
        "ms": sum(r["kernel_ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
    }]}
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
