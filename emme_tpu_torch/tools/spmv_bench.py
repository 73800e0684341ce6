"""Times of K5's multi-vector kernel (``bsr_spmm_ring_kernel``,
``csrc/spmv.cu``) on the tok8192 banded operator on one NVIDIA GPU, one JSON
line per measurement.

    python3 emme_tpu_torch/tools/spmv_bench.py [--reps N]

Builds the operator of the banded slice (tokamak, npoints 8192, float32,
band_deta 10: 1,840 stored 128 x 128 complex64 blocks) through K1, then for
r = 8, 16 and 32 right-hand sides times the kernel, its plain version
``bsr_matvec_ref`` and the generic kernel (``bsr_spmv_tile_kernel``, which
the same shapes took before the ring kernel existed), checks the kernel
against the plain version (1e-5 of scale) and that two runs repeat bit for
bit.  Each line carries the card's name and power limit and the bound: the
larger of the bytes (blocks, indices, x, y, each once) over 3.35 TB/s and
the float32 operations (8 a complex multiply-add) over 67 TFLOP/s.
"""

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parents[2]
N, BAND_DETA, SEED_OMEGA = 8192, 10.0, -0.8405 + 0.2529j
PEAK_BYTES_PER_S, PEAK_F32_FLOP_PER_S = 3.35e12, 67e12
BAR = 1e-5


def emit(**fields):
    print(json.dumps(fields), flush=True)


def event_ms(fn, torch, reps, rounds=5):
    """Device ms a call of ``fn()``: ``rounds`` times ``reps`` back-to-back
    calls between a pair of CUDA events, after a warm-up; returns (median,
    least) of the rounds."""
    fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times), min(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("spmv_bench: needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    from emme_tpu_torch import _build, from_config
    from emme_tpu_torch.grid import Grid
    from emme_tpu_torch.ops import cuda_spmv, sparse
    from emme_tpu_torch.ops.singularity import singularity_coeff_band
    from emme_tpu_torch.solvers import eigen, sparse_eigen as se

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(2) as pool:
        base = pool.submit(_build.build, "spmv")
        pool.submit(_build.build, "kappa")
        emit(phase="build", seconds=base.result()["seconds"], ptxas=[
            ln.strip() for ln in base.result()["log"].splitlines()
            if "spmm" in ln or "registers" in ln or "spill" in ln], card=card)

    dev, f32 = torch.device("cuda"), torch.float32
    with open(ROOT / "tests" / "goldens" / "inputs" / "tokamak.json") as f:
        p = from_config(dict(json.load(f), npoints=N), dtype=f32)
    grid = Grid.create(p.length, N, dtype=f32)
    bs = se.pick_block(N)
    h = se.band_halfwidth(p, grid, bs, BAND_DETA)
    cband = singularity_coeff_band(N, (h + 1) * bs - 1, dtype=f32)
    tiers = eigen.discretization(p, f32)[0]
    op = se.assemble_bdia(
        p, grid, cband, torch.tensor(SEED_OMEGA, dtype=torch.complex64,
                                     device=dev), h, bs, tiers=tiers,
        fused=True)
    bsr = sparse.bdia_to_bsr(op)
    del op
    gen = torch.Generator(device=dev).manual_seed(0)

    # the same operator with its blocks 8 bytes off a 16-byte boundary: the
    # ring kernel does not take it, so it goes through the generic kernel
    buf = torch.empty(bsr.data.numel() + 1, dtype=bsr.data.dtype, device=dev)
    buf[1:] = bsr.data.reshape(-1)
    shifted = sparse.BSROperator(
        data=buf[1:].view(bsr.data.shape), col_idx=bsr.col_idx,
        row_of=bsr.row_of, row_ptr=bsr.row_ptr, n=bsr.n, block=bsr.block)

    def generic(x):
        return cuda_spmv.bsr_matvec(shifted, x)

    for r in (8, 16, 32):
        x = torch.randn((N, r), dtype=torch.complex64, device=dev,
                        generator=gen)
        ref = sparse.bsr_matvec_ref(bsr, x)
        got = cuda_spmv.bsr_matvec(bsr, x)
        again = cuda_spmv.bsr_matvec(bsr, x)
        old = generic(x)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        n_bytes = sum(t.numel() * t.element_size() for t in
                      (bsr.data, bsr.col_idx, bsr.row_ptr, x, got))
        flop = 8 * bsr.data.numel() * r
        by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
        by_ops = flop / PEAK_F32_FLOP_PER_S * 1e3
        k_ms, k_min = event_ms(lambda: cuda_spmv.bsr_matvec(bsr, x), torch,
                               args.reps)
        p_ms, _ = event_ms(lambda: sparse.bsr_matvec_ref(bsr, x), torch,
                           args.reps)
        g_ms, _ = event_ms(lambda: generic(x), torch, args.reps)
        k2_ms, _ = event_ms(lambda: cuda_spmv.bsr_matvec(bsr, x), torch,
                            args.reps)
        emit(phase="spmm", r=r, nnzb=bsr.nnzb, block=bsr.block,
             max_abs_err=err, scale=scale,
             ok=err <= BAR * scale, repeat_bit_equal=bool(torch.equal(
                 got, again)),
             generic_max_abs_err=float((old - ref).abs().max()),
             kernel_ms=k_ms, kernel_ms_min=k_min, kernel_ms_again=k2_ms,
             plain_ms=p_ms, generic_kernel_ms=g_ms,
             bound_ms=max(by_bytes, by_ops),
             bound_by="bytes" if by_bytes >= by_ops else "operations",
             bound_bytes_ms=by_bytes, bound_operations_ms=by_ops,
             share_of_bound=max(by_bytes, by_ops) / k_ms,
             speedup_vs_plain=p_ms / k_ms, card=card)


if __name__ == "__main__":
    main()
