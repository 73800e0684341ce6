"""Smoke run of the PyTorch / CUDA port (emme_tpu_torch) on one NVIDIA GPU.

Usage, from the repository root:

    python3 chip_smoke.py

It needs one CUDA card and the CUDA toolkit (nvcc); without a card it exits
non-zero before printing any result.  Phases, one JSON line each; a failed
check exits non-zero:

1. device: the card's name and power limit (nvidia-smi), TF32 off.
2. build:  kernel K1 compiled with nvcc from emme_tpu_torch/csrc/ into
   emme_tpu_torch/_build/; build_adaptive: kernel N1 (csrc/adaptive.cu,
   --fmad=false), started with the other three sources, one nvcc each;
   ptxas's registers and spills.
3. kernel vs plain: K1 against its plain PyTorch version on the card, on
   every |i - j| tier of the n=1024 tokamak pairs (ms=(0,), bar 5e-7
   max(scale, 1)) and on the n=128 stellarator pairs (ms=(0,1,2), bar
   5e-6 max(scale, 1)); median of 3 timed calls of each after a warm-up.
   Tier 0 (the near pairs, where the plain float32 version is the less
   accurate side) is held to the plain math in float64 on the same inputs,
   as phase 13 is: K1 within the bar of it, or no further from it than the
   plain float32 version; its distance to the plain version is printed.
3b. assembly_routes: one tok1024 and one stel1024 dense assembly on each
   route, the kernels (P, K1 a tier, Q, ops/cuda_assembly.py) and the
   torch around K1: CUDA-event and host-clock ms, the kernels each
   launches (torch.profiler), and the two operators' largest gap, held to
   phase 3's bar (5e-7 / 5e-6 max(scale, 1)).
3c. guard_routes: the driver's quadrature guard at tok1024 and stel1024
   (the solve's tier table and plan) at the converged omega and at one
   where the flags fire, on each route, the kernels (P, G, R, one host
   read) and the torch integrand: both reports (the same n_sampled,
   frac_flagged within 0.01, the largest errors within the torch route's
   own card-to-CPU spread), G's rows pair by pair against the torch
   integrand and R's report against the plain reduction of those rows;
   at the converged omega host-clock ms, the kernels and host reads each
   route makes (at most 10 and 2 on the kernels), G's CUDA-event ms beside
   its bound (its nodes times K1's operations a node,
   portbench/roofline/k1.py).
4. slice: the main path, from_config(tokamak, npoints=1024, float32, cuda)
   -> eigen.solve(p, -0.8+0.25j, tol=1e-5, chunk=16384) at its defaults on
   a card (the device loop, the null vector by inverse iteration), twice;
   the second run is timed, counted (K1 launches must equal tiers x (2 +
   the steps the loop queued)) and checked against golden tok1024 (relative
   error < 1e-5).
5. breakdown: one assembly, one trace solve, one SVD and one inverse
   iteration at n=1024, timed.
5b. dense_certify: the same case with tol=1e-6 and host64=True (complex128
   polish on the card), warm-up then timed: within 2e-6 of golden tok1024
   (tests/test_eigen.py:90; the JAX package's TPU record is 1.41e-6 from
   it, BENCH_r05.json).
5c. stel_slice: this slice's path at full width, from_config(stellarator,
   npoints=1024, float32) -> eigen.solve(sp, -1.656+2.490j, tol=1e-6,
   chunk=16384, host64=True) as bench.py:89-104 runs it (electromagnetic,
   operator 2048 x 2048), warm-up then timed and counted: K1 against its
   plain version on every tier with ms=(0,1,2) first; omega within 2e-4 of
   bench.py:94's golden (the JAX package's record: 1.31e-5 from it); K1
   launches must equal tiers x assemblies, all with three moments; residual
   ||M v|| / ||M||_F of the polished pair; peak device memory; one
   assembly and K1's part of it, timed.
5d. dense_methods: tok1024 float32 with method="QRSecant" and
   "BorderedSecant", each within 1e-5 of golden, and one
   qr_column_pivoted, timed; loop="device" against loop="host" (same
   steps, omega within 1e-6, the host reads of each: one blocking read a
   solve on the device loop); the null vector by
   inverse iteration against the SVD's on the converged M (correlation >
   1 - 1e-5, residuals, times).
6. build_pic: kernels K2, K3, K4 compiled from csrc/pic.cu (started in
   parallel with K1's build in phase 2), each of K2 and K3 in its four
   forms (csrc/pic.cu: where the field and the histogram live, by npoints);
   ptxas's registers and spills of each.
7. grid_sync_probe: the cooperative-launch attribute, K3's launch shape
   (co-resident grid, shared memory, registers) and K4 at that grid, which
   must see every block's writes; K4's time beside the
   same launch without its copies, and the cost of one grid barrier (the
   launch without copies at 1 and at 1081 rounds).
8. pic_stage_vs_plain: at the canonical size (tok1024, 1024 markers per
   cell, drift-center on, f32) one step of K2 with the first-stage quirk
   and one without, each stage against stage_ref on the same inputs (bars
   2e-5 of scale, eta within 1 ulp); kernel, field and plain ms per stage;
   the field reduce run twice on the same partials must repeat bit for bit.
9. pic_mega_vs_stages: 8 steps of K3 (launch="single") against 8 steps of
   K2 (launch="stages") and the plain mega_ref from one state: stats 1e-5,
   state 2e-5 (dc_pb 1e-4), eta bit-equal between K3 and K2; K3 run twice
   from the same state must repeat eta bit for bit (weights, field and
   stats repeat only to rounding: the order of the shared-memory atomics
   inside a block varies; whether they did repeat is printed).
10. pic_slice: the canonical run cuda_pic.run(p, 1024, 180, 0.25) with
   launch="auto", twice, the second timed and counted: it must take K3, and
   its (omega, gamma) fit must land within 5 % / 10 % of golden
   pic_tok1024; the plain path (pic.run) from the same initial state must
   fit within 1 % of it.
10b. pic_breakdown: at the canonical size, K3's time per stage with the
   marker pass or the field reduce left out, the grid barriers' cost from
   phase 7, K3's launch shape, and the share of K3's bound reached.
11. build_spmv: kernel K5 compiled from csrc/spmv.cu (started in parallel
   with K1's build in phase 2); registers and spills from ptxas.
12. spmv_vs_plain: K5 against bsr_matvec_ref on the tok8192 operator of
   the banded slice (complex64, r = 1, 8, 16 and 32, bar 1e-5 of scale)
   and on the tok1024 operator in complex128 (bar 1e-12 of scale); two
   runs of K5 must repeat bit for bit; ms of K5, of the plain version and
   of bdia_matvec, K5's GB/s of stored blocks and its share of the bound.
   The phase has a time limit of its own (120 s).
13. banded_kernel_vs_plain: K1 and its plain version on the first 2^17
   pairs of each tier section of the tok8192 kernel table, each against
   the plain math in float64 on the same inputs: K1 within the phase-3 bar
   of it, or no further from it than the plain version.
14. banded_slice: the banded main path, from_config(tokamak, npoints=8192,
   float32, cuda) -> sparse_eigen.solve(p, -0.8405+0.2529j, tol=1e-5,
   band_deta=10, m_krylov=16, spmv="bsr"), twice; the second is timed and
   counted (K5: 16 Arnoldi matvecs + 1 + 50 rate-chain matvecs; K1: table
   chunks x (4 + steps) assemblies), with nnz 30,146,560 and
   ||M v|| / ||M||_F < 1e-4; its omega must land within 2e-5 of the dense
   float32 trace secant at n=8192 run from it (the untruncated operator;
   the distance to the JAX package's recorded TPU value, bench.py:135-136,
   is printed too; phase 17 explains it).  Then the same solve with
   loop="device": the same steps, omega within 1e-6 of the host loop's,
   both times and the blocking host reads of each.
15. banded_breakdown: at n=8192, one assembly (and K1's share of it), the
   banded LU, the selected inverse with the trace, one banded solve, one
   Arnoldi stage and the null vector, in ms.
16. banded_certify: tok1024, band_deta 20, host64=True (complex128 polish
   on the card) within 2e-6 of golden tok1024.
17. banded_tpu_precision: phase 14's call again with every matmul of the
   banded LU, selected inverse and solves fed bf16-rounded operands (one
   bf16 pass, float32 accumulation: a TPU's default precision); its omega
   must land within 1e-4 of the JAX package's recorded tok8192 value
   (bench.py:135-136), which phase 14's float32 omega misses.
18. driver_eigen: the product surface.  An input file written from
   tests/goldens/inputs/tokamak.json (npoints 1024) goes through
   emme_tpu_torch.cli.main([input, "-o", out, "--f32", "--host64",
   "--chunk", "16384", "-q"]) twice, the second timed and counted:
   output.json's eigenvalue within 2e-6 of golden tok1024, an eigenvector
   of 1024 entries, eigenMatrics/eigenMatrix.bin of 1024^2 x 16 bytes, the
   quadrature guard's record, K1 launches > 0, the guard on the kernels
   (eigen.GUARD_ROUTE one "kernels", G and R launched once each); its
   seconds beside phase
   5b's for the same solve (the driver's own cost: guard, dump, JSON) and
   the timer's sections ("All", "Iteration", "Output": the dump and
   output.json; the guard is what is left of "All").
19. driver_pic: the canonical PIC case from an input file ("method": "PIC",
   "pic_backend": "fused", "stream_fields": false, --f32), twice: one launch
   of K3 (and K4's self-check before it), the fit within 5 % / 10 % of
   golden pic_tok1024.  Then 8 steps with "pic_launch": "stages" (24 + 24
   launches of K2), the same case at npoints 16,384 (time_step large_dt:
   one launch of K3, a finite field of 16,384 entries), and 16 steps on the
   default streaming path, whose dump holds 16 x 1024 complex128 values.
19b. driver_pic_sorted: phase 19's input file with "pic_sorted": true at
   the driver's defaults (W 384, 128 chunks of 8,192 markers), twice: no
   window violation, no kernel launched (the sorted path is plain torch,
   whatever pic_backend says), no field dump, the fit within 5 % / 10 % of
   golden pic_tok1024; its seconds, sorts and peak device memory (also
   over what was allocated before it) beside the plain path from the same
   file ("pic_backend": "xla").  Then, from
   one state, 8 canonical steps of pic.run_sorted against pic.run (stats
   within 1e-4 relative, ms of each) and of the 'matmul' and 'bf16' CIC
   forms against 'take' / 'segment' ('matmul' field within 1e-4; 'bf16'
   printed, beside a repeat of the plain run).
20. driver_scan: tokamak npoints 1024 --f32 with "eta_i": {"head": 3.0,
   "step": 0.25, "tail": 3.5}: three points in walk order, each omega
   within 2e-5 of a direct eigen.solve at that eta_i from the seed the walk
   gave it, the checkpoint gone at the end; seconds and steps a point, and
   whether a later point took more steps than the first.  Then the same scan at
   npoints 32 in float64 on the card against
   tests/goldens/scan_eta_i_tok32.json at 2e-5.
21. driver_sparse: tokamak npoints 1024 with "eigen_backend": "sparse",
   "band_deta": 20, "m_krylov": 16, "spmv_method": "bsr", --f32 --host64:
   within 2e-6 of golden tok1024, the SpMV route K5's (16 + 1 + 50
   launches), the banded dump read back by load_bdia_dump.
22. eigen_timed: eigen.solve(p, -0.8+0.25j, tol=1e-5, chunk=16384,
   timed=True) at tok1024: phase 4's omega within 1e-6, and the seconds a
   step of " - linear solve", " - integration" and " - differential", each
   ended by a device synchronize.
23. pic_large_grid: K2 and K3 past the small-grid form, tokamak npoints
   16,384 (16,777,216 markers: the histogram in one block's shared memory,
   a cluster of one, the field from device memory), 1024 markers per cell,
   drift-center, dt 0.25 scaled with the cell width (large_dt: at dt 0.25
   the grid-scale mode overflows float32 within the canonical 180 steps
   there).  K3 against mega_ref over 8 steps and K2's stage 1 against
   stage_ref, at phases 8-9's bars; eta bit-equal between two K3 runs and
   between K3 and K2 (the run entry point, launch="stages", counted); the
   deposit's share of K3's time (K3 without it, by difference); the
   180-step run through cuda_pic.run, counted, finite, and K3 alone over
   it (median of 3 after a warm-up) with its bound; K3 against the plain
   pic.run from one state at 256 markers per cell, 30 steps, per-step
   statistics within 1 %; and, reported only, K3 over 180 steps at dt 0.25
   from the 1024- and the 256-markers-a-cell states: the first step that
   leaves float32.  Then, one line each (pic_large_grid_size), npoints
   32,768 and 65,536 (1024 markers per cell: 33.5M and 67.1M markers; the
   histogram in a thread-block cluster's distributed shared memory,
   clusters of 2 and 4), 224,256 (16 markers per cell, the cluster form's
   cap: clusters of 8, every rank's slice filling its block) and 229,376
   (16 markers per cell, past the cap: a scratch row a block): the launch
   shape (cluster size, clusters, SMs covered), K4 at that shape against
   its plain version, K3 against mega_ref over 8 steps and twice, the
   deposit's share, K2's stage 1 against stage_ref, and the run entry
   point counted, launch "auto" (K4 and K3 once) and "stages" (K2), eta
   bit-equal with K3; K3's launch shape (clusters, SMs covered) for
   clusters of 2, 4 and 8.  K3's bounds count the markers' bytes once a
   stage where their state outgrows the L2, the carry left out (k3_bytes).
   Time limit 300 s.
24. dense_arnoldi: arnoldi.solve(p, -0.8+0.25j, m_krylov=24,
   newton_polish=6, tol=1e-5) at tok1024 float32 (assemblies through K1
   on the base panel mesh) and eigen.solve's TraceSecant from the same
   guess, a warm-up of each, then 5 calls of each in turns, each counted:
   the medians and every time; within 1e-5 of golden tok1024,
   ||M v|| / ||M||_F < 1e-4; the raw Arnoldi estimate's
   distance to golden; the sixteen shifts of benchmarks/bench_arnoldi.py
   (default_rng(0), -0.8+0.25j +- 0.15) through solve_shifts_batched,
   counted (K1's launches and arnoldi.SURVEY_ROUTE, 1 / 16 / 32 / 16),
   with its seconds, peak device memory and the four closest
   estimates, two of them against solve_one_shift (BATCH_BAR).  Time limit
   120 s.
25. mesh_window_assembly: the windows of a 4-row layout of the tok8192
   banded float32 operator (band_deta 10, block pick_block(8192 // 4) =
   128, tiered) through sparse_eigen.assemble_bdia_window, K1 for every
   table chunk, in this process: each window within the phase-3 bar (5e-7
   max(scale, 1)) of the same block rows of the whole assemble_bdia
   operator, one K1 launch a chunk (counted once a window), and K1 on the
   window's first 2^17 table pairs held to the plain math in float64 as in
   phase 13; each window's ms and launches beside the whole assembly's (the
   quadrature's division over the shards, halo included).
26. mesh_slice: the multi-device paths over NCCL, one rank a card, with
   rows = torch.cuda.device_count(), in one spawn through
   parallel.mesh.launch (deadline MESH_DEADLINE_S): the collectives on cuda
   complex64 and complex128 tensors against their definitions (the edge
   zeros of ppermute included); then through emme_tpu_torch.cli --f32 with
   "mesh": {"rows": R}: tok8192 sparse (the SPIKE solve, band_deta 10,
   from phase 14's seed) within 2e-5 of phase 14's dense float32 omega at
   n=8192, its distance from phase 14's banded omega, its steps and K1
   launches in the rank; tok1024 dense (the pair-sharded assembly) within
   1e-5 of golden tok1024; the canonical PIC case (marker-sharded, the
   plain step) within 5 % / 10 % of golden pic_tok1024; each with its
   seconds beside its single-device phase's (14, 4 and 10's plain run).
27. native_vs_plain (run after phase 5d): kernel N1 (csrc/adaptive.cu, the
   float64 adaptive Gauss-Kronrod integrals of the reference-exact engine)
   against its plain version (ops/adaptive.integrate_ref) on the card, on
   every integral of one assembly, as eigen_native.solve launches it: the
   523,776 tok1024 pairs (m = 0, G7K15, depth limit 100) and the 523,776
   stel1024 pairs with three moments (1,571,328 integrals, G15K31, depth
   limit 20); no integral split differently (panel counts) or with other
   Miller steps, and max abs within 1e-12 of the largest value; max abs,
   median, flips, the kernel's ms (median of 3) and the plain version's,
   the bound, and native.assemble's ms without a plan and with one made
   beforehand (native.assembly_plan; the plan's N1 memo serves the
   repeats: the first plain, the second filling, the others reading), the
   two M equal bit for bit, the
   plan's N1 rows equal to adaptive.pair_rows of the pairs' ends bit for
   bit, and native.ASSEMBLY_ROUTE; N1's launch shape (slots a warp:
   integrals a warp holds at a time, blocks of the persistent grid,
   registers a thread) and SHA-256 digests of its outputs (the values with
   -0 read as +0, the panel counts, the Miller steps), as
   emme_tpu_torch/tools/native_bench.py prints them for a parent commit.
   native_memo: N1's memo (cuda_adaptive.Memo) along a whole
   eigen_native.solve of each, each launch against a memo-free one at the
   same omega (0 values or panel counts differing): the routes (first,
   fill, reads), each launch's CUDA-event ms beside the memo-free one's,
   Miller steps, nodes memoised and in full, the reads' hit share and the
   memo's bytes.
28. native_slice: eigen_native.solve(p, w0, tol=1e-6) in float64 on the
   card through the port's modules, counted (N1 launches = 2 + steps):
   stel1024 from -1.656+2.490j within 1e-8 of
   tests/goldens/stellarator_sequence.json's stel1024 in 3 steps, tok1024
   from -0.8+0.25j within 1e-8 of golden tok1024 in 5 steps; the seconds of
   each, and phase 5b's certified float32 omega's distance to this one;
   the null vector (one route count, inverse iteration on M^H M) within
   1e-11 up to a phase of the right singular vector of the card's SVD;
   one assembly plan a solve, every assembly planned, its N1 memo filled
   once and read at every step (native.ASSEMBLY_ROUTE).

The kernels JSON gives every kernel its bound: the larger of the bytes it
must move (each input read once, each output written once; for K3, whose
markers' state outgrows the 50 MB L2 past the canonical size, each
stage's marker loads and stores less the share the L2 could hold) over
3.35 TB/s and its float32 operations over 67 TFLOP/s (NVIDIA's H100 SXM
data sheet), from this run's shapes and data; N1's operations are float64,
counted from the engine's function (ops/cuda_adaptive.flop_count: the
Miller steps and panels this run's integrals took), each at one FP64
instruction: 132 SMs x 64 lanes x 1.98 GHz, 16.7e12 a second.  The operations of a node
of K1 and of a marker-stage of K2 / K3 are counted from the kernels'
machine code (emme_tpu_torch/tools/sass_count.py, an FMA as two) on the
path a node or marker executes: one side of each Bessel function's split,
Taylor or asymptotic, never both, weighted by the share of this run's nodes
and markers on each side; for K3 the stage body with J0 and the phase factor
carried in.  The static count of both sides together stands beside it as
static_flop_per_unit and is used in no bound.

K1's launches in the kernels JSON include phase 25's windows and phase
26's ranks (their counts come back from the spawned process).

The last three lines are the kernels JSON, the nvidia-smi line and
{"ok": true, "device": {...}}.
"""

import hashlib
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import threading
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
CERTIFY_BAR = 2e-6   # tests/test_eigen.py:90, host64 vs golden
# bench.py:94,104: the stellarator at n=1024, its golden and its bar; the
# JAX package's own record is 1.31e-5 from the golden
STEL_GUESS = -1.656 + 2.490j
STEL_GOLDEN = complex(-1.65655594094, 2.49032058254)
STEL_BAR = 2e-4
# guard_routes: an omega at which the integrand outpaces the oscillatory
# panels, so the guard's flags fire, and the bars between the guard's
# kernel and torch routes (tests/test_torch_cuda.py, where each is
# measured and argued)
GUARD_BAD_OMEGA = -6.0 + 0.001j
GUARD_ABS_SPREAD = 3e-4
GUARD_REL_FACTOR = 5.0
GUARD_BAD_CEIL = 3e-6
K5_TIME_LIMIT_S = 120
# dense_arnoldi: arnoldi.solve's tolerance (the main path's), the Krylov
# depth of tests/test_sparse_arnoldi.py and benchmarks/bench_arnoldi.py,
# and the bar between a batched and an unbatched float32 estimate (two LU
# paths and sweeps: the leading Ritz value parts at ~100 ulp)
SOLVE_TOL = 1e-5
ARNOLDI_KW = dict(m_krylov=24)
ARNOLDI_REPEATS = 5
BATCH_BAR = 1e-4
ARNOLDI_TIME_LIMIT_S = 120
# tests/goldens/eigenvalues.json "pic_tok1024": the C++ reference's fit of
# the canonical PIC run (its RNG differs, so the check is statistical)
GOLDEN_PIC = complex(0.837758, 0.203384)
PIC_MPC, PIC_STEPS, PIC_DT = 1024, 180, 0.25   # benchmarks/bench_pic.py
PIC_BARS = {"weight": 2e-5, "field": 2e-5, "j0": 2e-5, "dc_pb": 1e-4}
STAGE_BAR = 2e-5   # tests/test_pallas_pic.py:48, state relative to scale
STATS_BAR = 1e-5   # tests/test_pallas_pic.py:39
N_BAND = 8192      # the banded slice's grid (bench.py:117-138)
BAND_GUESS = -0.8405 + 0.2529j   # bench.py:126, the n=4096 continuation seed
BAND_KW = dict(tol=1e-5, band_deta=10.0, m_krylov=16, spmv="bsr")
# The banded omega is held to the dense float32 trace secant at the same n
# (the untruncated operator, its own assembly and LU), within twice the
# solve's 1e-5 criterion.  The JAX package's recorded tok8192 value
# (bench.py:135-136) is no bar for the float32 solve: its banded TPU runs
# did the banded linear algebra's matmuls at the TPU's default precision
# (one bf16 pass).  Phase 17 holds the same call with those matmuls
# emulated to the record, at bench.py:136's 1e-4.
BAND_RECORD = complex(-0.841785728931427, 0.25214308500289917)
BAND_BAR = 2e-5
RECORD_BAR = 1e-4
DENSE_CHECK_STEPS = 3
BAND_NNZ = 30_146_560   # 1,840 stored 128 x 128 blocks
CERT_BAR = 2e-6    # tests/test_sparse_eigen.py:56; BENCH_SPARSE.md:17 1.44e-6
# K5 vs plain: sums of ~4,200 float32 terms; complex128 as
# tests/test_sparse_eigen.py:247-250
SPMV_BARS = {"complex64": 1e-5, "complex128": 1e-12}
K1_CHECK_PAIRS = 1 << 17   # pairs per tier section in banded_kernel_vs_plain
# NVIDIA H100 SXM data sheet: device memory rate, float32 rate outside the
# tensor cores, L2 cache
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
L2_BYTES = 50e6
# float32 operations (FMA = 2, MUFU = 1) of one quadrature node of K1 and of
# one marker-stage of K2 / K3 (drift-center on), from
# emme_tpu_torch/tools/sass_count.py on CUDA 12.8: the kernel compiled with
# the Taylor side of its Bessel functions alone, with the asymptotic side
# alone, and ("static", used in no bound) with both as the package loads it.
# K2: pic_stage_kernel<stage, first, true>; K3: one stage's marker loop of
# pic_mega_kernel (J0 and the phase factor carried in); "0_first" is the
# run's first stage.
K1_FLOP_PER_NODE = {"taylor": 1071, "asymptotic": 935, "static": 1422}
K2_FLOP_PER_MARKER_STAGE = {
    "taylor": {"0_first": 720, "0": 940, "1": 940, "2": 946},
    "asymptotic": {"0_first": 473, "0": 565, "1": 565, "2": 571},
    "static": {"0_first": 877, "0": 1177, "1": 1177, "2": 1183}}
K3_FLOP_PER_MARKER_STAGE = {
    "taylor": {"0_first": 722, "0": 721, "1": 721, "2": 727},
    "asymptotic": {"0_first": 474, "0": 474, "1": 474, "2": 480},
    "static": {"0_first": 878, "0": 876, "1": 876, "2": 882}}
# Bytes a marker-stage of the K3 run must move in device memory, drift-center
# on (csrc/pic.cu mega_markers): Markers' v_par, v_perp, odv, ost, pw and
# MegaState's eta, wre, wim read, 32; eta, wre, wim written, 12; vel written
# at stage 1 and read at stage 2, 8.  The carry (j0, dcr, dci) is left out: it
# caches values the stage could compute from the same inputs, and the
# operations side (K3_FLOP_PER_MARKER_STAGE) already takes its saving.  The
# state a marker keeps between stages: Markers and vel, 10 float32 arrays.
K3_BYTES_PER_MARKER_STAGE = {"0_first": 44, "0": 44, "1": 52, "2": 52}
K3_STATE_BYTES_PER_MARKER = 40
BARRIER_ROUNDS = 1081   # K3's canonical run: two barriers a stage, and one
# driver_pic_sorted: the steps of run_sorted against run and of the CIC
# forms against take / segment, and the bar of both (float32 rounding: the
# unwrapped eta and the order of the sums)
SORTED_CHECK_STEPS = 8
SORTED_STATS_BAR = 1e-4
# pic_large_grid: the forms past the small-grid build: the histogram in one
# block's shared memory (16,384), in a cluster's distributed shared memory
# (32,768: clusters of 2; 65,536: of 4; 224,256, the cap: of 8, each rank's
# slice filling its block) and a scratch row a block (229,376, past the
# cluster form's cap); each size's markers per cell (fewer at the two
# largest); the markers per cell of the fit check
LARGE_NF = (16384, 32768, 65536, 224256, 229376)
LARGE_MPC = {224256: 16, 229376: 16}
CLUSTER_SHAPE_NF = (32768, 65536, 131072)   # clusters of 2, 4, 8
FIT_MPC = 256
CROSS_STEPS = 30


def large_dt(n):
    """The canonical case's dt scaled with the cell width (2L / npoints):
    a marker crosses as many cells a step as at npoints 1024.  At dt 0.25
    the scheme's grid-scale mode, whose growth rate goes with 1 / cell
    width, carries K3's statistics past float32 within the canonical 180
    steps at npoints 16,384, the sooner the fewer markers a cell (phase 23
    reports the step), and within 40 steps at 4,096 and 16 markers a cell
    in emme_tpu too (tests/test_torch_cuda_pic_cpu.py); at this dt the
    180-step run stays finite.  A step's work does not depend on dt."""
    return PIC_DT * N_TOK / n
LARGE_TIME_LIMIT_S = 300


# native_vs_plain / native_slice: the reference-exact float64 engine (N1).
# N1 against its plain version on every integral of an n=1024 assembly: on
# the card both call the same libdevice functions and N1 is built without
# contraction, so no integral may split differently and the values agree to
# rounding, within NATIVE_BAR of the largest; the solves' bar against the
# engine's goldens: golden tok1024 (5 steps) and
# tests/goldens/stellarator_sequence.json's stel1024 (3 steps).
NATIVE_BAR = 1e-12
NATIVE_SOLVE_BAR = 1e-8
NATIVE_STEL1024 = complex(-1.656555940938338, 2.490320582544963)
NATIVE_STEPS = {"stellarator": 3, "tokamak": 5}
NATIVE_TIME_LIMIT_S = 300
# N1's least time: its operations at the FP64 pipe's instruction rate, 132
# SMs x 64 float64 lanes x the 1.98 GHz boost clock (NVIDIA H100 SXM),
# 16.7e12 a second.  The data sheet's 34 TFLOP/s counts an FMA as two
# operations; cuda_adaptive.flop_count counts each add, multiply, divide
# and libm call of the engine's function once.  The engine's roundings
# forbid fusing any of them but the exact products by 2 of the Miller
# step's running sum (fma(2, y, s): two counted operations, one
# instruction), and the step's two quotients take three instructions each
# where each is counted once, so its instructions stay above its 16
# counted operations and the count at this rate is a least time.
F64_OPS_PER_S = 132 * 64 * 1.98e9
# bytes an integral of N1 must move: its pair row (4 float64) and moment
# read, its value (2 float64), panel count and Miller steps written
N1_BYTES_PER_INTEGRAL = 32 + 4 + 16 + 4 + 8

MESH_ROWS = 4            # the window layout of mesh_window_assembly
MESH_DEADLINE_S = 240    # mesh_slice's spawn: every rank killed past it

# Single-device results the mesh phases stand beside, filled by phases 4,
# 10 and 14.
SINGLE = {}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def emit_build(phase, rec, **fields):
    """One build phase: the library, nvcc's seconds, and the registers and
    spills ptxas reported."""
    emit(phase, library=str(pathlib.Path(rec["path"]).relative_to(REPO)),
         seconds=rec["seconds"],
         ptxas=[ln.strip() for ln in rec["log"].splitlines()
                if "registers" in ln or "spill" in ln], **fields)


def check(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def watchdog(seconds, what):
    """End the process with code 3 unless the returned timer is cancelled
    within ``seconds``: a kernel that hangs fails fast."""
    def stop():
        print(f"chip_smoke: {what} passed its time limit of {seconds} s",
              file=sys.stderr, flush=True)
        os._exit(3)
    t = threading.Timer(seconds, stop)
    t.daemon = True
    t.start()
    return t


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


def compare(p, eta_a, eta_b, omega, ms, quad, bar, torch, cuda_kappa,
            hold_to_f64=False):
    """K1 vs the plain version on one pair set: errors, scale, and core
    times (inputs prepared once; kernel launch vs plain arithmetic).  K1 is
    held to the plain float32 version at ``bar`` max(scale, 1); with
    ``hold_to_f64`` to the plain math in float64 on the same float32 inputs
    instead: within the bar of it, or no further from it than the plain
    float32 version (the less accurate side on the near pairs)."""
    got = cuda_kappa.kappa_pairs_fused(p, eta_a, eta_b, omega, ms=ms, quad=quad)
    ref = cuda_kappa.kappa_pairs_ref(p, eta_a, eta_b, omega, ms=ms, quad=quad)
    args = cuda_kappa._prepare(p, eta_a, eta_b, omega, quad)
    mid, halfw, pair, scal, order = args
    exact = cuda_kappa._finish(p, cuda_kappa._plain(
        mid.double(), halfw.double(), pair.double(), scal.double(), order,
        ms), ms) if hold_to_f64 else ref
    torch.cuda.synchronize()
    errs, scales, vs_f64 = [], [], {}
    for a, b, e in zip(got, ref, exact):
        check(a.is_cuda and bool(torch.isfinite(a).all()),
              "kernel output on the card and finite")
        errs.append(float((a - b).abs().max()))
        scales.append(float(b.abs().max()))
        limit = bar * max(scales[-1], 1.0)
        if hold_to_f64:
            k1_err = float((a - e).abs().max())
            plain_err = float((b - e).abs().max())
            vs_f64 = {"k1_vs_f64": max(k1_err, vs_f64.get("k1_vs_f64", 0.0)),
                      "plain_vs_f64": max(plain_err,
                                          vs_f64.get("plain_vs_f64", 0.0))}
            check(k1_err <= max(limit, plain_err),
                  f"K1 vs float64 {k1_err:.3e} > max({limit:.3e}, plain vs "
                  f"float64 {plain_err:.3e})")
        else:
            check(errs[-1] <= limit, f"kernel vs plain {errs[-1]:.3e} > "
                                     f"{bar} max({scales[-1]:.3e}, 1)")
    k_ms, _ = timed(lambda: cuda_kappa._launch(mid, halfw, pair, scal, order,
                                               ms), torch)
    p_ms, _ = timed(lambda: cuda_kappa._plain(mid, halfw, pair, scal, order,
                                              ms), torch)
    w_ms, _ = timed(lambda: cuda_kappa.kappa_pairs_fused(
        p, eta_a, eta_b, omega, ms=ms, quad=quad), torch)
    nodes = int(eta_a.shape[0]) * int(mid.shape[1]) * order
    asym = k1_asymptotic_share(torch, cuda_kappa, mid, halfw, pair, scal,
                               order, every=16)
    return {"npairs": int(eta_a.shape[0]), "n_panels": int(mid.shape[1]),
            "order": order, "max_abs_err": max(errs), "scale": max(scales),
            "kernel_ms": k_ms, "plain_ms": p_ms, "wrapper_ms": w_ms,
            "nodes": nodes, "asymptotic_share": asym, **vs_f64,
            "flop": nodes * by_branch(K1_FLOP_PER_NODE, asym),
            "bytes": nbytes(mid, halfw, pair, scal)
            + 4 * int(eta_a.shape[0]) * 2 * len(ms)}


def by_branch(table, asym_share, variant=None):
    """Operations of one node or marker-stage: the Taylor path's count and
    the asymptotic path's, weighted by the share on the asymptotic side."""
    t, a = table["taylor"], table["asymptotic"]
    if variant is not None:
        t, a = t[variant], a[variant]
    return t + asym_share * (a - t)


def k1_asymptotic_share(torch, cuda_kappa, mid, halfw, pair, scal, order,
                        every):
    """The share of K1's quadrature nodes whose scaled Bessel functions take
    the asymptotic side, |w|^2 = bi(eta) bi(eta') / |lambda|^2 > 144
    (csrc/kappa.cu), on every ``every``-th pair: the plain version's node,
    rotation and lambda arithmetic."""
    mid, halfw, pair = mid[::every], halfw[::every], pair[::every]
    x = torch.tensor(cuda_kappa._table_views(
        cuda_kappa.kernel_tables(order))["x"][:order], device=mid.device)
    t = torch.clamp_min(mid[:, :, None] + halfw[:, :, None] * x, 1e-6)
    t = t.reshape(mid.shape[0], -1)
    om_r, arc, qR, vt = scal[0], scal[2], scal[3], scal[4]
    de, b1, ba, bb = (pair[:, k:k + 1] for k in range(4))
    omi = -torch.sign(torch.where(om_r == 0, torch.ones_like(om_r), om_r))
    y = t / arc
    rinv = torch.rsqrt(1.0 + y * y)
    c = 0.5 * vt * b1 / (qR * de)
    lam2 = (1.0 + c * t * omi * y * rinv) ** 2 + (c * t * rinv) ** 2
    return float((ba * bb / lam2 > 144.0).float().mean())


def pic_asymptotic_share(torch, cuda_pic, params, arrs):
    """The share of markers whose J0 / J1 take the asymptotic side,
    (v_perp / vt) sqrt(b_theta (1 + (shat eta)^2)) > 8 (csrc/pic.cu)."""
    vt, bt, shat = (float(params[k]) for k in (cuda_pic.P_VT, cuda_pic.P_BT,
                                               cuda_pic.P_SHAT))
    arg = arrs["v_perp"] / vt * torch.sqrt(
        bt * (1.0 + (shat * arrs["eta"]) ** 2))
    return float((arg.abs() > 8.0).float().mean())


def k3_bytes(markers, n_steps, once_bytes):
    """Bytes a K3 run must move.  Where the markers' state (10 float32
    arrays) outgrows the L2 cache it streams through device memory every
    stage: each stage's loads and stores count (K3_BYTES_PER_MARKER_STAGE),
    less the share of the state the L2 could hold from stage to stage.  At
    least each input read once and each output written once
    (``once_bytes``), the whole count where the state fits the L2."""
    per = K3_BYTES_PER_MARKER_STAGE
    staged = markers * (per["0_first"] + (n_steps - 1) * per["0"]
                        + n_steps * (per["1"] + per["2"]))
    state = markers * K3_STATE_BYTES_PER_MARKER
    return max(once_bytes, staged * max(0.0, 1.0 - L2_BYTES / state))


def k3_flop(asym_share, markers, n_steps):
    """Operations of a K3 run: the first stage once, then stage 0, 1, 2."""
    per = {v: by_branch(K3_FLOP_PER_MARKER_STAGE, asym_share, v)
           for v in ("0_first", "0", "1", "2")}
    return markers * (per["0_first"] + (n_steps - 1) * per["0"]
                      + n_steps * (per["1"] + per["2"]))


def event_ms(fn, torch, reps=20):
    """Mean device time in ms of ``fn()`` over ``reps`` back-to-back calls
    after one warm-up, from CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, flops, flop_rate=PEAK_F32_FLOP_PER_S):
    """The least time in ms the card could take: bytes over the memory
    rate or operations over their type's rate (float32 unless
    ``flop_rate`` says otherwise), whichever is larger."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / flop_rate * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes": n_bytes, "bound_flop": flops}


def digest(t):
    """The first 16 hex digits of the SHA-256 of a tensor's bytes."""
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


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
    moved, flops = 0, 0
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
            fm, fld = timed(lambda: cuda_pic._launch_field(partials, qn),
                            torch)
            again = cuda_pic._launch_field(partials, qn)
            check(all(torch.equal(a, b) for a, b in zip(fld, again)),
                  f"K2 stage {s}: the field reduce repeats bit for bit")
            pm, _ = timed(lambda: cuda_pic.stage_ref(*args), torch)
            ins = [*field, qn, *arrs.values(), *(vel_prev or ())]
            asym = pic_asymptotic_share(torch, cuda_pic, fs.params, arrs)
            bnd = bound(nbytes(*ins, *got), int(arrs["eta"].shape[0])
                        * by_branch(K2_FLOP_PER_MARKER_STAGE, asym,
                                    "0_first" if first else str(s)))
            moved += bnd["bound_bytes"]
            flops += bnd["bound_flop"]
            k_ms.append(km)
            f_ms.append(fm)
            p_ms.append(pm)
            emit("pic_stage_vs_plain", stage=s, first=first,
                 markers=int(arrs["eta"].shape[0]), max_abs_err=err,
                 eta_bit_equal=bool(torch.equal(got[2], ref[2])),
                 stage_ms=km, field_ms=fm, plain_ms=pm,
                 partials=list(partials.shape), field_repeat_bit_equal=True,
                 asymptotic_share=asym, **bnd, card=card)
            if s == 1:
                vel_prev = got[:2]
            arrs = dict(arrs, eta=got[2], w_re=got[3], w_im=got[4])
            field = got[5:]
    total = bound(moved, flops)
    return {"max_abs_err": max(errs), "ms": sum(k_ms) + sum(f_ms),
            "plain_ms": sum(p_ms), "bound_ms": total["bound_ms"],
            "bound_by": total["bound_by"], "library_ms": None,
            "stages": len(k_ms),
            "flop_per_unit": flops / (len(k_ms) * int(arrs["eta"].shape[0])),
            "static_flop_per_unit": K2_FLOP_PER_MARKER_STAGE["static"]["1"]}


def pic_phases(torch, build_rec, card):
    """Phases 6-10 (PIC: kernels K2, K3, K4); returns their entries of the
    kernels line."""
    from emme_tpu_torch import from_config
    from emme_tpu_torch.solvers import cuda_pic, pic

    dev = torch.device("cuda")
    f32 = torch.float32

    emit_build("build_pic", build_rec)   # 6. build_pic

    p = from_config(load_cfg("tokamak", 1024), dtype=f32)
    check(p.device.type == "cuda", "from_config lands on the card by default")
    check(p.drift_center_transformation_switch, "canonical case is dc on")
    m = PIC_MPC * p.npoints

    # 7. grid_sync_probe, at K3's launch shape
    grid = cuda_pic.mega_grid(dev, p.npoints, True)
    check(grid["cooperative"], "the device supports cooperative launch")
    check(grid["grid"] == grid["sms"], "K3 fits one block a SM")
    x = torch.rand((grid["grid"], cuda_pic.THREADS), device=dev)
    probe = cuda_pic.grid_sync_probe(x)
    probe_ref = cuda_pic.grid_sync_probe_ref(x)
    torch.cuda.synchronize()
    probe_ok = bool(torch.equal(probe, probe_ref))
    check(probe_ok, "grid-sync probe: every block saw every block's writes")
    probe_ms = event_ms(lambda: cuda_pic.grid_sync_probe(x), torch)
    probe_plain_ms = event_ms(lambda: cuda_pic.grid_sync_probe_ref(x), torch)
    # the same launch without its loads and stores, and one grid barrier
    floor_ms = event_ms(lambda: cuda_pic.grid_sync_probe(x, copy=False),
                        torch)
    one_ms = event_ms(lambda: cuda_pic.grid_sync_probe(
        x, rounds=1, copy=False), torch)
    many_ms = event_ms(lambda: cuda_pic.grid_sync_probe(
        x, rounds=BARRIER_ROUNDS, copy=False), torch, reps=5)
    barrier_us = 1e3 * (many_ms - one_ms) / (BARRIER_ROUNDS - 1)
    probe_bound = bound(nbytes(x, probe), x.numel())
    emit("grid_sync_probe", cooperative_launch=grid["cooperative"],
         **{k: grid[k] for k in ("sms", "grid", "threads", "partials",
                                 "smem", "registers")},
         rounds=cuda_pic.PROBE_ROUNDS, ok=probe_ok, ms=probe_ms,
         plain_ms=probe_plain_ms, no_copy_ms=floor_ms,
         barrier_rounds=[1, BARRIER_ROUNDS], barrier_ms=[one_ms, many_ms],
         us_per_grid_barrier=barrier_us, **probe_bound, card=card)

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
    # K3 again from the same state: eta repeats bit for bit; the rest only
    # to rounding (shared-memory atomics inside a block), so it is reported
    st_again, s_again, _ = cuda_pic.run(p, PIC_MPC, n9, PIC_DT, state=s0,
                                        launch="single")
    check(torch.equal(s_again.eta, s_k3.eta), "K3 twice: eta bit-equal")
    repeat = {"eta": True, "stats": bool(torch.equal(st_again, st_k3)),
              **{name: bool(torch.equal(getattr(s_again, name),
                                        getattr(s_k3, name)))
                 for name in ("weight", "field")}}
    for name, bar in PIC_BARS.items():
        err = rel_err(getattr(s_again, name), getattr(s_k3, name))
        check(err < bar, f"K3 twice {name} {err:.3e} < {bar}")
    check(cuda_pic.LAST_MEGA_GRID == grid,
          f"K3 ran at the probed launch shape: {cuda_pic.LAST_MEGA_GRID}")
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
         eta_bit_equal=True, repeat_bit_equal=repeat,
         partials=grid["partials"],
         state_rel_err=state_errs,
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
    SINGLE["pic_plain_seconds"] = plain_s
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

    # 10b. pic_breakdown: K3's stage at the canonical size, part by part
    n_stages = 3 * PIC_STEPS
    part_us = {}
    for name, parts in (("all", 3), ("no_reduce", 1), ("no_markers", 2),
                        ("neither", 0)):
        ms_, _ = timed(lambda: cuda_pic._launch_mega(
            True, fs.params, *field_c, qn, arrs_c, PIC_STEPS, parts=parts),
            torch)
        part_us[name] = 1e3 * ms_ / n_stages
    asym_c = pic_asymptotic_share(torch, cuda_pic, fs.params, arrs_c)
    k3_run_bound = bound(
        k3_bytes(m, PIC_STEPS, nbytes(
            *field_c, qn, *arrs_c.values(), arrs_c["eta"], arrs_c["w_re"],
            arrs_c["w_im"], *field_c, stats)),
        k3_flop(asym_c, m, PIC_STEPS))
    emit("pic_breakdown", case="canonical run, K3", stages=n_stages,
         us_per_stage=part_us["all"],
         marker_pass_us=part_us["all"] - part_us["no_markers"],
         field_reduce_us=part_us["all"] - part_us["no_reduce"],
         two_grid_barriers_us=2 * barrier_us,
         rest_us=part_us["neither"] - 2 * barrier_us,
         parts_us=part_us, launch_shape=grid,
         markers_per_thread=m / (grid["grid"] * grid["threads"]),
         asymptotic_share=asym_c,
         flop_per_marker_stage=k3_run_bound["bound_flop"] / (m * n_stages),
         static_flop_per_marker_stage=K3_FLOP_PER_MARKER_STAGE["static"],
         k3_ms=k3_run_ms, **k3_run_bound,
         share_of_bound=k3_run_bound["bound_ms"] / k3_run_ms, card=card)

    k3_bound = bound(
        k3_bytes(m, n9, nbytes(*field0, qn, *arrs0.values(),
                               *(t for t, _ in k3_vs_plain))),
        k3_flop(pic_asymptotic_share(torch, cuda_pic, fs.params, arrs0), m,
                n9))
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
         "bound_ms": k3_bound["bound_ms"], "bound_by": k3_bound["bound_by"],
         "library_ms": None, "steps": n9,
         "flop_per_unit": k3_bound["bound_flop"] / (m * 3 * n9),
         "static_flop_per_unit": K3_FLOP_PER_MARKER_STAGE["static"]["1"],
         "canonical_run_ms": k3_run_ms,
         "canonical_run_bound_ms": k3_run_bound["bound_ms"]},
        {"name": "grid_sync_probe", "route": "cuda", "source": src,
         "replaces": f"{rep}:621", "launches": launches["grid_sync_probe"],
         "launches_from": "cuda_pic.run(launch='auto'), canonical run",
         "max_abs_err": float((probe - probe_ref).abs().max()),
         "ms": probe_ms, "plain_ms": probe_plain_ms,
         "bound_ms": probe_bound["bound_ms"],
         "bound_by": probe_bound["bound_by"], "library_ms": None,
         "no_copy_ms": floor_ms},
    ]


def k3_vs_plain(torch, cuda_pic, fs, qn, arrs, field, n_steps, what):
    """K3 against mega_ref over ``n_steps`` from one state at the bars of
    phase 9 (stats 1e-5, weights and field 2e-5 of scale, eta within 1
    ulp), and K3 twice: eta bit-equal.  Returns (K3's result, max abs
    error, K3 ms, plain ms)."""
    got = cuda_pic.mega(True, fs.params, *field, qn, arrs, n_steps)
    again = cuda_pic.mega(True, fs.params, *field, qn, arrs, n_steps)
    ref = cuda_pic.mega_ref(True, fs.params, *field, qn, arrs, n_steps)
    torch.cuda.synchronize()
    check(got[5].shape == (n_steps, 3) and got[5].is_cuda
          and all(bool(torch.isfinite(t).all()) for t in got),
          f"{what}: K3 finite on the card")
    check(rel_err(got[5], ref[5]) < STATS_BAR,
          f"{what}: K3 vs plain stats {rel_err(got[5], ref[5]):.3e} < "
          f"{STATS_BAR}")
    for a, b in zip(got[1:5], ref[1:5]):
        check(rel_err(a, b) < STAGE_BAR,
              f"{what}: K3 vs plain {rel_err(a, b):.3e} < {STAGE_BAR}")
    check(within_ulp(got[0], ref[0], torch),
          f"{what}: K3 eta within 1 ulp of plain")
    check(torch.equal(got[0], again[0]), f"{what}: K3 twice, eta bit-equal")
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    k_ms, _ = timed(lambda: cuda_pic.mega(True, fs.params, *field, qn, arrs,
                                          n_steps), torch)
    p_ms, _ = timed(lambda: cuda_pic.mega_ref(True, fs.params, *field, qn,
                                              arrs, n_steps), torch,
                    repeats=1)
    return got, err, k_ms, p_ms


def canonical_dt_run(torch, cuda_pic, p, qn, arrs, field):
    """K3 over the canonical run's 180 steps at its dt 0.25 from the given
    markers: the first step whose statistics leave float32 (180 when none
    does) and the rms growth over the finite steps."""
    stats = cuda_pic.mega(True, cuda_pic.FusedStep.params_vec(p, PIC_DT),
                          *field, qn, arrs, PIC_STEPS)[5]
    bad = ~torch.isfinite(stats).all(dim=1).cpu()
    first = int(bad.nonzero()[0, 0]) if bool(bad.any()) else PIC_STEPS
    return {"first_non_finite_step": first,
            "rms_growth": float(stats[max(first - 1, 0), 2] / stats[0, 2])}


def pic_large_grid_phase(torch, card):
    """Phase 23 (pic_large_grid): K2 and K3 past the small-grid form, at
    the canonical case's settings but npoints 16,384 (16,777,216 markers;
    the histogram in one block's shared memory, the field from device
    memory), then
    each size of LARGE_NF past it (large_grid_size: the cluster form and
    the scratch-row form).  Returns the K2 and K3 entries' large grid
    fields and their launches on the run entry point."""
    from emme_tpu_torch import from_config
    from emme_tpu_torch.solvers import cuda_pic, pic

    limit = watchdog(LARGE_TIME_LIMIT_S, "phase pic_large_grid")
    dev = torch.device("cuda")
    f32 = torch.float32
    n = LARGE_NF[0]
    dt = large_dt(n)
    p = from_config(load_cfg("tokamak", n), dtype=f32)
    m = PIC_MPC * n
    s0 = pic.init_state(p, PIC_MPC, torch.Generator(device=dev).manual_seed(0),
                        dtype=f32)
    fs = cuda_pic.FusedStep(p, m, dt)
    qn = pic.quasi_neutrality_coef(p, dtype=f32)
    arrs0 = cuda_pic.state_to_arrs(s0)
    field0 = (s0.field.real.contiguous(), s0.field.imag.contiguous())
    shape = cuda_pic.mega_grid(dev, n, True)
    check(shape["form"] == cuda_pic.FORM_CLUSTER and shape["cluster"] == 1
          and shape["grid"] == shape["sms"],
          f"npoints {n}: the cluster form with one block a cluster, one block "
          f"a SM: {shape}")
    n9 = 8

    # K3 against mega_ref over 8 steps
    k3_got, k3_err, k3_ms, k3_plain_ms = k3_vs_plain(
        torch, cuda_pic, fs, qn, arrs0, field0, n9, f"npoints {n}")
    check(cuda_pic.LAST_MEGA_GRID == shape, "K3 ran at its launch shape")
    asym = pic_asymptotic_share(torch, cuda_pic, fs.params, arrs0)
    k3_bound = bound(k3_bytes(m, n9, nbytes(*field0, qn, *arrs0.values(),
                                            *k3_got)),
                     k3_flop(asym, m, n9))
    deposit = deposit_share(torch, cuda_pic, fs, qn, arrs0, field0, n9,
                            k3_ms)

    # K2: one stage against stage_ref, after one plain step
    eta, wre, wim, fr, fi, _ = cuda_pic.mega_ref(True, fs.params, *field0, qn,
                                                 arrs0, 1)
    arrs1 = dict(arrs0, eta=eta, w_re=wre, w_im=wim)
    args = (1, False, True, fs.params, fr, fi, qn, arrs1)
    got = cuda_pic.stage(*args)
    ref = cuda_pic.stage_ref(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        check(a.is_cuda and bool(torch.isfinite(a).all())
              and rel_err(a, b) < STAGE_BAR,
              f"npoints {n}: K2 stage 1 vs plain {rel_err(a, b):.3e} < "
              f"{STAGE_BAR}")
    check(within_ulp(got[2], ref[2], torch), "K2 eta within 1 ulp of plain")
    k2_err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    k2_ms, _ = timed(lambda: cuda_pic.stage(*args), torch)
    k2_plain_ms, _ = timed(lambda: cuda_pic.stage_ref(*args), torch)
    k2_bound = bound(nbytes(fr, fi, qn, *arrs1.values(), *got),
                     m * by_branch(K2_FLOP_PER_MARKER_STAGE, pic_asymptotic_share(
                         torch, cuda_pic, fs.params, arrs1), "1"))
    del arrs1, got, ref, eta, wre, wim, fr, fi

    # K2 through the run entry point, 8 steps, counted: eta bit-equal to K3
    for k in cuda_pic.LAUNCHES:
        cuda_pic.LAUNCHES[k] = 0
    _, s_k2, _ = cuda_pic.run(p, PIC_MPC, n9, dt, state=s0,
                              launch="stages")
    torch.cuda.synchronize()
    k2_launches = dict(cuda_pic.LAUNCHES)
    check(k2_launches["pic_stage"] == 3 * n9 == k2_launches["pic_field"],
          f"npoints {n}, launch='stages': K2 3 x {n9} times: {k2_launches}")
    check(torch.equal(s_k2.eta, k3_got[0]), f"npoints {n}: K3 and K2 eta "
                                            "bit-equal")
    del s_k2, k3_got

    # the 180-step run through cuda_pic.run (launch 'auto'), counted, and
    # K3 alone over it: median of 3 after a warm-up
    def run():
        gen = torch.Generator(device=dev).manual_seed(1)
        return cuda_pic.run(p, PIC_MPC, PIC_STEPS, dt, generator=gen)

    run()
    cuda_pic._SELFCHECK.clear()
    for k in cuda_pic.LAUNCHES:
        cuda_pic.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats, s_end, _ = run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    run_launches = dict(cuda_pic.LAUNCHES)
    check(cuda_pic.LAST_LAUNCH == "single" and run_launches["pic_mega"] == 1
          and run_launches["grid_sync_probe"] >= 1,
          f"npoints {n}: the run took K3 once, after K4: {run_launches}")
    # the grid-scale mode still grows fast at this grid (large_dt): the
    # run's statistics must stay finite over all its steps
    finite = torch.isfinite(stats).all(dim=1).cpu()
    first_bad = int((~finite).nonzero()[0, 0]) if not bool(finite.all()) \
        else PIC_STEPS
    check(first_bad == PIC_STEPS, f"npoints {n}: the run's statistics are "
                                  f"finite (first non-finite step {first_bad})")
    growth = float(stats[-1, 2] / stats[0, 2])
    del s_end
    # the same markers at the canonical dt 0.25 (reported, not checked)
    canon_dt = canonical_dt_run(torch, cuda_pic, p, qn, arrs0, field0)
    s1 = pic.init_state(p, PIC_MPC, torch.Generator(device=dev).manual_seed(1),
                        dtype=f32)
    arrs_r = cuda_pic.state_to_arrs(s1)
    field_r = (s1.field.real.contiguous(), s1.field.imag.contiguous())
    del s1
    run_ms, run_out = timed(lambda: cuda_pic.mega(
        True, fs.params, *field_r, qn, arrs_r, PIC_STEPS), torch)
    run_bound = bound(k3_bytes(m, PIC_STEPS, nbytes(
        *field_r, qn, *arrs_r.values(), *run_out)),
                      k3_flop(pic_asymptotic_share(torch, cuda_pic, fs.params,
                                                   arrs_r), m, PIC_STEPS))
    del arrs_r, field_r, run_out, arrs0, field0, s0

    # K3 against the plain run (pic.run) from one state at 256 markers per
    # cell: per-step statistics within 1 % (no fit: the series is the
    # grid-scale mode's growth, not the canonical mode's oscillation)
    s_fit = pic.init_state(p, FIT_MPC, torch.Generator(device=dev).manual_seed(1),
                           dtype=f32)
    fit_canon_dt = canonical_dt_run(torch, cuda_pic, p, qn,
                                    cuda_pic.state_to_arrs(s_fit),
                                    (s_fit.field.real.contiguous(),
                                     s_fit.field.imag.contiguous()))
    for k in cuda_pic.LAUNCHES:
        cuda_pic.LAUNCHES[k] = 0
    st_fit, _, _ = cuda_pic.run(p, FIT_MPC, CROSS_STEPS, dt, state=s_fit)
    torch.cuda.synchronize()
    fit_launches = dict(cuda_pic.LAUNCHES)
    check(cuda_pic.LAST_LAUNCH == "single" and fit_launches["pic_mega"] == 1,
          f"the cross-check run took K3: {fit_launches}")
    t0 = time.perf_counter()
    st_plain, _, _ = pic.run(p, FIT_MPC, CROSS_STEPS, dt, state=s_fit)
    torch.cuda.synchronize()
    plain_run_s = time.perf_counter() - t0
    both = (torch.isfinite(st_fit).all(dim=1)
            & torch.isfinite(st_plain).all(dim=1)).cpu()
    n_both = int(both.cumprod(0).sum())
    step_diff = float(((st_fit - st_plain).norm(dim=1)
                       / st_plain.norm(dim=1))[:n_both].max())
    check(n_both == CROSS_STEPS and step_diff < 0.01,
          f"npoints {n} x {FIT_MPC}: K3 and the plain run agree to 1 % a "
          f"step over {n_both} finite steps: {step_diff:.3e}")
    del s_fit, st_plain, st_fit

    # the sizes past 16,384: the cluster form and the scratch-row form
    sizes = [large_grid_size(torch, cuda_pic, pic, from_config, dev, nb,
                             LARGE_MPC.get(nb, PIC_MPC), n9, card)
             for nb in LARGE_NF[1:]]
    torch.cuda.empty_cache()
    # K3's launch shape for each cluster size: whole clusters on a GPC
    cluster_shapes = []
    for nb in CLUSTER_SHAPE_NF:
        sh = cuda_pic.mega_grid(dev, nb, True)
        check(sh["cluster"] == cuda_pic.cluster_size(nb) > 1
              and sh["grid"] == sh["cluster"] * sh["clusters"] > 0,
              f"npoints {nb}: clusters of {sh['cluster']}: {sh}")
        cluster_shapes.append({k: sh[k] for k in ("cluster", "clusters",
                                                  "grid", "sms")})

    emit("pic_large_grid", case=f"tokamak npoints {n} x {PIC_MPC} markers/cell, "
         f"dt {dt}, f32, drift-center; and npoints "
         f"{', '.join(str(z['npoints']) for z in sizes)}", markers=m, dt=dt,
         launch_shape=shape,
         k3_vs_plain_max_abs_err=k3_err, k3_ms=k3_ms, k3_plain_ms=k3_plain_ms,
         k3_bound_ms=k3_bound["bound_ms"], k3_bound_by=k3_bound["bound_by"],
         k3_share_of_bound=k3_bound["bound_ms"] / k3_ms, deposit=deposit,
         k2_vs_plain_max_abs_err=k2_err,
         k2_stage_ms=k2_ms, k2_plain_ms=k2_plain_ms,
         k2_bound_ms=k2_bound["bound_ms"], k2_launches=k2_launches,
         run={"steps": PIC_STEPS, "seconds": run_s, "launches": run_launches,
              "first_non_finite_step": first_bad, "rms_growth": growth,
              "at_dt_0.25": canon_dt,
              "k3_ms": run_ms,
              "bound_ms": run_bound["bound_ms"],
              "bound_by": run_bound["bound_by"],
              "share_of_bound": run_bound["bound_ms"] / run_ms},
         cross_check={"markers_per_cell": FIT_MPC, "steps": CROSS_STEPS,
                      "at_dt_0.25": fit_canon_dt,
                      "finite_steps": n_both, "max_step_stats_rel_diff":
                      step_diff, "plain_seconds": plain_run_s,
                      "launches": fit_launches},
         sizes=[{k: v for k, v in z.items() if k != "launches"}
                for z in sizes], cluster_shapes=cluster_shapes, card=card)
    limit.cancel()
    k2 = {"large_grid_npoints": n, "large_grid_ms": k2_ms,
          "large_grid_plain_ms": k2_plain_ms,
          "large_grid_bound_ms": k2_bound["bound_ms"],
          "large_grid_bound_by": k2_bound["bound_by"],
          "large_grid_share": k2_bound["bound_ms"] / k2_ms,
          "large_grid_max_abs_err": max([k2_err] + [z["k2_max_abs_err"]
                                                    for z in sizes]),
          "large_grid_sizes": [{
              "npoints": z["npoints"], "form": z["form"],
              "cluster": z["cluster"], "ms": z["k2_stage_ms"],
              "plain_ms": z["k2_plain_ms"], "bound_ms": z["k2_bound_ms"],
              "bound_by": z["k2_bound_by"],
              "share": z["k2_bound_ms"] / z["k2_stage_ms"]} for z in sizes]}
    k3 = {"large_grid_npoints": n, "large_grid_ms": k3_ms,
          "large_grid_plain_ms": k3_plain_ms,
          "large_grid_bound_ms": k3_bound["bound_ms"],
          "large_grid_bound_by": k3_bound["bound_by"],
          "large_grid_share": k3_bound["bound_ms"] / k3_ms,
          "large_grid_max_abs_err": max([k3_err] + [z["k3_max_abs_err"]
                                                    for z in sizes]),
          "large_grid_run_ms": run_ms,
          "large_grid_run_bound_ms": run_bound["bound_ms"],
          "large_grid_run_share": run_bound["bound_ms"] / run_ms,
          "large_grid_sizes": [{
              "npoints": z["npoints"], "form": z["form"],
              "cluster": z["cluster"], "clusters": z["clusters"],
              "ms": z["k3_ms"], "plain_ms": z["k3_plain_ms"],
              "bound_ms": z["bound_ms"], "bound_by": z["bound_by"],
              "share": z["share_of_bound"],
              "deposit_share": z["deposit"]["share"]} for z in sizes]}
    launches = {"pic_stage": k2_launches["pic_stage"],
                "pic_field": k2_launches["pic_field"],
                "pic_mega": run_launches["pic_mega"] + fit_launches["pic_mega"],
                "grid_sync_probe": run_launches["grid_sync_probe"]
                + fit_launches["grid_sync_probe"]}
    for z in sizes:
        for k, v in z["launches"].items():
            launches[k] += v
    return k2, k3, launches


def deposit_share(torch, cuda_pic, fs, qn, arrs, field, n_steps, k3_ms):
    """K3 over ``n_steps`` with the marker pass's deposit left out
    (csrc/pic.cu kPartNoDeposit): its ms, and the deposit's share of the
    run's ``k3_ms`` by difference (its adds, not the barriers and the
    partials around them, which both runs keep)."""
    ms, _ = timed(lambda: cuda_pic._launch_mega(
        True, fs.params, *field, qn, arrs, n_steps,
        parts=3 | cuda_pic.PART_NO_DEPOSIT), torch)
    return {"no_deposit_ms": ms, "share": 1.0 - ms / k3_ms}


def large_grid_size(torch, cuda_pic, pic, from_config, dev, n, mpc, n_steps,
                    card):
    """One size of phase 23 past 16,384: the launch shape (the form, the
    cluster size, the co-resident clusters and the SMs they cover), K4 at
    that shape against its plain version, K3 against mega_ref over
    ``n_steps`` and twice (eta bit-equal), the deposit's share of K3's
    time, K2's stage 1 against stage_ref, and the run entry point, counted:
    launch 'auto' (the self-check's K4, then K3 once) and 'stages' (K2), eta
    bit-equal with K3.  Emits one pic_large_grid_size line; returns its
    fields and the launches."""
    f32 = torch.float32
    what = f"npoints {n}"
    p = from_config(load_cfg("tokamak", n), dtype=f32)
    m = mpc * n
    dt = large_dt(n)
    s0 = pic.init_state(p, mpc, torch.Generator(device=dev).manual_seed(0),
                        dtype=f32)
    fs = cuda_pic.FusedStep(p, m, dt)
    qn = pic.quasi_neutrality_coef(p, dtype=f32)
    arrs = cuda_pic.state_to_arrs(s0)
    field = (s0.field.real.contiguous(), s0.field.imag.contiguous())
    shape = cuda_pic.mega_grid(dev, n, True)
    form, cs = cuda_pic.form(n), cuda_pic.cluster_size(n)
    check(shape["form"] == form and shape["cluster"] == cs
          and shape["grid"] == shape["clusters"] * cs
          and shape["partials"] == shape["clusters"]
          and 0 < shape["grid"] <= shape["sms"]
          and (cs > 1 or shape["grid"] == shape["sms"]),
          f"{what}: form {form}, clusters of {cs}, the co-resident clusters "
          f"times their size: {shape}")

    # K4 at K3's launch shape, clusters included
    x = torch.rand((shape["grid"], cuda_pic.THREADS), device=dev)
    probe = cuda_pic.grid_sync_probe(x, cluster=cs)
    torch.cuda.synchronize()
    check(torch.equal(probe, cuda_pic.grid_sync_probe_ref(x)),
          f"{what}: K4 at K3's shape ({shape['grid']} blocks in clusters of "
          f"{cs}): every block saw every block's writes")
    del x, probe

    # K3 against mega_ref, the deposit's share
    got, k3_err, k3_ms, k3_plain_ms = k3_vs_plain(
        torch, cuda_pic, fs, qn, arrs, field, n_steps, what)
    check(cuda_pic.LAST_MEGA_GRID == shape, f"{what}: K3 ran at its shape")
    k3_eta = got[0]
    k3_bnd = bound(k3_bytes(m, n_steps, nbytes(*field, qn, *arrs.values(),
                                               *got)),
                   k3_flop(pic_asymptotic_share(torch, cuda_pic, fs.params,
                                                arrs), m, n_steps))
    del got
    deposit = deposit_share(torch, cuda_pic, fs, qn, arrs, field, n_steps,
                            k3_ms)

    # K2: stage 1 against stage_ref, after one plain step
    eta, wre, wim, fr, fi, _ = cuda_pic.mega_ref(True, fs.params, *field, qn,
                                                 arrs, 1)
    arrs1 = dict(arrs, eta=eta, w_re=wre, w_im=wim)
    args = (1, False, True, fs.params, fr, fi, qn, arrs1)
    k2_got = cuda_pic.stage(*args)
    k2_ref = cuda_pic.stage_ref(*args)
    torch.cuda.synchronize()
    for a, b in zip(k2_got, k2_ref):
        check(a.is_cuda and bool(torch.isfinite(a).all())
              and rel_err(a, b) < STAGE_BAR,
              f"{what}: K2 stage 1 vs plain {rel_err(a, b):.3e} < "
              f"{STAGE_BAR}")
    check(within_ulp(k2_got[2], k2_ref[2], torch),
          f"{what}: K2 eta within 1 ulp of plain")
    k2_err = max(float((a - b).abs().max()) for a, b in zip(k2_got, k2_ref))
    k2_ms, _ = timed(lambda: cuda_pic.stage(*args), torch)
    k2_plain_ms, _ = timed(lambda: cuda_pic.stage_ref(*args), torch)
    asym1 = pic_asymptotic_share(torch, cuda_pic, fs.params, arrs1)
    k2_bnd = bound(nbytes(fr, fi, qn, *arrs1.values(), *k2_got),
                   m * by_branch(K2_FLOP_PER_MARKER_STAGE, asym1, "1"))
    del arrs1, k2_got, k2_ref, eta, wre, wim, fr, fi

    # the run entry point, counted: K4's self-check and K3 once, then K2
    launches = {}
    runs = {}
    for path in ("auto", "stages"):
        cuda_pic._SELFCHECK.clear()
        for k in cuda_pic.LAUNCHES:
            cuda_pic.LAUNCHES[k] = 0
        _, s_run, _ = cuda_pic.run(p, mpc, n_steps, dt, state=s0, launch=path)
        torch.cuda.synchronize()
        runs[path] = dict(cuda_pic.LAUNCHES)
        check(torch.equal(s_run.eta, k3_eta),
              f"{what}, launch={path!r}: eta bit-equal to K3's")
        del s_run
        for k, v in runs[path].items():
            launches[k] = launches.get(k, 0) + v
    check(runs["auto"]["pic_mega"] == 1
          and runs["auto"]["grid_sync_probe"] >= 1
          and runs["stages"]["pic_stage"] == 3 * n_steps
          == runs["stages"]["pic_field"],
          f"{what}: the run took K4 and K3 once, launch='stages' K2 3 x "
          f"{n_steps} times: {runs}")
    out = {"npoints": n, "markers_per_cell": mpc, "markers": m, "dt": dt,
           "steps": n_steps, "form": form, "cluster": cs,
           "clusters": shape["clusters"], "sms_covered": shape["grid"],
           "sms": shape["sms"], "registers": shape["registers"],
           "smem": shape["smem"], "partials": shape["partials"],
           "k3_max_abs_err": k3_err, "k3_ms": k3_ms,
           "k3_plain_ms": k3_plain_ms, **k3_bnd,
           "share_of_bound": k3_bnd["bound_ms"] / k3_ms, "deposit": deposit,
           "k2_max_abs_err": k2_err, "k2_stage_ms": k2_ms,
           "k2_plain_ms": k2_plain_ms, "k2_bound_ms": k2_bnd["bound_ms"],
           "k2_bound_by": k2_bnd["bound_by"], "run_launches": runs}
    emit("pic_large_grid_size", **out, card=card)
    out["launches"] = launches
    return out


def compare_f64(p, eta_a, eta_b, omega, quad, torch, cuda_kappa):
    """K1 and its plain version on one pair set, each against the plain
    math in float64 on the same float32 inputs (panel rows, pair rows,
    scalars).  At tok8192 the float32 plain version itself sits 1-3e-6
    from that evaluation, so K1 is held to the phase-3 bar against the
    float64 values, or to no worse than the plain version."""
    args = cuda_kappa._prepare(p, eta_a, eta_b, omega, quad)
    mid, halfw, pair, scal, order = args
    k1 = cuda_kappa._finish(p, cuda_kappa._launch(*args, (0,)), (0,))[0]
    plain = cuda_kappa._finish(p, cuda_kappa._plain(*args, (0,)), (0,))[0]
    exact = cuda_kappa._finish(p, cuda_kappa._plain(
        mid.double(), halfw.double(), pair.double(), scal.double(), order,
        (0,)), (0,))[0]
    torch.cuda.synchronize()
    check(k1.is_cuda and bool(torch.isfinite(k1).all()),
          "kernel output on the card and finite")
    scale = float(exact.abs().max())
    k1_err = float((k1 - exact).abs().max())
    plain_err = float((plain - exact).abs().max())
    bar = max(ES_BAR * max(scale, 1.0), plain_err)
    check(k1_err <= bar, f"K1 vs float64 {k1_err:.3e} > {bar:.3e}")
    k_ms = event_ms(lambda: cuda_kappa._launch(*args, (0,)), torch, reps=3)
    p_ms, _ = timed(lambda: cuda_kappa._plain(*args, (0,)), torch, repeats=1)
    return {"npairs": int(eta_a.shape[0]), "n_panels": int(mid.shape[1]),
            "max_abs_err": float((k1 - plain).abs().max()),
            "k1_vs_f64": k1_err, "plain_vs_f64": plain_err, "scale": scale,
            "kernel_ms": k_ms, "plain_ms": p_ms}


def library_spmv_ms(torch, bsr, x, ref, tol):
    """The time of PyTorch's own sparse BSR product on the same operator
    and x (one library call, used nowhere in the port)."""
    lib = torch.sparse_bsr_tensor(bsr.row_ptr.to(torch.int64),
                                  bsr.col_idx.to(torch.int64), bsr.data,
                                  size=(bsr.n, bsr.n), check_invariants=False)
    cols = x if x.dim() == 2 else x[:, None]
    out = lib @ cols
    torch.cuda.synchronize()
    check(float((out.reshape(ref.shape) - ref).abs().max()) <= tol,
          "the library's BSR product agrees with the plain version")
    return event_ms(lambda: lib @ cols, torch)


def spmv_compare(torch, sparse, cuda_spmv, op, x, bar):
    """K5 vs its plain version (and bdia_matvec) on one operator and x:
    error, scale and device times."""
    bsr = sparse.bdia_to_bsr(op)
    got = cuda_spmv.bsr_matvec(bsr, x)
    again = cuda_spmv.bsr_matvec(bsr, x)
    ref = sparse.bsr_matvec_ref(bsr, x)
    via_bdia = sparse.bdia_matvec(op, x)
    torch.cuda.synchronize()
    check(got.is_cuda and bool(torch.isfinite(got).all()),
          "K5 output on the card and finite")
    check(torch.equal(got, again), "K5 twice: bit-equal")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    check(err <= bar * scale, f"K5 vs plain {err:.3e} > {bar} x {scale:.3e}")
    check(float((via_bdia - ref).abs().max()) <= bar * scale,
          "bdia_matvec agrees with the plain BSR product")
    k_ms = event_ms(lambda: cuda_spmv.bsr_matvec(bsr, x), torch)
    p_ms = event_ms(lambda: sparse.bsr_matvec_ref(bsr, x), torch)
    d_ms = event_ms(lambda: sparse.bdia_matvec(op, x), torch)
    stored = nbytes(bsr.data)
    r = 1 if x.dim() == 1 else int(x.shape[1])
    # a complex multiply-add is 8 real operations
    bnd = bound(nbytes(bsr.data, bsr.col_idx, bsr.row_ptr, x, got),
                8 * bsr.data.numel() * r)
    return {"r": r, **bnd, "library_ms": library_spmv_ms(torch, bsr, x, ref,
                                                         bar * scale),
            "dtype": str(op.data.dtype).removeprefix("torch."),
            "nnzb": bsr.nnzb, "block": bsr.block, "max_abs_err": err,
            "scale": scale, "kernel_ms": k_ms, "plain_ms": p_ms,
            "bdia_ms": d_ms, "kernel_gb_per_s": stored / k_ms / 1e6,
            "share_of_bound": bnd["bound_ms"] / k_ms,
            "speedup_vs_plain": p_ms / k_ms, "repeat_bit_equal": True}


def tpu_precision_solve(torch, banded, solve):
    """``solve()`` with every matmul of the banded linear algebra (LU,
    selected inverse, solves) fed bf16-rounded complex64 operands and
    accumulated in float32: one bf16 pass, a TPU's default matmul precision
    for float32, which the JAX package's banded TPU runs used."""
    from torch.overrides import TorchFunctionMode

    def bf16(t):
        if not isinstance(t, torch.Tensor):
            return t
        return torch.complex(t.real.bfloat16().float(),
                             t.imag.bfloat16().float())

    matmuls = {torch.matmul, torch.Tensor.__matmul__, torch.Tensor.matmul,
               torch.Tensor.__rmatmul__}

    class Bf16Matmul(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in matmuls:
                args = tuple(bf16(a) for a in args)
            return func(*args, **(kwargs or {}))

    def rounded(f):
        def call(*args, **kwargs):
            with Bf16Matmul():
                return f(*args, **kwargs)
        return call

    exact = {name: getattr(banded, name) for name in
             ("banded_lu", "banded_selected_inverse", "banded_solve")}
    try:
        for name, f in exact.items():
            setattr(banded, name, rounded(f))
        return solve()
    finally:
        for name, f in exact.items():
            setattr(banded, name, f)


def banded_phases(torch, build_rec, card):
    """Phases 11-17 (the banded slice: K5, and K1 again); returns K5's
    entry of the kernels line and K1's banded numbers."""
    from emme_tpu_torch import from_config
    from emme_tpu_torch.grid import Grid
    from emme_tpu_torch.ops import banded, cuda_kappa, cuda_spmv
    from emme_tpu_torch.ops import sparse
    from emme_tpu_torch.ops.singularity import (singularity_coeff_band,
                                                singularity_coeff_matrix)
    from emme_tpu_torch.solvers import eigen, sparse_eigen as se

    dev = torch.device("cuda")
    f32 = torch.float32

    emit_build("build_spmv", build_rec, card=card)   # 11. build_spmv

    # the tok8192 operator of the slice, at the seed
    p = from_config(load_cfg("tokamak", N_BAND), dtype=f32)
    check(p.device.type == "cuda", "from_config lands on the card by default")
    grid = Grid.create(p.length, N_BAND, dtype=f32)
    check(grid.eta.is_cuda, "Grid.create lands on the card by default")
    bs = se.pick_block(N_BAND)
    h = se.band_halfwidth(p, grid, bs, BAND_KW["band_deta"])
    de_max = (h + 1) * bs - 1
    cband = singularity_coeff_band(N_BAND, de_max, dtype=f32)
    tiers = eigen.discretization(p, f32)[0]
    seed = torch.tensor(BAND_GUESS, dtype=torch.complex64, device=dev)
    op = se.assemble_bdia(p, grid, cband, seed, h, bs, tiers=tiers,
                          fused=True)

    # 12. spmv_vs_plain
    limit = watchdog(K5_TIME_LIMIT_S, "phase spmv_vs_plain")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for r in (1, 8, 16, 32):
        shape = (N_BAND,) if r == 1 else (N_BAND, r)
        x = torch.randn(shape, dtype=torch.complex64, device=dev,
                        generator=gen)
        rows.append(spmv_compare(torch, sparse, cuda_spmv, op, x,
                                 SPMV_BARS["complex64"]))
        emit("spmv_vs_plain", case=f"tok{N_BAND} band_deta 10", **rows[-1],
             card=card)
    p1 = from_config(load_cfg("tokamak", N_TOK), dtype=f32)
    g1 = Grid.create(p1.length, N_TOK, dtype=f32)
    h1 = se.band_halfwidth(p1, g1, 128, se.DEFAULT_BAND_DETA)
    op1 = se.assemble_bdia(
        p1, g1, singularity_coeff_band(N_TOK, (h1 + 1) * 128 - 1, dtype=f32),
        torch.tensor(GUESS, dtype=torch.complex64, device=dev), h1, 128,
        tiers=eigen.discretization(p1, f32)[0], fused=True)
    op1 = sparse.BDIAOperator(data=op1.data.to(torch.complex128),
                              offsets=op1.offsets, n=op1.n, block=op1.block)
    for r in (1, 16):
        shape = (N_TOK,) if r == 1 else (N_TOK, r)
        x = torch.randn(shape, dtype=torch.complex128, device=dev,
                        generator=gen)
        rows.append(spmv_compare(torch, sparse, cuda_spmv, op1, x,
                                 SPMV_BARS["complex128"]))
        emit("spmv_vs_plain", case=f"tok{N_TOK} band_deta 20", **rows[-1],
             card=card)
    del op1
    limit.cancel()

    # 13. banded_kernel_vs_plain: the first pairs of each tier section
    k1_rows = []
    for t, (lo, hi, q) in enumerate(se.table_sections(None, f32, de_max,
                                                      tiers)):
        npairs = min(K1_CHECK_PAIRS, (hi - lo + 1) * N_BAND)
        ea, eb = se.table_pairs(grid, lo, 0, npairs)
        r = compare_f64(p, ea, eb, seed, q, torch, cuda_kappa)
        k1_rows.append(r)
        emit("banded_kernel_vs_plain", case=f"tok{N_BAND}", section=t,
             de=[lo, hi], **r, card=card)

    # 14. banded_slice: the main path, twice; the second timed and counted
    def solve(stats):
        return se.solve(p, BAND_GUESS, stats=stats, **BAND_KW)

    del op
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve({})
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    cuda_kappa.LAUNCHES = 0
    cuda_spmv.LAUNCHES = 0
    eigen.HOST_READS.update(blocking=0, flag_polls=0)
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    om, vec, n_steps, state = solve(stats)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    k1_launches, k5_launches = cuda_kappa.LAUNCHES, cuda_spmv.LAUNCHES
    host_reads = dict(eigen.HOST_READS)
    peak = torch.cuda.max_memory_allocated()
    # the same solve on the device loop (no host wait inside the iteration)
    cuda_kappa.LAUNCHES = 0
    eigen.HOST_READS.update(blocking=0, flag_polls=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    om_dev, _, steps_dev, _ = se.solve(p, BAND_GUESS, loop="device",
                                       **BAND_KW)
    torch.cuda.synchronize()
    device_loop = {"seconds": time.perf_counter() - t0, "steps": steps_dev,
                   "queued_steps": eigen.LAST_SOLVE["queued_steps"],
                   "omega": [om_dev.real, om_dev.imag],
                   "k1_launches": cuda_kappa.LAUNCHES,
                   "host_reads": dict(eigen.HOST_READS),
                   "rel_vs_host_loop": abs(om_dev - om) / abs(om)}
    chunks = sum(1 for _ in se.table_pair_chunks(grid, de_max, None, tiers,
                                                 se.FUSED_CHUNK))
    M = state.M
    residual = float(torch.linalg.vector_norm(sparse.bdia_matvec(M, vec))
                     / torch.linalg.vector_norm(M.data))
    # the untruncated operator: the dense float32 trace secant at n=8192
    # (its own assembly and LU), from the banded omega, as in eigen.solve
    coeff = singularity_coeff_matrix(N_BAND, dtype=f32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sd = eigen.init_state(p, grid, coeff, state.omega, chunk=16384,
                          tiers=tiers, fused=True)
    for _ in range(DENSE_CHECK_STEPS):
        sd = eigen.newton_trace_step(p, grid, coeff, sd, chunk=16384,
                                     tiers=tiers, fused=True)
    om_dense = complex(sd.omega.item())
    dense_s = time.perf_counter() - t0
    del sd, coeff
    rel_dense = abs(om - om_dense) / abs(om_dense)
    rel_record = abs(om - BAND_RECORD) / abs(BAND_RECORD)
    SINGLE.update(band_omega=om, band_dense_omega=om_dense,
                  band_seconds=solve_s)
    emit("banded_slice", case=f"tok{N_BAND} float32 banded, band_deta 10, "
         "m_krylov 16, spmv bsr", omega=[om.real, om.imag],
         dense_omega=[om_dense.real, om_dense.imag], rel_vs_dense=rel_dense,
         dense_seconds=dense_s,
         jax_tpu_record=[BAND_RECORD.real, BAND_RECORD.imag],
         rel_vs_jax_tpu_record=rel_record, steps=n_steps, seconds=solve_s,
         first_run_seconds=first_s,
         arnoldi_omega=[stats["arnoldi_omega"].real,
                        stats["arnoldi_omega"].imag],
         spmv_route=stats["spmv_route"], nnz=M.nnz, h=stats["h"],
         k1_launches=k1_launches, k1_chunk=se.FUSED_CHUNK,
         k1_chunks_per_assembly=chunks, k5_launches=k5_launches,
         host_reads=host_reads, device_loop=device_loop,
         residual=residual, peak_memory_bytes=peak, card=card)
    check(device_loop["steps"] == n_steps
          and device_loop["rel_vs_host_loop"] < 1e-6,
          f"banded device loop vs host loop: {device_loop}, host steps "
          f"{n_steps}")
    check(device_loop["k1_launches"]
          == chunks * (4 + device_loop["queued_steps"]),
          f"device loop K1 launches {device_loop['k1_launches']} == {chunks} "
          f"chunks x (4 + {device_loop['queued_steps']} queued steps)")
    # one read for the Arnoldi stage's shift, one for the step count and
    # omega; the host loop also reads the done flag every step
    check(device_loop["host_reads"]["blocking"] == 2
          and host_reads["blocking"] == n_steps + 2,
          f"blocking reads: device loop {device_loop['host_reads']}, host "
          f"loop {host_reads}")
    check(k5_launches == BAND_KW["m_krylov"],
          f"K5 launches {k5_launches} == {BAND_KW['m_krylov']}, the Arnoldi "
          f"stage's matvecs")
    check(k1_launches == chunks * (4 + n_steps),
          f"K1 launches {k1_launches} == {chunks} chunks x (4 + {n_steps})")
    check(M.nnz == BAND_NNZ and (M.block, stats["h"]) == (128, 16),
          f"operator nnz {M.nnz}, block {M.block}, h {stats['h']}")
    check(M.data.is_cuda and vec.is_cuda and state.omega.is_cuda,
          "operator, eigenvector and omega on the card")
    check(vec.shape == (N_BAND,) and M.data.dtype == torch.complex64,
          "shapes and dtype")
    check(bool(torch.isfinite(M.data).all())
          and bool(torch.isfinite(vec).all()), "finite operator and vector")
    check(rel_dense < BAND_BAR,
          f"banded vs dense omega {rel_dense:.3e} < {BAND_BAR}")
    check(residual < RESIDUAL_BAR,
          f"||M v||/||M||_F {residual:.3e} < {RESIDUAL_BAR}")

    # 15. banded_breakdown at n=8192
    asm = lambda: se.assemble_bdia(p, grid, cband, state.omega, h, bs,  # noqa: E731
                                   tiers=tiers, fused=True)
    asm_ms, _ = timed(asm, torch)
    k1_ms, k1_nodes, k1_bytes, k1_flop = 0.0, 0, 0, 0.0
    for ea, eb, q in se.table_pair_chunks(grid, de_max, None, tiers,
                                          se.FUSED_CHUNK):
        args = cuda_kappa._prepare(p, ea, eb, state.omega, q)
        k1_ms += event_ms(lambda: cuda_kappa._launch(*args, (0,)), torch,
                          reps=1)
        npairs, n_panels = args[0].shape
        k1_nodes += npairs * n_panels * args[4]
        k1_bytes += nbytes(*args[:4]) + 8 * npairs
        k1_flop += npairs * n_panels * args[4] * by_branch(
            K1_FLOP_PER_NODE, k1_asymptotic_share(torch, cuda_kappa, *args,
                                                  every=64))
        del args
    k1_bound = bound(k1_bytes, k1_flop)
    lu_ms, lu = timed(lambda: banded.banded_lu(M), torch)
    selinv_ms, _ = timed(lambda: banded.banded_trace_product(
        banded.banded_selected_inverse(lu), state.dM), torch)
    solve_ms, _ = timed(lambda: banded.banded_solve(lu, vec), torch)
    arn_ms, _ = timed(lambda: se.arnoldi_estimate(state, BAND_KW["m_krylov"],
                                                  "bsr"), torch)
    null_ms, _ = timed(lambda: se._null_vector(banded.banded_lu(M), N_BAND,
                                               M.data.dtype, iters=3), torch)
    emit("banded_breakdown", case=f"tok{N_BAND}", assembly_ms=asm_ms,
         k1_ms_per_assembly=k1_ms, k1_nodes_per_assembly=k1_nodes,
         k1_bound_ms=k1_bound["bound_ms"], k1_bound_by=k1_bound["bound_by"],
         k1_flop_per_node=k1_flop / k1_nodes,
         banded_lu_ms=lu_ms,
         selected_inverse_and_trace_ms=selinv_ms, banded_solve_ms=solve_ms,
         arnoldi_stage_ms=arn_ms, null_vector_ms=null_ms, card=card)
    del lu, state, M

    # 16. banded_certify: tok1024 with the complex128 polish on the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    om1, v1, steps1, _ = se.solve(p1, GUESS, tol=1e-6, band_deta=20.0,
                                  host64=True)
    torch.cuda.synchronize()
    cert_s = time.perf_counter() - t0
    rel1 = abs(om1 - GOLDEN_TOK1024) / abs(GOLDEN_TOK1024)
    check(v1.is_cuda and v1.dtype == torch.complex128
          and abs(float(torch.linalg.vector_norm(v1)) - 1.0) < 1e-12,
          "certified eigenvector: complex128, unit norm, on the card")
    check(rel1 < CERT_BAR, f"certified omega rel err {rel1:.3e} < {CERT_BAR}")
    emit("banded_certify", case=f"tok{N_TOK} banded band_deta 20 host64",
         omega=[om1.real, om1.imag],
         golden=[GOLDEN_TOK1024.real, GOLDEN_TOK1024.imag], rel_err=rel1,
         steps=steps1, seconds=cert_s, card=card)

    # 17. banded_tpu_precision: the slice's call with TPU-precision matmuls
    # in the banded linear algebra reproduces the JAX package's TPU record
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    om_b, _, steps_b, _ = tpu_precision_solve(
        torch, banded, lambda: se.solve(p, BAND_GUESS, **BAND_KW))
    torch.cuda.synchronize()
    rel_b = abs(om_b - BAND_RECORD) / abs(BAND_RECORD)
    emit("banded_tpu_precision", case=f"tok{N_BAND} as banded_slice, banded "
         "LU / selected inverse / solves at one bf16 pass",
         omega=[om_b.real, om_b.imag], steps=steps_b,
         seconds=time.perf_counter() - t0,
         jax_tpu_record=[BAND_RECORD.real, BAND_RECORD.imag],
         rel_vs_jax_tpu_record=rel_b,
         float32_rel_vs_jax_tpu_record=rel_record,
         rel_vs_float32=abs(om_b - om) / abs(om), card=card)
    check(rel_b < RECORD_BAR,
          f"TPU-precision omega vs the JAX package's TPU record {rel_b:.3e} "
          f"< {RECORD_BAR}")

    k5 = rows[0]
    k5_r16 = next(r for r in rows if r["r"] == 16 and r["dtype"] == "complex64")
    return ({"name": "bsr_spmv", "route": "cuda",
             "source": "emme_tpu_torch/csrc/spmv.cu",
             "replaces": "emme_tpu/ops/sparse.py:109",
             "launches": k5_launches,
             "launches_from": f"sparse_eigen.solve tok{N_BAND} (m_krylov 16, "
                              "spmv bsr)",
             "max_abs_err": max(r["max_abs_err"] for r in rows),
             "ms": k5["kernel_ms"], "plain_ms": k5["plain_ms"],
             "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
             "library_ms": k5["library_ms"],
             "ms_at": f"tok{N_BAND}, r = 1, complex64",
             "r16": {k: k5_r16[k] for k in (
                 "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                 "bound_by", "share_of_bound", "max_abs_err")}},
            {"launches": k1_launches + device_loop["k1_launches"],
             "max_abs_err": max(r["max_abs_err"] for r in k1_rows)})


def vec_corr(a, b, torch):
    a, b = a.to(torch.complex128), b.to(torch.complex128)
    return float(torch.vdot(a, b).abs() / (torch.linalg.vector_norm(a)
                                           * torch.linalg.vector_norm(b)))


def counted_solve(torch, cuda_kappa, eigen, solve):
    """One warm-up call of ``solve()``, then one timed and counted: returns
    (result, seconds, first-run seconds, K1 launches by moments, host reads,
    what the solve did).  K1's launches are counted by moments around
    ``cuda_kappa._launch`` for the timed call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    by_ms = {}
    launch = cuda_kappa._launch

    def counted(mid, halfw, pair, scal, order, ms):
        by_ms[tuple(ms)] = by_ms.get(tuple(ms), 0) + 1
        return launch(mid, halfw, pair, scal, order, ms)

    eigen.HOST_READS.update(blocking=0, flag_polls=0)
    cuda_kappa._launch = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solve()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        cuda_kappa._launch = launch
    return (out, seconds, first_s, by_ms, dict(eigen.HOST_READS),
            dict(eigen.LAST_SOLVE))


def dense_phases(torch, card, p, state):
    """Phases 5b-5d (the rest of the dense solver); returns K1's launches on
    these paths and its stel1024 comparison rows."""
    from emme_tpu_torch import from_config
    from emme_tpu_torch.grid import Grid
    from emme_tpu_torch.ops import cuda_kappa, kernels, linalg
    from emme_tpu_torch.ops.singularity import singularity_coeff_matrix
    from emme_tpu_torch.solvers import eigen

    dev = torch.device("cuda")
    f32 = torch.float32
    n_tiers = len(eigen.discretization(p, f32)[0])

    # 5b. dense_certify
    (om, vec, n_steps, _), secs, first_s, by_ms, reads, did = counted_solve(
        torch, cuda_kappa, eigen, lambda: eigen.solve(
            p, GUESS, tol=1e-6, chunk=16384, host64=True))
    rel = abs(om - GOLDEN_TOK1024) / abs(GOLDEN_TOK1024)
    assemblies = 2 + did["queued_steps"] + did["polish_assemblies"]
    cert_launches = sum(by_ms.values())
    cert_s, cert_om = secs, om
    emit("dense_certify", case=f"tok{N_TOK} float32 dense host64 tol 1e-6",
         omega=[om.real, om.imag],
         golden=[GOLDEN_TOK1024.real, GOLDEN_TOK1024.imag], rel_err=rel,
         steps=n_steps, loop_steps=did["steps"],
         extra_steps=did["polish_steps"], loop=did["loop"],
         assemblies=assemblies, launches=cert_launches, host_reads=reads,
         seconds=secs, first_run_seconds=first_s, card=card)
    check(rel < CERTIFY_BAR, f"certified omega rel err {rel:.3e} < {CERTIFY_BAR}")
    check(n_steps == did["steps"] + did["polish_steps"], "step counting")
    check(by_ms == {(0,): n_tiers * assemblies},
          f"K1 launches {by_ms} == {n_tiers} tiers x {assemblies} assemblies")
    check(vec.is_cuda and vec.dtype == torch.complex128
          and abs(float(torch.linalg.vector_norm(vec)) - 1.0) < 1e-12,
          "certified eigenvector: complex128, unit norm, on the card")

    # 5c. stel_slice: the electromagnetic path at full width
    sp = from_config(load_cfg("stellarator", N_TOK), dtype=f32)
    check(sp.electromagnetic and sp.device.type == "cuda",
          "stellarator: electromagnetic, on the card")
    gs = Grid.create(sp.length, sp.npoints, dtype=f32)
    tiers_s = eigen.discretization(sp, f32)[0]
    groups_s = eigen.pair_plan(sp.npoints, tiers_s, str(gs.eta.device))["groups"]
    om_s = torch.tensor(STEL_GUESS, dtype=torch.complex64, device=dev)
    stel_rows = []
    for t, (iu, ju, spec) in enumerate(groups_s):
        r = compare(sp, gs.eta[iu], gs.eta[ju], om_s, (0, 1, 2),
                    kernels.scaled_quad(None, f32, spec), EM_BAR, torch,
                    cuda_kappa)
        stel_rows.append(r)
        emit("kernel_vs_plain", case=f"stel{N_TOK}", tier=t,
             ms_moments=[0, 1, 2], **r)
    torch.cuda.reset_peak_memory_stats()
    (om, vec, n_steps, st), secs, first_s, by_ms, reads, did = counted_solve(
        torch, cuda_kappa, eigen, lambda: eigen.solve(
            sp, STEL_GUESS, tol=1e-6, chunk=16384, host64=True))
    peak = torch.cuda.max_memory_allocated()
    rel = abs(om - STEL_GOLDEN) / abs(STEL_GOLDEN)
    assemblies = 2 + did["queued_steps"] + did["polish_assemblies"]
    stel_launches = sum(by_ms.values())
    coeff_s = singularity_coeff_matrix(sp.npoints, dtype=f32)
    asm = lambda: eigen.assemble_matrix(  # noqa: E731
        sp, gs, coeff_s, torch.tensor(om, dtype=torch.complex64, device=dev),
        None, 16384, tiers_s, True)
    asm_ms, M = timed(asm, torch)
    M = M.to(torch.complex128)
    residual = float(torch.linalg.vector_norm(M @ vec)
                     / torch.linalg.matrix_norm(M))
    dim = 2 * sp.npoints
    emit("stel_slice", case=f"stel{N_TOK} float32 electromagnetic dense "
         "host64 tol 1e-6", dim=dim, omega=[om.real, om.imag],
         golden=[STEL_GOLDEN.real, STEL_GOLDEN.imag], rel_err=rel,
         jax_package_rel_err=1.31e-5, steps=n_steps, loop_steps=did["steps"],
         extra_steps=did["polish_steps"], loop=did["loop"],
         queued_steps=did["queued_steps"], assemblies=assemblies,
         tiers=len(groups_s), launches=stel_launches,
         launches_by_moments={str(k): v for k, v in by_ms.items()},
         host_reads=reads, residual=residual, seconds=secs,
         first_run_seconds=first_s, assembly_ms=asm_ms,
         kernel_ms_per_assembly=sum(r["kernel_ms"] for r in stel_rows),
         plain_ms_per_assembly=sum(r["plain_ms"] for r in stel_rows),
         peak_memory_bytes=peak, card=card)
    check(rel < STEL_BAR, f"stel{N_TOK} omega rel err {rel:.3e} < {STEL_BAR}")
    check(by_ms == {(0, 1, 2): len(groups_s) * assemblies},
          f"K1 launches {by_ms} == {len(groups_s)} tiers x {assemblies} "
          "assemblies, all with three moments")
    check(st.M.shape == (dim, dim) and st.M.dtype == torch.complex64
          and vec.shape == (dim,) and vec.dtype == torch.complex128
          and vec.is_cuda, "shapes and dtypes")
    check(bool(torch.isfinite(st.M).all()) and bool(torch.isfinite(vec).all()),
          "finite operator and eigenvector")
    check(residual < RESIDUAL_BAR,
          f"||M v||/||M||_F {residual:.3e} < {RESIDUAL_BAR}")
    del M, st, coeff_s

    # 5d. dense_methods
    # QRSecant takes the host loop by default: on the device loop the one
    # masked step past convergence is a whole pivoted-QR sweep; both timed
    methods = {}
    for method, loop in (("QRSecant", None), ("QRSecant", "device"),
                         ("BorderedSecant", None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        om, vec, n_steps, _ = eigen.solve(p, GUESS, tol=1e-5, chunk=16384,
                                          method=method, loop=loop)
        torch.cuda.synchronize()
        rel = abs(om - GOLDEN_TOK1024) / abs(GOLDEN_TOK1024)
        did = dict(eigen.LAST_SOLVE)
        methods[method if loop is None else f"{method} loop={loop}"] = {
            "omega": [om.real, om.imag], "rel_err": rel, "steps": n_steps,
            "loop": did["loop"], "queued_steps": did["queued_steps"],
            "seconds": time.perf_counter() - t0}
        check(rel < SOLVE_BAR, f"{method} omega rel err {rel:.3e} < {SOLVE_BAR}")
    check(methods["QRSecant"]["loop"] == "host"
          and methods["BorderedSecant"]["loop"] == "device",
          f"default loops by method: {methods}")
    check(methods["QRSecant"]["steps"]
          == methods["QRSecant loop=device"]["steps"],
          f"QRSecant steps on both loops: {methods}")
    qr_ms, _ = timed(lambda: linalg.qr_column_pivoted(state.M), torch,
                     repeats=1)
    loops = {}
    for loop in ("host", "device"):
        (om, vec, n_steps, _), secs, _, _, reads, did = counted_solve(
            torch, cuda_kappa, eigen, lambda: eigen.solve(
                p, GUESS, tol=1e-5, chunk=16384, loop=loop))
        loops[loop] = {"omega": om, "steps": n_steps, "seconds": secs,
                       "host_reads": reads,
                       "queued_steps": did["queued_steps"]}
    d_loop = abs(loops["device"]["omega"] - loops["host"]["omega"]) \
        / abs(loops["host"]["omega"])
    check(loops["device"]["steps"] == loops["host"]["steps"],
          f"device and host loop steps: {loops}")
    check(d_loop < 1e-6, f"device vs host loop omega {d_loop:.3e} < 1e-6")
    check(loops["device"]["host_reads"]["blocking"] == 1,
          f"the device loop reads once a solve: {loops['device']}")
    check(loops["host"]["host_reads"]["blocking"] == loops["host"]["steps"] + 1,
          f"the host loop reads once a step and once more: {loops['host']}")
    for v in loops.values():
        v["omega"] = [v["omega"].real, v["omega"].imag]
    M = state.M
    inv_ms, v_inv = timed(lambda: linalg.null_space_vector(M, "inverse"),
                          torch)
    svd_ms, v_svd = timed(lambda: linalg.null_space_vector(M, "svd"), torch)
    corr = vec_corr(v_inv, v_svd, torch)
    res = {k: float(torch.linalg.vector_norm(M @ v)
                    / torch.linalg.matrix_norm(M))
           for k, v in (("inverse", v_inv), ("svd", v_svd))}
    check(corr > 1 - 1e-5, f"inverse vs svd null vector {corr} > 1 - 1e-5")
    emit("dense_methods", case=f"tok{N_TOK} float32 dense tol 1e-5",
         methods=methods, qr_column_pivoted_ms=qr_ms, loops=loops,
         loop_omega_rel_diff=d_loop,
         null_vector={"correlation": corr, "residual": res,
                      "inverse_ms": inv_ms, "svd_ms": svd_ms}, card=card)
    return {"launches": cert_launches + stel_launches,
            "certify_seconds": cert_s, "certify_omega": cert_om,
            "certify_launches": cert_launches, "stel_launches": stel_launches,
            "max_abs_err": max(r["max_abs_err"] for r in stel_rows),
            "stel_rows": stel_rows}


def driver_phases(torch, card, slice_omega, certify_s):
    """Phases 18-22 (the product surface): input files through
    ``emme_tpu_torch.cli.main`` on the card.  Returns each kernel's launches
    on these paths, by the names of the kernels line, and what they came
    from."""
    import numpy as np

    from emme_tpu_torch import cli, from_config
    from emme_tpu_torch.ops import cuda_guard, cuda_kappa, cuda_spmv, sparse
    from emme_tpu_torch.solvers import cuda_pic, eigen, pic
    from emme_tpu_torch.solvers import sparse_eigen as se
    from emme_tpu_torch.utils.timer import Timer

    f32 = torch.float32
    golden = [GOLDEN_TOK1024.real, GOLDEN_TOK1024.imag]

    def reset_counts():
        cuda_kappa.LAUNCHES = 0
        cuda_spmv.LAUNCHES = 0
        cuda_guard.LAUNCHES = 0
        for k in eigen.GUARD_ROUTE:
            eigen.GUARD_ROUTE[k] = 0
        for k in cuda_pic.LAUNCHES:
            cuda_pic.LAUNCHES[k] = 0
        # as in a fresh process: K3's once-per-process self-check runs again
        cuda_pic._SELFCHECK.clear()

    def counts():
        return {"kappa_pairs": cuda_kappa.LAUNCHES,
                "bsr_spmv": cuda_spmv.LAUNCHES, **cuda_pic.LAUNCHES}

    def run_cli(tmp, name, cfg, *flags, runs=2):
        """Write ``cfg`` as an input file and run it ``runs`` times through
        the command line's entry point; the last run is timed and counted.
        Returns (output.json, output directory, seconds, first run's
        seconds, launches)."""
        path = tmp / f"{name}.json"
        path.write_text(json.dumps(cfg, indent=1))
        out = tmp / name
        secs = []
        for _ in range(runs):
            reset_counts()
            Timer.get_timer().reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main([str(path), "-o", str(out), "-q", *flags])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            check(rc == 0, f"cli.main returned {rc}")
        doc = json.loads((out / "output.json").read_text())
        check(doc["framework"] == "emme_tpu_torch" and doc["input"] == cfg,
              "output.json names the port and carries the input")
        check(not (out / "checkpoint.json").exists(),
              "the checkpoint is gone after a clean run")
        return doc, out, secs[-1], secs[0], counts()

    def single(doc):
        return doc["result"]["(None)"]["scan_result"][0]

    launches = {k: 0 for k in counts()}
    sources = {k: [] for k in launches}

    def credit(name, got, phase):
        launches[name] += got[name]
        sources[name].append(f"{phase} ({got[name]})")

    with tempfile.TemporaryDirectory(prefix="emme_smoke_") as tmp:
        tmp = pathlib.Path(tmp)

        # 18. driver_eigen
        cfg = load_cfg("tokamak", N_TOK)
        doc, out, secs, first_s, got = run_cli(
            tmp, "driver_eigen", cfg, "--f32", "--host64", "--chunk", "16384")
        res = single(doc)
        om = complex(*res["eigenvalue"])
        rel = abs(om - GOLDEN_TOK1024) / abs(GOLDEN_TOK1024)
        dump = out / "eigenMatrics" / "eigenMatrix.bin"
        emit("driver_eigen", case=f"cli tok{N_TOK} --f32 --host64 --chunk "
             "16384", omega=res["eigenvalue"], golden=golden, rel_err=rel,
             steps=res["iteration_steps"], seconds=secs,
             first_run_seconds=first_s, direct_call_seconds=certify_s,
             driver_overhead_seconds=secs - certify_s,
             timer_sections=Timer.get_timer().timings(),
             quadrature_guard=res["quadrature_guard"], launches=got,
             guard_route=dict(eigen.GUARD_ROUTE),
             guard_launches=cuda_guard.LAUNCHES,
             loop=eigen.LAST_SOLVE["loop"], dump_bytes=dump.stat().st_size,
             card=card)
        check(rel < CERTIFY_BAR, f"driver omega rel err {rel:.3e} < "
                                 f"{CERTIFY_BAR}")
        check(len(res["eigenvector"]) == N_TOK, "eigenvector of 1024 entries")
        check(dump.stat().st_size == N_TOK * N_TOK * 16,
              "eigenMatrix.bin holds 1024^2 complex128 values")
        check(res["quadrature_guard"]["n_sampled"] == 4096
              and math.isfinite(res["quadrature_guard"]["max_abs_err"]),
              f"the quadrature guard ran: {res['quadrature_guard']}")
        check(got["kappa_pairs"] > 0 and eigen.LAST_SOLVE["loop"] == "device",
              f"the driver's solve went through K1 on the device loop: {got}")
        check(eigen.GUARD_ROUTE == {"kernels": 1, "torch": 0}
              and cuda_guard.LAUNCHES == 2,
              f"the driver's guard took the kernels, G and R once each: "
              f"{eigen.GUARD_ROUTE}, {cuda_guard.LAUNCHES} launches")
        credit("kappa_pairs", got, "driver_eigen")

        # 19. driver_pic
        pic_cfg = dict(cfg, method="PIC", marker_per_cell=PIC_MPC,
                       step_number=PIC_STEPS, time_step=PIC_DT,
                       pic_backend="fused", stream_fields=False)
        doc, out, secs, first_s, got = run_cli(tmp, "driver_pic", pic_cfg,
                                               "--f32")
        res = single(doc)
        om = complex(*res["eigenvalue"])
        d_om = abs(om.real - GOLDEN_PIC.real) / abs(GOLDEN_PIC.real)
        d_gam = abs(om.imag - GOLDEN_PIC.imag) / abs(GOLDEN_PIC.imag)
        check(cuda_pic.LAST_LAUNCH == "single"
              and got["pic_mega"] == 1 and got["grid_sync_probe"] >= 1
              and got["pic_stage"] == 0,
              f"the canonical run from an input file launched K3 once, "
              f"after K4: {got}")
        check(d_om < 0.05 and d_gam < 0.10,
              f"fit {om} within 5 % / 10 % of golden pic_tok1024 "
              f"{GOLDEN_PIC}")
        check(len(res["eigenvector"]) == N_TOK
              and all(math.isfinite(v) for pair in res["eigenvector"]
                      for v in pair), "final field: 1024 finite entries")
        check(not (out / "eigenMatrics" / "eigenMatrix.bin").exists(),
              "'fused' writes no field dump")
        for k in ("pic_mega", "grid_sync_probe"):
            credit(k, got, "driver_pic")
        doc8, _, secs8, _, got8 = run_cli(
            tmp, "driver_pic_stages",
            dict(pic_cfg, step_number=8, pic_launch="stages"), "--f32",
            runs=1)
        check(cuda_pic.LAST_LAUNCH == "stages" and got8["pic_stage"] == 24
              and got8["pic_field"] == 24 and got8["pic_mega"] == 0,
              f"pic_launch 'stages', 8 steps: 24 + 24 launches of K2: {got8}")
        for k in ("pic_stage", "pic_field"):
            credit(k, got8, "driver_pic stages")
        n_large = LARGE_NF[0]
        doc_l, _, secs_l, _, got_l = run_cli(
            tmp, "driver_pic_large", dict(pic_cfg, npoints=n_large,
                                          time_step=large_dt(n_large)),
            "--f32", runs=1)
        res_l = single(doc_l)
        check(cuda_pic.LAST_LAUNCH == "single" and got_l["pic_mega"] == 1
              and got_l["grid_sync_probe"] >= 1,
              f"npoints {n_large} from an input file ran K3 once, after K4: "
              f"{got_l}")
        check(len(res_l["eigenvector"]) == n_large
              and all(math.isfinite(v) for pair in res_l["eigenvector"]
                      for v in pair),
              f"npoints {n_large} from an input file: a finite field of "
              f"{n_large} entries")
        for k in ("pic_mega", "grid_sync_probe"):
            credit(k, got_l, f"driver_pic npoints {n_large}")
        stream_cfg = {k: v for k, v in pic_cfg.items()
                      if k not in ("pic_backend", "stream_fields")}
        _, out16, secs16, _, got16 = run_cli(
            tmp, "driver_pic_stream", dict(stream_cfg, step_number=16),
            "--f32", runs=1)
        hist = np.fromfile(out16 / "eigenMatrics" / "eigenMatrix.bin",
                           dtype=np.complex128)
        check(hist.shape == (16 * N_TOK,) and bool(np.isfinite(hist).all())
              and sum(got16.values()) == 0,
              f"the streaming path dumps 16 x 1024 finite fields and takes "
              f"the plain path: {hist.shape}, {got16}")
        emit("driver_pic", case="cli tok1024 x 1024 markers/cell, 180 steps, "
             "dt 0.25, --f32, pic_backend fused, stream_fields false",
             omega=res["eigenvalue"],
             golden=[GOLDEN_PIC.real, GOLDEN_PIC.imag],
             rel_err=[d_om, d_gam], seconds=secs, first_run_seconds=first_s,
             path="single", launches=got,
             stages={"steps": 8, "seconds": secs8, "launches": got8,
                     "omega": single(doc8)["eigenvalue"]},
             large_grid={"npoints": n_large, "seconds": secs_l,
                         "launches": got_l, "omega": res_l["eigenvalue"]},
             streaming={"steps": 16, "seconds": secs16,
                        "dump_values": int(hist.shape[0])}, card=card)

        # 19b. driver_pic_sorted
        driver_pic_sorted(torch, card, tmp, pic_cfg, run_cli, single, pic,
                          from_config)

        # 20. driver_scan
        scan_cfg = dict(cfg, eta_i={"head": 3.0, "step": 0.25, "tail": 3.5})
        doc, out, secs, first_s, got = run_cli(
            tmp, "driver_scan", scan_cfg, "--f32", "--chunk", "16384")
        unit = doc["result"]["eta_i"]
        check(unit["scan_values"] == [3.0, 3.25, 3.5], "walk order")
        seed = complex(*cfg["initial_guess"])
        points = []
        for value, res in zip(unit["scan_values"], unit["scan_result"]):
            om = complex(*res["eigenvalue"])
            p_i = from_config(dict(cfg, eta_i=value), dtype=f32)
            direct, _, n_direct, _ = eigen.solve(
                p_i, seed, tol=cfg["iteration_precision"], chunk=16384)
            rel = abs(om - direct) / abs(direct)
            check(rel < 2e-5, f"scan point eta_i={value}: {om} vs direct "
                              f"solve {direct}, {rel:.3e} < 2e-5")
            check((out / "eigenMatrics"
                   / f"eta_iEq{value:.6f}.bin").stat().st_size
                  == N_TOK * N_TOK * 16, "every point has its dump")
            points.append({"eta_i": value, "omega": res["eigenvalue"],
                           "steps": res["iteration_steps"],
                           "direct_steps": n_direct, "rel_vs_direct": rel,
                           "guard_flagged":
                           res["quadrature_guard"]["frac_flagged"]})
            seed = om
        steps = [pt["steps"] for pt in points]
        credit("kappa_pairs", got, "driver_scan")
        gold = json.loads((REPO / "tests" / "goldens"
                           / "scan_eta_i_tok32.json").read_text())
        doc32, _, secs32, _, _ = run_cli(
            tmp, "driver_scan32", dict(scan_cfg, npoints=32), runs=1)
        unit32 = doc32["result"]["eta_i"]
        check(unit32["scan_values"] == gold["scan_values"], "tok32 walk order")
        rel32 = [abs(complex(*r["eigenvalue"]) - complex(*g)) / abs(complex(*g))
                 for r, g in zip(unit32["scan_result"], gold["eigenvalues"])]
        check(max(rel32) < 2e-5, f"tok32 float64 scan on the card vs the "
                                 f"reference's scan: {rel32} < 2e-5")
        emit("driver_scan", case=f"cli tok{N_TOK} --f32, eta_i 3.0 / 0.25 / "
             "3.5", points=points, seconds=secs, first_run_seconds=first_s,
             seconds_per_point=secs / len(points), launches=got,
             continuation_takes_no_more_steps=max(steps[1:]) <= steps[0],
             tok32_float64={"seconds": secs32, "rel_vs_reference_scan": rel32,
                            "steps": [r["iteration_steps"]
                                      for r in unit32["scan_result"]]},
             card=card)

        # 21. driver_sparse
        sp_cfg = dict(cfg, eigen_backend="sparse", band_deta=20.0,
                      m_krylov=16, spmv_method="bsr")
        doc, out, secs, first_s, got = run_cli(
            tmp, "driver_sparse", sp_cfg, "--f32", "--host64")
        res = single(doc)
        om = complex(*res["eigenvalue"])
        rel = abs(om - GOLDEN_TOK1024) / abs(GOLDEN_TOK1024)
        stats = res["sparse_stats"]
        op = sparse.load_bdia_dump(out / "eigenMatrics" / "eigenMatrix.bin")
        emit("driver_sparse", case=f"cli tok{N_TOK} sparse band_deta 20 "
             "m_krylov 16 spmv bsr --f32 --host64", omega=res["eigenvalue"],
             golden=golden, rel_err=rel, steps=res["iteration_steps"],
             seconds=secs, first_run_seconds=first_s, sparse_stats=stats,
             quadrature_guard=res["quadrature_guard"], launches=got,
             card=card)
        check(rel < CERT_BAR, f"driver sparse omega rel err {rel:.3e} < "
                              f"{CERT_BAR}")
        check(stats["spmv_route"] == "bsr" and got["bsr_spmv"]
              == sp_cfg["m_krylov"],
              f"K5 launches {got['bsr_spmv']} == the 16 Arnoldi matvecs, "
              f"route {stats['spmv_route']}")
        check(0 < got["kappa_pairs"] < 200,
              f"the banded assemblies went through K1 in table-sized calls, "
              f"not --chunk-sized ones: {got['kappa_pairs']} launches")
        check(op.data.is_cuda and (op.n, op.block) == (N_TOK, stats["block"])
              and op.nnz == stats["nnz"]
              and bool(torch.isfinite(op.data).all()),
              "the banded dump reads back through load_bdia_dump")
        credit("kappa_pairs", got, "driver_sparse")
        credit("bsr_spmv", got, "driver_sparse")
        del op

    # 22. eigen_timed
    p = from_config(load_cfg("tokamak", N_TOK), dtype=f32)
    sections = (" - linear solve", " - integration", " - differential")
    timer = Timer.get_timer()
    for _ in range(2):
        timer.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        om, _, n_steps, _ = eigen.solve(p, GUESS, tol=1e-5, chunk=16384,
                                        timed=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    per_step = {name.strip(" -"): timer.timings()[name] / n_steps
                for name in sections}
    rel = abs(om - slice_omega) / abs(slice_omega)
    emit("eigen_timed", case=f"tok{N_TOK} float32 dense TraceSecant timed",
         omega=[om.real, om.imag], rel_vs_slice=rel, steps=n_steps,
         seconds=secs, seconds_per_step=per_step,
         sections_share_of_solve=sum(timer.timings()[s] for s in sections)
         / secs, loop=eigen.LAST_SOLVE["loop"], card=card)
    check(rel < 1e-6, f"timed solve vs phase slice {rel:.3e} < 1e-6")
    check(timer.entries == list(sections) and all(v > 0 for v in
                                                  per_step.values()),
          f"the three sections were timed: {timer.timings()}")
    return launches, {k: " + ".join(v) for k, v in sources.items()}


def driver_pic_sorted(torch, card, tmp, pic_cfg, run_cli, single, pic,
                      from_config):
    """Phase 19b: the sorted-window PIC path (plain torch, no kernel) from
    phase 19's input file with "pic_sorted": true at the driver's defaults,
    beside the plain path from the same file; then run_sorted against
    pic.run, and the 'matmul' and 'bf16' CIC forms against 'take' /
    'segment', over SORTED_CHECK_STEPS canonical steps from one state."""
    f32 = torch.float32
    viols = []
    real_run_sorted = pic.run_sorted

    def counted_run_sorted(*args, **kwargs):
        stats, state, v = real_run_sorted(*args, **kwargs)
        viols.append(int(v))
        return stats, state, v

    pic.run_sorted = counted_run_sorted
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    doc, out, secs, first_s, got = run_cli(
        tmp, "driver_pic_sorted", dict(pic_cfg, pic_sorted=True), "--f32")
    peak = torch.cuda.max_memory_allocated()
    pic.run_sorted = real_run_sorted
    chose = dict(pic.LAST_SORTED)
    res = single(doc)
    om = complex(*res["eigenvalue"])
    d_om = abs(om.real - GOLDEN_PIC.real) / abs(GOLDEN_PIC.real)
    d_gam = abs(om.imag - GOLDEN_PIC.imag) / abs(GOLDEN_PIC.imag)
    _, _, plain_secs, _, _ = run_cli(
        tmp, "driver_pic_plain", dict(pic_cfg, pic_backend="xla"), "--f32")
    check(viols == [0, 0], f"no window violation in either run: {viols}")
    check(chose["R"] * chose["sorts"] == PIC_STEPS
          and chose["W"] == 384 and chose["n_chunks"] == 128,
          f"the driver's defaults give W 384 and 128 chunks: {chose}")
    check(sum(got.values()) == 0,
          f"the sorted path launches no kernel, whatever pic_backend: {got}")
    check(d_om < 0.05 and d_gam < 0.10,
          f"sorted fit {om} within 5 % / 10 % of golden pic_tok1024 "
          f"{GOLDEN_PIC}")
    check(len(res["eigenvector"]) == N_TOK
          and all(math.isfinite(v) for pair in res["eigenvector"]
                  for v in pair), "sorted final field: 1024 finite entries")
    check(not (out / "eigenMatrics" / "eigenMatrix.bin").exists(),
          "the sorted path writes no field dump")

    p = from_config(pic_cfg, dtype=f32)
    s0 = pic.init_state(p, PIC_MPC,
                        torch.Generator(device="cuda").manual_seed(2),
                        dtype=f32)
    n = SORTED_CHECK_STEPS

    def plain(**kw):
        return pic.run(p, PIC_MPC, n, PIC_DT, state=s0, **kw)

    sorted_ms, (st_s, s_s, v_s) = timed(lambda: pic.run_sorted(
        p, PIC_MPC, n, PIC_DT, state=s0, resort_every=30), torch)
    check_chose = dict(pic.LAST_SORTED)
    plain_ms, (st_p, s_p, _) = timed(plain, torch)
    st_r, s_r, _ = plain()
    forms = {name: plain(gather_method=name, deposit_method=name)
             for name in ("matmul", "bf16")}
    stats_rel = rel_err(st_s, st_p)
    field_rel = rel_err(s_s.field, s_p.field)
    cic = {name: {"field_rel": rel_err(f[1].field, s_p.field),
                  "stats_rel": rel_err(f[0], st_p)}
           for name, f in forms.items()}
    emit("driver_pic_sorted", case="cli tok1024 x 1024 markers/cell, 180 "
         "steps, dt 0.25, --f32, pic_sorted (pic_backend fused ignored)",
         omega=[om.real, om.imag], golden=[GOLDEN_PIC.real, GOLDEN_PIC.imag],
         rel_err=[d_om, d_gam], seconds=secs, first_run_seconds=first_s,
         plain_from_file_seconds=plain_secs,
         plain_direct_seconds=SINGLE.get("pic_plain_seconds"),
         sorts=chose["sorts"], chose=chose, violations=viols,
         peak_device_bytes=peak, peak_device_bytes_over_held=peak - held,
         launches=got,
         sorted_vs_plain={"steps": n, "chose": check_chose,
                          "violations": int(v_s), "stats_rel": stats_rel,
                          "field_rel": field_rel, "sorted_ms": sorted_ms,
                          "plain_ms": plain_ms},
         cic_forms={"plain_repeat_field_rel": rel_err(s_r.field, s_p.field),
                    **cic}, card=card)
    check(int(v_s) == 0, f"run_sorted over {n} steps: {int(v_s)} violations")
    check(stats_rel < SORTED_STATS_BAR,
          f"run_sorted vs run stats {stats_rel:.3e} < {SORTED_STATS_BAR}")
    check(cic["matmul"]["field_rel"] < SORTED_STATS_BAR,
          f"'matmul' CIC vs take / segment field "
          f"{cic['matmul']['field_rel']:.3e} < {SORTED_STATS_BAR}")
    check(all(bool(torch.isfinite(f[1].field).all()) for f in forms.values()),
          "the 'matmul' and 'bf16' runs are finite")


def assembly_routes_phase(torch, card):
    """Phase 3b (assembly_routes): one tok1024 and one stel1024 dense
    assembly on each route -- the kernels (P, K1 a tier, Q, from the
    solve's plan, ``ops/cuda_assembly.py``) and the torch around K1
    (``eigen._assemble_torch``) -- by CUDA events over back-to-back calls
    and by the host clock, the kernels each launches (``torch.profiler``),
    and the two operators' largest gap against K1's bar against its plain
    version."""
    from torch.profiler import ProfilerActivity, profile

    from emme_tpu_torch import from_config
    from emme_tpu_torch.grid import Grid
    from emme_tpu_torch.ops.singularity import singularity_coeff_matrix
    from emme_tpu_torch.solvers import eigen

    f32 = torch.float32
    dev = torch.device("cuda")

    def launches(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if not str(e.device_type()).endswith("CPU")
                 and not e.name().startswith(("Memcpy", "Memset"))
                 and e.duration_ns() > 0]
        return len(names), sum("kappa_pairs_kernel" in n for n in names)

    for case, name, guess, bar in (("tok", "tokamak", GUESS, ES_BAR),
                                   ("stel", "stellarator", STEL_GUESS,
                                    EM_BAR)):
        p = from_config(load_cfg(name, N_TOK), dtype=f32)
        grid = Grid.create(p.length, p.npoints, dtype=f32)
        coeff = singularity_coeff_matrix(p.npoints, dtype=f32)
        tiers = eigen.discretization(p, f32)[0]
        plan = eigen.assembly_plan(p, grid, None, tiers)
        omega = torch.tensor(guess, dtype=torch.complex64, device=dev)
        routes = {
            "kernels": lambda: eigen.assemble_matrix(
                p, grid, coeff, omega, None, 16384, tiers, True, plan),
            "torch": lambda: eigen._assemble_torch(
                p, grid, coeff, omega, None, 16384, tiers, True)}
        row, Ms = {}, {}
        for route, fn in routes.items():
            n_launch, n_k1 = launches(fn)
            wall_ms, Ms[route] = timed(fn, torch)
            row[route] = {"event_ms": event_ms(fn, torch, reps=10),
                          "wall_ms": wall_ms, "launches": n_launch,
                          "k1_launches": n_k1}
        scale = float(Ms["torch"].abs().max())
        gap = float((Ms["kernels"] - Ms["torch"]).abs().max())
        check(gap <= bar * max(scale, 1.0),
              f"{case}{N_TOK} kernels vs torch route {gap:.3e} > {bar} "
              f"max({scale:.3e}, 1)")
        check(row["kernels"]["k1_launches"] == row["torch"]["k1_launches"]
              == len(plan.tiers), "K1 once a tier on both routes")
        emit("assembly_routes", case=f"{case}{N_TOK}", tiers=len(plan.tiers),
             moments=list(plan.ms), max_abs_gap=gap, scale=scale, **row,
             card=card)


def guard_routes_phase(torch, card):
    """Phase 3c (guard_routes): the driver's quadrature guard as a request
    runs it, at tok1024 and stel1024 (the solve's tier table and assembly
    plan), at the converged omega and at GUARD_BAD_OMEGA, where the flags
    fire, on each route -- the kernels (P, G, R and one host read,
    ``ops/cuda_guard.py``) and the torch integrand -- held to the bars of
    tests/test_torch_cuda.py::test_guard_kernel_route_matches_torch_route:

    * the reports: the same ``n_sampled`` (4096), ``frac_flagged`` within
      0.01 (above 0.01 on both at the bad omega), ``max_abs_err`` within
      GUARD_ABS_SPREAD of the torch route's card reading plus the bar of
      max(scale, 1), ``max_rel_err`` within GUARD_REL_FACTOR of the nearer
      of the torch route's card and CPU readings;
    * G's rows read per sampled pair as R reads them
      (``cuda_guard.pair_values``) against ``eigen.guard_pairs`` on the
      card: |K| within the bar (GUARD_BAD_CEIL at the bad omega) of each
      moment's max(scale, 1), the tier gap within twice that, the embedded
      error within twice the bar plus 2^-18 of itself;
    * R's report against ``eigen.guard_report`` on those rows: the largest
      errors to 1e-6 of themselves, the flagged count within 4.

    At the converged omega besides: host-clock ms, the kernel launches and
    ``layer.host_read`` spans of each route (launch calls and spans on the
    host, ``torch.profiler``; at most 10 and 2 on the kernels), and G's
    device time by CUDA events beside its bound (G's nodes times K1's
    operations a node from ``portbench/roofline/k1.py``, at the nodes' own
    share of each Bessel branch)."""
    from torch.profiler import ProfilerActivity, profile

    from emme_tpu_torch import from_config
    from emme_tpu_torch.grid import Grid
    from emme_tpu_torch.ops import cuda_assembly, cuda_guard
    from emme_tpu_torch.solvers import eigen
    from portbench.roofline import k1 as k1_roofline

    f32 = torch.float32
    cpu = torch.device("cpu")

    def counts(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        on_host = [e.name() for e in prof.profiler.kineto_results.events()
                   if str(e.device_type()).endswith("CPU")]
        return (sum(n.startswith(("cudaLaunch", "cuLaunch"))
                    for n in on_host), on_host.count("layer.host_read"))

    for case, name, converged in (("tok", "tokamak", GOLDEN_TOK1024),
                                  ("stel", "stellarator", STEL_GOLDEN)):
        cfg = load_cfg(name, N_TOK)
        p = from_config(cfg, dtype=f32)
        grid = Grid.create(p.length, p.npoints, dtype=f32)
        p_cpu = from_config(cfg, dtype=f32, device=cpu)
        grid_cpu = Grid.create(p_cpu.length, p.npoints, dtype=f32,
                               device=cpu)
        tiers = eigen.discretization(p, f32)[0]
        plan = eigen.assembly_plan(p, grid, None, tiers)
        acc, prec = p.integration_accuracy, p.integration_precision
        ms = tuple(plan.ms)
        bar = EM_BAR if p.electromagnetic else ES_BAR
        gplan = eigen._guard_plan(p.npoints, ms, (4096, 0, tiers, None),
                                  None, int(p.integration_start_points),
                                  str(grid.eta.device))
        for at, omega in (("converged", converged), ("bad", GUARD_BAD_OMEGA)):
            where = f"{case}{N_TOK} guard at the {at} omega"
            routes = {
                "kernels": lambda: eigen.quadrature_guard(
                    p, grid, omega, tiers=tiers, plan=plan),
                "torch": lambda: eigen.quadrature_guard(
                    p, grid, omega, chunk=16384, tiers=tiers, fused=False)}
            row = {}
            for route, fn in routes.items():
                if at == "converged":
                    n_launch, n_reads = counts(fn)
                    wall_ms, rep = timed(fn, torch)
                    row[route] = {"wall_ms": wall_ms, "launches": n_launch,
                                  "host_reads": n_reads, "report": rep}
                else:
                    row[route] = {"report": fn()}
            row["torch_cpu"] = {"report": eigen.quadrature_guard(
                p_cpu, grid_cpu, omega, chunk=16384, tiers=tiers)}
            if at == "converged":
                check(row["kernels"]["launches"] <= 10
                      and row["kernels"]["host_reads"] <= 2,
                      f"{where}: {row['kernels']['launches']} launches, "
                      f"{row['kernels']['host_reads']} host reads")

            # G's rows per sampled pair against the torch integrand
            buf = cuda_assembly.inputs(
                gplan.inputs_plan(plan.points, plan.scalars), omega)
            out = cuda_guard.pairs(gplan, buf)
            got = cuda_guard.pair_values(gplan, out, plan.scalars)
            want = eigen.guard_pairs(p, grid, omega, chunk=16384,
                                     tiers=tiers)
            vbar = bar if at == "converged" else GUARD_BAD_CEIL
            gaps = {"abs_k": 0.0, "gap": 0.0, "error_rel": 0.0}
            for k in range(len(ms)):
                s_k = max(float(want[0][:, k].max()), 1.0)
                d_err = (got[1][:, k] - want[1][:, k]).abs()
                d = {"abs_k": float((got[0][:, k] - want[0][:, k]).abs().max())
                     / s_k,
                     "gap": float((got[2][:, k] - want[2][:, k]).abs().max())
                     / s_k,
                     "error_rel": float(((d_err - 2 * bar * s_k).clamp_min(0)
                                         / want[1][:, k].abs())
                                        .nan_to_num().max())}
                gaps = {key: max(v, d[key]) for key, v in gaps.items()}
            check(gaps["abs_k"] <= vbar and gaps["gap"] <= 2 * vbar
                  and gaps["error_rel"] <= 2.0 ** -18,
                  f"{where}: G's rows against the torch integrand {gaps}")

            # R against the plain reduction of G's rows
            r_flagged, r_abs, r_rel = cuda_guard.report(
                gplan, out, plan.scalars, acc, prec).tolist()
            plain = eigen.guard_report(*got, acc, prec)
            check(abs(r_flagged - plain["frac_flagged"] * 4096) <= 4
                  and abs(r_abs - plain["max_abs_err"])
                  <= 1e-6 * plain["max_abs_err"]
                  and abs(r_rel - plain["max_rel_err"])
                  <= 1e-6 * plain["max_rel_err"],
                  f"{where}: R {[r_flagged, r_abs, r_rel]} against the "
                  f"plain reduction of G's rows {plain}")

            # the reports
            rep = row["kernels"]["report"]
            card_rep = row["torch"]["report"]
            cpu_rep = row["torch_cpu"]["report"]
            scale = max([1.0] + [float(want[0][:, k].max())
                                 for k in range(len(ms))])
            nearer = min(abs(math.log(rep["max_rel_err"] / r["max_rel_err"]))
                         for r in (card_rep, cpu_rep))
            check(rep["n_sampled"] == card_rep["n_sampled"] == 4096
                  and abs(rep["frac_flagged"] - card_rep["frac_flagged"])
                  <= 0.01
                  and abs(rep["max_abs_err"] - card_rep["max_abs_err"])
                  <= GUARD_ABS_SPREAD * card_rep["max_abs_err"] + bar * scale
                  and nearer <= math.log(GUARD_REL_FACTOR),
                  f"{where}: reports {rep} vs torch card {card_rep}, torch "
                  f"cpu {cpu_rep}")
            if at == "bad":
                check(rep["frac_flagged"] > 0.01
                      and card_rep["frac_flagged"] > 0.01,
                      f"{where}: the flags fire on both routes: {rep} vs "
                      f"{card_rep}")
                emit("guard_routes", case=f"{case}{N_TOK}", at=at,
                     omega=[omega.real, omega.imag], **row, g_rows=gaps,
                     r_report=[r_flagged, r_abs, r_rel], card=card)
                continue

            g_ms = event_ms(lambda: cuda_guard.pairs(gplan, buf), torch)
            nodes = flop = 0.0
            for t in gplan.tiers:
                mid, halfw, pair, scal = gplan.inputs_plan(
                    plan.points, plan.scalars).inputs(buf, t)
                asym = k1_roofline.asymptotic_share(mid, halfw, pair, scal,
                                                    t.order)
                nodes += t.npairs * t.n_panels * t.order
                flop += k1_roofline.call_work(t.npairs, t.n_panels, t.order,
                                              len(ms), asym)[0]
            g = bound(0, flop)
            emit("guard_routes", case=f"{case}{N_TOK}", at=at,
                 omega=[omega.real, omega.imag], sets=len(gplan.tiers),
                 moments=list(ms), **row, g_rows=gaps,
                 r_report=[r_flagged, r_abs, r_rel], g_ms=g_ms,
                 g_nodes=nodes, g_bound_ms=g["bound_ms"],
                 g_bound_share=g["bound_ms"] / g_ms, card=card)


def dense_arnoldi_phase(torch, card):
    """Phase 24 (dense_arnoldi): the shift-invert Arnoldi estimate plus
    Newton polish against pure Newton (TraceSecant) at tok1024 float32, and
    the sixteen shifts of benchmarks/bench_arnoldi.py batched.  Returns
    K1's launches on these two paths."""
    import numpy as np

    from emme_tpu_torch import from_config
    from emme_tpu_torch.grid import Grid
    from emme_tpu_torch.ops import cuda_kappa
    from emme_tpu_torch.ops.singularity import singularity_coeff_matrix
    from emme_tpu_torch.solvers import arnoldi, eigen

    limit = watchdog(ARNOLDI_TIME_LIMIT_S, "phase dense_arnoldi")
    f32 = torch.float32
    p = from_config(load_cfg("tokamak", N_TOK), dtype=f32)
    golden = [GOLDEN_TOK1024.real, GOLDEN_TOK1024.imag]

    def rel(om):
        return abs(om - GOLDEN_TOK1024) / abs(GOLDEN_TOK1024)

    def arnoldi_solve():
        return arnoldi.solve(p, GUESS, m_krylov=ARNOLDI_KW["m_krylov"],
                             newton_polish=6, tol=SOLVE_TOL)

    def trace_solve():
        return eigen.solve(p, GUESS, tol=SOLVE_TOL, chunk=16384)

    # one shift: Arnoldi + polish against TraceSecant from the same guess,
    # in turns after a warm-up of each, every call counted from 0
    secs = {"arnoldi": [], "trace": []}
    for fn in (arnoldi_solve, trace_solve):
        fn()
    for _ in range(ARNOLDI_REPEATS):
        for name, fn in (("arnoldi", arnoldi_solve), ("trace", trace_solve)):
            cuda_kappa.LAUNCHES = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs[name].append(time.perf_counter() - t0)
            if name == "arnoldi":
                (om, vec, steps), arn_launches = out, cuda_kappa.LAUNCHES
            else:
                (om_t, _, steps_t, _), trace_launches = out, cuda_kappa.LAUNCHES
    arn_s, trace_s = (statistics.median(secs[k]) for k in ("arnoldi", "trace"))
    raw, _, _ = arnoldi.solve(p, GUESS, m_krylov=ARNOLDI_KW["m_krylov"],
                              newton_polish=0)
    grid = Grid.create(p.length, p.npoints, dtype=f32)
    coeff = singularity_coeff_matrix(p.npoints, dtype=f32)
    M = eigen.assemble_matrix(p, grid, coeff, torch.tensor(
        om, dtype=torch.complex64, device=grid.eta.device), None, 2048,
        None, True)
    residual = float(torch.linalg.vector_norm(M @ vec)
                     / torch.linalg.matrix_norm(M))
    del M
    check(rel(om) < SOLVE_BAR, f"Arnoldi + polish omega rel err "
                               f"{rel(om):.3e} < {SOLVE_BAR}")
    check(residual < RESIDUAL_BAR,
          f"Arnoldi ||M v||/||M||_F {residual:.3e} < {RESIDUAL_BAR}")
    check(arn_launches > 0 and vec.is_cuda,
          f"the Arnoldi solve went through K1 on the card: {arn_launches}")

    # sixteen shifts, batched: one (16, n, n) LU and one Arnoldi sweep
    rng = np.random.default_rng(0)
    sigmas = GUESS + 0.15 * (rng.normal(size=16) + 1j * rng.normal(size=16))
    arnoldi.solve_shifts_batched(p, sigmas[:2], **ARNOLDI_KW)   # warm-up
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_kappa.LAUNCHES = 0
    route = dict(arnoldi.SURVEY_ROUTE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ests = arnoldi.solve_shifts_batched(p, sigmas, **ARNOLDI_KW)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    batch_launches = cuda_kappa.LAUNCHES
    route = {k: arnoldi.SURVEY_ROUTE[k] - route[k] for k in route}
    check(route == {"surveys": 1, "shifts": 16, "assemblies": 32,
                    "plans": 16}, f"the survey's route counts {route}")
    peak = torch.cuda.max_memory_allocated()
    dist = sorted((rel(e), k) for k, e in enumerate(ests))
    check(len(ests) == 16 and all(np.isfinite(ests)),
          "sixteen finite estimates")
    check(batch_launches > 0, "the batched shifts went through K1")
    unbatched = {}
    for _, k in dist[:2]:
        one, _, _ = arnoldi.solve_one_shift(p, grid, coeff, sigmas[k],
                                            ARNOLDI_KW["m_krylov"])
        unbatched[k] = abs(ests[k] - one) / abs(one)
        check(unbatched[k] < BATCH_BAR,
              f"shift {k}: batched vs unbatched estimate "
              f"{unbatched[k]:.3e} < {BATCH_BAR}")
    emit("dense_arnoldi", case=f"tok{N_TOK} float32 dense, sigma {GUESS}, "
         "m_krylov 24, newton_polish 6, tol 1e-5", omega=[om.real, om.imag],
         golden=golden, rel_err=rel(om), raw_estimate_rel_err=rel(raw),
         polish_steps=steps, seconds=arn_s, all_seconds=secs["arnoldi"],
         k1_launches=arn_launches, residual=residual,
         trace_secant={"omega": [om_t.real, om_t.imag],
                       "rel_err": rel(om_t), "steps": steps_t,
                       "seconds": trace_s, "all_seconds": secs["trace"],
                       "k1_launches": trace_launches},
         faster="TraceSecant" if trace_s < arn_s else "Arnoldi + polish",
         shifts={"n": 16, "seconds": batch_s, "peak_memory_bytes": peak,
                 "k1_launches": batch_launches, "survey_route": route,
                 "closest_rel_err": [d for d, _ in dist[:4]],
                 "batched_vs_unbatched": {str(k): v
                                          for k, v in unbatched.items()}},
         card=card)
    limit.cancel()
    return {"launches": arn_launches + batch_launches,
            "from": f"arnoldi.solve tok{N_TOK} ({arn_launches}) + "
                    f"solve_shifts_batched 16 shifts ({batch_launches})"}


def mesh_window_phase(torch, card):
    """Phase 25: the windows of a MESH_ROWS-row layout of the tok8192
    banded operator through K1, each against the whole assembly's rows;
    returns K1's entry additions (launches, max_abs_err)."""
    from emme_tpu_torch import from_config
    from emme_tpu_torch.grid import Grid
    from emme_tpu_torch.ops import cuda_kappa
    from emme_tpu_torch.ops.singularity import singularity_coeff_band
    from emme_tpu_torch.solvers import eigen, sparse_eigen as se

    f32 = torch.float32
    p = from_config(load_cfg("tokamak", N_BAND), dtype=f32)
    grid = Grid.create(p.length, N_BAND, dtype=f32)
    bs = se.pick_block(N_BAND // MESH_ROWS)
    h = se.band_halfwidth(p, grid, bs, BAND_KW["band_deta"])
    de_max = (h + 1) * bs - 1
    cband = singularity_coeff_band(N_BAND, de_max, dtype=f32)
    tiers = eigen.discretization(p, f32)[0]
    seed = torch.tensor(BAND_GUESS, dtype=torch.complex64, device="cuda")
    kw = dict(tiers=tiers, fused=True)
    whole_ms, whole = timed(lambda: se.assemble_bdia(p, grid, cband, seed, h,
                                                     bs, **kw), torch)
    nbl = (N_BAND // bs) // MESH_ROWS
    check(h <= nbl, f"half-bandwidth {h} fits a shard of {nbl} block rows")
    scale = float(whole.data.abs().max())
    rows, launches = [], 0
    for s in range(MESH_ROWS):
        i0, ncols = s * nbl * bs - de_max, nbl * bs + de_max
        lo, hi, q = se.table_sections(None, f32, de_max, tiers)[0]
        ea, eb = se.table_pairs(grid, lo, 0, min(K1_CHECK_PAIRS,
                                                 (hi - lo + 1) * ncols),
                                i0, ncols)
        k1 = compare_f64(p, ea, eb, seed, q, torch, cuda_kappa)

        def window():
            return se.assemble_bdia_window(p, grid, cband, seed, h, bs,
                                           s * nbl, nbl, **kw)

        cuda_kappa.LAUNCHES = 0
        win = window()
        torch.cuda.synchronize()
        n_launch = cuda_kappa.LAUNCHES
        launches += n_launch
        chunks = sum(1 for _ in se.table_pair_chunks(
            grid, de_max, None, tiers, se.FUSED_CHUNK, i0, ncols))
        err = float((win - whole.data[:, s * nbl:(s + 1) * nbl]).abs().max())
        check(win.is_cuda and bool(torch.isfinite(win).all()),
              f"window {s} finite on the card")
        check(n_launch == chunks, f"window {s}: K1 launches {n_launch} == "
                                  f"{chunks} table chunks")
        check(err <= ES_BAR * max(scale, 1.0),
              f"window {s} vs the whole operator {err:.3e} > {ES_BAR} "
              f"max({scale:.3e}, 1)")
        del win
        win_ms, _ = timed(window, torch)
        rows.append({"window": s, "block_rows": [s * nbl, (s + 1) * nbl],
                     "table_columns": ncols, "ms": win_ms,
                     "k1_launches": n_launch, "max_abs_err_vs_whole": err,
                     "k1_vs_plain_max_abs_err": k1["max_abs_err"],
                     "k1_vs_f64": k1["k1_vs_f64"],
                     "plain_vs_f64": k1["plain_vs_f64"],
                     "k1_check_pairs": k1["npairs"]})
    emit("mesh_window_assembly", case=f"tok{N_BAND} float32 banded, "
         f"band_deta {BAND_KW['band_deta']}, {MESH_ROWS} windows, block {bs}, "
         f"h {h}", whole_ms=whole_ms, windows=rows,
         windows_sum_ms=sum(r["ms"] for r in rows),
         halo_columns_share=sum(r["table_columns"] for r in rows)
         / N_BAND - 1.0, card=card)
    return {"launches": launches,
            "max_abs_err": max(r["k1_vs_plain_max_abs_err"] for r in rows)}


def native_memo(torch, p, ph, rows, m, om0):
    """Phase 27's memo: N1 along a whole eigen_native.solve's omega sequence
    (0.99 om0, om0, each step's omega) with a fresh memo (the first launch
    plain, the second filling, the later reading) against a memo-free launch
    at each omega: 0 values (bits) or panel counts differing; each launch's
    CUDA-event ms beside the memo-free one's, its Miller steps, its nodes
    memoised and in full; the reads' hit share, the memo's bytes."""
    from emme_tpu_torch.ops import adaptive, cuda_adaptive
    from emme_tpu_torch.solvers import eigen_native

    seq = [0.99 * om0, om0]
    eigen_native.solve(p, om0, tol=1e-6,
                       callback=lambda j, w, d: seq.append(w))

    def event_ms(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b), out

    memo = cuda_adaptive.Memo()
    launches = []
    for w in seq:
        sc = adaptive.scalars(ph, w)
        plain_ms, (v0, p0, m0) = event_ms(
            lambda: cuda_adaptive.integrate(rows, m, sc))
        ms, (v1, p1, m1) = event_ms(
            lambda: cuda_adaptive.integrate(rows, m, sc, memo=memo))
        differ = int((v0.view(torch.int64) != v1.view(torch.int64))
                     .any(1).sum()) + int((p0 != p1).sum())
        stats = memo.stats[-1].tolist() \
            if memo.last in ("fill", "read") else None
        launches.append({"route": memo.last, "ms": ms, "plain_ms": plain_ms,
                         "differ": differ, "miller": int(m1.sum()),
                         "plain_miller": int(m0.sum()),
                         "nodes_memo_full": stats})
    routes = [r["route"] for r in launches]
    check(routes == ["first", "fill"] + ["read"] * (len(seq) - 2),
          f"the memo's routes along the solve: {routes}")
    check(all(r["differ"] == 0 for r in launches),
          "the memo's launches equal the memo-free ones bit for bit: "
          f"{[r['differ'] for r in launches]} integrals differ")
    reads = [r for r in launches if r["route"] == "read"]
    hits = [r["nodes_memo_full"][0] / sum(r["nodes_memo_full"])
            for r in reads]
    return {"launches": launches, "integrals": int(m.numel()),
            "memoised": memo.n, "memo_bytes": memo.bytes,
            "read_ms": statistics.median(r["ms"] for r in reads),
            "fill_ms": launches[1]["ms"],
            "plain_ms": statistics.median(r["plain_ms"] for r in launches),
            "read_hit_share_min": min(hits),
            "read_hit_share_mean": statistics.mean(hits)}


def native_phases(torch, card, certified_omega):
    """Phases 27-28: N1 against its plain version on the card, and the
    reference-exact solves through the port's modules; returns N1's entry of
    the kernels JSON."""
    from emme_tpu_torch import from_config, native
    from emme_tpu_torch.ops import adaptive, cuda_adaptive, linalg
    from emme_tpu_torch.ops.singularity import singularity_coeff_matrix
    from emme_tpu_torch.solvers import eigen_native

    dog = watchdog(NATIVE_TIME_LIMIT_S, "native phases")
    cmp = {}
    for name, om in (("tokamak", GUESS), ("stellarator", STEL_GUESS)):
        p = from_config(load_cfg(name, N_TOK))
        check(p.device.type == "cuda" and p.dtype == torch.float64,
              f"{name}: float64 on the card by default")
        # every integral of one assembly, as eigen_native.solve launches it
        iu, ju = torch.triu_indices(N_TOK, N_TOK, 1, device=p.device)
        rows, m, grid, ph = native.pair_integrals(p, iu, ju)
        k = 3 if p.electromagnetic else 1
        ends = adaptive.pair_rows(ph, grid[iu].repeat_interleave(k),
                                  grid[ju].repeat_interleave(k))
        check(torch.equal(rows.view(torch.int64), ends.view(torch.int64)),
              f"{name}: N1's rows, g and b_i gathered from the grid, are "
              f"pair_rows' of the pairs' ends bit for bit")
        del ends
        sc = adaptive.scalars(ph, om)
        k_ms, (got, panels, miller) = timed(
            lambda: cuda_adaptive.integrate(rows, m, sc), torch)
        shape = dict(cuda_adaptive.LAST_LAUNCH)
        digests = {"values_digest": digest(got + 0.0),
                   "panels_digest": digest(panels),
                   "miller_digest": digest(miller)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref, rpanels, rmiller = adaptive.integrate_ref(rows, m, sc)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        check(got.is_cuda and bool(torch.isfinite(got).all()),
              f"{name}: N1 finite on the card")
        diff = torch.linalg.vector_norm(got - ref, dim=1)
        rel = diff / torch.linalg.vector_norm(ref, dim=1)
        flips = int((panels != rpanels).sum())
        miller_differ = int((miller != rmiller).sum())
        scale = float(ref.abs().max())
        max_abs = float(diff.max())
        bit_equal = float((got == ref).all(dim=1).double().mean())
        check(flips == 0 and miller_differ == 0,
              f"N1 vs plain, {name}: {flips} of {m.numel()} integrals split "
              f"differently, {miller_differ} differ in Miller steps")
        check(max_abs < NATIVE_BAR * scale,
              f"N1 vs plain, {name}: {max_abs:.3e} < {NATIVE_BAR} x "
              f"{scale:.3e}")
        flop = cuda_adaptive.flop_count(panels, miller, ph.gk_order)
        bnd = bound(N1_BYTES_PER_INTEGRAL * m.numel(), flop, F64_OPS_PER_S)
        coeff = singularity_coeff_matrix(N_TOK)
        asm_ms, M = timed(lambda: native.assemble(p, coeff, om), torch)
        check(M.is_cuda and M.dtype == torch.complex128
              and bool(torch.isfinite(M).all()), f"{name}: assembly finite")
        plan = native.assembly_plan(p, coeff)
        planned_ms, M_plan = timed(
            lambda: native.assemble(p, coeff, om, plan=plan), torch)
        check(torch.equal(torch.view_as_real(M_plan).view(torch.int64),
                          torch.view_as_real(M).view(torch.int64)),
              f"{name}: the planned assembly's M is the unplanned one's, "
              f"bit for bit")
        check(plan.rows.shape == rows.shape and torch.equal(
            plan.rows.view(torch.int64), rows.view(torch.int64))
              and torch.equal(plan.m, m),
              f"{name}: the plan's N1 rows and moments are pair_integrals'")
        del M, M_plan, plan, got, ref
        memo = native_memo(torch, p, ph, rows, m, om)
        emit("native_memo", case=f"{'tok' if name == 'tokamak' else 'stel'}"
             f"{N_TOK}", **memo, card=card)
        del rows, m
        cmp[name] = {
            "integrals": int(panels.numel()), "max_abs_err": max_abs,
            "scale": scale, "max_rel": float(rel.max()),
            "median_rel": float(rel.median()),
            "median_abs": float(diff.median()),
            "bit_equal_share": bit_equal,
            "flips": flips, "miller_steps_differ": miller_differ,
            "panels": int(panels.sum()),
            "panels_per_integral": float(panels.double().mean()),
            "miller_steps": int(miller.sum()),
            "kernel_ms": k_ms, "plain_ms": plain_ms, **bnd,
            "share_of_bound": bnd["bound_ms"] / k_ms,
            "native_assemble_ms": asm_ms,
            "native_assemble_planned_ms": planned_ms,
            "assembly_route": dict(native.ASSEMBLY_ROUTE),
            "slots": shape["slots"],
            "blocks": shape["blocks"], "registers": shape["registers"],
            "local_bytes": shape["local_bytes"], **digests,
            "memo_read_ms": memo["read_ms"],
            "memo_read_hit_share": memo["read_hit_share_min"]}
        emit("native_vs_plain", case=f"{'tok' if name == 'tokamak' else 'stel'}"
             f"{N_TOK}", order=ph.gk_order, max_subdivide=ph.max_subdivide,
             moments=[0, 1, 2] if p.electromagnetic else [0], **cmp[name],
             card=card)

    # 28. native_slice: the reference-exact solves, counted
    slices = {}
    launches = 0
    for name, om0, golden in (("stellarator", STEL_GUESS, NATIVE_STEL1024),
                              ("tokamak", GUESS, GOLDEN_TOK1024)):
        p = from_config(load_cfg(name, N_TOK))
        cuda_adaptive.LAUNCHES = 0
        singular = linalg.NULL_VECTOR_ROUTE["singular"]
        route = dict(native.ASSEMBLY_ROUTE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        om, vec, n_steps, M = eigen_native.solve(p, om0, tol=1e-6)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n_launch = cuda_adaptive.LAUNCHES
        launches += n_launch
        rel = abs(om - golden) / abs(golden)
        residual = float(torch.linalg.vector_norm(M @ vec)
                         / torch.linalg.matrix_norm(M))
        # the null vector (inverse iteration on M^H M) against the SVD's
        svd_vec = torch.linalg.svd(M)[2][-1].conj()
        c = torch.vdot(svd_vec, vec)
        svd_dist = float(torch.linalg.vector_norm(vec - c / c.abs() * svd_vec))
        slices[name] = {"omega": [om.real, om.imag], "rel_err": rel,
                        "steps": n_steps, "seconds": secs,
                        "launches": n_launch}
        extra = {}
        if name == "tokamak":
            extra["certified_f32_rel_diff"] = (
                abs(certified_omega - om) / abs(om))
        emit("native_slice", case=f"{'tok' if name == 'tokamak' else 'stel'}"
             f"{N_TOK} eigen_native.solve float64", omega=[om.real, om.imag],
             golden=[golden.real, golden.imag], rel_err=rel, steps=n_steps,
             seconds=secs, launches=n_launch, residual=residual,
             svd_vector_distance=svd_dist, dim=M.shape[0],
             assembly_route=dict(native.ASSEMBLY_ROUTE), **extra, card=card)
        check(M.is_cuda and vec.is_cuda and M.dtype == torch.complex128,
              f"{name}: M and vector complex128 on the card")
        check(bool(torch.isfinite(M).all()) and bool(torch.isfinite(vec).all()),
              f"{name}: finite M and vector")
        check(n_launch == 2 + n_steps,
              f"{name}: N1 launches {n_launch} == 2 + {n_steps} steps")
        check(linalg.NULL_VECTOR_ROUTE["singular"] == singular + 1,
              f"{name}: one null vector by inverse iteration on M^H M")
        check(native.ASSEMBLY_ROUTE == dict(
            route, plans=route["plans"] + 1,
            planned=route["planned"] + 2 + n_steps,
            memo_fills=route["memo_fills"] + 1,
            memo_reads=route["memo_reads"] + n_steps),
              f"{name}: one plan, 2 + {n_steps} planned assemblies, the "
              f"memo filled once and read {n_steps} times: "
              f"{native.ASSEMBLY_ROUTE} after {route}")
        check(svd_dist <= 1e-11,
              f"{name}: null vector {svd_dist:.3e} <= 1e-11 from the SVD's")
        check(n_steps == NATIVE_STEPS[name],
              f"{name}: {n_steps} steps == {NATIVE_STEPS[name]}")
        check(rel < NATIVE_SOLVE_BAR,
              f"{name}: omega rel err {rel:.3e} < {NATIVE_SOLVE_BAR}")
        del M, vec
    dog.cancel()
    tok, stel = cmp["tokamak"], cmp["stellarator"]
    return {
        "name": "adaptive_integrals",
        "route": "cuda",
        "source": "emme_tpu_torch/csrc/adaptive.cu",
        "replaces": "native/emme_native.cpp:319",
        "launches": launches,
        "launches_from": f"eigen_native.solve stel{N_TOK} "
                         f"({slices['stellarator']['launches']}) + tok{N_TOK} "
                         f"({slices['tokamak']['launches']})",
        "max_abs_err": max(tok["max_abs_err"], stel["max_abs_err"]),
        "ms": tok["kernel_ms"], "plain_ms": tok["plain_ms"],
        "bound_ms": tok["bound_ms"], "bound_by": tok["bound_by"],
        "library_ms": None,
        "ms_at": f"one tok{N_TOK} assembly: {tok['integrals']} integrals, "
                 f"m = 0, G7K15",
        "flips": tok["flips"] + stel["flips"],
        "stel_ms": stel["kernel_ms"], "stel_plain_ms": stel["plain_ms"],
        "stel_bound_ms": stel["bound_ms"],
        "stel_ms_at": f"one stel{N_TOK} assembly: {stel['integrals']} "
                      f"integrals, m = 0, 1, 2, G15K31",
        "native_assemble_ms": {"tok": tok["native_assemble_ms"],
                               "stel": stel["native_assemble_ms"]},
        "native_assemble_planned_ms": {
            "tok": tok["native_assemble_planned_ms"],
            "stel": stel["native_assemble_planned_ms"]},
        "assembly_route": dict(native.ASSEMBLY_ROUTE),
        "solve_seconds": {k: v["seconds"] for k, v in slices.items()},
    }


def mesh_slice_rank(workdir, single, cli_device="auto"):
    """One rank of phase 26 (spawned by parallel.mesh.launch, NCCL, one
    card): the collectives, then the three mesh paths through the command
    line (``--device cli_device``; "cpu" rehearses the phase on gloo
    ranks); rank 0 returns what it measured."""
    import torch
    from emme_tpu_torch import cli
    from emme_tpu_torch.ops import cuda_kappa
    from emme_tpu_torch.parallel import mesh as mesh_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = mesh_mod.make_mesh()
    R, row, dev = mesh.n_rows, mesh.row, mesh.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    coll = {}
    for dtype in (torch.complex64, torch.complex128):
        xs = [(torch.arange(5) + complex(r, 1)).to(dtype) for r in range(R)]
        x = xs[row].to(dev)
        zero = torch.zeros(5, dtype=dtype)
        got = {"gather": (mesh_mod.all_gather(x, mesh), torch.stack(xs)),
               "psum": (mesh_mod.psum(x, mesh), sum(xs)),
               "broadcast": (mesh_mod.broadcast(x, mesh), xs[0]),
               "right": (mesh_mod.ppermute(x, mesh, +1),
                         xs[row - 1] if row > 0 else zero),
               "left": (mesh_mod.ppermute(x, mesh, -1),
                        xs[row + 1] if row + 1 < R else zero)}
        coll[str(dtype)] = {k: bool(a.device == dev and a.dtype == dtype
                                    and torch.equal(a.cpu(), b))
                            for k, (a, b) in got.items()}
    jobs = {
        "sparse": (dict(load_cfg("tokamak", N_BAND), method="eigen",
                        eigen_backend="sparse",
                        band_deta=BAND_KW["band_deta"],
                        initial_guess=[BAND_GUESS.real, BAND_GUESS.imag],
                        iteration_precision=BAND_KW["tol"])),
        "dense": dict(load_cfg("tokamak", N_TOK), method="eigen",
                      initial_guess=[GUESS.real, GUESS.imag],
                      iteration_precision=SOLVE_TOL),
        "pic": dict(load_cfg("tokamak", N_TOK), method="PIC",
                    marker_per_cell=PIC_MPC, step_number=PIC_STEPS,
                    time_step=PIC_DT, stream_fields=False,
                    initial_guess=[GUESS.real, GUESS.imag]),
    }
    out = {"rows": R, "device": str(dev), "collectives": coll}
    for name, cfg in jobs.items():
        path = pathlib.Path(workdir) / f"{name}.json"
        if row == 0:
            path.write_text(json.dumps(dict(cfg, mesh={"rows": R})))
        mesh_mod.psum(torch.zeros(1, device=dev), mesh)   # the file is there
        cuda_kappa.LAUNCHES = 0
        sync()
        t0 = time.perf_counter()
        cli.main([str(path), "-o", str(pathlib.Path(workdir) / name),
                  "--f32", "--no-checkpoint", "-q", "--device", cli_device])
        sync()
        seconds = time.perf_counter() - t0
        launches = cuda_kappa.LAUNCHES
        if row == 0:
            doc = json.loads((pathlib.Path(workdir) / name
                              / "output.json").read_text())
            res = doc["result"]["(None)"]["scan_result"][0]
            out[name] = {"seconds": seconds, "k1_launches": launches,
                         "omega": res["eigenvalue"],
                         "steps": res.get("iteration_steps"),
                         "sparse_stats": res.get("sparse_stats"),
                         "vector_len": len(res["eigenvector"]),
                         "single_device_seconds": single[name]}
    return out if row == 0 else None


def mesh_slice_phase(torch, card):
    """Phase 26: the mesh paths over NCCL with one rank a card; returns
    K1's launches in the ranks."""
    from emme_tpu_torch.parallel import mesh as mesh_mod

    R = torch.cuda.device_count()
    single = {"sparse": SINGLE["band_seconds"],
              "dense": SINGLE["slice_seconds"],
              "pic": SINGLE["pic_plain_seconds"]}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        got = mesh_mod.launch(mesh_slice_rank, R, "cuda", args=(tmp, single),
                              deadline=MESH_DEADLINE_S)[0]
        spawn_s = time.perf_counter() - t0
    for dtype, ok in got["collectives"].items():
        check(all(ok.values()), f"NCCL collectives on {dtype}: {ok}")
    sp, de, pc = got["sparse"], got["dense"], got["pic"]
    om_sp = complex(*sp["omega"])
    rel_dense = abs(om_sp - SINGLE["band_dense_omega"]) / abs(
        SINGLE["band_dense_omega"])
    rel_banded = abs(om_sp - SINGLE["band_omega"]) / abs(SINGLE["band_omega"])
    om_de = complex(*de["omega"])
    rel_golden = abs(om_de - GOLDEN_TOK1024) / abs(GOLDEN_TOK1024)
    om_pc = complex(*pc["omega"])
    d_om = abs(om_pc.real - GOLDEN_PIC.real) / abs(GOLDEN_PIC.real)
    d_gam = abs(om_pc.imag - GOLDEN_PIC.imag) / abs(GOLDEN_PIC.imag)
    emit("mesh_slice", rows=R, device=got["device"], spawn_seconds=spawn_s,
         collectives=got["collectives"],
         sparse={**sp, "rel_vs_dense_f32": rel_dense,
                 "rel_vs_banded_phase14": rel_banded},
         dense={**de, "rel_vs_golden": rel_golden},
         pic={**pc, "rel_vs_golden": [d_om, d_gam]}, card=card)
    check(sp["sparse_stats"]["mesh_rows"] == R and sp["vector_len"] == N_BAND,
          f"the sparse job ran the SPIKE solve over {R} rows")
    check(rel_dense < BAND_BAR, f"mesh SPIKE tok{N_BAND} vs the dense float32 "
                                f"omega {rel_dense:.3e} < {BAND_BAR}")
    check(rel_golden < SOLVE_BAR, f"mesh dense tok{N_TOK} vs golden "
                                  f"{rel_golden:.3e} < {SOLVE_BAR}")
    check(d_om < 0.05 and d_gam < 0.10,
          f"mesh PIC fit {om_pc} within 5 % / 10 % of golden {GOLDEN_PIC}")
    check(sp["k1_launches"] > 0 and de["k1_launches"] > 0,
          "K1 launched in the ranks")
    return {"launches": sp["k1_launches"] + de["k1_launches"],
            "from": f"mesh_slice over {R} rank(s): sparse tok{N_BAND} "
                    f"({sp['k1_launches']}) + dense tok{N_TOK} "
                    f"({de['k1_launches']})"}


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
    with ThreadPoolExecutor(4) as pool:
        builds = {name: pool.submit(_build.build, name)
                  for name in ("kappa", "pic", "spmv", "adaptive")}
        builds = {name: f.result() for name, f in builds.items()}
    emit_build("build", builds["kappa"])
    emit_build("build_adaptive", builds["adaptive"])

    dev = torch.device("cuda")
    f32 = torch.float32

    # 3. kernel vs plain
    p = from_config(load_cfg("tokamak", N_TOK), dtype=f32)
    check(p.device.type == "cuda", "from_config lands on the card by default")
    grid = Grid.create(p.length, p.npoints, dtype=f32)
    check(grid.eta.is_cuda, "Grid.create lands on the card by default")
    tiers = eigen.discretization(p, f32)[0]
    groups = eigen.pair_plan(p.npoints, tiers, str(grid.eta.device))["groups"]
    omega = torch.tensor(GUESS, dtype=torch.complex64, device=dev)
    rows = []
    for t, (iu, ju, spec) in enumerate(groups):
        quad = kernels.scaled_quad(None, f32, spec)
        r = compare(p, grid.eta[iu], grid.eta[ju], omega, (0,), quad, ES_BAR,
                    torch, cuda_kappa, hold_to_f64=(t == 0))
        rows.append(r)
        emit("kernel_vs_plain", case=f"tok{N_TOK}", tier=t, ms_moments=[0], **r)
    ps = from_config(load_cfg("stellarator", N_STEL), dtype=f32)
    gs = Grid.create(ps.length, ps.npoints, dtype=f32)
    iu, ju = torch.triu_indices(ps.npoints, ps.npoints, 1, device=dev)
    r_em = compare(ps, gs.eta[iu], gs.eta[ju],
                   torch.tensor(-1.656 + 2.49j, dtype=torch.complex64,
                                device=dev),
                   (0, 1, 2), None, EM_BAR, torch, cuda_kappa)
    emit("kernel_vs_plain", case=f"stel{N_STEL}", tier=None, ms_moments=[0, 1, 2],
         **r_em)

    # 3b. assembly_routes: the kernels around K1 against the torch route
    assembly_routes_phase(torch, card)
    # 3c. guard_routes: the guard's kernels against its torch route
    guard_routes_phase(torch, card)

    # 4. the slice: the dense float32 TraceSecant solve at n=1024
    def solve():
        return eigen.solve(p, GUESS, tol=1e-5, chunk=16384)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    cuda_kappa.LAUNCHES = 0
    eigen.HOST_READS.update(blocking=0, flag_polls=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    om, vec, n_steps, state = solve()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = cuda_kappa.LAUNCHES
    SINGLE["slice_seconds"] = solve_s
    did, reads = dict(eigen.LAST_SOLVE), dict(eigen.HOST_READS)
    rel = abs(om - GOLDEN_TOK1024) / abs(GOLDEN_TOK1024)
    M = state.M
    residual = float(torch.linalg.vector_norm(M @ vec)
                     / torch.linalg.matrix_norm(M))
    check(did["loop"] == "device", "the card's default is the device loop")
    check(reads["blocking"] == 1,
          f"the device loop reads the host once a solve: {reads}")
    check(launches == len(groups) * (2 + did["queued_steps"]),
          f"K1 launches {launches} == {len(groups)} tiers x (2 + "
          f"{did['queued_steps']} queued steps)")
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
         steps=n_steps, queued_steps=did["queued_steps"], loop=did["loop"],
         host_reads=reads, seconds=solve_s, first_run_seconds=first_s,
         launches=launches, tiers=len(groups), residual=residual, card=card)

    # 5. breakdown of one step's parts at n=1024
    coeff = singularity_coeff_matrix(p.npoints, dtype=f32)
    asm_ms, _ = timed(lambda: eigen.assemble_matrix(
        p, grid, coeff, state.omega, None, 16384, tiers, True), torch)
    lin_ms, _ = timed(lambda: linalg.complex_solve_trace(M, state.dM),
                      torch)
    null_ms, _ = timed(lambda: eigen.null_space(M), torch)
    svd_ms, _ = timed(lambda: linalg.null_space_vector(M, "svd"), torch)
    emit("breakdown", assembly_ms=asm_ms, kernel_ms_per_assembly=sum(
        r["kernel_ms"] for r in rows), trace_solve_ms=lin_ms,
         null_vector_ms=null_ms, svd_ms=svd_ms, card=card)

    k1_dense = dense_phases(torch, card, p, state)
    del state, M
    n1 = native_phases(torch, card, k1_dense["certify_omega"])
    pic_kernels = pic_phases(torch, builds["pic"], card)
    k5, k1_banded = banded_phases(torch, builds["spmv"], card)
    drv_launches, drv_from = driver_phases(torch, card, om,
                                           k1_dense["certify_seconds"])
    k2_large, k3_large, large_launches = pic_large_grid_phase(torch, card)
    k1_arnoldi = dense_arnoldi_phase(torch, card)
    k1_windows = mesh_window_phase(torch, card)
    k1_mesh = mesh_slice_phase(torch, card)

    k1_bound = bound(sum(r["bytes"] for r in rows),
                     sum(r["flop"] for r in rows))
    k1_stel_bound = bound(sum(r["bytes"] for r in k1_dense["stel_rows"]),
                          sum(r["flop"] for r in k1_dense["stel_rows"]))
    kernels_line = {"kernels": [{
        "name": "kappa_pairs",
        "route": "cuda",
        "source": "emme_tpu_torch/csrc/kappa.cu",
        "replaces": "emme_tpu/ops/pallas_kappa.py:241",
        "launches": launches + k1_dense["launches"] + k1_banded["launches"]
        + k1_arnoldi["launches"] + k1_windows["launches"]
        + k1_mesh["launches"],
        "launches_from": f"eigen.solve tok{N_TOK} ({launches}) + host64 "
                         f"({k1_dense['certify_launches']}) + stel{N_TOK} "
                         f"host64 ({k1_dense['stel_launches']}) + "
                         f"sparse_eigen.solve tok{N_BAND} "
                         f"({k1_banded['launches']}) + "
                         f"{k1_arnoldi['from']} + assemble_bdia_window "
                         f"tok{N_BAND}, {MESH_ROWS} windows "
                         f"({k1_windows['launches']}) + {k1_mesh['from']}",
        "max_abs_err": max([r["max_abs_err"] for r in rows]
                           + [r_em["max_abs_err"], k1_dense["max_abs_err"],
                              k1_banded["max_abs_err"]]),
        "ms": sum(r["kernel_ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": k1_bound["bound_ms"], "bound_by": k1_bound["bound_by"],
        "library_ms": None, "nodes": sum(r["nodes"] for r in rows),
        "flop_per_unit": k1_bound["bound_flop"] / sum(r["nodes"] for r in rows),
        "static_flop_per_unit": K1_FLOP_PER_NODE["static"],
        "ms_at": f"one tok{N_TOK} assembly, all tiers",
        "stel_ms": sum(r["kernel_ms"] for r in k1_dense["stel_rows"]),
        "stel_plain_ms": sum(r["plain_ms"] for r in k1_dense["stel_rows"]),
        "stel_bound_ms": k1_stel_bound["bound_ms"],
        "stel_ms_at": f"one stel{N_TOK} assembly, all tiers, three moments",
    }] + pic_kernels + [k5, n1]}
    # the large-grid runs of K2, K3 and K4 (phase 23)
    for k in kernels_line["kernels"]:
        extra = {"pic_stage": k2_large, "pic_mega": k3_large}.get(k["name"],
                                                                   {})
        k.update(extra)
        if k["name"] in large_launches:
            k["launches"] += large_launches[k["name"]]
            k["launches_from"] += (f" + npoints "
                                   f"{', '.join(map(str, LARGE_NF))} "
                                   f"({large_launches[k['name']]})")
    # every kernel's launches on the driver's paths, from input files; N1
    # has none: no input file reaches the reference-exact engine in either
    # package (emme_tpu/driver.py does not call emme_tpu.native)
    field_launches = drv_launches.pop("pic_field")
    for k in kernels_line["kernels"]:
        if k["name"] == n1["name"]:
            continue
        n = drv_launches[k["name"]]
        check(n > 0, f"{k['name']} was launched from an input file")
        k["launches"] += n
        k["launches_from"] += f" + cli: {drv_from[k['name']]}"
        k["driver_launches"] = n
    check(field_launches == drv_launches["pic_stage"],
          "pic_field runs once a pic_stage")
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
