"""Parameter-scan driver: the port's equivalent of the reference's
``main()`` (``src/main.cpp:182-338``).  Counterpart of
``emme_tpu/driver.py``.

Any top-level input value of the form ``{"head": h, "step": s, "tail": t}``
(or ``"tail": [t_l, t_r]``) declares a scan dimension (main.cpp:225-242).
The bidirectional scan generator walks head -> tail, then restarts toward the
other tail (main.cpp:139-172), carrying eigenvalue continuation: each point
seeds the next with its converged omega; on direction flip the omega re-seeds
from the first result; failures record ``{"eigenvalue": "NaN", "reason"}``
and the scan continues (main.cpp:262-324).

Additions over the reference: checkpoint/resume of completed scan points, a
selectable output directory and device, the timer's report, and a
parallel scan mode (``scan_workers > 1``) that keeps the seeding rule of the
JAX package's wavefront batches (see ``_run_scan_parallel``).

Everything runs on the CUDA card unless the caller names another device
(``device="cpu"``).  The multi-device paths (``mesh_rows`` / ``mesh_scan``
or the input key ``"mesh": {"rows": R, "scan": S}``) run the job SPMD over
R x S ranks of a ``torch.distributed`` group (``parallel/mesh.py``): NCCL
with one rank a card, or gloo between CPU processes with
``device="cpu"``.  There is no fallback to the CPU: more ranks than cards
raise.  Every input key of the JAX package's driver is read here, the
sorted-window PIC path (``"pic_sorted"``) and every CIC form of
``gather_method`` / ``deposit_method`` included.
"""

from __future__ import annotations

import concurrent.futures
import itertools
import json
import math
import os
import pathlib
import threading
import warnings

import numpy as np
import torch

from . import params as params_mod
from .grid import Grid
from .ops.sparse import save_bdia_dump
from .parallel import mesh as mesh_mod
from .parallel import sharded, spike
from .solvers import cuda_pic, eigen, eigen_native, pic, sparse_eigen
from .utils import debug as debug_mod
from .utils import provenance
from .utils.timer import Timer, host_read, section, span


def _is_scan_spec(v) -> bool:
    return isinstance(v, dict) and "head" in v and "step" in v and "tail" in v


def scan_values(spec) -> tuple[list[float], list[bool]]:
    """Materialize the reference's bidirectional scan walk
    (main.cpp:139-172, 225-242).  Returns (values, turning_flags)."""
    head = float(spec["head"])
    step = float(spec["step"])
    tail = spec["tail"]
    if isinstance(tail, list):
        left_tail, right_tail = float(tail[0]), float(tail[1])
    else:
        left_tail = float(tail)
        right_tail = head + 0.5 * math.copysign(step, head - left_tail)

    values, turning = [], []

    def within(cur, cur_tail):
        # the reference's 0.01*|step| slack absorbs float error (main.cpp:151)
        return abs(cur - head) <= abs(cur_tail - head) + 0.01 * abs(step)

    cur, cur_tail = head, left_tail
    first = True
    flipped = False
    while True:
        if not first:
            cur += math.copysign(step, cur_tail - head)
        first = False
        if within(cur, cur_tail):
            values.append(cur)
            turning.append(False)
        else:
            if flipped:
                break
            flipped = True
            cur_tail = right_tail
            cur = head + math.copysign(step, cur_tail - head)
            if not within(cur, cur_tail):
                break
            values.append(cur)
            turning.append(True)
    return values, turning


def filter_input(cfg: dict) -> dict:
    """Replace scan specs by their head value (main.cpp:174-180)."""
    out = dict(cfg)
    for k, v in out.items():
        if _is_scan_spec(v):
            out[k] = v["head"]
    return out


def _typed_array(vec) -> list:
    """Complex vector -> [[re, im], ...] matching the reference's typed-array
    output extension (JsonParser.h:260-278)."""
    v = host_read(vec.detach().cpu).numpy()
    return [[float(x.real), float(x.imag)] for x in v]


def solve_once_eigen(cfg: dict, omega_guess: complex, matrix_file=None,
                     dtype=torch.float64, device=None, quad=None,
                     chunk: int = 2048, host64: bool = False, mesh=None):
    """One eigen-method solve (main.cpp:19-80).  Returns the single-result
    object and the converged omega for continuation.

    Config surface beyond the reference: ``eigen_backend`` ('dense' |
    'sparse', the never-dense block-banded solve | 'exact', below),
    ``iteration_method``,
    ``quad_tiered``, ``fused_assembly`` (kernel integrals through the CUDA
    kernel K1; default on for float32), ``eigen_timers`` (the dense loop's
    per-phase sections), ``band_deta``, ``band_block``, ``m_krylov``,
    ``spmv_method`` ('bdia' | 'bsr', the CUDA kernel K5), ``quad_guard``
    ('warn' | 'refine' | 'off').  ``device=None`` is the CUDA card.

    ``mesh`` (a ``parallel.mesh.Mesh``; every rank of it calls this): the
    dense backend assembles pair-sharded (``parallel/sharded.solve``,
    TraceSecant only), the sparse backend runs the distributed SPIKE
    Newton solve (``parallel/spike.solve``); the solve runs on the mesh's
    device and rank 0 of its ``rows`` axis writes the dump.

    ``eigen_backend`` 'exact': the reference-exact engine,
    ``eigen_native.solve`` (every kernel integral an adaptive
    Gauss-Kronrod integral in float64 to the input's
    ``integration_*`` keys, kernel N1 on a card), TraceSecant or QRSecant
    to ``iteration_precision``.  float64 only (another ``dtype`` raises);
    no mesh form (a mesh raises); no quadrature guard, which tests static
    panel meshes this backend never uses: the result's
    ``quadrature_guard`` says it did not run.  ``quad``, ``chunk`` and
    ``host64`` have nothing to set there.  The result has the dense
    backend's fields and eigenvector convention."""
    _check_mesh(mesh)
    if mesh is not None:
        device = mesh.device
    with span("driver.params"):
        p = params_mod.from_config(cfg, dtype=dtype, device=device)
    tol = float(cfg.get("iteration_precision", 1e-6))

    backend = cfg.get("eigen_backend", "dense")
    method = cfg.get("iteration_method", "TraceSecant")
    if backend == "exact":
        if dtype != torch.float64:
            raise ValueError(f"eigen_backend 'exact' is float64 only, got "
                             f"{dtype}")
        if mesh is not None:
            raise ValueError("eigen_backend 'exact' has no mesh form")
    stats: dict = {}
    with section("Iteration"):
        if backend == "sparse":
            # block-banded end-to-end path: the dense operator never exists;
            # with a mesh the distributed SPIKE Newton solve (QRSecant routes
            # to the distributed bordered update, as on the single-device
            # banded path).  ``chunk`` sizes the torch integrand's pair
            # chunks; through K1 the kernel table keeps its own call size
            # (2M pairs): with 2,048 pairs a call a tok1024 solve made 2,568
            # launches and took 6.8 s instead of 0.3 s on an H100
            fused = eigen.discretization(p, dtype, False,
                                         cfg.get("fused_assembly"))[1]
            kw = dict(tol=tol, quad=quad, chunk=None if fused else chunk,
                      host64=host64, method=method,
                      band_deta=cfg.get("band_deta"),
                      block=cfg.get("band_block"),
                      tiered=cfg.get("quad_tiered"), fused=fused, stats=stats)
            if mesh is not None:
                omega, vec, n_steps, M_dump = spike.solve(p, omega_guess,
                                                          mesh, **kw)
            else:
                omega, vec, n_steps, state = sparse_eigen.solve(
                    p, omega_guess, m_krylov=int(cfg.get("m_krylov", 0)),
                    spmv=cfg.get("spmv_method"), **kw)
                M_dump = state.M
        elif backend == "dense" and mesh is not None:
            if method != "TraceSecant":
                # the column-pivoted QR's pivot sweep is a sequential
                # whole-matrix recursion with no row-sharded form that keeps
                # the reference trajectory (the JAX package's error)
                raise ValueError(
                    "mesh-sharded dense solve supports "
                    f"iteration_method='TraceSecant' only, got {method!r}; "
                    "QRSecant is single-device on the dense backend "
                    "(sequential pivoted-QR recursion) -- use "
                    "eigen_backend='sparse' for a distributed bordered "
                    "iteration")
            omega, vec, n_steps, state = sharded.solve(
                p, omega_guess, mesh, tol=tol, quad=quad, chunk=chunk,
                host64=host64)
            M_dump = state.M
        elif backend == "dense":
            omega, vec, n_steps, state = eigen.solve(
                p, omega_guess, tol=tol, quad=quad, chunk=chunk,
                method=method, host64=host64,
                tiered=cfg.get("quad_tiered"),
                timed=bool(cfg.get("eigen_timers", False)),
                fused=cfg.get("fused_assembly"))
            M_dump = state.M
        elif backend == "exact":
            omega, vec, n_steps, M_dump = eigen_native.solve(
                p, omega_guess, tol=tol, method=method)
        else:
            raise ValueError(
                "eigen_backend must be 'dense', 'sparse' or 'exact', got "
                f"{backend!r}")
    debug_mod.check_finite("omega", omega)
    debug_mod.check_finite("eigenvector", vec)
    debug_mod.check_finite("operator M(omega)", M_dump)

    with section("Output"):
        if matrix_file is not None and _leader(mesh):
            if backend == "sparse":
                # banded dump: the BDIA planes (the dense matrix never
                # existed) + JSON sidecar; load_bdia_dump reads it back
                save_bdia_dump(M_dump, matrix_file)
            else:
                M_dump.cpu().numpy().astype(np.complex128).tofile(matrix_file)

    # runtime quadrature-accuracy guard: check the static panel mesh against
    # the reference's own adaptive acceptance criterion AT THE CONVERGED
    # omega; warn -- or refine once on a denser mesh -- when an off-golden
    # regime under-resolves.
    guard_mode = cfg.get("quad_guard", "warn")
    guard_stats = None
    if guard_mode not in ("warn", "refine", "off"):
        raise ValueError(
            f"quad_guard must be 'warn', 'refine' or 'off', got {guard_mode!r}")
    if backend == "exact":
        guard_stats = {"run": False, "reason": "adaptive integrals to the "
                       "input's integration keys: no static panel mesh"}
    elif guard_mode != "off":
        with span("driver.guard"):
            grid = Grid.create(p.length, p.npoints, dtype=dtype,
                               device=p.device)
            # guard with the SAME tier meshes assembly used (a tiered f32
            # run evaluates far pairs on 2-4x coarser meshes; guarding only
            # the base mesh would miss their under-resolution) and, on the
            # sparse backend, only the kept band (pairs beyond it are never
            # assembled).  The single-device dense solve returns its tier
            # table and its kernels' plan (the point rows and scalars the
            # guard's kernels read) on its state
            plan = None
            if backend == "dense" and mesh is None:
                tiers, plan = state.tiers, state.plan
            else:
                tiers = eigen.discretization(p, dtype,
                                             cfg.get("quad_tiered"))[0]
            max_dij = None
            if backend == "sparse":
                block, h = stats["block"], stats["h"]
                max_dij = sparse_eigen.em_de_max(p.npoints, h, block) \
                    if p.electromagnetic else (h + 1) * block - 1
            guard_stats = eigen.quadrature_guard(
                p, grid, omega, quad=quad, chunk=chunk, tiers=tiers,
                max_dij=max_dij, fused=cfg.get("fused_assembly"), plan=plan)
        if guard_stats["frac_flagged"] > 0:
            msg = (f"quadrature guard: {guard_stats['frac_flagged']:.1%} of "
                   f"sampled kernel integrals fail the reference acceptance "
                   f"test at omega={omega:.6g} (max_abs_err="
                   f"{guard_stats['max_abs_err']:.3g})")
            if guard_mode == "refine":
                quad2 = eigen.refine_quad(quad, dtype)
                warnings.warn(msg + " -- re-solving on a 2x denser mesh")
                cfg2 = dict(cfg, quad_guard="off")
                res2, omega2 = solve_once_eigen(
                    cfg2, omega, matrix_file=matrix_file, dtype=dtype,
                    device=device, quad=quad2, chunk=chunk, host64=host64,
                    mesh=mesh)
                res2["quadrature_guard"] = dict(guard_stats, refined=True)
                res2["eigenvalue_coarse_mesh"] = [omega.real, omega.imag]
                return res2, omega2
            warnings.warn(msg)

    result = {
        "eigenvalue": [omega.real, omega.imag],
        "eigenvector": _typed_array(vec),
        "iteration_steps": n_steps,
    }
    if guard_stats is not None:
        result["quadrature_guard"] = guard_stats
    if stats:
        result["sparse_stats"] = {
            k: (v if not isinstance(v, complex) else [v.real, v.imag])
            for k, v in stats.items()}
    return result, omega


def fused_pic_ok(dtype, npoints: int, markers: int) -> bool:
    """Whether the fused PIC kernels take a run: float32, npoints % 128 ==
    0 and markers % 1024 == 0 (``emme_tpu/driver.py``'s condition; K2 and K3
    hold any such grid, the largest in device memory)."""
    return dtype == torch.float32 and npoints % 128 == 0 \
        and markers % 1024 == 0


def solve_once_pic(cfg: dict, omega_guess: complex, matrix_file=None,
                   dtype=torch.float64, device=None, seed: int = 0,
                   mesh=None, **_):
    """One PIC-method solve (main.cpp:82-137).

    Config surface beyond the reference: ``pic_backend`` ('auto' | 'fused' |
    'xla': the fused CUDA marker kernels of ``solvers/cuda_pic.py`` against
    the plain PyTorch path, which keeps its input-schema name 'xla';
    'fused' needs float32, npoints % 128 == 0 and markers % 1024 == 0, as
    in ``emme_tpu``; ``fused_pic_ok``), ``pic_precision`` (accepted for the
    schema; every value is exact float32 on the card), ``pic_launch``
    ('auto' | 'single' | 'stages': the whole time loop as ONE cooperative
    launch of kernel K3 against one launch of K2 per RK stage),
    ``gather_method`` ('take' | 'matmul' | 'bf16'), ``deposit_method``
    ('segment' | 'matmul' | 'bf16'; ``pic.gather_cic``, ``pic.deposit``),
    ``pic_timers`` (per-phase Particle Pushing / Field Solve / Diagnostics
    sections), ``pic_sorted`` (the sorted-window marker path,
    ``pic.run_sorted``, with ``pic_resort_every`` (30), ``pic_window``
    (384) and ``pic_chunk_markers`` (8192); a window violation raises
    ``RuntimeError`` unless ``pic_allow_window_violations``, which warns;
    it writes no field dump and runs the plain path on any device, whatever
    ``pic_backend`` says), ``time_step_adaptive`` (embedded-error step
    control, the reference Integrator's step_adaptive that its main() never
    wires up),
    ``stream_fields`` / ``stream_chunk_steps`` (the field dump appended
    during the run; default on when a dump is asked for), ``omega_fit``
    ('peak' | 'peak_views' | 'fft').

    'auto' takes the fused kernels on a CUDA device when the shapes allow
    and no field dump is asked for: it never drops the dump silently, while
    an explicit 'fused' trades the dump for speed.  ``seed`` seeds the
    marker loading's ``torch.Generator`` on the device.

    ``mesh`` (a ``parallel.mesh.Mesh``; every rank of it calls this): the
    markers shard over its ``rows`` axis and the deposited density is
    summed over the ranks (``parallel/sharded.pic_sharded_run``, the plain
    step, as in the JAX package); ``pic_timers`` and the streamed dump keep
    their forms; ``time_step_adaptive`` raises; ``pic_sorted`` and the CIC
    forms are not read (the JAX package's precedence: the mesh comes
    first).  Rank 0 of ``rows`` writes the dump."""
    _check_mesh(mesh)
    if mesh is not None:
        device = mesh.device
    p = params_mod.from_config(cfg, dtype=dtype, device=device)
    mpc = int(cfg["marker_per_cell"])
    nt = int(cfg["step_number"])
    dt = float(cfg["time_step"])

    fits = {"peak": pic.calculate_omega,
            "peak_views": lambda s, dt: pic.calculate_omega(s, dt,
                                                            views=True),
            "fft": pic.calculate_omega_fft}
    fit_name = cfg.get("omega_fit", "peak")
    if fit_name not in fits:
        raise ValueError(
            f"omega_fit must be one of {list(fits)}, got {fit_name!r}")

    adaptive = bool(cfg.get("time_step_adaptive", False))
    stream = bool(cfg.get("stream_fields", True)) and matrix_file is not None
    gen = torch.Generator(device=p.device).manual_seed(seed)
    times = None
    fields = None
    with section("PIC run"):
        if mesh is not None:
            if adaptive:
                # host-driven dt control needs per-step host decisions
                raise ValueError("mesh-sharded PIC does not support "
                                 "time_step_adaptive (host-driven dt "
                                 "control); drop the mesh for adaptive "
                                 "runs")
            if cfg.get("pic_timers"):
                stats, state, fields = sharded.pic_sharded_run_timed(
                    p, mpc, nt, dt, mesh, generator=gen,
                    record_fields=matrix_file is not None)
            elif stream:
                stats, state = sharded.pic_sharded_run_streaming(
                    p, mpc, nt, dt, mesh, matrix_file, generator=gen,
                    chunk_steps=int(cfg.get("stream_chunk_steps", 16)))
            else:
                state, stats = sharded.pic_sharded_run(p, mpc, nt, dt, mesh,
                                                       generator=gen)
        elif adaptive:
            times, stats, state = pic.run_adaptive(
                p, mpc, nt * dt, dt, generator=gen,
                upper_err_bound=float(cfg.get("adaptive_upper_err", 1e-7)),
                lower_err_bound=float(cfg.get("adaptive_lower_err", 1e-10)))
        elif cfg.get("pic_timers"):
            stats, state, fields = pic.run_timed(
                p, mpc, nt, dt, generator=gen,
                record_fields=matrix_file is not None)
        elif cfg.get("pic_sorted"):
            stats, state, viols = pic.run_sorted(
                p, mpc, nt, dt, generator=gen,
                resort_every=int(cfg.get("pic_resort_every", 30)),
                window=int(cfg.get("pic_window", 384)),
                chunk_markers=int(cfg.get("pic_chunk_markers", 8192)))
            if int(viols):
                # a clamped marker deposits at a wrong cell: wrong physics
                msg = (f"pic_sorted: {int(viols)} marker-stage window "
                       "violations (markers clamped to their chunk window "
                       "-- deposits landed at wrong cells); widen "
                       "pic_window or lower pic_resort_every")
                if not cfg.get("pic_allow_window_violations"):
                    raise RuntimeError(msg)
                warnings.warn(msg)
        elif stream:
            # per-step field history flushed DURING the run (parity with
            # main.cpp:105-110: a killed run keeps the flushed steps)
            stats, state = pic.run_streaming(
                p, mpc, nt, dt, matrix_file, generator=gen,
                chunk_steps=int(cfg.get("stream_chunk_steps", 16)),
                gather_method=cfg.get("gather_method"),
                deposit_method=cfg.get("deposit_method"))
        else:
            backend = cfg.get("pic_backend", "auto")
            if backend not in ("auto", "fused", "xla"):
                raise ValueError(f"pic_backend must be auto|fused|xla, "
                                 f"got {backend!r}")
            fused_ok = fused_pic_ok(dtype, int(p.npoints),
                                    mpc * int(p.npoints))
            if backend == "fused" and not fused_ok:
                raise ValueError(
                    "pic_backend='fused' needs f32, npoints % 128 == 0 "
                    "and markers % 1024 == 0")
            # auto never drops the buffered field dump silently; explicit
            # 'fused' trades the dump for speed (streaming runs keep the
            # plain path either way)
            use_fused = backend == "fused" or (
                backend == "auto" and fused_ok and matrix_file is None
                and p.device.type == "cuda")
            if use_fused:
                stats, state, fields = cuda_pic.run(
                    p, mpc, nt, dt, generator=gen,
                    precision=cfg.get("pic_precision", "default"),
                    launch=cfg.get("pic_launch", "auto"))
            else:
                stats, state, fields = pic.run(
                    p, mpc, nt, dt, generator=gen,
                    record_fields=matrix_file is not None,
                    gather_method=cfg.get("gather_method"),
                    deposit_method=cfg.get("deposit_method"))
    debug_mod.check_finite("PIC field", state.field)
    debug_mod.check_finite("PIC field statistics", stats)

    if matrix_file is not None and fields is not None and _leader(mesh):
        debug_mod.check_finite("PIC field history", fields)
        fields.cpu().numpy().astype(np.complex128).tofile(matrix_file)

    # omega_fit: "peak" reproduces the reference's peak-count fit (unsigned
    # frequency, solver_pic.h:514-527); "peak_views" its EMME_USE_VIEWS
    # gamma time-weight convention (solver_pic.h:479-489); "fft" resolves
    # the frequency sign.
    if adaptive:
        omega = pic.calculate_omega_nonuniform(times, stats)
    else:
        omega = fits[fit_name](stats, dt)
    result = {
        "eigenvalue": [omega.real, omega.imag],
        "eigenvector": _typed_array(state.field),
    }
    if adaptive:
        result["adaptive_steps"] = int(len(times))
        result["adaptive_final_time"] = float(times[-1])
    return result, omega_guess  # PIC does not update the continuation seed


_SOLVERS = {"eigen": solve_once_eigen, "PIC": solve_once_pic}


def _check_mesh(mesh):
    if mesh is not None and not isinstance(mesh, mesh_mod.Mesh):
        raise TypeError(f"mesh must be an emme_tpu_torch.parallel.mesh.Mesh, "
                        f"got {type(mesh).__name__}")


def _leader(mesh) -> bool:
    """Whether this rank writes its solve's files: always without a mesh,
    rank 0 of its ``rows`` group with one."""
    return mesh is None or mesh.row == 0


def _mesh_map(mesh, fn, items) -> list:
    """``fn`` over ``items`` on the mesh's scan groups, ``n_scan`` items at
    a time: group g (its ``rows`` ranks together) takes the g-th item of
    each batch.  Every rank gets every result, in item order (rank 0 of
    each group contributes its group's)."""
    out = []
    for b in range(0, len(items), mesh.n_scan):
        batch = items[b:b + mesh.n_scan]
        mine = fn(batch[mesh.scan]) if mesh.scan < len(batch) else None
        got = mesh_mod.all_gather_object(mine if mesh.row == 0 else None,
                                         mesh)
        out.extend(got[g * mesh.n_rows] for g in range(len(batch)))
    return out


def _wavefront(values, turnings, width: int, guess, run_batch) -> list:
    """The continuation-preserving batches: the walk order in batches of
    ``width`` points, every point of a batch seeded from the last converged
    omega of the previous batch; a direction flip starts a new batch
    seeded from the first result (main.cpp:281-291), a failed point resets
    the seed to ``guess``.  ``run_batch(indices, seed)`` returns the
    batch's results; returns every result in walk order."""
    results = []
    omega = guess
    i = 0
    while i < len(values):
        batch = []
        for j in range(i, min(i + width, len(values))):
            if turnings[j] and j > i:
                break
            batch.append(j)
        if turnings[batch[0]]:
            first = results[0] if results else None
            if first and isinstance(first.get("eigenvalue"), list):
                omega = complex(*first["eigenvalue"])
            else:
                omega = guess
        out = run_batch(batch, omega)
        results.extend(out)
        ev = out[-1].get("eigenvalue")
        omega = complex(*ev) if isinstance(ev, list) else guess
        i = batch[-1] + 1
    return results


def _run_scan_parallel(solver, input_cfg, key, spec, guess, outdir, done,
                       record_ckpt, scan_workers, verbose, solver_kw,
                       mode: str = "wavefront", mesh=None):
    """Parallel scan: scan points fan out over ``scan_workers`` threads,
    or over the scan groups of ``mesh`` (``mesh.n_scan`` at a time, each
    point solved over its group's ``rows`` ranks).

    ``mode="wavefront"`` (default) KEEPS eigenvalue continuation -- the
    reference scan's core semantic (main.cpp:263, 281-291): see
    ``_wavefront``.  The seed lags at most ``scan_workers`` points behind,
    vs the sequential walk's one.  ``mode="independent"`` seeds every
    point from the user guess.

    Threads share the one device and its stream, so they keep these
    seeding rules, results in walk order, per-point fault capture and the
    ordered checkpoint, and buy no time: the parallel speed-up of the JAX
    package's form came from one device a worker.  The scan groups of a
    mesh are that form: R x S ranks, one card each."""
    values, turnings = scan_values(spec)
    cfg0 = filter_input(input_cfg)
    lock = threading.Lock()

    def record(value, res):
        with lock:
            done[f"{key}={value!r}"] = res
            snapshot = dict(done)  # shallow: completed entries are not mutated
            seq = record_ckpt.next_seq()   # ordered WITH the snapshot
            if verbose:
                print(f"    {key}:{value}  ->  {res.get('eigenvalue')}")
        # serialize OUTSIDE the lock: dumping full eigenvectors for every
        # completed point is O(scan), and doing it under the global lock
        # would serialize all workers on I/O
        record_ckpt(snapshot, seq)

    def solve_point(j, seed_omega):
        value = values[j]
        with lock:
            if f"{key}={value!r}" in done:
                return done[f"{key}={value!r}"]
        cfg = dict(cfg0)
        cfg[key] = value
        mfile = outdir / "eigenMatrics" / f"{key}Eq{value:.6f}.bin"
        try:
            res, _ = solver(cfg, seed_omega, matrix_file=mfile, **solver_kw)
            res["eigenMatrix"] = str(mfile)
            res["scan_value"] = value
        except Exception as e:  # scan-level fault tolerance
            res = {"eigenvalue": "NaN", "reason": str(e)}
        if mesh is None:
            record(value, res)
        return res

    with concurrent.futures.ThreadPoolExecutor(scan_workers) as ex:
        if mesh is None:
            def run_batch(batch, seed):
                return list(ex.map(lambda j: solve_point(j, seed), batch))
        else:
            def run_batch(batch, seed):
                out = _mesh_map(mesh, lambda j: solve_point(j, seed), batch)
                for j, res in zip(batch, out):
                    record(values[j], res)
                return out
        if mode == "independent":
            results = run_batch(list(range(len(values))), guess)
        else:
            results = _wavefront(values, turnings, scan_workers, guess,
                                 run_batch)
    return {"scan_key": key, "scan_values": list(values),
            "scan_result": results}


def run(input_cfg: dict | str | pathlib.Path, output_dir=".",
        dtype=torch.float64, device=None, checkpoint: bool = True,
        verbose: bool = True, quad=None, chunk: int = 2048,
        host64: bool = False, scan_workers: int = 1,
        scan_mode: str = "wavefront", mesh_rows: int | None = None,
        mesh_scan: int | None = None, debug: bool = False) -> dict:
    """Execute the full (possibly scanning) job; writes output.json and
    binary matrix dumps under ``output_dir``; returns the result object.

    ``device``: None is the CUDA card (and raises where there is none);
    "cpu" runs every solve on the CPU.

    ``scan_mode`` (with scan_workers > 1): "wavefront" keeps eigenvalue
    continuation in batches of scan_workers; "independent" seeds every
    point from the user guess.

    ``"shifts": [[re, im], ...]`` (eigen method): multi-shift run -- every
    shift seeds an independent solve (add ``"m_krylov"`` for a shift-invert
    Arnoldi stage per shift on the sparse backend); results land under
    result["shifts"] in shift order.

    ``debug`` (or the input key ``"debug": true``): input validation before
    any solve and finiteness checks of every result (``utils/debug.py``).

    ``mesh_rows`` (or the input key ``"mesh": {"rows": R}``): every solve
    distributed over R ranks -- the pair-sharded assembly for the dense
    backend, the distributed SPIKE banded Newton solve for the sparse
    backend, marker-sharded deposition for PIC.  ``mesh_scan`` (or
    ``"scan": S`` there): the 2-D topology, R x S ranks in S groups of R;
    scan points (or ``"shifts"``) run S at a time in the wavefront batches
    of ``scan_workers`` = S, each solve over its group.  The ranks are
    spawned here (``parallel.mesh.launch``: NCCL and one card a rank, or
    gloo processes with ``device="cpu"``; more ranks than cards raise
    ``ValueError``) and the result of rank 0 is returned; under torchrun
    the job runs over the initialized group instead.  Rank 0 writes
    output.json and the checkpoint, rank 0 of each group its solves'
    dumps."""
    if scan_mode not in ("wavefront", "independent"):
        raise ValueError(f"scan_mode must be 'wavefront' or 'independent', "
                         f"got {scan_mode!r}")
    if not isinstance(input_cfg, dict):
        with open(input_cfg) as f:
            input_cfg = json.load(f)

    debug = bool(debug or input_cfg.get("debug"))
    if debug:
        # the reference's EMME_DEBUG analogue: input dimension/positivity
        # validation now, finiteness checks of every result later
        debug_mod.validate_problem(
            params_mod.from_config(filter_input(input_cfg), dtype=dtype,
                                   device=device),
            filter_input(input_cfg))

    method = input_cfg.get("method")
    if method not in _SOLVERS:
        raise ValueError(f"Method '{method}' is not supported, yet.")

    mesh_cfg = input_cfg.get("mesh") or {}
    rows = mesh_rows if mesh_rows is not None else mesh_cfg.get("rows")
    scan = int(mesh_scan if mesh_scan is not None
               else mesh_cfg.get("scan", 1))
    kw = dict(output_dir=output_dir, dtype=dtype, checkpoint=checkpoint,
              verbose=verbose, quad=quad, chunk=chunk, host64=host64,
              scan_workers=scan_workers, scan_mode=scan_mode, debug=debug)
    if not rows:
        if scan > 1:
            raise ValueError(f"mesh scan={scan} needs mesh rows: use "
                             "--mesh-rows R or \"mesh\": {\"rows\": R, "
                             "\"scan\": S}")
        return _run(input_cfg, device=device, mesh=None, **kw)
    rows = int(rows)
    if scan_workers > 1 and scan <= 1:
        raise ValueError(
            "mesh with scan_workers > 1 needs an explicit scan axis: "
            'use "mesh": {"rows": R, "scan": S} (the rows and scan '
            "axes partition the same ranks)")
    device = "cuda" if device is None else device
    if mesh_mod.in_group(device):
        mesh = mesh_mod.make_mesh(rows, scan)
        return _run(input_cfg, device=mesh.device, mesh=mesh, **kw)
    return mesh_mod.launch(_run_rank, rows * scan, device=device,
                           args=(input_cfg, rows, scan, kw))[0]


def _run_rank(input_cfg, rows: int, scan: int, kw: dict):
    """One spawned rank of a mesh job: the job over the mesh; rank 0
    returns the result."""
    mesh = mesh_mod.make_mesh(rows, scan)
    result = _run(input_cfg, device=mesh.device, mesh=mesh, **kw)
    return result if mesh.rank == 0 else None


def _run(input_cfg: dict, output_dir, dtype, device, checkpoint, verbose,
         quad, chunk, host64, scan_workers, scan_mode, debug, mesh):
    """The job on this process: alone (``mesh`` None) or as one rank of
    ``mesh``, whose rank 0 writes output.json and the checkpoint."""
    writer = mesh is None or mesh.rank == 0
    verbose = verbose and writer
    method = input_cfg.get("method")
    solver = _SOLVERS[method]
    if mesh is not None and mesh.n_scan > 1:
        scan_workers = mesh.n_scan

    outdir = pathlib.Path(output_dir)
    (outdir / "eigenMatrics").mkdir(parents=True, exist_ok=True)
    ckpt_path = outdir / "checkpoint.json"

    timer = Timer.get_timer()
    timer.start_timing("All")

    guess = complex(input_cfg["initial_guess"][0], input_cfg["initial_guess"][1]) \
        if "initial_guess" in input_cfg else 0j

    result = {
        "input": input_cfg,
        "git_commit_hash": provenance.git_commit_hash(),
        "build_time": provenance.build_time(),
        "run_time": provenance.date_string(),
        "framework": "emme_tpu_torch",
        "result": {},
    }

    done = {}
    if checkpoint and ckpt_path.exists():
        with open(ckpt_path) as f:
            done = json.load(f)

    scan_config = {k: v for k, v in input_cfg.items() if _is_scan_spec(v)}

    ckpt_seq = itertools.count()
    ckpt_written = [-1]
    ckpt_write_lock = threading.Lock()

    def record_ckpt(snapshot=None, seq=None):
        if checkpoint and writer:
            data = done if snapshot is None else snapshot
            # atomic replace: concurrent writers (scan_workers > 1) can't
            # interleave partial JSON in the checkpoint file.  The O(scan)
            # json.dump stays outside any lock; only the replace is ordered
            # by ``seq`` (taken under the caller's lock with the snapshot)
            # so a slow worker's OLDER snapshot can never overwrite a newer
            # checkpoint -- that would drop completed entries and force
            # their re-solve on resume
            tmp = ckpt_path.with_suffix(f".tmp{threading.get_ident()}")
            with open(tmp, "w") as f:
                json.dump(data, f)
            with ckpt_write_lock:
                if seq is not None and seq <= ckpt_written[0]:
                    os.remove(tmp)   # stale snapshot lost the race
                    return
                os.replace(tmp, ckpt_path)
                if seq is not None:
                    ckpt_written[0] = seq

    record_ckpt.next_seq = lambda: next(ckpt_seq)

    solver_kw = dict(dtype=dtype, device=device, quad=quad, chunk=chunk,
                     host64=host64, mesh=mesh)
    scan_mesh = mesh if mesh is not None and mesh.n_scan > 1 else None
    nan_checks_were_on = debug_mod.nan_checks_enabled()
    if debug:
        debug_mod.enable_nan_checks()
    try:
        shifts = input_cfg.get("shifts")
        if shifts is not None:
            # multi-shift eigensolve: every shift seeds its own solve.  Use
            # "m_krylov" in the input for a shift-invert Arnoldi stage per
            # shift (sparse backend).
            if method != "eigen":
                raise ValueError('"shifts" requires method "eigen"')
            if scan_config:
                raise ValueError('"shifts" and scan dimensions are mutually '
                                 "exclusive (one batch axis per run)")
            sigmas = [complex(s[0], s[1]) for s in shifts]
            cfg0 = filter_input(input_cfg)
            lock = threading.Lock()

            def solve_shift(item):
                i, sig = item
                with lock:
                    if f"shift={i}" in done:   # resume: shifts checkpoint
                        return done[f"shift={i}"]
                mfile = outdir / "eigenMatrics" / f"shift{i}.bin"
                try:
                    res, _ = solver(cfg0, sig, matrix_file=mfile, **solver_kw)
                    res["eigenMatrix"] = str(mfile)
                except Exception as e:  # per-shift fault tolerance
                    res = {"eigenvalue": "NaN", "reason": str(e)}
                res["shift"] = [sig.real, sig.imag]
                return res

            def record_shift(item, res):
                i, sig = item
                ck = f"shift={i}"
                with lock:
                    done[ck] = res
                    snapshot = dict(done)
                    seq = record_ckpt.next_seq()   # ordered WITH the snapshot
                    if verbose:
                        print(f"    shift {sig}  ->  {res.get('eigenvalue')}")
                record_ckpt(snapshot, seq)   # interrupted runs resume

            def one_shift(item):
                ck = f"shift={item[0]}"
                with lock:
                    if ck in done:
                        return done[ck]
                res = solve_shift(item)
                record_shift(item, res)
                return res

            items = list(enumerate(sigmas))
            if scan_mesh is not None:
                out = _mesh_map(scan_mesh, solve_shift, items)
                for it, res in zip(items, out):
                    record_shift(it, res)
            elif scan_workers > 1:
                with concurrent.futures.ThreadPoolExecutor(scan_workers) as ex:
                    out = list(ex.map(one_shift, items))
            else:
                out = [one_shift(it) for it in items]
            result["result"]["shifts"] = {
                "scan_key": "shifts",
                "scan_values": [[s.real, s.imag] for s in sigmas],
                "scan_result": out}
        elif not scan_config:
            unit = {"scan_key": "(None)", "scan_result": []}
            mfile = outdir / "eigenMatrics" / "eigenMatrix.bin"
            res, _ = solver(input_cfg, guess, matrix_file=mfile, **solver_kw)
            unit["scan_result"].append(res)
            result["result"]["(None)"] = unit
        elif scan_workers > 1:
            for key, spec in scan_config.items():
                if verbose:
                    print(f"\nScanning {key} ("
                          + (f"{mesh.n_scan} groups of {mesh.n_rows} ranks"
                             if scan_mesh is not None else
                             f"{scan_workers} workers on one device") + ")")
                result["result"][key] = _run_scan_parallel(
                    solver, input_cfg, key, spec, guess, outdir, done,
                    record_ckpt, scan_workers, verbose, solver_kw,
                    mode=scan_mode, mesh=scan_mesh)
        else:
            for key, spec in scan_config.items():
                cfg = filter_input(input_cfg)
                values, turnings = scan_values(spec)
                unit = {"scan_key": key, "scan_values": [], "scan_result": []}
                omega = guess
                if verbose:
                    print(f"\nScanning {key}")
                for value, turning in zip(values, turnings):
                    cfg[key] = value
                    unit["scan_values"].append(value)
                    if turning:
                        first = unit["scan_result"][0] \
                            if unit["scan_result"] else None
                        if first and isinstance(first.get("eigenvalue"), list):
                            omega = complex(*first["eigenvalue"])
                        else:
                            omega = guess
                    if verbose:
                        print(f"    {key}:{value}")
                    ck = f"{key}={value!r}"
                    mfile = outdir / "eigenMatrics" / f"{key}Eq{value:.6f}.bin"
                    if ck in done:
                        unit["scan_result"].append(done[ck])
                        ev = done[ck].get("eigenvalue")
                        if isinstance(ev, list):
                            omega = complex(*ev)
                        continue
                    try:
                        res, omega = solver(cfg, omega, matrix_file=mfile,
                                            **solver_kw)
                        res["eigenMatrix"] = str(mfile)
                        res["scan_value"] = value
                        if verbose:
                            print(f"        eigenvalue: {res['eigenvalue']}")
                    except Exception as e:  # scan-level fault tolerance
                        res = {"eigenvalue": "NaN", "reason": str(e)}
                        omega = guess
                        if verbose:
                            print(f"        {e}")
                    unit["scan_result"].append(res)
                    done[ck] = res
                    record_ckpt()
                result["result"][key] = unit
    finally:
        if debug and not nan_checks_were_on:
            debug_mod.disable_nan_checks()

    timer.start_timing("Output")
    if writer:
        with open(outdir / "output.json", "w") as f:
            json.dump(result, f, indent=1)
    timer.pause_timing("Output")
    timer.pause_timing("All")
    if verbose:
        print()
        timer.print()
    if checkpoint and writer and ckpt_path.exists():
        ckpt_path.unlink()  # completed cleanly
    return result
