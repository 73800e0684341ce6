"""Process meshes over ``torch.distributed``.

Counterpart of ``emme_tpu/parallel/mesh.py``.  The JAX layer is one
process that holds a ``Mesh`` of N devices and runs ``shard_map`` bodies;
here it is SPMD, torch's own idiom: one process a rank, each holding one
shard, each running the body of the JAX ``shard_fn`` on its local tensors.
The mesh has the JAX package's two named axes:

  * ``rows``: the operator / marker data axis (one shard a rank);
  * ``scan``: independent scan points or shifts, one group of ``rows``
    ranks each.

Rank ``scan * n_rows + row`` holds shard ``row`` of scan group ``scan``.
The collectives are process-group calls -- NCCL between CUDA cards, one
rank a card, and gloo between CPU processes -- and a body is written once
for both.  Complex tensors travel as their real views.

``launch`` spawns the ranks of one job on the local machine and returns
what they return; every run has a deadline, and a rank that fails ends the
run with its traceback (the other ranks are killed, never left waiting in a
collective).  Under ``torchrun`` (a process group already initialized)
nothing is spawned: the mesh is made over that group.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pathlib
import pickle
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

# Seconds a collective may wait for the other ranks before it raises.
PG_TIMEOUT = datetime.timedelta(seconds=60)
# Seconds a spawned run may take before every rank is killed.
DEADLINE_S = 3600.0


def distributed_init(coordinator: str | None = None, num_processes=None,
                     process_id=None, device="cuda"):
    """Join this process to the job's process group (the counterpart of
    ``jax.distributed.initialize``): NCCL for a CUDA ``device``, gloo for
    the CPU.  ``coordinator``: an init method (``tcp://host:port``,
    ``file:///path``; a bare ``host:port`` is taken as TCP), or None for
    torchrun's environment.  On a CUDA device the rank's card becomes the
    current one (``LOCAL_RANK``, else the rank modulo the visible cards)."""
    cuda = torch.device(device).type == "cuda"
    if coordinator is None:
        init_method = "env://"
    elif "://" in coordinator:
        init_method = coordinator
    else:
        init_method = f"tcp://{coordinator}"
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=PG_TIMEOUT)
    if cuda:
        local = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)


def in_group(device="cuda") -> bool:
    """Whether this process is a rank of an initialized group; a process
    that torchrun started (RANK and WORLD_SIZE in its environment) joins
    its group here first."""
    if not dist.is_initialized() and "RANK" in os.environ \
            and "WORLD_SIZE" in os.environ:
        distributed_init(device=device)
    return dist.is_initialized()


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``rows`` x ``scan`` mesh: its coordinates,
    the process groups of its two axes (with their global ranks, in axis
    order) and its device."""
    n_rows: int
    n_scan: int
    row: int
    scan: int
    rows_group: Any
    scan_group: Any
    rows_ranks: tuple
    scan_ranks: tuple
    device: torch.device

    @property
    def shape(self) -> dict:
        return {"rows": self.n_rows, "scan": self.n_scan}

    @property
    def rank(self) -> int:
        return self.scan * self.n_rows + self.row

    def group(self, axis: str):
        return self.rows_group if axis == "rows" else self.scan_group

    def ranks(self, axis: str) -> tuple:
        return self.rows_ranks if axis == "rows" else self.scan_ranks

    def index(self, axis: str) -> int:
        return self.row if axis == "rows" else self.scan

    def size(self, axis: str) -> int:
        return self.n_rows if axis == "rows" else self.n_scan


def make_mesh(n_rows: int | None = None, n_scan: int = 1) -> Mesh:
    """The ``rows`` x ``scan`` mesh over the initialized process group
    (every rank calls it, in the same order as its other group calls).
    ``n_rows`` None takes the world size over ``n_scan``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group: "
                           "call it in a rank of launch(...) or under "
                           "torchrun")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_rows is None:
        n_rows = world // n_scan
    if n_rows * n_scan != world:
        raise ValueError(f"mesh rows={n_rows} x scan={n_scan} needs "
                         f"{n_rows * n_scan} ranks, the process group has "
                         f"{world}")
    row, scan = rank % n_rows, rank // n_rows

    def groups(rank_lists):
        if len(rank_lists) == 1:
            return dist.group.WORLD, tuple(rank_lists[0])
        mine = None
        for ranks in rank_lists:          # every rank makes every group
            g = dist.new_group(ranks, timeout=PG_TIMEOUT)
            if rank in ranks:
                mine = (g, tuple(ranks))
        return mine

    rows_group, rows_ranks = groups(
        [list(range(g * n_rows, (g + 1) * n_rows)) for g in range(n_scan)])
    scan_group, scan_ranks = groups(
        [list(range(r, world, n_rows)) for r in range(n_rows)])
    if "nccl" in str(dist.get_backend()):
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return Mesh(n_rows=n_rows, n_scan=n_scan, row=row, scan=scan,
                rows_group=rows_group, scan_group=scan_group,
                rows_ranks=rows_ranks, scan_ranks=scan_ranks, device=device)


# ---------------------------------------------------------------------------
# collectives: stand-ins for jax.lax.axis_index / all_gather / psum /
# ppermute inside a shard_map body
# ---------------------------------------------------------------------------

def _real(x):
    return torch.view_as_real(x) if x.is_complex() else x


def axis_index(mesh: Mesh, axis: str = "rows") -> int:
    return mesh.index(axis)


def all_gather(x, mesh: Mesh, axis: str = "rows", dim: int = 0,
               tiled: bool = False):
    """Every rank's ``x`` along ``axis``, in axis order: stacked on a new
    ``dim``, or concatenated along ``dim`` when ``tiled``."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size(axis))]
    dist.all_gather([_real(t) for t in parts], _real(x),
                    group=mesh.group(axis))
    return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)


def psum(x, mesh: Mesh, axis: str = "rows"):
    """The sum of every rank's ``x`` along ``axis``, on every rank."""
    y = x.clone().contiguous()
    dist.all_reduce(_real(y), group=mesh.group(axis))
    return y


def broadcast(x, mesh: Mesh, axis: str = "rows"):
    """Index 0's ``x`` on every rank of ``axis``: the ranks then take the
    same decisions from the same values."""
    y = x.clone().contiguous()
    dist.broadcast(_real(y), mesh.ranks(axis)[0], group=mesh.group(axis))
    return y


def ppermute(x, mesh: Mesh, shift: int, axis: str = "rows"):
    """Shard i of the result is shard i - ``shift``'s ``x``: ``shift`` +1
    sends every shard to its right neighbour, -1 to its left.  Shards with
    no sender receive zeros -- the global edges, as ``jax.lax.ppermute``
    with the open chain of ``emme_tpu/parallel/sharded.py``."""
    n, i = mesh.size(axis), mesh.index(axis)
    ranks, group = mesh.ranks(axis), mesh.group(axis)
    x = x.contiguous()
    y = torch.zeros_like(x)
    ops = []
    if 0 <= i + shift < n:
        ops.append(dist.P2POp(dist.isend, _real(x), ranks[i + shift], group))
    if 0 <= i - shift < n:
        ops.append(dist.P2POp(dist.irecv, _real(y), ranks[i - shift], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return y


def all_gather_object(obj, mesh: Mesh) -> list:
    """Every rank's picklable ``obj``, in global rank order."""
    out = [None] * (mesh.n_rows * mesh.n_scan)
    dist.all_gather_object(out, obj)
    return out


# ---------------------------------------------------------------------------
# spawning the ranks of a job
# ---------------------------------------------------------------------------

def _rank_main(fn, args, rank, world, device_type, tmp):
    """One spawned rank: join the group, run ``fn``, leave its result -- or
    its exception, the time it was raised and its traceback, then exit at
    once -- in ``tmp``."""
    out = pathlib.Path(tmp)
    try:
        torch.set_num_threads(1)
        distributed_init(f"file://{out / 'store'}", world, rank,
                         device=device_type)
        result = fn(*args)
        with open(out / f"rank{rank}.tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(out / f"rank{rank}.tmp", out / f"rank{rank}.pkl")
        dist.barrier()
        dist.destroy_process_group()
    except BaseException as e:
        raised = time.time()
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        try:
            with open(out / f"rank{rank}.exc", "wb") as f:
                pickle.dump((raised, e), f)
        except (pickle.PicklingError, TypeError, AttributeError):
            pass      # an exception that does not pickle: the traceback stays
        # the process boundary: record, then end at once -- a failed rank
        # never waits on its group, and the launcher reports the failure
        os._exit(1)


def _first_exception(tmp: pathlib.Path, n_ranks: int):
    """The exception a failed rank raised first (the others mostly saw
    their collective break after it), or None."""
    found = []
    for r in range(n_ranks):
        try:
            with open(tmp / f"rank{r}.exc", "rb") as f:
                found.append(pickle.load(f))
        except (OSError, EOFError, pickle.UnpicklingError, AttributeError,
                ImportError):
            continue
    return min(found, key=lambda t: t[0])[1] if found else None


def launch(fn, n_ranks: int, device="cuda", args=(),
           deadline: float | None = None) -> list:
    """Run ``fn(*args)`` on ``n_ranks`` spawned ranks of one
    process group (NCCL and one card a rank for a CUDA ``device``, gloo for
    the CPU; the rendezvous is a file in a temporary directory) and return
    their results in rank order.  ``fn`` must be importable from a module
    that imports no JAX (the spawned child imports it; a script that
    launches needs the ``if __name__ == "__main__":`` guard of every
    spawned start).  Each collective waits at most ``PG_TIMEOUT``; the run
    at most ``deadline`` seconds (default ``DEADLINE_S``): past it, or as soon
    as one rank fails, every rank is killed.  A failed run re-raises the
    exception its first failing rank raised, caused by a RuntimeError that
    holds every failed rank's traceback; a run past its deadline raises
    that RuntimeError.

    In a rank of a group already initialized, or started by torchrun
    (``in_group``), nothing is spawned: ``fn`` runs here and the list holds
    this rank's result."""
    deadline = DEADLINE_S if deadline is None else deadline
    device = torch.device(device)
    if in_group(device):
        return [fn(*args)]
    if device.type == "cuda":
        have = torch.cuda.device_count()
        if n_ranks > have:
            raise ValueError(f"{n_ranks} ranks on CUDA need {n_ranks} cards "
                             f"(one rank a card), {have} visible")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="emme_mesh_") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, args, r, n_ranks, device.type, tmp),
                             daemon=True)
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        end = time.monotonic() + deadline
        try:
            while True:
                codes = [p.exitcode for p in procs]
                if all(c == 0 for c in codes):
                    why = None
                    break
                if any(c not in (None, 0) for c in codes):
                    why = "a rank failed"
                    break
                if time.monotonic() > end:
                    alive = [r for r, c in enumerate(codes) if c is None]
                    why = (f"ranks {alive} still running after the "
                           f"deadline of {deadline} s")
                    break
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
            for p in procs:
                p.join(10)
        tmp = pathlib.Path(tmp)
        if why is not None:
            report = []
            for r, p in enumerate(procs):
                err = tmp / f"rank{r}.err"
                if err.exists():
                    report.append(f"--- rank {r} ---\n{err.read_text()}")
                elif p.exitcode not in (0, -9):
                    report.append(f"--- rank {r} exited with code "
                                  f"{p.exitcode} and left no traceback "
                                  "(its standard error is above)")
            failure = RuntimeError(f"mesh launch of {n_ranks} ranks on "
                                   f"{device.type} ended: {why}; every rank "
                                   "was killed\n" + "\n".join(report))
            first = _first_exception(tmp, n_ranks) if why == "a rank failed" \
                else None
            if first is None:
                raise failure
            raise first from failure
        results = []
        for r in range(n_ranks):
            with open(tmp / f"rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
    return results
