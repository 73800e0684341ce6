"""Kernels G and R: the quadrature guard on the card, in K1's library.

``eigen.quadrature_guard`` takes this route where an assembly takes the
kernels (``eigen.kernel_route``: a CUDA grid, float32 parameters, K1).  A
guard there is four steps, where the torch route launches some 5,200
kernels and reads the host a dozen times at n = 1024:

* kernel P (``csrc/assembly.h``, unchanged) writes the panel and pair rows
  of every set: a set is one tier group of the sampled pairs on one mesh,
  the base mesh for every group and, beside it, the group's tier mesh
  where the tier table makes it coarser;
* kernel G (``csrc/guard.h::guard_pairs_kernel``) writes, for each pair of
  each set and each moment, the Kronrod sum and the summed per-panel
  |K - G| from one evaluation of K1's integrand a node;
* kernel R (``guard_report_kernel``) forms each sampled pair's |K|, error
  and tier gap in float32 and the report from them in float64, as the
  plain version (``eigen.guard_pairs`` and ``eigen.guard_report``) does;
* one host read of R's three numbers.

``pair_values`` reads G's rows in torch as R does, for the checks.

A ``Plan`` holds what depends on the sample alone -- the sets' pairs and
panel counts, P's layout, each sampled pair's rows in G's output -- and
``eigen`` makes one once for a guard's arguments.  What depends on the
request (the point rows and scalars P reads, omega) comes with each call;
an assembly plan of the same parameters and grid has them.

``LAUNCHES`` counts G's and R's launches.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ..utils.timer import host_read
from . import cuda_assembly, cuda_kappa, kernels, quadrature

# kernel launches made here (G and R) since the caller last set it to 0
LAUNCHES = 0

_F32 = torch.float32


@dataclass(frozen=True)
class Plan:
    """The guard's sample laid out for P, G and R on one card."""
    n: int
    ms: tuple
    order: int
    tiers: tuple           # cuda_assembly.Tier a set
    size: int              # floats in P's buffer
    meta: np.ndarray       # the sets for the launchers, int64
    rows: torch.Tensor     # (n_sampled, 2) int32: base row, tier row or -1

    @property
    def n_sampled(self) -> int:
        return int(self.rows.shape[0])

    @property
    def total(self) -> int:
        """G's output rows: every set's pairs."""
        return sum(t.npairs for t in self.tiers)

    def inputs_plan(self, points, scalars) -> cuda_assembly.Plan:
        """The assembly plan P reads for this sample: the sets as tiers,
        with a request's point rows and scalars."""
        return cuda_assembly.Plan(n=self.n, ms=self.ms, points=points,
                                  scalars=scalars, tiers=self.tiers,
                                  size=self.size, meta=self.meta)


def build_plan(n: int, ms, groups, iu, ju, quad, order: int,
               device) -> Plan:
    """The plan of a sample: ``iu``, ``ju`` its pairs (numpy), ``groups``
    (index array, tier spec) in the plain version's order, ``quad`` the
    base mesh, ``order`` the G-K order where the mesh names none."""
    dev = torch.device(device)
    sets, rows = [], []
    off = 0
    for idx, spec in groups:
        a = torch.as_tensor(iu[idx], dtype=torch.int64, device=dev)
        b = torch.as_tensor(ju[idx], dtype=torch.int64, device=dev)
        sets.append((a, b, None))
        base = off + np.arange(len(idx))
        off += len(idx)
        tier = np.full(len(idx), -1)
        if spec != 1.0:
            sets.append((a, b, kernels.scaled_quad(quad, _F32, spec)))
            tier = off + np.arange(len(idx))
            off += len(idx)
        rows.append(np.stack([base, tier], axis=1))
    tiers, size, meta = cuda_assembly.layout(sets, quad, order)
    if len({t.order for t in tiers}) != 1:
        raise ValueError("the guard's meshes must share one G-K order")
    return Plan(n=n, ms=tuple(ms), order=tiers[0].order, tiers=tiers,
                size=size, meta=meta,
                rows=torch.as_tensor(np.concatenate(rows).astype(np.int32),
                                     device=dev))


@functools.lru_cache(maxsize=4)
def rule_tables(order: int) -> np.ndarray:
    """G's constant table: K1's (``cuda_kappa.kernel_tables``) then the
    embedded Gauss weights padded to 31 (``csrc/guard.h`` struct Rule)."""
    _x, _wk, wg = quadrature.gk_rule(order)
    tab = np.concatenate([cuda_kappa.kernel_tables(order),
                          np.pad(wg, (0, cuda_kappa.MAX_ORDER - order))])
    tab = tab.astype(np.float32)
    tab.setflags(write=False)
    return tab


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _library():
    lib, _record = _build.load("kappa")
    if lib.guard_pairs_launch.argtypes is None:
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.guard_pairs_launch.argtypes = [vp, ci, vp, vp, ci, ci, ci, ci,
                                           ci, vp, ci, vp]
        lib.guard_pairs_launch.restype = ci
        lib.guard_report_launch.argtypes = [vp, vp, ci, ci, vp, cd, cd, vp,
                                            vp]
        lib.guard_report_launch.restype = ci
    return lib


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"guard kernel {what} failed: CUDA error {err}")


def pairs(plan: Plan, buf) -> torch.Tensor:
    """Kernel G on P's buffer ``buf``: (plan.total, 3 len(ms)) float32,
    each set's rows in turn: [re, im of each moment, embedded error of
    each moment], without K1's prefactor."""
    global LAUNCHES
    device = buf.device
    if device.type != "cuda" or buf.dtype != _F32 \
            or tuple(buf.shape) != (plan.size,):
        raise ValueError(f"kernel G takes P's float32 buffer of "
                         f"{plan.size} on a CUDA device")
    out = torch.empty((plan.total, 3 * len(plan.ms)), dtype=_F32,
                      device=device)
    tab = rule_tables(plan.order)
    m = list(plan.ms) + [0] * (3 - len(plan.ms))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _check(_library().guard_pairs_launch(
            plan.meta.ctypes.data, len(plan.tiers), buf.data_ptr(),
            out.data_ptr(), plan.order, len(plan.ms), m[0], m[1], m[2],
            tab.ctypes.data, tab.size, stream), "G")
    LAUNCHES += 1
    return out


def report(plan: Plan, out, scalars, accuracy: float,
           precision: float) -> torch.Tensor:
    """Kernel R on G's rows ``out``: (3,) float64 on the card, [flagged,
    max_abs_err, max_rel_err]."""
    global LAUNCHES
    device = out.device
    if out.dtype != _F32 or not out.is_contiguous() \
            or tuple(out.shape) != (plan.total, 3 * len(plan.ms)):
        raise ValueError("kernel R takes G's contiguous float32 rows")
    if scalars.device != device or scalars.dtype != _F32 \
            or tuple(scalars.shape) != (len(cuda_assembly.SCALARS),):
        raise ValueError(f"kernel R takes the plan's float32 scalars on "
                         f"{device}")
    rep = torch.empty(3, dtype=torch.float64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _check(_library().guard_report_launch(
            out.data_ptr(), plan.rows.data_ptr(), plan.n_sampled,
            len(plan.ms), scalars.data_ptr(), float(accuracy),
            float(precision), rep.data_ptr(), stream), "R")
    LAUNCHES += 1
    return rep


def pair_values(plan: Plan, out, scalars):
    """G's rows ``out`` read per sampled pair as kernel R reads them, in
    torch: |K|, the embedded error and the tier gap (0 where the pair's
    group keeps the base mesh), each (n_sampled, len(ms)) float32 with
    K1's prefactor, in the order of ``eigen.guard_pairs``.  With
    ``eigen.guard_report`` the plain version of R on G's own rows."""
    nm = len(plan.ms)
    i_r, i_i = (cuda_assembly.SCALARS.index(k) for k in ("pref_r", "pref_i"))
    pref = torch.complex(scalars[i_r], scalars[i_i])
    rows = plan.rows.long()

    def values(r):
        return pref * torch.complex(r[:, 0:2 * nm:2], r[:, 1:2 * nm:2])

    base = out[rows[:, 0]]
    v = values(base)
    gap = (values(out[rows[:, 1].clamp_min(0)]) - v).abs()
    gap = torch.where(rows[:, 1:] >= 0, gap, torch.zeros_like(gap))
    return v.abs(), pref.abs() * base[:, 2 * nm:], gap


def guard(plan: Plan, points, scalars, omega, accuracy: float,
          precision: float) -> dict:
    """The guard's report on the card: P, G, R and one host read.
    ``points``, ``scalars``: the request's point rows and scalars
    (``cuda_assembly.point_rows``, or an assembly plan's)."""
    buf = cuda_assembly.inputs(plan.inputs_plan(points, scalars), omega)
    rep = report(plan, pairs(plan, buf), scalars, accuracy, precision)
    flagged, max_abs, max_rel = host_read(rep.tolist)
    return {
        "n_sampled": plan.n_sampled,
        "frac_flagged": int(flagged) / max(plan.n_sampled, 1),
        "max_abs_err": max_abs,
        "max_rel_err": max_rel,
    }
