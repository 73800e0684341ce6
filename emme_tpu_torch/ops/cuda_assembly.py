"""Kernels P and Q: the dense float32 assembly of M(omega) on the card,
around K1.

``eigen.assemble_matrix`` takes this route on a CUDA grid with float32
parameters and K1 (``fused``).  An assembly is one launch of P, one K1
launch a tier through ``cuda_kappa._launch`` (unchanged: the same inputs,
the same launch) and one launch of Q, where the torch route launches some
1,000 small kernels:

* P (``csrc/assembly.h::assembly_inputs_kernel``) writes every tier's K1
  inputs, the tensors ``cuda_kappa._prepare`` returns -- the panel mids and
  half-widths, the pair rows [d_eta, beta1, bi(eta), bi(eta')] and the 8
  scalars -- from a ``Plan`` and omega, which it reads on the device;
* Q (``assembly_place_kernel``) applies K1's prefactor, the closed-form
  electron moments of an electromagnetic operator, the singularity
  coefficients and dx, and writes both triangles and the diagonal of M.

A ``Plan`` holds what does not change with omega: the tiers' pairs and
panel counts, g(eta) and bi(eta) at the grid's points, and the parameters'
scalars, each computed by the torch expression the torch route evaluates.
``eigen.solve`` makes one a solve.

Both kernels follow that torch operation for operation, each step rounded
on its own (``csrc/assembly.h``), so P's outputs equal ``_prepare``'s and
Q's M ``eigen._materialize_from_pairs``'s to float32 rounding.  That torch
is the plain version: the CPU route runs it, and the card's tests hold P
and Q to it.  Both kernels live in K1's library (``kappa.cu`` includes
``assembly.h``): one build.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ..utils.timer import span
from . import cuda_kappa, kernels

_F32 = torch.float32

MAX_TIERS = 8          # csrc/assembly.h kMaxTiers
_SCAL = 8              # floats of K1's scalars at the head of P's buffer

# The plan's packed float32 scalars, in the order of csrc/assembly.h Scalar.
SCALARS = ("arc", "qR", "vt", "omega_s_i", "eta_i", "arc4", "beta1",
           "pref_r", "pref_i", "diag_a", "dx", "e1_r", "e1_i", "omega_s_e",
           "c2", "beta1_e", "omega_s_e2", "diag_d")


def _scalars(p, grid):
    """The assembly's omega-free scalars, (len(SCALARS),) float32, each by
    the torch expression of the torch route: ``cuda_kappa._prepare`` and
    ``_finish``, ``kernels.transit_panel_bounds`` (4 arc) and
    ``kappa_f_tau_e``, ``Params.beta_1`` and ``beta_1_e`` (their factors
    before g(eta) - g(eta')), ``eigen._materialize_from_pairs``."""
    qR = p.q * p.R
    ws_i, ws_e, wd = p.omega_s_i, p.omega_s_e, p.omega_d_bar   # once each
    pref = (-1j * qR / (p.vt * math.sqrt(2.0 * math.pi))).to(torch.complex64)
    e1 = -1j * qR / (2.0 * p.vt * p.tau)
    vals = {
        "arc": p.arc_coeff, "qR": qR, "vt": p.vt, "omega_s_i": ws_i,
        "eta_i": p.eta_i, "arc4": 4.0 * p.arc_coeff,
        "beta1": qR / p.vt * wd,
        "pref_r": pref.real, "pref_i": pref.imag,
        "diag_a": 1.0 + 1.0 / p.tau, "dx": grid.dx,
        "e1_r": e1.real, "e1_i": e1.imag, "omega_s_e": ws_e,
        "c2": (p.q**2 * p.R**2) / (2.0 * p.vt**2 * p.tau),
        "beta1_e": qR / p.vt * (wd * ws_e / ws_i),
        "omega_s_e2": ws_e * (1.0 + p.eta_e),
        "diag_d": (2.0 * p.tau) / p.beta_e,
    }
    return torch.stack([torch.as_tensor(vals[k]).to(_F32).reshape(())
                        for k in SCALARS])


@dataclass(frozen=True)
class Tier:
    """One tier's pairs (int64 rows i < columns j on the device), its G-K
    order and panel counts, and where P writes its K1 inputs (float offsets
    in the buffer)."""
    iu: torch.Tensor
    ju: torch.Tensor
    order: int
    counts: tuple          # (n_shoulder, n_osc, n_tail)
    mid: int
    halfw: int
    pair: int

    @property
    def npairs(self) -> int:
        return int(self.iu.shape[0])

    @property
    def n_panels(self) -> int:
        return sum(self.counts)


@dataclass(frozen=True)
class Plan:
    """What an assembly needs besides omega and the coefficients."""
    n: int
    ms: tuple
    points: torch.Tensor    # (3, n) float32: eta, g(eta), bi(eta)
    scalars: torch.Tensor   # (len(SCALARS),) float32
    tiers: tuple            # of Tier
    size: int               # floats in P's buffer
    meta: np.ndarray        # the tiers for the launchers, int64

    def inputs(self, buf, t: Tier):
        """Tier ``t``'s K1 inputs in P's buffer ``buf``: (mid, halfw, pair,
        scal), the tensors ``cuda_kappa._prepare`` returns."""
        size = t.npairs * t.n_panels
        return (buf[t.mid:t.mid + size].view(t.npairs, t.n_panels),
                buf[t.halfw:t.halfw + size].view(t.npairs, t.n_panels),
                buf[t.pair:t.pair + 4 * t.npairs].view(t.npairs, 4),
                buf[:_SCAL])


def layout(groups, quad, order: int):
    """The tiers of ``groups`` and P's buffer: ((Tier, ...), floats in the
    buffer, the launchers' int64 meta).  ``groups``: (iu, ju, quad_t) a
    tier, the pairs as int64 tensors and the tier's panel mesh (None:
    ``quad``); ``order``: the G-K order where a mesh names none."""
    groups = list(groups)
    if not 1 <= len(groups) <= MAX_TIERS:
        raise ValueError(f"the kernels take 1 to {MAX_TIERS} tiers, got "
                         f"{len(groups)}")
    preset = kernels.panel_preset(_F32)
    tiers, meta, off = [], [], _SCAL
    for iu, ju, q in groups:
        q = (quad if q is None else q) or {}
        counts = tuple(int(q.get(k, preset[k]))
                       for k in ("n_shoulder", "n_osc", "n_tail"))
        iu, ju = iu.contiguous(), ju.contiguous()
        if iu.dtype != torch.int64 or ju.dtype != torch.int64:
            raise ValueError("tier pairs must be int64")
        size = int(iu.shape[0]) * sum(counts)
        pair = -(-(off + 2 * size) // 4) * 4   # 16-byte rows
        t = Tier(iu=iu, ju=ju, order=int(q.get("order", order)),
                 counts=counts, mid=off, halfw=off + size, pair=pair)
        tiers.append(t)
        meta += [iu.data_ptr(), ju.data_ptr(), t.npairs, *counts, t.mid,
                 t.halfw, t.pair]
        off = pair + 4 * t.npairs
    return tuple(tiers), off, np.asarray(meta, dtype=np.int64)


def point_rows(p, grid):
    """What P reads besides the pairs and omega: the (3, n) point rows
    eta, g(eta), bi(eta) at the grid's points, float32, and the packed
    scalars (``SCALARS``)."""
    eta = grid.eta.to(_F32)
    points = torch.stack([eta, p.g(eta).to(_F32),
                          p.bi(eta).to(_F32)]).contiguous()
    return points, _scalars(p, grid)


def build_plan(p, grid, groups, quad=None) -> Plan:
    """The plan of ``grid``'s assemblies.  ``groups``: (iu, ju, quad_t) a
    tier, the pairs as int64 tensors on the grid's device and the tier's
    panel mesh (``kernels.scaled_quad``; None: ``quad``).  Made on any
    device; only the kernels need the card."""
    tiers, size, meta = layout(groups, quad, p.integration_start_points)
    points, scalars = point_rows(p, grid)
    return Plan(n=grid.npoints,
                ms=(0, 1, 2) if p.electromagnetic else (0,),
                points=points, scalars=scalars, tiers=tiers, size=size,
                meta=meta)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _library():
    lib, _record = _build.load("kappa")
    if lib.assembly_inputs_launch.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.assembly_inputs_launch.argtypes = [vp, ci, ci, vp, vp, vp, vp,
                                               vp]
        lib.assembly_inputs_launch.restype = ci
        lib.assembly_place_launch.argtypes = [vp, vp, ci, ci, ci, vp, vp,
                                              vp, vp, vp, vp]
        lib.assembly_place_launch.restype = ci
    return lib


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"assembly kernel {what} failed: CUDA error {err}")


def _card(plan: Plan, omega):
    """The plan's card, and omega as the kernels read it there: a complex64
    0-d tensor."""
    device = plan.points.device
    if device.type != "cuda":
        raise ValueError(f"kernels P and Q run on a CUDA device, the plan "
                         f"is on {device}")
    return device, torch.as_tensor(omega, dtype=torch.complex64,
                                   device=device).reshape(())


def inputs(plan: Plan, omega) -> torch.Tensor:
    """Kernel P: every tier's K1 inputs in one float32 buffer (read them
    with ``plan.inputs``)."""
    device, omega = _card(plan, omega)
    buf = torch.empty(plan.size, dtype=_F32, device=device)
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        _check(_library().assembly_inputs_launch(
            plan.meta.ctypes.data, len(plan.tiers), plan.n,
            plan.points.data_ptr(), plan.scalars.data_ptr(), omega.data_ptr(),
            buf.data_ptr(), stream), "P")
    return buf


def place(plan: Plan, outs, coeff, omega) -> torch.Tensor:
    """Kernel Q: M (dim, dim) complex64 from the tiers' K1 outputs
    ``outs`` ((npairs, 2 len(ms)) float32 each) and ``coeff`` (n, n) on
    the plan's card."""
    device, omega = _card(plan, omega)
    em = len(plan.ms) == 3
    dim = plan.n * (2 if em else 1)
    coeff = coeff.to(_F32).contiguous()
    if tuple(coeff.shape) != (plan.n, plan.n) or coeff.device != device:
        raise ValueError(f"coeff must be ({plan.n}, {plan.n}) on {device}")
    if len(outs) != len(plan.tiers):
        raise ValueError(f"{len(outs)} K1 outputs for {len(plan.tiers)} tiers")
    for t, o in zip(plan.tiers, outs):
        if o.device != device or o.dtype != _F32 or not o.is_contiguous() \
                or tuple(o.shape) != (t.npairs, 2 * len(plan.ms)):
            raise ValueError("K1 outputs must be contiguous float32 "
                             "(npairs, 2 len(ms)) a tier")
    M = torch.empty((dim, dim), dtype=torch.complex64, device=device)
    ptrs = np.asarray([o.data_ptr() for o in outs], dtype=np.int64)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _check(_library().assembly_place_launch(
            plan.meta.ctypes.data, ptrs.ctypes.data, len(plan.tiers),
            plan.n, int(em), plan.points.data_ptr(), plan.scalars.data_ptr(),
            omega.data_ptr(), coeff.data_ptr(), M.data_ptr(), stream), "Q")
    return M


def assemble(plan: Plan, coeff, omega) -> torch.Tensor:
    """M(omega) on the card: P, K1 a tier, Q.  The spans are the torch
    route's: ``assembly.pairs`` around P and the K1 calls, ``assembly.place``
    around Q."""
    omega = _card(plan, omega)[1]
    with span("assembly.pairs"):
        buf = inputs(plan, omega)
        outs = [cuda_kappa._launch(*plan.inputs(buf, t), t.order, plan.ms)
                for t in plan.tiers]
    with span("assembly.place"):
        return place(plan, outs, coeff, omega)
