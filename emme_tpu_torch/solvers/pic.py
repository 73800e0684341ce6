"""delta-f particle-in-cell initial-value solver along a field line.

Counterpart of ``emme_tpu/solvers/pic.py``: the plain path and the reference
trajectory for the CUDA kernels of ``solvers/cuda_pic.py``.  Markers live in
structure-of-arrays form as complex/real tensors; the CIC gather is an
indexed load and the CIC deposition two ``index_add_``; the time loop is a
Python loop over RK3 steps.

Behaviour kept from the reference (``include/solver_pic.h``):
  * j0 / drift-center pull-back start at ZERO and are (re)computed during
    each field solve (solver_pic.h:34-47, 269-273), so the first RK stage
    sees j0 == 0.
  * the 3-stage low-storage RK tableau (solver_pic.h:466-470).
  * cell_width = 2 L / npoints (NOT the eigen grid's 2 L/(npoints-1)).
  * the tokamak-form drift frequencies from the parameters
    (solver_pic.h:361-370), whatever the geometry.
  * random numbers come from an explicit ``torch.Generator``; they are not
    the JAX package's, so trajectory tests start both packages from one
    state (``convert.pic_state_from_arrays``) and golden comparisons are
    statistical in (omega, gamma).

``run_streaming`` appends every step's field to a file during the run and
``run_timed`` brackets the phases of a step with timer sections; both take
this plain path, as the JAX package's do.

The CIC gather is an indexed load of a per-cell table and the deposit a
scatter-add.  The JAX package's CIC forms all run here so: its 'matmul'
one-hot product has a single non-zero term a row, so it is the same load
and sums; 'bf16' rounds the table or the deposited parts to bfloat16 as its
bf16 product does.  ``run_sorted`` is the sorted-window
marker path (markers sorted by eta, each chunk's CIC confined to a window
of W cells, violations counted and clamped) computed with indexed loads and
``index_add_`` in place of the TPU's per-window one-hot contractions.
``run_jitted`` is not ported: ``run`` has its role.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from ..ops.bessel import bessel_i01_scaled, bessel_j0, bessel_j1
from ..utils.timer import host_read, section, sync

# Low-storage RK tableau (reference solver_pic.h:466-470).
RK_COEF = np.array([
    [1.0, 0.62653829327080, 0.0, 0.0],
    [0.0, 1.0, -0.55111240553326, 0.0],
    [0.0, 1.5220585509963, -0.52205855099628, 0.92457411226246],
    [1.0, 0.13686116839369, -1.1368611683937, 0.0],
])

_COMPLEX = {torch.float64: torch.complex128, torch.float32: torch.complex64}


@dataclass
class PICState:
    eta: Any          # (n,) marker position along field line
    v_para: Any       # (n,) constant
    v_perp: Any       # (n,) constant
    weight: Any       # (n,) complex
    omega_dv: Any     # (n,) velocity dependence of magnetic drift freq
    omega_st: Any     # (n,) diamagnetic drift freq
    p_weight: Any     # (n,) Fm/g normalization
    j0: Any           # (n,) gyroaverage, recomputed each field solve
    dc_pb: Any        # (n,) drift-center pull-back operator
    field: Any        # (nf,) complex


def cell_width(p):
    return 2.0 * p.length / p.npoints


def quasi_neutrality_coef(p, dtype=torch.float64):
    """1 / ((1 + 1/tau - Gamma0(b)) * cell_width), Gamma0 = I0(b) e^{-b}
    (solver_pic.h:372-391), cast back to ``dtype``."""
    cw = cell_width(p)
    idx = torch.arange(p.npoints, dtype=dtype, device=p.device)
    b = p.b_theta * (1.0 + (p.shat * (idx * cw - p.length)) ** 2)
    i0s, _, _ = bessel_i01_scaled(b.to(dtype).to(_COMPLEX[dtype]))
    gamma0 = i0s.real   # I0(b) e^{-b} for real b >= 0
    return (1.0 / ((1.0 + 1.0 / p.tau - gamma0) * cw)).to(dtype)


def state_from_draws(p, eta, z_para, z_perp, w0, dtype=torch.float64) -> PICState:
    """Marker loading from its random draws (solver_pic.h:180-236): ``eta``
    uniform on [-L, L), ``z_para``/``z_perp`` standard normal, ``w0``
    uniform on [0, 0.001).  v_perp = |normal|, water-bag reweighted p_weight
    normalized to 2L / sum; j0, dc_pb and the field start at zero."""
    n = eta.shape[0]
    cdtype = _COMPLEX[dtype]
    dev = eta.device
    v_para = z_para * p.vt / torch.sqrt(p.water_bag_weight_vpara)
    v_perp = torch.abs(z_perp * p.vt / torch.sqrt(p.water_bag_weight_vperp))
    weight = w0.to(cdtype)

    vt2 = p.vt * p.vt
    omega_dv = (v_para**2 + 0.5 * v_perp**2) / (2.0 * vt2)
    omega_st = p.omega_s_i * (
        1.0 + p.eta_i * ((v_para**2 + v_perp**2) / (2.0 * vt2) - 1.5))
    p_weight = v_perp * torch.exp(
        -(v_para**2 * (1.0 - p.water_bag_weight_vpara)
          + v_perp**2 * (1.0 - p.water_bag_weight_vperp)) / (2.0 * vt2))
    p_weight = p_weight * (2.0 * p.length / torch.sum(p_weight))

    return PICState(
        eta=eta, v_para=v_para, v_perp=v_perp, weight=weight,
        omega_dv=omega_dv, omega_st=omega_st, p_weight=p_weight,
        j0=torch.zeros(n, dtype=dtype, device=dev),
        dc_pb=torch.zeros(n, dtype=cdtype, device=dev),
        field=torch.zeros(p.npoints, dtype=cdtype, device=dev))


def _nonzero_normal(n: int, **kw):
    """Standard normal draws none of which is exactly 0.  A v_para of 0
    puts the drift-center phase q R / v_para at infinity and its marker's
    deposit at NaN.  On a CUDA device torch draws float32 normals in
    Box-Muller pairs from u = x 2^-32 + 2^-33, which rounds to 1.0 for the
    top 128 of the 2^32 values of x: both draws of the pair are then 0,
    once in 2^25 pairs, so a run of 16.8M markers (npoints 16,384 at 1024
    markers a cell) holds such a pair a quarter of the time.  Zero draws
    are drawn again, from the same generator."""
    z = torch.randn(n, **kw)
    zero = z == 0
    while bool(zero.any()):
        z[zero] = torch.randn(int(zero.sum()), **kw)
        zero = z == 0
    return z


def init_state(p, marker_per_cell: int, generator: torch.Generator,
               dtype=torch.float64) -> PICState:
    """Marker loading with draws from ``generator`` (on p's device)."""
    n = marker_per_cell * p.npoints
    kw = dict(generator=generator, dtype=dtype, device=p.device)
    eta = torch.rand(n, **kw) * (2.0 * p.length) - p.length
    z_para = _nonzero_normal(n, **kw)
    z_perp = torch.randn(n, **kw)
    w0 = torch.rand(n, **kw) * 0.001
    return state_from_draws(p, eta, z_para, z_perp, w0, dtype)


def _locate(p, eta):
    cw = cell_width(p)
    x = (eta + p.length) / cw
    idx = torch.floor(x)
    w = x - idx
    return idx.to(torch.int64), w


def _omega_d(p, eta):
    return p.omega_d_bar * (torch.cos(eta) + p.shat * eta * torch.sin(eta))


def _omega_d_integral(p, eta, v_para):
    return ((p.q * p.R / v_para) * p.omega_d_bar
            * (torch.sin(eta) * (1.0 + p.shat) - p.shat * eta * torch.cos(eta)))


_GATHER_METHODS = ("take", "matmul", "bf16")
_DEPOSIT_METHODS = ("segment", "matmul", "bf16")


def _check_method(method, allowed):
    """None or one of ``allowed``.  The JAX package runs its one-hot form
    for any other name; the port raises."""
    if method is not None and method not in allowed:
        raise ValueError(f"unknown CIC form {method!r}: one of "
                         f"{list(allowed)} or None")


def _bf16(t):
    """``t`` rounded to bfloat16 and back to its dtype (each part of a
    complex tensor)."""
    if t.is_complex():
        return torch.view_as_complex(_bf16(torch.view_as_real(t)))
    return t.to(torch.bfloat16).to(t.dtype)


def _field_table(field):
    """(nf, 4) complex CIC table of the periodic field: f[c], f[c+1],
    g[c] = f[c+1] - f[c-1] and g[c+1] (the JAX package's 8 real planes)."""
    fp = torch.roll(field, -1)
    g = fp - torch.roll(field, 1)
    return torch.stack([field, fp, g, torch.roll(g, -1)], dim=-1)


def _blend(rows, w, cw):
    """phi and dphi from gathered table rows (..., 4)."""
    f0, f1, g0, g1 = rows.unbind(-1)
    phi = (1.0 - w) * f0 + w * f1
    dphi = ((1.0 - w) * g0 + w * g1) / (2.0 * cw)
    return phi, dphi


def gather_cic(field, idx, w, nf, cw, method: str | None = None):
    """CIC field gather by an indexed load of the field table: returns
    (phi, dphi) at marker positions; dphi blends the centered difference
    (f[c+1] - f[c-1]) / 2cw (solver_pic.h:96-104).  ``method``: 'take' (the
    default) and 'matmul' are the same load; 'bf16' rounds the table to
    bfloat16 first, which is what the JAX package's bf16 one-hot product
    returns."""
    _check_method(method, _GATHER_METHODS)
    table = _field_table(field)
    if method == "bf16":
        table = _bf16(table)
    return _blend(table[idx % nf], w, cw)


def put_velocity(p, s: PICState, gather_method: str | None = None):
    """d(weight)/dt for every marker (solver_pic.h:82-140)."""
    nf = p.npoints
    cw = cell_width(p)
    x_perp = s.v_perp / p.vt
    sb = torch.sqrt(p.b_theta * (1.0 + (p.shat * s.eta) ** 2))
    dj0 = (-p.b_theta * p.shat**2 * x_perp * s.eta
           * bessel_j1(x_perp * sb) / sb)

    idx, w = _locate(p, s.eta)
    phi, dphi = gather_cic(s.field, idx, w, nf, cw, method=gather_method)

    omega_d = _omega_d(p, s.eta)
    common = (1j * ((s.omega_st - omega_d * s.omega_dv) * s.j0 * phi)
              - s.v_para / (p.q * p.R) * (s.j0 * dphi + dj0 * phi))
    if p.drift_center_transformation_switch:
        return s.p_weight * torch.conj(s.dc_pb) * common
    return (-s.weight * omega_d * s.omega_dv * 1j + s.p_weight * common)


def deposit(den, idx, w, nf, method: str | None = None):
    """CIC charge deposition den -> grid as scatter-adds: both parts of a
    marker land on its cell idx, and the right parts roll by one cell.
    ``method``: 'segment' (the default) and 'matmul' are the same sums;
    'bf16' rounds the parts (re/im x left/right) to bfloat16 first, as the
    JAX package's bf16 one-hot product does."""
    _check_method(method, _DEPOSIT_METHODS)
    left, right = den * (1.0 - w), den * w
    if method == "bf16":
        left, right = _bf16(left), _bf16(right)
    i0 = idx % nf
    zero = torch.zeros(nf, dtype=den.dtype, device=den.device)
    return zero.index_add(0, i0, left) \
        + torch.roll(zero.index_add(0, i0, right), 1)


def solve_field(p, s: PICState, qn_coef, deposit_method: str | None = None,
                density_reduce=None):
    """Charge deposition + quasi-neutrality solve (solver_pic.h:249-354).
    Also refreshes j0 and the drift-center pull-back as the reference does.

    ``density_reduce``: a callable applied to the deposited density before
    the solve (the sum over the ranks when the markers are sharded,
    ``parallel/sharded.py``)."""
    nf = p.npoints
    x_perp = s.v_perp / p.vt
    sb = torch.sqrt(p.b_theta * (1.0 + (p.shat * s.eta) ** 2))
    j0 = bessel_j0(x_perp * sb)
    dc_pb = torch.exp(-1j * _omega_d_integral(p, s.eta, s.v_para) * s.omega_dv)

    den = (j0 * s.weight * dc_pb if p.drift_center_transformation_switch
           else j0 * s.weight)
    idx, w = _locate(p, s.eta)
    d = deposit(den, idx, w, nf, method=deposit_method)
    if density_reduce is not None:
        d = density_reduce(d)
    return replace(s, j0=j0, dc_pb=dc_pb, field=d * qn_coef)


def update(p, s: PICState, velocity, dt, qn_coef,
           deposit_method: str | None = None, density_reduce=None):
    """Push eta (periodic bound to [-L, L)), advance weights, re-solve field
    (solver_pic.h:142-156, 393-396)."""
    eta = s.eta + s.v_para * dt / (p.q * p.R)
    eta = torch.remainder(eta + p.length, 2.0 * p.length) - p.length
    s = replace(s, eta=eta, weight=s.weight + velocity * dt)
    return solve_field(p, s, qn_coef, deposit_method, density_reduce)


def _combo(row, vs):
    """sum_k row[k] v_k over tensors, or elementwise over tuples of them.
    float(): an np.float64 on the left of a tensor product would turn it
    into a numpy array (the JAX package's round-5 promotion bug)."""
    if isinstance(vs[0], (tuple, list)):
        return type(vs[0])(_combo(row, list(parts)) for parts in zip(*vs))
    return sum(float(row[k]) * x for k, x in enumerate(vs))


def rk3_generic(state, velocity_fn, update_fn, dt):
    """3-stage low-storage scheme over an abstract state
    (solver_pic.h:425-435): stage p uses velocity sum_k coef[p][k] v_k and
    substep coef[p][p+1] dt.  Velocities are tensors or tuples of them."""
    v = []
    for stage in range(3):
        v.append(velocity_fn(state))
        state = update_fn(state, _combo(RK_COEF[stage], v),
                          float(RK_COEF[stage][stage + 1]) * dt)
    return state, v


def rk3_error_estimate(v, dt, norm_fn):
    """Embedded error combination sum_k coef[3][k] v_k scaled by dt
    (solver_pic.h:437-457)."""
    return norm_fn(_combo(RK_COEF[3], v), dt)


def rk3_step(p, s: PICState, dt, qn_coef, gather_method: str | None = None,
             deposit_method: str | None = None, density_reduce=None):
    """PIC instantiation of the 3-stage scheme; ``density_reduce`` as in
    ``solve_field``."""
    return rk3_generic(
        s,
        lambda st: put_velocity(p, st, gather_method),
        lambda st, vel, sub_dt: update(p, st, vel, sub_dt, qn_coef,
                                       deposit_method, density_reduce),
        dt)


def field_stats(field):
    """Per-step (mean Re, mean Im, rms) diagnostics (main.cpp:111-118)."""
    return torch.stack([
        torch.mean(field.real),
        torch.mean(field.imag),
        torch.sqrt(torch.mean((field * torch.conj(field)).real))])


def initial_state(p, marker_per_cell: int, generator=None,
                  state: PICState | None = None) -> PICState:
    """``state`` when given, else ``init_state`` in p's dtype with
    ``generator`` (seed 0 on p's device by default)."""
    if state is not None:
        return state
    if generator is None:
        generator = torch.Generator(device=p.device).manual_seed(0)
    return init_state(p, marker_per_cell, generator, dtype=p.dtype)


def run(p, marker_per_cell: int, n_steps: int, dt, generator=None,
        state: PICState | None = None, record_fields: bool = False,
        gather_method: str | None = None, deposit_method: str | None = None,
        density_reduce=None):
    """Full PIC run.  Starts from ``state`` when given, else from
    ``init_state`` with ``generator`` (seed 0 on p's device by default).
    ``density_reduce`` as in ``solve_field``.  Returns (stats (n_steps,
    3), final state, the per-step fields (n_steps, nf) when
    ``record_fields`` else None)."""
    s = initial_state(p, marker_per_cell, generator, state)
    qn_coef = quasi_neutrality_coef(p, dtype=p.dtype)
    stats, fields = [], []
    for _ in range(n_steps):
        s, _v = rk3_step(p, s, dt, qn_coef, gather_method, deposit_method,
                         density_reduce)
        stats.append(field_stats(s.field))
        if record_fields:
            fields.append(s.field)
    return (torch.stack(stats), s,
            torch.stack(fields) if record_fields else None)


# ---------------------------------------------------------------------------
# Sorted-window marker path (emme_tpu/solvers/pic.py:371-614).  Markers are
# sorted by wrapped eta every R steps, so each chunk of C markers spans a few
# cells, and its CIC gather and deposit are confined to a window of W cells
# of an extended grid with G guard cells a side: eta runs UNWRAPPED between
# sorts and the guards take its periodic images.  The guard width comes from
# the realized max |v_para|; a marker that still leaves its window is
# clamped to it AND counted, and the count is returned.  The TPU computes
# each window by one-hot contractions; here the gather is an indexed load
# and the deposit adds into per-chunk window buffers that one index_add_
# lays onto the extended grid.  Same sums; no (n_chunks, C, W) one-hot.
# ---------------------------------------------------------------------------

_RK_SUBSTEP_SUM = float(sum(abs(RK_COEF[s][s + 1]) for s in range(3)))

# What the last ``run_sorted`` chose: re-sort interval R, guard cells G,
# window W, base quantum, chunks, and the number of sorts.
LAST_SORTED: dict = {}

_MARKER_FIELDS = ("v_para", "v_perp", "weight", "omega_dv", "omega_st",
                  "p_weight", "j0", "dc_pb")


def _wrap_eta(p, eta):
    return torch.remainder(eta + p.length, 2.0 * p.length) - p.length


def sort_by_eta(p, s: PICState) -> PICState:
    """Every marker field sorted by wrapped eta (one stable sort, one
    permutation); the field is untouched."""
    eta, perm = torch.sort(_wrap_eta(p, s.eta), stable=True)
    return replace(s, eta=eta,
                   **{k: getattr(s, k)[perm] for k in _MARKER_FIELDS})


def _window_bases(p, eta_sorted, n_chunks: int, W: int, G: int, nfe: int,
                  quant: int = 1):
    """Per-chunk window starts in EXTENDED cell coordinates, centered on
    the chunk's sorted span and floor-quantized to ``quant`` (the JAX
    package buckets its deposit fold by them; the quantum costs <= quant -
    1 cells of right margin)."""
    cw = cell_width(p)
    C = eta_sorted.shape[0] // n_chunks
    idx = torch.floor((eta_sorted + p.length) / cw).to(torch.int64) + G
    first = idx[0::C]
    last = idx[C - 1::C]
    mid = (first + last) // 2
    base = torch.clamp(mid - W // 2, 0, nfe - W - 1)
    if quant > 1:
        base = (base // quant) * quant
    return base


def _field_table_ext(field, G: int):
    """The (nf + 2G + 2, 4) CIC table with G wrapped guard rows left and
    G + 2 right, so unwrapped window indices need no mod."""
    table = _field_table(field)
    return torch.cat([table[-G:], table, table[:G + 2]])


def _window_index(eta, w0, W: int, G: int, cw, L):
    """(local cell in the chunk's window, CIC weight, violations) of each
    marker, (n_chunks, C): a local cell outside [0, W) is counted and
    clamped."""
    n_chunks = w0.shape[0]
    x = (eta.reshape(n_chunks, -1) + L) / cw
    idxf = torch.floor(x)
    w = x - idxf
    lidx = idxf.to(torch.int64) + G - w0[:, None]
    viol = ((lidx < 0) | (lidx >= W)).sum()
    return torch.clamp(lidx, 0, W - 1), w, viol


def _gather_windowed(table_ext, eta, w0, W: int, G: int, cw, L):
    """CIC gather through each chunk's window: the table row at w0 + local
    cell.  Returns (phi, dphi, violations)."""
    lidx, w, viol = _window_index(eta, w0, W, G, cw, L)
    phi, dphi = _blend(table_ext[w0[:, None] + lidx], w, cw)
    return phi.reshape(-1), dphi.reshape(-1), viol


def _deposit_windowed(den, eta, w0, W: int, G: int, nf: int, cw, L):
    """CIC deposit through each chunk's window: each marker's two parts
    add into its chunk's (W + 1)-cell buffer (left node at the local cell,
    right node one on), the buffers overlap-add onto the extended grid at
    w0 with one index_add_, and the guard rows fold back onto the periodic
    grid.  Returns (density (nf,) complex, violations)."""
    lidx, w, viol = _window_index(eta, w0, W, G, cw, L)
    n_chunks = w0.shape[0]
    dev = den.device
    den2 = den.reshape(n_chunks, -1)
    slot = (lidx + (W + 1) * torch.arange(n_chunks, device=dev)[:, None]
            ).reshape(-1)
    buf = torch.zeros(n_chunks * (W + 1), dtype=den.dtype, device=dev)
    buf.index_add_(0, slot, (den2 * (1.0 - w)).reshape(-1))
    buf.index_add_(0, slot + 1, (den2 * w).reshape(-1))
    acc = torch.zeros(nf + 2 * G + 2, dtype=den.dtype, device=dev)
    acc.index_add_(0, (w0[:, None] + torch.arange(W + 1, device=dev)
                       ).reshape(-1), buf)
    out = acc[G:G + nf].clone()
    out[nf - G:] += acc[:G]
    right = acc[G + nf:]
    out[:right.shape[0]] += right
    return out, viol


def put_velocity_sorted(p, s: PICState, w0, W: int, G: int):
    """put_velocity with the windowed gather; ``s.eta`` may be UNWRAPPED
    (the guards take the periodic image), the physics terms use the wrapped
    coordinate.  Returns (velocity, violations)."""
    cw = cell_width(p)
    eta_p = _wrap_eta(p, s.eta)
    x_perp = s.v_perp / p.vt
    sb = torch.sqrt(p.b_theta * (1.0 + (p.shat * eta_p) ** 2))
    dj0 = (-p.b_theta * p.shat**2 * x_perp * eta_p
           * bessel_j1(x_perp * sb) / sb)

    phi, dphi, viol = _gather_windowed(_field_table_ext(s.field, G), s.eta,
                                       w0, W, G, cw, p.length)

    omega_d = _omega_d(p, eta_p)
    common = (1j * ((s.omega_st - omega_d * s.omega_dv) * s.j0 * phi)
              - s.v_para / (p.q * p.R) * (s.j0 * dphi + dj0 * phi))
    if p.drift_center_transformation_switch:
        return s.p_weight * torch.conj(s.dc_pb) * common, viol
    return (-s.weight * omega_d * s.omega_dv * 1j
            + s.p_weight * common), viol


def solve_field_sorted(p, s: PICState, qn_coef, w0, W: int, G: int,
                       density_reduce=None):
    """solve_field with the windowed deposit (unwrapped eta allowed).
    Returns (state, violations)."""
    cw = cell_width(p)
    eta_p = _wrap_eta(p, s.eta)
    x_perp = s.v_perp / p.vt
    sb = torch.sqrt(p.b_theta * (1.0 + (p.shat * eta_p) ** 2))
    j0 = bessel_j0(x_perp * sb)
    dc_pb = torch.exp(-1j * _omega_d_integral(p, eta_p, s.v_para)
                      * s.omega_dv)

    den = (j0 * s.weight * dc_pb if p.drift_center_transformation_switch
           else j0 * s.weight)
    d, viol = _deposit_windowed(den, s.eta, w0, W, G, p.npoints, cw,
                                p.length)
    if density_reduce is not None:
        d = density_reduce(d)
    return replace(s, j0=j0, dc_pb=dc_pb, field=d * qn_coef), viol


def rk3_step_sorted(p, s: PICState, dt, qn_coef, w0, W: int, G: int,
                    density_reduce=None):
    """RK3 step on the sorted-window path; eta stays UNWRAPPED (no
    per-stage mod: it wraps at the next sort).  Returns (state,
    violations of the three gathers and deposits)."""
    viols = 0
    v = []
    for stage in range(3):
        vel, vg = put_velocity_sorted(p, s, w0, W, G)
        v.append(vel)
        sub_dt = float(RK_COEF[stage][stage + 1]) * dt
        s = replace(s, eta=s.eta + s.v_para * sub_dt / (p.q * p.R),
                    weight=s.weight + _combo(RK_COEF[stage], v) * sub_dt)
        s, vd = solve_field_sorted(p, s, qn_coef, w0, W, G, density_reduce)
        viols = viols + vg + vd
    return s, viols


def run_sorted(p, marker_per_cell: int, n_steps: int, dt, generator=None,
               state: PICState | None = None, resort_every: int = 15,
               window: int = 384, chunk_markers: int = 8192):
    """``run`` on the sorted-window path, from ``state`` or ``init_state``
    as ``run``.  Markers re-sort every R <= ``resort_every`` steps; R and
    the guard width G follow from the realized max |v_para| (constant over
    a run) so that no marker can drift past its window between sorts; the
    returned violation count is the runtime proof.  ``LAST_SORTED`` records
    what was chosen.

    Returns (stats (n_steps, 3), final state (sorted as at the last sort,
    eta unwrapped), violations: a 0-d int64 tensor)."""
    s = initial_state(p, marker_per_cell, generator, state)
    n = int(s.eta.shape[0])
    vmax = float(torch.max(torch.abs(s.v_para)))

    # the guard derivation of emme_tpu/solvers/pic.py:592-621: between
    # sorts the fastest marker drifts R * dt * vmax * sum|substep| / (q R);
    # the margin of a centered window is ~(W - span) / 2 - quant cells
    # (span allowance 16 cells + CIC reach)
    nf = p.npoints
    cw = 2.0 * float(p.length) / nf
    W = min(int(window), nf)
    quant = max(1, W // 8)
    span_allow = max(16, 2 * int(chunk_markers) // max(marker_per_cell, 1))
    margin_eta = ((W - span_allow) // 2 - 4 - quant) * cw
    drift_per_step = float(dt) * vmax * (_RK_SUBSTEP_SUM + 0.2) \
        / float(p.q * p.R)
    safe_R = max(1, int(margin_eta / max(drift_per_step, 1e-30)))
    R = min(int(resort_every), safe_R, n_steps)
    while n_steps % R:
        R -= 1
    G = int(np.ceil(R * drift_per_step / cw)) + 2
    nfe = nf + 2 * G + 2
    n_chunks = max(1, n // int(chunk_markers))
    if n % n_chunks:
        raise ValueError(f"run_sorted: {n} markers do not split into "
                         f"{n_chunks} chunks (chunk_markers "
                         f"{chunk_markers})")
    if G + 2 > nf:
        raise ValueError(f"run_sorted: {G} guard cells a side pass the "
                         f"grid of {nf} cells; lower dt or resort_every")

    qn_coef = quasi_neutrality_coef(p, dtype=p.dtype)
    viols = torch.zeros((), dtype=torch.int64, device=p.device)
    stats = []
    for _ in range(n_steps // R):
        s = sort_by_eta(p, s)
        w0 = _window_bases(p, s.eta, n_chunks, W, G, nfe, quant)
        for _ in range(R):
            s, v = rk3_step_sorted(p, s, dt, qn_coef, w0, W, G)
            viols = viols + v
            stats.append(field_stats(s.field))
    LAST_SORTED.clear()
    LAST_SORTED.update(R=R, G=G, W=W, quant=quant, n_chunks=n_chunks,
                       sorts=n_steps // R)
    return torch.stack(stats), s, viols


def _fields_to_file(fields, f):
    """Append (k, nf) complex fields to the open binary file ``f`` as raw
    complex128, the layout of the buffered dump."""
    torch.stack(fields).to(torch.complex128).cpu().numpy().tofile(f)


def run_streaming(p, marker_per_cell: int, n_steps: int, dt, stream_path,
                  generator=None, state: PICState | None = None,
                  chunk_steps: int = 16, gather_method: str | None = None,
                  deposit_method: str | None = None, density_reduce=None):
    """``run`` with the per-step field dumps STREAMED to disk during the run
    (the reference writes each step's field before the next one starts,
    main.cpp:105-110, so a killed run keeps its field history; the buffered
    ``run`` loses everything).

    Every ``chunk_steps`` steps the fields of the segment go to the host and
    are APPENDED to ``stream_path`` (complex128 raw, the layout of the
    buffered dump), flushed and ``fsync``ed, which bounds the history a
    killed run loses to ``chunk_steps`` steps.  The device waits for the
    host once a segment, not once a step.

    Returns (stats (n_steps, 3), final state)."""
    s = initial_state(p, marker_per_cell, generator, state)
    qn_coef = quasi_neutrality_coef(p, dtype=p.dtype)
    stats, fields = [], []
    with open(stream_path, "wb") as f:
        for k in range(n_steps):
            s, _v = rk3_step(p, s, dt, qn_coef, gather_method, deposit_method,
                             density_reduce)
            stats.append(field_stats(s.field))
            fields.append(s.field)
            if len(fields) == chunk_steps or k == n_steps - 1:
                _fields_to_file(fields, f)
                f.flush()
                os.fsync(f.fileno())
                fields = []
    return torch.stack(stats), s


def run_timed(p, marker_per_cell: int, n_steps: int, dt, generator=None,
              state: PICState | None = None, record_fields: bool = False,
              density_reduce=None):
    """Observability variant of ``run``: the step loop with the reference's
    per-phase timer sections ("Initial", "Particle Pushing", "Field Solve",
    "Diagnostics"; solver_pic.h:127-155).  On a card every section ends
    with a device synchronize, so it is slower than ``run``: use it to see
    the push / deposit / diagnose split.  Returns (stats, final state,
    fields or None)."""
    with section("Initial"):
        s = initial_state(p, marker_per_cell, generator, state)
        qn_coef = quasi_neutrality_coef(p, dtype=p.dtype)
        sync(s.field)

    stats, fields = [], []
    for _ in range(n_steps):
        v = []
        for stage in range(3):
            with section("Particle Pushing"):
                v.append(put_velocity(p, s))
                sub_dt = float(RK_COEF[stage][stage + 1]) * dt
                eta = s.eta + s.v_para * sub_dt / (p.q * p.R)
                eta = torch.remainder(eta + p.length, 2.0 * p.length) \
                    - p.length
                s = replace(s, eta=eta, weight=s.weight
                            + _combo(RK_COEF[stage], v) * sub_dt)
                sync(s.weight)
            with section("Field Solve"):
                s = solve_field(p, s, qn_coef, density_reduce=density_reduce)
                sync(s.field)
        with section("Diagnostics"):
            stats.append(field_stats(s.field))
            if record_fields:
                fields.append(s.field)
            sync(stats[-1])
    return (torch.stack(stats), s,
            torch.stack(fields) if record_fields else None)


def update_err(s: PICState, combo, dt):
    """Reference error norm (solver_pic.h:158-169): the reference loops
    over the first field.size() markers only (a quirk kept as is):
    err = sqrt(sum |v_i dt|^2 / sum |w_i|^2) over i < nf."""
    nf = s.field.shape[-1]
    v = combo[:nf] * dt
    w = s.weight[:nf]
    err = torch.sum(v.real ** 2 + v.imag ** 2)
    tot = torch.sum(w.real ** 2 + w.imag ** 2)
    return torch.sqrt(err / tot)


def step_adaptive(p, s: PICState, current_dt, qn_coef,
                  upper_err_bound=1e-7, lower_err_bound=1e-10,
                  max_halvings: int = 30):
    """Adaptive step with embedded-error halving/doubling and state rollback
    (solver_pic.h:437-457).  Returns (new_state, dt_taken, next_dt)."""
    dt = float(current_dt)
    for _ in range(max_halvings):
        s_new, v = rk3_step(p, s, dt, qn_coef)
        err = float(update_err(s_new, _combo(RK_COEF[3], v), dt))
        if err < upper_err_bound:
            next_dt = dt * 2.0 if err < lower_err_bound else dt
            return s_new, dt, next_dt
        dt *= 0.5
    raise RuntimeError("step_adaptive: error bound not reached")


def run_adaptive(p, marker_per_cell: int, total_time: float, dt0,
                 generator=None, state: PICState | None = None,
                 upper_err_bound=1e-7, lower_err_bound=1e-10):
    """Adaptive-step PIC run to t = total_time using ``step_adaptive``.
    Returns (times, stats, final state): ``times`` are the accepted step
    END times (nonuniform)."""
    s = initial_state(p, marker_per_cell, generator, state)
    qn_coef = quasi_neutrality_coef(p, dtype=p.dtype)
    t, dt = 0.0, float(dt0)
    times, stats_l = [], []
    while t < total_time - 1e-12:
        dt = min(dt, total_time - t)
        s, dt_taken, dt = step_adaptive(p, s, dt, qn_coef,
                                        upper_err_bound, lower_err_bound)
        t += dt_taken
        times.append(t)
        stats_l.append(field_stats(s.field).cpu().numpy())
    return np.asarray(times), np.stack(stats_l), s


# ---------------------------------------------------------------------------
# (omega, gamma) fits on the stats series, in numpy (pic.py:838-937)
# ---------------------------------------------------------------------------

def _fit_gamma(second, dt, views: bool = False):
    """LSQ slope of log rms(phi) over the (already-halved) window -- the
    closed form of solver_pic.h:490-501.  The two compile-time conventions:

    * plain (default): the reference loop weights val*t BEFORE t += dt, so
      t_i = i*dt starting at 0 -- paired with the (nn+1) coefficient that
      belongs to t_i = (i+1)*dt, this biases gamma by
      -12*sum(vals)/(dt*nn*(nn^2-1)); reproduced faithfully
      (calculate_omega_fft uses the unbiased fit).
    * ``views`` (EMME_USE_VIEWS, solver_pic.h:479-489): the accumulate
      lambda increments t FIRST, so t_i = (i+1)*dt -- the unbiased pairing.
    """
    vals = np.log(second[:, 2])
    t = dt * (np.arange(len(vals)) + (1 if views else 0))
    weighted_sum = float(np.sum(vals * t))
    ssum = float(np.sum(vals))
    nn = len(vals)
    return (6.0 * (2.0 * weighted_sum - dt * ssum * (nn + 1))
            / (dt * dt * nn * (nn * nn - 1)))


def _as_numpy(stats):
    """The statistics on the host; a tensor's copy is a blocking read
    (``timer.host_read``)."""
    if isinstance(stats, torch.Tensor):
        return host_read(stats.detach().cpu).numpy()
    return np.asarray(stats)


def _peaks(real_log):
    return [i for i in range(1, len(real_log) - 1)
            if real_log[i] > real_log[i - 1] and real_log[i] > real_log[i + 1]]


def calculate_omega(stats, dt, views: bool = False):
    """gamma from the LSQ slope of log rms(phi) over the second half; omega
    from peak spacing of log|mean Re phi| (solver_pic.h:475-529);
    ``views`` selects the EMME_USE_VIEWS time-weight convention for gamma."""
    stats = _as_numpy(stats)
    second = stats[len(stats) // 2:]
    gamma = _fit_gamma(second, dt, views=views)
    peaks = _peaks(np.log(np.abs(second[:, 0])))
    omega = 0.0
    if len(peaks) > 1:
        omega = np.pi * (len(peaks) - 1) / (dt * (peaks[-1] - peaks[0]))
    return complex(omega, gamma)


def calculate_omega_nonuniform(times, stats):
    """(omega, gamma) fit for adaptive-step runs (nonuniform sample times):
    gamma by LSQ slope of log rms(phi) against the actual times over the
    second half; omega by peak counting against the actual peak times."""
    times = np.asarray(times)
    stats = _as_numpy(stats)
    n = len(stats) // 2
    t = times[n:]
    second = stats[n:]
    gamma = np.polyfit(t, np.log(second[:, 2]), 1)[0]
    peaks = _peaks(np.log(np.abs(second[:, 0])))
    omega = 0.0
    if len(peaks) > 1:
        omega = np.pi * (len(peaks) - 1) / (t[peaks[-1]] - t[peaks[0]])
    return complex(omega, gamma)


def calculate_omega_fft(stats, dt, pad: int = 16):
    """Sign-resolving FFT variant of the omega fit (the fix the reference's
    own FIXME at solver_pic.h:514-527 suggests): the complex mean field over
    the second half, growth-flattened by the fitted gamma, Hann windowed,
    zero-padded; the dominant line refined by parabolic interpolation of
    log|F|.  A mode e^{-i omega_r t + gamma t} lands at f = -omega_r / 2 pi,
    so the real part carries the physical sign.  gamma is the unbiased LSQ
    slope."""
    stats = _as_numpy(stats)
    second = stats[len(stats) // 2:]
    m = len(second)
    t = dt * np.arange(m)
    gamma = float(np.polyfit(t, np.log(second[:, 2]), 1)[0])
    sig = (second[:, 0] + 1j * second[:, 1]) * np.exp(-gamma * t)
    sig = sig * np.hanning(m)
    nfft = pad * m
    mag = np.abs(np.fft.fft(sig, n=nfft))
    k = int(np.argmax(mag))
    km, kp = (k - 1) % nfft, (k + 1) % nfft
    lm, l0, lp = np.log(mag[km]), np.log(mag[k]), np.log(mag[kp])
    denom = lm - 2.0 * l0 + lp
    delta = 0.5 * (lm - lp) / denom if denom != 0.0 else 0.0
    f_peak = (k + delta) / (nfft * dt)
    if k + delta > nfft / 2:  # wrap to the negative-frequency branch
        f_peak -= 1.0 / dt
    return complex(-2.0 * np.pi * f_peak, gamma)
