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

Not ported: the sorted-window path and the one-hot matmul / bf16 CIC forms
(TPU workarounds), and ``run_jitted``, whose role ``run`` has here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from ..ops.bessel import bessel_i01_scaled, bessel_j0, bessel_j1
from ..utils.timer import section, sync

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


def _check_method(method, allowed):
    if method not in (None, allowed):
        raise ValueError(f"only the {allowed!r} CIC form is ported, got "
                         f"{method!r}")


def gather_cic(field, idx, w, nf, cw, method: str | None = None):
    """CIC field gather by indexed loads: returns (phi, dphi) at marker
    positions; dphi blends the centered difference (f[c+1] - f[c-1]) / 2cw
    (solver_pic.h:96-104)."""
    _check_method(method, "take")
    fm1 = field[(idx - 1) % nf]
    f0 = field[idx % nf]
    f1 = field[(idx + 1) % nf]
    f2 = field[(idx + 2) % nf]
    phi = (1.0 - w) * f0 + w * f1
    dphi = ((1.0 - w) * (f1 - fm1) + w * (f2 - f0)) / (2.0 * cw)
    return phi, dphi


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
    """CIC charge deposition den -> grid as two scatter-adds (the JAX
    package's 'segment' form)."""
    _check_method(method, "segment")
    i0 = idx % nf
    i1 = (idx + 1) % nf
    zero = torch.zeros(nf, dtype=den.dtype, device=den.device)
    return (zero.index_add(0, i0, den * (1.0 - w))
            + zero.index_add(0, i1, den * w))


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
    if isinstance(stats, torch.Tensor):
        return stats.detach().cpu().numpy()
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
