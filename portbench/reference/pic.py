"""Plain reference of EMME's delta-f particle-in-cell run and its fit.

A frozen copy of the algorithm (``include/solver_pic.h`` of the upstream
code) in plain PyTorch, float64 by default: markers loaded from the same
random draws the program is handed, the gyroaveraged field gathered and the
density deposited by cloud-in-cell on the periodic grid, the drift-center
transformation, the 3-stage low-storage Runge-Kutta step, the per-step
field statistics and the (omega, gamma) fit of ``solver_pic.h:475-529``.
J0 and J1 are ``torch.special``'s; Gamma0 is numpy's ``i0``.  It imports
nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from .operator import phys

RK = ((1.0, 0.62653829327080, 0.0, 0.0),
      (0.0, 1.0, -0.55111240553326, 0.0),
      (0.0, 1.5220585509963, -0.52205855099628, 0.92457411226246))


class Markers:
    """Marker state and the run's constants."""

    def __init__(self, inp: dict, eta, z_para, z_perp, w0, dtype):
        ph = phys(inp)
        self.ph = ph
        self.dc = bool(inp.get("drift_center_transformation_switch", False))
        self.nf = ph.npoints
        self.cw = 2.0 * ph.length / ph.npoints
        f = lambda t: t.to(dtype)   # noqa: E731
        self.cdt = torch.complex128 if dtype == torch.float64 \
            else torch.complex64
        vt2 = ph.vt * ph.vt
        self.eta = f(eta)
        self.v_para = f(z_para) * ph.vt / ph.wb_para ** 0.5
        self.v_perp = (f(z_perp) * ph.vt / ph.wb_perp ** 0.5).abs()
        self.weight = f(w0).to(self.cdt)
        vp2, vq2 = self.v_para ** 2, self.v_perp ** 2
        self.odv = (vp2 + 0.5 * vq2) / (2.0 * vt2)
        self.ost = ph.omega_s_i * (1.0 + ph.eta_i * ((vp2 + vq2) / (2.0 * vt2)
                                                    - 1.5))
        pw = self.v_perp * torch.exp(-(vp2 * (1.0 - ph.wb_para)
                                       + vq2 * (1.0 - ph.wb_perp)) / (2.0 * vt2))
        self.pw = pw * (2.0 * ph.length / pw.sum())
        self.j0 = torch.zeros_like(self.eta)
        self.dc_pb = torch.zeros_like(self.weight)
        self.field = torch.zeros(self.nf, dtype=self.cdt, device=eta.device)
        idx = np.arange(self.nf)
        b = ph.b_theta * (1.0 + (ph.shat * (idx * self.cw - ph.length)) ** 2)
        gamma0 = np.i0(b) * np.exp(-b)
        self.qn = torch.as_tensor(1.0 / ((1.0 + 1.0 / ph.tau - gamma0)
                                         * self.cw), dtype=dtype,
                                  device=eta.device)


def _locate(m: Markers, eta):
    x = (eta + m.ph.length) / m.cw
    idx = torch.floor(x)
    return idx.long() % m.nf, x - idx


def _sb(m: Markers, eta):
    return torch.sqrt(m.ph.b_theta * (1.0 + (m.ph.shat * eta) ** 2))


def _omega_d(m: Markers, eta):
    ph = m.ph
    return ph.omega_d_bar * (torch.cos(eta) + ph.shat * eta * torch.sin(eta))


def velocity(m: Markers, eta, weight, j0, dc_pb, field):
    """d(weight)/dt (solver_pic.h:82-140)."""
    ph = m.ph
    xp = m.v_perp / ph.vt
    sb = _sb(m, eta)
    dj0 = (-ph.b_theta * ph.shat ** 2 * xp * eta
           * torch.special.bessel_j1(xp * sb) / sb)
    idx, w = _locate(m, eta)
    nxt = (idx + 1) % m.nf
    prv = (idx - 1) % m.nf
    nn = (idx + 2) % m.nf
    phi = (1.0 - w) * field[idx] + w * field[nxt]
    dphi = ((1.0 - w) * (field[nxt] - field[prv])
            + w * (field[nn] - field[idx])) / (2.0 * m.cw)
    od = _omega_d(m, eta)
    common = (1j * ((m.ost - od * m.odv) * j0 * phi)
              - m.v_para / (ph.q * ph.R) * (j0 * dphi + dj0 * phi))
    if m.dc:
        return m.pw * torch.conj(dc_pb) * common
    return -weight * od * m.odv * 1j + m.pw * common


def field_solve(m: Markers, eta, weight):
    """Deposit and quasi-neutrality (solver_pic.h:249-354): (j0, dc_pb,
    field)."""
    ph = m.ph
    xp = m.v_perp / ph.vt
    j0 = torch.special.bessel_j0(xp * _sb(m, eta))
    odi = ((ph.q * ph.R / m.v_para) * ph.omega_d_bar
           * (torch.sin(eta) * (1.0 + ph.shat) - ph.shat * eta * torch.cos(eta)))
    dc_pb = torch.exp(-1j * odi * m.odv)
    den = j0 * weight * dc_pb if m.dc else j0 * weight
    idx, w = _locate(m, eta)
    d = torch.zeros(m.nf, dtype=m.cdt, device=eta.device)
    d.index_add_(0, idx, den * (1.0 - w))
    d.index_add_(0, (idx + 1) % m.nf, den * w)
    return j0, dc_pb, d * m.qn


def _round(t, kind):
    """``t`` rounded to ``kind`` (e.g. bfloat16) and back, each part of a
    complex tensor."""
    if t.is_complex():
        return torch.view_as_complex(_round(torch.view_as_real(t), kind))
    return t.to(kind).to(t.dtype)


def step(m: Markers, dt: float, keep=None):
    """One 3-stage step; the state is advanced in place.  ``keep``: a
    dtype the marker state (eta, weight) and the field are rounded to
    after every stage, as a state stored in that type would be."""
    ph = m.ph
    vs = []
    for s in range(3):
        vs.append(velocity(m, m.eta, m.weight, m.j0, m.dc_pb, m.field))
        vel = sum(RK[s][k] * v for k, v in enumerate(vs))
        sub = RK[s][s + 1] * dt
        eta = m.eta + m.v_para * sub / (ph.q * ph.R)
        m.eta = torch.remainder(eta + ph.length, 2.0 * ph.length) - ph.length
        m.weight = m.weight + vel * sub
        if keep is not None:
            m.eta, m.weight = _round(m.eta, keep), _round(m.weight, keep)
        m.j0, m.dc_pb, m.field = field_solve(m, m.eta, m.weight)
        if keep is not None:
            m.field = _round(m.field, keep)


def field_stats(field):
    """(mean Re, mean Im, rms) of the field (main.cpp:111-118)."""
    return torch.stack([field.real.mean(), field.imag.mean(),
                        (field.abs() ** 2).mean().sqrt()])


def run(inp: dict, draws, n_steps: int, dt: float, dtype=torch.float64,
        keep=None):
    """The run from ``draws`` = (eta, z_para, z_perp, w0): (stats (n_steps,
    3) as numpy, final field).  ``keep``: as in ``step``."""
    m = Markers(inp, *draws, dtype=dtype)
    stats = []
    for _ in range(n_steps):
        step(m, dt, keep)
        stats.append(field_stats(m.field))
    return torch.stack(stats).cpu().numpy(), m.field


def fit(stats, dt: float) -> complex:
    """(omega, gamma): gamma the least-squares slope of log rms over the
    second half with the reference's time weights (t_i = i dt against the
    (n + 1) coefficient); omega from the spacing of the peaks of
    log |mean Re phi| (solver_pic.h:475-529)."""
    stats = np.asarray(stats, dtype=np.float64)
    second = stats[len(stats) // 2:]
    vals = np.log(second[:, 2])
    nn = len(vals)
    t = dt * np.arange(nn)
    gamma = (6.0 * (2.0 * float(np.sum(vals * t)) - dt * float(np.sum(vals))
                    * (nn + 1)) / (dt * dt * nn * (nn * nn - 1)))
    lg = np.log(np.abs(second[:, 0]))
    peaks = [i for i in range(1, nn - 1) if lg[i] > lg[i - 1]
             and lg[i] > lg[i + 1]]
    omega = 0.0
    if len(peaks) > 1:
        omega = np.pi * (len(peaks) - 1) / (dt * (peaks[-1] - peaks[0]))
    return complex(omega, gamma)
