"""Gyrokinetic propagator kernels kappa_f_tau / kappa_f_tau_e on torch.

The ion kernel (reference ``src/Parameters.cpp:113-184``) is a
contour-rotated integral over normalized transit time t in [0, inf) whose
integrand combines the parallel propagator, FLR-scaled complex Bessel I0/I1,
and a log-domain underflow-safe exponential.  As in
``emme_tpu/ops/kernels.py`` it is evaluated for all pairs x all quadrature
nodes of a static per-pair panel mesh (``ops/quadrature.py``).  This is the
float64 golden-parity path and the off-kernel float32 path; the float32
main path goes through the CUDA kernel (``ops/cuda_kappa.py``).

Electron kernels (``Parameters.cpp:186-209``) are closed forms.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from . import quadrature
from .bessel import bessel_i01_scaled

SAFE_EXP_CUTOFF = -40.0  # reference Parameters.cpp:167-173

# Default panel counts for the transit-time integral, per working precision.
# The float64 mesh over-resolves on purpose (golden comparisons to ~1e-10);
# at float32 the matrix entries bottom out at ~1e-7 relative rounding noise,
# so a mesh ~4x coarser reaches the same converged eigenvalue.
PANEL_PRESETS = {
    "float32": {"n_shoulder": 8, "n_osc": 32, "n_tail": 4},
    "float64": {"n_shoulder": 40, "n_osc": 144, "n_tail": 16},
}


def _dtype_name(real_dtype) -> str:
    return str(real_dtype).removeprefix("torch.")


def panel_preset(real_dtype) -> dict:
    return dict(PANEL_PRESETS[_dtype_name(real_dtype)])


# |eta - eta'| tier table for assembly: (upper bound, per-tier mesh spec),
# the auto-tuned table of emme_tpu/ops/kernels.py.  The integrand's
# resolution demand is set by the Gaussian turn-on at t ~ q R |d_eta| / vt,
# so far pairs get coarser meshes.  Spec: scale float (legacy) or frozen
# (key, value) tuple of explicit panel counts.
TIER_TABLE = (
    (0.6, 1.0),
    (8.0, (("n_osc", 12), ("n_shoulder", 6), ("n_tail", 1))),
    (16.0, (("n_osc", 4), ("n_shoulder", 4), ("n_tail", 1))),
    (float("inf"), (("n_osc", 4), ("n_shoulder", 6), ("n_tail", 1))),
)


def scaled_quad(quad, real_dtype, spec) -> dict:
    """Per-tier panel mesh: ``spec`` is a scale float (every panel count
    multiplied) or a frozen (key, value) tuple of explicit panel counts.

    A ``quad`` whose panel counts differ from the preset scales the tuple
    spec's counts by the same per-key ratio.  A tuple-spec key that is not
    in the preset raises KeyError, as in ``emme_tpu``."""
    base = panel_preset(real_dtype)
    if quad:
        base.update(quad)
    if isinstance(spec, (int, float)):
        return {k: (max(1, int(round(v * spec))) if k.startswith("n_")
                    else v) for k, v in base.items()}
    preset = panel_preset(real_dtype)
    out = dict(base)
    for k, v in dict(spec).items():
        factor = base.get(k, preset[k]) / preset[k]
        out[k] = max(1, int(round(v * factor)))
    return out


def tier_thresholds_ij(dx: float, npoints: int, table=TIER_TABLE) -> tuple:
    """TIER_TABLE in |i - j| index units for a concrete grid spacing."""
    out = []
    for ub, scale in table:
        ij = npoints if ub == float("inf") \
            else min(npoints, int(np.ceil(ub / dx)))
        out.append((ij, scale))
    return tuple(out)


def complex_dtype(real_dtype):
    return torch.complex128 if real_dtype == torch.float64 else torch.complex64


def kappa_integrand(p, t, eta, eta_p, omega, ms: Sequence[int]):
    """Integrand of kappa_f_tau at transit-time nodes ``t``.

    Args:
      p: Params.
      t: real tensor of integration nodes (broadcasts against eta).
      eta, eta_p: field-line coordinates (broadcast with t).
      omega: complex 0-d tensor.
      ms: tuple of velocity moments to emit (subset of (0, 1, 2)).

    Returns a tuple of tensors, one per m in ``ms``.
    Mirrors reference Parameters.cpp:120-176.
    """
    # contour rotation: omi = -copysign(1, Re omega)
    om_re = omega.real
    omi = -torch.sign(torch.where(om_re == 0, torch.ones_like(om_re), om_re))
    exp_arg = torch.exp(-omi * 1j * torch.atan(t / p.arc_coeff))
    taut = t * exp_arg
    jacob = exp_arg - (1j * exp_arg * omi * t) / (
        p.arc_coeff * (1.0 + (t / p.arc_coeff) ** 2))

    beta1 = p.beta_1(eta, eta_p)
    d_eta = eta - eta_p
    lam = 1.0 + 0.5j * (taut * p.vt) / (p.q * p.R * d_eta) * beta1

    bi_eta = p.bi(eta)
    bi_eta_p = p.bi(eta_p)
    sqrt_bb = torch.sqrt(bi_eta * bi_eta_p)

    i0s, i1s, zs = bessel_i01_scaled(sqrt_bb / lam)

    lam3_inv = 1.0 / (lam * (lam * lam))
    norm_vel = (p.q * p.R * d_eta) / (p.vt * taut)
    nv2 = norm_vel * norm_vel

    i0_coef = ((omega - p.omega_s_i * (1.0 + p.eta_i * (0.5 * nv2 - 1.5)))
               / lam
               + p.omega_s_i * p.eta_i * (0.5 * (bi_eta + bi_eta_p) - lam) * lam3_inv)
    i1_coef = -p.omega_s_i * p.eta_i * sqrt_bb * lam3_inv

    log_norm_vel = -0.5 * nv2
    log_i_beta = -0.5j * beta1 * norm_vel
    log_hf_tau = 1j * taut * omega
    log_exp_term = -(bi_eta + bi_eta_p) / (2.0 + 1j * beta1 / norm_vel)
    log_coef = log_norm_vel + log_i_beta + log_hf_tau + log_exp_term

    # underflow-safe exp: the Bessel scaling e^{zs} is folded into the
    # exponent exactly as the reference does (Parameters.cpp:174-175).
    expo = log_coef - zs
    keep = expo.real >= SAFE_EXP_CUTOFF
    # clamp the discarded nodes so exp() can't overflow/NaN before the select
    safe = torch.exp(torch.where(keep, expo, SAFE_EXP_CUTOFF))
    core = torch.where(keep, safe * (i0_coef * i0s + i1_coef * i1s), 0.0)

    base = jacob / taut * core
    moment = {0: None, 1: norm_vel, 2: nv2}
    return tuple(base * moment[m] if m else base for m in ms)


def transit_panel_bounds(p, d_eta_abs, omega, n_shoulder: int = 40,
                         n_osc: int = 144, n_tail: int = 16):
    """Per-entry panel boundaries for the transit-time integral.

    Three graded sections tuned to the integrand structure:
      * shoulder: geometric panels through the Gaussian turn-on at
        t ~ q R |d_eta| / vt;
      * oscillatory bulk: linear panels sized for the exp(i omega taut)
        oscillation, up to the contour-rotation decay cutoff;
      * tail: geometric panels to capture slow residual decay.
    """
    a = p.q * p.R * d_eta_abs / p.vt          # Gaussian scale per entry
    t_a = a / 12.0 + 1e-8
    t_b = torch.clamp_min(3.0 * a, 1.0)

    im = omega.imag
    re = torch.abs(omega.real)
    # decay rate after full contour rotation ~ max(|Re w|, Im w); before
    # rotation (t < arc) only Im w (if > 0) damps.
    rate_far = torch.clamp_min(torch.maximum(re, im), 0.02)
    rate_near = torch.clamp_min(im, 0.0)
    # if the mode grows only after rotation, mass extends past ~4*arc
    t_cut = torch.where(rate_near > 0.05,
                        45.0 / rate_near,
                        45.0 / rate_far + 4.0 * p.arc_coeff)
    t_c = torch.clamp_min(torch.maximum(t_cut, 4.0 * t_b), 50.0)
    t_d = 50.0 * t_c

    sh = quadrature.geometric_bounds(t_a, t_b, n_shoulder)
    osc = quadrature.linear_bounds(t_b, t_c, n_osc)
    tail = quadrature.geometric_bounds(t_c, t_d, n_tail)
    return torch.cat([sh, osc[..., 1:], tail[..., 1:]], dim=-1)


def kappa_f_tau(p, eta, eta_p, omega, ms: Sequence[int] = (0,),
                quad=None):
    """Batched ion kernel over pair tensors ``eta``/``eta_p``.

    Returns (values, errs): ``values`` is a tuple (one entry per m) of complex
    tensors shaped like ``eta``; ``errs`` is a matching tuple of the summed
    embedded G-K error estimates per moment.
    Reference: Parameters.cpp:113-184.
    """
    quad = quad or {}
    order = quad.get("order", p.integration_start_points)
    preset = panel_preset(eta.dtype)
    bounds = transit_panel_bounds(
        p, torch.abs(eta - eta_p), omega,
        n_shoulder=quad.get("n_shoulder", preset["n_shoulder"]),
        n_osc=quad.get("n_osc", preset["n_osc"]),
        n_tail=quad.get("n_tail", preset["n_tail"]))
    pts, wk, wg = quadrature.panel_points(bounds, order)

    fvals = kappa_integrand(p, pts, eta[..., None, None],
                            eta_p[..., None, None], omega, ms)

    pref = -1j * (p.q * p.R) / (p.vt * math.sqrt(2.0 * math.pi))
    outs = []
    errs = []
    for f in fvals:
        integral, err = quadrature.panel_reduce(f, wk, wg)
        outs.append(pref * integral)
        errs.append(torch.abs(pref) * err)
    return tuple(outs), tuple(errs)


def kappa_f_tau_e(p, eta, eta_p, omega, m: int):
    """Adiabatic/fluid electron kernel, closed form.
    Reference: Parameters.cpp:186-209."""
    d = eta - eta_p
    sgn = d / torch.abs(d)
    if m == 0:
        return torch.zeros(torch.broadcast_shapes(eta.shape, eta_p.shape),
                           dtype=complex_dtype(p.q.dtype), device=d.device)
    if m == 1:
        return (-1j * (p.q * p.R) / (2.0 * p.vt * p.tau)
                * (omega - p.omega_s_e) * sgn)
    if m == 2:
        return ((p.q**2 * p.R**2) / (2.0 * p.vt**2 * p.tau) * sgn
                * (omega * (omega - p.omega_s_e) * d
                   - p.beta_1_e(eta, eta_p) * p.vt / (p.q * p.R)
                   * (omega - p.omega_s_e * (1.0 + p.eta_e))))
    raise ValueError("Unsupported mode value")
