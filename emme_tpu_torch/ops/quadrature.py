"""Fixed-shape Gauss-Kronrod panel quadrature on torch tensors.

The same G-K 15/31 rules as ``emme_tpu/ops/quadrature.py``, applied on a
static set of panels whose boundaries (but never their count) depend on the
integrand's parameters, with per-panel embedded error estimates.  Nodes and
weights are the standard QUADPACK Gauss-Kronrod constants.
"""

from __future__ import annotations

import numpy as np
import torch

# Standard Gauss-Kronrod abscissae (non-negative half) and weights.
# K15 (embedded G7) and K31 (embedded G15), as published in QUADPACK.
_GK = {
    # 7-point PURE Gauss-Legendre (no embedded estimate: wg == wk, so the
    # "embedded error" is identically zero).
    7: {
        "abscissa": np.array([
            0.0,
            0.40584515137739717,
            0.74153118559939444,
            0.94910791234275852,
        ]),
        "gauss_weight": np.array([]),
        "kronrod_weight": np.array([
            0.41795918367346939,
            0.38183005050511894,
            0.27970539148927667,
            0.12948496616886969,
        ]),
    },
    15: {
        "abscissa": np.array([
            0.0,
            0.20778495500789847,
            0.40584515137739717,
            0.58608723546769113,
            0.74153118559939444,
            0.86486442335976907,
            0.94910791234275852,
            0.99145537112081264,
        ]),
        "gauss_weight": np.array([
            0.41795918367346939,
            0.38183005050511894,
            0.27970539148927667,
            0.12948496616886969,
        ]),
        "kronrod_weight": np.array([
            2.09482141084727828e-01,
            2.04432940075298892e-01,
            1.90350578064785410e-01,
            1.69004726639267903e-01,
            1.40653259715525919e-01,
            1.04790010322250184e-01,
            6.30920926299785533e-02,
            2.29353220105292250e-02,
        ]),
    },
    31: {
        "abscissa": np.array([
            0.0,
            0.1011420669187175,
            0.20119409399743452,
            0.29918000715316881,
            0.39415134707756337,
            0.48508186364023968,
            0.57097217260853885,
            0.65099674129741697,
            0.72441773136017005,
            0.79041850144246593,
            0.84820658341042722,
            0.8972645323440819,
            0.9372733924007059,
            0.96773907567913913,
            0.98799251802048543,
            0.99800229869339706,
        ]),
        "gauss_weight": np.array([
            0.20257824192556112,
            0.19843148532711152,
            0.18616100001556193,
            0.1662692058169939,
            0.1395706779261542,
            0.10715922046717143,
            0.07036604748810768,
            0.030753241996119,
        ]),
        "kronrod_weight": np.array([
            0.10133000701479155,
            0.100769845523875595,
            0.099173598721791959,
            0.0966427269836236785,
            0.093126598170825321,
            0.0885644430562117706,
            0.083080502823133021,
            0.0768496807577203789,
            0.069854121318728259,
            0.0620095678006706403,
            0.053481524690928087,
            0.0445897513247648766,
            0.035346360791375846,
            0.0254608473267153202,
            0.0150079473293161225,
            0.00537747987292334899,
        ]),
    },
}


def gk_rule(order: int):
    """Full symmetric G-K rule on [-1, 1].

    Returns ``(x, w_kronrod, w_gauss)`` as numpy arrays of length ``order``.
    ``w_gauss`` is the embedded lower-order Gauss rule's weight placed at the
    shared abscissae (zero at Kronrod-only points), so the embedded estimate
    is ``sum(f * w_gauss)``.
    """
    if order not in _GK:
        raise ValueError(f"Gauss-Kronrod order must be one of {list(_GK)}, got {order}")
    d = _GK[order]
    half = d["abscissa"]
    n_half = len(half)
    x = np.concatenate([-half[:0:-1], half])  # ascending, odd length
    wk = np.concatenate([d["kronrod_weight"][:0:-1], d["kronrod_weight"]])

    if order == 7:   # pure Gauss rule: no embedded estimate (wg == wk)
        return x, wk, wk.copy()

    # Gauss points sit at every odd-indexed abscissa of the half rule
    # (counting the centre as 0) for K15/K31, plus the centre iff the
    # embedded Gauss order is odd (G7, G15 both odd -> centre is a Gauss
    # point); the reference's interleave, functions.h:189-199.
    gauss_order = (order - 1) // 2
    wg_half = np.zeros(n_half)
    gw = d["gauss_weight"]
    if gauss_order % 2 == 1:
        wg_half[0] = gw[0]
    for i in range(1, n_half):
        if (gauss_order - i) % 2 == 1:
            wg_half[i] = gw[i // 2]
    wg = np.concatenate([wg_half[:0:-1], wg_half])
    return x, wk, wg


def panel_points(bounds, order: int):
    """Map per-integral panel boundaries to quadrature node positions.

    Args:
      bounds: (..., P+1) tensor of panel boundaries (monotone in last axis).
      order: 7, 15 or 31.

    Returns:
      ``(pts, wk, wg)``, each of shape (..., P, order); the weights are
      already scaled by each panel's half-width.
    """
    x, wk, wg = gk_rule(order)
    lo = bounds[..., :-1]
    hi = bounds[..., 1:]
    mid = 0.5 * (lo + hi)
    halfw = 0.5 * (hi - lo)

    def t(a):
        return torch.as_tensor(a, dtype=bounds.dtype, device=bounds.device)

    pts = mid[..., None] + halfw[..., None] * t(x)
    wk = halfw[..., None] * t(wk)
    wg = halfw[..., None] * t(wg)
    return pts, wk, wg


def panel_reduce(fvals, wk, wg):
    """Weighted reduction over (..., P, order) samples.

    Returns ``(integral, err)``: the Kronrod estimate summed over panels and
    the summed per-panel |K - G| embedded error estimate.
    """
    k_panel = torch.sum(fvals * wk, dim=-1)
    g_panel = torch.sum(fvals * wg, dim=-1)
    integral = torch.sum(k_panel, dim=-1)
    err = torch.sum(torch.abs(k_panel - g_panel), dim=-1)
    return integral, err


def integrate_fixed(f, bounds, order: int = 15):
    """Integrate the callable ``f`` over per-integral panel meshes
    ``bounds`` (..., P+1).  ``f`` is applied to the whole node tensor
    (..., P, order) in one call, so it must be vectorized.  Returns
    ``(integral, err)`` as ``panel_reduce``."""
    pts, wk, wg = panel_points(bounds, order)
    return panel_reduce(f(pts), wk, wg)


def _unit_fractions(n_panels: int, like):
    """0, 1/n, ..., 1 in ``like``'s dtype: iota / n rounded once, the values
    ``jnp.linspace(0, 1, n + 1)`` gives."""
    return torch.arange(n_panels + 1, dtype=like.dtype,
                        device=like.device) / n_panels


def geometric_bounds(t_lo, t_hi, n_panels: int):
    """(...,) scalars -> (..., n_panels+1) geometrically spaced boundaries."""
    frac = _unit_fractions(n_panels, t_lo)
    log_lo = torch.log(t_lo)
    log_hi = torch.log(t_hi)
    return torch.exp(log_lo[..., None] + (log_hi - log_lo)[..., None] * frac)


def linear_bounds(t_lo, t_hi, n_panels: int):
    """(...,) scalars -> (..., n_panels+1) linearly spaced boundaries."""
    frac = _unit_fractions(n_panels, t_lo)
    return t_lo[..., None] + (t_hi - t_lo)[..., None] * frac
