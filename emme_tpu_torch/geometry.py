"""Magnetic geometry models as pure functions on torch tensors.

Each geometry supplies ``g_integration_f`` (the field-line integral of the
magnetic drift, reference ``src/Parameters.cpp:76-85, 248-440``) and ``bi``
(the FLR argument b_i(eta), ``Parameters.cpp:97-100, 230-232``).  Dispatch is
by the ``conf`` string.  Counterpart of ``emme_tpu/geometry.py``; the
stellarator closed form keeps the same regrouping in ``k = lh - mh*q``.
"""

from __future__ import annotations

import math

import torch

GEOMETRIES = (
    "tokamak",
    "stellarator",
    "cylinder",
    "cylinder old",
    "taloyMagneticDrift",  # sic -- reference spelling (Parameters.cpp:24)
)


# ---------------------------------------------------------------------------
# Derived scalar helpers (reference Parameters.cpp:36-74, 211-246)
# ---------------------------------------------------------------------------

def alpha_f(p):
    return (p.q * p.q * p.R * p.beta_e / (p.epsilon_n * p.R)
            * ((1.0 + p.eta_e) + 1.0 / p.tau * (1.0 + p.eta_i)))


def omega_s_i_f(p):
    return -(torch.sqrt(p.b_theta) * p.vt) / (p.epsilon_n * p.R)


def omega_s_e_f(p):
    return -p.tau * omega_s_i_f(p)


def omega_d_bar_f(p):
    return 2.0 * p.epsilon_n * omega_s_i_f(p) * p.omega_d_coeff


# Stellarator-derived scalars (Parameters.cpp:211-246)

def _stel_deltap(p, alpha):
    return -0.25 * alpha


def _stel_rdeltapp(p, alpha, deltap):
    return -alpha + (2.0 * p.shat - 3.0) * deltap


def _stel_curvature_aver(p, alpha, deltap):
    return (p.mh / p.lh * p.r_over_R / (p.q * p.R) * (4.0 - p.shat)
            + (-alpha + 2.0 * p.shat * deltap + 0.0) / p.R)


# ---------------------------------------------------------------------------
# cylinder shat_coeff (reference functions.cpp:32-83): average of
# cos(x) + a x sin(x) over [0, first zero], via fixed-iteration bisection.
# ---------------------------------------------------------------------------

def cylinder_shat_coeff(a, tolerance=1e-9, max_iterations=100):
    def f(x):
        return torch.cos(x) + a * x * torch.sin(x)

    low = torch.zeros_like(a)
    high = torch.full_like(a, math.pi)
    mid = torch.zeros_like(a)
    for _ in range(max_iterations):
        mid = low + (high - low) / 2.0
        f_mid = f(mid)
        go_left = f(low) * f_mid < 0
        high = torch.where(go_left, mid, high)
        low = torch.where(go_left, low, mid)
    x0 = mid
    integral = (1.0 + a) * torch.sin(x0) - a * x0 * torch.cos(x0)
    return integral / x0


# ---------------------------------------------------------------------------
# g_integration_f per geometry
# ---------------------------------------------------------------------------

def _g_tokamak(p, alpha, eta):
    """Reference Parameters.cpp:76-85.  NB the last term's exponent uses the
    C++ integer division quirk ``3 / 2 == 1`` faithfully."""
    return (-(alpha * eta) / 2.0
            + p.shat * p.theta * torch.cos(eta)
            - p.shat * eta * torch.cos(eta)
            + torch.sin(eta)
            + p.shat * torch.sin(eta)
            + 0.25 * alpha * torch.sin(2.0 * eta)
            - (1.0 - p.shat) * p.q * p.epsilon_r
            / (p.epsilon_r ** 2 + p.q ** 2) ** 1  # pow(x, 3/2) with int 3/2==1
            * eta)


def _g_stellarator(p, alpha, eta):
    """Reference Parameters.cpp:248-393, regrouped with k = lh - mh q."""
    lh = p.lh
    u = p.mh * p.q
    k = lh - u
    S = p.shat
    E = p.epsilon_h_t
    A = _stel_deltap(p, alpha)
    Rd = _stel_rdeltapp(p, alpha, A)
    curv = _stel_curvature_aver(p, alpha, A)
    ARd = A * (1.0 + S) + Rd
    phase = eta * k - p.alpha_0 * p.mh

    km1, kp1 = k - 1.0, k + 1.0
    num = (
        eta * km1 * k**2 * kp1 * (A + curv * p.R + Rd + A * S)
        - 2.0 * E * (eta - p.eta_k) * lh * km1 * k * kp1 * S * torch.cos(phase)
        + 2.0 * k**2 * km1 * kp1 * (1.0 + S) * torch.sin(eta)
        + torch.cos(eta) * (
            -2.0 * (eta - p.eta_k) * km1 * k**2 * kp1 * S
            - ((lh**4 - lh**2) + (u**4 - u**2)) * ARd * torch.sin(eta))
        + torch.sin(2.0 * eta) * ARd * lh * u * (-1.0 + 2.0 * lh**2 - 3.0 * lh * u + 2.0 * u**2)
        + E * ARd * lh * k**2 * (1.0 - k) * torch.sin(eta + phase)
        - E * ARd * lh * k**2 * (1.0 + k) * torch.sin(eta - phase)
        - 2.0 * E * lh * km1 * kp1 * (k + S) * torch.sin(-phase)
    )
    return num / (2.0 * km1 * k**2 * kp1)


def _g_cylinder(p, alpha, eta):
    """Reference Parameters.cpp:400-402: eta * average of cos+a x sin, the
    average precomputed once in ``params.from_config``."""
    return eta * p.cyl_shat_coeff


def _g_cylinder_old(p, alpha, eta):
    return eta


def _g_taylor(p, alpha, eta):
    """Pade {3,4} approximant, reference Parameters.cpp:404-436."""
    S = p.shat
    a = alpha
    den_common = 7.0 + 16.0 * a + 40.0 * a**2 - 28.0 * S - 80.0 * a * S + 40.0 * S**2
    num = eta + (eta**3 * (
        -31.0 - 96.0 * a - 168.0 * a**2 - 560.0 * a**3
        + 186.0 * S + 672.0 * a * S + 1680.0 * a**2 * S
        - 504.0 * S**2 - 1680.0 * a * S**2 + 560.0 * S**3)) / (42.0 * den_common)
    den = (1.0
           + (eta**2 * (3.0 + 19.0 * a + 56.0 * a**2 - 18.0 * S - 84.0 * a * S
                        + 28.0 * S**2)) / (7.0 * den_common)
           + (eta**4 * (11.0 - 4.0 * a + 704.0 * a**2 - 88.0 * S - 584.0 * a * S
                        + 216.0 * S**2)) / (840.0 * den_common))
    return num / den


_G_FUNCS = {
    "tokamak": _g_tokamak,
    "stellarator": _g_stellarator,
    "cylinder": _g_cylinder,
    "cylinder old": _g_cylinder_old,
    "taloyMagneticDrift": _g_taylor,
}


def g_integration_f(p, eta):
    """Magnetic-drift integral g(eta) for the configured geometry."""
    if p.conf not in _G_FUNCS:
        raise ValueError(f"Input configuration not supported yet: {p.conf!r}")
    return _G_FUNCS[p.conf](p, alpha_f(p), eta)


# ---------------------------------------------------------------------------
# bi(eta): FLR argument
# ---------------------------------------------------------------------------

def bi_f(p, eta):
    """b_i(eta).  Tokamak family: Parameters.cpp:97-100; stellarator
    overrides with sigma_f (Parameters.cpp:225-232)."""
    if p.conf == "stellarator":
        alpha = alpha_f(p)
        A = _stel_deltap(p, alpha)
        Rd = _stel_rdeltapp(p, alpha, A)
        sigma = p.shat * (eta - p.eta_k) + (A * (1.0 + p.shat) + Rd) * torch.sin(eta)
        return p.b_theta * (1.0 + sigma**2)
    alpha = alpha_f(p)
    return p.b_theta * (1.0 + (p.shat * (eta - p.theta) - alpha * torch.sin(eta)) ** 2)
