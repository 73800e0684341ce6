"""Scaled complex modified-Bessel I0/I1, and real J0/J1/i0e, on torch
tensors.

The branchless Taylor + asymptotic hybrid of ``emme_tpu/ops/bessel.py``
(44 Taylor / 14 asymptotic terms, split at |w| = 12), accurate to ~1e-12
relative in float64, is the production form; the masked Miller recurrence
of the reference (``bessel_i01_scaled_miller``) is its validator.  Both
return the *scaled* pair
``(I0(z)*e^{zs}, I1(z)*e^{zs}, zs)`` with ``zs = z if Re z < 0 else -z``
(so ``|e^{zs}| <= 1``), matching how the reference consumes
``bessel_i_alter_helper`` in ``Parameters.cpp:135-175``: the caller folds
``-zs`` into its log-domain exponent so the product never overflows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_TAYLOR_TERMS = 44
_ASYM_TERMS = 14
_SPLIT = 12.0
_MILLER_THRESHOLD = 2.0e7


def asym_coeffs(nu: int, terms: int):
    """a_k(nu) = prod_{j=1..k} (4 nu^2 - (2j-1)^2) / (k! 8^k)."""
    a = np.ones(terms)
    for k in range(1, terms):
        a[k] = a[k - 1] * (4 * nu * nu - (2 * k - 1) ** 2) / (k * 8.0)
    return a


_A0 = asym_coeffs(0, _ASYM_TERMS)
_A1 = asym_coeffs(1, _ASYM_TERMS)


def _to_complex(z):
    if z.is_complex():
        return z
    return z.to(torch.complex128 if z.dtype == torch.float64
                else torch.complex64)


def bessel_i01_scaled_miller(z, forward_steps: int = 64,
                             max_order: int = 160):
    """Mask-vectorized Miller recurrence for scaled I0/I1, the reference's
    ``bessel_i_alter_helper`` (functions.h:381-408) as
    ``emme_tpu/ops/bessel.py:44`` writes it: a forward recurrence finds the
    starting order (until |p1| exceeds the threshold), then a backward
    recurrence with parity-signed normalization accumulates the scaled
    values.  The loop bounds are static; lanes that finish early are
    masked.  ``max_order`` must exceed every lane's starting order (about
    |z| + forward_steps).  A validator of ``bessel_i01_scaled``, no
    production path.  Returns (I0 e^{zs}, I1 e^{zs}, zs)."""
    z = _to_complex(torch.as_tensor(z))
    az = torch.abs(z)
    # z == 0 (I0 = 1, I1 = 0): the recurrence divides by z
    safe_z = torch.where(az == 0, torch.ones_like(z), z)
    n0 = torch.floor(az) + 1.0
    test = torch.clamp_min(torch.sqrt(
        _MILLER_THRESHOLD * (2.0 * n0 / torch.clamp_min(az, 1e-300))),
        _MILLER_THRESHOLD)

    p0 = torch.zeros_like(z)
    p1 = torch.ones_like(z)
    n = n0
    for _ in range(forward_steps):
        active = torch.abs(p1) <= test
        p_new = p0 - (2.0 * n / safe_z) * p1
        p0 = torch.where(active, p1, p0)
        p1 = torch.where(active, p_new, p1)
        n = torch.where(active, n + 1.0, n)

    y0 = 1.0 / p1
    y1 = torch.zeros_like(z)
    mu = torch.zeros_like(z)
    neg_re = z.real < 0
    for i in range(max_order - 1):
        # k counts down max_order - 1 .. 1; a lane is active while
        # k <= n - 1; for Re z < 0 the normalization series alternates
        k = max_order - 1.0 - i
        active = k <= n - 1.0
        y_t = (2.0 * k / safe_z) * y0 + y1
        sign = torch.where(neg_re, -1.0, 1.0).to(az.dtype) if k % 2.0 == 1.0 \
            else 1.0
        mu = torch.where(active, mu + 2.0 * sign * y0, mu)
        y1 = torch.where(active, y0, y1)
        y0 = torch.where(active, y_t, y0)
    mu_t = mu + y0
    zs = torch.where(neg_re, z, -z)
    i0s = torch.where(az == 0, torch.ones_like(z), y0 / mu_t)
    i1s = torch.where(az == 0, torch.zeros_like(z), y1 / mu_t)
    return i0s, i1s, zs


def bessel_i01_scaled(z):
    """Branchless scaled I0/I1: Taylor for |z| <= 12, asymptotic beyond.

    Returns ``(I0(z) e^{zs}, I1(z) e^{zs}, zs)`` with ``zs = z`` if
    ``Re z < 0`` else ``-z``.
    """
    z = _to_complex(z)
    neg_re = z.real < 0
    zs = torch.where(neg_re, z, -z)
    # Reduce to Re w >= 0: I0(-z) = I0(z), I1(-z) = -I1(z).
    w = torch.where(neg_re, -z, z)
    aw = torch.abs(w)

    # --- Taylor branch (scaled by e^{-w}) ---
    q = 0.25 * w * w
    # Horner over k: I0 = sum q^k/(k!)^2 ; I1 = (w/2) sum q^k/(k!(k+1)!).
    # In place: t = 1 + t q / c without a new tensor per term, the division
    # by the real c taken on the (re, im) view.
    t0 = torch.ones_like(z)
    t1 = torch.ones_like(z)
    t0_ri = torch.view_as_real(t0)
    t1_ri = torch.view_as_real(t1)
    for k in range(_TAYLOR_TERMS, 0, -1):
        t0.mul_(q)
        t0_ri.div_(k * k)
        t0.add_(1.0)
        t1.mul_(q)
        t1_ri.div_(k * (k + 1))
        t1.add_(1.0)
    scale = torch.exp(-w)
    i0_taylor = t0 * scale
    i1_taylor = 0.5 * w * t1 * scale

    # --- Asymptotic branch (scaled by e^{-w}) ---
    # I_nu(w) ~ e^w/sqrt(2 pi w) * S_minus + sigma * e^{-w}/sqrt(2 pi w) * S_plus
    # S_minus = sum (-1)^k a_k / w^k ; S_plus = sum a_k / w^k
    winv = 1.0 / torch.where(aw == 0, torch.ones_like(w), w)
    s0m = torch.zeros_like(z)
    s0p = torch.zeros_like(z)
    s1m = torch.zeros_like(z)
    s1p = torch.zeros_like(z)
    for k in range(_ASYM_TERMS - 1, -1, -1):
        s0m.mul_(winv).add_(((-1.0) ** k) * float(_A0[k]))
        s0p.mul_(winv).add_(float(_A0[k]))
        s1m.mul_(winv).add_(((-1.0) ** k) * float(_A1[k]))
        s1p.mul_(winv).add_(float(_A1[k]))
    pref = 1.0 / torch.sqrt(2.0 * math.pi * w)
    # Recessive term carries e^{+-(nu+1/2) pi i} (DLMF 10.40.5): upper sign
    # for Im w >= 0, lower otherwise (w is in the right half-plane).
    # nu=0: e^{+- i pi/2} = +-i ; nu=1: e^{+- 3 i pi/2} = -+i.
    sgn = torch.where(w.imag >= 0, 1.0, -1.0).to(w.real.dtype)
    sigma0 = 1j * sgn
    sigma1 = -1j * sgn
    exp2 = torch.exp(-2.0 * w)
    i0_asym = pref * (s0m + sigma0 * exp2 * s0p)
    i1_asym = pref * (s1m + sigma1 * exp2 * s1p)

    use_taylor = aw <= _SPLIT
    i0 = torch.where(use_taylor, i0_taylor, i0_asym)
    i1 = torch.where(use_taylor, i1_taylor, i1_asym)
    i1 = torch.where(neg_re, -i1, i1)
    return i0, i1, zs


# ---------------------------------------------------------------------------
# Real-argument J0/J1 for the PIC gyroaverage (emme_tpu/ops/bessel.py:199-249):
# a 30-term Taylor sum for |x| <= 8 and the Abramowitz & Stegun 9.4.3/9.4.6
# rational asymptotic form beyond.  Kept term for term as the JAX package
# writes them, so float32 results carry the same rounding (the Taylor sum
# cancels near |x| = 8); torch.special.bessel_j0 would give other numbers.
# ---------------------------------------------------------------------------

_INV_PI_2 = 0.636619772367581343      # 2 / pi


def bessel_j0(x):
    """J0 for real x: Taylor (|x| <= 8) + Hankel asymptotics."""
    ax = torch.abs(x)
    q = -0.25 * x * x
    t = torch.ones_like(x)
    for k in range(30, 0, -1):
        t = 1.0 + t * q / (k * k)
    small = t
    z = 8.0 / torch.clamp_min(ax, 1e-30)
    y = z * z
    P = 1.0 + y * (-0.1098628627e-2 + y * (0.2734510407e-4
        + y * (-0.2073370639e-5 + y * 0.2093887211e-6)))
    Q = z * (-0.1562499995e-1 + y * (0.1430488765e-3
        + y * (-0.6911147651e-5 + y * (0.7621095161e-6 + y * (-0.934935152e-7)))))
    xx = ax - 0.785398163397448309616
    large = torch.sqrt(_INV_PI_2 / torch.clamp_min(ax, 1e-30)) * (
        torch.cos(xx) * P - torch.sin(xx) * Q)
    return torch.where(ax <= 8.0, small, large)


def bessel_j1(x):
    """J1 for real x: Taylor (|x| <= 8) + Hankel asymptotics, odd parity."""
    ax = torch.abs(x)
    q = -0.25 * x * x
    t = torch.ones_like(x)
    for k in range(30, 0, -1):
        t = 1.0 + t * q / (k * (k + 1))
    small = 0.5 * x * t
    z = 8.0 / torch.clamp_min(ax, 1e-30)
    y = z * z
    P = 1.0 + y * (0.183105e-2 + y * (-0.3516396496e-4
        + y * (0.2457520174e-5 + y * (-0.240337019e-6))))
    Q = z * (0.04687499995 + y * (-0.2002690873e-3
        + y * (0.8449199096e-5 + y * (-0.88228987e-6 + y * 0.105787412e-6))))
    xx = ax - 2.356194490192344928847
    large = torch.sqrt(_INV_PI_2 / torch.clamp_min(ax, 1e-30)) * (
        torch.cos(xx) * P - torch.sin(xx) * Q)
    large = torch.where(x < 0, -large, large)
    return torch.where(ax <= 8.0, small, large)


def bessel_i0e(x):
    """Scaled I0(x) e^{-|x|} for real x, in float64 (complex128 internals)."""
    i0s, _, _ = bessel_i01_scaled(torch.as_tensor(x).to(torch.complex128))
    return i0s.real
