"""Scaled complex modified-Bessel I0/I1 on torch tensors.

The branchless Taylor + asymptotic hybrid of ``emme_tpu/ops/bessel.py``
(44 Taylor / 14 asymptotic terms, split at |w| = 12), accurate to ~1e-12
relative in float64.  It returns the *scaled* pair
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
