"""K1, the transit-time integral a (eta, eta') pair: its operations and
bytes, from the plain formula (Parameters.cpp:113-184 as the float32 path
writes it on (re, im) planes: contour rotation, lambda, scaled complex
Bessel I0 / I1 with 26 Taylor or 10 asymptotic terms, the coefficients,
the log-domain exponent, the moments and the Kronrod sum).

A node takes one side of the Bessel split, |w| <= 12 (Taylor) or beyond
(asymptotic); ``asymptotic_share`` finds the share of nodes beyond from a
call's own inputs.
"""

from __future__ import annotations

import torch

from .common import Tally

TAYLOR_TERMS = 26
ASYM_TERMS = 10
SPLIT = 12.0


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cinv(br, bi):
    d = 1.0 / (br * br + bi * bi)
    return br * d, -bi * d


def _cdiv(ar, ai, br, bi):
    d = 1.0 / (br * br + bi * bi)
    return (ar * br + ai * bi) * d, (ai * br - ar * bi) * d


def _cexp(T, ar, ai):
    e = T.fn(ar)
    return e * T.fn(ai), e * T.fn(ai)


def _bessel(T, zr, zi, asymptotic: bool):
    """Scaled I0, I1 on one side of the split; returns (i0r, i0i, i1r,
    i1i, zsr, zsi)."""
    wr, wi = zr, zi                     # w = +-z: a sign, no operation
    zsr, zsi = zr, zi
    _aw2 = wr * wr + wi * wi            # the split's test
    sr, si = _cexp(T, -wr, -wi)         # e^{-w}
    if not asymptotic:
        qr, qi = 0.25 * (wr * wr - wi * wi), 0.5 * wr * wi
        t0r, t0i, t1r, t1i = 1.0, 0.0, 1.0, 0.0
        for _ in range(TAYLOR_TERMS):
            # the first term multiplies the constant 1: as written
            pr, pi = _cmul(T.v(), T.v(), qr, qi)
            t0r, t0i = 1.0 + pr * 0.5, pi * 0.5
            pr, pi = _cmul(T.v(), T.v(), qr, qi)
            t1r, t1i = 1.0 + pr * 0.5, pi * 0.5
        i0r, i0i = _cmul(t0r, t0i, sr, si)
        ur, ui = _cmul(t1r, t1i, sr, si)
        i1r, i1i = _cmul(0.5 * wr, 0.5 * wi, ur, ui)
        return i0r, i0i, i1r, i1i, zsr, zsi
    vr, vi = _cinv(wr, wi)
    sums = []
    for _ in range(4):                  # s0-, s0+, s1-, s1+
        sr_, si_ = T.v(), T.v()
        for _ in range(ASYM_TERMS):
            sr_, si_ = _cmul(sr_, si_, vr, vi)
            sr_ = sr_ + 0.5
        sums.append((sr_, si_))
    r = T.fn(wr * wr + wi * wi)         # the principal sqrt of 2 pi w
    t = T.fn(0.5 * (r + wr) + 1e-30)
    pfr, pfi = _cinv(t, wi / (2.0 * t))
    e2r, e2i = _cmul(sr, si, sr, si)
    r0r, r0i = _cmul(e2r, e2i, *sums[1])
    r0r, r0i = -1.0 * r0i, 1.0 * r0r    # times i sgn
    r1r, r1i = _cmul(e2r, e2i, *sums[3])
    r1r, r1i = 1.0 * r1i, -1.0 * r1r
    i0r, i0i = _cmul(pfr, pfi, sums[0][0] + r0r, sums[0][1] + r0i)
    i1r, i1i = _cmul(pfr, pfi, sums[2][0] + r1r, sums[2][1] + r1i)
    return i0r, i0i, i1r, i1i, zsr, zsi


def node_ops(asymptotic: bool, n_moments: int) -> int:
    """Operations of one quadrature node, its share of the Kronrod sums of
    ``n_moments`` moments (0, 1, 2 in turn) included."""
    T = Tally()
    mid, hw, x, wk_t = T.v(), T.v(), 0.5, 0.5
    de, b1, ba, bb = T.v(), T.v(), T.v(), T.v()
    om_r, om_i, arc, qR, vt, ws_i, eta_i, omi = (T.v() for _ in range(8))
    pre = T.ops          # inputs cost nothing
    t = mid + hw * x
    wk = wk_t * hw
    sbb = T.fn(ba * bb)
    y = t / arc
    rinv = T.fn(1.0 + y * y)
    ear = rinv
    eai = -omi * y * rinv
    tautr = t * ear
    tauti = t * eai
    g = omi * t / (arc * (1.0 + y * y))
    jacr = ear + eai * g
    jaci = eai - ear * g
    c = 0.5 * vt * b1 / (qR * de)
    lamr = 1.0 - c * tauti
    lami = c * tautr
    zr, zi = _cdiv(sbb, 0.0 * sbb, lamr, lami)
    i0r, i0i, i1r, i1i, zsr, zsi = _bessel(T, zr, zi, asymptotic)
    l2r, l2i = _cmul(lamr, lami, lamr, lami)
    l3ir, l3ii = _cinv(*_cmul(l2r, l2i, lamr, lami))
    k_de = qR * de / vt
    tinvr, tinvi = _cinv(tautr, tauti)
    nvr = k_de * tinvr
    nvi = k_de * tinvi
    nv2r, nv2i = _cmul(nvr, nvi, nvr, nvi)
    ar = om_r - ws_i * (1.0 + eta_i * (0.5 * nv2r - 1.5))
    ai = om_i - ws_i * eta_i * 0.5 * nv2i
    c0r, c0i = _cdiv(ar, ai, lamr, lami)
    dr, di = _cmul(0.5 * (ba + bb) - lamr, -lami, l3ir, l3ii)
    i0cr = c0r + ws_i * eta_i * dr
    i0ci = c0i + ws_i * eta_i * di
    i1cr = -ws_i * eta_i * sbb * l3ir
    i1ci = -ws_i * eta_i * sbb * l3ii
    er = -0.5 * nv2r + 0.5 * b1 * nvi - tauti * om_r - tautr * om_i
    ei = -0.5 * nv2i - 0.5 * b1 * nvr + tautr * om_r - tauti * om_i
    qir, qii = _cdiv(0.0 * b1, b1, nvr, nvi)
    etr, eti = _cdiv(-(ba + bb), 0.0 * ba, 2.0 + qir, qii)
    er = er + etr - zsr
    ei = ei + eti - zsi
    exr, exi = _cexp(T, er, ei)
    p0r, p0i = _cmul(i0cr, i0ci, i0r, i0i)
    p1r, p1i = _cmul(i1cr, i1ci, i1r, i1i)
    cr, ci = _cmul(exr, exi, p0r + p1r, p0i + p1i)
    jtr, jti = _cmul(jacr, jaci, tinvr, tinvi)
    mr, mi = _cmul(jtr, jti, cr, ci)
    for m in range(n_moments):
        if m:
            mr, mi = _cmul(mr, mi, nvr, nvi)
        _sum_r, _sum_i = T.v() + mr * wk, T.v() + mi * wk
    return T.ops - pre


def asymptotic_share(mid, halfw, pair, scal, order: int,
                     sample: int = 4096) -> float:
    """Share of a call's quadrature nodes whose Bessel functions take the
    asymptotic side, |w|^2 = bi(eta) bi(eta') / |lambda|^2 > 144, on an
    evenly spaced sample of its pairs, in float64 from the call's inputs:
    panel mids and half-widths (npairs, n_panels), pair rows [d_eta, beta1,
    bi(eta), bi(eta')], scalars [om_r, om_i, arc, qR, vt, ...]."""
    from ..reference.operator import kronrod
    step = max(1, mid.shape[0] // sample)
    mid, halfw, pair = (a[::step].double() for a in (mid, halfw, pair))
    x = torch.as_tensor(kronrod(order)[0], dtype=torch.float64,
                        device=mid.device)
    t = torch.clamp_min(mid[:, :, None] + halfw[:, :, None] * x, 1e-6)
    t = t.reshape(mid.shape[0], -1)
    s = scal.double()
    om_r, arc, qR, vt = s[0], s[2], s[3], s[4]
    de, b1, ba, bb = (pair[:, k:k + 1] for k in range(4))
    omi = 1.0 if float(om_r) < 0 else -1.0
    y = t / arc
    rinv = torch.rsqrt(1.0 + y * y)
    c = 0.5 * vt * b1 / (qR * de)
    lam2 = (1.0 + c * t * omi * y * rinv) ** 2 + (c * t * rinv) ** 2
    return float((ba * bb / lam2 > SPLIT * SPLIT).double().mean())


def call_work(npairs: int, n_panels: int, order: int, n_moments: int,
              asym_share: float) -> tuple[float, float]:
    """(operations, bytes) of one K1 call: every node of every pair; its
    inputs read once (panel mids and half-widths, 4 pair floats, 8
    scalars) and its outputs written once (2 floats a moment a pair)."""
    nodes = npairs * n_panels * order
    per = ((1.0 - asym_share) * node_ops(False, n_moments)
           + asym_share * node_ops(True, n_moments))
    nbytes = 4 * (2 * npairs * n_panels + 4 * npairs + 8
                  + 2 * n_moments * npairs)
    return nodes * per, float(nbytes)
