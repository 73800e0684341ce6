"""The kappa_f_tau transit-time integral per (eta, eta') pair: CUDA kernel K1
and its plain PyTorch version.

Counterpart of ``emme_tpu/ops/pallas_kappa.py`` (the Pallas TPU kernel
``_kappa_kernel``).  The kernel (``csrc/kappa.cu``) evaluates the whole
integrand chain -- node synthesis from the panel (mid, half-width) rows,
contour rotation, propagator lambda, float32 scaled complex Bessel I0/I1
(26 Taylor / 10 asymptotic terms), log-domain underflow-safe exponential,
velocity moments and the Kronrod-weighted sum -- in registers, so per pair
only the panel rows and four scalars are read and 2 floats per moment are
written.

``kappa_pairs_fused`` launches the kernel for CUDA tensors and counts each
launch in ``LAUNCHES``; for CPU tensors it runs the plain version.  A failed
build or launch raises: nothing falls back.  ``kappa_pairs_ref`` is the plain
version on any device, used by the tests and to check the kernel on the card.
The panel bounds are computed outside the kernel in torch (float32, from a
complex64 omega), as ``pallas_kappa.py:386-392`` does outside the Pallas call.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .. import _build
from . import kernels, quadrature
from .bessel import asym_coeffs

# kernel launches made by kappa_pairs_fused (one per call on a CUDA tensor)
LAUNCHES = 0

MAX_ORDER = 31
_TAYLOR_TERMS = 26   # f32 Bessel hybrid term counts, as pallas_kappa.py:92-94
_ASYM_TERMS = 10
_SPLIT = 12.0
_CHUNK = 16384       # pairs per step of the plain version

_F32 = torch.float32


@functools.lru_cache(maxsize=8)
def kernel_tables(order: int) -> np.ndarray:
    """The float32 constant table of ``csrc/kappa.cu`` (struct Tables):
    G-K abscissae and Kronrod weights padded to 31, the Taylor reciprocals
    1/k^2 and 1/(k(k+1)) for k = 1..26, and the asymptotic coefficients
    (-1)^k a_k(0), a_k(0), (-1)^k a_k(1), a_k(1) for k = 0..9.  Read-only;
    the plain version reads the same values."""
    if not 1 <= order <= MAX_ORDER:
        raise ValueError(f"order must be in 1..{MAX_ORDER}, got {order}")
    x, wk, _ = quadrature.gk_rule(order)
    k = np.arange(1, _TAYLOR_TERMS + 1, dtype=np.float64)
    sg = np.where(np.arange(_ASYM_TERMS) % 2 == 1, -1.0, 1.0)
    a0 = asym_coeffs(0, _ASYM_TERMS)
    a1 = asym_coeffs(1, _ASYM_TERMS)
    parts = [np.pad(x, (0, MAX_ORDER - order)),
             np.pad(wk, (0, MAX_ORDER - order)),
             1.0 / (k * k), 1.0 / (k * (k + 1)),
             sg * a0, a0, sg * a1, a1]
    tab = np.concatenate(parts).astype(np.float32)
    tab.setflags(write=False)
    return tab


def _table_views(tab: np.ndarray):
    """Split a ``kernel_tables`` array into its named float32 parts."""
    sizes = [MAX_ORDER, MAX_ORDER, _TAYLOR_TERMS, _TAYLOR_TERMS,
             _ASYM_TERMS, _ASYM_TERMS, _ASYM_TERMS, _ASYM_TERMS]
    names = ["x", "wk", "c0", "c1", "a0m", "a0p", "a1m", "a1p"]
    out, o = {}, 0
    for name, n in zip(names, sizes):
        out[name] = tab[o:o + n]
        o += n
    return out


def _check_ms(ms) -> tuple:
    ms = tuple(int(m) for m in ms)
    if not ms or list(ms) != sorted(set(ms)) or not set(ms) <= {0, 1, 2}:
        raise ValueError(f"ms must be an increasing subset of (0, 1, 2), got {ms}")
    return ms


def _prepare(p, eta, eta_p, omega, quad):
    """Per-pair kernel inputs, in float32 on ``eta``'s device: panel mids
    and half-widths (npairs, n_panels), the pair rows (npairs, 4)
    [d_eta, beta1, bi(eta), bi(eta')], the scalars (8,) [om_r, om_i, arc,
    qR, vt, omega_s_i, eta_i, 0], and the G-K order."""
    quad = quad or {}
    preset = kernels.panel_preset(_F32)
    order = int(quad.get("order", p.integration_start_points))
    eta = eta.to(_F32)
    eta_p = eta_p.to(_F32)
    d_eta = eta - eta_p
    beta1 = p.beta_1(eta, eta_p).to(_F32)
    bi_a = p.bi(eta).to(_F32)
    bi_b = p.bi(eta_p).to(_F32)
    omega = torch.as_tensor(omega, device=eta.device)
    om_r = omega.real.to(_F32)
    om_i = omega.imag.to(_F32)
    bounds = kernels.transit_panel_bounds(
        p, torch.abs(d_eta), torch.complex(om_r, om_i),
        n_shoulder=int(quad.get("n_shoulder", preset["n_shoulder"])),
        n_osc=int(quad.get("n_osc", preset["n_osc"])),
        n_tail=int(quad.get("n_tail", preset["n_tail"]))).to(_F32)
    mid = (0.5 * (bounds[:, :-1] + bounds[:, 1:])).contiguous()
    halfw = (0.5 * (bounds[:, 1:] - bounds[:, :-1])).contiguous()
    pair = torch.stack([d_eta, beta1, bi_a, bi_b], dim=1).contiguous()

    def s(v):
        return v.to(_F32).reshape(())

    scal = torch.stack([s(om_r), s(om_i), s(p.arc_coeff), s(p.q * p.R),
                        s(p.vt), s(p.omega_s_i), s(p.eta_i),
                        torch.zeros((), dtype=_F32, device=eta.device)])
    return mid, halfw, pair, scal, order


def _finish(p, out, ms):
    """Apply the prefactor -i qR / (vt sqrt(2 pi)); (npairs, 2 len(ms))
    float32 -> tuple of complex64 (npairs,)."""
    pref = (-1j * (p.q * p.R) / (p.vt * math.sqrt(2.0 * math.pi))).to(
        torch.complex64)
    return tuple(pref * torch.complex(out[:, 2 * k], out[:, 2 * k + 1])
                 for k in range(len(ms)))


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _library():
    lib, _record = _build.load("kappa")
    fn = lib.kappa_pairs_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                       vp, ci, vp]
        fn.restype = ci
        lib.kappa_table_len.argtypes = []
        lib.kappa_table_len.restype = ci
    return lib


def _launch(mid, halfw, pair, scal, order, ms):
    """Run K1 on the card: (npairs, 2 len(ms)) float32."""
    global LAUNCHES
    npairs, n_panels = mid.shape
    device = mid.device
    for name, t, shape in (("mid", mid, (npairs, n_panels)),
                           ("halfw", halfw, (npairs, n_panels)),
                           ("pair", pair, (npairs, 4)),
                           ("scal", scal, (8,))):
        if t.device != device or t.dtype != _F32 or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            raise ValueError(
                f"kappa kernel: {name} must be a contiguous float32 tensor "
                f"of shape {shape} on {device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if pair.data_ptr() % 16:
        raise ValueError("kappa kernel: pair rows must be 16-byte aligned")
    out = torch.empty((npairs, 2 * len(ms)), dtype=_F32, device=device)
    if npairs == 0:
        return out
    lib = _library()
    tab = kernel_tables(order)
    if lib.kappa_table_len() != tab.size:
        raise RuntimeError(f"kappa kernel table holds {lib.kappa_table_len()} "
                           f"floats, the wrapper {tab.size}")
    m = list(ms) + [0] * (3 - len(ms))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.kappa_pairs_launch(
            mid.data_ptr(), halfw.data_ptr(), pair.data_ptr(),
            scal.data_ptr(), out.data_ptr(), npairs, n_panels, order,
            len(ms), m[0], m[1], m[2], tab.ctypes.data, tab.size, stream)
    if err != 0:
        raise RuntimeError(f"kappa kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# the plain version: the kernel's math on (re, im) float32 planes
# ---------------------------------------------------------------------------

def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cinv(br, bi):
    d = 1.0 / (br * br + bi * bi)
    return br * d, -bi * d


def _cdiv(ar, ai, br, bi):
    d = 1.0 / (br * br + bi * bi)
    return (ar * br + ai * bi) * d, (ai * br - ar * bi) * d


def _cexp(ar, ai):
    e = torch.exp(ar)
    return e * torch.cos(ai), e * torch.sin(ai)


def _csqrt_rhp(wr, wi):
    """Principal sqrt for Re w >= 0 (algebraic form, no trig)."""
    r = torch.sqrt(wr * wr + wi * wi)
    t = torch.sqrt(0.5 * (r + wr) + 1e-30)
    return t, wi / (2.0 * t)


def _bessel_i01_scaled_ri(zr, zi, tab):
    """float32 scaled I0/I1 hybrid on (re, im) planes: returns
    (i0r, i0i, i1r, i1i, zsr, zsi), i_n = I_n(z) e^{zs},
    zs = z if Re z < 0 else -z."""
    neg = zr < 0
    zsr = torch.where(neg, zr, -zr)
    zsi = torch.where(neg, zi, -zi)
    wr = torch.where(neg, -zr, zr)
    wi = torch.where(neg, -zi, zi)
    aw2 = wr * wr + wi * wi
    sr, si = _cexp(-wr, -wi)

    # Taylor branch, scaled by e^{-w}
    qr, qi = 0.25 * (wr * wr - wi * wi), 0.5 * wr * wi
    t0r, t0i = torch.ones_like(wr), torch.zeros_like(wr)
    t1r, t1i = torch.ones_like(wr), torch.zeros_like(wr)
    for k in range(_TAYLOR_TERMS, 0, -1):
        c0 = float(tab["c0"][k - 1])
        c1 = float(tab["c1"][k - 1])
        pr, pi = _cmul(t0r, t0i, qr, qi)
        t0r, t0i = 1.0 + pr * c0, pi * c0
        pr, pi = _cmul(t1r, t1i, qr, qi)
        t1r, t1i = 1.0 + pr * c1, pi * c1
    i0tr, i0ti = _cmul(t0r, t0i, sr, si)
    ur, ui = _cmul(t1r, t1i, sr, si)
    i1tr, i1ti = _cmul(0.5 * wr, 0.5 * wi, ur, ui)

    # Asymptotic branch (DLMF 10.40.1 + recessive 10.40.5), scaled by e^{-w}
    vr, vi = _cinv(torch.where(aw2 == 0, torch.ones_like(wr), wr), wi)
    zero = torch.zeros_like(wr)
    s0mr = s0mi = s0pr = s0pi = s1mr = s1mi = s1pr = s1pi = zero
    for k in range(_ASYM_TERMS - 1, -1, -1):
        s0mr, s0mi = _cmul(s0mr, s0mi, vr, vi)
        s0mr = s0mr + float(tab["a0m"][k])
        s0pr, s0pi = _cmul(s0pr, s0pi, vr, vi)
        s0pr = s0pr + float(tab["a0p"][k])
        s1mr, s1mi = _cmul(s1mr, s1mi, vr, vi)
        s1mr = s1mr + float(tab["a1m"][k])
        s1pr, s1pi = _cmul(s1pr, s1pi, vr, vi)
        s1pr = s1pr + float(tab["a1p"][k])
    two_pi = float(np.float32(2.0 * np.pi))
    pfr, pfi = _cinv(*_csqrt_rhp(two_pi * wr, two_pi * wi))
    sgn = torch.where(wi >= 0, 1.0, -1.0).to(wr.dtype)
    e2r, e2i = _cmul(sr, si, sr, si)             # e^{-2w}
    r0r, r0i = _cmul(e2r, e2i, s0pr, s0pi)
    r0r, r0i = -sgn * r0i, sgn * r0r             # sigma0 = i sgn
    r1r, r1i = _cmul(e2r, e2i, s1pr, s1pi)
    r1r, r1i = sgn * r1i, -sgn * r1r             # sigma1 = -i sgn
    i0ar, i0ai = _cmul(pfr, pfi, s0mr + r0r, s0mi + r0i)
    i1ar, i1ai = _cmul(pfr, pfi, s1mr + r1r, s1mi + r1i)

    use_t = aw2 <= _SPLIT * _SPLIT
    i0r = torch.where(use_t, i0tr, i0ar)
    i0i = torch.where(use_t, i0ti, i0ai)
    i1r = torch.where(use_t, i1tr, i1ar)
    i1i = torch.where(use_t, i1ti, i1ai)
    i1r = torch.where(neg, -i1r, i1r)
    i1i = torch.where(neg, -i1i, i1i)
    return i0r, i0i, i1r, i1i, zsr, zsi


def _plain_block(mid, halfw, pair, scal, tab, order, ms):
    """The kernel's arithmetic for one block of pairs: (n, 2 len(ms))."""
    om_r, om_i, arc, qR, vt, ws_i, eta_i = (scal[k] for k in range(7))
    x = torch.tensor(tab["x"][:order], device=mid.device)
    wk_t = torch.tensor(tab["wk"][:order], device=mid.device)
    n = mid.shape[0]
    hw = halfw[:, :, None]
    t = torch.clamp_min(mid[:, :, None] + hw * x, 1e-6).reshape(n, -1)
    wk = (wk_t * hw).reshape(n, -1)

    de, b1, ba, bb = (pair[:, k:k + 1] for k in range(4))
    sbb = torch.sqrt(ba * bb)

    # contour rotation: cos(atan y) = 1/sqrt(1+y^2), sin(atan y) = y/sqrt(1+y^2)
    omi = -torch.sign(torch.where(om_r == 0, torch.ones_like(om_r), om_r))
    y = t / arc
    rinv = torch.rsqrt(1.0 + y * y)
    ear = rinv
    eai = -omi * y * rinv
    tautr = t * ear
    tauti = t * eai
    g = omi * t / (arc * (1.0 + y * y))
    jacr = ear + eai * g
    jaci = eai - ear * g

    # lambda = 1 + 0.5 i (taut vt)/(qR d_eta) beta1
    c = 0.5 * vt * b1 / (qR * de)
    lamr = 1.0 - c * tauti
    lami = c * tautr

    zr, zi = _cdiv(sbb, torch.zeros_like(sbb), lamr, lami)
    i0r, i0i, i1r, i1i, zsr, zsi = _bessel_i01_scaled_ri(zr, zi, tab)

    l2r, l2i = _cmul(lamr, lami, lamr, lami)
    l3ir, l3ii = _cinv(*_cmul(l2r, l2i, lamr, lami))

    # norm_vel = qR d_eta / (vt taut)
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

    # log-domain exponent (Parameters.cpp:156-175)
    er = -0.5 * nv2r + 0.5 * b1 * nvi - tauti * om_r - tautr * om_i
    ei = -0.5 * nv2i - 0.5 * b1 * nvr + tautr * om_r - tauti * om_i
    qir, qii = _cdiv(torch.zeros_like(b1), b1, nvr, nvi)
    etr, eti = _cdiv(-(ba + bb), torch.zeros_like(ba), 2.0 + qir, qii)
    er = er + etr - zsr
    ei = ei + eti - zsi

    keep = er >= kernels.SAFE_EXP_CUTOFF
    exr, exi = _cexp(torch.where(keep, er, kernels.SAFE_EXP_CUTOFF), ei)
    p0r, p0i = _cmul(i0cr, i0ci, i0r, i0i)
    p1r, p1i = _cmul(i1cr, i1ci, i1r, i1i)
    cr, ci = _cmul(exr, exi, p0r + p1r, p0i + p1i)
    cr = torch.where(keep, cr, 0.0)
    ci = torch.where(keep, ci, 0.0)

    # base = jacob / taut * core
    jtr, jti = _cmul(jacr, jaci, tinvr, tinvi)
    mr, mi = _cmul(jtr, jti, cr, ci)

    cols = []
    prev = 0
    for m in ms:
        for _ in range(m - prev):
            mr, mi = _cmul(mr, mi, nvr, nvi)
        prev = m
        cols += [torch.sum(mr * wk, dim=1), torch.sum(mi * wk, dim=1)]
    return torch.stack(cols, dim=1)


def _plain(mid, halfw, pair, scal, order, ms, chunk=_CHUNK):
    """The plain version of K1 over all pairs, ``chunk`` pairs at a time."""
    tab = _table_views(kernel_tables(order))
    npairs = mid.shape[0]
    out = torch.empty((npairs, 2 * len(ms)), dtype=mid.dtype, device=mid.device)
    for s in range(0, npairs, chunk):
        e = min(s + chunk, npairs)
        out[s:e] = _plain_block(mid[s:e], halfw[s:e], pair[s:e], scal, tab,
                                order, ms)
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def kappa_pairs_fused(p, eta, eta_p, omega, ms=(0,), quad=None):
    """Drop-in for ``kernels.kappa_f_tau`` on float32 pair lists (no
    embedded error output).  Returns a tuple of complex64 (npairs,) tensors.

    On CUDA tensors this launches K1 (and counts it in ``LAUNCHES``); on CPU
    tensors it runs the plain version."""
    ms = _check_ms(ms)
    if eta.device != eta_p.device or eta.dim() != 1 \
            or eta.shape != eta_p.shape:
        raise ValueError("eta and eta_p must be 1-d tensors of one shape "
                         "on one device")
    mid, halfw, pair, scal, order = _prepare(p, eta, eta_p, omega, quad)
    if eta.device.type == "cuda":
        out = _launch(mid, halfw, pair, scal, order, ms)
    elif eta.device.type == "cpu":
        out = _plain(mid, halfw, pair, scal, order, ms)
    else:
        raise ValueError(f"kappa_pairs_fused: no kernel for device {eta.device}")
    return _finish(p, out, ms)


def kappa_pairs_ref(p, eta, eta_p, omega, ms=(0,), quad=None,
                    chunk: int = _CHUNK):
    """The plain PyTorch version of ``kappa_pairs_fused``, on any device:
    the kernel's math (26/10 Bessel terms, the -40 clamp, the algebraic
    rotation), ``chunk`` pairs at a time."""
    ms = _check_ms(ms)
    mid, halfw, pair, scal, order = _prepare(p, eta, eta_p, omega, quad)
    return _finish(p, _plain(mid, halfw, pair, scal, order, ms, chunk), ms)
