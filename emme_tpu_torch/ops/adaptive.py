"""Float64 adaptive Gauss-Kronrod transit-time integrals: the plain PyTorch
version of kernel N1 (``csrc/adaptive.cu``).

Counterpart of the reference-exact C++ engine ``native/emme_native.cpp``
(``integrate_adaptive``, ``PairCtx``, ``bessel_i01``, ``g_eta``,
``bi_eta``), whose math this module copies operation for operation:

* the derived scalars and the five geometries' g(eta), b_i(eta) (the
  engine's regrouped stellarator form);
* the Miller-recurrence scaled I0/I1: start order
  N = floor(|w| + 9 sqrt|w|) + 24, rescaled by 1e-250 past 1e250;
* the integrand with omi = -copysign(1, Re omega), the -40 exponent cutoff
  and nv^m, on (re, im) float64 planes, each complex product and quotient
  written out as GCC's complex arithmetic evaluates it (Smith's division,
  libgcc ``__divdc3``), so that the kernel can repeat it line for line;
* G7K15 / G15K31 panels in x = atan(t) with the 1/cos^2 factor, and the
  engine's two-part acceptance test with its depth limit.

The engine subdivides depth first.  Its accept test is local to each
interval once the integral's ``abs_tol`` is known, and ``abs_tol`` comes
from the root panel, which is always popped first; so the set of accepted
panels does not depend on the visiting order.  This version runs breadth
first over every (integral, interval) at once and sums each integral's
accepted panels in order of their left end, which is the depth-first order
(left child first): the sum is the engine's, term for term.  The engine's
loop stops at 100,000 pops; a breadth-first pass cannot reproduce that
truncation, so an integral that reaches it raises, as does a root panel
whose integral is exactly zero and which splits (the engine would take
``abs_tol`` from a later panel).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..utils.timer import host_read

GEOMETRY_IDS = {
    "tokamak": 0,
    "stellarator": 1,
    "cylinder": 2,
    "cylinder old": 3,
    "taloyMagneticDrift": 4,   # sic -- reference spelling
}

MAX_POPS = 100000          # the engine's guard: at most MAX_POPS - 1 pops
HALF_PI = math.pi / 2.0    # the integration range [0, pi/2] in x = atan(t)
BIG, INV_BIG = 1e250, 1e-250
CUTOFF = -40.0             # Re(exponent) below which the integrand is 0
CHUNK = 32768              # integrals per breadth-first pass

# QUADPACK node tables as the engine holds them (emme_native.cpp:255-294)
K15_X = (0.0, 0.20778495500789847, 0.40584515137739717,
         0.58608723546769113, 0.74153118559939444, 0.86486442335976907,
         0.94910791234275852, 0.99145537112081264)
K15_WG = (0.41795918367346939, 0.38183005050511894, 0.27970539148927667,
          0.12948496616886969)
K15_WK = (2.09482141084727828e-01, 2.04432940075298892e-01,
          1.90350578064785410e-01, 1.69004726639267903e-01,
          1.40653259715525919e-01, 1.04790010322250184e-01,
          6.30920926299785533e-02, 2.29353220105292250e-02)
K31_X = (0.0, 0.1011420669187175, 0.20119409399743452, 0.29918000715316881,
         0.39415134707756337, 0.48508186364023968, 0.57097217260853885,
         0.65099674129741697, 0.72441773136017005, 0.79041850144246593,
         0.84820658341042722, 0.8972645323440819, 0.9372733924007059,
         0.96773907567913913, 0.98799251802048543, 0.99800229869339706)
K31_WG = (0.20257824192556112, 0.19843148532711152, 0.18616100001556193,
          0.1662692058169939, 0.1395706779261542, 0.10715922046717143,
          0.07036604748810768, 0.030753241996119)
K31_WK = (0.10133000701479155, 0.100769845523875595, 0.099173598721791959,
          0.0966427269836236785, 0.093126598170825321,
          0.0885644430562117706, 0.083080502823133021,
          0.0768496807577203789, 0.069854121318728259,
          0.0620095678006706403, 0.053481524690928087,
          0.0445897513247648766, 0.035346360791375846,
          0.0254608473267153202, 0.0150079473293161225,
          0.00537747987292334899)

_F64 = torch.float64


def gk_rule(order: int):
    """(X, WK, WG, gauss_order) of the engine's G7K15 (order 15) or G15K31
    (order 31) panel; X from the centre outward."""
    if order == 31:
        return K31_X, K31_WK, K31_WG, 15
    if order == 15:
        return K15_X, K15_WK, K15_WG, 7
    raise ValueError(f"the adaptive engine takes G-K order 15 or 31, got {order}")


# ---------------------------------------------------------------------------
# physics parameters (the engine's struct Phys)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Phys:
    """Plain-float mirror of the port's ``Params`` as the engine reads it."""
    q: float
    shat: float
    tau: float
    epsilon_n: float
    epsilon_r: float
    eta_i: float
    eta_e: float
    b_theta: float
    beta_e: float
    R: float
    vt: float
    omega_d_coeff: float
    length: float
    theta: float
    arc_coeff: float
    eta_k: float
    lh: float
    mh: float
    epsilon_h_t: float
    alpha_0: float
    r_over_R: float
    geometry: int
    gk_order: int
    integration_rel_tol: float
    precision_goal: float
    max_subdivide: int
    cylinder_shat_coeff: float

    @property
    def alpha(self):
        return (self.q * self.q * self.R * self.beta_e
                / (self.epsilon_n * self.R)
                * ((1 + self.eta_e) + 1 / self.tau * (1 + self.eta_i)))

    @property
    def omega_s_i(self):
        return -(math.sqrt(self.b_theta) * self.vt) / (self.epsilon_n * self.R)

    @property
    def omega_s_e(self):
        return -self.tau * self.omega_s_i

    @property
    def omega_d_bar(self):
        return 2.0 * self.epsilon_n * self.omega_s_i * self.omega_d_coeff


_PHYS_FLOATS = ("q", "shat", "tau", "epsilon_n", "epsilon_r", "eta_i",
                "eta_e", "b_theta", "beta_e", "R", "vt", "omega_d_coeff",
                "length", "theta", "arc_coeff", "eta_k", "lh", "mh",
                "epsilon_h_t", "alpha_0", "r_over_R")


def phys_from_params(p) -> Phys:
    """The engine's parameters from the port's ``Params``: G-K order from
    ``integration_start_points``, relative tolerance from
    ``integration_precision``, the absolute floor from
    ``integration_accuracy``, the depth limit from
    ``integration_iteration_limit``.  The scalars (0-d tensors; on the
    card, device tensors) are stacked and read in one copy, under
    ``layer.host_read``."""
    if p.conf not in GEOMETRY_IDS:
        raise ValueError(f"unknown geometry {p.conf!r}")
    keys = _PHYS_FLOATS + (("cyl_shat_coeff",) if p.conf == "cylinder"
                           else ())
    vals = dict(zip(keys, host_read(torch.Tensor.tolist, torch.stack(
        [getattr(p, k) for k in keys]).to(_F64))))
    return Phys(**{k: vals[k] for k in _PHYS_FLOATS},
                geometry=GEOMETRY_IDS[p.conf],
                gk_order=int(p.integration_start_points),
                integration_rel_tol=float(p.integration_precision),
                precision_goal=float(p.integration_accuracy),
                max_subdivide=int(p.integration_iteration_limit),
                cylinder_shat_coeff=vals.get("cyl_shat_coeff", 0.0))


# ---------------------------------------------------------------------------
# geometry (emme_native.cpp:67-144), float64 tensors
# ---------------------------------------------------------------------------

def g_eta(ph: Phys, eta):
    """The field-line integral of the magnetic drift, g(eta)."""
    a = ph.alpha
    if ph.geometry == 0:
        return (-(a * eta) / 2.0 + ph.shat * ph.theta * torch.cos(eta)
                - ph.shat * eta * torch.cos(eta) + torch.sin(eta)
                + ph.shat * torch.sin(eta) + 0.25 * a * torch.sin(2.0 * eta)
                - (1.0 - ph.shat) * ph.q * ph.epsilon_r
                / (ph.epsilon_r * ph.epsilon_r + ph.q * ph.q) * eta)
    if ph.geometry == 1:   # the engine's regrouped form, k = lh - mh q
        lh, u = ph.lh, ph.mh * ph.q
        k, S, E = lh - u, ph.shat, ph.epsilon_h_t
        A = -0.25 * a
        Rd = -a + (2.0 * S - 3.0) * A
        curv = (ph.mh / ph.lh * ph.r_over_R / (ph.q * ph.R) * (4.0 - S)
                + (-a + 2.0 * S * A) / ph.R)
        ARd = A * (1.0 + S) + Rd
        phs = eta * k - ph.alpha_0 * ph.mh
        km1, kp1, k2 = k - 1.0, k + 1.0, k * k
        num = (eta * km1 * k2 * kp1 * (A + curv * ph.R + Rd + A * S)
               - 2.0 * E * (eta - ph.eta_k) * lh * km1 * k * kp1 * S
               * torch.cos(phs)
               + 2.0 * k2 * km1 * kp1 * (1.0 + S) * torch.sin(eta)
               + torch.cos(eta)
               * (-2.0 * (eta - ph.eta_k) * km1 * k2 * kp1 * S
                  - ((lh * lh * lh * lh - lh * lh) + (u * u * u * u - u * u))
                  * ARd * torch.sin(eta))
               + torch.sin(2.0 * eta) * ARd * lh * u
               * (-1.0 + 2.0 * lh * lh - 3.0 * lh * u + 2.0 * u * u)
               + E * ARd * lh * k2 * (1.0 - k) * torch.sin(eta + phs)
               - E * ARd * lh * k2 * (1.0 + k) * torch.sin(eta - phs)
               - 2.0 * E * lh * km1 * kp1 * (k + S) * torch.sin(-phs))
        return num / (2.0 * km1 * k2 * kp1)
    if ph.geometry == 2:
        return eta * ph.cylinder_shat_coeff
    if ph.geometry == 3:
        return eta * 1.0
    S = ph.shat   # Taylor magnetic drift, Pade {3,4}
    den_c = (7.0 + 16.0 * a + 40.0 * a * a - 28.0 * S - 80.0 * a * S
             + 40.0 * S * S)
    e2 = eta * eta
    num = eta + (e2 * eta
                 * (-31.0 - 96.0 * a - 168.0 * a * a - 560.0 * a * a * a
                    + 186.0 * S + 672.0 * a * S + 1680.0 * a * a * S
                    - 504.0 * S * S - 1680.0 * a * S * S + 560.0 * S * S * S)
                 ) / (42.0 * den_c)
    den = (1.0
           + (e2 * (3.0 + 19.0 * a + 56.0 * a * a - 18.0 * S - 84.0 * a * S
                    + 28.0 * S * S)) / (7.0 * den_c)
           + (e2 * e2 * (11.0 - 4.0 * a + 704.0 * a * a - 88.0 * S
                         - 584.0 * a * S + 216.0 * S * S)) / (840.0 * den_c))
    return num / den


def bi_eta(ph: Phys, eta):
    """The FLR argument b_i(eta)."""
    a = ph.alpha
    if ph.geometry == 1:
        A = -0.25 * a
        Rd = -a + (2.0 * ph.shat - 3.0) * A
        sigma = (ph.shat * (eta - ph.eta_k)
                 + (A * (1.0 + ph.shat) + Rd) * torch.sin(eta))
        return ph.b_theta * (1.0 + sigma * sigma)
    s = ph.shat * (eta - ph.theta) - a * torch.sin(eta)
    return ph.b_theta * (1.0 + s * s)


def pair_rows(ph: Phys, eta, eta_p):
    """Per-pair inputs of the integrand, (n, 4) float64 on ``eta``'s
    device: [d_eta, beta1, b_i(eta), b_i(eta')] (the engine's PairCtx)."""
    eta = torch.as_tensor(eta, dtype=_F64)
    eta_p = torch.as_tensor(eta_p, dtype=_F64, device=eta.device)
    return rows_of(ph, eta - eta_p, g_eta(ph, eta) - g_eta(ph, eta_p),
                   bi_eta(ph, eta), bi_eta(ph, eta_p))


def rows_of(ph: Phys, d_eta, dg, bie, bip):
    """``pair_rows`` from eta - eta', g(eta) - g(eta'), b_i(eta) and
    b_i(eta'), which a caller may gather from values on a grid."""
    beta1 = (ph.q * ph.R) / ph.vt * ph.omega_d_bar * dg
    return torch.stack([d_eta, beta1, bie, bip], dim=1).contiguous()


# ---------------------------------------------------------------------------
# complex arithmetic on (re, im) planes, as GCC evaluates std::complex
# ---------------------------------------------------------------------------

def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv(a, b, c, d):
    """(a + ib) / (c + id): Smith's algorithm, libgcc's __divdc3."""
    small = torch.abs(c) < torch.abs(d)
    r1 = c / d
    den1 = c * r1 + d
    r2 = d / c
    den2 = d * r2 + c
    x = torch.where(small, (a * r1 + b) / den1, (b * r2 + a) / den2)
    y = torch.where(small, (b * r1 - a) / den1, (b - a * r2) / den2)
    return x, y


def _rdiv(a, c, d):
    """a / (c + id) for real a: __divdc3 with b = 0."""
    small = torch.abs(c) < torch.abs(d)
    r = torch.where(small, c / d, d / c)
    den = torch.where(small, c * r + d, d * r + c)
    ar = a * r
    return (torch.where(small, ar, a) / den,
            torch.where(small, -a, -ar) / den)


def _idiv(b, c, d):
    """ib / (c + id) for real b: __divdc3 with a = 0."""
    small = torch.abs(c) < torch.abs(d)
    r = torch.where(small, c / d, d / c)
    den = torch.where(small, c * r + d, d * r + c)
    br = b * r
    return (torch.where(small, b, br) / den,
            torch.where(small, br, b) / den)


# ---------------------------------------------------------------------------
# Miller scaled I0 / I1 (emme_native.cpp:168-197)
# ---------------------------------------------------------------------------

def bessel_i01(zr, zi):
    """The engine's scaled I0/I1 of z = zr + i zi (float64 planes):
    returns (i0r, i0i, i1r, i1i, zsr, zsi, iters), i_n = I_n(z) e^{zs},
    zs = z if Re z < 0 else -z, and the recurrence's steps per element."""
    zero = (zr == 0.0) & (zi == 0.0)
    neg = zr < 0.0
    zsr = torch.where(neg, zr, -zr)
    zsi = torch.where(neg, zi, -zi)
    wr = torch.where(neg, -zr, zr)
    wi = torch.where(neg, -zi, zi)
    aw = torch.hypot(wr, wi)
    n_start = (aw + 9.0 * torch.sqrt(aw)).to(torch.int64) + 24
    n_start = torch.where(zero, torch.zeros_like(n_start), n_start)
    # 2k / w by Smith with b = 0: ratio and denominator do not depend on k
    wr1 = torch.where(zero, torch.ones_like(wr), wr)
    small = torch.abs(wr1) < torch.abs(wi)
    ratio = torch.where(small, wr1 / wi, wi / wr1)
    den = torch.where(small, wr1 * ratio + wi, wi * ratio + wr1)

    # descending start order: the elements still in the recurrence at step
    # k are a prefix
    order = torch.argsort(n_start, descending=True, stable=True)
    ns = n_start[order]
    small, ratio, den = small[order], ratio[order], den[order]
    m = ns.numel()
    ykr = torch.ones(m, dtype=_F64, device=zr.device)
    yki = torch.zeros_like(ykr)
    yk1r, yk1i = torch.zeros_like(ykr), torch.zeros_like(ykr)
    sr, si = torch.zeros_like(ykr), torch.zeros_like(ykr)
    y1r, y1i = torch.zeros_like(ykr), torch.zeros_like(ykr)
    n_max = int(ns[0]) if m else 0
    live = torch.searchsorted(-ns, -torch.arange(n_max, 0, -1,
                                                 device=ns.device),
                              right=True).tolist() if n_max else []
    for k, L in zip(range(n_max, 0, -1), live):
        a = 2.0 * k
        sm, rt, dn = small[:L], ratio[:L], den[:L]
        ar = a * rt
        tr = torch.where(sm, ar, torch.full_like(ar, a)) / dn
        ti = torch.where(sm, torch.full_like(ar, -a), -ar) / dn
        cr, ci = ykr[:L], yki[:L]
        pr, pi = _cmul(tr, ti, cr, ci)
        nr = pr + yk1r[:L]
        ni = pi + yk1i[:L]
        sr[:L] = sr[:L] + 2.0 * cr
        si[:L] = si[:L] + 2.0 * ci
        if k == 1:
            y1r[:L], y1i[:L] = cr, ci
        yk1r[:L], yk1i[:L] = cr, ci
        big = torch.hypot(nr, ni) > BIG
        # float64 factors: torch.where of two Python floats is float32,
        # where 1e-250 is 0
        sc = torch.where(big, torch.full_like(nr, INV_BIG),
                         torch.ones_like(nr))
        ykr[:L], yki[:L] = nr * sc, ni * sc
        yk1r[:L], yk1i[:L] = yk1r[:L] * sc, yk1i[:L] * sc
        sr[:L], si[:L] = sr[:L] * sc, si[:L] * sc
        y1r[:L], y1i[:L] = y1r[:L] * sc, y1i[:L] * sc
    Sr, Si = sr + ykr, si + yki
    i0r, i0i = _cdiv(ykr, yki, Sr, Si)
    i1r, i1i = _cdiv(y1r, y1i, Sr, Si)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(m, device=order.device)
    i0r, i0i, i1r, i1i = i0r[inv], i0i[inv], i1r[inv], i1i[inv]
    negf = torch.where(neg, -1.0, 1.0)
    i1r, i1i = i1r * negf, i1i * negf
    one = torch.ones_like(zr)
    nil = torch.zeros_like(zr)
    return (torch.where(zero, one, i0r), torch.where(zero, nil, i0i),
            torch.where(zero, nil, i1r), torch.where(zero, nil, i1i),
            torch.where(zero, nil, zsr), torch.where(zero, nil, zsi),
            n_start)


# ---------------------------------------------------------------------------
# the integrand (PairCtx::operator(), emme_native.cpp:221-248)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Scalars:
    """The integrand's scalars: omega, arc_coeff, q R, vt, omega_s_i, eta_i,
    and the acceptance test's rel_tol and precision_goal."""
    om_r: float
    om_i: float
    arc: float
    qR: float
    vt: float
    wsi: float
    eta_i: float
    rel_tol: float
    precision_goal: float
    order: int
    max_subdivide: int


def scalars(ph: Phys, omega) -> Scalars:
    omega = complex(omega)
    return Scalars(omega.real, omega.imag, ph.arc_coeff, ph.q * ph.R, ph.vt,
                   ph.omega_s_i, ph.eta_i, ph.integration_rel_tol,
                   ph.precision_goal, ph.gk_order, ph.max_subdivide)


def integrand(x, rows, m, sc: Scalars):
    """f(tan x) / cos^2 x at nodes x (float64) for the pairs ``rows``
    (one row a node) and moments ``m``: (re, im, miller steps)."""
    d_eta, beta1, bie, bip = rows.unbind(1)
    t = torch.tan(x)
    c = torch.cos(x)
    omi = -math.copysign(1.0, sc.om_r)
    sqrt_bb = torch.sqrt(bie * bip)
    phi = (-omi) * torch.atan(t / sc.arc)
    ear, eai = torch.cos(phi), torch.sin(phi)
    taur, taui = t * ear, t * eai
    dj = sc.arc * (1.0 + (t / sc.arc) * (t / sc.arc))
    jr = ear - (-eai * omi) * t / dj
    ji = eai - (ear * omi) * t / dj
    qrd = sc.qR * d_eta
    lr = 1.0 + (-0.5 * (taui * sc.vt)) / qrd * beta1
    li = (0.5 * (taur * sc.vt)) / qrd * beta1
    zr, zi = _rdiv(sqrt_bb, lr, li)
    i0r, i0i, i1r, i1i, zsr, zsi, iters = bessel_i01(zr, zi)
    l2r, l2i = _cmul(lr, li, lr, li)
    l3r, l3i = _cmul(l2r, l2i, lr, li)
    l3r, l3i = _rdiv(1.0, l3r, l3i)
    nvr, nvi = _rdiv(qrd, sc.vt * taur, sc.vt * taui)
    hr, hi = _cmul(0.5 * nvr, 0.5 * nvi, nvr, nvi)
    hr = sc.eta_i * (hr - 1.5)
    hi = sc.eta_i * hi
    ar_, ai_ = _cdiv(sc.om_r - sc.wsi * (1.0 + hr), sc.om_i - sc.wsi * hi,
                     lr, li)
    we = sc.wsi * sc.eta_i
    br_, bi_ = _cmul(we * (0.5 * (bie + bip) - lr), we * (-li), l3r, l3i)
    i0cr, i0ci = ar_ + br_, ai_ + bi_
    w1 = -sc.wsi * sc.eta_i * sqrt_bb
    i1cr, i1ci = w1 * l3r, w1 * l3i
    Ar, Ai = _cmul(-0.5 * nvr, -0.5 * nvi, nvr, nvi)
    hb = 0.5 * beta1
    Br, Bi = -(hb * nvi), hb * nvr
    Cr, Ci = _cmul(-taui, taur, sc.om_r, sc.om_i)
    Er, Ei = _idiv(beta1, nvr, nvi)
    Gr, Gi = _rdiv(bie + bip, 2.0 + Er, Ei)
    lcr = ((Ar - Br) + Cr) - Gr
    lci = ((Ai - Bi) + Ci) - Gi
    xr, xi = lcr - zsr, lci - zsi
    cut = xr < CUTOFF
    sqr, sqi = _cmul(nvr, nvi, nvr, nvi)
    nmr = torch.where(m >= 2, sqr, torch.where(m == 1, nvr, 1.0))
    nmi = torch.where(m >= 2, sqi, torch.where(m == 1, nvi, 0.0))
    fr, fi = _cdiv(nmr, nmi, taur, taui)
    fr, fi = _cmul(fr, fi, jr, ji)
    ex = torch.exp(xr)
    fr, fi = _cmul(fr, fi, ex * torch.cos(xi), ex * torch.sin(xi))
    s0r, s0i = _cmul(i0cr, i0ci, i0r, i0i)
    s1r, s1i = _cmul(i1cr, i1ci, i1r, i1i)
    fr, fi = _cmul(fr, fi, s0r + s1r, s0i + s1i)
    fr = torch.where(cut, 0.0, fr)
    fi = torch.where(cut, 0.0, fi)
    cc = c * c
    return fr / cc, fi / cc, iters


# ---------------------------------------------------------------------------
# the adaptive rule, breadth first (integrate_adaptive, emme_native.cpp:319)
# ---------------------------------------------------------------------------

def _panel(lo, hi, rows, m, sc: Scalars):
    """One G-K panel per interval: (integral re, im, error, miller steps)."""
    X, WK, WG, gauss = gk_rule(sc.order)
    nh = len(X)
    mid = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo)
    cols = [mid]
    for i in range(1, nh):
        cols += [mid + half * X[i], mid - half * X[i]]
    nn = len(cols)
    x = torch.stack(cols, dim=1).reshape(-1)
    fr, fi, it = integrand(x, rows.repeat_interleave(nn, dim=0),
                           m.repeat_interleave(nn), sc)
    fr, fi = fr.reshape(-1, nn), fi.reshape(-1, nn)
    gkr = 0.0 + WK[0] * fr[:, 0]
    gki = 0.0 + WK[0] * fi[:, 0]
    gr = 0.0 + WG[0] * fr[:, 0]
    gi = 0.0 + WG[0] * fi[:, 0]
    for i in range(1, nh):
        vr = fr[:, 2 * i - 1] + fr[:, 2 * i]
        vi = fi[:, 2 * i - 1] + fi[:, 2 * i]
        gkr = gkr + WK[i] * vr
        gki = gki + WK[i] * vi
        if (gauss - i) % 2 != 0:
            gr = gr + WG[i // 2] * vr
            gi = gi + WG[i // 2] * vi
    err = torch.hypot(gkr - gr, gki - gi) * half
    return gkr * half, gki * half, err, it.reshape(-1, nn).sum(dim=1), mid, half


def _integrate_chunk(rows, m, sc: Scalars):
    n = rows.shape[0]
    dev = rows.device
    idx = torch.arange(n, device=dev)
    lo = torch.zeros(n, dtype=_F64, device=dev)
    hi = torch.full((n,), HALF_PI, dtype=_F64, device=dev)
    abs_tol = torch.zeros(n, dtype=_F64, device=dev)
    pops = torch.zeros(n, dtype=torch.int64, device=dev)
    miller = torch.zeros(n, dtype=torch.int64, device=dev)
    inv_scale = 2.0 / HALF_PI
    scale = (math.ldexp(1.0, sc.max_subdivide) if sc.max_subdivide <= 1023
             else math.inf)
    acc = []
    root = True
    while idx.numel():
        ir, ii, err, it, mid, half = _panel(lo, hi, rows[idx], m[idx], sc)
        pops.index_add_(0, idx, torch.ones_like(idx))
        miller.index_add_(0, idx, it)
        if int(pops.max()) >= MAX_POPS:
            raise RuntimeError(f"adaptive quadrature: an integral needs more "
                               f"than {MAX_POPS - 1} panels, where the "
                               f"engine stops")
        cur = torch.hypot(sc.rel_tol * ir, sc.rel_tol * ii)
        if root:
            abs_tol = cur.clone()
        can_split = half * scale > 0.99 * HALF_PI     # ldexp(half, depth)
        split = (can_split & (err > abs_tol[idx] * inv_scale + sc.precision_goal)
                 & (err > cur + sc.precision_goal))
        if root and bool((split & (abs_tol == 0.0)).any()):
            raise RuntimeError("adaptive quadrature: a root panel with an "
                               "exactly zero integral splits; the engine's "
                               "tolerance would come from a later panel")
        root = False
        keep = ~split
        acc.append((idx[keep], lo[keep], ir[keep], ii[keep]))
        idx, lo, mid, hi = idx[split], lo[split], mid[split], hi[split]
        idx = torch.cat([idx, idx])
        lo, hi = torch.cat([lo, mid]), torch.cat([mid, hi])
    a_idx, a_lo, a_r, a_i = (torch.cat(v) for v in zip(*acc))
    # the depth-first order: by integral, then by left end
    o = torch.argsort(a_lo, stable=True)
    o = o[torch.argsort(a_idx[o], stable=True)]
    a_idx, a_r, a_i = a_idx[o], a_r[o], a_i[o]
    counts = torch.bincount(a_idx, minlength=n)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(a_idx.numel(), device=dev) - start[a_idx]
    width = int(counts.max())
    pr = torch.zeros((n, width), dtype=_F64, device=dev)
    pi = torch.zeros((n, width), dtype=_F64, device=dev)
    pr[a_idx, rank] = a_r
    pi[a_idx, rank] = a_i
    sr = torch.zeros(n, dtype=_F64, device=dev)
    si = torch.zeros(n, dtype=_F64, device=dev)
    for j in range(width):
        sr = sr + pr[:, j]
        si = si + pi[:, j]
    return sr, si, pops, miller


def integrate_ref(rows, m, sc: Scalars):
    """The plain version of N1 on any device: for each integral (a row of
    ``rows`` with its moment ``m``) the engine's adaptive integral of the
    transit-time integrand over t in [0, inf).  Returns (values (n, 2)
    float64 [re, im], panels (n,) int32, miller steps (n,) int64)."""
    gk_rule(sc.order)
    n = rows.shape[0]
    out = torch.empty((n, 2), dtype=_F64, device=rows.device)
    panels = torch.empty(n, dtype=torch.int32, device=rows.device)
    miller = torch.empty(n, dtype=torch.int64, device=rows.device)
    m = m.to(device=rows.device, dtype=torch.int32)
    for s in range(0, n, CHUNK):
        sr, si, pops, it = _integrate_chunk(rows[s:s + CHUNK],
                                            m[s:s + CHUNK], sc)
        out[s:s + CHUNK, 0], out[s:s + CHUNK, 1] = sr, si
        panels[s:s + CHUNK] = pops.to(torch.int32)
        miller[s:s + CHUNK] = it
    return out, panels, miller


def ion_prefactor(ph: Phys, values):
    """kappa_ion = -i q R / (vt sqrt(2 pi)) * integral, as the engine
    evaluates it: (n, 2) float64 -> complex128."""
    c1 = (-(ph.q * ph.R)) / (ph.vt * math.sqrt(2.0 * math.pi))
    return torch.complex(-(c1 * values[:, 1]), c1 * values[:, 0])


@dataclass(frozen=True, eq=False)
class ElectronPairs:
    """The omega-free half of the electron term for pairs (eta, eta'), made
    once for any number of omega: d = eta - eta', sgn(d), C sgn(d) with
    C = q^2 R^2 / (2 vt^2 tau), and b1e vt / (q R), b1e from
    g(eta) - g(eta'); each as ``kappa_electron`` evaluates it."""
    d: torch.Tensor
    sgn: torch.Tensor
    c_sgn: torch.Tensor
    b1e_v: torch.Tensor

    @property
    def shape(self):
        """The pairs' shape, as ``kappa_electron``'s ``eta`` has it."""
        return self.d.shape


def electron_pairs(ph: Phys, d, dg) -> ElectronPairs:
    """``ElectronPairs`` of pairs (eta, eta') from d = eta - eta' and
    dg = g(eta) - g(eta') (float64 tensors)."""
    sgn = d / torch.abs(d)
    wse = ph.omega_s_e
    b1e = ((ph.q * ph.R) / ph.vt * (ph.omega_d_bar * wse / ph.omega_s_i)
           * dg)
    return ElectronPairs(
        d, sgn,
        (ph.q * ph.q * ph.R * ph.R) / (2.0 * ph.vt * ph.vt * ph.tau) * sgn,
        b1e * ph.vt / (ph.q * ph.R))


def kappa_electron(ph: Phys, m, eta, eta_p, omega):
    """The engine's closed-form electron term (emme_native.cpp:367-389),
    complex128; m per element in {0, 1, 2}.  ``eta`` may instead be the
    pairs' ``ElectronPairs``, with ``eta_p`` None: then only the
    omega-dependent factors are computed."""
    e = eta if eta_p is None else electron_pairs(
        ph, eta - eta_p, g_eta(ph, eta) - g_eta(ph, eta_p))
    wse = ph.omega_s_e
    omega = complex(omega)
    k1 = (-1j * (ph.q * ph.R) / (2.0 * ph.vt * ph.tau) * (omega - wse)) * e.sgn
    k2 = e.c_sgn * (omega * (omega - wse) * e.d
                    - e.b1e_v * (omega - wse * (1.0 + ph.eta_e)))
    return torch.where(m == 1, k1, torch.where(m >= 2, k2,
                                               torch.zeros_like(k2)))
