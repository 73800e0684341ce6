"""Plain reference of EMME's kernel-integral operator M(omega).

A frozen copy of the algorithm, in plain PyTorch, for judging what the
program returns: the geometry (``Parameters.cpp`` of the upstream code),
the ion kernel kappa_f_tau as a contour-rotated transit-time integral with
scaled complex Bessel I0 / I1, on graded Gauss-Kronrod panels, the closed
electron kernels, the singularity correction and the operator's block
layout (``solver.h:439-511``).  It imports nothing of the program and
takes nothing the program made: every value is worked out again from the
configuration's input dict.

Two uses:

* ``operator_rows``: rows of M(omega) in float64 on the float64 panel mesh
  (200 panels a pair), for the residual of a returned eigenpair.
* ``assemble`` and ``trace_secant``: the whole operator and its Newton
  iteration at another precision, the control of the eigen cells.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

SAFE_EXP_CUTOFF = -40.0
# panels a pair: shoulder, oscillatory bulk, tail (float64 over-resolves on
# purpose; the float32 counts reach the same eigenvalue to ~1e-7)
MESH = {"float64": (40, 144, 16), "float32": (8, 32, 4)}
# singularity correction by |i - j| (singularity_handler.cpp:3-24)
SING = (0.0, 2.951388888888883, -2.4305555555555305, 4.166666666667441,
        -0.3472222222224549, 1.159722222222284)


@dataclass(frozen=True)
class Phys:
    """The input's physics as Python floats."""
    conf: str
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
    arc: float
    wb_para: float
    wb_perp: float
    eta_k: float
    lh: float
    mh: float
    eps_h_t: float
    alpha_0: float
    r_over_R: float
    npoints: int
    order: int

    @property
    def electromagnetic(self) -> bool:
        return self.beta_e != 0.0

    @property
    def alpha(self):
        return (self.q * self.q * self.R * self.beta_e
                / (self.epsilon_n * self.R)
                * ((1.0 + self.eta_e) + (1.0 + self.eta_i) / self.tau))

    @property
    def omega_s_i(self):
        return -math.sqrt(self.b_theta) * self.vt / (self.epsilon_n * self.R)

    @property
    def omega_s_e(self):
        return -self.tau * self.omega_s_i

    @property
    def omega_d_bar(self):
        return 2.0 * self.epsilon_n * self.omega_s_i * self.omega_d_coeff


def phys(inp: dict) -> Phys:
    """``Phys`` of an EMME input dict (Parameters.cpp:36-66)."""
    g = inp.get
    return Phys(
        conf=inp["conf"], q=float(inp["q"]), shat=float(inp["shat"]),
        tau=float(inp["tau"]), epsilon_n=float(inp["epsilon_n"]),
        epsilon_r=float(g("epsilon_r", 0.0)), eta_i=float(inp["eta_i"]),
        eta_e=float(inp["eta_e"]), b_theta=float(inp["k_rho"]) ** 2,
        beta_e=float(inp["beta_e"]), R=float(inp["R"]), vt=float(inp["vt"]),
        omega_d_coeff=float(g("omega_d_coeff", 1.0)),
        length=float(inp["length"]), theta=float(g("theta", 0.0)),
        arc=float(g("arc_coeff", 100.0)),
        wb_para=float(g("water_bag_weight_vpara", 1.0)),
        wb_perp=float(g("water_bag_weight_vperp", 1.0)),
        eta_k=float(g("eta_k", 0.0)), lh=float(g("lh", 1.0)),
        mh=float(g("mh", 1.0)), eps_h_t=float(g("epsilon_h_t", 0.0)),
        alpha_0=float(g("alpha_0", 0.0)), r_over_R=float(g("r_over_R", 0.0)),
        npoints=int(inp["npoints"]),
        order=int(g("integration_start_points", 15)))


# ---------------------------------------------------------------------------
# geometry (Parameters.cpp:76-100, 211-393)
# ---------------------------------------------------------------------------

def g_drift(ph: Phys, eta):
    """Field-line integral of the magnetic drift, g(eta)."""
    a = ph.alpha
    if ph.conf == "tokamak":
        return (-(a * eta) / 2.0 + ph.shat * ph.theta * torch.cos(eta)
                - ph.shat * eta * torch.cos(eta) + torch.sin(eta)
                + ph.shat * torch.sin(eta) + 0.25 * a * torch.sin(2.0 * eta)
                # pow(x, 3 / 2) with the C++ integer 3 / 2 == 1
                - (1.0 - ph.shat) * ph.q * ph.epsilon_r
                / (ph.epsilon_r ** 2 + ph.q ** 2) * eta)
    if ph.conf != "stellarator":
        raise ValueError(f"no reference geometry for {ph.conf!r}")
    lh, u = ph.lh, ph.mh * ph.q
    k = lh - u
    S, E = ph.shat, ph.eps_h_t
    A = -0.25 * a
    Rd = -a + (2.0 * S - 3.0) * A
    curv = (ph.mh / ph.lh * ph.r_over_R / (ph.q * ph.R) * (4.0 - S)
            + (-a + 2.0 * S * A) / ph.R)
    ARd = A * (1.0 + S) + Rd
    phase = eta * k - ph.alpha_0 * ph.mh
    km1, kp1 = k - 1.0, k + 1.0
    num = (eta * km1 * k**2 * kp1 * (A + curv * ph.R + Rd + A * S)
           - 2.0 * E * (eta - ph.eta_k) * lh * km1 * k * kp1 * S
           * torch.cos(phase)
           + 2.0 * k**2 * km1 * kp1 * (1.0 + S) * torch.sin(eta)
           + torch.cos(eta) * (
               -2.0 * (eta - ph.eta_k) * km1 * k**2 * kp1 * S
               - ((lh**4 - lh**2) + (u**4 - u**2)) * ARd * torch.sin(eta))
           + torch.sin(2.0 * eta) * ARd * lh * u
           * (-1.0 + 2.0 * lh**2 - 3.0 * lh * u + 2.0 * u**2)
           + E * ARd * lh * k**2 * (1.0 - k) * torch.sin(eta + phase)
           - E * ARd * lh * k**2 * (1.0 + k) * torch.sin(eta - phase)
           - 2.0 * E * lh * km1 * kp1 * (k + S) * torch.sin(-phase))
    return num / (2.0 * km1 * k**2 * kp1)


def b_flr(ph: Phys, eta):
    """FLR argument b_i(eta)."""
    a = ph.alpha
    if ph.conf == "stellarator":
        A = -0.25 * a
        Rd = -a + (2.0 * ph.shat - 3.0) * A
        sigma = (ph.shat * (eta - ph.eta_k)
                 + (A * (1.0 + ph.shat) + Rd) * torch.sin(eta))
        return ph.b_theta * (1.0 + sigma**2)
    return ph.b_theta * (1.0 + (ph.shat * (eta - ph.theta)
                                - a * torch.sin(eta)) ** 2)


def beta_1(ph: Phys, eta, eta_p, electron: bool = False):
    scale = ph.omega_s_e / ph.omega_s_i if electron else 1.0
    return (ph.q * ph.R / ph.vt * ph.omega_d_bar * scale
            * (g_drift(ph, eta) - g_drift(ph, eta_p)))


# ---------------------------------------------------------------------------
# scaled complex Bessel I0 / I1: Taylor for |w| <= 12, asymptotic beyond
# ---------------------------------------------------------------------------

def _asym(nu: int, terms: int) -> np.ndarray:
    a = np.ones(terms)
    for k in range(1, terms):
        a[k] = a[k - 1] * (4 * nu * nu - (2 * k - 1) ** 2) / (k * 8.0)
    return a


def bessel_i01_scaled(z, taylor: int = 44, asym: int = 14):
    """(I0(z) e^{zs}, I1(z) e^{zs}, zs), zs = z if Re z < 0 else -z."""
    neg = z.real < 0
    zs = torch.where(neg, z, -z)
    w = torch.where(neg, -z, z)
    aw = w.abs()
    q = 0.25 * w * w
    t0 = torch.ones_like(w)
    t1 = torch.ones_like(w)
    for k in range(taylor, 0, -1):
        t0 = 1.0 + t0 * q / (k * k)
        t1 = 1.0 + t1 * q / (k * (k + 1))
    scale = torch.exp(-w)
    i0_t = t0 * scale
    i1_t = 0.5 * w * t1 * scale
    a0, a1 = _asym(0, asym), _asym(1, asym)
    winv = 1.0 / torch.where(aw == 0, torch.ones_like(w), w)
    s0m = s0p = s1m = s1p = torch.zeros_like(w)
    for k in range(asym - 1, -1, -1):
        sg = (-1.0) ** k
        s0m = s0m * winv + sg * a0[k]
        s0p = s0p * winv + a0[k]
        s1m = s1m * winv + sg * a1[k]
        s1p = s1p * winv + a1[k]
    pref = 1.0 / torch.sqrt(2.0 * math.pi * w)
    sgn = torch.where(w.imag >= 0, 1.0, -1.0).to(aw.dtype)
    e2 = torch.exp(-2.0 * w)
    i0_a = pref * (s0m + 1j * sgn * e2 * s0p)
    i1_a = pref * (s1m - 1j * sgn * e2 * s1p)
    small = aw <= 12.0
    i0 = torch.where(small, i0_t, i0_a)
    i1 = torch.where(small, i1_t, i1_a)
    return i0, torch.where(neg, -i1, i1), zs


# ---------------------------------------------------------------------------
# the ion kernel (Parameters.cpp:113-184) on graded G-K panels
# ---------------------------------------------------------------------------

_GK = {  # non-negative abscissae, Gauss weights, Kronrod weights (QUADPACK)
    15: ([0.0, 0.20778495500789847, 0.40584515137739717,
          0.58608723546769113, 0.74153118559939444, 0.86486442335976907,
          0.94910791234275852, 0.99145537112081264],
         [2.09482141084727828e-01, 2.04432940075298892e-01,
          1.90350578064785410e-01, 1.69004726639267903e-01,
          1.40653259715525919e-01, 1.04790010322250184e-01,
          6.30920926299785533e-02, 2.29353220105292250e-02]),
    31: ([0.0, 0.1011420669187175, 0.20119409399743452, 0.29918000715316881,
          0.39415134707756337, 0.48508186364023968, 0.57097217260853885,
          0.65099674129741697, 0.72441773136017005, 0.79041850144246593,
          0.84820658341042722, 0.8972645323440819, 0.9372733924007059,
          0.96773907567913913, 0.98799251802048543, 0.99800229869339706],
         [0.10133000701479155, 0.100769845523875595, 0.099173598721791959,
          0.0966427269836236785, 0.093126598170825321, 0.0885644430562117706,
          0.083080502823133021, 0.0768496807577203789, 0.069854121318728259,
          0.0620095678006706403, 0.053481524690928087, 0.0445897513247648766,
          0.035346360791375846, 0.0254608473267153202,
          0.0150079473293161225, 0.00537747987292334899]),
}


def kronrod(order: int):
    """Kronrod nodes and weights of the whole rule on [-1, 1]."""
    x, w = (np.asarray(a) for a in _GK[order])
    return (np.concatenate([-x[:0:-1], x]),
            np.concatenate([w[:0:-1], w]))


def panel_bounds(ph: Phys, d_eta_abs, omega: complex, mesh):
    """Graded panel boundaries of the transit-time integral: geometric
    through the Gaussian turn-on at q R |d_eta| / vt, linear through the
    oscillation, geometric in the tail."""
    n_sh, n_osc, n_tail = mesh
    a = ph.q * ph.R * d_eta_abs / ph.vt
    t_a = a / 12.0 + 1e-8
    t_b = torch.clamp_min(3.0 * a, 1.0)
    rate_far = max(abs(omega.real), omega.imag, 0.02)
    rate_near = max(omega.imag, 0.0)
    t_cut = 45.0 / rate_near if rate_near > 0.05 \
        else 45.0 / rate_far + 4.0 * ph.arc
    t_c = torch.clamp_min(torch.clamp_min(4.0 * t_b, t_cut), 50.0)
    t_d = 50.0 * t_c

    def frac(n):
        return torch.arange(n + 1, dtype=a.dtype, device=a.device) / n

    def geo(lo, hi, n):
        return torch.exp(torch.log(lo)[:, None]
                         + torch.log(hi / lo)[:, None] * frac(n))

    def lin(lo, hi, n):
        return lo[:, None] + (hi - lo)[:, None] * frac(n)

    return torch.cat([geo(t_a, t_b, n_sh), lin(t_b, t_c, n_osc)[:, 1:],
                      geo(t_c, t_d, n_tail)[:, 1:]], dim=1)


def kappa_ion(ph: Phys, eta, eta_p, omega: complex, ms, mesh):
    """The ion kernel's moments ``ms`` for the pairs (eta, eta'), (npairs,)
    each, in eta's dtype."""
    rdt = eta.dtype
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    dev = eta.device
    xg, wk = kronrod(ph.order)
    bounds = panel_bounds(ph, (eta - eta_p).abs(), omega, mesh)
    mid = 0.5 * (bounds[:, 1:] + bounds[:, :-1])
    hw = 0.5 * (bounds[:, 1:] - bounds[:, :-1])
    t = (mid[:, :, None] + hw[:, :, None]
         * torch.as_tensor(xg, dtype=rdt, device=dev))
    wt = hw[:, :, None] * torch.as_tensor(wk, dtype=rdt, device=dev)
    e, ep = eta[:, None, None], eta_p[:, None, None]

    omi = 1.0 if omega.real < 0 else -1.0
    om = torch.as_tensor(omega, dtype=cdt, device=dev)
    rot = torch.exp(-omi * 1j * torch.atan(t / ph.arc))
    taut = t * rot
    jacob = rot - 1j * rot * omi * t / (ph.arc * (1.0 + (t / ph.arc) ** 2))
    b1 = beta_1(ph, e, ep)
    d = e - ep
    lam = 1.0 + 0.5j * taut * ph.vt / (ph.q * ph.R * d) * b1
    bi_a, bi_b = b_flr(ph, e), b_flr(ph, ep)
    sbb = torch.sqrt(bi_a * bi_b)
    terms = (44, 14) if rdt == torch.float64 else (26, 10)
    i0, i1, zs = bessel_i01_scaled(sbb / lam, *terms)
    lam3_inv = 1.0 / lam**3
    nv = ph.q * ph.R * d / (ph.vt * taut)
    nv2 = nv * nv
    wsi, ei = ph.omega_s_i, ph.eta_i
    c0 = ((om - wsi * (1.0 + ei * (0.5 * nv2 - 1.5))) / lam
          + wsi * ei * (0.5 * (bi_a + bi_b) - lam) * lam3_inv)
    c1 = -wsi * ei * sbb * lam3_inv
    expo = (-0.5 * nv2 - 0.5j * b1 * nv + 1j * taut * om
            - (bi_a + bi_b) / (2.0 + 1j * b1 / nv) - zs)
    keep = expo.real >= SAFE_EXP_CUTOFF
    core = torch.where(
        keep, torch.exp(torch.where(keep, expo, SAFE_EXP_CUTOFF))
        * (c0 * i0 + c1 * i1), 0.0)
    base = jacob / taut * core
    pref = -1j * ph.q * ph.R / (ph.vt * math.sqrt(2.0 * math.pi))
    mom = {0: 1.0, 1: nv, 2: nv2}
    return tuple(pref * (base * mom[m] * wt).sum(dim=(1, 2)) for m in ms)


def kappa_electron(ph: Phys, eta, eta_p, omega: complex, m: int):
    """The closed electron kernels (Parameters.cpp:186-209), m = 1, 2."""
    d = eta - eta_p
    sgn = torch.sign(d)
    wse = ph.omega_s_e
    if m == 1:
        return (-1j * ph.q * ph.R / (2.0 * ph.vt * ph.tau)
                * (omega - wse) * sgn)
    b1e = beta_1(ph, eta, eta_p, electron=True)
    return ((ph.q * ph.R) ** 2 / (2.0 * ph.vt**2 * ph.tau) * sgn
            * (omega * (omega - wse) * d
               - b1e * ph.vt / (ph.q * ph.R)
               * (omega - wse * (1.0 + ph.eta_e))))


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------

def grid(ph: Phys, dtype, device):
    n = ph.npoints
    dx = 2.0 * ph.length / (n - 1)
    eta = -ph.length + dx * torch.arange(n, dtype=dtype, device=device)
    return eta, dx


def sing_coeff(n: int, a, b, dtype):
    """Correction of the pair (a, b), a < b index tensors: by b - a, and
    -0.5 where b is the last column."""
    c = torch.as_tensor(SING, dtype=dtype, device=a.device)
    dij = b - a
    base = torch.where(dij <= 5, c[dij.clamp(max=5)],
                       torch.ones((), dtype=dtype, device=a.device))
    return base - 0.5 * (b == n - 1).to(dtype)


def _pair_kernels(ph, eta, a, b, omega, mesh, chunk):
    """The operator's kernels of the index pairs (a, b), a < b: kappa0 and,
    electromagnetic, kappa1 and kappa2 with the electrons'."""
    ms = (0, 1, 2) if ph.electromagnetic else (0,)
    parts = [[] for _ in ms]
    for s in range(0, a.shape[0], chunk):
        ea, eb = eta[a[s:s + chunk]], eta[b[s:s + chunk]]
        for k, v in enumerate(kappa_ion(ph, ea, eb, omega, ms, mesh)):
            if k > 0:
                v = v + kappa_electron(ph, ea, eb, omega, k)
            parts[k].append(v)
    return [torch.cat(p) for p in parts]


def band_mask(inp: dict, i, j, dx: float):
    """Which entries (i, j) the operator keeps.  The dense operator keeps
    all.  The never-dense banded one (``eigen_backend`` "sparse") keeps the
    block diagonals that hold every pair with |eta_i - eta_j| <=
    ``band_deta`` (default 10): blocks of the largest of 128, 64, 32, 16, 8
    that divides npoints, h = ceil(w / block) of them each side, w =
    max(ceil(band_deta / dx), 5) grid points.  Electrostatic only."""
    if inp.get("eigen_backend", "dense") != "sparse":
        return torch.ones_like(i, dtype=torch.bool)
    n = int(inp["npoints"])
    if float(inp["beta_e"]) != 0.0:
        raise ValueError("the banded reference is electrostatic only")
    bs = next((b for b in (128, 64, 32, 16, 8) if b <= n and n % b == 0), n)
    w = max(math.ceil(float(inp.get("band_deta", 10.0)) / dx), 5)
    h = min(-(-w // bs), n // bs - 1)
    return (i // bs - j // bs).abs() <= h


def operator_rows(inp: dict, rows, omega: complex, device="cpu",
                  chunk: int = 512):
    """Rows ``rows`` (indices into 0..N-1, N = npoints or, electromagnetic,
    2 npoints) of M(omega) in complex128 on the float64 mesh: (len(rows),
    N).  ``chunk``: pairs a kernel call."""
    ph = phys(inp)
    n = ph.npoints
    f64 = torch.float64
    eta, dx = grid(ph, f64, device)
    em = ph.electromagnetic
    rows = torch.as_tensor([int(r) for r in rows], device=device)
    phy = rows % n                                   # the row's grid index
    cols = torch.arange(n, device=device)
    i = phy[:, None].expand(-1, n)
    j = cols[None, :].expand(len(rows), -1)
    off = (i != j) & band_mask(inp, i, j, dx)
    i, j = i[off], j[off]                            # every pair of each row
    a, b = torch.minimum(i, j), torch.maximum(i, j)
    k = _pair_kernels(ph, eta, a, b, omega, MESH["float64"], chunk)
    r = torch.arange(len(rows), device=device)[:, None].expand(-1, n)[off]
    upper = (j > i).to(f64) * 2.0 - 1.0              # +1 where (i, j) = (a, b)
    top = rows[r] < n
    out = torch.zeros((len(rows), 2 * n if em else n),
                      dtype=torch.complex128, device=device)
    out[r[top], j[top]] = (-k[0] * sing_coeff(n, a, b, f64) * dx)[top]
    diag = torch.arange(len(rows), device=device)
    if not em:
        out[diag, phy] = 1.0 + 1.0 / ph.tau
        return out
    out[r[top], n + j[top]] = (upper * k[1] * dx)[top]
    low = ~top
    out[r[low], j[low]] = (-upper * k[1] * dx)[low]
    out[r[low], n + j[low]] = (k[2] * dx)[low]
    t = rows < n
    out[diag[t], phy[t]] = 1.0 + 1.0 / ph.tau
    out[diag[~t], n + phy[~t]] = (2.0 * ph.tau / ph.beta_e
                                  * b_flr(ph, eta[phy[~t]])).to(out.dtype)
    return out


def row_check(inp: dict, omega: complex, vec, rows, device="cpu",
              chunk: int = 512) -> dict:
    """Judge an eigenpair (omega, v) on the rows ``rows`` of the float64
    operator:

    * ``residual``: its backward error there, ||M_S v|| / || |M_S| |v| ||
      (2-norms over the rows);
    * ``omega_gap``: |d| / |omega|, d the shift of omega that the rows ask
      for, the least-squares solution of M_S(omega) v + d M'_S(omega) v = 0
      with M' the central difference of the rows at omega +- 1e-4 |omega|.
    """
    v = torch.as_tensor(vec).to(device=device, dtype=torch.complex128)
    bad = {"residual": math.inf, "omega_gap": math.inf}
    if not bool(torch.isfinite(torch.view_as_real(v)).all()) \
            or not math.isfinite(abs(omega)) or float(v.abs().max()) == 0.0:
        return bad
    M = operator_rows(inp, rows, omega, device, chunk)
    r = M @ v
    scale = torch.linalg.vector_norm(M.abs() @ v.abs())
    h = 1e-4 * abs(omega)
    dMv = (operator_rows(inp, rows, omega + h, device, chunk) @ v
           - operator_rows(inp, rows, omega - h, device, chunk) @ v) / (2 * h)
    d = -complex(torch.vdot(dMv, r) / torch.vdot(dMv, dMv))
    return {"residual": float(torch.linalg.vector_norm(r) / scale),
            "omega_gap": abs(d) / abs(omega)}


def assemble(inp: dict, omega: complex, dtype=torch.float32, device="cpu",
             mesh=None, chunk: int = 16384, round_bits: int | None = None):
    """The whole operator M(omega) in ``dtype`` arithmetic, the entries
    the operator keeps (``band_mask``) and zeros elsewhere; ``round_bits``
    keeps that many mantissa bits of every kernel value (10: TF32)."""
    ph = phys(inp)
    n = ph.npoints
    eta, dx = grid(ph, dtype, device)
    iu, ju = torch.triu_indices(n, n, 1, device=device)
    keep = band_mask(inp, iu, ju, dx)
    iu, ju = iu[keep], ju[keep]
    mesh = mesh or MESH[str(dtype).removeprefix("torch.")]
    ks = _pair_kernels(ph, eta, iu, ju, omega, mesh, chunk)
    if round_bits is not None:
        ks = [round_mantissa(k, round_bits) for k in ks]
    cdt = ks[0].dtype
    diag = torch.arange(n, device=device)

    def block(vals, dvals, sign=1.0):
        X = torch.zeros((n, n), dtype=cdt, device=device)
        X[iu, ju] = vals
        X[ju, iu] = sign * vals
        X[diag, diag] = dvals.to(cdt)
        return X

    A = block(-ks[0] * sing_coeff(n, iu, ju, dtype) * dx,
              torch.full((n,), 1.0 + 1.0 / ph.tau, dtype=dtype,
                         device=device))
    if not ph.electromagnetic:
        return A
    U = block(ks[1] * dx, torch.zeros(n, dtype=dtype, device=device), -1.0)
    D = block(ks[2] * dx, 2.0 * ph.tau / ph.beta_e * b_flr(ph, eta))
    return torch.cat([torch.cat([A, U], 1), torch.cat([U.T, D], 1)], 0)


def round_mantissa(x, bits: int):
    """``x`` (float32 or complex64) with ``bits`` mantissa bits, rounded to
    nearest: TF32 keeps 10."""
    if x.is_complex():
        return torch.view_as_complex(
            round_mantissa(torch.view_as_real(x).contiguous(), bits))
    drop = 23 - bits
    i = x.contiguous().view(torch.int32)
    half = 1 << (drop - 1)
    i = ((i + half) >> drop) << drop
    return i.view(torch.float32)


def trace_secant(inp: dict, omega0: complex, tol: float, limit: int,
                 **assemble_kw):
    """The reference iteration (solver.h:113-160, 396-415): Newton on
    det M = 0 by d_omega = -1 / tr(M^{-1} dM), dM the secant difference.
    Returns (omega, null vector of M(omega), steps)."""
    w_old = 0.99 * omega0
    dw = 0.01 * omega0
    M_old = assemble(inp, w_old, **assemble_kw)
    w = w_old + dw
    M = assemble(inp, w, **assemble_kw)
    dM = (M - M_old) / dw
    steps = 0
    for steps in range(1, limit + 1):
        dw = complex(-1.0 / torch.diagonal(torch.linalg.solve(M, dM)).sum())
        if not math.isfinite(abs(dw)):
            break
        w = w + dw
        M_new = assemble(inp, w, **assemble_kw)
        dM = (M_new - M) / dw
        M = M_new
        if abs(dw) < tol * abs(w):
            break
    return w, null_vector(M), steps


def null_vector(M, iters: int = 3):
    """The null vector of a nearly singular M by inverse iteration from a
    vector of ones."""
    lu, piv = torch.linalg.lu_factor(M)
    x = torch.ones(M.shape[0], 1, dtype=M.dtype, device=M.device)
    for _ in range(iters):
        x = torch.linalg.lu_solve(lu, piv, x)
        x = x / torch.linalg.vector_norm(x)
    return x[:, 0]
