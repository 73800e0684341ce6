"""Plain reference of EMME's operator M(omega) under the input file's own
guarantee: every kernel integral by adaptive Gauss-Kronrod quadrature in
float64, to the file's ``integration_*`` keys.

Written from the algorithm of the upstream engine's adaptive integrator
(the C++ engine's ``integrate_adaptive`` and ``emme_assemble``), in plain
PyTorch and NumPy.  It imports nothing of the program and takes nothing
the program made: the physics comes from the configuration's input dict
(``operator.phys``, and the geometry, the singularity correction and the
grid of ``operator.py``, whose forms are the engine's).  What it holds:

* the QUADPACK G7K15 and G15K31 tables (``integration_start_points`` 15 or
  31) on [0, pi/2] in x = atan(t), the integrand times 1/cos^2 x;
* the engine's acceptance test: a panel splits in two while it may (its
  half-width times 2^``integration_iteration_limit`` above 0.99 pi/2) and
  its error estimate |K - G| half passes both |rel I_root| 2/pi + abs and
  |rel I_panel| + abs, rel = ``integration_precision``, abs =
  ``integration_accuracy``, I_root the first panel's integral;
* the integrand: the contour-rotated transit time, its Jacobian, the drift
  and FLR factors with the scaled Bessel I0 and I1 of sqrt(b b') / lambda,
  the -40 exponent cutoff;
* the Bessel functions by the engine's recipe: Miller's downward
  recurrence from order floor(|w| + 9 sqrt|w|) + 24 on Re w >= 0, rescaled
  by 1e-250 past 1e250, normalised by e^w = I0 + 2 sum I_k;
* the electrostatic operator: -kappa_0 c_ij dx off the diagonal (c the
  singularity correction), 1 + 1/tau on it.

Departures from the engine, none of which changes a value beyond rounding:

* breadth first: every (integral, interval) of a level at once, in chunks,
  where the engine pops a stack depth first; each integral's accepted
  panels are summed in the order they are accepted, so the sum differs
  from the engine's in rounding;
* torch's complex128 arithmetic, not the C++ library's: the integrand
  agrees to rounding, and an acceptance test within rounding of its
  threshold may go the other way;
* each node's Miller recurrence runs its own length, the nodes sorted by
  it, instead of one node at a time;
* the engine stops after 100,000 panels of one integral and keeps what it
  has; here such an integral raises, as does a root panel whose integral
  is exactly zero and which splits (the engine takes its tolerance from a
  later panel);
* electrostatic inputs only (the electromagnetic blocks are not written).

``rows`` gives chosen rows of M(omega); ``row_check`` judges an eigenpair
on them as ``operator.row_check`` does on the fixed-panel operator;
``assemble`` and ``trace_secant`` give the whole operator and the
reference's own Newton iteration.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import operator as op

HALF_PI = math.pi / 2.0
MAX_PANELS = 100_000        # the engine's pops an integral
CHUNK = 1 << 15             # intervals a pass (x 15 or 31 nodes)
BIG, INV_BIG = 1e250, 1e-250
EXP_CUTOFF = -40.0

# QUADPACK: non-negative Kronrod abscissae, Kronrod weights, and the Gauss
# weights of the abscissae 0, x_2, x_4, ... (G7K15: 7 Gauss nodes; G15K31:
# 15)
RULES = {
    15: ([0.0, 0.20778495500789847, 0.40584515137739717,
          0.58608723546769113, 0.74153118559939444, 0.86486442335976907,
          0.94910791234275852, 0.99145537112081264],
         [2.09482141084727828e-01, 2.04432940075298892e-01,
          1.90350578064785410e-01, 1.69004726639267903e-01,
          1.40653259715525919e-01, 1.04790010322250184e-01,
          6.30920926299785533e-02, 2.29353220105292250e-02],
         [0.41795918367346939, 0.38183005050511894, 0.27970539148927667,
          0.12948496616886969]),
    31: ([0.0, 0.1011420669187175, 0.20119409399743452, 0.29918000715316881,
          0.39415134707756337, 0.48508186364023968, 0.57097217260853885,
          0.65099674129741697, 0.72441773136017005, 0.79041850144246593,
          0.84820658341042722, 0.8972645323440819, 0.9372733924007059,
          0.96773907567913913, 0.98799251802048543, 0.99800229869339706],
         [0.10133000701479155, 0.100769845523875595, 0.099173598721791959,
          0.0966427269836236785, 0.093126598170825321,
          0.0885644430562117706, 0.083080502823133021,
          0.0768496807577203789, 0.069854121318728259,
          0.0620095678006706403, 0.053481524690928087,
          0.0445897513247648766, 0.035346360791375846,
          0.0254608473267153202, 0.0150079473293161225,
          0.00537747987292334899],
         [0.20257824192556112, 0.19843148532711152, 0.18616100001556193,
          0.1662692058169939, 0.1395706779261542, 0.10715922046717143,
          0.07036604748810768, 0.030753241996119]),
}


def rule(order: int):
    """The whole rule on [-1, 1]: nodes, Kronrod weights, and Kronrod minus
    Gauss weights (Gauss 0 off its nodes), each (order,) float64."""
    if order not in RULES:
        raise ValueError(f"no Gauss-Kronrod table for {order} nodes")
    x, wk, wg = (np.asarray(a) for a in RULES[order])
    gauss = np.zeros_like(wk)
    gauss[::2] = wg                  # Gauss nodes: 0, x_2, x_4, ...
    return (np.concatenate([-x[:0:-1], x]),
            np.concatenate([wk[:0:-1], wk]),
            np.concatenate([(wk - gauss)[:0:-1], wk - gauss]))


def tolerances(inp: dict):
    """(relative, absolute, depth) of the acceptance test."""
    return (float(inp.get("integration_precision", 1e-6)),
            float(inp.get("integration_accuracy", 1e-6)),
            int(inp.get("integration_iteration_limit", 100)))


# ---------------------------------------------------------------------------
# scaled Bessel I0 / I1 by Miller's recurrence
# ---------------------------------------------------------------------------

def bessel_i01(z):
    """(I0(z) e^{zs}, I1(z) e^{zs}, zs), zs = z where Re z < 0 else -z, for
    a complex128 tensor ``z``."""
    neg = z.real < 0
    zs = torch.where(neg, z, -z)
    w = torch.where(neg, -z, z).reshape(-1)
    aw = w.abs()
    start = (torch.floor(aw + 9.0 * torch.sqrt(aw)) + 24.0).to(torch.int64)
    start, order = torch.sort(start, descending=True)
    w = w[order]
    # the nodes with start order >= k are a prefix of the sorted nodes
    count = torch.searchsorted(-start, -torch.arange(
        int(start[0]) + 1 if len(start) else 1, device=z.device),
        right=True).tolist()
    yk1 = torch.zeros_like(w)
    yk = torch.ones_like(w)
    s = torch.zeros_like(w)
    for k in range(len(count) - 1, 0, -1):
        c = count[k]
        ykm1 = (2.0 * k / w[:c]) * yk[:c] + yk1[:c]
        s[:c] += 2.0 * yk[:c]
        yk1[:c] = yk[:c]
        yk[:c] = ykm1
        big = yk[:c].abs() > BIG
        if bool(big.any()):
            scale = torch.where(big, INV_BIG, 1.0)
            yk[:c] *= scale
            yk1[:c] *= scale
            s[:c] *= scale
    # y_1 is the value before the last step: y_0 = (2 / w) y_1 + y_2
    i0 = yk / (s + yk)
    i1 = yk1 / (s + yk)
    back = torch.empty_like(order)
    back[order] = torch.arange(len(order), device=z.device)
    i0, i1 = i0[back].reshape(z.shape), i1[back].reshape(z.shape)
    zero = z == 0
    i0 = torch.where(zero, 1.0, i0)
    i1 = torch.where(zero, 0.0, torch.where(neg, -i1, i1))
    return i0, i1, torch.where(zero, 0.0, zs)


# ---------------------------------------------------------------------------
# the ion kernel's adaptive integral
# ---------------------------------------------------------------------------

def _pair_context(ph, eta, eta_p):
    """Per integral: (d_eta, beta_1, b_i + b_i', sqrt(b_i b_i'))."""
    d = eta - eta_p
    b1 = op.beta_1(ph, eta, eta_p)
    bi, bp = op.b_flr(ph, eta), op.b_flr(ph, eta_p)
    return d, b1, bi + bp, torch.sqrt(bi * bp)


def integrand(ph, x, ctx, omega: complex):
    """f(tan x) / cos^2 x for nodes ``x`` (k, nodes) of the integrals whose
    context rows ``ctx`` (each (k, 1)) are given (moment 0)."""
    d, b1, bsum, sbb = ctx
    t = torch.tan(x)
    c = torch.cos(x)
    omi = -math.copysign(1.0, omega.real)
    ea = torch.exp(-omi * 1j * torch.atan(t / ph.arc))
    taut = t * ea
    jac = ea - (1j * ea * omi * t) / (ph.arc * (1.0 + (t / ph.arc) ** 2))
    qr = ph.q * ph.R
    lam = 1.0 + 0.5j * (taut * ph.vt) / (qr * d) * b1
    nv = (qr * d) / (ph.vt * taut)
    wsi, ei = ph.omega_s_i, ph.eta_i
    l3 = 1.0 / (lam * lam * lam)
    c0 = ((omega - wsi * (1.0 + ei * (0.5 * nv * nv - 1.5))) / lam
          + wsi * ei * (0.5 * bsum - lam) * l3)
    c1 = -wsi * ei * sbb * l3
    lc = (-0.5 * nv * nv - 0.5j * b1 * nv + 1j * taut * omega
          - bsum / (2.0 + 1j * b1 / nv))
    i0, i1, zs = bessel_i01(sbb / lam)
    expo = lc - zs
    keep = torch.isfinite(expo) & (expo.real >= EXP_CUTOFF)
    val = (jac / taut * torch.exp(torch.where(keep, expo, EXP_CUTOFF))
           * (c0 * i0 + c1 * i1))
    return torch.where(keep, val, 0.0) / (c * c)


def integrate(ph, inp: dict, eta, eta_p, omega: complex):
    """The transit-time integral of each pair (eta, eta'), (k,) float64,
    at ``omega``, adaptive to the input's tolerances: complex128 (k,)."""
    rel, goal, depth = tolerances(inp)
    dev = eta.device
    x, wk, wkg = (torch.as_tensor(a, device=dev) for a in rule(ph.order))
    ctx_all = _pair_context(ph, eta, eta_p)
    n = eta.shape[0]
    total = torch.zeros(n, dtype=torch.complex128, device=dev)
    abs_tol = torch.zeros(n, dtype=torch.float64, device=dev)
    pops = torch.zeros(n, dtype=torch.int64, device=dev)
    # the open intervals: (integral, lo, hi)
    idx = torch.arange(n, device=dev)
    lo = torch.zeros(n, dtype=torch.float64, device=dev)
    hi = torch.full((n,), HALF_PI, dtype=torch.float64, device=dev)
    root = True
    while len(idx):
        nxt = ([], [], [])
        for s in range(0, len(idx), CHUNK):
            i, a, b = idx[s:s + CHUNK], lo[s:s + CHUNK], hi[s:s + CHUNK]
            mid, half = 0.5 * (a + b), 0.5 * (b - a)
            ctx = tuple(v[i, None] for v in ctx_all)
            f = integrand(ph, mid[:, None] + half[:, None] * x, ctx, omega)
            val = (f * wk).sum(1) * half
            err = (f * wkg).sum(1).abs() * half
            if root:
                abs_tol[i] = (rel * val).abs()
            can = half * 2.0 ** depth > 0.99 * HALF_PI
            split = (can & (err > abs_tol[i] * (2.0 / HALF_PI) + goal)
                     & (err > (rel * val).abs() + goal))
            if root and bool((split & (val == 0)).any()):
                raise ArithmeticError("a root panel with a zero integral "
                                      "splits: its tolerance is undefined")
            total.index_add_(0, i[~split], val[~split])
            pops.index_add_(0, i, torch.ones_like(i))
            i, a, mid, b = i[split], a[split], mid[split], b[split]
            for part, v in zip(nxt, (torch.cat([i, i]), torch.cat([a, mid]),
                                     torch.cat([mid, b]))):
                part.append(v)
        root = False
        idx, lo, hi = (torch.cat(part) for part in nxt)
        if len(idx) and int(pops.max()) >= MAX_PANELS - 1:
            raise ArithmeticError(f"an integral needs {MAX_PANELS} panels "
                                  f"or more")
    return total


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------

def rows(inp: dict, which, omega: complex, device="cpu"):
    """Rows ``which`` of M(omega), complex128 (len(which), npoints): each
    pair's kernel computed once, for the pair (min, max) of its indices."""
    ph = op.phys(inp)
    if ph.electromagnetic:
        raise ValueError("the adaptive reference is electrostatic only")
    n = ph.npoints
    eta, dx = op.grid(ph, torch.float64, device)
    r = torch.as_tensor([int(v) for v in which], device=device)
    i = r[:, None].expand(-1, n)
    j = torch.arange(n, device=device)[None, :].expand(len(r), -1)
    off = i != j
    a, b = torch.minimum(i, j)[off], torch.maximum(i, j)[off]
    pair, inverse = torch.unique(a * n + b, return_inverse=True)
    pa, pb = pair // n, pair % n
    # the ion kernel kappa_0: -i q R / (vt sqrt(2 pi)) times the integral
    k = (-1j * (ph.q * ph.R) / (ph.vt * math.sqrt(2.0 * math.pi))
         * integrate(ph, inp, eta[pa], eta[pb], complex(omega)))
    vals = -k * op.sing_coeff(n, pa, pb, torch.float64) * dx
    out = torch.zeros((len(r), n), dtype=torch.complex128, device=device)
    out[off] = vals[inverse]
    out[torch.arange(len(r), device=device), r] = 1.0 + 1.0 / ph.tau
    return out


def assemble(inp: dict, omega: complex, device="cpu"):
    """The whole operator M(omega), complex128 (npoints, npoints)."""
    return rows(inp, range(int(inp["npoints"])), omega, device)


def row_check(inp: dict, omega: complex, vec, which, device="cpu") -> dict:
    """Judge an eigenpair (omega, v) on the rows ``which`` of the adaptive
    operator, as ``operator.row_check`` does on the fixed-panel one:
    ``residual`` ||M_S v|| / || |M_S| |v| || and ``omega_gap`` |d| /
    |omega|, d the least-squares shift of omega that M_S(omega) v + d
    M'_S(omega) v = 0 asks for, M' the central difference at omega +-
    1e-4 |omega|."""
    v = torch.as_tensor(vec).to(device=device, dtype=torch.complex128)
    if not bool(torch.isfinite(torch.view_as_real(v)).all()) \
            or not math.isfinite(abs(omega)) or float(v.abs().max()) == 0.0:
        return {"residual": math.inf, "omega_gap": math.inf}
    M = rows(inp, which, omega, device)
    r = M @ v
    scale = torch.linalg.vector_norm(M.abs() @ v.abs())
    h = 1e-4 * abs(omega)
    dMv = (rows(inp, which, omega + h, device) @ v
           - rows(inp, which, omega - h, device) @ v) / (2 * h)
    d = -complex(torch.vdot(dMv, r) / torch.vdot(dMv, dMv))
    return {"residual": float(torch.linalg.vector_norm(r) / scale),
            "omega_gap": abs(d) / abs(omega)}


def trace_secant(inp: dict, omega0: complex, tol: float, limit: int,
                 device="cpu"):
    """The reference's own float64 TraceSecant on the adaptive operator
    from ``omega0``: (omega, null vector by SVD, steps)."""
    w_old = 0.99 * omega0
    dw = 0.01 * omega0
    M_old = assemble(inp, w_old, device)
    w = w_old + dw
    M = assemble(inp, w, device)
    dM = (M - M_old) / dw
    steps = 0
    for steps in range(1, limit + 1):
        dw = complex(-1.0 / torch.diagonal(torch.linalg.solve(M, dM)).sum())
        if not math.isfinite(abs(dw)):
            break
        w = w + dw
        M_new = assemble(inp, w, device)
        dM = (M_new - M) / dw
        M = M_new
        if abs(dw) < tol * abs(w):
            break
    return w, torch.linalg.svd(M)[2][-1].conj(), steps
