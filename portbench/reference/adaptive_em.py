"""Plain reference of EMME's electromagnetic operator M(omega) under the
input file's own guarantee: every kernel integral, of every moment, by
adaptive Gauss-Kronrod quadrature in float64 to the file's
``integration_*`` keys.

The electromagnetic twin of ``adaptive.py``, written from the upstream
engine's assembly (the C++ engine's ``PairCtx``, ``integrate_adaptive``,
``kappa_electron`` and ``emme_assemble``) in plain PyTorch and NumPy.  It
imports nothing of the program and takes nothing the program made: the
rules, tolerances, Bessel functions and moment-0 integrand come from
``adaptive.py``, the physics, grid, singularity correction, closed
electron kernels and FLR argument from ``operator.py``.  What it adds:

* the ion integrand's moments: the engine multiplies moment 0's integrand
  by nv^m, nv = q R d_eta / (vt t~) with t~ the contour-rotated transit
  time (m = 1, 2);
* each (pair, moment) its own adaptive integral with its own root
  tolerance, as the engine integrates each ``kappa_ion(m)`` alone;
* the 2N x 2N layout: for a pair i < j with kernels k0, k1, k2 (the ion
  integrals times -i q R / (vt sqrt(2 pi)), k1 and k2 plus the electron
  closed forms at (eta_i, eta_j)), M[i, j] = M[j, i] = -k0 c_ij dx;
  M[i, n + j] = M[j + n, i] = k1 dx, M[j, n + i] = M[i + n, j] = -k1 dx;
  M[n + i, n + j] = M[n + j, n + i] = k2 dx; on the diagonal 1 + 1/tau,
  zeros in the off-diagonal blocks, and 2 tau / beta_e b_i(eta_i) in the
  A_par block.

Departures from the engine, none of which changes a value beyond rounding:

* those of ``adaptive.py`` (breadth first, each integral's accepted panels
  summed in the order they are accepted; torch's complex arithmetic; each
  node's Miller recurrence its own length; an integral that needs 100,000
  panels, or a root panel with a zero integral that splits, raises);
* nv^m multiplies the moment-0 integrand after its 1/cos^2 x factor, where
  the engine multiplies before it, and nv^2 is nv nv;
* the stellarator's g(eta) in ``operator.py``'s form, not the engine's
  regrouped one, and the electron sign of d_eta by ``torch.sign``;
* only the (pair, moment) integrals that the asked rows use are computed:
  a phi row needs moments 0 and 1, an A_par row moments 1 and 2.

Where an acceptance test lands within rounding of its threshold, this
reference and the program may take it in opposite ways: the integral then
moves by up to the test's tolerance (the file's absolute
``integration_accuracy`` 1e-2 dominates it).  ``kernels`` returns each
integral's panel count beside its value, so that a caller can count such
flips against the program's.

``rows`` gives chosen rows of M(omega) from either block; ``row_check``
judges an eigenpair on them as ``adaptive.row_check`` does; ``assemble``
and ``trace_secant`` give the whole operator and the reference's own
Newton iteration.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import adaptive as es
from portbench.reference import operator as op

MOMENTS = 3


def integrand(ph, x, ctx, m, omega: complex):
    """The moment-``m`` integrand (``m`` (k, 1) int64 of 0, 1, 2) at nodes
    ``x`` (k, nodes) of the integrals whose context rows ``ctx`` (each (k,
    1), ``adaptive._pair_context``) are given."""
    f = es.integrand(ph, x, ctx, omega)
    t = torch.tan(x)
    omi = -math.copysign(1.0, omega.real)
    taut = t * torch.exp(-omi * 1j * torch.atan(t / ph.arc))
    nv = (ph.q * ph.R * ctx[0]) / (ph.vt * taut)
    return f * torch.where(m == 0, 1.0, torch.where(m == 1, nv, nv * nv))


def integrate(ph, inp: dict, eta, eta_p, m, omega: complex):
    """One adaptive integral per (eta, eta', m), each (k,): the
    transit-time integral of moment ``m`` at ``omega`` to the input's
    tolerances.  Returns (values complex128 (k,), panels int64 (k,))."""
    rel, goal, depth = es.tolerances(inp)
    dev = eta.device
    x, wk, wkg = (torch.as_tensor(a, device=dev) for a in es.rule(ph.order))
    ctx_all = es._pair_context(ph, eta, eta_p)
    n = eta.shape[0]
    total = torch.zeros(n, dtype=torch.complex128, device=dev)
    abs_tol = torch.zeros(n, dtype=torch.float64, device=dev)
    pops = torch.zeros(n, dtype=torch.int64, device=dev)
    idx = torch.arange(n, device=dev)
    lo = torch.zeros(n, dtype=torch.float64, device=dev)
    hi = torch.full((n,), es.HALF_PI, dtype=torch.float64, device=dev)
    root = True
    while len(idx):
        nxt = ([], [], [])
        for s in range(0, len(idx), es.CHUNK):
            part = slice(s, s + es.CHUNK)
            i, a, b = idx[part], lo[part], hi[part]
            mid, half = 0.5 * (a + b), 0.5 * (b - a)
            ctx = tuple(v[i, None] for v in ctx_all)
            f = integrand(ph, mid[:, None] + half[:, None] * x, ctx,
                          m[i, None], omega)
            val = (f * wk).sum(1) * half
            err = (f * wkg).sum(1).abs() * half
            if root:
                abs_tol[i] = (rel * val).abs()
            can = half * 2.0 ** depth > 0.99 * es.HALF_PI
            split = (can & (err > abs_tol[i] * (2.0 / es.HALF_PI) + goal)
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
        if len(idx) and int(pops.max()) >= es.MAX_PANELS - 1:
            raise ArithmeticError(f"an integral needs {es.MAX_PANELS} "
                                  f"panels or more")
    return total, pops


def kernels(inp: dict, a, b, m, omega: complex, device="cpu"):
    """The operator's kernel of moment ``m`` for the index pairs (a, b), a
    < b (each (k,) int64): the ion integral times -i q R / (vt sqrt(2 pi)),
    plus the electron closed form for m = 1, 2.  Returns (complex128 (k,),
    each integral's panels (k,))."""
    ph = op.phys(inp)
    eta, _dx = op.grid(ph, torch.float64, device)
    ea, eb = eta[a], eta[b]
    vals, pops = integrate(ph, inp, ea, eb, m, complex(omega))
    k = -1j * (ph.q * ph.R) / (ph.vt * math.sqrt(2.0 * math.pi)) * vals
    for mm in (1, 2):
        sel = m == mm
        k[sel] = k[sel] + op.kappa_electron(ph, ea[sel], eb[sel],
                                            complex(omega), mm)
    return k, pops


def row_items(n: int, which, device="cpu"):
    """The (pair, moment) integrals the rows ``which`` (of 0 .. 2n - 1)
    use, and where each entry of those rows finds its kernel: (a, b, m of
    the unique integrals; row index, column, the row's grid index, a, b,
    the entry's moment and its integral's index, one each per off-diagonal
    entry)."""
    r = torch.as_tensor([int(v) for v in which], dtype=torch.int64,
                        device=device)
    phy = r % n
    j = torch.arange(n, device=device)[None, :].expand(len(r), -1)
    i = phy[:, None].expand(-1, n)
    row = torch.arange(len(r), device=device)[:, None].expand(-1, n)
    top = (r < n)[:, None].expand(-1, n)
    off = i != j
    row, i, j, top = row[off], i[off], j[off], top[off]
    a, b = torch.minimum(i, j), torch.maximum(i, j)
    # a phi row: moment 0 into the phi block, 1 into the A_par block; an
    # A_par row: moment 1 into the phi block, 2 into the A_par block
    m_left = torch.where(top, 0, 1)
    row, i, j, a, b = (torch.cat([v, v]) for v in (row, i, j, a, b))
    m = torch.cat([m_left, m_left + 1])
    right = torch.cat([torch.zeros_like(top), torch.ones_like(top)])
    key, where = torch.unique((a * n + b) * MOMENTS + m, return_inverse=True)
    ua, um = key // MOMENTS // n, key % MOMENTS
    ub = key // MOMENTS % n
    return (ua, ub, um), (row, j + n * right, i, a, b, m, where)


def rows(inp: dict, which, omega: complex, device="cpu",
         with_panels: bool = False):
    """Rows ``which`` (indices into 0 .. 2 npoints - 1) of the
    electromagnetic M(omega), complex128 (len(which), 2 npoints); with
    ``with_panels`` also (a, b, m, panels) of every integral computed."""
    ph = op.phys(inp)
    if not ph.electromagnetic:
        raise ValueError("adaptive_em is the electromagnetic operator: an "
                         "electrostatic input takes adaptive.rows")
    n = ph.npoints
    eta, dx = op.grid(ph, torch.float64, device)
    (ua, ub, um), (row, col, i, a, b, m, where) = row_items(n, which,
                                                           device)
    k, pops = kernels(inp, ua, ub, um, omega, device)
    k = k[where]
    upper = torch.where(col % n > i, 1.0, -1.0).to(torch.float64)
    val = torch.where(m == 0, -k * op.sing_coeff(n, a, b, torch.float64),
                      torch.where(m == 1, upper * k, k)) * dx
    # an A_par row's phi entry is -upper k1 dx
    val = torch.where((m == 1) & (col < n), -val, val)
    w = torch.as_tensor([int(v) for v in which], dtype=torch.int64,
                        device=device)
    out = torch.zeros((len(w), 2 * n), dtype=torch.complex128,
                      device=device)
    out[row, col] = val
    d = torch.arange(len(w), device=device)
    phy, top = w % n, w < n
    out[d[top], phy[top]] = 1.0 + 1.0 / ph.tau
    out[d[~top], n + phy[~top]] = (2.0 * ph.tau / ph.beta_e
                                   * op.b_flr(ph, eta[phy[~top]])
                                   ).to(out.dtype)
    if with_panels:
        return out, (ua, ub, um, pops)
    return out


def assemble(inp: dict, omega: complex, device="cpu"):
    """The whole operator M(omega), complex128 (2 npoints, 2 npoints)."""
    return rows(inp, range(2 * int(inp["npoints"])), omega, device)


def row_check(inp: dict, omega: complex, vec, which, device="cpu") -> dict:
    """Judge an eigenpair (omega, v) on the rows ``which`` of the adaptive
    electromagnetic operator, as ``adaptive.row_check`` does:
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
    """The reference's own float64 TraceSecant on the adaptive
    electromagnetic operator from ``omega0``: (omega, null vector by SVD,
    steps)."""
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
