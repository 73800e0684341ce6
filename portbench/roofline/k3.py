"""K3, the whole delta-f PIC run in one launch: its operations and bytes,
from the plain marker formula (solver_pic.h:82-156, 249-354 as the
float32 path writes it on (re, im) planes: CIC gather of phi and dphi, the
marker physics with J0 / J1, the drift-center phase factor, the RK
combine and push, J0 and the phase at the new position, the CIC deposit).

J0 and J1 take one side of their split, |x| <= 8 (a 30-term Taylor sum)
or beyond (the Hankel asymptotic form); ``asymptotic_share`` finds the
share beyond from the run's markers.  The field's cross-block sum (a few
hundred float64 adds a grid point a stage) is left out: under 0.1 % of a
stage's operations at a thousand markers a cell.
"""

from __future__ import annotations

import torch

from .common import L2_BYTES, Tally

# Bytes a marker-stage must move in device memory when the markers' state
# streams through it, drift-center on: v_par, v_perp, odv, ost, pw and eta,
# w_re, w_im read (32); eta, w_re, w_im written (12); the RK velocity
# written at stage 1 and read at stage 2 (8).  The state a marker keeps
# between stages: 10 float32 arrays.
BYTES_PER_MARKER_STAGE = {"0_first": 44, "0": 44, "1": 52, "2": 52}
STATE_BYTES_PER_MARKER = 40
SPLIT = 8.0


def _j(T, x, asymptotic: bool, order: int):
    """J0 (order 0) or J1 (order 1) of x on one side of the split."""
    if not asymptotic:
        q = -0.25 * x * x
        t = T.v()
        for _ in range(30):
            t = 1.0 + t * q / 0.5
        return 0.5 * x * t if order else t
    z = 8.0 / x
    y = z * z
    P = 1.0 + y * (0.1 + y * (0.1 + y * (0.1 + y * 0.1)))
    Q = z * (0.1 + y * (0.1 + y * (0.1 + y * (0.1 + y * 0.1))))
    xx = x - 0.7
    return T.fn(0.6 / x) * (T.fn(xx) * P - T.fn(xx) * Q)


def stage_ops(variant: str, asymptotic: bool, dc: bool = True) -> int:
    """Operations of one marker in one stage: ``variant`` "0_first" (the
    run's first stage: J0 and the phase factor are zero), "0", "1" or "2"
    (the stage that combines two RK velocities)."""
    T = Tally()
    eta, vpar, vperp, wre, wim, odv, ost, pw = (T.v() for _ in range(8))
    L, cw, vt, bt, shat, odb, qR, i2cw, sub_dt = (T.v() for _ in range(9))
    f0r, f0i, f1r, f1i, fmr, fmi, fppr, fppi = (T.v() for _ in range(8))
    pre = T.ops
    x = (eta + L) / cw
    idxf = T.fn(x)
    wgt = x - idxf
    g0r, g0i = f1r - fmr, f1i - fmi
    g1r, g1i = fppr - f0r, fppi - f0i
    wl = 1.0 - wgt
    phir = wl * f0r + wgt * f1r
    phii = wl * f0i + wgt * f1i
    dphir = (wl * g0r + wgt * g1r) * i2cw
    dphii = (wl * g0i + wgt * g1i) * i2cw
    x_perp = vperp / vt
    sb = T.fn(bt * (1.0 + (shat * eta) * (shat * eta)))
    dj0 = -bt * (shat * shat) * x_perp * eta \
        * _j(T, x_perp * sb, asymptotic, 1) / sb
    omega_d = odb * (T.fn(eta) + shat * eta * T.fn(eta))
    if variant == "0_first":
        j0 = dcr = dci = T.v()
    else:
        j0 = _j(T, x_perp * sb, asymptotic, 0)
        odi = (qR / vpar) * odb * (T.fn(eta) * (1.0 + shat)
                                   - shat * eta * T.fn(eta))
        ph = odi * odv
        dcr, dci = T.fn(ph), -T.fn(ph)
    a = ost - omega_d * odv
    vq = vpar / qR
    comr = -a * j0 * phii - vq * (j0 * dphir + dj0 * phir)
    comi = a * j0 * phir - vq * (j0 * dphii + dj0 * phii)
    if dc:
        velr = pw * (dcr * comr + dci * comi)
        veli = pw * (dcr * comi - dci * comr)
    else:
        b = omega_d * odv
        velr = wim * b + pw * comr
        veli = -wre * b + pw * comi
    if variant == "2":
        velr = T.v() * T.v() + T.v() * velr
        veli = T.v() * T.v() + T.v() * veli
    m = eta + vpar * (sub_dt / qR) + L
    eta_n = m - (2.0 * L) * T.fn(m / (2.0 * L)) - L
    wre_n = wre + velr * sub_dt
    wim_n = wim + veli * sub_dt
    x2 = (eta_n + L) / cw
    w2 = x2 - T.fn(x2)
    j0n = _j(T, x_perp * T.fn(bt * (1.0 + (shat * eta_n) * (shat * eta_n))),
             asymptotic, 0)
    if dc:
        odin = (qR / vpar) * odb * (T.fn(eta_n) * (1.0 + shat)
                                    - shat * eta_n * T.fn(eta_n))
        phn = odin * odv
        dnr, dni = T.fn(phn), -T.fn(phn)
        denr = j0n * (wre_n * dnr - wim_n * dni)
        deni = j0n * (wre_n * dni + wim_n * dnr)
    else:
        denr, deni = j0n * wre_n, j0n * wim_n
    w2l = 1.0 - w2
    for den in (denr, deni):             # two cells, two planes: 4 adds
        T.v() + den * w2l
        T.v() + den * w2
    return T.ops - pre


def asymptotic_share(eta, v_perp, vt: float, b_theta: float,
                     shat: float) -> float:
    """Share of markers whose J0 / J1 argument (v_perp / vt) sqrt(b_theta
    (1 + (shat eta)^2)) lies beyond the split."""
    arg = v_perp.double() / vt * torch.sqrt(
        b_theta * (1.0 + (shat * eta.double()) ** 2))
    return float((arg.abs() > SPLIT).double().mean())


def run_work(markers: int, n_steps: int, nf: int, asym_share: float,
             dc: bool = True) -> tuple[float, float]:
    """(operations, bytes) of one K3 run.  Bytes: where the markers' state
    outgrows the L2 every stage's loads and stores count, less the share
    the L2 could keep; at least each input read once and each output
    written once (the markers, the field, the statistics)."""
    def per(v):
        return ((1.0 - asym_share) * stage_ops(v, False, dc)
                + asym_share * stage_ops(v, True, dc))
    flop = markers * (per("0_first") + (n_steps - 1) * per("0")
                      + n_steps * (per("1") + per("2")))
    b = BYTES_PER_MARKER_STAGE
    staged = markers * (b["0_first"] + (n_steps - 1) * b["0"]
                        + n_steps * (b["1"] + b["2"]))
    state = markers * STATE_BYTES_PER_MARKER
    once = markers * (32 + 12) + 4 * (2 * nf) * 3 + 4 * 3 * n_steps
    return flop, max(float(once), staged * max(0.0, 1.0 - L2_BYTES / state))
