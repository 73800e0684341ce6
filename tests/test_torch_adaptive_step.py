"""Kernel N1's Miller step (``emme_tpu_torch/csrc/adaptive.cu``: ``quot``,
``miller``, ``bessel_i01``) modelled on the CPU, held bit for bit to the
plain version ``ops/adaptive.py`` that N1 is compared with on the card.

The step takes the quotient 2k / den of the engine's Smith division from a
reciprocal y = 1 / den taken once a node, q0 = num y, r = fma(-q0, den,
num), q = fma(r, y, q0), where the engine divides twice a step; it sums
with fma(2, y_k, s); and it calls hypot only where max(|y.r|, |y.i|) passes
a filter.  A CUDA kernel cannot run here, so these tests check that each of
those rewrites rounds as the operation it replaces:

* the quotient is the IEEE quotient on every (2k, +-2k ratio, den) that the
  plain version's Miller recurrences meet in a 32-point assembly of each of
  the five geometries, and on edge mantissas at both ends of the kernel's
  range (``kRecipMin``, ``kRecipMax``, read from the source);
* a step-for-step model of the new recurrence gives ``adaptive.bessel_i01``'s
  values and step counts bit for bit, rescales included;
* the kernel's own Bessel code (``csrc/adaptive_bessel.h``, which
  ``adaptive.cu`` includes), built for the host with g++, gives them bit for
  bit too, signs of zero included, through both instances of its
  recurrence: the reciprocal one and the one that divides (z on the real or
  imaginary axis, or so small that den leaves the reciprocal's range);
* the filter never skips a step where hypot passes 1e250.

Python 3.12 has no ``math.fma``: ``fma_exact`` rounds the exact rational
a b + c once (``fractions.Fraction``; int / int true division rounds
correctly), and ``fma_vec`` is the Boldo-Melquiond emulation (error-free
product and sum, the tail added with rounding to odd, one last rounding to
nearest), exact where nothing overflows or underflows; the data's operands
are asserted inside that range and ``fma_vec`` is held to ``fma_exact``.
"""
import ctypes
import functools
import json
import math
import pathlib
import re
import shutil
import subprocess
from fractions import Fraction

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import emme_tpu_torch as et
from emme_tpu_torch import native
from emme_tpu_torch.ops import adaptive

torch.set_num_threads(2)

SRC = pathlib.Path(et.__file__).resolve().parent / "csrc" / "adaptive_bessel.h"
INPUTS = pathlib.Path(__file__).resolve().parent / "goldens" / "inputs"
GEOMETRIES = ["tokamak", "stellarator", "cylinder", "cylinder_old",
              "taloyMagneticDrift"]
OMEGA = {"stellarator": -1.656 + 2.49j}
GUESS = -0.8 + 0.25j
# fma_vec's operands stay inside [2^-EMU_EXP, 2^EMU_EXP] in magnitude
EMU_EXP = 900
CHUNK = 1 << 20


def _const(name):
    """A ``constexpr double`` of the kernel's Bessel code."""
    m = re.search(rf"constexpr double {name} = ([^;]+);", SRC.read_text())
    v = m.group(1).strip()
    return float.fromhex(v) if v.startswith("0x") else float(v)


RECIP_MIN, RECIP_MAX = _const("kRecipMin"), _const("kRecipMax")
FILTER, BIG = _const("kRescaleFilter"), _const("kBig")


# ---------------------------------------------------------------------------
# fma, exactly
# ---------------------------------------------------------------------------

def fma_exact(a, b, c):
    """IEEE fma(a, b, c) in round to nearest even: a b + c rounded once."""
    x = Fraction(a) * Fraction(b) + Fraction(c)
    if x != 0:
        return float(x)
    prod_neg = math.copysign(1.0, a) * math.copysign(1.0, b) < 0
    if a * b == 0 and c == 0 and prod_neg and math.copysign(1.0, c) < 0:
        return -0.0        # (-0) + (-0); every other exact zero is +0
    return 0.0


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    c = 134217729.0 * a    # 2^27 + 1
    h = c - (c - a)
    return h, a - h


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _add_odd(a, b):
    """a + b rounded to odd: the sum where exact, else the neighbour of the
    nearest sum whose last mantissa bit is 1."""
    s, e = _two_sum(a, b)
    odd = (s.view(np.int64) & 1) == 1
    t = np.nextafter(s, np.where(e > 0, np.inf, -np.inf))
    return np.where((e == 0) | odd, s, t)


def fma_vec(a, b, c):
    """fma over float64 arrays (Boldo and Melquiond, 2008)."""
    a, b, c = np.broadcast_arrays(*(np.asarray(v, np.float64)
                                    for v in (a, b, c)))
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    return th + _add_odd(tl, ul)


def _in_emu_range(*arrays):
    for v in arrays:
        v = np.abs(v[v != 0])
        assert v.size == 0 or (v.min() >= 2.0 ** -EMU_EXP
                               and v.max() <= 2.0 ** EMU_EXP)


def quot_vec(num, den, y):
    """The kernel's quot: num / den from y = 1 / den."""
    q0 = num * y
    r = fma_vec(-q0, den, num)
    _in_emu_range(num, den, y, q0, r)
    return fma_vec(r, y, q0)


def quot_exact(num, den):
    y = 1.0 / den
    q0 = num * y
    return fma_exact(fma_exact(-q0, den, num), y, q0)


def _bits(x):
    return np.asarray(x, np.float64).view(np.int64)


def _same(a, b):
    """Bit for bit, signs of zero included, where not NaN; NaN in the same
    places (a NaN's sign and payload carry nothing)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nan = np.isnan(a)
    return (np.array_equal(nan, np.isnan(b))
            and np.array_equal(_bits(a[~nan]), _bits(b[~nan])))


# ---------------------------------------------------------------------------
# the Miller set-up as ops/adaptive.bessel_i01 writes it
# ---------------------------------------------------------------------------

def miller_setup(zr, zi):
    """(neg, n, small, ratio, den) of z (float64 tensors, z != 0), with
    ops/adaptive.bessel_i01's operations."""
    neg = zr < 0.0
    wr = torch.where(neg, -zr, zr)
    wi = torch.where(neg, -zi, zi)
    aw = torch.hypot(wr, wi)
    n = (aw + 9.0 * torch.sqrt(aw)).to(torch.int64) + 24
    small = torch.abs(wr) < torch.abs(wi)
    ratio = torch.where(small, wr / wi, wi / wr)
    den = torch.where(small, wr * ratio + wi, wi * ratio + wr)
    return neg, n, small, ratio, den


@functools.lru_cache(maxsize=None)
def assembly_z(name):
    """Every Bessel argument z the plain version evaluates in the 32-point
    assembly of input ``name``, with the start orders it took: (zr, zi, n)
    as numpy arrays, and the assembly's Miller steps."""
    with open(INPUTS / f"{name}.json") as f:
        cfg = dict(json.load(f), npoints=32)
    p = et.from_config(cfg, device="cpu")
    iu, ju = torch.triu_indices(32, 32, 1)
    rows, m, _, ph = native.pair_integrals(p, iu, ju)
    seen = []
    plain = adaptive.bessel_i01

    def record(zr, zi):
        out = plain(zr, zi)
        seen.append((zr.clone(), zi.clone(), out[-1].clone()))
        return out

    adaptive.bessel_i01 = record
    try:
        _, _, miller = adaptive.integrate_ref(
            rows, m, adaptive.scalars(ph, OMEGA.get(name, GUESS)))
    finally:
        adaptive.bessel_i01 = plain
    zr, zi, n = (torch.cat(v) for v in zip(*seen))
    return zr.numpy(), zi.numpy(), n.numpy(), int(miller.sum())


# ---------------------------------------------------------------------------
# (a) the reciprocal-and-fma quotient is the IEEE quotient
# ---------------------------------------------------------------------------

def test_fma_vec_is_the_exact_fma():
    """fma_vec against fma_exact on the data's own operand triples and on
    seeded triples with wide exponents and near-total cancellation."""
    rng = np.random.default_rng(7)
    zr, zi, _, _ = assembly_z("tokamak")
    sel = rng.choice(zr.size, 1500, replace=False)
    _, _, small, ratio, den = (t.numpy() for t in miller_setup(
        torch.from_numpy(zr[sel]), torch.from_numpy(zi[sel])))
    a = 2.0 * rng.integers(1, 60, sel.size)
    num = np.where(small, a * ratio, a)
    y = 1.0 / den
    q0 = num * y
    r = fma_vec(-q0, den, num)
    m = rng.uniform(1, 2, (3, 2000)) * np.exp2(rng.integers(-200, 200,
                                                            (3, 2000)))
    m *= rng.choice([-1.0, 1.0], (3, 2000))
    cancel = -(m[0, :500] * m[1, :500])
    triples = [(-q0, den, num), (r, y, q0), tuple(m),
               (m[0, :500], m[1, :500], cancel),
               (m[0, :500], m[1, :500], np.nextafter(cancel, 0.0))]
    for x, yy, z in triples:
        got = fma_vec(x, yy, z)
        ref = [fma_exact(float(p), float(q), float(s))
               for p, q, s in zip(x, yy, z)]
        assert np.array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("name", GEOMETRIES)
def test_quotient_is_ieee_on_assembly(name):
    """Every quotient of every Miller step of the plain version's 32-point
    assembly: (2k, +-2k ratio) / den from y = 1 / den is the IEEE quotient
    bit for bit; every node lies in the kernel's reciprocal range, and the
    start orders are the plain version's."""
    zr, zi, n_plain, steps = assembly_z(name)
    assert zr.size and not ((zr == 0) & (zi == 0)).any()
    _, n, small, ratio, den = (t.numpy() for t in miller_setup(
        torch.from_numpy(zr), torch.from_numpy(zi)))
    assert np.array_equal(n, n_plain) and int(n.sum()) == steps
    assert (np.abs(den) >= RECIP_MIN).all() and (np.abs(den) <= RECIP_MAX).all()
    assert (np.abs(ratio) >= RECIP_MIN).all()
    node = np.repeat(np.arange(n.size), n)
    first = np.repeat(np.cumsum(n) - n, n)
    k = np.arange(node.size) - first + 1           # 1..n of each node
    checked = 0
    for s in range(0, node.size, CHUNK):
        i, a = node[s:s + CHUNK], 2.0 * k[s:s + CHUNK]
        sm, rt, dn = small[i], ratio[i], den[i]
        ar = a * rt
        y = 1.0 / dn
        for num in (np.where(sm, ar, a), np.where(sm, -a, -ar)):
            assert np.array_equal(_bits(quot_vec(num, dn, y)),
                                  _bits(num / dn))
            checked += num.size
    assert checked == 2 * steps


def _edge_cases(family, rng):
    """(num, den) pairs of one edge family, as the kernel forms them: num =
    2k or +-2k ratio, |ratio| <= 1, den in the kernel's range."""
    ones = 2.0 - 2.0 ** -52                      # mantissa of all ones
    ks = np.unique(np.concatenate([[1, 2, 3, 24, 2047, 2048, 2049, 2999,
                                    2 ** 31 - 1],
                                   rng.integers(1, 3000, 40)]))
    if family == "all_ones":
        dens = [s * ones * 2.0 ** e for e in range(-250, 250, 9)
                for s in (1.0, -1.0)]
        ratios = [1.0 - 2.0 ** -53] + [ones * 2.0 ** -j for j in
                                        (1, 2, 10, 52, 53, 200, 251)]
    elif family == "powers_of_two":
        dens = [s * 2.0 ** e for e in range(-250, 251, 10)
                for s in (1.0, -1.0)]
        ratios = [1.0] + [2.0 ** -j for j in (1, 3, 52, 53, 100, 250)]
    else:   # the range's ends, and random mantissas next to them
        ends = [RECIP_MIN, np.nextafter(RECIP_MIN, np.inf), RECIP_MAX,
                np.nextafter(RECIP_MAX, 0.0)]
        dens = [s * d for d in ends + list(RECIP_MIN * rng.uniform(1, 2, 6))
                + list(RECIP_MAX * rng.uniform(0.5, 1, 6))
                for s in (1.0, -1.0)]
        ratios = [RECIP_MIN, 1.0, np.nextafter(1.0, 0.0),
                  float(rng.uniform(0.5, 1.0))]
    out = []
    for den in dens:
        for k in rng.choice(ks, 12, replace=False):
            a = 2.0 * float(k)
            out.append((a, den))
            for rt in ratios:
                ar = a * rt
                out += [(ar, den), (-ar, den), (-a, den)]
    return out


@pytest.mark.parametrize("family", ["all_ones", "powers_of_two",
                                    "range_ends"])
def test_quotient_is_ieee_at_edges(family):
    """Edge mantissas (all ones, powers of two) and denominators at both ends
    of the kernel's reciprocal range, with fma_exact: the quotient is the
    IEEE quotient bit for bit."""
    cases = _edge_cases(family, np.random.default_rng(11))
    assert len(cases) > 1000
    for num, den in cases:
        assert RECIP_MIN <= abs(den) <= RECIP_MAX
        q = quot_exact(num, den)
        assert q == num / den and math.copysign(1.0, q) == math.copysign(
            1.0, num / den), (num, den)


# ---------------------------------------------------------------------------
# Bessel arguments: the assemblies', and the edges of the reciprocal range
# ---------------------------------------------------------------------------

def bessel_cases(group):
    """(zr, zi, recip) of one group of seeded Bessel arguments: recip, whether
    the kernel's reciprocal recurrence runs for them (else the dividing one).

    tokamak, stellarator: 1,500 z of the 32-point assembly and 40 with 700 <=
    |Re z| <= 1500, whose recurrences pass 1e250 and rescale.  real_axis: z
    real (Im z = +-0) or imaginary (Re z = +-0), where ratio is 0, up to |z|
    = 1500.  tiny: |z| from 1e-160 to 1e-77 (den under 2^-250), and z whose
    ratio Im w / Re w lies under 2^-250, down to subnormal (where the
    reciprocal would round some Im I0, Im I1 otherwise than the division
    does).  Most of the tiny |z| overflow the
    recurrence (its factor 2k / |w| a step is past what the 1e250 rescale
    absorbs) and give NaN in the plain version as in the engine."""
    rng = np.random.default_rng(3)
    if group in ("tokamak", "stellarator"):
        zr, zi, _, _ = assembly_z(group)
        sel = rng.choice(zr.size, 1500, replace=False)
        big_r = rng.uniform(700.0, 1500.0, 40) * rng.choice([-1.0, 1.0], 40)
        big_i = rng.uniform(-300.0, 300.0, 40)
        return (np.concatenate([zr[sel], big_r]),
                np.concatenate([zi[sel], big_i]), True)
    sign = rng.choice([-1.0, 1.0], 200)
    if group == "real_axis":
        mag = np.concatenate([10.0 ** rng.uniform(-3.0, 2.0, 160),
                              rng.uniform(700.0, 1500.0, 40)])
        zero = np.where(rng.uniform(size=200) < 0.5, 0.0, -0.0)
        axis = rng.uniform(size=200) < 0.75
        return (np.where(axis, sign * mag, zero),
                np.where(axis, zero, sign * np.minimum(mag, 200.0)), False)
    phase = rng.uniform(-np.pi, np.pi, 100)
    mag = 10.0 ** rng.uniform(-160.0, -77.0, 100)
    # Im w / Re w down to subnormal: there 2k ratio / den is subnormal and
    # the reciprocal's correction is no longer exact
    ratio = np.concatenate([10.0 ** rng.uniform(-300.0, -76.0, 100),
                            10.0 ** rng.uniform(-323.0, -300.0, 2000)])
    ratio *= rng.choice([-1.0, 1.0], ratio.size)
    re = rng.uniform(0.1, 40.0, ratio.size) * rng.choice([-1.0, 1.0],
                                                         ratio.size)
    return (np.concatenate([mag * np.cos(phase), re]),
            np.concatenate([mag * np.sin(phase), np.abs(re) * ratio]), False)


# ---------------------------------------------------------------------------
# (b) the new Miller step, modelled step for step
# ---------------------------------------------------------------------------

def miller_model(zr, zi):
    """csrc/adaptive.cu's bessel_i01 on float64 arrays (z != 0), step for
    step: the reciprocal quotient where den and ratio lie in the kernel's
    range (else two divisions), the fma running sum, the filtered rescale,
    y_1 taken as the last step's y_{k+1}.  Returns (i0r, i0i, i1r, i1i, zsr,
    zsi, n) as the plain version does, and each element's rescales."""
    tz = torch.from_numpy
    neg, n, small, ratio, den = (t.numpy() for t in miller_setup(tz(zr),
                                                                 tz(zi)))
    recip = ((np.abs(den) >= RECIP_MIN) & (np.abs(den) <= RECIP_MAX)
             & (np.abs(ratio) >= RECIP_MIN))
    order = np.argsort(-n, kind="stable")        # live elements: a prefix
    ns, sm, rt, dn, rc = n[order], small[order], ratio[order], den[order], \
        recip[order]
    y = 1.0 / dn
    ykr, yki = np.ones(ns.size), np.zeros(ns.size)
    yk1r, yk1i = np.zeros(ns.size), np.zeros(ns.size)
    sr, si = np.zeros(ns.size), np.zeros(ns.size)
    rescales = np.zeros(ns.size, np.int64)
    for k in range(int(ns.max()), 0, -1):
        L = int(np.searchsorted(-ns, -k, side="right"))
        a = float(2 * k)
        ar = a * rt[:L]
        nr = np.where(sm[:L], ar, a)
        ni = np.where(sm[:L], -a, -ar)
        tr, ti, r = nr / dn[:L], ni / dn[:L], rc[:L]
        tr[r] = quot_vec(nr[r], dn[:L][r], y[:L][r])
        ti[r] = quot_vec(ni[r], dn[:L][r], y[:L][r])
        cr, ci = ykr[:L].copy(), yki[:L].copy()
        pr = tr * cr - ti * ci
        pi = tr * ci + ti * cr
        nxr, nxi = pr + yk1r[:L], pi + yk1i[:L]
        sr[:L] = fma_vec(2.0, cr, sr[:L])
        si[:L] = fma_vec(2.0, ci, si[:L])
        yk1r[:L], yk1i[:L] = cr, ci
        ykr[:L], yki[:L] = nxr, nxi
        passed = np.fmax(np.abs(nxr), np.abs(nxi)) > FILTER
        big = passed & (torch.hypot(tz(nxr), tz(nxi)) > BIG).numpy()
        rescales[:L] += big
        for v in (ykr, yki, yk1r, yk1i, sr, si):
            v[:L] = np.where(big, v[:L] * 1e-250, v[:L])
    S = [tz(sr + ykr), tz(si + yki)]
    i0r, i0i = adaptive._cdiv(tz(ykr), tz(yki), *S)
    i1r, i1i = adaptive._cdiv(tz(yk1r), tz(yk1i), *S)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    sign = np.where(neg, -1.0, 1.0)
    out = (i0r.numpy()[inv], i0i.numpy()[inv], i1r.numpy()[inv] * sign,
           i1i.numpy()[inv] * sign, np.where(neg, zr, -zr),
           np.where(neg, zi, -zi), n)
    return out, rescales[inv]


def _recip(zr, zi):
    _, _, _, ratio, den = (t.numpy() for t in miller_setup(
        torch.from_numpy(zr), torch.from_numpy(zi)))
    return ((np.abs(den) >= RECIP_MIN) & (np.abs(den) <= RECIP_MAX)
            & (np.abs(ratio) >= RECIP_MIN))


@pytest.mark.parametrize("name", ["tokamak", "stellarator", "real_axis",
                                  "tiny"])
def test_miller_model_is_plain_bessel(name):
    """The model's I0, I1, zs and steps are ops/adaptive.bessel_i01's, bit
    for bit, signs of zero included (``_same``), on each group of
    ``bessel_cases``:
    those of the assemblies, whose 40 large z each pass 1e250 (|I_k| grows
    as e^|Re z|), take the reciprocal; the real axis and the tiny z divide.
    """
    zr, zi, recip = bessel_cases(name)
    assert (_recip(zr, zi) == recip).all()
    got, rescales = miller_model(zr, zi)
    ref = adaptive.bessel_i01(torch.from_numpy(zr), torch.from_numpy(zi))
    normal = np.hypot(zr, zi) >= 1e-3
    assert ((rescales > 0) == (np.abs(zr) >= 700.0))[normal].all()
    for g, r in zip(got, ref):
        assert _same(g, r.numpy())


# ---------------------------------------------------------------------------
# the kernel's own Bessel code, built for the host
# ---------------------------------------------------------------------------

HARNESS = r"""
#include "adaptive_bessel.h"

extern "C" void n1_bessel(const double* zr, const double* zi, long long n,
                          double* out, int* steps) {
  for (long long k = 0; k < n; ++k) {
    C i0, i1, zs;
    bessel_i01(C{zr[k], zi[k]}, i0, i1, zs, steps[k]);
    const double o[6] = {i0.r, i0.i, i1.r, i1.i, zs.r, zs.i};
    for (int j = 0; j < 6; ++j) out[6 * k + j] = o[j];
  }
}

extern "C" int n1_recip_range(double den, double ratio) {
  return recip_range(den, ratio);
}
"""


@pytest.fixture(scope="module")
def kernel_bessel(tmp_path_factory):
    """csrc/adaptive_bessel.h compiled for the host with g++, without FMA
    contraction (as nvcc --fmad=false builds the kernel): (n1_bessel,
    n1_recip_range)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's Bessel code for the host")
    tmp = tmp_path_factory.mktemp("n1_bessel")
    (tmp / "harness.cc").write_text(HARNESS)
    lib = tmp / "libn1_bessel.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off",
                    "-fno-fast-math", "-shared", "-fPIC", "-I", str(SRC.parent),
                    "-o", str(lib), str(tmp / "harness.cc")], check=True)
    so = ctypes.CDLL(str(lib))
    vp = ctypes.c_void_p
    so.n1_bessel.argtypes = [vp, vp, ctypes.c_longlong, vp, vp]
    so.n1_bessel.restype = None
    so.n1_recip_range.argtypes = [ctypes.c_double, ctypes.c_double]
    so.n1_recip_range.restype = ctypes.c_int
    return so


@pytest.mark.parametrize("name", ["tokamak", "stellarator", "real_axis",
                                  "tiny"])
def test_kernel_bessel_is_plain_bessel(kernel_bessel, name):
    """The kernel's bessel_i01, from its own source, against
    ops/adaptive.bessel_i01 on each group of ``bessel_cases``: I0, I1, zs
    bit for bit, signs of zero included (``_same``), and the same steps;
    each z takes
    the instance of the recurrence the group names (by the kernel's own
    recip_range).  The dividing instance keeps the engine's rounding where
    the reciprocal's correction is not exact: a subnormal 2k ratio / den
    (the tiny group, where the reciprocal would change some Im I0 and Im
    I1) and a -0 numerator on the axes (whose +0 from the correction the
    next sums happen to absorb)."""
    zr, zi, recip = bessel_cases(name)
    n = zr.size
    out = np.empty((n, 6))
    steps = np.empty(n, np.int32)
    kernel_bessel.n1_bessel(zr.ctypes.data, zi.ctypes.data, n,
                            out.ctypes.data, steps.ctypes.data)
    _, _, _, ratio, den = (t.numpy() for t in miller_setup(
        torch.from_numpy(zr), torch.from_numpy(zi)))
    took = [kernel_bessel.n1_recip_range(d, r) for d, r in zip(den, ratio)]
    assert all(bool(t) == recip for t in took)
    ref = adaptive.bessel_i01(torch.from_numpy(zr), torch.from_numpy(zi))
    for j in range(6):
        assert _same(out[:, j], ref[j].numpy()), j
    assert np.array_equal(steps, ref[6].numpy())


# ---------------------------------------------------------------------------
# (c) the rescale filter
# ---------------------------------------------------------------------------

_near = st.floats(min_value=1e249, max_value=2e250)
_any = st.floats(allow_nan=True, allow_infinity=True)


@settings(max_examples=800, deadline=None, derandomize=True)
@given(st.one_of(_near, _any, _near.map(lambda v: -v)),
       st.one_of(_near, _any, st.just(0.0)))
def test_rescale_filter_skips_no_rescale(x, y):
    """Where hypot(x, y) > 1e250 (libm's and torch's), max(|x|, |y|) passes
    the kernel's filter (fmax: a NaN gives way to the other operand)."""
    h = max(math.hypot(x, y), np.hypot(x, y),
            float(torch.hypot(torch.tensor(x, dtype=torch.float64),
                              torch.tensor(y, dtype=torch.float64))))
    if h > BIG:
        assert np.fmax(abs(x), abs(y)) > FILTER


def test_rescale_filter_margin():
    """On the filter's edge hypot stays under 1e250 by more than hypot's
    error: sqrt(2) 5e249 (1 + 2^-50) < 1e250."""
    assert math.sqrt(2.0) * FILTER * (1 + 2.0 ** -50) < BIG
    for x, y in ((FILTER, FILTER), (FILTER, 0.0), (FILTER, -FILTER)):
        assert max(math.hypot(x, y), np.hypot(x, y)) < BIG
