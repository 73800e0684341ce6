// Kernel N1's integrand at one node, split into the node's omega-free half
// and its omega half (the engine's PairCtx::operator(), emme_native.cpp:
// 221-248), included by adaptive.cu.  Plain C++ apart from the function
// qualifiers, like adaptive_bessel.h, so the same code also compiles for
// the host (tests/test_torch_adaptive_memo.py builds it with g++).  Like
// adaptive.cu it must build without FMA contraction.
//
// Within a solve only omega changes (the sign of Re omega aside, which
// fixes the contour's direction): the Miller recurrence, lambda, the
// geometry's terms and the contour's point are the same at every
// assembly.  free_half computes everything omega does not change, each
// value rounded as the engine's integrand rounds it; omega_half finishes
// the node from those values in the engine's order of operations.  So
// omega_half(free_half(x)) is the engine's integrand operation for
// operation, and so is omega_half of a free half read back from memory.

#ifndef EMME_TPU_TORCH_ADAPTIVE_NODE_H_
#define EMME_TPU_TORCH_ADAPTIVE_NODE_H_

#include "adaptive_bessel.h"

namespace {

constexpr double kCutoff = -40.0;

// omega, arc_coeff, q R, vt, omega_s_i, eta_i, rel_tol, precision_goal
struct Scal {
  double om_r, om_i, arc, qR, vt, wsi, eta_i, rel_tol, pg;
  int order, max_sub;
};

struct Pair {
  double d_eta, beta1, bie, bip, sqrt_bb;
};

// a / (c + i d) for real a: __divdc3 with a zero imaginary numerator
N1_INLINE C rdiv(double a, C b) {
  if (fabs(b.r) < fabs(b.i)) {
    const double r = b.r / b.i;
    const double den = b.r * r + b.i;
    return {(a * r) / den, (-a) / den};
  }
  const double r = b.i / b.r;
  const double den = b.i * r + b.r;
  return {a / den, (-(a * r)) / den};
}

// i b / (c + i d) for real b: __divdc3 with a zero real numerator
N1_INLINE C idiv(double b, C z) {
  if (fabs(z.r) < fabs(z.i)) {
    const double r = z.r / z.i;
    const double den = z.r * r + z.i;
    return {b / den, (b * r) / den};
  }
  const double r = z.i / z.r;
  const double den = z.i * r + z.r;
  return {(b * r) / den, b / den};
}

// What omega_half reads of a node: 21 float64, the fields of its record.
struct Half {
  C u;     // omega_s_i (1 + h_r), omega_s_i h_i (eta_i in h)
  C lam;   // lambda
  C b0;    // the I0 coefficient's omega-free term
  C i0s;   // the scaled I0
  C s1;    // the I1 coefficient times the scaled I1
  C tau;   // the contour's point
  C ab;    // A - B
  C g;     // G
  C zs;    // the Bessel scaling exponent
  C f0;    // nv^m / tau times the contour's Jacobian
  double cc;   // cos^2 x
};
constexpr int kHalfFields = 21;

// The omega-free half of f(tan x) / cos^2 x; steps: the Miller
// recurrence's length.  Depends on omega only through sign(Re omega).
N1_FN Half free_half(double x, const Pair& pr, int m, const Scal& sc,
                     int& steps) {
  Half h;
  const double t = tan(x);
  const double c = cos(x);
  const double omi = -copysign(1.0, sc.om_r);
  const double phi = (-omi) * atan(t / sc.arc);
  const double ear = cos(phi), eai = sin(phi);
  h.tau = {t * ear, t * eai};
  const double dj = sc.arc * (1.0 + (t / sc.arc) * (t / sc.arc));
  const C jac = {ear - (((-eai) * omi) * t) / dj, eai - ((ear * omi) * t) / dj};
  const double qrd = sc.qR * pr.d_eta;
  h.lam = {1.0 + ((-0.5 * (h.tau.i * sc.vt)) / qrd) * pr.beta1,
           ((0.5 * (h.tau.r * sc.vt)) / qrd) * pr.beta1};
  C i1s;
  bessel_i01(rdiv(pr.sqrt_bb, h.lam), h.i0s, i1s, h.zs, steps);
  const C l3 = rdiv(1.0, cmul(cmul(h.lam, h.lam), h.lam));
  const C nv = rdiv(qrd, C{sc.vt * h.tau.r, sc.vt * h.tau.i});
  const C hh = cmul(C{0.5 * nv.r, 0.5 * nv.i}, nv);
  const double hr = sc.eta_i * (hh.r - 1.5);
  const double hi = sc.eta_i * hh.i;
  h.u = {sc.wsi * (1.0 + hr), sc.wsi * hi};
  const double we = sc.wsi * sc.eta_i;
  h.b0 = cmul(C{we * (0.5 * (pr.bie + pr.bip) - h.lam.r), we * (-h.lam.i)},
              l3);
  const double w1 = -sc.wsi * sc.eta_i * pr.sqrt_bb;
  h.s1 = cmul(C{w1 * l3.r, w1 * l3.i}, i1s);
  const C A = cmul(C{-0.5 * nv.r, -0.5 * nv.i}, nv);
  const double hb = 0.5 * pr.beta1;
  const C B = {-(hb * nv.i), hb * nv.r};
  h.ab = {A.r - B.r, A.i - B.i};
  const C E = idiv(pr.beta1, nv);
  h.g = rdiv(pr.bie + pr.bip, C{2.0 + E.r, E.i});
  const C nm = m >= 2 ? cmul(nv, nv) : (m == 1 ? nv : C{1.0, 0.0});
  h.f0 = cmul(cdiv(nm, h.tau), jac);
  h.cc = c * c;
  return h;
}

// The node's value from its omega-free half at omega: the a0 quotient,
// the exponent with its -40 cutoff, exp and its phase, the products.
N1_FN C omega_half(const Half& h, const Scal& sc) {
  const C a0 = cdiv(C{sc.om_r - h.u.r, sc.om_i - h.u.i}, h.lam);
  const C i0c = {a0.r + h.b0.r, a0.i + h.b0.i};
  const C Cc = cmul(C{-h.tau.i, h.tau.r}, C{sc.om_r, sc.om_i});
  const double xr = ((h.ab.r + Cc.r) - h.g.r) - h.zs.r;
  const double xi = ((h.ab.i + Cc.i) - h.g.i) - h.zs.i;
  if (xr < kCutoff) return {0.0, 0.0};
  const double ex = exp(xr);
  C f = cmul(h.f0, C{ex * cos(xi), ex * sin(xi)});
  const C s0 = cmul(i0c, h.i0s);
  f = cmul(f, C{s0.r + h.s1.r, s0.i + h.s1.i});
  return {f.r / h.cc, f.i / h.cc};
}

// A node's record: field f at p[f * stride], so that the lanes of a slot,
// one node each at stride 1, read and write adjacent words.
N1_INLINE void store_half(double* p, int stride, const Half& h) {
  const double v[kHalfFields] = {h.u.r,  h.u.i,  h.lam.r, h.lam.i, h.b0.r,
                                 h.b0.i, h.i0s.r, h.i0s.i, h.s1.r,  h.s1.i,
                                 h.tau.r, h.tau.i, h.ab.r, h.ab.i,  h.g.r,
                                 h.g.i,  h.zs.r, h.zs.i, h.f0.r,  h.f0.i,
                                 h.cc};
#pragma unroll
  for (int f = 0; f < kHalfFields; ++f) p[f * stride] = v[f];
}

N1_INLINE Half load_half(const double* p, int stride) {
  double v[kHalfFields];
#pragma unroll
  for (int f = 0; f < kHalfFields; ++f) v[f] = p[f * stride];
  Half h;
  h.u = {v[0], v[1]};
  h.lam = {v[2], v[3]};
  h.b0 = {v[4], v[5]};
  h.i0s = {v[6], v[7]};
  h.s1 = {v[8], v[9]};
  h.tau = {v[10], v[11]};
  h.ab = {v[12], v[13]};
  h.g = {v[14], v[15]};
  h.zs = {v[16], v[17]};
  h.f0 = {v[18], v[19]};
  h.cc = v[20];
  return h;
}

// The engine's depth-first order of an integral's intervals (left child
// first) as a key: left end ascending, then right end (so width)
// descending.  Whether [alo, ahi] comes before [blo, bhi].
N1_INLINE bool key_before(double alo, double ahi, double blo, double bhi) {
  return alo < blo || (alo == blo && ahi > bhi);
}

}  // namespace

#endif  // EMME_TPU_TORCH_ADAPTIVE_NODE_H_
