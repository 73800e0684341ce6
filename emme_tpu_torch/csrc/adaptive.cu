// Float64 adaptive Gauss-Kronrod transit-time integrals, one integral per
// (pair, moment), CUDA C++ for Hopper (sm_90a): kernel N1.
//
// Replaces no TPU kernel: it ports the reference-exact C++ engine
// native/emme_native.cpp (integrate_adaptive at :319, PairCtx at :203,
// bessel_i01 at :168, reached from emme_assemble at :439 and
// emme_kappa_batch), which the JAX package keeps on the CPU because the TPU
// has no float64.  Same math, operation for operation, as the plain version
// emme_tpu_torch/ops/adaptive.py: the integrand on (re, im) doubles with each
// complex product and quotient written out as GCC evaluates std::complex
// (Smith's division, libgcc __divdc3), the Miller-recurrence scaled I0/I1
// (start order floor(|w| + 9 sqrt|w|) + 24, rescale by 1e-250 past 1e250),
// the -40 exponent cutoff, nv^m, G7K15 / G15K31 panels in x = atan(t) with
// the 1/cos^2 factor, the two-part acceptance test with precision_goal, the
// depth limit ldexp(half, max_subdivide) > 0.99 pi/2, the 100,000-pop guard,
// and the engine's depth-first order (left child first), so the panel sums
// add up in the engine's order.  Build with --fmad=false (_build.py): an
// accept/split decision can turn on the last bit, and a contracted FMA would
// round where the plain version does not.  The prefactor
// -i qR / (vt sqrt(2 pi)) and the placement in the matrix are the caller's.
//
// What bounds it: float64 operations.  A pair reads 36 bytes and writes 28;
// a node costs some 180-230 float64 operations besides its Bessel recurrence
// of 16 a step over 24 to ~100 steps, with IEEE divisions and libm calls
// (tan, cos, atan, sincos, exp, hypot) among them.  No tensor core is used.
//
// Design (simple first): one warp per integral, a grid-stride loop over
// integrals.  Lanes 0..14 (G7K15) or 0..30 (G15K31) each evaluate one node of
// the panel on top of the interval stack; the node values go to a per-warp
// buffer in shared memory and every lane forms the Kronrod and Gauss sums in
// the engine's order from it, so the accept decision is uniform across the
// warp without a shuffle.  The stack (at most max_subdivide + 1 intervals)
// lives in shared memory, written by lane 0.  The Miller steps of each node
// are summed with a fixed-order shuffle and written with the panel count.
// The kernel allocates nothing and does not synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1 << 20;
constexpr int kMaxPops = 100000;
constexpr int kMaxSubdivide = 700;   // the stack of 4 warps stays under 48 KB
constexpr double kBig = 1e250;
constexpr double kInvBig = 1e-250;
constexpr double kCutoff = -40.0;
constexpr double kHalfPi = 3.14159265358979323846 / 2.0;
constexpr double kInvScale = 2.0 / kHalfPi;

__constant__ double kX15[8] = {
    0.0, 0.20778495500789847, 0.40584515137739717, 0.58608723546769113,
    0.74153118559939444, 0.86486442335976907, 0.94910791234275852,
    0.99145537112081264};
__constant__ double kWG15[4] = {0.41795918367346939, 0.38183005050511894,
                                0.27970539148927667, 0.12948496616886969};
__constant__ double kWK15[8] = {
    2.09482141084727828e-01, 2.04432940075298892e-01, 1.90350578064785410e-01,
    1.69004726639267903e-01, 1.40653259715525919e-01, 1.04790010322250184e-01,
    6.30920926299785533e-02, 2.29353220105292250e-02};
__constant__ double kX31[16] = {
    0.0, 0.1011420669187175, 0.20119409399743452, 0.29918000715316881,
    0.39415134707756337, 0.48508186364023968, 0.57097217260853885,
    0.65099674129741697, 0.72441773136017005, 0.79041850144246593,
    0.84820658341042722, 0.8972645323440819, 0.9372733924007059,
    0.96773907567913913, 0.98799251802048543, 0.99800229869339706};
__constant__ double kWG31[8] = {0.20257824192556112, 0.19843148532711152,
                                0.18616100001556193, 0.1662692058169939,
                                0.1395706779261542,  0.10715922046717143,
                                0.07036604748810768, 0.030753241996119};
__constant__ double kWK31[16] = {
    0.10133000701479155,   0.100769845523875595,  0.099173598721791959,
    0.0966427269836236785, 0.093126598170825321,  0.0885644430562117706,
    0.083080502823133021,  0.0768496807577203789, 0.069854121318728259,
    0.0620095678006706403, 0.053481524690928087,  0.0445897513247648766,
    0.035346360791375846,  0.0254608473267153202, 0.0150079473293161225,
    0.00537747987292334899};

// omega, arc_coeff, q R, vt, omega_s_i, eta_i, rel_tol, precision_goal
struct Scal {
  double om_r, om_i, arc, qR, vt, wsi, eta_i, rel_tol, pg;
  int order, max_sub;
};

struct Pair {
  double d_eta, beta1, bie, bip, sqrt_bb;
};

struct C {
  double r, i;
};

__device__ __forceinline__ C cmul(C a, C b) {
  return {a.r * b.r - a.i * b.i, a.r * b.i + a.i * b.r};
}

// (a.r + i a.i) / (b.r + i b.i): Smith's algorithm, libgcc's __divdc3
__device__ __forceinline__ C cdiv(C a, C b) {
  if (fabs(b.r) < fabs(b.i)) {
    const double r = b.r / b.i;
    const double den = b.r * r + b.i;
    return {(a.r * r + a.i) / den, (a.i * r - a.r) / den};
  }
  const double r = b.i / b.r;
  const double den = b.i * r + b.r;
  return {(a.i * r + a.r) / den, (a.i - a.r * r) / den};
}

// a / (c + i d) for real a: __divdc3 with a zero imaginary numerator
__device__ __forceinline__ C rdiv(double a, C b) {
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
__device__ __forceinline__ C idiv(double b, C z) {
  if (fabs(z.r) < fabs(z.i)) {
    const double r = z.r / z.i;
    const double den = z.r * r + z.i;
    return {b / den, (b * r) / den};
  }
  const double r = z.i / z.r;
  const double den = z.i * r + z.r;
  return {(b * r) / den, b / den};
}

// Scaled I0/I1 by Miller's backward recurrence (emme_native.cpp:168-197):
// i0 = I0(z) e^{zs}, i1 = I1(z) e^{zs}, zs = z if Re z < 0 else -z; steps
// is the recurrence's length.
__device__ void bessel_i01(C z, C& i0, C& i1, C& zs, int& steps) {
  if (z.r == 0.0 && z.i == 0.0) {
    i0 = {1.0, 0.0};
    i1 = {0.0, 0.0};
    zs = {0.0, 0.0};
    steps = 0;
    return;
  }
  const bool neg = z.r < 0.0;
  zs = neg ? z : C{-z.r, -z.i};
  const C w = neg ? C{-z.r, -z.i} : z;
  const double aw = hypot(w.r, w.i);
  const int n = static_cast<int>(aw + 9.0 * sqrt(aw)) + 24;
  // 2k / w by Smith's division: its ratio and denominator do not depend on k
  const bool small = fabs(w.r) < fabs(w.i);
  const double ratio = small ? w.r / w.i : w.i / w.r;
  const double den = small ? w.r * ratio + w.i : w.i * ratio + w.r;
  C yk1 = {0.0, 0.0}, yk = {1.0, 0.0}, s = {0.0, 0.0}, y1 = {0.0, 0.0};
  for (int k = n; k >= 1; --k) {
    const double a = 2.0 * k;
    const double ar = a * ratio;
    const C t = {(small ? ar : a) / den, (small ? -a : -ar) / den};
    const C p = cmul(t, yk);
    const C ykm1 = {p.r + yk1.r, p.i + yk1.i};
    s.r = s.r + 2.0 * yk.r;
    s.i = s.i + 2.0 * yk.i;
    if (k == 1) y1 = yk;
    yk1 = yk;
    yk = ykm1;
    if (hypot(yk.r, yk.i) > kBig) {
      yk = {yk.r * kInvBig, yk.i * kInvBig};
      yk1 = {yk1.r * kInvBig, yk1.i * kInvBig};
      s = {s.r * kInvBig, s.i * kInvBig};
      y1 = {y1.r * kInvBig, y1.i * kInvBig};
    }
  }
  const C S = {s.r + yk.r, s.i + yk.i};
  i0 = cdiv(yk, S);
  i1 = cdiv(y1, S);
  if (neg) i1 = {-i1.r, -i1.i};
  steps = n;
}

// f(tan x) / cos^2 x: the engine's PairCtx::operator() at t = tan x
__device__ C integrand(double x, const Pair& pr, int m, const Scal& sc,
                       int& steps) {
  const double t = tan(x);
  const double c = cos(x);
  const double omi = -copysign(1.0, sc.om_r);
  const double phi = (-omi) * atan(t / sc.arc);
  const double ear = cos(phi), eai = sin(phi);
  const C tau = {t * ear, t * eai};
  const double dj = sc.arc * (1.0 + (t / sc.arc) * (t / sc.arc));
  const C jac = {ear - (((-eai) * omi) * t) / dj, eai - ((ear * omi) * t) / dj};
  const double qrd = sc.qR * pr.d_eta;
  const C lam = {1.0 + ((-0.5 * (tau.i * sc.vt)) / qrd) * pr.beta1,
                 ((0.5 * (tau.r * sc.vt)) / qrd) * pr.beta1};
  C i0s, i1s, zs;
  bessel_i01(rdiv(pr.sqrt_bb, lam), i0s, i1s, zs, steps);
  const C l3 = rdiv(1.0, cmul(cmul(lam, lam), lam));
  const C nv = rdiv(qrd, C{sc.vt * tau.r, sc.vt * tau.i});
  const C h = cmul(C{0.5 * nv.r, 0.5 * nv.i}, nv);
  const double hr = sc.eta_i * (h.r - 1.5);
  const double hi = sc.eta_i * h.i;
  const C a0 = cdiv(C{sc.om_r - sc.wsi * (1.0 + hr), sc.om_i - sc.wsi * hi},
                    lam);
  const double we = sc.wsi * sc.eta_i;
  const C b0 = cmul(C{we * (0.5 * (pr.bie + pr.bip) - lam.r), we * (-lam.i)},
                    l3);
  const C i0c = {a0.r + b0.r, a0.i + b0.i};
  const double w1 = -sc.wsi * sc.eta_i * pr.sqrt_bb;
  const C i1c = {w1 * l3.r, w1 * l3.i};
  const C A = cmul(C{-0.5 * nv.r, -0.5 * nv.i}, nv);
  const double hb = 0.5 * pr.beta1;
  const C B = {-(hb * nv.i), hb * nv.r};
  const C Cc = cmul(C{-tau.i, tau.r}, C{sc.om_r, sc.om_i});
  const C E = idiv(pr.beta1, nv);
  const C G = rdiv(pr.bie + pr.bip, C{2.0 + E.r, E.i});
  const double xr = ((A.r - B.r) + Cc.r) - G.r - zs.r;
  const double xi = ((A.i - B.i) + Cc.i) - G.i - zs.i;
  if (xr < kCutoff) return {0.0, 0.0};
  const C nm = m >= 2 ? cmul(nv, nv) : (m == 1 ? nv : C{1.0, 0.0});
  C f = cmul(cdiv(nm, tau), jac);
  const double ex = exp(xr);
  f = cmul(f, C{ex * cos(xi), ex * sin(xi)});
  const C s0 = cmul(i0c, i0s);
  const C s1 = cmul(i1c, i1s);
  f = cmul(f, C{s0.r + s1.r, s0.i + s1.i});
  const double cc = c * c;
  return {f.r / cc, f.i / cc};
}

__global__ void __launch_bounds__(kThreads)
    adaptive_kernel(const double* __restrict__ rows,
                    const int* __restrict__ moments, long long n, Scal sc,
                    double* __restrict__ out, int* __restrict__ panels,
                    long long* __restrict__ miller) {
  extern __shared__ double2 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cap = sc.max_sub + 2;
  double2* stack = smem + warp * (cap + 32);
  double2* fbuf = stack + cap;
  const bool k31 = sc.order == 31;
  const int nh = k31 ? 16 : 8;
  const int nn = 2 * nh - 1;
  const int gauss = k31 ? 15 : 7;
  const double* X = k31 ? kX31 : kX15;
  const double* WK = k31 ? kWK31 : kWK15;
  const double* WG = k31 ? kWG31 : kWG15;
  // lane 0: the centre; lane 2i - 1: mid + half X[i]; lane 2i: mid - half X[i]
  const double xn = (lane > 0 && lane < nn) ? X[(lane + 1) >> 1] : 0.0;
  const bool plus = lane & 1;

  for (long long k = static_cast<long long>(blockIdx.x) * kWarps + warp;
       k < n; k += static_cast<long long>(gridDim.x) * kWarps) {
    const double* row = rows + 4 * k;
    Pair pr;
    pr.d_eta = row[0];
    pr.beta1 = row[1];
    pr.bie = row[2];
    pr.bip = row[3];
    pr.sqrt_bb = sqrt(pr.bie * pr.bip);
    const int m = moments[k];
    if (lane == 0) stack[0] = make_double2(0.0, kHalfPi);
    int sp = 1, guard = 0, pops = 0;
    long long steps = 0;
    double sum_r = 0.0, sum_i = 0.0, abs_tol = 0.0;
    __syncwarp();
    while (sp > 0 && ++guard < kMaxPops) {
      const double2 iv = stack[--sp];
      const double mid = 0.5 * (iv.x + iv.y);
      const double half = 0.5 * (iv.y - iv.x);
      if (lane < nn) {
        const double x =
            lane == 0 ? mid : (plus ? mid + half * xn : mid - half * xn);
        int st;
        const C f = integrand(x, pr, m, sc, st);
        steps += st;
        fbuf[lane] = make_double2(f.r, f.i);
      }
      __syncwarp();
      const double2 f0 = fbuf[0];
      double gkr = 0.0 + WK[0] * f0.x, gki = 0.0 + WK[0] * f0.y;
      double gr = 0.0 + WG[0] * f0.x, gi = 0.0 + WG[0] * f0.y;
      for (int i = 1; i < nh; ++i) {
        const double2 fp = fbuf[2 * i - 1], fm = fbuf[2 * i];
        const double vr = fp.x + fm.x, vi = fp.y + fm.y;
        gkr = gkr + WK[i] * vr;
        gki = gki + WK[i] * vi;
        if ((gauss - i) % 2 != 0) {
          gr = gr + WG[i / 2] * vr;
          gi = gi + WG[i / 2] * vi;
        }
      }
      __syncwarp();   // every lane has read the buffer and the popped slot
      const double ir = gkr * half, ii = gki * half;
      const double err = hypot(gkr - gr, gki - gi) * half;
      const double cur = hypot(sc.rel_tol * ir, sc.rel_tol * ii);
      if (abs_tol == 0.0) abs_tol = cur;
      const bool can_split = ldexp(half, sc.max_sub) > 0.99 * kHalfPi;
      if (can_split && err > abs_tol * kInvScale + sc.pg &&
          err > cur + sc.pg) {
        if (lane == 0) {
          stack[sp] = make_double2(mid, iv.y);
          stack[sp + 1] = make_double2(iv.x, mid);
        }
        sp += 2;
      } else {
        sum_r = sum_r + ir;
        sum_i = sum_i + ii;
      }
      ++pops;
      __syncwarp();
    }
    for (int off = 16; off > 0; off >>= 1)
      steps += __shfl_down_sync(0xffffffffu, steps, off);
    if (lane == 0) {
      out[2 * k] = sum_r;
      out[2 * k + 1] = sum_i;
      panels[k] = pops;
      miller[k] = steps;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// The largest max_subdivide the kernel's shared-memory stack takes.
int adaptive_max_subdivide() { return kMaxSubdivide; }

// Launch on `stream`.  rows: (n, 4) float64 [d_eta, beta1, b_i(eta),
// b_i(eta')]; moments: (n,) int32; scal: 9 host doubles [om_r, om_i, arc,
// qR, vt, omega_s_i, eta_i, rel_tol, precision_goal]; out: (n, 2) float64;
// panels: (n,) int32; miller: (n,) int64.  Returns cudaGetLastError() after
// the launch (0 on success).
int adaptive_launch(const double* rows, const int* moments, long long n,
                    const double* scal, int order, int max_sub, double* out,
                    int* panels, long long* miller, void* stream) {
  if (n < 1 || (order != 15 && order != 31) || max_sub < 0 ||
      max_sub > kMaxSubdivide)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scal sc = {scal[0], scal[1], scal[2], scal[3], scal[4], scal[5],
                   scal[6], scal[7], scal[8], order, max_sub};
  const size_t smem =
      static_cast<size_t>(kWarps) * (max_sub + 2 + 32) * sizeof(double2);
  const long long blocks = (n + kWarps - 1) / kWarps;
  const int grid = static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  adaptive_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      rows, moments, n, sc, out, panels, miller);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
