// Transit-time kernel integral kappa_f_tau for every (eta, eta') pair, CUDA C++
// for Hopper (sm_90a).
//
// Replaces the TPU kernel emme_tpu/ops/pallas_kappa.py::_kappa_kernel (the
// Pallas body at line 241, launched by _kappa_pairs_call).  Same math, term
// for term: the Gauss-Kronrod nodes of each pair's panel mesh are built from
// the panel (mid, half-width) rows, then the contour rotation (cos/sin of
// atan done algebraically), the propagator lambda, the float32 scaled complex
// Bessel I0/I1 (26 Taylor / 10 asymptotic terms, split at |w|^2 = 144), the
// I0/I1 coefficients, the log-domain exponent with the -40 safe-exp cut, and
// the Kronrod-weighted sum per velocity moment m in ms.  The prefactor
// -i qR / (vt sqrt(2 pi)) is applied by the caller.
//
// What bounds it: FP32 ALU and SFU throughput.  Each node costs some 300-500
// flops and about 10 transcendentals (rsqrt, sqrt, exp, sincos, IEEE divides),
// while a pair reads 4 * (2 * n_panels + 4) bytes and writes 8 per moment, so
// device memory is idle.  No tensor core is used: nothing here is a matrix
// product.  The math routines are the full-range ones (sincosf of arguments
// up to thousands of radians, expf down to -40, IEEE division); the file
// must not be built with --use_fast_math.
//
// Design (simple first): one warp per pair, a grid-stride loop over pairs.
// The 32 lanes stride over the pair's n_panels * order nodes, so every node
// of a pair is real work (no padding lanes).  Each lane keeps its moment sums
// in registers; a shuffle reduction ends the pair and lane 0 writes
// out[pair, 2k:2k+2].  The Taylor / asymptotic constants and the G-K tables
// arrive in a by-value kernel parameter, so they sit in the constant bank;
// the G-K tables, indexed per node, are copied to shared memory first.  The
// kernel allocates nothing and does not synchronise.

#include <cuda_runtime.h>

#include <cstring>

#include "assembly.h"   // kernels P and Q of the dense assembly, around K1

namespace {

constexpr int kMaxOrder = 31;
constexpr int kTaylorTerms = 26;
constexpr int kAsymTerms = 10;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kMaxBlocks = 65535;
constexpr float kSafeExpCutoff = -40.0f;
constexpr float kSplit2 = 144.0f;           // |w|^2 <= 12^2 -> Taylor
constexpr float kTwoPi = 6.28318530717958647692f;

// Which side of the scaled Bessel functions' |w| <= 12 split is compiled: 0,
// both (every build the package loads); 1, the Taylor sums alone; 2, the
// asymptotic sums alone.  1 and 2 exist to count the instructions of each
// path (emme_tpu_torch/tools/sass_count.py) and are never loaded.
#ifndef EMME_BESSEL_BRANCH
#define EMME_BESSEL_BRANCH 0
#endif

// Constant tables, filled by the caller (emme_tpu_torch/ops/cuda_kappa.py
// kernel_tables) from the same float32 values the plain version uses.
struct Tables {
  float x[kMaxOrder];        // G-K abscissae on [-1, 1]
  float wk[kMaxOrder];       // Kronrod weights
  float c0[kTaylorTerms];    // 1 / (k k),      k = 1..26
  float c1[kTaylorTerms];    // 1 / (k (k+1)),  k = 1..26
  float a0m[kAsymTerms];     // (-1)^k a_k(0)
  float a0p[kAsymTerms];     // a_k(0)
  float a1m[kAsymTerms];     // (-1)^k a_k(1)
  float a1p[kAsymTerms];     // a_k(1)
};
constexpr int kTableLen = static_cast<int>(sizeof(Tables) / sizeof(float));

struct Moments {
  int n;       // 1..3
  int m[3];    // increasing, each in {0, 1, 2}
};

struct Scalars {
  float om_r, om_i, arc, qR, vt, ws_i, eta_i, omi;
};

struct PairConst {
  float b1, ba, bb, sbb, c, k_de;
};

struct cfloat {
  float r, i;
};

__device__ __forceinline__ cfloat cmul(cfloat a, cfloat b) {
  return {a.r * b.r - a.i * b.i, a.r * b.i + a.i * b.r};
}

__device__ __forceinline__ cfloat cinv(cfloat b) {
  const float d = 1.0f / (b.r * b.r + b.i * b.i);
  return {b.r * d, -b.i * d};
}

__device__ __forceinline__ cfloat cdiv(cfloat a, cfloat b) {
  const float d = 1.0f / (b.r * b.r + b.i * b.i);
  return {(a.r * b.r + a.i * b.i) * d, (a.i * b.r - a.r * b.i) * d};
}

__device__ __forceinline__ cfloat cexp_f(float ar, float ai) {
  const float e = expf(ar);
  float s, c;
  sincosf(ai, &s, &c);
  return {e * c, e * s};
}

// Principal sqrt for Re w >= 0 (algebraic form, no trig).
__device__ __forceinline__ cfloat csqrt_rhp(float wr, float wi) {
  const float r = sqrtf(wr * wr + wi * wi);
  const float t = sqrtf(0.5f * (r + wr) + 1e-30f);
  return {t, wi / (2.0f * t)};
}

// Scaled I0/I1: i_n = I_n(z) e^{zs}, zs = z if Re z < 0 else -z.
__device__ __forceinline__ void bessel_i01_scaled(cfloat z, const Tables& tab,
                                                  cfloat& i0, cfloat& i1,
                                                  cfloat& zs) {
  const bool neg = z.r < 0.0f;
  zs = neg ? z : cfloat{-z.r, -z.i};
  const float wr = neg ? -z.r : z.r;
  const float wi = neg ? -z.i : z.i;
  const float aw2 = wr * wr + wi * wi;
  const cfloat s = cexp_f(-wr, -wi);       // e^{-w}
  if (EMME_BESSEL_BRANCH == 1 ||
      (EMME_BESSEL_BRANCH == 0 && aw2 <= kSplit2)) {
    // Taylor branch, scaled by e^{-w}
    const cfloat q = {0.25f * (wr * wr - wi * wi), 0.5f * wr * wi};
    cfloat t0 = {1.0f, 0.0f};
    cfloat t1 = {1.0f, 0.0f};
#pragma unroll
    for (int k = kTaylorTerms; k >= 1; --k) {
      cfloat p = cmul(t0, q);
      t0 = {1.0f + p.r * tab.c0[k - 1], p.i * tab.c0[k - 1]};
      p = cmul(t1, q);
      t1 = {1.0f + p.r * tab.c1[k - 1], p.i * tab.c1[k - 1]};
    }
    i0 = cmul(t0, s);
    i1 = cmul(cfloat{0.5f * wr, 0.5f * wi}, cmul(t1, s));
  } else {
    // Asymptotic branch (DLMF 10.40.1 + recessive 10.40.5), scaled by e^{-w}
    const cfloat v = cinv({wr, wi});
    cfloat s0m = {0.0f, 0.0f}, s0p = {0.0f, 0.0f};
    cfloat s1m = {0.0f, 0.0f}, s1p = {0.0f, 0.0f};
#pragma unroll
    for (int k = kAsymTerms - 1; k >= 0; --k) {
      s0m = cmul(s0m, v);
      s0m.r += tab.a0m[k];
      s0p = cmul(s0p, v);
      s0p.r += tab.a0p[k];
      s1m = cmul(s1m, v);
      s1m.r += tab.a1m[k];
      s1p = cmul(s1p, v);
      s1p.r += tab.a1p[k];
    }
    const cfloat pf = cinv(csqrt_rhp(kTwoPi * wr, kTwoPi * wi));
    const float sgn = wi >= 0.0f ? 1.0f : -1.0f;
    const cfloat e2 = cmul(s, s);            // e^{-2w}
    // sigma0 = i sgn, sigma1 = -i sgn times the recessive sums
    cfloat r0 = cmul(e2, s0p);
    r0 = {-sgn * r0.i, sgn * r0.r};
    cfloat r1 = cmul(e2, s1p);
    r1 = {sgn * r1.i, -sgn * r1.r};
    i0 = cmul(pf, cfloat{s0m.r + r0.r, s0m.i + r0.i});
    i1 = cmul(pf, cfloat{s1m.r + r1.r, s1m.i + r1.i});
  }
  if (neg) i1 = {-i1.r, -i1.i};
}

// The integrand at node t (Parameters.cpp:120-176); returns the m = 0 value
// and norm_vel for the higher moments.
__device__ __forceinline__ cfloat integrand(float t, const PairConst& pc,
                                            const Scalars& sc,
                                            const Tables& tab, cfloat& nv) {
  // contour rotation: e^{i phi}, phi = -omi atan(t / arc), without atan:
  // cos(atan y) = 1/sqrt(1+y^2), sin(atan y) = y/sqrt(1+y^2)
  const float y = t / sc.arc;
  const float rinv = rsqrtf(1.0f + y * y);
  const float ear = rinv;
  const float eai = -sc.omi * y * rinv;
  const float tautr = t * ear;
  const float tauti = t * eai;
  const float g = sc.omi * t / (sc.arc * (1.0f + y * y));
  const float jacr = ear + eai * g;
  const float jaci = eai - ear * g;

  // lambda = 1 + 0.5 i (taut vt) / (qR d_eta) beta1
  const cfloat lam = {1.0f - pc.c * tauti, pc.c * tautr};

  cfloat i0, i1, zs;
  bessel_i01_scaled(cdiv(cfloat{pc.sbb, 0.0f}, lam), tab, i0, i1, zs);

  const cfloat l3i = cinv(cmul(cmul(lam, lam), lam));   // lambda^-3

  // norm_vel = qR d_eta / (vt taut)
  const cfloat tinv = cinv({tautr, tauti});
  nv = {pc.k_de * tinv.r, pc.k_de * tinv.i};
  const cfloat nv2 = cmul(nv, nv);

  // i0_coef = (om - ws (1 + eta_i (0.5 nv^2 - 1.5))) / lam
  //           + ws eta_i (0.5 (ba + bb) - lam) lam^-3
  const float ar = sc.om_r - sc.ws_i * (1.0f + sc.eta_i * (0.5f * nv2.r - 1.5f));
  const float ai = sc.om_i - sc.ws_i * sc.eta_i * 0.5f * nv2.i;
  const cfloat c0 = cdiv({ar, ai}, lam);
  const cfloat d = cmul({0.5f * (pc.ba + pc.bb) - lam.r, -lam.i}, l3i);
  const float wse = sc.ws_i * sc.eta_i;
  const cfloat i0c = {c0.r + wse * d.r, c0.i + wse * d.i};
  const cfloat i1c = {-wse * pc.sbb * l3i.r, -wse * pc.sbb * l3i.i};

  // log-domain exponent (Parameters.cpp:156-175):
  // -0.5 nv^2 - 0.5 i b1 nv + i taut om - (ba + bb) / (2 + i b1 / nv) - zs
  float er = -0.5f * nv2.r + 0.5f * pc.b1 * nv.i - tauti * sc.om_r - tautr * sc.om_i;
  float ei = -0.5f * nv2.i - 0.5f * pc.b1 * nv.r + tautr * sc.om_r - tauti * sc.om_i;
  const cfloat qd = cdiv({0.0f, pc.b1}, nv);
  const cfloat et = cdiv({-(pc.ba + pc.bb), 0.0f}, {2.0f + qd.r, qd.i});
  er = er + et.r - zs.r;
  ei = ei + et.i - zs.i;

  const bool keep = er >= kSafeExpCutoff;
  const cfloat ex = cexp_f(keep ? er : kSafeExpCutoff, ei);
  const cfloat p0 = cmul(i0c, i0);
  const cfloat p1 = cmul(i1c, i1);
  cfloat core = cmul(ex, cfloat{p0.r + p1.r, p0.i + p1.i});
  if (!keep) core = {0.0f, 0.0f};

  // base = jacob / taut * core
  return cmul(cmul(cfloat{jacr, jaci}, tinv), core);
}

__global__ void __launch_bounds__(kThreads)
kappa_pairs_kernel(const float* __restrict__ mid,
                   const float* __restrict__ halfw,
                   const float4* __restrict__ pair,
                   const float* __restrict__ scal,
                   float* __restrict__ out, int npairs, int n_panels,
                   int order, const Moments ms,
                   const __grid_constant__ Tables tab) {
  __shared__ float s_x[kMaxOrder];
  __shared__ float s_wk[kMaxOrder];
  for (int i = threadIdx.x; i < order; i += blockDim.x) {
    s_x[i] = tab.x[i];
    s_wk[i] = tab.wk[i];
  }
  __syncthreads();

  Scalars sc;
  sc.om_r = scal[0];
  sc.om_i = scal[1];
  sc.arc = scal[2];
  sc.qR = scal[3];
  sc.vt = scal[4];
  sc.ws_i = scal[5];
  sc.eta_i = scal[6];
  // omi = -sign(Re om), with Re om == 0 taken as +1
  const float s = sc.om_r == 0.0f ? 1.0f : sc.om_r;
  sc.omi = -(s > 0.0f ? 1.0f : (s < 0.0f ? -1.0f : s));

  const int lane = threadIdx.x & 31;
  const int n_nodes = n_panels * order;
  const int nout = 2 * ms.n;
  for (int pr = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); pr < npairs;
       pr += gridDim.x * kWarpsPerBlock) {
    const float4 pv = pair[pr];   // [d_eta, beta1, bi(eta), bi(eta')]
    PairConst pc;
    pc.b1 = pv.y;
    pc.ba = pv.z;
    pc.bb = pv.w;
    pc.sbb = sqrtf(pv.z * pv.w);
    pc.c = 0.5f * sc.vt * pv.y / (sc.qR * pv.x);
    pc.k_de = sc.qR * pv.x / sc.vt;
    const float* mrow = mid + static_cast<size_t>(pr) * n_panels;
    const float* hrow = halfw + static_cast<size_t>(pr) * n_panels;

    float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = lane; k < n_nodes; k += 32) {
      const int panel = k / order;
      const int gi = k - panel * order;
      const float hw = hrow[panel];
      const float t = fmaxf(mrow[panel] + hw * s_x[gi], 1e-6f);
      const float w = s_wk[gi] * hw;
      cfloat nv;
      cfloat f = integrand(t, pc, sc, tab, nv);
      int prev = 0;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        if (q < ms.n) {
          for (int r = prev; r < ms.m[q]; ++r) f = cmul(f, nv);
          prev = ms.m[q];
          acc[2 * q] += f.r * w;
          acc[2 * q + 1] += f.i * w;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 6; ++q) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[q] += __shfl_down_sync(0xffffffffu, acc[q], off);
    }
    if (lane == 0) {
      float* orow = out + static_cast<size_t>(pr) * nout;
#pragma unroll
      for (int q = 0; q < 6; ++q)
        if (q < nout) orow[q] = acc[q];
    }
  }
}

#include "guard.h"   // kernels G and R of the quadrature guard, on K1's device
                     // functions

}  // namespace

extern "C" {

// Number of floats the caller's table must hold (layout of Tables).
int kappa_table_len() { return kTableLen; }

// Launch on `stream`.  mid, halfw: (npairs, n_panels) f32; pair: (npairs, 4)
// f32, 16-byte aligned; scal: 8 f32 [om_r, om_i, arc, qR, vt, ws_i, eta_i, 0]
// on the device; out: (npairs, 2 n_ms) f32; tables: kTableLen host floats.
// Returns cudaGetLastError() after the launch (0 on success).
int kappa_pairs_launch(const float* mid, const float* halfw, const float* pair,
                       const float* scal, float* out, int npairs, int n_panels,
                       int order, int n_ms, int m0, int m1, int m2,
                       const float* tables, int table_len, void* stream) {
  if (npairs < 1 || n_panels < 1 || order < 1 || order > kMaxOrder ||
      n_ms < 1 || n_ms > 3 || table_len != kTableLen)
    return static_cast<int>(cudaErrorInvalidValue);
  Tables tab;
  std::memcpy(&tab, tables, sizeof(Tables));
  const Moments ms = {n_ms, {m0, m1, m2}};
  const int blocks = static_cast<int>(
      (static_cast<long long>(npairs) + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const int grid = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  kappa_pairs_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mid, halfw, reinterpret_cast<const float4*>(pair), scal, out, npairs,
      n_panels, order, ms, tab);
  return static_cast<int>(cudaGetLastError());
}

// Kernel P (assembly.h) on `stream`: meta, assembly::kMetaFields int64 a
// tier, in host memory; points (3, n), scalars (assembly::kNumScalars),
// omega (complex64) and buf on the device.  Returns cudaGetLastError()
// after the launch (0 on success).
int assembly_inputs_launch(const long long* meta, int n_tiers, int n,
                           const float* points, const float* scalars,
                           const float* omega, float* buf, void* stream) {
  assembly::Tiers tiers;
  const long long work =
      assembly::read_tiers(meta, nullptr, n_tiers, true, &tiers);
  if (work < 0 || n < 2) return static_cast<int>(cudaErrorInvalidValue);
  assembly::assembly_inputs_kernel<<<assembly::blocks_for(work),
                                     assembly::kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      tiers, n, points, scalars, omega, buf);
  return static_cast<int>(cudaGetLastError());
}

// Kernel Q (assembly.h) on `stream`: meta as for P, outs the tiers' K1
// output addresses (host memory); coeff (n, n) float32 and M (dim, dim)
// complex64, dim = n (em = 0) or 2 n (em = 1), on the device.
int assembly_place_launch(const long long* meta, const long long* outs,
                          int n_tiers, int n, int em, const float* points,
                          const float* scalars, const float* omega,
                          const float* coeff, void* M, void* stream) {
  assembly::Tiers tiers;
  long long work = assembly::read_tiers(meta, outs, n_tiers, false, &tiers);
  if (work < 0 || n < 2 || (em != 0 && em != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  work = work > n ? work : n;
  assembly::assembly_place_kernel<<<assembly::blocks_for(work),
                                    assembly::kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      tiers, n, em, points, scalars, omega, coeff, static_cast<float2*>(M));
  return static_cast<int>(cudaGetLastError());
}

// Kernel G (guard.h) on `stream`: meta as for P, a tier a set, in host
// memory; buf, P's buffer, and out, (the sets' pairs, 3 n_ms) float32, on
// the device; tables: kTableLen floats as K1's, then kMaxOrder Gauss
// weights, in host memory.  Returns cudaGetLastError() after the launch.
int guard_pairs_launch(const long long* meta, int n_sets, const float* buf,
                       float* out, int order, int n_ms, int m0, int m1,
                       int m2, const float* tables, int table_len,
                       void* stream) {
  assembly::Tiers sets;
  if (assembly::read_tiers(meta, nullptr, n_sets, false, &sets) < 0 ||
      order < 1 || order > kMaxOrder || n_ms < 1 || n_ms > 3 ||
      table_len != kTableLen + kMaxOrder)
    return static_cast<int>(cudaErrorInvalidValue);
  long long total = 0;
  for (int t = 0; t < sets.count; ++t) total += sets.t[t].npairs;
  guard::Rule rule;
  std::memcpy(&rule, tables, sizeof(guard::Rule));
  const Moments ms = {n_ms, {m0, m1, m2}};
  guard::guard_pairs_kernel<<<guard::pair_blocks(total), guard::kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      sets, buf, out, total, order, ms, rule);
  return static_cast<int>(cudaGetLastError());
}

// Kernel R (guard.h) on `stream`, one block: out, G's rows; rows,
// (n_sampled, 2) int32; scalars, the plan's (assembly::kNumScalars); report,
// 3 doubles; all on the device.
int guard_report_launch(const float* out, const int* rows, int n_sampled,
                        int n_ms, const float* scalars, double accuracy,
                        double precision, double* report, void* stream) {
  if (n_sampled < 1 || n_ms < 1 || n_ms > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  guard::guard_report_kernel<<<1, guard::kReportThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      out, rows, n_sampled, n_ms, scalars, accuracy, precision, report);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
