// Kernels P and Q of the dense float32 assembly on the card, around K1.
// Included by kappa.cu: one library, one build.  Wrapper:
// emme_tpu_torch/ops/cuda_assembly.py.
//
// An assembly of M(omega) is one launch of P, one K1 launch a tier (each
// through cuda_kappa._launch, unchanged), and one launch of Q:
//
// * P, assembly_inputs_kernel: every tier's K1 inputs -- the panel mids and
//   half-widths (npairs, n_panels), the pair rows [d_eta, beta1, bi(eta),
//   bi(eta')] (npairs, 4) and the 8 scalars [om_r, om_i, arc, qR, vt,
//   omega_s_i, eta_i, 0] -- into one buffer, from the plan's point rows
//   (eta, g(eta), bi(eta) at the grid's points), its packed scalars and
//   omega, read on the device.  One thread a (pair, panel); the panel-0
//   thread of a pair writes its row.
// * Q, assembly_place_kernel: M from the tiers' K1 outputs (npairs, 2
//   len(ms)): the prefactor -i qR / (vt sqrt(2 pi)), -k0 coeff[i, j] dx into
//   both triangles and 1 + 1/tau on the diagonal; for an electromagnetic
//   operator the electron moments m = 1, 2 (closed form) and the A / U
//   (antisymmetric) / D blocks of the 2N x 2N operator, D's diagonal
//   2 tau / beta_e bi(eta).  One thread a pair, and one a diagonal entry.
//
// Rounding: each step is the torch operation it replaces
// (cuda_kappa._prepare, kernels.transit_panel_bounds,
// quadrature.geometric_bounds / linear_bounds, cuda_kappa._finish,
// kernels.kappa_f_tau_e, eigen._materialize_from_pairs) in torch's order,
// rounded on its own by an _rn intrinsic, so nvcc contracts none into an
// fma.  Where torch divides by a Python number it multiplies by the number's
// float32 reciprocal, and 45 / x is reciprocal(x) * 45 (Tensor.__rtruediv__);
// both are kept.  logf and expf are the libdevice functions torch's own
// kernels call.  So P's outputs equal _prepare's on the card, and Q's M
// equals _materialize_from_pairs's on the same K1 outputs up to the
// rounding of omega (omega - omega_s_e), a complex product that torch's
// kernel may contract into fmas.
//
// Neither is tuned: on an H100 P takes about 0.13 ms a tok1024 assembly (its
// logf / expf, its 64-bit index division) against K1's 3.3 ms; they exist
// to replace ~1,000 host launches an assembly.

#pragma once

#include <cuda_runtime.h>

namespace assembly {

constexpr int kMaxTiers = 8;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 65535;
constexpr int kMetaFields = 9;   // a tier's int64 fields in the meta

// The plan's packed float32 scalars, in the order of
// ops/cuda_assembly.py::SCALARS.
enum Scalar {
  kArc, kQR, kVt, kOmegaSI, kEtaI, kArc4, kBeta1, kPrefR, kPrefI, kDiagA,
  kDx, kE1R, kE1I, kOmegaSE, kC2, kBeta1E, kOmegaSE2, kDiagD, kNumScalars
};

struct Tier {
  const long long* iu;        // (npairs,) the pairs' rows i and columns j
  const long long* ju;
  const float* out;           // Q: K1's (npairs, 2 len(ms)) output rows
  long long npairs;
  long long mid, halfw, pair; // P: float offsets of the tier's inputs
  int n_sh, n_osc, n_tail;    // the tier's panel counts
};

struct Tiers {
  Tier t[kMaxTiers];
  int count;
};

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);          // torch.clamp_min
}

__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));   // torch.maximum
}

// k / n as torch forms arange(n + 1) / n on the card: k times the float32
// reciprocal of n
__device__ __forceinline__ float unit_fraction(int k, int n) {
  return __fmul_rn(static_cast<float>(k),
                   __fdiv_rn(1.0f, static_cast<float>(n)));
}

__device__ __forceinline__ float geometric(float lo, float hi, int n, int k) {
  const float llo = logf(lo);
  const float lhi = logf(hi);
  return expf(__fadd_rn(llo, __fmul_rn(__fsub_rn(lhi, llo),
                                       unit_fraction(k, n))));
}

__device__ __forceinline__ float linear(float lo, float hi, int n, int k) {
  return __fadd_rn(lo, __fmul_rn(__fsub_rn(hi, lo), unit_fraction(k, n)));
}

// The cut-off time of the oscillatory section, from omega alone.
__device__ __forceinline__ float cut_time(float om_r, float om_i, float arc4) {
  const float rate_far = clamp_min(maximum(fabsf(om_r), om_i), 0.02f);
  const float rate_near = clamp_min(om_i, 0.0f);
  return rate_near > 0.05f
             ? __fmul_rn(__fdiv_rn(1.0f, rate_near), 45.0f)
             : __fadd_rn(__fmul_rn(__fdiv_rn(1.0f, rate_far), 45.0f), arc4);
}

// The section ends of a pair's panel mesh (kernels.transit_panel_bounds).
struct Sections {
  float t_a, t_b, t_c, t_d;
};

__device__ __forceinline__ Sections sections(float d_abs, float t_cut,
                                             float qR, float vt) {
  const float a = __fdiv_rn(__fmul_rn(qR, d_abs), vt);
  Sections s;
  s.t_a = __fadd_rn(__fmul_rn(a, __fdiv_rn(1.0f, 12.0f)), 1e-8f);
  s.t_b = clamp_min(__fmul_rn(a, 3.0f), 1.0f);
  s.t_c = clamp_min(maximum(t_cut, __fmul_rn(s.t_b, 4.0f)), 50.0f);
  s.t_d = __fmul_rn(s.t_c, 50.0f);
  return s;
}

// Boundary k of the mesh: the shoulder's geometric ends, the oscillatory
// section's linear ones after the first, then the tail's after its first.
__device__ __forceinline__ float bound(const Sections& s, const Tier& T,
                                       int k) {
  if (k <= T.n_sh) return geometric(s.t_a, s.t_b, T.n_sh, k);
  if (k <= T.n_sh + T.n_osc) return linear(s.t_b, s.t_c, T.n_osc, k - T.n_sh);
  return geometric(s.t_c, s.t_d, T.n_tail, k - T.n_sh - T.n_osc);
}

// points: (3, n) eta, g(eta), bi(eta); sc: kNumScalars; omega: complex64.
__global__ void __launch_bounds__(kThreads)
assembly_inputs_kernel(Tiers tiers, int n, const float* __restrict__ points,
                       const float* __restrict__ sc,
                       const float* __restrict__ omega,
                       float* __restrict__ buf) {
  const float om_r = omega[0];
  const float om_i = omega[1];
  const long long start = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  if (start == 0) {
    buf[0] = om_r;
    buf[1] = om_i;
    buf[2] = sc[kArc];
    buf[3] = sc[kQR];
    buf[4] = sc[kVt];
    buf[5] = sc[kOmegaSI];
    buf[6] = sc[kEtaI];
    buf[7] = 0.0f;
  }
  const float t_cut = cut_time(om_r, om_i, sc[kArc4]);
  const float qR = sc[kQR];
  const float vt = sc[kVt];
  const float c_b1 = sc[kBeta1];
  const float* eta = points;
  const float* g = points + n;
  const float* bi = points + 2 * n;
#pragma unroll
  for (int t = 0; t < kMaxTiers; ++t) {
    if (t >= tiers.count) break;
    const Tier& T = tiers.t[t];
    const int n_panels = T.n_sh + T.n_osc + T.n_tail;
    const long long total = T.npairs * n_panels;
    for (long long e = start; e < total; e += stride) {
      const long long q = e / n_panels;
      const int k = static_cast<int>(e - q * n_panels);
      const long long i = T.iu[q];
      const long long j = T.ju[q];
      const float d = __fsub_rn(eta[i], eta[j]);
      const Sections s = sections(fabsf(d), t_cut, qR, vt);
      const float lo = bound(s, T, k);
      const float hi = bound(s, T, k + 1);
      buf[T.mid + e] = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
      buf[T.halfw + e] = __fmul_rn(__fsub_rn(hi, lo), 0.5f);
      if (k == 0)
        reinterpret_cast<float4*>(buf + T.pair)[q] = make_float4(
            d, __fmul_rn(c_b1, __fsub_rn(g[i], g[j])), bi[i], bi[j]);
    }
  }
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                     __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

__device__ __forceinline__ float2 scale(float2 a, float r) {
  return make_float2(__fmul_rn(a.x, r), __fmul_rn(a.y, r));
}

// M: (dim, dim) complex64, dim = n (em = 0) or 2 n (em = 1); coeff: (n, n).
__global__ void __launch_bounds__(kThreads)
assembly_place_kernel(Tiers tiers, int n, int em,
                      const float* __restrict__ points,
                      const float* __restrict__ sc,
                      const float* __restrict__ omega,
                      const float* __restrict__ coeff,
                      float2* __restrict__ M) {
  const long long dim = em ? 2LL * n : n;
  const long long start = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const float* eta = points;
  const float* g = points + n;
  const float* bi = points + 2 * n;
  const float2 zero = make_float2(0.0f, 0.0f);
  for (long long i = start; i < n; i += stride) {
    M[i * dim + i] = make_float2(sc[kDiagA], 0.0f);
    if (em) {
      M[i * dim + n + i] = zero;
      M[(n + i) * dim + i] = zero;
      M[(n + i) * dim + n + i] =
          make_float2(__fmul_rn(sc[kDiagD], bi[i]), 0.0f);
    }
  }
  const float2 pref = make_float2(sc[kPrefR], sc[kPrefI]);
  const float dx = sc[kDx];
  const int cols = em ? 6 : 2;
  // omega's scalars of the electron moments (kernels.kappa_f_tau_e)
  const float2 om = make_float2(omega[0], omega[1]);
  const float2 w1 = make_float2(__fsub_rn(om.x, sc[kOmegaSE]), om.y);
  const float2 c1 = cmul(make_float2(sc[kE1R], sc[kE1I]), w1);
  const float2 ww = cmul(om, w1);
  const float2 w2 = make_float2(__fsub_rn(om.x, sc[kOmegaSE2]), om.y);
#pragma unroll
  for (int t = 0; t < kMaxTiers; ++t) {
    if (t >= tiers.count) break;
    const Tier& T = tiers.t[t];
    for (long long q = start; q < T.npairs; q += stride) {
      const long long i = T.iu[q];
      const long long j = T.ju[q];
      const float* o = T.out + q * cols;
      const float2 k0 = cmul(pref, make_float2(o[0], o[1]));
      const float c = coeff[i * n + j];
      const float2 a = make_float2(__fmul_rn(__fmul_rn(-k0.x, c), dx),
                                   __fmul_rn(__fmul_rn(-k0.y, c), dx));
      M[i * dim + j] = a;
      M[j * dim + i] = a;
      if (!em) continue;
      const float d = __fsub_rn(eta[i], eta[j]);
      const float sgn = __fdiv_rn(d, fabsf(d));
      const float2 k1 = cadd(cmul(pref, make_float2(o[2], o[3])),
                             scale(c1, sgn));
      const float2 u = scale(k1, dx);
      const float2 mu = make_float2(-u.x, -u.y);
      M[i * dim + n + j] = u;         // U[i, j]
      M[j * dim + n + i] = mu;        // U[j, i] = -U[i, j]
      M[(n + j) * dim + i] = u;       // U^T
      M[(n + i) * dim + j] = mu;
      const float y = __fdiv_rn(
          __fmul_rn(__fmul_rn(sc[kBeta1E], __fsub_rn(g[i], g[j])), sc[kVt]),
          sc[kQR]);
      const float2 inner = make_float2(
          __fsub_rn(__fmul_rn(ww.x, d), __fmul_rn(y, w2.x)),
          __fsub_rn(__fmul_rn(ww.y, d), __fmul_rn(y, w2.y)));
      const float2 k2 = cadd(cmul(pref, make_float2(o[4], o[5])),
                             scale(inner, __fmul_rn(sc[kC2], sgn)));
      const float2 dd = scale(k2, dx);
      M[(n + i) * dim + n + j] = dd;
      M[(n + j) * dim + n + i] = dd;
    }
  }
}

// The tiers of a launch from the caller's meta (kMetaFields int64 a tier:
// iu, ju, npairs, n_shoulder, n_osc, n_tail, mid, halfw, pair) and, for Q,
// the K1 outputs' addresses; returns the most work items of one tier, or
// -1 for a malformed meta.
inline long long read_tiers(const long long* meta, const long long* outs,
                            int count, bool panels, Tiers* tiers) {
  if (count < 1 || count > kMaxTiers) return -1;
  long long most = 0;
  tiers->count = count;
  for (int t = 0; t < count; ++t) {
    const long long* m = meta + kMetaFields * t;
    Tier& T = tiers->t[t];
    T.iu = reinterpret_cast<const long long*>(m[0]);
    T.ju = reinterpret_cast<const long long*>(m[1]);
    T.out = outs ? reinterpret_cast<const float*>(outs[t]) : nullptr;
    T.npairs = m[2];
    T.n_sh = static_cast<int>(m[3]);
    T.n_osc = static_cast<int>(m[4]);
    T.n_tail = static_cast<int>(m[5]);
    T.mid = m[6];
    T.halfw = m[7];
    T.pair = m[8];
    if (T.npairs < 1 || T.n_sh < 1 || T.n_osc < 1 || T.n_tail < 1 ||
        T.pair % 4)
      return -1;
    const long long work =
        panels ? T.npairs * (T.n_sh + T.n_osc + T.n_tail) : T.npairs;
    most = work > most ? work : most;
  }
  return most;
}

inline int blocks_for(long long work) {
  const long long b = (work + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

}  // namespace assembly
