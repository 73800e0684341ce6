// Kernels G and R of the quadrature guard on the card, beside K1.
// Included by kappa.cu after K1's device functions, which G calls: one
// library, one build.  Wrapper: emme_tpu_torch/ops/cuda_guard.py.
//
// The guard (solvers/eigen.py::quadrature_guard) checks the static panel
// mesh at the converged omega on a fixed sample of (eta, eta') pairs, each
// pair on the base mesh with its embedded Gauss-Kronrod error and, where
// the tier table gives its |i - j| group a coarser mesh, on that mesh too.
// A set is one such (group, mesh).  On the card a guard is one launch of P
// (assembly.h, unchanged: a set is one of its tiers), one of G, one of R and
// one host read of R's three numbers:
//
// * G, guard_pairs_kernel: for each pair of each set and each moment m in
//   ms, the Kronrod sum over the pair's panels and the summed per-panel
//   |K_panel - G_panel| (quadrature.panel_reduce), without K1's prefactor.
//   The Gauss rule's nodes are a subset of the Kronrod rule's (its weight is
//   zero elsewhere, quadrature.gk_rule), so both sums come from one
//   evaluation of the integrand a node: K1's `integrand`, inlined here as in
//   K1.  One warp a pair, a lane a panel (the error needs each panel's two
//   sums whole), a shuffle reduction over the lanes; lane 0 writes the row
//   [re, im of each moment, error of each moment].
// * R, guard_report_kernel: from G's rows, each sampled pair's |K|,
//   error and tier gap per moment as the plain version forms them in
//   float32 (the prefactor applied, kernels.kappa_f_tau), then the plain
//   version's float64 test (eigen.guard_report): flagged where err or gap >
//   max(accuracy, precision |K|); the count flagged, the largest of
//   max(err, gap) and of max(err, gap) / max(|K|, 1e-300).  One block.
//
// Replaces no TPU kernel: the guard was torch around the integrand, some
// 5,200 launches and a dozen host reads a guard at n = 1024.  What bounds it
// on an H100: launches and the host read.  G's work is a few million nodes
// (4096 pairs x 44 panels x 15 nodes on the base mesh), some 3 % of one
// tok1024 assembly's, so its design is K1's node math with the simplest
// reduction that keeps each panel's sums; a lane a panel leaves lanes idle
// (44 panels on 32 lanes) and nothing here is tuned.  Neither kernel is
// launched by an assembly, and K1's kernel is not touched: G is its own
// __global__.

#pragma once

namespace guard {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kMaxBlocks = 65535;
constexpr int kReportThreads = 256;

// K1's constant tables and the embedded Gauss weights at the same nodes.
struct Rule {
  Tables k;
  float wg[kMaxOrder];
};

// sets: P's tiers, a set each; buf: P's buffer (K1's 8 scalars at its head,
// each set's mid, halfw and pair rows); out: (total, 3 ms.n) float32, the
// sets' rows one after the other.
__global__ void __launch_bounds__(kThreads)
guard_pairs_kernel(const __grid_constant__ assembly::Tiers sets,
                   const float* __restrict__ buf, float* __restrict__ out,
                   long long total, int order, const Moments ms,
                   const __grid_constant__ Rule rule) {
  __shared__ float s_x[kMaxOrder];
  __shared__ float s_wk[kMaxOrder];
  __shared__ float s_wg[kMaxOrder];
  for (int i = threadIdx.x; i < order; i += blockDim.x) {
    s_x[i] = rule.k.x[i];
    s_wk[i] = rule.k.wk[i];
    s_wg[i] = rule.wg[i];
  }
  __syncthreads();

  Scalars sc;
  sc.om_r = buf[0];
  sc.om_i = buf[1];
  sc.arc = buf[2];
  sc.qR = buf[3];
  sc.vt = buf[4];
  sc.ws_i = buf[5];
  sc.eta_i = buf[6];
  const float s = sc.om_r == 0.0f ? 1.0f : sc.om_r;   // as K1
  sc.omi = -(s > 0.0f ? 1.0f : (s < 0.0f ? -1.0f : s));

  const int lane = threadIdx.x & 31;
  const int cols = 3 * ms.n;
  for (long long w = static_cast<long long>(blockIdx.x) * kWarpsPerBlock +
                     (threadIdx.x >> 5);
       w < total; w += static_cast<long long>(gridDim.x) * kWarpsPerBlock) {
    int set = 0;
    long long q = w;
    while (set < sets.count - 1 && q >= sets.t[set].npairs) {
      q -= sets.t[set].npairs;
      ++set;
    }
    const assembly::Tier& T = sets.t[set];
    const int n_panels = T.n_sh + T.n_osc + T.n_tail;
    const float4 pv = reinterpret_cast<const float4*>(buf + T.pair)[q];
    PairConst pc;
    pc.b1 = pv.y;
    pc.ba = pv.z;
    pc.bb = pv.w;
    pc.sbb = sqrtf(pv.z * pv.w);
    pc.c = 0.5f * sc.vt * pv.y / (sc.qR * pv.x);
    pc.k_de = sc.qR * pv.x / sc.vt;
    const float* mrow = buf + T.mid + q * n_panels;
    const float* hrow = buf + T.halfw + q * n_panels;

    float acc[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int pn = lane; pn < n_panels; pn += 32) {
      const float hw = hrow[pn];
      const float md = mrow[pn];
      float pk[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float pg[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int gi = 0; gi < order; ++gi) {
        const float t = fmaxf(md + hw * s_x[gi], 1e-6f);
        const float wk = s_wk[gi] * hw;
        const float wg = s_wg[gi] * hw;
        cfloat nv;
        cfloat f = integrand(t, pc, sc, rule.k, nv);
        int prev = 0;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          if (k < ms.n) {
            for (int r = prev; r < ms.m[k]; ++r) f = cmul(f, nv);
            prev = ms.m[k];
            pk[2 * k] += f.r * wk;
            pk[2 * k + 1] += f.i * wk;
            pg[2 * k] += f.r * wg;
            pg[2 * k + 1] += f.i * wg;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        acc[2 * k] += pk[2 * k];
        acc[2 * k + 1] += pk[2 * k + 1];
        acc[6 + k] += hypotf(pk[2 * k] - pg[2 * k],
                             pk[2 * k + 1] - pg[2 * k + 1]);
      }
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
    }
    if (lane == 0) {
      float* row = out + w * cols;
      for (int k = 0; k < ms.n; ++k) {
        row[2 * k] = acc[2 * k];
        row[2 * k + 1] = acc[2 * k + 1];
        row[2 * ms.n + k] = acc[6 + k];
      }
    }
  }
}

// out: G's rows; rows: (n_sampled, 2) int32, each sampled pair's base-mesh
// row in out and its tier-mesh row (-1: its group has none); sc: the plan's
// scalars (the prefactor); report: 3 doubles [flagged, max_abs_err,
// max_rel_err].
__global__ void __launch_bounds__(kReportThreads)
guard_report_kernel(const float* __restrict__ out,
                    const int* __restrict__ rows, int n_sampled, int n_ms,
                    const float* __restrict__ sc, double accuracy,
                    double precision, double* __restrict__ report) {
  __shared__ double s_abs[kReportThreads];
  __shared__ double s_rel[kReportThreads];
  __shared__ int s_flagged[kReportThreads];
  const float2 pref = make_float2(sc[assembly::kPrefR], sc[assembly::kPrefI]);
  const float apref = hypotf(pref.x, pref.y);
  const int cols = 3 * n_ms;
  double max_abs = 0.0;
  double max_rel = 0.0;
  int flagged = 0;
  for (int s = threadIdx.x; s < n_sampled; s += kReportThreads) {
    const float* base = out + static_cast<long long>(rows[2 * s]) * cols;
    const int tier = rows[2 * s + 1];
    const float* coarse =
        tier >= 0 ? out + static_cast<long long>(tier) * cols : nullptr;
    bool flag = false;
    for (int k = 0; k < n_ms; ++k) {
      const float2 v =
          assembly::cmul(pref, make_float2(base[2 * k], base[2 * k + 1]));
      const double absk = hypotf(v.x, v.y);
      double err = __fmul_rn(apref, base[2 * n_ms + k]);
      const double thresh = fmax(accuracy, precision * absk);
      flag |= err > thresh;
      if (coarse) {
        const float2 c = assembly::cmul(
            pref, make_float2(coarse[2 * k], coarse[2 * k + 1]));
        const double gap = hypotf(__fsub_rn(c.x, v.x), __fsub_rn(c.y, v.y));
        flag |= gap > thresh;
        err = fmax(err, gap);
      }
      max_abs = fmax(max_abs, err);
      max_rel = fmax(max_rel, err / fmax(absk, 1e-300));
    }
    flagged += flag ? 1 : 0;
  }
  const int tid = static_cast<int>(threadIdx.x);
  s_abs[tid] = max_abs;
  s_rel[tid] = max_rel;
  s_flagged[tid] = flagged;
  __syncthreads();
  for (int half = kReportThreads / 2; half > 0; half >>= 1) {
    if (tid < half) {
      s_abs[tid] = fmax(s_abs[tid], s_abs[tid + half]);
      s_rel[tid] = fmax(s_rel[tid], s_rel[tid + half]);
      s_flagged[tid] += s_flagged[tid + half];
    }
    __syncthreads();
  }
  if (tid == 0) {
    report[0] = static_cast<double>(s_flagged[0]);
    report[1] = s_abs[0];
    report[2] = s_rel[0];
  }
}

inline int pair_blocks(long long total) {
  const long long b = (total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return static_cast<int>(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

}  // namespace guard
