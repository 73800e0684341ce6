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
// round where the plain version does not.  The few fma() calls written out
// in adaptive_bessel.h round exactly as the operations they replace (each
// says why); --fmad=false leaves explicit fma() alone.  The prefactor
// -i qR / (vt sqrt(2 pi)) and the placement in the matrix are the caller's.
//
// What bounds it (a plain or fill launch): float64 instructions.  A pair
// reads 36 bytes and writes 28;
// a node costs some 180-230 float64 operations besides its Bessel recurrence
// over 24 to ~100 steps, with IEEE divisions and libm calls (tan, cos, atan,
// sincos, exp, hypot) among them; at tok1024 the recurrence is ~80 % of the
// counted work.  No tensor core is used.
//
// Design.  The Miller step is the hot loop: its 2k / w quotient divides by a
// loop-invariant denominator, so the step takes a reciprocal computed once a
// node and two fma corrections instead of two IEEE divisions (each a
// reciprocal seed, its refinement and the same correction; bit-equal, see
// quot in adaptive_bessel.h), sums with one fma, and calls hypot only past
// a cheap filter.  A warp holds S integrals, its slots: S = 2 under G7K15
// (lanes 0-15 and 16-31, node lane % 16, lane 15 of each half idle), S = 1
// under G15K31 (lanes 0-30).
// Each lane of a slot evaluates one node of the panel on top of the slot's
// interval stack; the node values go to the slot's buffer in shared memory
// and every lane of the slot forms the Kronrod and Gauss sums in the engine's
// order from it, so the accept decision is uniform across the slot without a
// shuffle.  The stack (at most max_subdivide + 1 intervals) lives in shared
// memory, written by the slot's leader lane.  The panel loop is
// warp-uniform: it runs while a slot of the warp holds an integral, and the
// lanes of a slot without work skip the node.  When a slot's stack empties
// its Miller steps are summed with a fixed-order shuffle, its leader writes
// the integral's value, panel count and steps, and takes the next integral
// from a global counter (zeroed by the wrapper).  The grid is persistent:
// the co-resident number of blocks, so no SM waits on a block's slowest
// integral.  The kernel allocates nothing and does not synchronise.
//
// The memo.  A solve assembles the same integrals at 2 + steps values of
// omega, and a node's omega-free half (adaptive_node.h: the Miller
// recurrence and all but about a tenth of the rest) is the same at each
// of them while sign(Re omega) is.  A fill launch (kFill) writes the free
// half of every node of each panel an integral visits to the integral's
// place in a device memo, a record a panel with its interval as the key,
// in the depth-first order, until the place is full.  A read launch
// (kRead) walks the integral's records in that order beside its own pops:
// a popped interval equal to the next record's key takes the record and
// runs only omega_half; any other is evaluated in full.  A record holds
// what free_half computed for that interval and pair, so a hit gives the
// node's value bit for bit and so the tree its splits; a tree that moved
// only misses.  A record is a node's 21 fields, each at the stride of a
// slot's lanes (16 under G7K15, 32 under G15K31), so a slot reads and
// writes a field in adjacent words.  A read is bound by those bytes.  The
// wrapper (ops/cuda_adaptive.py) sizes the places, chooses the mode, and
// holds sign(Re omega) and the other scalars to the fill's.

#include <cuda_runtime.h>

#include <cstdint>

#include "adaptive_node.h"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxPops = 100000;
// the stacks of a block, (max_subdivide + 2) intervals and a node buffer a
// slot, stay under 92 KB (opted in past the default 48 KB)
constexpr int kMaxSubdivide = 700;
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

// A launch's memo (adaptive_node.h's records; see the notes at the top):
// unused by a plain launch.
enum Mode { kPlain = 0, kFill = 1, kRead = 2 };

struct Memo {
  double* rec;              // (places, kHalfFields, W) float64: the records
  double2* keys;            // (places,): a record's interval [lo, hi]
  const long long* cum;     // (n,): the inclusive sum of the places
  int* nrec;                // (n,): the records the fill wrote
  long long n;              // integrals memoised, a prefix of the launch's
  unsigned long long* stats;   // [nodes memoised, nodes in full]
};

// One warp, S slots: S integrals of (rows, moments) at a time, each through
// the engine's integrate_adaptive (emme_native.cpp:319-350) with its own
// stack, sums and counts, taken from `next` as the slots free up.  kFill
// also writes each visited panel's free halves to the integral's place
// while it has room; kRead serves a popped panel that matches the
// integral's next record from the record (the omega half alone) and
// evaluates any other in full.
template <bool kK31, int kMode>
__global__ void __launch_bounds__(kThreads)
    adaptive_kernel(const double* __restrict__ rows,
                    const int* __restrict__ moments, long long n, Scal sc,
                    double* __restrict__ out, int* __restrict__ panels,
                    long long* __restrict__ miller,
                    unsigned long long* __restrict__ next, Memo mm) {
  constexpr int S = kK31 ? 1 : 2;        // slots a warp
  constexpr int W = 32 / S;              // lanes a slot
  constexpr int nh = kK31 ? 16 : 8;
  constexpr int nn = 2 * nh - 1;         // nodes a panel
  constexpr int gauss = kK31 ? 15 : 7;
  constexpr long long kRec = static_cast<long long>(kHalfFields) * W;
  extern __shared__ double2 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int node = lane % W;
  const int slot = lane / W;
  const bool leader = node == 0;
  const int cap = sc.max_sub + 2;
  double2* stack = smem + (warp * S + slot) * (cap + W);
  double2* fbuf = stack + cap;
  const double* X = kK31 ? kX31 : kX15;
  const double* WK = kK31 ? kWK31 : kWK15;
  const double* WG = kK31 ? kWG31 : kWG15;
  // node 0: the centre; node 2i - 1: mid + half X[i]; node 2i: mid - half X[i]
  const double xn = (node > 0 && node < nn) ? X[(node + 1) >> 1] : 0.0;
  const bool plus = node & 1;
  const unsigned long long slots =
      static_cast<unsigned long long>(gridDim.x) * kWarps * S;

  // the slot's integral and its state (the same in every lane of the slot)
  long long k =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * S + slot;
  Pair pr;
  int m = 0, sp = 0, guard = 0, pops = 0;
  long long steps = 0;
  double sum_r = 0.0, sum_i = 0.0, abs_tol = 0.0;
  // the memo: the integral's place, its records (kRead) or room (kFill),
  // the next record and its key, the slot's panels memoised and in full
  long long base = 0;
  int len = 0, cur = 0;
  double2 key = make_double2(0.0, 0.0);
  long long memo_panels = 0, full_panels = 0;
  auto start = [&]() {
    const double* row = rows + 4 * k;
    pr.d_eta = row[0];
    pr.beta1 = row[1];
    pr.bie = row[2];
    pr.bip = row[3];
    pr.sqrt_bb = sqrt(pr.bie * pr.bip);
    m = moments[k];
    if (leader) stack[0] = make_double2(0.0, kHalfPi);
    sp = 1;
    guard = pops = 0;
    steps = 0;
    sum_r = sum_i = abs_tol = 0.0;
    if constexpr (kMode != kPlain) {
      const bool in = k < mm.n;
      base = in && k > 0 ? mm.cum[k - 1] : 0;
      len = !in ? 0
                : (kMode == kFill ? static_cast<int>(mm.cum[k] - base)
                                  : mm.nrec[k]);
      cur = 0;
      if (kMode == kRead && len > 0) key = mm.keys[base];
    }
  };
  bool live = k < n;
  if (live) start();
  __syncwarp();

  for (;;) {
    // the engine's `while (!stack.empty() && ++guard < 100000)`
    const bool work = live && sp > 0 && guard < kMaxPops - 1;
    const bool done = live && !work;
    if (__any_sync(kFull, done)) {
      long long tot = steps;
      for (int off = W / 2; off > 0; off >>= 1)
        tot += __shfl_down_sync(kFull, tot, off, W);
      long long nk = 0;
      if (done && leader) {
        out[2 * k] = sum_r;
        out[2 * k + 1] = sum_i;
        panels[k] = pops;
        miller[k] = tot;
        if (kMode == kFill && k < mm.n) mm.nrec[k] = cur;
        nk = static_cast<long long>(slots + atomicAdd(next, 1ull));
      }
      nk = __shfl_sync(kFull, nk, 0, W);
      if (done) {
        k = nk;
        live = k < n;
        if (live) start();
      }
      __syncwarp();
      continue;
    }
    if (!__any_sync(kFull, live)) break;

    double2 iv = make_double2(0.0, 0.0);
    double mid = 0.0, half = 0.0;
    if (work) {
      ++guard;
      iv = stack[--sp];
      mid = 0.5 * (iv.x + iv.y);
      half = 0.5 * (iv.y - iv.x);
      bool hit = false;
      if constexpr (kMode == kRead) {
        // the records are in the depth-first order: skip those the tree no
        // longer visits
        while (cur < len && key_before(key.x, key.y, iv.x, iv.y))
          if (++cur < len) key = mm.keys[base + cur];
        hit = cur < len && key.x == iv.x && key.y == iv.y;
      }
      // this lane's node in the record at the cursor
      auto rec = [&]() { return mm.rec + (base + cur) * kRec + node; };
      C f;
      if (hit) {
        if (node < nn) f = omega_half(load_half(rec(), W), sc);
        if (++cur < len) key = mm.keys[base + cur];
        ++memo_panels;
      } else {
        const bool keep = kMode == kFill && cur < len;
        if (node < nn) {
          const double x =
              node == 0 ? mid : (plus ? mid + half * xn : mid - half * xn);
          int st;
          const Half h = free_half(x, pr, m, sc, st);
          steps += st;
          if (keep) store_half(rec(), W, h);
          f = omega_half(h, sc);
        }
        if (keep) {
          if (leader) mm.keys[base + cur] = iv;
          ++cur;
          ++memo_panels;
        } else {
          ++full_panels;
        }
      }
      if (node < nn) fbuf[node] = make_double2(f.r, f.i);
    }
    __syncwarp();
    double gkr = 0.0, gki = 0.0, gr = 0.0, gi = 0.0;
    if (work) {
      const double2 f0 = fbuf[0];
      gkr = 0.0 + WK[0] * f0.x;
      gki = 0.0 + WK[0] * f0.y;
      gr = 0.0 + WG[0] * f0.x;
      gi = 0.0 + WG[0] * f0.y;
#pragma unroll
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
    }
    __syncwarp();   // every lane has read the buffer and the popped slot
    if (work) {
      const double ir = gkr * half, ii = gki * half;
      const double err = hypot(gkr - gr, gki - gi) * half;
      const double cur_tol = hypot(sc.rel_tol * ir, sc.rel_tol * ii);
      if (abs_tol == 0.0) abs_tol = cur_tol;
      const bool can_split = ldexp(half, sc.max_sub) > 0.99 * kHalfPi;
      if (can_split && err > abs_tol * kInvScale + sc.pg &&
          err > cur_tol + sc.pg) {
        if (leader) {
          stack[sp] = make_double2(mid, iv.y);
          stack[sp + 1] = make_double2(iv.x, mid);
        }
        sp += 2;
      } else {
        sum_r = sum_r + ir;
        sum_i = sum_i + ii;
      }
      ++pops;
    }
    __syncwarp();
  }
  if constexpr (kMode != kPlain) {
    if (leader && memo_panels + full_panels > 0) {
      atomicAdd(mm.stats, static_cast<unsigned long long>(memo_panels * nn));
      atomicAdd(mm.stats + 1,
                static_cast<unsigned long long>(full_panels * nn));
    }
  }
}

// What a launch of one instance at one shared-memory size needs, found
// once per device: blocks a multiprocessor holds, multiprocessors,
// registers and local bytes a thread.
struct Shape {
  int dev = -1, smem = -1, per_sm = 0, sms = 0, regs = 0, local = 0;
};

template <bool kK31, int kMode>
cudaError_t shape_of(int smem, Shape& sh) {
  static Shape cached;   // one per instance
  auto kernel = adaptive_kernel<kK31, kMode>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (cached.dev == dev && cached.smem == smem) {
    sh = cached;
    return cudaSuccess;
  }
  Shape s;
  s.dev = dev;
  s.smem = smem;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.per_sm, kernel,
                                                        kThreads, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  s.regs = attr.numRegs;
  s.local = static_cast<int>(attr.localSizeBytes);
  cached = sh = s;
  return cudaSuccess;
}

// Launch at the co-resident grid; info: [slots a warp, blocks, registers a
// thread, local bytes a thread].
template <bool kK31, int kMode>
int launch(const double* rows, const int* moments, long long n,
           const Scal& sc, double* out, int* panels, long long* miller,
           unsigned long long* next, const Memo& mm, cudaStream_t stream,
           int* info) {
  constexpr int S = kK31 ? 1 : 2;
  constexpr int W = 32 / S;
  const int smem = kWarps * S * (sc.max_sub + 2 + W) *
                   static_cast<int>(sizeof(double2));
  Shape sh;
  const cudaError_t err = shape_of<kK31, kMode>(smem, sh);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sh.per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long per_block = static_cast<long long>(kWarps) * S;
  const long long need = (n + per_block - 1) / per_block;
  const long long resident = static_cast<long long>(sh.per_sm) * sh.sms;
  const int grid = static_cast<int>(need < resident ? need : resident);
  info[0] = S;
  info[1] = grid;
  info[2] = sh.regs;
  info[3] = sh.local;
  adaptive_kernel<kK31, kMode><<<grid, kThreads, smem, stream>>>(
      rows, moments, n, sc, out, panels, miller, next, mm);
  return static_cast<int>(cudaGetLastError());
}

template <bool kK31>
int launch_mode(int mode, const double* rows, const int* moments,
                long long n, const Scal& sc, double* out, int* panels,
                long long* miller, unsigned long long* next, const Memo& mm,
                cudaStream_t stream, int* info) {
  if (mode == kFill)
    return launch<kK31, kFill>(rows, moments, n, sc, out, panels, miller,
                               next, mm, stream, info);
  if (mode == kRead)
    return launch<kK31, kRead>(rows, moments, n, sc, out, panels, miller,
                               next, mm, stream, info);
  return launch<kK31, kPlain>(rows, moments, n, sc, out, panels, miller, next,
                              mm, stream, info);
}

}  // namespace

extern "C" {

// The largest max_subdivide the kernel's shared-memory stacks take.
int adaptive_max_subdivide() { return kMaxSubdivide; }

// float64 a record: a node's fields at the stride of a slot's lanes.
int adaptive_record_doubles(int order) {
  return kHalfFields * (order == 31 ? 32 : 16);
}

// Launch on `stream`.  rows: (n, 4) float64 [d_eta, beta1, b_i(eta),
// b_i(eta')]; moments: (n,) int32; scal: 9 host doubles [om_r, om_i, arc,
// qR, vt, omega_s_i, eta_i, rel_tol, precision_goal]; out: (n, 2) float64;
// panels: (n,) int32; miller: (n,) int64; next: one zeroed uint64 on the
// device (the slots' work counter); info: 4 host ints, the launch's shape
// (see launch).  mode 0: plain, the memo's pointers unused; 1: fill; 2:
// read.  A memo launch's memo: rec, (places, adaptive_record_doubles)
// float64; keys, (places, 2) float64; cum, (n_memo,) int64 inclusive sum of
// the places; nrec, (n_memo,) int32; stats, two zeroed uint64 that the
// launch adds its [nodes memoised, nodes in full] to (memoised: written by
// a fill, read by a read).  Returns cudaGetLastError() after the launch (0
// on success).
int adaptive_launch(const double* rows, const int* moments, long long n,
                    const double* scal, int order, int max_sub, double* out,
                    int* panels, long long* miller, void* next, void* stream,
                    int* info, int mode, double* rec, double* keys,
                    const long long* cum, int* nrec, long long n_memo,
                    void* stats) {
  if (n < 1 || (order != 15 && order != 31) || max_sub < 0 ||
      max_sub > kMaxSubdivide || mode < kPlain || mode > kRead ||
      (mode != kPlain && (rec == nullptr || keys == nullptr ||
                          cum == nullptr || nrec == nullptr ||
                          stats == nullptr || n_memo < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Scal sc = {scal[0], scal[1], scal[2], scal[3], scal[4], scal[5],
                   scal[6], scal[7], scal[8], order, max_sub};
  const Memo mm = {rec, reinterpret_cast<double2*>(keys), cum, nrec,
                   mode == kPlain ? 0 : n_memo,
                   static_cast<unsigned long long*>(stats)};
  auto* counter = static_cast<unsigned long long*>(next);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return order == 31
             ? launch_mode<true>(mode, rows, moments, n, sc, out, panels,
                                 miller, counter, mm, st, info)
             : launch_mode<false>(mode, rows, moments, n, sc, out, panels,
                                  miller, counter, mm, st, info);
}

}  // extern "C"
