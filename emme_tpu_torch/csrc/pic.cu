// delta-f PIC marker pass, CUDA C++ for Hopper (sm_90a): kernels K2, K3, K4.
//
// Replaces the TPU kernels of emme_tpu/solvers/pallas_pic.py:
//   K2  _stage_kernel (body `kernel`, line 160; pallas_call at 319): one RK3
//       stage over all markers -> pic_stage_kernel + pic_field_kernel.
//   K3  _mega_kernel (line 438; pallas_call at 682): the whole run,
//       n_steps x 3 stages, in one launch -> pic_mega_kernel, a persistent
//       cooperative kernel with grid-wide barriers.
//   K4  alias_carry_probe (line 621; pallas_call at 634): the check that one
//       grid step's writes reach a later step's reads -> grid_sync_probe_kernel,
//       which checks that grid.sync() makes every block's writes visible to
//       every other block, the property K3 is built on.
//
// One stage for one marker (stage_marker, shared by K2 and K3 so the two
// cannot drift apart) is the Pallas body's arithmetic, term for term
// (pallas_pic.py:178-279): locate the cell at eta, CIC-gather phi and its
// centered difference from the field held in shared memory (an indexed load,
// where the TPU needed a one-hot matrix product), the J0/J1 gyroaverage
// (the JAX package's 30-term Taylor / A&S asymptotic forms in float32) and the
// drift physics, the weight velocity (drift-center or plain; FIRST gives
// j0 = dc = 0, the reference's zero-initialised first stage), the RK combine,
// the periodic eta advance, and the CIC deposit of j0 * w at the new eta into a
// per-block shared-memory histogram.  The eta advance is written with
// __fadd_rn / __fmul_rn / __fdiv_rn so nvcc contracts no FMA there: marker
// positions do not depend on the field and stay bit-equal with the plain
// PyTorch version (emme_tpu_torch/solvers/cuda_pic.py::stage_ref) over a run.
//
// The cross-block sum of the deposit has a fixed order.  Every block writes
// its histogram as one float64 partial: partials (n_blocks, 2, nf), no
// atomics on device memory.  The field pass then sums the partials with many
// blocks: a block takes 32 adjacent columns, its warps take the partials at a
// stride of the warp count (coalesced 256-byte reads), and warp 0 adds the
// warps' sums in warp order, rounds to float32 and multiplies by the
// quasi-neutrality coefficient.  Two runs over the same partials give the
// same bits.  Only the order of the shared-memory atomics inside a block
// varies, so eta (which never sees the field) repeats bit for bit and the
// field and the weights repeat to rounding.
//
// What bounds it: the instruction rate, then device memory.  A marker-stage
// is J0 twice and J1 once (30-term Taylor sums for |x| <= 8), four sincos and
// a few true divisions: on the Taylor side about 1,400 instructions, 660 of
// them float32 arithmetic (1,120 and 500 in K3, which carries one J0 and one
// sincos over from the stage before), against 50 to 90 bytes of marker
// traffic; up to 12,288 grid points the field and the histogram (4 nf
// floats) live in shared memory (the forms, below).  What the design does
// about it: the Taylor
// sums are unrolled and divide by their compile-time constants with the exact
// three-operation sequence of div_const (five instructions a term where an
// IEEE division took about thirteen); sin and cos of one angle come from one
// sincosf; K3 carries J0 and the phase factor from stage to stage (Carry).
// Around the marker pass: one block of 1024 threads a SM.  On an H100 that
// beat more, smaller blocks summed over thread-block clusters through
// distributed shared memory: 132 blocks make a grid barrier cost 1.2 us (736
// blocks: 1.9 us) and leave only 132 partials to sum, and the 64
// registers a thread that 1024 threads allow hold the stage body without
// spills.  K4, and K3 in its small-grid form, ask for a SM's whole share of
// shared memory, so that exactly one block sits on each SM.  The field reduce
// uses one block a tile instead of 2 nf threads in all, and the per-step
// statistics fall out of it.  K3 keeps two grid barriers a stage.  No tensor
// core is used: nothing here is a matrix product.  The math routines must be
// the full-range IEEE ones: do not build with --use_fast_math.
//
// Where a stage keeps the field and the deposit histogram is its form,
// chosen by nf alone (cuda_pic.form), never because a launch failed:
//   kFormShared, nf <= kSharedNf: both in shared memory, 16 nf bytes (the
//     small-grid build, the canonical case's);
//   kFormCluster, nf <= kClusterNf: the histogram in the shared memory of a
//     thread-block cluster of cs = 1, 2, 4 or 8 blocks (the smallest whose
//     slice fits a block, cluster_of; cs = 1 up to kClusterSliceNf, a plain
//     launch), the field planes read from device memory, 2 nf floats that
//     stay in L1 and L2 (K3's are written by its own reduce, so they are read
//     with plain loads after the grid barrier, not through the read-only
//     path).  Rank r of a cluster holds the columns [r nf / cs, (r + 1) nf /
//     cs) of both planes in its own shared memory; a marker's four adds go to
//     the rank that owns the column (the CIC pair is adjacent, so both cells
//     usually have one owner), through cluster.map_shared_rank where that
//     rank is another block.  This is the Hopper counterpart of the TPU
//     kernel's deposit accumulator, which stays in VMEM for the whole sweep
//     (pallas_pic.py:7-8, 691-692): the adds stay on the SMs, where
//     kFormGlobal sends them to L2.  One partial a cluster, partials
//     (n_blocks / cs, 2, nf), each rank writing its own columns.  The
//     barriers: cluster.sync() after the zeroing (no peer adds into a slice
//     before it is zeroed) and before write_partials (every add has landed,
//     and none comes later, so a block may leave the kernel or zero its slice
//     again after it).  K3's grid is the co-resident clusters times cs
//     (cudaOccupancyMaxActiveClusters), launched cooperatively with the
//     cluster attribute: on an H100 132 blocks at cs = 1, 66 clusters of 2
//     cover 132 SMs, 30 of 4 and 15 of 8 cover 120 (the GPCs' SM counts are
//     uneven);
//   kFormGlobal, above: each block deposits into its own row of a float32
//     scratch (n_blocks, 2, nf) in device memory, read back through L2 by
//     write_partials.
// The partials and their fixed-order float64 sum are the same in every
// form, so eta repeats bit for bit and the field to rounding in each.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;        // threads a block, every kernel here
constexpr int kFormShared = 0;
constexpr int kFormCluster = 1;
constexpr int kFormGlobal = 2;
constexpr int kSharedNf = 12288;      // 4 nf floats of shared memory: 192 KB
// kFormCluster: a rank's slice is 2 nf / cs floats beside the reduce's 8 KB;
// 28,032 columns fill a block (224,256 + 8,192 bytes), and a cluster has at
// most 8 blocks (the portable limit), so the form reaches 224,256 points.
constexpr int kClusterSliceNf = 28032;
constexpr int kClusterMax = 8;
constexpr int kClusterNf = 224256;
constexpr int kTile = 32;             // columns a block reduces at a time
// The most shared memory one block may have (a SM's 228 KB less the 1 KB the
// runtime keeps), static and dynamic together.
constexpr int kSmemPerBlock = 232448;
// reduce_field's static shared memory: a double for each warp and column
constexpr int kReduceSmem = kThreads / 32 * kTile * 8;
static_assert(kClusterSliceNf == (kSmemPerBlock - kReduceSmem) / 8,
              "a cluster rank's slice fills one block's shared memory");
static_assert(kClusterNf == kClusterMax * kClusterSliceNf,
              "kFormCluster ends at a full slice on each of kClusterMax ranks");

// Which side of each Bessel function's |x| <= 8 split is compiled: 0, both
// (every build the package loads); 1, the Taylor sums alone; 2, the
// asymptotic forms alone.  1 and 2 exist to count the instructions of each
// path (emme_tpu_torch/tools/sass_count.py) and are never loaded.
#ifndef EMME_BESSEL_BRANCH
#define EMME_BESSEL_BRANCH 0
#endif
__device__ __forceinline__ bool taylor_side(float ax) {
  return EMME_BESSEL_BRANCH == 1 || (EMME_BESSEL_BRANCH == 0 && ax <= 8.0f);
}

// Scalar block, filled by the caller (cuda_pic.FusedStep.params_vec) in
// float32; index names as in cuda_pic.py (P_L, P_CW, ...).
constexpr int kP_L = 0;
constexpr int kP_CW = 1;
constexpr int kP_VT = 2;
constexpr int kP_BT = 3;
constexpr int kP_SHAT = 4;
constexpr int kP_ODB = 5;
constexpr int kP_QR = 6;
constexpr int kP_I2CW = 7;
constexpr int kP_SUBDT = 8;           // 8, 9, 10: sub_dt of stage 0, 1, 2
constexpr int kP_CPREV = 11;          // RK_COEF[2][1]
constexpr int kP_CCUR = 12;           // RK_COEF[2][2]
constexpr int kParams = 16;

struct Params {
  float v[kParams];
};

struct Markers {            // (m,) float32 each
  const float* eta;
  const float* vpar;
  const float* vperp;
  const float* wre;
  const float* wim;
  const float* odv;
  const float* ost;
  const float* pw;
};

struct StageOut {
  float velr, veli, eta, wre, wim, denr, deni, w2;
  float j0, dcr, dci;       // J0 and the phase factor at the new eta
  int i2, ir;
};

// J0 and the drift-center phase factor at a stage's eta are the ones its
// predecessor computed at its new eta, from the same inputs, so the same
// bits.  K3 carries them from stage to stage (12 bytes a marker each way
// for a Bessel sum, a sincos and a division); K2 computes them.
struct Carry {
  float j0, dcr, dci;
};

// a / C for a compile-time integer C, correctly rounded (the IEEE quotient):
// with r = RN(1 / C), q = RN(a r), the remainder e = a - C q is exact in one
// FMA and RN(q + e r) is the quotient.  Exact for every float32 mantissa and
// each of the 60 Taylor divisors below (emme_tpu_torch/tools/
// div_const_check.py tries them all; tests/test_torch_cuda_pic_cpu.py emulates
// the sequence in rational arithmetic) while e stays normal, that is for
// |a| >= 2^-93; below that both this and a true division give a quotient
// under 2^-25, which the caller's 1 + quotient rounds away alike.
template <int C>
__device__ __forceinline__ float div_const(float a) {
  constexpr float c = static_cast<float>(C);
  constexpr float r = 1.0f / c;
  if ((C & (C - 1)) == 0) return __fmul_rn(a, r);   // a power of two: exact
  const float q = __fmul_rn(a, r);
  const float e = __fmaf_rn(-c, q, a);
  return __fmaf_rn(e, r, q);
}

// The 30-term Taylor sums of J0 (divisors k^2) and J1 (k (k + 1)), Horner
// from k = K down to 1: t = 1 + (t q) / divisor, unrolled at compile time.
template <int K, bool J1>
struct Taylor {
  static __device__ __forceinline__ float run(float t, float q) {
    constexpr int C = J1 ? K * (K + 1) : K * K;
    const float tn = __fadd_rn(1.0f, div_const<C>(__fmul_rn(t, q)));
    return Taylor<K - 1, J1>::run(tn, q);
  }
};
template <bool J1>
struct Taylor<0, J1> {
  static __device__ __forceinline__ float run(float t, float) { return t; }
};

// J0 / J1 for real x in float32: emme_tpu/ops/bessel.py:206-249, term for term.
__device__ float bessel_j0f(float x) {
  const float ax = fabsf(x);
  if (taylor_side(ax))
    return Taylor<30, false>::run(1.0f, (-0.25f * x) * x);
  const float z = 8.0f / fmaxf(ax, 1e-30f);
  const float y = z * z;
  const float P = 1.0f + y * (-0.1098628627e-2f + y * (0.2734510407e-4f
      + y * (-0.2073370639e-5f + y * 0.2093887211e-6f)));
  const float Q = z * (-0.1562499995e-1f + y * (0.1430488765e-3f
      + y * (-0.6911147651e-5f + y * (0.7621095161e-6f + y * (-0.934935152e-7f)))));
  const float xx = ax - 0.785398163397448309616f;
  float s, c;
  sincosf(xx, &s, &c);
  return sqrtf(0.636619772367581343f / fmaxf(ax, 1e-30f)) * (c * P - s * Q);
}

__device__ float bessel_j1f(float x) {
  const float ax = fabsf(x);
  if (taylor_side(ax))
    return (0.5f * x) * Taylor<30, true>::run(1.0f, (-0.25f * x) * x);
  const float z = 8.0f / fmaxf(ax, 1e-30f);
  const float y = z * z;
  const float P = 1.0f + y * (0.183105e-2f + y * (-0.3516396496e-4f
      + y * (0.2457520174e-5f + y * (-0.240337019e-6f))));
  const float Q = z * (0.04687499995f + y * (-0.2002690873e-3f
      + y * (0.8449199096e-5f + y * (-0.88228987e-6f + y * 0.105787412e-6f))));
  const float xx = ax - 2.356194490192344928847f;
  float s, c;
  sincosf(xx, &s, &c);
  const float large =
      sqrtf(0.636619772367581343f / fmaxf(ax, 1e-30f)) * (c * P - s * Q);
  return x < 0.0f ? -large : large;
}

__device__ __forceinline__ int clamp_cell(float f, int nf) {
  const int i = static_cast<int>(f);
  return i < 0 ? 0 : (i > nf - 1 ? nf - 1 : i);
}

// The drift-center phase (q R / v_par) odb (sin(eta) (1 + shat)
// - shat eta cos(eta)) odv, rounded operation by operation as the plain
// version rounds it (no FMA).  Where v_par is small the phase reaches
// thousands of radians, and one ulp of it moves cos and sin of it visibly:
// that alone put 1.4e-4 of scale between the kernel's and the plain first-
// stage field at the canonical size.  se, ce: sin and cos of eta.
__device__ __forceinline__ float dc_phase(const Params& P, float eta, float se,
                                          float ce, float vpar, float odv) {
  const float shat = P.v[kP_SHAT];
  const float a = __fmul_rn(__fdiv_rn(P.v[kP_QR], vpar), P.v[kP_ODB]);
  const float b = __fsub_rn(__fmul_rn(se, __fadd_rn(1.0f, shat)),
                            __fmul_rn(__fmul_rn(shat, eta), ce));
  return __fmul_rn(__fmul_rn(a, b), odv);
}

// One RK stage for one marker (pallas_pic.py:178-279).  sfr / sfi: the field
// planes (Planes).  vpre / vpim: stage 1's velocity (stage 2 only).
template <int STAGE, bool FIRST, bool DC, bool CARRY>
__device__ __forceinline__ StageOut stage_marker(
    const Params& P, const float* sfr, const float* sfi, int nf, float eta,
    float vpar, float vperp, float wre, float wim, float odv, float ost,
    float pw, float vpre, float vpim, Carry in) {
  static_assert(!FIRST || STAGE == 0, "FIRST is a stage-0 variant");
  const float L = P.v[kP_L], cw = P.v[kP_CW], vt = P.v[kP_VT];
  const float bt = P.v[kP_BT], shat = P.v[kP_SHAT], odb = P.v[kP_ODB];
  const float qR = P.v[kP_QR], i2cw = P.v[kP_I2CW];
  const float sub_dt = P.v[kP_SUBDT + STAGE];

  // locate at the current eta (solver_pic.h:96-104), clipped to [0, nf-1]
  const float x = __fdiv_rn(__fadd_rn(eta, L), cw);
  const float idxf = floorf(x);
  const float wgt = __fsub_rn(x, idxf);
  const int c = clamp_cell(idxf, nf);
  const int cp = c + 1 == nf ? 0 : c + 1;
  const int cm = c == 0 ? nf - 1 : c - 1;
  const int cpp = cp + 1 == nf ? 0 : cp + 1;

  // CIC gather: f[c], f[c+1], g[c] = f[c+1] - f[c-1], g[c+1] (periodic)
  const float f0r = sfr[c], f0i = sfi[c], f1r = sfr[cp], f1i = sfi[cp];
  const float g0r = f1r - sfr[cm], g0i = f1i - sfi[cm];
  const float g1r = sfr[cpp] - f0r, g1i = sfi[cpp] - f0i;
  const float wl = 1.0f - wgt;
  const float phir = wl * f0r + wgt * f1r;
  const float phii = wl * f0i + wgt * f1i;
  const float dphir = (wl * g0r + wgt * g1r) * i2cw;
  const float dphii = (wl * g0i + wgt * g1i) * i2cw;

  // marker physics (solver_pic.h:82-140)
  const float x_perp = vperp / vt;
  const float se2 = shat * eta;
  const float sb = sqrtf(bt * (1.0f + se2 * se2));
  const float arg = x_perp * sb;
  const float dj0 = -bt * (shat * shat) * x_perp * eta * bessel_j1f(arg) / sb;
  float se, ce;
  sincosf(eta, &se, &ce);
  const float omega_d = odb * (ce + shat * eta * se);
  float j0 = 0.0f, dcr = 0.0f, dci = 0.0f;
  if (!FIRST && CARRY) {
    j0 = in.j0;
    dcr = in.dcr;
    dci = in.dci;
  } else if (!FIRST) {
    j0 = bessel_j0f(arg);
    if (DC) {
      float sph, cph;
      sincosf(dc_phase(P, eta, se, ce, vpar, odv), &sph, &cph);
      dcr = cph;
      dci = -sph;
    }
  }
  const float a = ost - omega_d * odv;
  const float vq = vpar / qR;
  const float comr = -a * j0 * phii - vq * (j0 * dphir + dj0 * phir);
  const float comi = a * j0 * phir - vq * (j0 * dphii + dj0 * phii);
  StageOut o;
  if (DC) {
    o.velr = pw * (dcr * comr + dci * comi);
    o.veli = pw * (dcr * comi - dci * comr);
  } else {
    const float b = omega_d * odv;
    o.velr = wim * b + pw * comr;
    o.veli = -wre * b + pw * comi;
  }

  // RK combine + update (solver_pic.h:142-151, 425-435)
  float combor, comboi;
  if (STAGE == 2) {
    combor = P.v[kP_CPREV] * vpre + P.v[kP_CCUR] * o.velr;
    comboi = P.v[kP_CPREV] * vpim + P.v[kP_CCUR] * o.veli;
  } else {
    combor = o.velr;
    comboi = o.veli;
  }
  // eta + vpar (sub_dt / qR), then m - 2L floor(m / 2L) - L: no FMA
  const float e1 = __fadd_rn(eta, __fmul_rn(vpar, __fdiv_rn(sub_dt, qR)));
  const float m = __fadd_rn(e1, L);
  const float two_l = __fmul_rn(2.0f, L);
  const float eta_n = __fsub_rn(
      __fsub_rn(m, __fmul_rn(two_l, floorf(__fdiv_rn(m, two_l)))), L);
  o.eta = eta_n;
  o.wre = wre + combor * sub_dt;
  o.wim = wim + comboi * sub_dt;

  // deposit at eta_n (solver_pic.h:249-354)
  const float x2 = __fdiv_rn(__fadd_rn(eta_n, L), cw);
  const float i2f = floorf(x2);
  o.w2 = __fsub_rn(x2, i2f);
  o.i2 = clamp_cell(i2f, nf);
  o.ir = o.i2 + 1 >= nf ? 0 : o.i2 + 1;
  const float sen = shat * eta_n;
  const float sbn = sqrtf(bt * (1.0f + sen * sen));
  const float j0n = bessel_j0f(x_perp * sbn);
  if (DC) {
    float sn, cn, spn, cpn;
    sincosf(eta_n, &sn, &cn);
    sincosf(dc_phase(P, eta_n, sn, cn, vpar, odv), &spn, &cpn);
    const float dnr = cpn, dni = -spn;
    o.denr = j0n * (o.wre * dnr - o.wim * dni);
    o.deni = j0n * (o.wre * dni + o.wim * dnr);
    o.dcr = dnr;
    o.dci = dni;
  } else {
    o.denr = j0n * o.wre;
    o.deni = j0n * o.wim;
    o.dcr = 0.0f;
    o.dci = 0.0f;
  }
  o.j0 = j0n;
  return o;
}

// The field planes a stage gathers from and the histogram it deposits
// into: hr and hi = hr + w hold the columns [rank w, (rank + 1) w).
// kFormShared: shared memory laid out as field re, im, histogram re, im;
// kFormGlobal: both in device memory, the histogram the block's row of
// `scratch`; in these two w = nf and rank = 0.  kFormCluster: the field in
// device memory, this block's slice of the cluster's histogram in shared
// memory, w = nf / cs and rank the block's rank in its cluster.
struct Planes {
  const float* fr;
  const float* fi;
  float* hr;
  float* hi;
  int w;
  int rank;
};

template <int FORM>
__device__ __forceinline__ Planes planes(float* smem, float* scratch,
                                         const float* fr, const float* fi,
                                         int nf) {
  if (FORM == kFormShared)
    return {smem, smem + nf, smem + 2 * nf, smem + 3 * nf, nf, 0};
  if (FORM == kFormCluster) {
    cg::cluster_group cl = cg::this_cluster();
    const int w = nf / static_cast<int>(cl.num_blocks());
    return {fr, fi, smem, smem + w, w, static_cast<int>(cl.block_rank())};
  }
  float* h = scratch + static_cast<size_t>(blockIdx.x) * 2 * nf;
  return {fr, fi, h, h + nf, nf, 0};
}

// Add (re, im) into column col of the cluster's histogram: into this
// block's shared memory where it owns the column, else into the owner's
// through distributed shared memory.
__device__ __forceinline__ void cluster_add(const Planes& pl, int col,
                                            float re, float im) {
  const int owner = col / pl.w;
  const int off = col - owner * pl.w;
  float* h = owner == pl.rank
      ? pl.hr : cg::this_cluster().map_shared_rank(pl.hr, owner);
  atomicAdd(h + off, re);
  atomicAdd(h + pl.w + off, im);
}

template <int FORM>
__device__ __forceinline__ void deposit(const Planes& pl, const StageOut& o) {
  const float wl = 1.0f - o.w2;
  // a cluster of one block owns every column: no owner to work out
  if (FORM == kFormCluster && cg::this_cluster().num_blocks() > 1) {
    cluster_add(pl, o.i2, o.denr * wl, o.deni * wl);
    cluster_add(pl, o.ir, o.denr * o.w2, o.deni * o.w2);
    return;
  }
  atomicAdd(pl.hr + o.i2, o.denr * wl);
  atomicAdd(pl.hr + o.ir, o.denr * o.w2);
  atomicAdd(pl.hi + o.i2, o.deni * wl);
  atomicAdd(pl.hi + o.ir, o.deni * o.w2);
}

// The start of a stage: kFormShared copies the field into shared memory;
// every form zeroes its histogram (kFormCluster: the block's slice, and no
// peer adds into it before the whole cluster has zeroed).
template <int FORM>
__device__ __forceinline__ void stage_begin(float* smem, const Planes& pl,
                                            const float* fr, const float* fi,
                                            int nf) {
  if (FORM == kFormShared) {
    for (int c = threadIdx.x; c < nf; c += blockDim.x) {
      smem[c] = __ldcg(fr + c);
      smem[nf + c] = __ldcg(fi + c);
      smem[2 * nf + c] = 0.0f;
      smem[3 * nf + c] = 0.0f;
    }
  } else {
    for (int c = threadIdx.x; c < 2 * pl.w; c += blockDim.x) pl.hr[c] = 0.0f;
  }
  if (FORM == kFormCluster)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// First level of the deposit sum: the block's histogram becomes its float64
// partial, partials (n_blocks, 2, nf).  A scratch row (kFormGlobal) took
// its deposits as atomics in L2, so it is read from there.  kFormCluster:
// one partial a cluster, partials (n_blocks / cs, 2, nf); after the
// cluster barrier every add has landed and no block touches a peer's
// shared memory again in this stage, so each rank writes its own columns
// and may then leave the kernel or zero its slice for the next stage.
template <int FORM>
__device__ __forceinline__ void write_partials(const Planes& pl,
                                               double* partials, int nf) {
  if (FORM == kFormCluster) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    double* part = partials
        + static_cast<size_t>(blockIdx.x / cl.num_blocks()) * 2 * nf
        + static_cast<size_t>(pl.rank) * pl.w;
    for (int c = threadIdx.x; c < 2 * pl.w; c += blockDim.x) {
      const int plane = c < pl.w ? 0 : 1;
      part[plane * nf + c - plane * pl.w] = static_cast<double>(pl.hr[c]);
    }
    return;
  }
  __syncthreads();
  const int ncol = 2 * nf;
  double* part = partials + static_cast<size_t>(blockIdx.x) * ncol;
  for (int c = threadIdx.x; c < ncol; c += blockDim.x)
    part[c] = static_cast<double>(FORM == kFormGlobal ? __ldcg(pl.hr + c)
                                                      : pl.hr[c]);
}

// Second level: field = qn * sum over the partials (n_part, 2, nf), in a
// fixed order, in float64, rounded to float32 once.  A block takes the tiles
// first_tile, first_tile + tile_stride, ... of kTile adjacent columns; warp w
// sums partials w, w + n_warps, ... for its lane's column (one coalesced
// 256-byte read a partial), and warp 0 adds the warps' sums in warp order.
// A cell's density sums ~1000 markers of both signs; with a float32 sum the
// stage's largest difference from the plain version (float32 index_add_) was
// 2.4e-5 at the canonical size on an H100, with float64 sums on both sides
// 9.5e-7.  tile_stats (n_tiles, 2), when given, receives each tile's sum of
// the field values and of their squares: the per-step statistics' parts.
// nf is a multiple of kTile, so a tile lies in one plane.
__device__ __forceinline__ void reduce_field(const double* partials,
                                             int n_part, const float* qn,
                                             float* fro, float* fio, int nf,
                                             double* tile_stats,
                                             int first_tile, int tile_stride) {
  __shared__ double acc[kThreads / 32][kTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int ncol = 2 * nf, n_tiles = ncol / kTile;
  for (int tile = first_tile; tile < n_tiles; tile += tile_stride) {
    const int c = tile * kTile + lane;
    double s = 0.0;
    for (int q = warp; q < n_part; q += n_warps)
      s += __ldcg(partials + static_cast<size_t>(q) * ncol + c);
    acc[warp][lane] = s;
    __syncthreads();
    if (warp == 0) {
      double tot = acc[0][lane];
      for (int w = 1; w < n_warps; ++w) tot += acc[w][lane];
      const int col = c < nf ? c : c - nf;
      const float v = static_cast<float>(tot) * qn[col];
      (c < nf ? fro : fio)[col] = v;
      if (tile_stats != nullptr) {
        double a = v, b = static_cast<double>(v) * v;
        for (int h = 16; h > 0; h >>= 1) {
          a += __shfl_xor_sync(0xffffffffu, a, h);
          b += __shfl_xor_sync(0xffffffffu, b, h);
        }
        if (lane == 0) {
          tile_stats[2 * tile] = a;
          tile_stats[2 * tile + 1] = b;
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K2: one stage (pic_stage_kernel), then the field (pic_field_kernel)
// ---------------------------------------------------------------------------

template <int STAGE, bool FIRST, bool DC, int FORM>
__global__ void __launch_bounds__(kThreads)
pic_stage_kernel(Params P, const float* fr, const float* fi, Markers mk,
                 const float* vpre, const float* vpim, float* velre_o,
                 float* velim_o, float* eta_o, float* wre_o, float* wim_o,
                 double* partials, float* scratch, int m, int nf) {
  extern __shared__ float smem[];
  const Planes pl = planes<FORM>(smem, scratch, fr, fi, nf);
  stage_begin<FORM>(smem, pl, fr, fi, nf);
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < m; i += stride) {
    const StageOut o = stage_marker<STAGE, FIRST, DC, false>(
        P, pl.fr, pl.fi, nf, mk.eta[i], mk.vpar[i], mk.vperp[i], mk.wre[i],
        mk.wim[i], mk.odv[i], mk.ost[i], mk.pw[i],
        STAGE == 2 ? vpre[i] : 0.0f, STAGE == 2 ? vpim[i] : 0.0f, Carry{});
    velre_o[i] = o.velr;
    velim_o[i] = o.veli;
    eta_o[i] = o.eta;
    wre_o[i] = o.wre;
    wim_o[i] = o.wim;
    deposit<FORM>(pl, o);
  }
  write_partials<FORM>(pl, partials, nf);
}

// One block a tile of kTile columns.
__global__ void __launch_bounds__(kThreads)
pic_field_kernel(const double* partials, int n_part, const float* qn,
                 float* fro, float* fio, int nf) {
  reduce_field(partials, n_part, qn, fro, fio, nf, nullptr, blockIdx.x,
               gridDim.x);
}

// ---------------------------------------------------------------------------
// K3: the whole run in one cooperative launch
// ---------------------------------------------------------------------------

struct MegaState {          // eta, wre, wim updated in place; vel, Carry
  float* eta;
  float* wre;
  float* wim;
  float* velre;
  float* velim;
  float* j0;
  float* dcr;
  float* dci;
};

template <int STAGE, bool FIRST, bool DC, int FORM>
__device__ __forceinline__ void mega_markers(const Params& P, const Planes& pl,
                                             const Markers& mk,
                                             const MegaState& st, int m,
                                             int nf, bool dep) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < m; i += stride) {
    Carry in = {};
    if (!FIRST) {
      in.j0 = st.j0[i];
      if (DC) {
        in.dcr = st.dcr[i];
        in.dci = st.dci[i];
      }
    }
    const StageOut o = stage_marker<STAGE, FIRST, DC, true>(
        P, pl.fr, pl.fi, nf, st.eta[i], mk.vpar[i], mk.vperp[i], st.wre[i],
        st.wim[i], mk.odv[i], mk.ost[i], mk.pw[i],
        STAGE == 2 ? st.velre[i] : 0.0f, STAGE == 2 ? st.velim[i] : 0.0f, in);
    st.j0[i] = o.j0;
    if (DC) {
      st.dcr[i] = o.dcr;
      st.dci[i] = o.dci;
    }
    if (STAGE == 1) {
      st.velre[i] = o.velr;
      st.velim[i] = o.veli;
    }
    st.eta[i] = o.eta;
    st.wre[i] = o.wre;
    st.wim[i] = o.wim;
    if (dep) deposit<FORM>(pl, o);
  }
}

// The statistics of one step (main.cpp:111-118) from the tiles' sums, by one
// warp: lanes over tiles, then a fixed shuffle tree.  The first half of the
// tiles is the real plane, the second the imaginary one.
__device__ __forceinline__ void step_stats(const double* tile_stats,
                                           int n_tiles, int nf, float* row) {
  const int lane = threadIdx.x & 31;
  double a = 0.0, b = 0.0, c = 0.0;
  for (int t = lane; t < n_tiles; t += 32) {
    const double sum = __ldcg(tile_stats + 2 * t);
    if (t < n_tiles / 2) a += sum; else b += sum;
    c += __ldcg(tile_stats + 2 * t + 1);
  }
  for (int h = 16; h > 0; h >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, h);
    b += __shfl_xor_sync(0xffffffffu, b, h);
    c += __shfl_xor_sync(0xffffffffu, c, h);
  }
  if (lane == 0) {
    row[0] = static_cast<float>(a / nf);
    row[1] = static_cast<float>(b / nf);
    row[2] = static_cast<float>(sqrt(c / nf));
  }
}

// Parts of a stage that `parts` switches on; a run has both, and no
// kPartNoDeposit.  Leaving one out gives its share of the run's time by
// difference; kPartNoDeposit runs the marker pass without its deposit.
constexpr int kPartMarkers = 1;
constexpr int kPartReduce = 2;
constexpr int kPartNoDeposit = 4;

// fbuf: two field buffers of (2, nf); t reads buffer t % 2 (t == 0: the
// initial field) and writes buffer (t + 1) % 2.  stats: (n_steps, 3).
// scratch: (n_blocks, 2, nf) for kFormGlobal, else unused.  partials: one
// a block, one a cluster in kFormCluster.
// One block in `spread` reduces, so that the reducing blocks sit on as many
// SMs as there are tiles.
template <bool DC, int FORM>
__global__ void __launch_bounds__(kThreads)
pic_mega_kernel(Params P, const float* fr_in, const float* fi_in,
                const float* qn, Markers mk, MegaState st, double* partials,
                float* fbuf, double* tile_stats, float* stats, float* scratch,
                int n_steps, int m, int nf, int parts) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int grid_blocks = static_cast<int>(gridDim.x);
  const int n_tiles = 2 * nf / kTile;
  const int spread = max(1, grid_blocks / n_tiles);
  const bool reducer = (parts & kPartReduce) && blockIdx.x % spread == 0;
  const int n_reducers = (grid_blocks + spread - 1) / spread;
  const int n_part = FORM == kFormCluster
      ? grid_blocks / static_cast<int>(cg::this_cluster().num_blocks())
      : grid_blocks;
  const bool dep = !(parts & kPartNoDeposit);
  for (int t = 0; t < 3 * n_steps; ++t) {
    const int stage = t % 3;
    const float* cur = fbuf + (t % 2) * 2 * nf;
    const float* fr = t == 0 ? fr_in : cur;
    const float* fi = t == 0 ? fi_in : cur + nf;
    const Planes pl = planes<FORM>(smem, scratch, fr, fi, nf);
    stage_begin<FORM>(smem, pl, fr, fi, nf);
    if (!(parts & kPartMarkers)) {
    } else if (t == 0) {
      mega_markers<0, true, DC, FORM>(P, pl, mk, st, m, nf, dep);
    } else if (stage == 0) {
      mega_markers<0, false, DC, FORM>(P, pl, mk, st, m, nf, dep);
    } else if (stage == 1) {
      mega_markers<1, false, DC, FORM>(P, pl, mk, st, m, nf, dep);
    } else {
      mega_markers<2, false, DC, FORM>(P, pl, mk, st, m, nf, dep);
    }
    write_partials<FORM>(pl, partials, nf);
    grid.sync();
    float* nxt = fbuf + ((t + 1) % 2) * 2 * nf;
    if (reducer)
      reduce_field(partials, n_part, qn, nxt, nxt + nf, nf,
                   stage == 2 ? tile_stats : nullptr, blockIdx.x / spread,
                   n_reducers);
    grid.sync();
    // the last block reduces no tile where the grid outnumbers the tiles
    if (stage == 2 && blockIdx.x == grid_blocks - 1 && threadIdx.x < 32)
      step_stats(tile_stats, n_tiles, nf, stats + 3 * (t / 3));
  }
}

// ---------------------------------------------------------------------------
// K4: grid-sync probe
// ---------------------------------------------------------------------------

// The block rotation of round s >= 2: far at first (half the grid away,
// another SM), then nearer.
__device__ __forceinline__ int probe_rotation(int s, int nb) {
  return (nb / s + s) % nb;
}

// `rounds` rounds over blocks of `slice` floats; every round doubles.
// Round 1 reads x in place: block b doubles its own slice -> buf_a.  Round
// s >= 2 follows a grid.sync(): block b reads the slice block
// (b + rotation(s)) mod n_blocks wrote in round s - 1 and writes the other
// buffer.  The result (buf_a for odd rounds, buf_b for even) is right only if
// every round saw the other blocks' writes.  copy == 0 leaves the loads and
// stores out: the launch and its rounds - 1 barriers alone, the floor of this
// kernel's time.
__global__ void __launch_bounds__(kThreads)
grid_sync_probe_kernel(const float* x, float* buf_a, float* buf_b, int slice,
                       int rounds, int copy) {
  cg::grid_group grid = cg::this_grid();
  const int nb = static_cast<int>(gridDim.x);
  const size_t to = static_cast<size_t>(blockIdx.x) * slice;
  if (copy)
    for (int i = threadIdx.x; i < slice; i += blockDim.x)
      buf_a[to + i] = 2.0f * x[to + i];
  for (int s = 2; s <= rounds; ++s) {
    grid.sync();
    if (copy) {
      const float* src = s % 2 ? buf_b : buf_a;
      float* dst = s % 2 ? buf_a : buf_b;
      const size_t from =
          static_cast<size_t>((blockIdx.x + probe_rotation(s, nb)) % nb) *
          slice;
      for (int i = threadIdx.x; i < slice; i += blockDim.x)
        dst[to + i] = 2.0f * __ldcg(src + from + i);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using StageFn = void (*)(Params, const float*, const float*, Markers,
                         const float*, const float*, float*, float*, float*,
                         float*, float*, double*, float*, int, int);

int form_of(int nf) {
  if (nf <= kSharedNf) return kFormShared;
  return nf <= kClusterNf ? kFormCluster : kFormGlobal;
}

// The blocks of a cluster: in kFormCluster the smallest of 1, 2, 4, 8 whose
// slice of nf / cs columns fits a block (nf % kTile == 0, so cs divides
// nf); 1 in the other forms.
int cluster_of(int nf) {
  if (form_of(nf) != kFormCluster) return 1;
  int cs = 1;
  while (nf > cs * kClusterSliceNf) cs *= 2;
  return cs;
}

template <int FORM>
StageFn stage_fn_form(int stage, int first, int dc) {
  if (first && stage != 0) return nullptr;
  if (dc) {
    if (stage == 0) return first ? pic_stage_kernel<0, true, true, FORM>
                                 : pic_stage_kernel<0, false, true, FORM>;
    if (stage == 1) return pic_stage_kernel<1, false, true, FORM>;
    if (stage == 2) return pic_stage_kernel<2, false, true, FORM>;
  } else {
    if (stage == 0) return first ? pic_stage_kernel<0, true, false, FORM>
                                 : pic_stage_kernel<0, false, false, FORM>;
    if (stage == 1) return pic_stage_kernel<1, false, false, FORM>;
    if (stage == 2) return pic_stage_kernel<2, false, false, FORM>;
  }
  return nullptr;
}

StageFn stage_fn(int stage, int first, int dc, int nf) {
  switch (form_of(nf)) {
    case kFormShared: return stage_fn_form<kFormShared>(stage, first, dc);
    case kFormCluster: return stage_fn_form<kFormCluster>(stage, first, dc);
    default: return stage_fn_form<kFormGlobal>(stage, first, dc);
  }
}

template <int FORM>
const void* mega_fn_form(int dc) {
  return dc ? reinterpret_cast<const void*>(pic_mega_kernel<true, FORM>)
            : reinterpret_cast<const void*>(pic_mega_kernel<false, FORM>);
}

const void* mega_fn(int dc, int nf) {
  switch (form_of(nf)) {
    case kFormShared: return mega_fn_form<kFormShared>(dc);
    case kFormCluster: return mega_fn_form<kFormCluster>(dc);
    default: return mega_fn_form<kFormGlobal>(dc);
  }
}

// The dynamic shared memory a stage's form needs.
size_t smem_bytes(int nf) {
  const int floats[] = {4 * nf, 2 * (nf / cluster_of(nf)), 0};
  return static_cast<size_t>(floats[form_of(nf)]) * sizeof(float);
}

bool bad_nf(int nf) { return nf < kTile || nf % kTile; }

// The launch configuration of fn: `grid` blocks of kThreads with `bytes` of
// dynamic shared memory, cooperative or not, in clusters of `cluster`
// blocks where cluster > 1.  attrs: room for two attributes.
cudaLaunchConfig_t launch_config(int grid, size_t bytes, bool cooperative,
                                 int cluster, cudaLaunchAttribute* attrs,
                                 void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attrs;
  attrs[0].id = cudaLaunchAttributeCooperative;
  attrs[0].val.cooperative = cooperative ? 1 : 0;
  cfg.numAttrs = 1;
  if (cluster > 1) {
    attrs[1].id = cudaLaunchAttributeClusterDimension;
    attrs[1].val.clusterDim.x = cluster;
    attrs[1].val.clusterDim.y = 1;
    attrs[1].val.clusterDim.z = 1;
    cfg.numAttrs = 2;
  }
  return cfg;
}

// Launch fn with `bytes` of dynamic shared memory (more than 48 KB needs the
// attribute), cooperatively or not, in clusters of `cluster` blocks.  A
// launch the runtime refuses returns its error; nothing is launched in its
// place.
cudaError_t launch(const void* fn, int grid, size_t bytes, bool cooperative,
                   int cluster, void** args, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attrs[2];
  const cudaLaunchConfig_t cfg =
      launch_config(grid, bytes, cooperative, cluster, attrs, stream);
  e = cudaLaunchKernelExC(&cfg, fn, args);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// How many clusters of `cluster` blocks of fn with `bytes` of dynamic
// shared memory are co-resident on the device.
cudaError_t active_clusters(const void* fn, size_t bytes, int cluster,
                            int* clusters) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attrs[2];
  const cudaLaunchConfig_t cfg =
      launch_config(cluster, bytes, false, cluster, attrs, nullptr);
  return cudaOccupancyMaxActiveClusters(clusters, fn, &cfg);
}

// How many blocks of fn with `bytes` of dynamic shared memory are
// co-resident: blocks a SM by occupancy times the SM count.
cudaError_t resident_blocks(const void* fn, size_t bytes, int* blocks_per_sm,
                            int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                      kThreads, bytes);
  return e;
}

// The dynamic shared memory that fills a SM's share beside fn's static
// shared memory: one block a SM.
cudaError_t one_block_smem(const void* fn, size_t* bytes) {
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, fn);
  if (e != cudaSuccess) return e;
  *bytes = kSmemPerBlock - fa.sharedSizeBytes;
  *bytes -= *bytes % 128;
  return cudaSuccess;
}

Params load_params(const float* params) {
  Params P;
  for (int k = 0; k < kParams; ++k) P.v[k] = params[k];
  return P;
}

}  // namespace

extern "C" {

int pic_form(int nf) { return bad_nf(nf) ? -1 : form_of(nf); }
int pic_cluster_size(int nf) { return bad_nf(nf) ? -1 : cluster_of(nf); }
int pic_params_len() { return kParams; }
int pic_threads() { return kThreads; }
int pic_tile() { return kTile; }

// K2's grid for (stage, first, dc, m, nf): one block per kThreads markers, at
// most the co-resident count; in kFormCluster a multiple of the cluster
// size, at most the co-resident clusters' blocks.  0 on a bad argument or a
// CUDA error.
int pic_stage_grid(int stage, int first, int dc, int m, int nf) {
  if (bad_nf(nf) || m < 1) return 0;
  StageFn fn = stage_fn(stage, first, dc, nf);
  if (fn == nullptr) return 0;
  const void* f = reinterpret_cast<const void*>(fn);
  const int cs = cluster_of(nf);
  long long want = (static_cast<long long>(m) + kThreads - 1) / kThreads;
  long long cap = 0;
  if (cs > 1) {
    int clusters = 0;
    if (active_clusters(f, smem_bytes(nf), cs, &clusters) != cudaSuccess)
      return 0;
    want = (want + cs - 1) / cs * cs;
    cap = static_cast<long long>(clusters) * cs;
  } else {
    int per_sm = 0, sms = 0;
    if (resident_blocks(f, smem_bytes(nf), &per_sm, &sms) != cudaSuccess)
      return 0;
    cap = static_cast<long long>(per_sm) * sms;
  }
  return static_cast<int>(want < cap ? want : cap);
}

// One K2 stage over m markers with n_blocks blocks (pic_stage_grid), in
// clusters of pic_cluster_size(nf) blocks.
// params: kParams host floats.  vpre / vpim: stage 1's velocity, stage 2 only
// (else may be null).  partials: (n_blocks / pic_cluster_size(nf), 2, nf)
// device doubles.  scratch: (n_blocks, 2, nf) device floats where
// pic_form(nf) is kFormGlobal, else may be null.
int pic_stage_launch(int stage, int first, int dc, const float* params,
                     const float* fr, const float* fi, const float* eta,
                     const float* vpar, const float* vperp, const float* wre,
                     const float* wim, const float* odv, const float* ost,
                     const float* pw, const float* vpre, const float* vpim,
                     float* velre_o, float* velim_o, float* eta_o,
                     float* wre_o, float* wim_o, double* partials,
                     float* scratch, int m, int nf, int n_blocks,
                     void* stream) {
  if (bad_nf(nf) || m < 1 || n_blocks < 1 ||
      n_blocks % cluster_of(nf) ||
      (stage == 2 && (vpre == nullptr || vpim == nullptr)) ||
      (form_of(nf) == kFormGlobal && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  StageFn fn = stage_fn(stage, first, dc, nf);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Params P = load_params(params);
  Markers mk = {eta, vpar, vperp, wre, wim, odv, ost, pw};
  void* args[] = {&P, &fr, &fi, &mk, &vpre, &vpim, &velre_o, &velim_o,
                  &eta_o, &wre_o, &wim_o, &partials, &scratch, &m, &nf};
  return static_cast<int>(launch(reinterpret_cast<const void*>(fn), n_blocks,
                                 smem_bytes(nf), false, cluster_of(nf), args,
                                 stream));
}

// The field after a K2 stage: fro/fio[c] = qn[c] * sum_q partials[q, :, c].
int pic_field_launch(const double* partials, int n_part, const float* qn,
                     float* fro, float* fio, int nf, void* stream) {
  if (bad_nf(nf) || n_part < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  pic_field_kernel<<<2 * nf / kTile, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      partials, n_part, qn, fro, fio, nf);
  return static_cast<int>(cudaGetLastError());
}

// K3's co-resident grid at nf: the SM count, the grid (one block a SM; in
// kFormCluster the co-resident clusters times their size, which may leave
// SMs idle), the dynamic shared memory (kFormShared: a SM's whole share, so
// that exactly one block sits on a SM; the other forms: what they need,
// which leaves the rest of the SM's 256 KB to L1 for the field planes; 1024
// threads of 58+ registers fit one block a SM anyway), the kernel's
// registers, the device's cooperative-launch attribute, the cluster size
// and the clusters (grid / cluster).  grid is 0 where no block fits.
// Returns a CUDA error code.
int pic_mega_grid(int dc, int nf, int* sms, int* grid, int* smem,
                  int* registers, int* coop, int* cluster, int* clusters) {
  if (bad_nf(nf)) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = mega_fn(dc, nf);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(coop, cudaDevAttrCooperativeLaunch, dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, fn);
  size_t bytes = smem_bytes(nf);
  if (e == cudaSuccess && form_of(nf) == kFormShared)
    e = one_block_smem(fn, &bytes);
  int per_sm = 0;
  if (e == cudaSuccess) e = resident_blocks(fn, bytes, &per_sm, sms);
  *cluster = cluster_of(nf);
  *clusters = 0;
  if (e == cudaSuccess && *cluster > 1)
    e = active_clusters(fn, bytes, *cluster, clusters);
  if (e != cudaSuccess) return static_cast<int>(e);
  *registers = fa.numRegs;
  if (*cluster == 1) *clusters = per_sm > 0 ? *sms : 0;
  *grid = *clusters * *cluster;
  *smem = static_cast<int>(bytes);
  return static_cast<int>(cudaSuccess);
}

// The whole run: n_steps x 3 stages in one cooperative launch of `grid`
// blocks with `smem` bytes of dynamic shared memory (both from
// pic_mega_grid), in clusters of pic_cluster_size(nf) blocks.  eta, wre,
// wim are updated in place; velre / velim: (m,) scratch; carry: (3, m)
// scratch; partials: (grid / pic_cluster_size(nf), 2, nf) doubles; fbuf:
// (2, 2, nf); tile_stats: (2 nf / pic_tile(), 2) doubles; stats:
// (n_steps, 3); scratch: (grid, 2, nf) floats where pic_form(nf) is
// kFormGlobal, else may be null.  The final field is in fbuf buffer
// (3 n_steps) % 2.  parts: 3 for a run (1: the marker pass, 2: the field
// reduce, + 4: the marker pass without its deposit).
int pic_mega_launch(int dc, const float* params, const float* fr_in,
                    const float* fi_in, const float* qn, float* eta,
                    const float* vpar, const float* vperp, float* wre,
                    float* wim, const float* odv, const float* ost,
                    const float* pw, float* velre, float* velim, float* carry,
                    double* partials, float* fbuf, double* tile_stats,
                    float* stats, float* scratch, int n_steps, int m, int nf,
                    int grid, int smem, int parts, void* stream) {
  if (bad_nf(nf) || m < 1 || n_steps < 1 || grid < 1 ||
      grid % cluster_of(nf) || smem < static_cast<int>(smem_bytes(nf)) ||
      parts < 0 || parts > 7 ||
      (form_of(nf) == kFormGlobal && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params P = load_params(params);
  Markers mk = {eta, vpar, vperp, wre, wim, odv, ost, pw};
  MegaState st = {eta, wre, wim, velre, velim, carry, carry + m,
                  carry + 2 * static_cast<size_t>(m)};
  void* args[] = {&P, &fr_in, &fi_in, &qn, &mk, &st, &partials, &fbuf,
                  &tile_stats, &stats, &scratch, &n_steps, &m, &nf, &parts};
  return static_cast<int>(launch(mega_fn(dc, nf), grid, smem, true,
                                 cluster_of(nf), args, stream));
}

// K4: `rounds` rounds over n_blocks blocks, each on `slice` floats, with a
// SM's whole share of shared memory, so that the blocks are co-resident as
// K3's are, in clusters of `cluster` blocks as K3's (1: no cluster).  x is
// read in place; buf_a and buf_b are scratch; the result is in buf_a for
// odd rounds, buf_b for even.
int grid_sync_probe_launch(const float* x, float* buf_a, float* buf_b,
                           int n_blocks, int slice, int rounds, int copy,
                           int cluster, void* stream) {
  if (n_blocks < 1 || slice < 1 || rounds < 1 || cluster < 1 ||
      cluster > kClusterMax || n_blocks % cluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = reinterpret_cast<const void*>(grid_sync_probe_kernel);
  size_t bytes = 0;
  const cudaError_t e = one_block_smem(fn, &bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&x, &buf_a, &buf_b, &slice, &rounds, &copy};
  return static_cast<int>(launch(fn, n_blocks, bytes, true, cluster, args,
                                 stream));
}

}  // extern "C"
