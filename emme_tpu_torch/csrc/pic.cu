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
// The cross-block sum of the deposit is deterministic: each block writes its
// histogram to a partials buffer (n_blocks, 2, nf), and the field pass sums the
// partials in block order, in float64, and multiplies by the quasi-neutrality
// coefficient.  Only the order of the shared-memory atomics inside a block
// varies.
//
// What bounds it: the FP32 and SFU work per marker (J0 twice, J1, ~6 sin/cos,
// ~90 IEEE divisions of the Taylor sums) plus ~40 bytes of marker traffic per
// marker per stage; the field (2 nf floats) and the deposit histogram
// (2 nf floats) live in shared memory, 16 KB at nf = 1024.  No tensor core is
// used: nothing here is a matrix product.  The math routines must be the
// full-range IEEE ones: do not build with --use_fast_math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNf = 12288;         // 4 nf floats of shared memory: 192 KB

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
  int i2, ir;
};

// J0 / J1 for real x in float32: emme_tpu/ops/bessel.py:206-249, term for term.
__device__ float bessel_j0f(float x) {
  const float ax = fabsf(x);
  if (ax <= 8.0f) {
    const float q = (-0.25f * x) * x;
    float t = 1.0f;
    for (int k = 30; k >= 1; --k) t = 1.0f + t * q / static_cast<float>(k * k);
    return t;
  }
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
  if (ax <= 8.0f) {
    const float q = (-0.25f * x) * x;
    float t = 1.0f;
    for (int k = 30; k >= 1; --k)
      t = 1.0f + t * q / static_cast<float>(k * (k + 1));
    return (0.5f * x) * t;
  }
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
// stage field at the canonical size.
__device__ __forceinline__ float dc_phase(const Params& P, float eta,
                                          float vpar, float odv) {
  const float shat = P.v[kP_SHAT];
  const float a = __fmul_rn(__fdiv_rn(P.v[kP_QR], vpar), P.v[kP_ODB]);
  const float b = __fsub_rn(__fmul_rn(sinf(eta), __fadd_rn(1.0f, shat)),
                            __fmul_rn(__fmul_rn(shat, eta), cosf(eta)));
  return __fmul_rn(__fmul_rn(a, b), odv);
}

// One RK stage for one marker (pallas_pic.py:178-279).  sfr / sfi: the field
// planes in shared memory.  vpre / vpim: stage 1's velocity (stage 2 only).
template <int STAGE, bool FIRST, bool DC>
__device__ __forceinline__ StageOut stage_marker(
    const Params& P, const float* sfr, const float* sfi, int nf, float eta,
    float vpar, float vperp, float wre, float wim, float odv, float ost,
    float pw, float vpre, float vpim) {
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
  if (!FIRST) {
    j0 = bessel_j0f(arg);
    if (DC) {
      const float ph = dc_phase(P, eta, vpar, odv);
      dcr = cosf(ph);
      dci = -sinf(ph);
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
    const float phn = dc_phase(P, eta_n, vpar, odv);
    const float dnr = cosf(phn), dni = -sinf(phn);
    o.denr = j0n * (o.wre * dnr - o.wim * dni);
    o.deni = j0n * (o.wre * dni + o.wim * dnr);
  } else {
    o.denr = j0n * o.wre;
    o.deni = j0n * o.wim;
  }
  return o;
}

__device__ __forceinline__ void deposit(float* hr, float* hi,
                                        const StageOut& o) {
  const float wl = 1.0f - o.w2;
  atomicAdd(hr + o.i2, o.denr * wl);
  atomicAdd(hr + o.ir, o.denr * o.w2);
  atomicAdd(hi + o.i2, o.deni * wl);
  atomicAdd(hi + o.ir, o.deni * o.w2);
}

// Shared-memory layout of K2 and K3: field re, im, histogram re, im.
__device__ __forceinline__ void stage_field(float* smem, const float* fr,
                                            const float* fi, int nf) {
  for (int c = threadIdx.x; c < nf; c += blockDim.x) {
    smem[c] = __ldcg(fr + c);
    smem[nf + c] = __ldcg(fi + c);
    smem[2 * nf + c] = 0.0f;
    smem[3 * nf + c] = 0.0f;
  }
  __syncthreads();
}

__device__ __forceinline__ void write_partials(const float* smem,
                                               float* partials, int nf) {
  __syncthreads();
  float* part = partials + static_cast<size_t>(blockIdx.x) * 2 * nf;
  for (int c = threadIdx.x; c < 2 * nf; c += blockDim.x)
    part[c] = smem[2 * nf + c];
}

// Sum the partials (n_blocks, 2, nf) in block order, in float64, round to
// float32, times qn -> field.  A cell's density sums ~1000 markers of both
// signs; with a float32 sum the stage's largest difference from the plain
// version (float32 index_add_) was 2.4e-5 at the canonical size on an H100,
// with float64 sums on both sides 9.5e-7, for ~10 us more per stage here.
__device__ __forceinline__ void reduce_field(const float* partials,
                                             int n_blocks, const float* qn,
                                             float* fro, float* fio, int nf,
                                             int tid, int stride) {
  for (int c = tid; c < 2 * nf; c += stride) {
    double s = 0.0;
    for (int b = 0; b < n_blocks; ++b)
      s += __ldcg(partials + static_cast<size_t>(b) * 2 * nf + c);
    const float d = static_cast<float>(s);
    if (c < nf)
      fro[c] = d * qn[c];
    else
      fio[c - nf] = d * qn[c - nf];
  }
}

// ---------------------------------------------------------------------------
// K2: one stage (pic_stage_kernel), then the field (pic_field_kernel)
// ---------------------------------------------------------------------------

template <int STAGE, bool FIRST, bool DC>
__global__ void __launch_bounds__(kThreads)
pic_stage_kernel(Params P, const float* fr, const float* fi, Markers mk,
                 const float* vpre, const float* vpim, float* velre_o,
                 float* velim_o, float* eta_o, float* wre_o, float* wim_o,
                 float* partials, int m, int nf) {
  extern __shared__ float smem[];
  stage_field(smem, fr, fi, nf);
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < m; i += stride) {
    const StageOut o = stage_marker<STAGE, FIRST, DC>(
        P, smem, smem + nf, nf, mk.eta[i], mk.vpar[i], mk.vperp[i], mk.wre[i],
        mk.wim[i], mk.odv[i], mk.ost[i], mk.pw[i],
        STAGE == 2 ? vpre[i] : 0.0f, STAGE == 2 ? vpim[i] : 0.0f);
    velre_o[i] = o.velr;
    velim_o[i] = o.veli;
    eta_o[i] = o.eta;
    wre_o[i] = o.wre;
    wim_o[i] = o.wim;
    deposit(smem + 2 * nf, smem + 3 * nf, o);
  }
  write_partials(smem, partials, nf);
}

__global__ void __launch_bounds__(kThreads)
pic_field_kernel(const float* partials, int n_blocks, const float* qn,
                 float* fro, float* fio, int nf) {
  reduce_field(partials, n_blocks, qn, fro, fio, nf,
               blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x);
}

// ---------------------------------------------------------------------------
// K3: the whole run in one cooperative launch
// ---------------------------------------------------------------------------

struct MegaState {          // eta, wre, wim updated in place; vel carry
  float* eta;
  float* wre;
  float* wim;
  float* velre;
  float* velim;
};

template <int STAGE, bool FIRST, bool DC>
__device__ __forceinline__ void mega_markers(const Params& P, float* smem,
                                             const Markers& mk,
                                             const MegaState& st, int m,
                                             int nf) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < m; i += stride) {
    const StageOut o = stage_marker<STAGE, FIRST, DC>(
        P, smem, smem + nf, nf, st.eta[i], mk.vpar[i], mk.vperp[i], st.wre[i],
        st.wim[i], mk.odv[i], mk.ost[i], mk.pw[i],
        STAGE == 2 ? st.velre[i] : 0.0f, STAGE == 2 ? st.velim[i] : 0.0f);
    if (STAGE == 1) {
      st.velre[i] = o.velr;
      st.velim[i] = o.veli;
    }
    st.eta[i] = o.eta;
    st.wre[i] = o.wre;
    st.wim[i] = o.wim;
    deposit(smem + 2 * nf, smem + 3 * nf, o);
  }
}

// fbuf: two field buffers of (2, nf); t reads buffer t % 2 (t == 0: the
// initial field) and writes buffer (t + 1) % 2.  stats: (n_steps, 3).
template <bool DC>
__global__ void __launch_bounds__(kThreads)
pic_mega_kernel(Params P, const float* fr_in, const float* fi_in,
                const float* qn, Markers mk, MegaState st, float* partials,
                float* fbuf, float* stats, int n_steps, int m, int nf) {
  extern __shared__ float smem[];
  __shared__ float red[3][kThreads];
  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t < 3 * n_steps; ++t) {
    const int stage = t % 3;
    const float* cur = fbuf + (t % 2) * 2 * nf;
    stage_field(smem, t == 0 ? fr_in : cur, t == 0 ? fi_in : cur + nf, nf);
    if (t == 0)
      mega_markers<0, true, DC>(P, smem, mk, st, m, nf);
    else if (stage == 0)
      mega_markers<0, false, DC>(P, smem, mk, st, m, nf);
    else if (stage == 1)
      mega_markers<1, false, DC>(P, smem, mk, st, m, nf);
    else
      mega_markers<2, false, DC>(P, smem, mk, st, m, nf);
    write_partials(smem, partials, nf);
    grid.sync();
    float* nxt = fbuf + ((t + 1) % 2) * 2 * nf;
    reduce_field(partials, gridDim.x, qn, nxt, nxt + nf, nf,
                 blockIdx.x * blockDim.x + threadIdx.x,
                 gridDim.x * blockDim.x);
    grid.sync();
    if (stage == 2 && blockIdx.x == 0) {   // per-step stats (main.cpp:111-118)
      float a = 0.0f, b = 0.0f, c = 0.0f;
      for (int i = threadIdx.x; i < nf; i += blockDim.x) {
        const float r = __ldcg(nxt + i), q = __ldcg(nxt + nf + i);
        a += r;
        b += q;
        c += r * r + q * q;
      }
      red[0][threadIdx.x] = a;
      red[1][threadIdx.x] = b;
      red[2][threadIdx.x] = c;
      __syncthreads();
      for (int h = kThreads / 2; h > 0; h >>= 1) {
        if (threadIdx.x < h)
          for (int k = 0; k < 3; ++k)
            red[k][threadIdx.x] += red[k][threadIdx.x + h];
        __syncthreads();
      }
      if (threadIdx.x == 0) {
        const float inv = 1.0f / static_cast<float>(nf);
        float* row = stats + 3 * (t / 3);
        row[0] = red[0][0] * inv;
        row[1] = red[1][0] * inv;
        row[2] = sqrtf(red[2][0] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K4: grid-sync probe
// ---------------------------------------------------------------------------

// Round s = 1..rounds: block b reads the slice block (b + s) mod nblocks
// wrote in round s - 1, doubles it into the other buffer, grid.sync().  The
// result (buffer rounds % 2) is x * 2^rounds, rotated by rounds (rounds+1)/2
// blocks, only if every round saw every other block's writes.
__global__ void __launch_bounds__(kThreads)
grid_sync_probe_kernel(float* buf0, float* buf1, int slice, int rounds) {
  cg::grid_group grid = cg::this_grid();
  const int nb = gridDim.x;
  for (int s = 1; s <= rounds; ++s) {
    const float* src = (s - 1) % 2 ? buf1 : buf0;
    float* dst = s % 2 ? buf1 : buf0;
    const size_t from = static_cast<size_t>((blockIdx.x + s) % nb) * slice;
    const size_t to = static_cast<size_t>(blockIdx.x) * slice;
    for (int i = threadIdx.x; i < slice; i += blockDim.x)
      dst[to + i] = 2.0f * __ldcg(src + from + i);
    grid.sync();
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using StageFn = void (*)(Params, const float*, const float*, Markers,
                         const float*, const float*, float*, float*, float*,
                         float*, float*, float*, int, int);

StageFn stage_fn(int stage, int first, int dc) {
  if (first && stage != 0) return nullptr;
  if (dc) {
    if (stage == 0) return first ? pic_stage_kernel<0, true, true>
                                 : pic_stage_kernel<0, false, true>;
    if (stage == 1) return pic_stage_kernel<1, false, true>;
    if (stage == 2) return pic_stage_kernel<2, false, true>;
  } else {
    if (stage == 0) return first ? pic_stage_kernel<0, true, false>
                                 : pic_stage_kernel<0, false, false>;
    if (stage == 1) return pic_stage_kernel<1, false, false>;
    if (stage == 2) return pic_stage_kernel<2, false, false>;
  }
  return nullptr;
}

size_t smem_bytes(int nf) { return static_cast<size_t>(4) * nf * sizeof(float); }

// Let a kernel take `bytes` of dynamic shared memory (needed above 48 KB).
template <typename F>
cudaError_t allow_smem(F fn, size_t bytes) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename F>
cudaError_t resident_grid(F fn, size_t bytes, int* blocks_per_sm, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = allow_smem(fn, bytes);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                      kThreads, bytes);
  return e;
}

bool bad_nf(int nf) { return nf < 4 || nf > kMaxNf; }

Params load_params(const float* params) {
  Params P;
  for (int k = 0; k < kParams; ++k) P.v[k] = params[k];
  return P;
}

}  // namespace

extern "C" {

int pic_max_nf() { return kMaxNf; }
int pic_params_len() { return kParams; }
int pic_threads() { return kThreads; }

// K2's grid for (stage, first, dc, m, nf): one block per 256 markers, at
// most the co-resident count; 0 on a bad argument or a CUDA error.
int pic_stage_grid(int stage, int first, int dc, int m, int nf) {
  StageFn fn = stage_fn(stage, first, dc);
  if (fn == nullptr || bad_nf(nf) || m < 1) return 0;
  int per_sm = 0, sms = 0;
  if (resident_grid(fn, smem_bytes(nf), &per_sm, &sms) != cudaSuccess) return 0;
  const long long want = (static_cast<long long>(m) + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(per_sm) * sms;
  return static_cast<int>(want < cap ? want : cap);
}

// One K2 stage over m markers with n_blocks blocks (pic_stage_grid).
// params: kParams host floats.  vpre / vpim: stage 1's velocity, stage 2
// only (else may be null).  partials: (n_blocks, 2, nf) device floats.
int pic_stage_launch(int stage, int first, int dc, const float* params,
                     const float* fr, const float* fi, const float* eta,
                     const float* vpar, const float* vperp, const float* wre,
                     const float* wim, const float* odv, const float* ost,
                     const float* pw, const float* vpre, const float* vpim,
                     float* velre_o, float* velim_o, float* eta_o,
                     float* wre_o, float* wim_o, float* partials, int m,
                     int nf, int n_blocks, void* stream) {
  StageFn fn = stage_fn(stage, first, dc);
  if (fn == nullptr || bad_nf(nf) || m < 1 || n_blocks < 1 ||
      (stage == 2 && (vpre == nullptr || vpim == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(nf);
  cudaError_t e = allow_smem(fn, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Markers mk = {eta, vpar, vperp, wre, wim, odv, ost, pw};
  fn<<<n_blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      load_params(params), fr, fi, mk, vpre, vpim, velre_o, velim_o, eta_o,
      wre_o, wim_o, partials, m, nf);
  return static_cast<int>(cudaGetLastError());
}

// The field after a K2 stage: fro/fio[c] = qn[c] * sum_b partials[b, :, c].
int pic_field_launch(const float* partials, int n_blocks, const float* qn,
                     float* fro, float* fio, int nf, void* stream) {
  if (bad_nf(nf) || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (2 * nf + kThreads - 1) / kThreads;
  pic_field_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, n_blocks, qn, fro, fio, nf);
  return static_cast<int>(cudaGetLastError());
}

// K3's co-resident grid at nf: blocks per SM (occupancy), SM count and the
// device's cooperative-launch attribute.  Returns a CUDA error code.
int pic_mega_grid(int dc, int nf, int* blocks_per_sm, int* sms, int* coop) {
  if (bad_nf(nf)) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = dc ? resident_grid(pic_mega_kernel<true>, smem_bytes(nf),
                           blocks_per_sm, sms)
           : resident_grid(pic_mega_kernel<false>, smem_bytes(nf),
                           blocks_per_sm, sms);
  return static_cast<int>(e);
}

// The whole run: n_steps x 3 stages in one cooperative launch of `grid`
// blocks (at most pic_mega_grid's blocks_per_sm x sms).  eta, wre, wim are
// updated in place; velre / velim: (m,) scratch; partials: (grid, 2, nf);
// fbuf: (2, 2, nf); stats: (n_steps, 3).  The final field is in fbuf
// buffer (3 n_steps) % 2.
int pic_mega_launch(int dc, const float* params, const float* fr_in,
                    const float* fi_in, const float* qn, float* eta,
                    const float* vpar, const float* vperp, float* wre,
                    float* wim, const float* odv, const float* ost,
                    const float* pw, float* velre, float* velim,
                    float* partials, float* fbuf, float* stats, int n_steps,
                    int m, int nf, int grid, void* stream) {
  if (bad_nf(nf) || m < 1 || n_steps < 1 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = dc ? reinterpret_cast<const void*>(pic_mega_kernel<true>)
                      : reinterpret_cast<const void*>(pic_mega_kernel<false>);
  const size_t bytes = smem_bytes(nf);
  cudaError_t e = dc ? allow_smem(pic_mega_kernel<true>, bytes)
                     : allow_smem(pic_mega_kernel<false>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  Params P = load_params(params);
  Markers mk = {eta, vpar, vperp, wre, wim, odv, ost, pw};
  MegaState st = {eta, wre, wim, velre, velim};
  void* args[] = {&P, &fr_in, &fi_in, &qn, &mk, &st, &partials, &fbuf,
                  &stats, &n_steps, &m, &nf};
  e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, bytes,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// K4: `rounds` rounds over nblocks blocks of `slice` floats; buf0 holds x,
// buf1 is scratch; the result is in buffer rounds % 2.
int grid_sync_probe_launch(float* buf0, float* buf1, int nblocks, int slice,
                           int rounds, void* stream) {
  if (nblocks < 1 || slice < 1 || rounds < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&buf0, &buf1, &slice, &rounds};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(grid_sync_probe_kernel), dim3(nblocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
