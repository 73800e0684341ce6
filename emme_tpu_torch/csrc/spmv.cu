// Complex block-sparse-row (BSR) SpMV / SpMM, y = A x, CUDA C++ for Hopper
// (sm_90a).
//
// Replaces the TPU kernel emme_tpu/ops/sparse.py::_spmv_kernel (the Pallas
// body at line 109, launched by bsr_matvec_pallas).  The Pallas kernel runs
// one grid step per stored block on a sequential grid: it zeroes a block
// row's y at the row's first block and carries the sum in VMEM, with the
// complex product written as four real dots on (re, im) planes.  Hopper has
// no sequential grid, so here each CTA OWNS a tile of rows inside one block
// row: it walks that block row's stored blocks from row_ptr, keeps its sums
// in registers and writes its y rows once.  No atomics, no sum across CTAs,
// and the result is deterministic.
//
// Within a CTA, warp w owns consecutive rows; the lanes read neighbouring
// columns of each of them, accumulate in the element type across every
// block of the row, and a warp-shuffle reduction per (row, rhs) ends the
// walk.
//
// Two kernels, chosen by the number of right-hand sides r:
// * r = 1 (every matvec of the banded eigensolve): bsr_spmv_vec_kernel.
//   8 warps a CTA; each lane loads 16 bytes at a time (two complex64
//   elements, or one complex128) and starts the loads of all its rows
//   together.  x is read straight through the read-only cache (64 KB at
//   n = 8192, resident in L2), so a block costs no barrier.  Rows per warp
//   (2 for complex64, 4 for complex128) were picked on the H100 at the
//   tok8192 operator: more warps in flight beat more rows per warp.  At
//   bs 128 that is 64 x 8 = 512 CTAs (complex64).  An odd bs, or a pointer
//   not 16-byte aligned, takes element-sized loads.
// * r > 1: bsr_spmv_tile_kernel stages each block's x segment (RT = 8
//   right-hand sides) in shared memory and tiles r by 8; 32 rows a CTA.
//
// What bounds it: device memory.  Every stored block is read once per
// matvec (per 8 right-hand sides): 241 MB of complex64 blocks at the
// tok8192 operator, about 72 us at 3.35 TB/s; x and y are a few hundred KB.
// The arithmetic (8 flops per complex multiply-add, 1 per 2 bytes read) is
// far below the card's rate.  TMA tiles and a persistent grid are later
// work.
//
// Templates on float2 (complex64) and double2 (complex128); both accumulate
// in their own element type.  x and y are (n, r) row-major.  The kernels
// allocate nothing and do not synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;   // both kernels: 8 warps a CTA
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;                    // r > 1
constexpr int kTileRows = kWarps * kRowsPerWarp;   // 32 rows per CTA
constexpr int kMaxBlock = 256;

template <typename V>
__device__ __forceinline__ void cfma(V& acc, const V a, const V b) {
  acc.x = fma(a.x, b.x, acc.x);
  acc.x = fma(-a.y, b.y, acc.x);
  acc.y = fma(a.x, b.y, acc.y);
  acc.y = fma(a.y, b.x, acc.y);
}

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_down_sync(0xffffffffu, v.x, off);
    v.y += __shfl_down_sync(0xffffffffu, v.y, off);
  }
  return v;
}

// r = 1 load packs: P is what one lane loads at a time, N elements of V;
// ROWS is the rows a warp owns.
template <typename V, typename P>
struct Pack {   // one element a load
  static constexpr int N = 1;
  static constexpr int ROWS = 4;
  __device__ static void mac(V& acc, const P a, const P x) { cfma(acc, a, x); }
};
template <>
struct Pack<float2, float4> {   // two complex64 elements a load
  static constexpr int N = 2;
  static constexpr int ROWS = 2;
  __device__ static void mac(float2& acc, const float4 a, const float4 x) {
    cfma(acc, float2{a.x, a.y}, float2{x.x, x.y});
    cfma(acc, float2{a.z, a.w}, float2{x.z, x.w});
  }
};

// r = 1.  grid: nb * row_tiles; block: kThreads; no shared memory.
template <typename V, typename P>
__global__ void __launch_bounds__(kThreads)
bsr_spmv_vec_kernel(const P* __restrict__ data,
                    const int* __restrict__ col_idx,
                    const int* __restrict__ row_ptr, const P* __restrict__ x,
                    V* __restrict__ y, int bs, int row_tiles) {
  constexpr int kRows = Pack<V, P>::ROWS;
  const int rb = blockIdx.x / row_tiles;
  const int tile = blockIdx.x - rb * row_tiles;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = (tile * kWarps + warp) * kRows;
  const int nrows = min(kRows, bs - row0);   // warp-uniform
  const int np = bs / Pack<V, P>::N;         // packs per row

  V acc[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) acc[q] = V{0, 0};

  const int k_end = row_ptr[rb + 1];
  for (int k = row_ptr[rb]; k < k_end; ++k) {
    const P* xs = x + static_cast<size_t>(__ldg(col_idx + k)) * np;
    const P* blk = data + (static_cast<size_t>(k) * bs + row0) * np;
#pragma unroll 2
    for (int j = lane; j < np; j += 32) {
      const P xv = __ldg(xs + j);
      P a[kRows];   // the warp's row loads, all in flight at once
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        a[q] = q < nrows ? __ldg(blk + static_cast<size_t>(q) * np + j)
                         : P{};
#pragma unroll
      for (int q = 0; q < kRows; ++q) Pack<V, P>::mac(acc[q], a[q], xv);
    }
  }

#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const V s = warp_sum(acc[q]);
    if (lane == 0 && q < nrows)
      y[static_cast<size_t>(rb) * bs + row0 + q] = s;
  }
}

template <typename V, typename P>
void launch_vec(const void* data, const int* col_idx, const int* row_ptr,
                const void* x, void* y, int nb, int bs, cudaStream_t stream) {
  constexpr int kRowsPerCta = kWarps * Pack<V, P>::ROWS;
  const int row_tiles = (bs + kRowsPerCta - 1) / kRowsPerCta;
  bsr_spmv_vec_kernel<V, P><<<nb * row_tiles, kThreads, 0, stream>>>(
      static_cast<const P*>(data), col_idx, row_ptr, static_cast<const P*>(x),
      static_cast<V*>(y), bs, row_tiles);
}

// r > 1.  grid: (nb * row_tiles, ceil(r / RT)); block: kThreads; dynamic shared
// memory: RT * bs elements of V, stored right-hand side by right-hand side so
// that the lanes of a warp read neighbouring words.
template <typename V, int RT>
__global__ void __launch_bounds__(kThreads)
bsr_spmv_tile_kernel(const V* __restrict__ data,
                     const int* __restrict__ col_idx,
                     const int* __restrict__ row_ptr, const V* __restrict__ x,
                     V* __restrict__ y, int bs, int r, int row_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* xs = reinterpret_cast<V*>(smem_raw);   // (RT, bs): x segment of a block

  const int rb = blockIdx.x / row_tiles;
  const int tile = blockIdx.x - rb * row_tiles;
  const int c0 = blockIdx.y * RT;
  const int nrt = min(RT, r - c0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = tile * kTileRows + warp * kRowsPerWarp;

  V acc[kRowsPerWarp][RT];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q)
#pragma unroll
    for (int c = 0; c < RT; ++c) acc[q][c] = V{0, 0};

  const int k_begin = row_ptr[rb];
  const int k_end = row_ptr[rb + 1];
  for (int k = k_begin; k < k_end; ++k) {
    const size_t xoff = static_cast<size_t>(col_idx[k]) * bs;
    __syncthreads();   // the previous block's segment is consumed
    for (int e = threadIdx.x; e < bs * RT; e += kThreads) {
      const int j = e / RT;
      const int c = e - j * RT;
      xs[c * bs + j] = c < nrt ? x[(xoff + j) * r + c0 + c] : V{0, 0};
    }
    __syncthreads();
    const V* blk = data + static_cast<size_t>(k) * bs * bs;
#pragma unroll 2
    for (int j = lane; j < bs; j += 32) {
      V a[kRowsPerWarp];
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q)
        a[q] = row0 + q < bs ? blk[static_cast<size_t>(row0 + q) * bs + j]
                             : V{0, 0};
#pragma unroll
      for (int c = 0; c < RT; ++c) {
        const V xv = xs[c * bs + j];
#pragma unroll
        for (int q = 0; q < kRowsPerWarp; ++q) cfma(acc[q][c], a[q], xv);
      }
    }
  }

#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
#pragma unroll
    for (int c = 0; c < RT; ++c) {
      const V s = warp_sum(acc[q][c]);
      if (lane == 0 && row0 + q < bs && c < nrt)
        y[(static_cast<size_t>(rb) * bs + row0 + q) * r + c0 + c] = s;
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename V>
int launch(const void* data, const int* col_idx, const int* row_ptr,
           const void* x, void* y, int nb, int bs, int r,
           cudaStream_t stream) {
  if (r == 1) {
    if (sizeof(V) == 8 && bs % 2 == 0 && aligned16(data) && aligned16(x))
      launch_vec<float2, float4>(data, col_idx, row_ptr, x, y, nb, bs,
                                 stream);
    else
      launch_vec<V, V>(data, col_idx, row_ptr, x, y, nb, bs, stream);
  } else {
    constexpr int kRt = 8;
    const int row_tiles = (bs + kTileRows - 1) / kTileRows;
    const dim3 grid(nb * row_tiles, (r + kRt - 1) / kRt);
    bsr_spmv_tile_kernel<V, kRt>
        <<<grid, kThreads, bs * kRt * sizeof(V), stream>>>(
            static_cast<const V*>(data), col_idx, row_ptr,
            static_cast<const V*>(x), static_cast<V*>(y), bs, r, row_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`.  dtype 0: complex64 (float2), 1: complex128 (double2).
// data: (nnzb, bs, bs); col_idx: (nnzb,) int32; row_ptr: (nb + 1,) int32;
// x, y: (nb * bs, r) row-major, all on the device.  Returns
// cudaGetLastError() after the launch (0 on success).
int bsr_spmv_launch(int dtype, const void* data, const int* col_idx,
                    const int* row_ptr, const void* x, void* y, int nb, int bs,
                    int r, void* stream) {
  if (nb < 1 || bs < 1 || bs > kMaxBlock || r < 1 || r > 65535 * 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float2>(data, col_idx, row_ptr, x, y, nb, bs, r, s);
  if (dtype == 1)
    return launch<double2>(data, col_idx, row_ptr, x, y, nb, bs, r, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int bsr_spmv_max_block() { return kMaxBlock; }

}  // extern "C"
