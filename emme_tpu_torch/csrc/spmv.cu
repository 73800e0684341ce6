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
// In the r = 1 and the generic kernel, warp w owns consecutive rows; the
// lanes read neighbouring columns of each of them, accumulate in the element
// type across every block of the row, and a warp-shuffle reduction per
// (row, rhs) ends the walk.
//
// Three kernels, chosen by the number of right-hand sides r and the shape:
// * r = 1 (every matvec of the banded eigensolve): bsr_spmv_vec_kernel.
//   8 warps a CTA; each lane loads 16 bytes at a time (two complex64
//   elements, or one complex128) and starts the loads of all its rows
//   together.  x is read straight through the read-only cache (64 KB at
//   n = 8192, resident in L2), so a block costs no barrier.  Rows per warp
//   (2 for complex64, 4 for complex128) were picked on the H100 at the
//   tok8192 operator: more warps in flight beat more rows per warp.  At
//   bs 128 that is 64 x 8 = 512 CTAs (complex64).  An odd bs, or a pointer
//   not 16-byte aligned, takes element-sized loads.
// * r > 1, complex64, even bs, 16-byte aligned blocks: bsr_spmm_ring_kernel.
//   At r = 16 the float32 work (8 flops a complex multiply-add, 3.9 GFLOP
//   at the tok8192 operator, 58 us at 67 TFLOP/s) is almost level with the
//   bytes (241 MB of blocks, 72 us at 3.35 TB/s), so the kernel has to keep
//   both pipes busy.  Its design:
//   - one pass over the stored blocks for 16 right-hand sides (more are
//     tiled by 16 on grid.y); bsr_pack_x_kernel first repacks x, zero
//     padded, to (tiles, n, 18), so that a block's x segment is one
//     contiguous span whose rows start 16 bytes apart modulo the banks;
//   - a ring of two stages in shared memory, filled by
//     one-dimensional bulk copies (cp.async.bulk, TMA without a tensor
//     map) that complete on an mbarrier a stage: thread 0 starts two
//     copies a stage, the tile's rows of a block (one span, blocks are
//     row-major) and the block's x segment, one stage ahead of the stage
//     the warps multiply; a warp releases a stage through a second
//     mbarrier, which thread 0 waits for before it fills the stage again.
//     (A first version copied row by row into padded rows: 33 copies a
//     stage took one thread longer than the multiplication.  A second kept
//     a ninth warp for the copies: three warps on one of the SM's four
//     schedulers cap every thread at 168 registers, and the multiply loop
//     then waits for each shared-memory load; with eight warps the loop
//     has the registers to keep its loads ahead.)  The reads from shared
//     memory stay free of bank conflicts because the lanes that read
//     different rows also read different columns;
//   - a thread owns 8 rows x 8 right-hand sides of the CTA's 64 x 16
//     outputs and one slice of the columns, sums
//     over its columns in registers (8 + 8 words read from shared memory
//     for 64 complex multiply-adds), and the slices are summed once at the
//     end of the block row, by shuffles inside a warp and through shared
//     memory across warps, in a fixed order: no atomics, two runs repeat
//     bit for bit;
//   - float32 FMAs on the CUDA cores; no TF32, no wgmma.
//   The launch shape (64 rows a CTA, 2 stages, 8 warps, 8 x 8 micro-tiles)
//   won a sweep on the H100 over 16 / 32 / 64 rows, 2 to 4 stages, 8 / 16
//   warps and 4- / 8-row micro-tiles.  A block too large for two stages of
//   the ring (bs above 176) goes to the generic kernel.
// * any other r > 1 (complex128, an odd bs, unaligned blocks):
//   bsr_spmv_tile_kernel stages each block's x segment (RT = 8 right-hand
//   sides) in shared memory behind two barriers and tiles r by 8; 32 rows a
//   CTA.
//
// What bounds it: device memory.  Every stored block is read once per
// matvec (per 16 right-hand sides on the ring kernel, per 8 on the generic
// one): 241 MB of complex64 blocks at the tok8192 operator, about 72 us at
// 3.35 TB/s; x and y are a few hundred KB.
//
// Templates on float2 (complex64) and double2 (complex128); both accumulate
// in their own element type.  x and y are (n, r) row-major.  The kernels
// allocate nothing and do not synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;   // the r = 1 and the generic kernel: 8 warps a CTA
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;                    // r > 1, generic
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

// ---------------------------------------------------------------------------
// r > 1, complex64: the ring kernel.

constexpr int kRhsTile = 16;     // right-hand sides per pass over the blocks
constexpr int kMicroRows = 8;    // a thread's outputs: 8 rows x
constexpr int kMicroRhs = 8;     //   8 right-hand sides
constexpr int kSpmmRows = 64;    // rows of a block row a CTA owns
constexpr int kStages = 2;       // ring depth
constexpr int kRowGroups = kSpmmRows / kMicroRows;
constexpr int kCombos = kRowGroups * (kRhsTile / kMicroRhs);   // micro-tiles
constexpr int kRingWarps = 8;
constexpr int kRingThreads = kRingWarps * 32;
constexpr int kSlices = kRingThreads / kCombos;  // column slices a CTA
// elements of a row of the packed x: 16 right-hand sides and 2 of padding,
// 144 bytes, so that the rows of neighbouring columns start 16 bytes apart
// modulo the 128 bytes of the shared-memory banks
constexpr int kXRow = kRhsTile + 2;
constexpr int kBarBytes = 128;   // full[kStages], empty[kStages] mbarriers
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block can use
static_assert(kSpmmRows % kMicroRows == 0 && kCombos <= 32
              && 32 % kCombos == 0, "a warp holds whole sets of micro-tiles");
static_assert(kStages >= 2 && 16 * kStages <= kBarBytes, "ring depth");

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed.  A wait of
// more than about two seconds can only be a lost arrival: trap, so that a
// fault of the barrier discipline is an error and not a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > 4000000000LL) __trap();
  } while (!done);
}

// One-dimensional bulk copy global -> shared; dst, src and bytes are
// multiples of 16.  Completes `bytes` of the barrier's transaction count.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// x (n, r) -> xp (tiles, n, kXRow): 16 right-hand sides a row, zero padded
// past r, and two elements of padding a row (see kXRow).
__global__ void bsr_pack_x_kernel(const float2* __restrict__ x,
                                  float2* __restrict__ xp, int n, int r,
                                  int tiles) {
  const size_t total = static_cast<size_t>(tiles) * n * kXRow;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(e % kXRow);
    const size_t j = (e / kXRow) % n;
    const int col = static_cast<int>(e / (static_cast<size_t>(kXRow) * n))
                        * kRhsTile + c;
    xp[e] = c < kRhsTile && col < r ? x[j * r + col] : float2{0.f, 0.f};
  }
}

// grid: (nb * row_tiles, ceil(r / 16)); block: kRingThreads; dynamic shared
// memory: kBarBytes, then the ring of kStages stages, each kSpmmRows rows of
// a block and its (bs, kXRow) x segment.  The cross-warp sum at the end
// reuses the ring.
__global__ void __launch_bounds__(kRingThreads)
bsr_spmm_ring_kernel(const float2* __restrict__ data,
                     const int* __restrict__ col_idx,
                     const int* __restrict__ row_ptr,
                     const float2* __restrict__ xp, float2* __restrict__ y,
                     int bs, int n, int r, int row_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rb = blockIdx.x / row_tiles;
  const int row0 = (blockIdx.x - rb * row_tiles) * kSpmmRows;
  const int nrows = min(kSpmmRows, bs - row0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const uint32_t row_bytes = bs * sizeof(float2);
  const uint32_t a_bytes = kSpmmRows * row_bytes;
  const uint32_t x_bytes = bs * kXRow * sizeof(float2);
  const uint32_t stage_bytes = a_bytes + x_bytes;
  const uint32_t smem_base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t full0 = smem_base, empty0 = smem_base + kBarBytes / 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);             // thread 0's expect_tx
      mbar_init(empty0 + 8 * s, kRingWarps);   // one a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int k0 = row_ptr[rb];
  const int nblk = row_ptr[rb + 1] - k0;

  // thread 0 fills the ring: block `it` of the row goes into stage
  // it % kStages once every warp has released that stage's last block
  const float2* src = data + (static_cast<size_t>(k0) * bs + row0) * bs;
  const float2* xsrc = xp + static_cast<size_t>(blockIdx.y) * n * kXRow;
  auto fill = [&](int it) {
    const int s = it % kStages;
    const uint32_t use = it / kStages;   // times this stage was filled
    if (use > 0) mbar_wait(empty0 + 8 * s, (use - 1) & 1);
    const uint32_t full = full0 + 8 * s;
    // two copies a stage: the tile's rows of the block are one span, and
    // so is the block's x segment
    mbar_expect_tx(full, nrows * row_bytes + x_bytes);
    const uint32_t dst = smem_base + kBarBytes + s * stage_bytes;
    bulk_load(dst, src + static_cast<size_t>(it) * bs * bs, nrows * row_bytes,
              full);
    bulk_load(dst + a_bytes,
              xsrc + static_cast<size_t>(col_idx[k0 + it]) * bs * kXRow,
              x_bytes, full);
  };
  if (threadIdx.x == 0)
    for (int it = 0; it < kStages - 1 && it < nblk; ++it) fill(it);

  // Lanes of a warp: kCombos micro-tiles x 32 / kCombos slices.
  // A slice is `per` neighbouring columns; a thread walks its slice's
  // columns starting rg columns in, so that the lanes of a half-warp, which
  // read rows a multiple of the row length apart, read different columns
  // (different banks), and the x rows they read, kXRow elements apart, lie
  // in different banks too.
  const int combo = lane % kCombos;
  const int rg = combo / (kRhsTile / kMicroRhs);
  const int cg = combo % (kRhsTile / kMicroRhs);
  const int slice = warp * (32 / kCombos) + lane / kCombos;
  const int per = (bs + kSlices - 1) / kSlices;
  const int j0 = slice * per;
  const int first = rg % per;

  float2 acc[kMicroRows][kMicroRhs];
#pragma unroll
  for (int q = 0; q < kMicroRows; ++q)
#pragma unroll
    for (int c = 0; c < kMicroRhs; ++c) acc[q][c] = float2{0.f, 0.f};

  for (int it = 0; it < nblk; ++it) {
    const int s = it % kStages;
    if (threadIdx.x == 0 && it + kStages - 1 < nblk) fill(it + kStages - 1);
    __syncwarp();
    mbar_wait(full0 + 8 * s, (it / kStages) & 1);
    const unsigned char* at = smem + kBarBytes + s * stage_bytes
                              + rg * row_bytes;
    const unsigned char* xt = at - rg * row_bytes + a_bytes
                              + cg * kMicroRhs * sizeof(float2);
#pragma unroll 2
    for (int i = 0; i < per; ++i) {
      const int j = j0 + (first + i < per ? first + i : first + i - per);
      if (j < bs) {
        float2 a[kMicroRows];
#pragma unroll
        for (int q = 0; q < kMicroRows; ++q)
          a[q] = *reinterpret_cast<const float2*>(
              at + q * kRowGroups * row_bytes + j * sizeof(float2));
        const float4* xr = reinterpret_cast<const float4*>(
            xt + j * kXRow * sizeof(float2));
#pragma unroll
        for (int c2 = 0; c2 < kMicroRhs / 2; ++c2) {
          const float4 xv = xr[c2];
#pragma unroll
          for (int q = 0; q < kMicroRows; ++q) {
            cfma(acc[q][2 * c2], a[q], float2{xv.x, xv.y});
            cfma(acc[q][2 * c2 + 1], a[q], float2{xv.z, xv.w});
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  // the warp's slices, then the warps, in a fixed order
#pragma unroll
  for (int off = kCombos; off < 32; off <<= 1)
#pragma unroll
    for (int q = 0; q < kMicroRows; ++q)
#pragma unroll
      for (int c = 0; c < kMicroRhs; ++c) {
        acc[q][c].x += __shfl_xor_sync(0xffffffffu, acc[q][c].x, off);
        acc[q][c].y += __shfl_xor_sync(0xffffffffu, acc[q][c].y, off);
      }
  __syncthreads();   // every warp has read its last stage: the ring is free
  float2* red = reinterpret_cast<float2*>(smem + kBarBytes);
  if (lane < kCombos) {
#pragma unroll
    for (int q = 0; q < kMicroRows; ++q)
#pragma unroll
      for (int c = 0; c < kMicroRhs; ++c)
        red[(warp * kSpmmRows + q * kRowGroups + rg) * kRhsTile
            + cg * kMicroRhs + c] = acc[q][c];
  }
  __syncthreads();
  const int c0 = blockIdx.y * kRhsTile;
  for (int o = threadIdx.x; o < kSpmmRows * kRhsTile; o += kRingThreads) {
    const int row = o / kRhsTile;
    const int c = o - row * kRhsTile;
    float2 sum = red[o];
#pragma unroll
    for (int w = 1; w < kRingWarps; ++w) {
      const float2 v = red[w * kSpmmRows * kRhsTile + o];
      sum.x += v.x;
      sum.y += v.y;
    }
    if (row < nrows && c0 + c < r)
      y[(static_cast<size_t>(rb) * bs + row0 + row) * r + c0 + c] = sum;
  }
}

// Bytes of one stage of the ring at block size bs.
size_t ring_stage_bytes(int bs) {
  return (static_cast<size_t>(kSpmmRows) * bs + static_cast<size_t>(bs) * kXRow)
         * sizeof(float2);
}

// The ring kernel's launch: bsr_pack_x_kernel fills the scratch `xp`,
// ceil(r / 16) * n * kXRow elements, first.
int launch_ring(const float2* data, const int* col_idx, const int* row_ptr,
                const float2* x, float2* xp, float2* y, int nb, int bs, int r,
                cudaStream_t stream) {
  const int n = nb * bs;
  const int tiles = (r + kRhsTile - 1) / kRhsTile;
  const size_t stage_bytes = ring_stage_bytes(bs);
  const size_t red_bytes =
      static_cast<size_t>(kRingWarps) * kSpmmRows * kRhsTile * sizeof(float2);
  const size_t ring_bytes = kStages * stage_bytes;
  const size_t smem_bytes =
      kBarBytes + (ring_bytes > red_bytes ? ring_bytes : red_bytes);
  if (smem_bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // set at every launch: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      bsr_spmm_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(tiles) * n * kXRow;
  const int blocks = static_cast<int>((total + 255) / 256);
  bsr_pack_x_kernel<<<blocks < 2048 ? blocks : 2048, 256, 0, stream>>>(
      x, xp, n, r, tiles);
  const int row_tiles = (bs + kSpmmRows - 1) / kSpmmRows;
  const dim3 grid(nb * row_tiles, tiles);
  bsr_spmm_ring_kernel<<<grid, kRingThreads, smem_bytes, stream>>>(
      data, col_idx, row_ptr, xp, y, bs, n, r, row_tiles);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The ring kernel takes complex64 with an even block (rows are multiples
// of 16 bytes) whose ring fits in shared memory, and 16-byte aligned blocks.
bool ring_takes(int dtype, const void* data, int bs, int r) {
  return dtype == 0 && r > 1 && bs % 2 == 0 && aligned16(data)
         && kBarBytes + kStages * ring_stage_bytes(bs) <= kMaxSmem;
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
// x, y: (nb * bs, r) row-major, all on the device.  xp: 16-byte aligned
// scratch of bsr_spmm_scratch_elems() elements where that is not 0 (the
// ring kernel), else null (the r = 1 and the generic kernel).  Returns
// cudaGetLastError() after the launch (0 on success).
int bsr_spmv_launch(int dtype, const void* data, const int* col_idx,
                    const int* row_ptr, const void* x, void* xp, void* y,
                    int nb, int bs, int r, void* stream) {
  if (nb < 1 || bs < 1 || bs > kMaxBlock || r < 1 || r > 65535 * 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xp != nullptr) {
    if (!ring_takes(dtype, data, bs, r) || !aligned16(xp) || xp == x)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_ring(static_cast<const float2*>(data), col_idx, row_ptr,
                       static_cast<const float2*>(x),
                       static_cast<float2*>(xp), static_cast<float2*>(y), nb,
                       bs, r, s);
  }
  if (dtype == 0)
    return launch<float2>(data, col_idx, row_ptr, x, y, nb, bs, r, s);
  if (dtype == 1)
    return launch<double2>(data, col_idx, row_ptr, x, y, nb, bs, r, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int bsr_spmv_max_block() { return kMaxBlock; }

// Elements of scratch the launch needs for these arguments: those of the
// repacked x where the ring kernel takes the shape, else 0.
long long bsr_spmm_scratch_elems(int dtype, const void* data, int nb, int bs,
                                 int r) {
  if (!ring_takes(dtype, data, bs, r)) return 0;
  return static_cast<long long>((r + kRhsTile - 1) / kRhsTile) * nb * bs
         * kXRow;
}

}  // extern "C"
