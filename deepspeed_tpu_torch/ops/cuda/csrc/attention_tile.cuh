// Tile code shared by the attention kernels for Hopper (sm_90a):
// flash_attention.cu (dense), block_sparse_attention.cu (over a layout's
// lookup tables) and decode_attention.cu (its prefill path).  One 64-row
// tile of a 64-wide head per block of 4 warps, each warp owning 16 of the
// rows:
// * 16-byte cp.async copies of a [64][64] tile from a strided [B, S, H, 64]
//   tensor into shared memory (rows past S zero-filled);
// * c = a . b^T and acc += p . b on [16 x 64] warp tiles, bf16 through
//   mma.sync m16n8k16 (fp32 accumulate) on fragments read by ldmatrix
//   (RowFragments, a warp's own 16 rows held in registers, and pv_tile: the
//   flash and block-sparse kernels and the decode prefill path), fp32
//   through FMA in the same register layout (no TF32: product_nt /
//   product_pv);
// * row stores to contiguous [B, S, heads, 64] outputs.
// A 16 x 64 fp32 tile of a warp lives in registers as c[8][4]: c[j][i] is
// row g + 8 * (i >> 1), column 8 j + 2 t + (i & 1), where g = lane / 4 and
// t = lane % 4 (the mma.m16n8k16 accumulator layout, which is also the
// A-operand layout of the next product, so p and ds go to the tensor cores
// from registers).  The row tiles' helpers (Tr, kTileElems, product_nt,
// product_pv, pv_tile, store_rows, load_rows, RowFragments) also take a
// wider head (a 16 x 128 tile is c[16][4]) for the decode kernels' prefill
// path and the flash kernels at head_dim 128; their default is kD.
// SharedRows is RowFragments without the registers: the rows stay in shared
// memory and each product reads them by ldmatrix (the flash dKV at head_dim
// 96, 128 and 256, where K's and V's fragments would take 64 registers a
// thread beside the 128 of dK and dV at 128; the forward's Q and dQ's Q and
// dO at 256).

#pragma once

#include <math.h>

#include "sm90_primitives.cuh"

namespace {

constexpr int kD = 64;                  // head_dim the kernels are compiled for
constexpr int kTile = 64;               // rows of a query or key tile
constexpr int kWarps = 4;               // 16 rows each
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;       // JAX's NEG_INF: where the running max starts
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;    // dynamic shared memory a block may have (H100)

// shared-memory row pitch of a [row][D] tile: 16 bytes past a multiple of
// 128, so the 8 rows of one ldmatrix (or 8 lanes' float4 reads) hit
// different banks
template <typename T, int D = kD> struct Tr;
template <int D> struct Tr<bf16, D> { static constexpr int kLd = D + 8; };    // 144-byte rows at D 64
template <int D> struct Tr<float, D> { static constexpr int kLd = D + 4; };   // 272-byte rows at D 64

template <typename T, int D = kD> constexpr int kTileElems = kTile * Tr<T, D>::kLd;

// dst[r][0 : kD) = src[(row0 + r) * ss + 0 : kD) for r < kTile; rows at or
// past S are zeros.  Asynchronous: commit, wait and a barrier before reading.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ss, int row0, int S) {
  constexpr int kElems = 16 / sizeof(T);
  constexpr int kChunks = kD / kElems;                     // 16-byte chunks per row
  constexpr int kPer = kTile * kChunks / kThreads;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kChunks, col = (c % kChunks) * kElems;
    const bool valid = row0 + r < S;
    copy16_async(dst + r * Tr<T>::kLd + col, valid ? src + (row0 + r) * ss + col : src, valid);
  }
}

template <int NJ>
__device__ __forceinline__ void zero(float (&c)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
}

// fp32: c = a . b^T for the first 8 NJ rows of b (c's columns), D deep.
template <int NJ, int D = kD>
__device__ __forceinline__ void product_nt(float (&c)[NJ][4], const float* a, const float* b) {
  constexpr int L = Tr<float, D>::kLd;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  zero(c);
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    const float4 lo = *reinterpret_cast<const float4*>(a + g * L + d);
    const float4 hi = *reinterpret_cast<const float4*>(a + (g + 8) * L + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float4 bv = *reinterpret_cast<const float4*>(b + (j * 8 + 2 * t + i) * L + d);
        c[j][i] = fmaf(lo.x, bv.x, c[j][i]);
        c[j][i] = fmaf(lo.y, bv.y, c[j][i]);
        c[j][i] = fmaf(lo.z, bv.z, c[j][i]);
        c[j][i] = fmaf(lo.w, bv.w, c[j][i]);
        c[j][2 + i] = fmaf(hi.x, bv.x, c[j][2 + i]);
        c[j][2 + i] = fmaf(hi.y, bv.y, c[j][2 + i]);
        c[j][2 + i] = fmaf(hi.z, bv.z, c[j][2 + i]);
        c[j][2 + i] = fmaf(hi.w, bv.w, c[j][2 + i]);
      }
  }
}

// fp32: acc += p . b over p's 8 NJ columns (b's first 8 NJ rows); acc is
// 16 x 8 ND, the head's width or, given W (the width of b's rows), the 8 ND
// columns of b from where it points (the flash dKV's column halves at 256).
template <int W = 0, int NJ, int ND>
__device__ __forceinline__ void product_pv(float (&acc)[ND][4], const float (&p)[NJ][4],
                                           const float* b) {
  constexpr int L = Tr<float, W ? W : 8 * ND>::kLd;
  const int lane = threadIdx.x & 31, t = lane & 3, quad = lane & ~3;
#pragma unroll
  for (int jk = 0; jk < NJ; ++jk)
#pragma unroll
    for (int tk = 0; tk < 4; ++tk)
#pragma unroll
      for (int ik = 0; ik < 2; ++ik) {
        const float p_lo = __shfl_sync(kFull, p[jk][ik], quad + tk);
        const float p_hi = __shfl_sync(kFull, p[jk][2 + ik], quad + tk);
        const float* br = b + (jk * 8 + 2 * tk + ik) * L + 2 * t;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          const float2 bv = *reinterpret_cast<const float2*>(br + j * 8);
          acc[j][0] = fmaf(p_lo, bv.x, acc[j][0]);
          acc[j][1] = fmaf(p_lo, bv.y, acc[j][1]);
          acc[j][2] = fmaf(p_hi, bv.x, acc[j][2]);
          acc[j][3] = fmaf(p_hi, bv.y, acc[j][3]);
        }
      }
}

template <typename T> __device__ __forceinline__ void store2(T* dst, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<bf16>(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// out[row][h][0 : kD) = c's rows (scaled by inv[0] / inv[1] for rows g and
// g + 8) for the warp's rows below S; out is contiguous [B, S, heads, kD]
// with its batch and head offset applied.
template <typename T, int ND>
__device__ __forceinline__ void store_rows(T* out, long long row_stride, const float (&c)[ND][4],
                                           int row0, int S, const float (&inv)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= S) continue;
    T* dst = out + r * row_stride + 2 * t;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      store2<T>(dst + j * 8, c[j][2 * half] * inv[half], c[j][2 * half + 1] * inv[half]);
  }
}

// ---- ldmatrix helpers (the decode prefill path and the flash forward) ----

// dst[r][0 : kD) = src[(row0 + r) * ss + 0 : kD) for r < ROWS, by THREADS
// threads; rows at or past S are zeros.  Asynchronous, as load_tile.
template <typename T, int ROWS, int THREADS, int D = kD>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long ss, int row0, int S) {
  constexpr int kElems = 16 / sizeof(T);
  constexpr int kChunks = D / kElems;
  constexpr int kPer = ROWS * kChunks / THREADS;
  static_assert(kPer * THREADS == ROWS * kChunks, "whole 16-byte chunks per thread");
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c / kChunks, col = (c % kChunks) * kElems;
    const bool valid = row0 + r < S;
    copy16_async(dst + r * Tr<T, D>::kLd + col, valid ? src + (row0 + r) * ss + col : src, valid);
  }
}

// A warp's own 16 rows ([row][D] in shared memory) as the A operand of c =
// rows . b^T: the flash forward's and dQ's query (and dO) rows, dKV's key
// (and value) rows.  bf16 fragments are loaded once by ldmatrix and kept in
// registers, b's by ldmatrix per tile (four 8x8 matrices, two mma, per
// instruction); fp32 leaves the rows in shared memory for product_nt.
template <typename T, int D = kD> struct RowFragments;

template <int D> struct RowFragments<bf16, D> {
  uint32_t f[D / 16][4];

  __device__ __forceinline__ void load(const bf16* rows) {
    constexpr int L = Tr<bf16, D>::kLd;
    const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(f[kk], rows + ((mi & 1) * 8 + r8) * L + kk * 16 + (mi >> 1) * 8);
  }

  // c = rows . b^T for the first 8 NJ rows of b ([row][D] in shared
  // memory; NJ even)
  template <int NJ>
  __device__ __forceinline__ void product_nt(float (&c)[NJ][4], const bf16* b) const {
    constexpr int L = Tr<bf16, D>::kLd;
    const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
    zero(c);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t bfr[4];
        ldsm_x4(bfr, b + ((2 * jp + (mi >> 1)) * 8 + r8) * L + kk * 16 + (mi & 1) * 8);
        mma_bf16(c[2 * jp], f[kk][0], f[kk][1], f[kk][2], f[kk][3], bfr[0], bfr[1]);
        mma_bf16(c[2 * jp + 1], f[kk][0], f[kk][1], f[kk][2], f[kk][3], bfr[2], bfr[3]);
      }
  }
};

template <int D> struct RowFragments<float, D> {
  const float* rows;
  __device__ __forceinline__ void load(const float* r) { rows = r; }
  template <int NJ>
  __device__ __forceinline__ void product_nt(float (&c)[NJ][4], const float* b) const {
    ::product_nt<NJ, D>(c, rows, b);
  }
};

// The same A operand left in shared memory: bf16 reads its fragments by
// ldmatrix at every product (one 16-deep slice at a time); fp32 already does.
template <typename T, int D = kD> struct SharedRows : RowFragments<T, D> {};

template <int D> struct SharedRows<bf16, D> {
  const bf16* rows;
  __device__ __forceinline__ void load(const bf16* r) { rows = r; }
  template <int NJ>
  __device__ __forceinline__ void product_nt(float (&c)[NJ][4], const bf16* b) const {
    constexpr int L = Tr<bf16, D>::kLd;
    const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
    zero(c);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, rows + ((mi & 1) * 8 + r8) * L + kk * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t bfr[4];
        ldsm_x4(bfr, b + ((2 * jp + (mi >> 1)) * 8 + r8) * L + kk * 16 + (mi & 1) * 8);
        mma_bf16(c[2 * jp], af[0], af[1], af[2], af[3], bfr[0], bfr[1]);
        mma_bf16(c[2 * jp + 1], af[0], af[1], af[2], af[3], bfr[2], bfr[3]);
      }
    }
  }
};

// acc += p . b: p the warp's 16 x 8 NJ tile in registers (rounded to bf16,
// as JAX's kernels round p to v's dtype and ds to q's), b [8 NJ][kD] in
// shared memory (v or k for rows of queries; do or q for dKV's rows of
// keys), read transposed by ldmatrix.trans.  NJ even; acc is 16 x 8 ND,
// as in product_pv (W: the width of b's rows where acc is narrower).
template <int W = 0, int NJ, int ND>
__device__ __forceinline__ void pv_tile(float (&acc)[ND][4], const float (&p)[NJ][4],
                                        const bf16* b) {
  constexpr int L = Tr<bf16, W ? W : 8 * ND>::kLd;
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    const uint32_t a0 = pack_rn(p[2 * kk][0], p[2 * kk][1]);
    const uint32_t a1 = pack_rn(p[2 * kk][2], p[2 * kk][3]);
    const uint32_t a2 = pack_rn(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    const uint32_t a3 = pack_rn(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int jp = 0; jp < ND / 2; ++jp) {
      uint32_t bfr[4];
      ldsm_x4_trans(bfr, b + (kk * 16 + (mi & 1) * 8 + r8) * L + (2 * jp + (mi >> 1)) * 8);
      mma_bf16(acc[2 * jp], a0, a1, a2, a3, bfr[0], bfr[1]);
      mma_bf16(acc[2 * jp + 1], a0, a1, a2, a3, bfr[2], bfr[3]);
    }
  }
}

template <int W = 0, int NJ, int ND>
__device__ __forceinline__ void pv_tile(float (&acc)[ND][4], const float (&p)[NJ][4],
                                        const float* b) {
  product_pv<W>(acc, p, b);
}


template <typename Kernel, typename P>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, const P& p, cudaStream_t st,
                   int threads = kThreads) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15u) == 0; }

}  // namespace
