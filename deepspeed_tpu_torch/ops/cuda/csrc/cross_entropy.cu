// Fused cross-entropy over the tied lm head for Hopper (sm_90a): the
// forward (per-row nll and lse), dx and dhead.
//
// Replaces ops/pallas/cross_entropy.py:_fwd_kernel, :_bwd_dx_kernel and
// :_bwd_dh_kernel of the JAX package.  With s = x . head^T summed in fp32,
// and pad columns (vocab_size <= col < V) set to -1e9 as the JAX kernels
// set them:
//     forward: lse_i = log sum_v exp(s_iv),  nll_i = lse_i - s_i,label_i
//     dx:      dx    = ds . head
//     dhead:   dhead = ds^T . x,  ds_iv = (exp(s_iv - lse_i) - [v == label_i]) * g
// where g = dloss / N is read from device memory.  No [N, V] tensor ever
// reaches device memory: each kernel recomputes its score tiles from
// (x, head) in shared memory, as the TPU kernels do in VMEM.
//
// Bound: operations.  At GPT-2's training shape (N 2048, E 768, V 50304)
// one score pass is 2*N*E*V = 158 GFLOP; the forward does one, dx and
// dhead two each (a recomputed score pass and their own product).  Their
// inputs are a few MB, so the floor is those flops over the tensor-core
// rate in bf16 (989 TFLOP/s) and over the fp32 rate (67 TFLOP/s) for fp32.
//
// Design (simple and correct first; wgmma, TMA and a pipelined stream are
// later work):
// * bf16 products use wmma (mma.sync 16x16x16, fp32 accumulate) from
//   shared-memory tiles; fp32 inputs use fp32 FMA on the CUDA cores (no
//   TF32).  bf16 tiles are staged with cp.async, so each thread's 16-byte
//   copies are all in flight before it waits.
// * forward: grid (row tiles of 128, vocab splits).  score_tile() computes
//   a 128 x 128 block of s, staging x and head in steps of 32 columns.
//   Each block walks its split's vocab tiles with the online softmax
//   (running max, sum, label logit; two threads per row).  The block that
//   finishes a row tile last (an atomic counter per row tile) folds the
//   splits' partials in split order, so the result does not depend on
//   which block ends first.
// * dx and dhead are one kernel, ce_bwd_kernel<T, kDhead>.  A block owns
//   32 "resident" rows of all 768 columns (x rows for dx, head rows for
//   dhead), staged once in shared memory, and an fp32 accumulator
//   [32 x 768] in registers (each warp owns 96 columns).  It streams the
//   other operand (head rows for dx, x rows for dhead) in tiles of 64
//   (bf16) or 16 (fp32) full rows: each tile is staged once and serves both
//   the score product s = resident . tile^T and the update acc += ds . tile,
//   with ds rounded to the input dtype, as the autograd of JAX's unchunked
//   branch rounds it.
// * dx: grid (row tiles of 32, vocab splits); the splits' fp32 partials are
//   summed in split order by the last block of the row tile.  dhead: one
//   block per 32 vocab rows walks every row of x: no atomics, so fp32
//   results are deterministic.  The backward kernel is compiled for n_embd
//   768 (GPT-2) only; the wrapper raises on another.
// * rows past N and vocab rows past V are masked, never padded in memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;                      // E columns per step of the forward's score product
constexpr int kAccE = 768;                   // n_embd of the backward kernel
constexpr int kRes = 32;                     // resident rows of a backward block
constexpr int kWarpCols = kAccE / kWarps;    // 96 accumulator columns per warp
constexpr float kPadLogit = -1e9f;

constexpr int kFwdRows = 128, kFwdCols = 128;

static_assert(kWarpCols % 16 == 0 && kRes % 16 == 0, "wmma tiling");

template <typename T> struct Cfg;
template <> struct Cfg<bf16> {
  static constexpr int kLd = kBK + 8;          // forward staging stride (wmma: multiple of 8)
  static constexpr int kStream = 64;           // streamed rows per backward tile
  static constexpr int kLdA = kRes + 8;        // ds tile stride
  static constexpr int kLdB = kAccE + 8;       // full-row tile stride
};
template <> struct Cfg<float> {
  static constexpr int kLd = kBK + 1;          // odd stride: conflict-free column reads
  static constexpr int kStream = 16;
  static constexpr int kLdA = kRes + 4;
  static constexpr int kLdB = kAccE + 4;
};

template <typename T> constexpr bool kIsBf16 = std::is_same<T, bf16>::value;

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) & ~size_t(127); }

// 16 bytes global -> shared without a register round trip, so a thread's
// copies are all in flight at once; an invalid source fills zeros.
__device__ __forceinline__ void copy16_async(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

// Wait for this thread's async copies (a barrier then publishes them).
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float masked(float s, int col, int vocab_size) {
  return col < vocab_size ? s : kPadLogit;
}

// True in the block that arrives last at `counter` (of `expected`); that
// block then sees every other block's global writes (read them with
// __ldcg, past the incoherent L1).
__device__ bool last_block(int* counter, int expected) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counter, 1) == expected - 1;
  __syncthreads();
  return is_last != 0;
}

// --------------------------------------------------------------------------
// forward
// --------------------------------------------------------------------------

// Shared memory of the forward: the score tile s and its two staging tiles.
template <typename T>
struct FwdLayout {
  static constexpr size_t kA = align128(sizeof(float) * kFwdRows * (kFwdCols + 4));
  static constexpr size_t kB = kA + align128(sizeof(T) * kFwdRows * Cfg<T>::kLd);
  static constexpr size_t kBytes = kB + align128(sizeof(T) * kFwdCols * Cfg<T>::kLd);
};

// dst[r][0 : kBK) = src[row0 + r][k0 : k0 + kBK) for r < ROWS; rows at or
// past nrows are zeros.  bf16 copies are asynchronous: wait_copies() and a
// barrier before reading dst.
template <typename T, int ROWS>
__device__ __forceinline__ void stage_k(const T* __restrict__ src, int row0, int nrows, int e,
                                        int k0, T* __restrict__ dst) {
  constexpr int kLd = Cfg<T>::kLd;
  if constexpr (kIsBf16<T>) {
    constexpr int kVecs = kBK / 8;
    for (int i = threadIdx.x; i < ROWS * kVecs; i += kThreads) {
      const int r = i / kVecs, part = i % kVecs;
      const bool valid = row0 + r < nrows;
      copy16_async(dst + r * kLd + part * 8,
                   valid ? src + (size_t)(row0 + r) * e + k0 + part * 8 : src, valid);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * kBK; i += kThreads) {
      const int r = i / kBK, k = i % kBK;
      dst[r * kLd + k] = row0 + r < nrows ? src[(size_t)(row0 + r) * e + k0 + k] : 0.f;
    }
  }
}

// s[BM][BN + 4] = x[row0 : row0 + BM] . head[col0 : col0 + BN]^T over all e
// columns, fp32 sums.  x rows past n and head rows past v count as zeros.
// Ends with a barrier, so s is ready for every thread.
template <typename T, int BM, int BN, int WM>
__device__ void score_tile(const T* __restrict__ x, const T* __restrict__ head, int row0, int n,
                           int col0, int v, int e, T* __restrict__ a, T* __restrict__ b,
                           float* __restrict__ s) {
  constexpr int kLd = Cfg<T>::kLd;
  constexpr int kLdS = BN + 4;
  if constexpr (kIsBf16<T>) {
    constexpr int WN = kWarps / WM;
    constexpr int FM = BM / (WM * 16), FN = BN / (WN * 16);
    static_assert(FM * WM * 16 == BM && FN * WN * 16 == BN, "warp tiling");
    const int warp = threadIdx.x / 32, wm = warp / WN, wn = warp % WN;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int k0 = 0; k0 < e; k0 += kBK) {
      stage_k<T, BM>(x, row0, n, e, k0, a);
      stage_k<T, BN>(head, col0, v, e, k0, b);
      wait_copies();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[FN];
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::load_matrix_sync(af[i], a + (wm * FM + i) * 16 * kLd + kk, kLd);
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::load_matrix_sync(bfr[j], b + (wn * FN + j) * 16 * kLd + kk, kLd);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(s + (wm * FM + i) * 16 * kLdS + (wn * FN + j) * 16, acc[i][j],
                                kLdS, wmma::mem_row_major);
  } else {
    // thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j
    constexpr int RM = BM / 16, RN = BN / 16;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < e; k0 += kBK) {
      stage_k<T, BM>(x, row0, n, e, k0, a);
      stage_k<T, BN>(head, col0, v, e, k0, b);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kBK; ++k) {
        float av[RM], bv[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) av[i] = a[(ty + 16 * i) * kLd + k];
#pragma unroll
        for (int j = 0; j < RN; ++j) bv[j] = b[(tx + 16 * j) * kLd + k];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[(ty + 16 * i) * kLdS + tx + 16 * j] = acc[i][j];
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ x, const T* __restrict__ head, const int* __restrict__ labels,
              float* __restrict__ part, int* __restrict__ counters, float* __restrict__ nll,
              float* __restrict__ lse, int n, int e, int v, int vocab_size, int per_split) {
  constexpr int BM = kFwdRows, BN = kFwdCols, kLdS = BN + 4, kHalf = BN / 2;
  using L = FwdLayout<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s = reinterpret_cast<float*>(smem);
  T* a = reinterpret_cast<T*>(smem + L::kA);
  T* b = reinterpret_cast<T*>(smem + L::kB);

  const int row0 = blockIdx.x * BM, split = blockIdx.y, splits = gridDim.y;
  const int t_begin = split * per_split;
  const int t_end = min(t_begin + per_split, (v + BN - 1) / BN);
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;   // two threads per row
  const int row = row0 + r;
  const int label = row < n ? labels[row] : -1;
  float m = -INFINITY, l = 0.f, ll = 0.f;
  for (int t = t_begin; t < t_end; ++t) {
    const int col0 = t * BN;
    score_tile<T, BM, BN, 2>(x, head, row0, n, col0, v, e, a, b, s);
    const float* srow = s + r * kLdS + half * kHalf;
    const int c0 = col0 + half * kHalf;
    float tmax = -INFINITY;
    for (int c = 0; c < kHalf && c0 + c < v; ++c)
      tmax = fmaxf(tmax, masked(srow[c], c0 + c, vocab_size));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    float sum = 0.f, lab = 0.f;
    for (int c = 0; c < kHalf && c0 + c < v; ++c) {
      const float sv = masked(srow[c], c0 + c, vocab_size);
      sum += expf(sv - m_new);
      if (c0 + c == label) lab += sv;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    lab += __shfl_xor_sync(0xffffffffu, lab, 1);
    l = l * expf(m - m_new) + sum;
    ll += lab;
    m = m_new;
    __syncthreads();   // s is rewritten by the next tile
  }
  if (half == 0 && row < n) {
    part[((size_t)split * 3 + 0) * n + row] = m;
    part[((size_t)split * 3 + 1) * n + row] = l;
    part[((size_t)split * 3 + 2) * n + row] = ll;
  }
  if (!last_block(counters + blockIdx.x, splits)) return;
  for (int rr = threadIdx.x; rr < BM; rr += kThreads) {
    const int row2 = row0 + rr;
    if (row2 >= n) continue;
    float mm = -INFINITY;
    for (int j = 0; j < splits; ++j) mm = fmaxf(mm, __ldcg(part + ((size_t)j * 3) * n + row2));
    float ls = 0.f, lls = 0.f;
    for (int j = 0; j < splits; ++j) {
      const float mj = __ldcg(part + ((size_t)j * 3) * n + row2);
      const float lj = __ldcg(part + ((size_t)j * 3 + 1) * n + row2);
      if (lj > 0.f) ls += lj * expf(mj - mm);
      lls += __ldcg(part + ((size_t)j * 3 + 2) * n + row2);
    }
    const float lse_r = mm + logf(ls);
    lse[row2] = lse_r;
    nll[row2] = lse_r - lls;
  }
}

// --------------------------------------------------------------------------
// backward (dx and dhead)
// --------------------------------------------------------------------------

// Shared memory of the backward kernel: the score tile s [kRes][BN + 4]
// fp32, the ds tile held k-major (at[j][i]: streamed row j, resident row
// i), the resident rows, the streamed tile, and one 16x16 fp32 scratch per
// warp for the accumulator's store.
template <typename T>
struct BwdLayout {
  static constexpr int BN = Cfg<T>::kStream;
  static constexpr size_t kAt = align128(sizeof(float) * kRes * (BN + 4));
  static constexpr size_t kR = kAt + align128(sizeof(T) * BN * Cfg<T>::kLdA);
  static constexpr size_t kT = kR + align128(sizeof(T) * kRes * Cfg<T>::kLdB);
  static constexpr size_t kScratch = kT + align128(sizeof(T) * BN * Cfg<T>::kLdB);
  static constexpr size_t kBytes = kScratch + align128(sizeof(float) * kWarps * 256);
};

// dst[r][0 : kAccE) = src[row0 + r] for r < ROWS (row stride kLdB); rows
// at or past nrows are zeros.
template <typename T, int ROWS>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int row0, int nrows,
                                           T* __restrict__ dst) {
  constexpr int kPer = 16 / sizeof(T);               // elements per 16-byte load
  constexpr int kVecs = kAccE / kPer;
  constexpr int kLdB = Cfg<T>::kLdB;
  for (int i = threadIdx.x; i < ROWS * kVecs; i += kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * kPer;
    const bool valid = row0 + r < nrows;
    copy16_async(dst + r * kLdB + c, valid ? src + (size_t)(row0 + r) * kAccE + c : src, valid);
  }
  wait_copies();
}

// s[i][j] = res[i] . tile[j] over kAccE columns (fp32 sums), i < kRes,
// j < kStream; both operands staged with row stride kLdB.
template <typename T>
__device__ __forceinline__ void score_rows(const T* __restrict__ res, const T* __restrict__ tile,
                                           float* __restrict__ s) {
  constexpr int BN = Cfg<T>::kStream, kLdB = Cfg<T>::kLdB, kLdS = BN + 4;
  if constexpr (kIsBf16<T>) {
    // one 16x16 block of s per warp: 2 x 4 blocks for 8 warps
    static_assert((kRes / 16) * (BN / 16) == kWarps, "one score block per warp");
    // kChains independent accumulators over interleaved k steps, so
    // consecutive mma do not wait on each other; summed at the end
    constexpr int kChains = 4;
    const int warp = threadIdx.x / 32, fi = warp / (BN / 16), fj = warp % (BN / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) wmma::fill_fragment(acc[c], 0.f);
    for (int k = 0; k < kAccE; k += 16 * kChains) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(af, res + fi * 16 * kLdB + k + 16 * c, kLdB);
        wmma::load_matrix_sync(bfr, tile + fj * 16 * kLdB + k + 16 * c, kLdB);
        wmma::mma_sync(acc[c], af, bfr, acc[c]);
      }
    }
#pragma unroll
    for (int c = 1; c < kChains; ++c)
#pragma unroll
      for (int t = 0; t < acc[0].num_elements; ++t) acc[0].x[t] += acc[c].x[t];
    wmma::store_matrix_sync(s + fi * 16 * kLdS + fj * 16, acc[0], kLdS, wmma::mem_row_major);
  } else {
    // two entries of s per thread: row i, columns j and j + BN / 2; a warp
    // reads 4 resident rows and 8 tile rows per k, in distinct banks
    static_assert(kRes * BN == 2 * kThreads, "two score entries per thread");
    const int i = threadIdx.x / (BN / 2), j = threadIdx.x % (BN / 2);
    const float* ri = res + i * kLdB;
    const float* t0 = tile + j * kLdB;
    const float* t1 = t0 + (BN / 2) * kLdB;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
    for (int k = 0; k < kAccE; ++k) {
      const float rv = ri[k];
      a0 = fmaf(rv, t0[k], a0);
      a1 = fmaf(rv, t1[k], a1);
    }
    s[i * kLdS + j] = a0;
    s[i * kLdS + j + BN / 2] = a1;
  }
}

// The [kRes x kAccE] fp32 accumulator of a backward block:
// acc += A . B, with A [kRes x k] held k-major in shared memory (at[k][m])
// and B [k x kAccE] the streamed tile.
template <typename T> struct Acc;

template <> struct Acc<bf16> {
  static constexpr int FM = kRes / 16, FN = kWarpCols / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[FM][FN];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(f[i][j], 0.f);
  }

  // k rows [0, kStream) of at against the streamed tile bb
  __device__ void mma(const bf16* __restrict__ at, const bf16* __restrict__ bb) {
    constexpr int kLdA = Cfg<bf16>::kLdA, kLdB = Cfg<bf16>::kLdB;
    const int col0 = (threadIdx.x / 32) * kWarpCols;
#pragma unroll 2
    for (int kk = 0; kk < Cfg<bf16>::kStream; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i) wmma::load_matrix_sync(af[i], at + kk * kLdA + i * 16, kLdA);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, bb + kk * kLdB + col0 + j * 16, kLdB);
#pragma unroll
        for (int i = 0; i < FM; ++i) wmma::mma_sync(f[i][j], af[i], bfr, f[i][j]);
      }
    }
  }

  // out[r][c] (row stride kAccE) for r < rows, through this warp's 16x16
  // fp32 scratch
  template <typename O>
  __device__ void store(O* __restrict__ out, int rows, float* __restrict__ scratch) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float* st = scratch + warp * 256;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::store_matrix_sync(st, f[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int idx = lane; idx < 256; idx += 32) {
          const int r = i * 16 + idx / 16, c = warp * kWarpCols + j * 16 + idx % 16;
          if (r < rows) out[(size_t)r * kAccE + c] = from_f<O>(st[idx]);
        }
        __syncwarp();
      }
  }
};

template <> struct Acc<float> {
  // thread (ty, tx) owns rows ty + 8 i and columns tx + 32 j
  static constexpr int RM = kRes / 8, RN = kAccE / 32;
  float f[RM][RN];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) f[i][j] = 0.f;
  }

  __device__ void mma(const float* __restrict__ at, const float* __restrict__ bb) {
    constexpr int kLdA = Cfg<float>::kLdA, kLdB = Cfg<float>::kLdB;
    const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
#pragma unroll 2
    for (int k = 0; k < Cfg<float>::kStream; ++k) {
      float av[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = at[k * kLdA + ty + 8 * i];
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float bv = bb[k * kLdB + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i) f[i][j] = fmaf(av[i], bv, f[i][j]);
      }
    }
  }

  template <typename O>
  __device__ void store(O* __restrict__ out, int rows, float* /*scratch*/) {
    const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 8 * i;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < RN; ++j) out[(size_t)r * kAccE + tx + 32 * j] = from_f<O>(f[i][j]);
    }
  }
};

// dx (kDhead false): resident rows are x rows [res0, res0 + 32) of n, the
// streamed tiles are head rows (vocab) from tile t_begin to t_end; the
// block writes its fp32 partial [32 x 768] of split blockIdx.y, and the
// last block of the row tile sums the splits into dx.
// dhead (kDhead true): resident rows are head rows [res0, res0 + 32) of v,
// the streamed tiles are all rows of x; the block writes dhead directly.
template <typename T, bool kDhead>
__global__ void __launch_bounds__(kThreads)
ce_bwd_kernel(const T* __restrict__ x, const T* __restrict__ head,
              const int* __restrict__ labels, const float* __restrict__ lse,
              const float* __restrict__ gscale, T* __restrict__ out, float* __restrict__ part,
              int* __restrict__ counters, int n, int n_pad, int v, int vocab_size,
              int per_split) {
  constexpr int BN = Cfg<T>::kStream, kLdA = Cfg<T>::kLdA, kLdS = BN + 4;
  using L = BwdLayout<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s = reinterpret_cast<float*>(smem);
  T* at = reinterpret_cast<T*>(smem + L::kAt);
  T* res = reinterpret_cast<T*>(smem + L::kR);
  T* tile = reinterpret_cast<T*>(smem + L::kT);
  float* scratch = reinterpret_cast<float*>(smem + L::kScratch);
  __shared__ float lse_s[kDhead ? BN : kRes];    // per row of x in play
  __shared__ int lab_s[kDhead ? BN : kRes];

  const int res0 = blockIdx.x * kRes;
  const int res_n = kDhead ? v : n;              // rows of the resident operand
  const int str_n = kDhead ? n : v;              // rows of the streamed operand
  const int t_begin = kDhead ? 0 : blockIdx.y * per_split;
  const int t_end = kDhead ? (n + BN - 1) / BN : min(t_begin + per_split, (v + BN - 1) / BN);
  const float g = *gscale;
  stage_rows<T, kRes>(kDhead ? head : x, res0, res_n, res);
  if (!kDhead && threadIdx.x < kRes) {
    const int row = res0 + threadIdx.x;
    lse_s[threadIdx.x] = row < n ? lse[row] : 0.f;
    lab_s[threadIdx.x] = row < n ? labels[row] : -1;
  }
  Acc<T> acc;
  acc.zero();
  for (int t = t_begin; t < t_end; ++t) {
    const int str0 = t * BN;
    stage_rows<T, BN>(kDhead ? x : head, str0, str_n, tile);
    if (kDhead && threadIdx.x < BN) {
      const int row = str0 + threadIdx.x;
      lse_s[threadIdx.x] = row < n ? lse[row] : 0.f;
      lab_s[threadIdx.x] = row < n ? labels[row] : -1;
    }
    __syncthreads();
    score_rows<T>(res, tile, s);
    __syncthreads();
    // ds into at[j][i], the A operand (resident x streamed) held k-major
    for (int idx = threadIdx.x; idx < kRes * BN; idx += kThreads) {
      const int i = idx / BN, j = idx % BN;
      const int row = kDhead ? str0 + j : res0 + i, col = kDhead ? res0 + i : str0 + j;
      const int r = kDhead ? j : i;
      float d = 0.f;
      if (row < n && col < v) {
        const float p = expf(masked(s[i * kLdS + j], col, vocab_size) - lse_s[r]);
        d = (p - (col == lab_s[r] ? 1.f : 0.f)) * g;
      }
      at[j * kLdA + i] = from_f<T>(d);
    }
    __syncthreads();
    acc.mma(at, tile);
    __syncthreads();   // tile, at and the row stats are rewritten by the next tile
  }
  if constexpr (kDhead) {
    acc.store(out + (size_t)res0 * kAccE, min(kRes, v - res0), scratch);
  } else {
    // fp32 partial of this split; part is [splits][n_pad][kAccE]
    const int splits = gridDim.y;
    acc.store(part + ((size_t)blockIdx.y * n_pad + res0) * kAccE, kRes, scratch);
    if (!last_block(counters + blockIdx.x, splits)) return;
    for (int i = threadIdx.x; i < kRes * kAccE; i += kThreads) {
      const int r = i / kAccE, c = i % kAccE, row = res0 + r;
      if (row >= n) continue;
      float sum = __ldcg(part + (size_t)row * kAccE + c);
      for (int j = 1; j < splits; ++j) sum += __ldcg(part + ((size_t)j * n_pad + row) * kAccE + c);
      out[(size_t)row * kAccE + c] = from_f<T>(sum);
    }
  }
}

// --------------------------------------------------------------------------
// launches
// --------------------------------------------------------------------------

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool aligned(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <typename T>
cudaError_t launch_fwd(const void* x, const void* head, const int* labels, float* part,
                       int* counters, float* nll, float* lse, int n, int e, int v, int vocab_size,
                       int splits, cudaStream_t st) {
  const size_t smem = FwdLayout<T>::kBytes;
  cudaError_t err = prepare(ce_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int v_tiles = (v + kFwdCols - 1) / kFwdCols;
  const dim3 grid((n + kFwdRows - 1) / kFwdRows, splits);
  ce_fwd_kernel<T><<<grid, kThreads, smem, st>>>(
      (const T*)x, (const T*)head, labels, part, counters, nll, lse, n, e, v, vocab_size,
      (v_tiles + splits - 1) / splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dx(const void* x, const void* head, const int* labels, const float* lse,
                      const float* gscale, void* dx, float* part, int* counters, int n, int v,
                      int vocab_size, int splits, cudaStream_t st) {
  const size_t smem = BwdLayout<T>::kBytes;
  cudaError_t err = prepare(ce_bwd_kernel<T, false>, smem);
  if (err != cudaSuccess) return err;
  const int row_tiles = (n + kRes - 1) / kRes;
  const int v_tiles = (v + Cfg<T>::kStream - 1) / Cfg<T>::kStream;
  ce_bwd_kernel<T, false><<<dim3(row_tiles, splits), kThreads, smem, st>>>(
      (const T*)x, (const T*)head, labels, lse, gscale, (T*)dx, part, counters, n,
      row_tiles * kRes, v, vocab_size, (v_tiles + splits - 1) / splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* x, const void* head, const int* labels, const float* lse,
                      const float* gscale, void* dh, int n, int v, int vocab_size,
                      cudaStream_t st) {
  const size_t smem = BwdLayout<T>::kBytes;
  cudaError_t err = prepare(ce_bwd_kernel<T, true>, smem);
  if (err != cudaSuccess) return err;
  ce_bwd_kernel<T, true><<<(v + kRes - 1) / kRes, kThreads, smem, st>>>(
      (const T*)x, (const T*)head, labels, lse, gscale, (T*)dh, nullptr, nullptr, n, 0, v,
      vocab_size, 0);
  return cudaGetLastError();
}

bool shape_ok(int n, int e, int v, int vocab_size, int dtype) {
  return n > 0 && e > 0 && e % kBK == 0 && v > 0 && vocab_size > 0 && vocab_size <= v &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Each returns a cudaError_t (0 = launched).
// part: [splits][3][n] fp32 scratch; counters: ceil(n / 128) zeroed ints.
int dst_ce_forward(const void* x, const void* head, const int* labels, float* part,
                   int* counters, float* nll, float* lse, int n, int e, int v, int vocab_size,
                   int splits, int dtype, void* stream) {
  if (!shape_ok(n, e, v, vocab_size, dtype) || splits <= 0 || splits > 65535 || !aligned(x) ||
      !aligned(head))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0 ? launch_fwd<float>(x, head, labels, part, counters, nll, lse, n, e, v,
                                              vocab_size, splits, st)
                          : launch_fwd<bf16>(x, head, labels, part, counters, nll, lse, n, e, v,
                                             vocab_size, splits, st));
}

// part: [splits][ceil(n / 32) * 32][768] fp32 scratch; counters: ceil(n / 32)
// zeroed ints.  gscale: one fp32 on the device (dloss / N).
int dst_ce_backward_dx(const void* x, const void* head, const int* labels, const float* lse,
                       const float* gscale, void* dx, float* part, int* counters, int n, int e,
                       int v, int vocab_size, int splits, int dtype, void* stream) {
  if (!shape_ok(n, e, v, vocab_size, dtype) || e != kAccE || splits <= 0 || splits > 65535 ||
      !aligned(x) || !aligned(head))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0 ? launch_dx<float>(x, head, labels, lse, gscale, dx, part, counters, n,
                                             v, vocab_size, splits, st)
                          : launch_dx<bf16>(x, head, labels, lse, gscale, dx, part, counters, n,
                                            v, vocab_size, splits, st));
}

int dst_ce_backward_dhead(const void* x, const void* head, const int* labels, const float* lse,
                          const float* gscale, void* dh, int n, int e, int v, int vocab_size,
                          int dtype, void* stream) {
  if (!shape_ok(n, e, v, vocab_size, dtype) || e != kAccE || !aligned(x) || !aligned(head))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0
                   ? launch_dh<float>(x, head, labels, lse, gscale, dh, n, v, vocab_size, st)
                   : launch_dh<bf16>(x, head, labels, lse, gscale, dh, n, v, vocab_size, st));
}

}  // extern "C"
