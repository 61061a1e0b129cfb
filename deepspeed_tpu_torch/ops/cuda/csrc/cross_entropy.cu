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
// Bound: operations.  At GPT-2's training shape (N 4096, E 768, V 50304)
// one score pass is 2*N*E*V = 317 GFLOP; the forward does one, dx and
// dhead two each (a recomputed score pass and their own product).  Their
// inputs are a few MB, so the floor is those flops over the tensor-core
// rate in bf16 (989 TFLOP/s) and over the fp32 rate (67 TFLOP/s) for fp32.
// Widths: any n_embd E that is a multiple of 8 (rows start on 16-byte
// boundaries); the wrapper raises on any other.  The backward runs in
// thread-block clusters up to 8 x 208 = 1664 columns (GPT-2's 768, 1024,
// 1280 and 1600 all fit) and, past that or with a head bias, through the
// wide path at the end of this file (LLaMA's and BLOOM's 4096).
// Head bias (GPT-J's untied head): the forward adds bias[col] to the fp32
// scores before the label's logit and the pad mask, as the JAX kernels'
// _score_block does; the wide backward's ds pass does the same, and the
// dhead entry point also writes dbias = the sum over rows of the fp32 ds.
//
// Forward, bf16 (ce_fwd_wgmma_kernel; redesigned for Hopper).  The score
// product is a GEMM with one long reduction over E and no dependent second
// product, so it runs on warpgroup MMA fed by the tensor memory accelerator:
// * A block owns 128 rows of x and a range of vocab tiles of 256 columns.
//   Warpgroup 0 produces: one thread streams x and head as 64-column
//   slices of E (128 bytes a row) by TMA, with the 128-byte swizzle the
//   wgmma shared-memory descriptors name, into a ring of kWgStages stages
//   (16 KB of x and 32 KB of head each), counted off each stage's
//   transaction barrier (mbarrier).  The ring carries on across vocab
//   tiles, so the next tile's first slices land while this tile's softmax
//   runs.  Warpgroups 1 and 2 consume: each issues wgmma.mma_async
//   m64n256k16 (both operands in shared memory, fp32 accumulators in
//   registers, 128 a thread) for its 64 rows, and frees a stage once the
//   products that read it are done.  setmaxnreg moves registers from the
//   producer (40) to the consumers (232).
// * The online softmax runs on the accumulators: each thread holds two
//   rows' columns in the mma accumulator layout, so a row's max and sum
//   are quad shuffles.  Scores go to log2 units in the exponential's FFMA,
//   exponentials by ex2.approx; the thread that holds the label's column
//   takes its logit.  The score tile never touches shared memory.
// * TMA's out-of-bounds zero fill masks the ragged edges: rows past N,
//   vocab rows past V and the columns of a last slice past E (E 200, or
//   any E not a multiple of 64).  Memory is never padded.  Only a tile
//   that reaches past vocab_size masks by value.
// * Grid: row tiles x vocab splits, row tiles fastest, so all row tiles
//   of one vocab range are in flight together and share its head tiles
//   through L2 (the head, 77 MB at GPT-2's shape, exceeds the 50 MB L2; x
//   is 6 MB).  The wrapper picks the split count from the blocks the card
//   holds at once (the occupancy query; fwd_grid in cross_entropy.py).
// * Each split writes its rows' (max, sum, label logit); the block that
//   arrives last at its row tile's counter folds the splits in split order
//   (merge_splits, shared with fp32), so the result does not depend on
//   which block ends first, and sets the counter back to 0: counters live
//   across calls (cached per device by the wrapper), never memset.
// fp32 (ce_fwd_kernel<float>; not redesigned): 128 x 128 score tiles by
// FMA from cp.async-staged 32-column steps, two threads a row reading the
// tile from shared memory, 32 vocab splits; the same partials and merge.
// Bound: operations, 2 N E V = 317 GFLOP at N 4096, E 768, V 50304: 0.320
// ms at 989 TFLOP/s (bf16).  What holds the bf16 kernel (H100 SXM, 700 W;
// PERF.md, section 6): the products and the ring alone take ~87 % of its
// time, ~81 % of the tensor-core peak; the softmax, which both consumer
// warpgroups run while no product of theirs is in flight, the other ~13 %
// (forward_variants.py, "ce-products-only").  Next: overlap one
// warpgroup's softmax with the other's products.
//
// Backward (dx and dhead, one kernel ce_bwd_kernel<T, kDhead>; redesigned
// for Hopper).  It is flash attention with head width E: a block keeps
// "resident" rows R (x rows for dx, head rows for dhead) and streams the
// other operand T (head rows, or x rows) in tiles; per tile
//     s = R . T^T,  ds = (softmax part - one-hot) * g,  acc += ds . T,
// with one copy of each T tile serving both products.  The fp32
// accumulator [rows x E] is too big for one block at GPT-2's widths, so:
// * A thread-block cluster of C blocks (C = 1, 2, 4 or 8: the smallest
//   whose slice of E, rounded up to 8 columns, fits 208; GPT-2 768 -> 4 x
//   192, 1024 / 1280 / 1600 -> 8 x 128 / 160 / 200) shares one tile of 128
//   resident rows (bf16, streamed tiles of 64; fp32 64 and 32).  Block c
//   loads only its slice of E of R and of every T tile and keeps only that
//   slice of the accumulator, in registers.
// * Each block computes the partial score over its slice.  Block c owns
//   rows [c m, (c + 1) m) of the tile (m = rows / C): every block sends it
//   those rows' partials, block c sums the C of them in rank order (fixed:
//   fp32 results are deterministic, no atomics), forms ds, rounds it to
//   the input dtype (as the autograd of JAX's unchunked branch rounds ds)
//   and sends its rows of ds to every block, which then updates its own
//   columns, acc += ds . T.
// * The exchanges are bulk copies (cp.async.bulk, shared::cta to
//   shared::cluster), one per peer, each counted off a transaction barrier
//   (mbarrier) in the receiving block, so a block waits only for the data
//   it reads: no cluster-wide barrier per tile.  (First designs sent them
//   with per-thread distributed-shared-memory stores and cluster barriers:
//   slower, the store count and the barriers' release fences dominating.)
// * The step is pipelined so that each exchange is in flight while the
//   tensor cores work: step t computes tile t's partial scores while ds(t -
//   1) is in flight, and applies ds(t - 1) while tile t's partials are in
//   flight; ds is double-buffered.
// * bf16 products are mma.sync m16n8k16 (fp32 accumulate) with fragments
//   by ldmatrix (T by .trans for the update), the next step's fragments
//   loaded while the current step's products run; the score warp tiles are
//   32 x 32 and the update's 64 rows x every 4th 8-column slice, to cut
//   the shared-memory bytes per product.  fp32 uses FMA in the same layout
//   (no TF32).
// * T tiles stream into two ring slots by bulk copies, one per row,
//   counted off the slot's barrier; ds is formed with ex2.approx on log2
//   scaled scores.
// * Grids: dx, a cluster per 128 rows of x, times vocab splits chosen from
//   the clusters the card holds at once (the CUDA occupancy query; the
//   splits' fp32 partials are summed in split order by the last block of
//   each row tile and slice); dhead, a cluster per 128 vocab rows, each
//   walking every row of x.
// * Rows past N, vocab rows past V and columns past E are masked (zeros or
//   earlier finite values in shared memory that only meet ds = 0, never
//   written), never padded in memory.
// What holds it (PERF.md): the exchange and the per-step bookkeeping of
// all warps in lockstep take about as long as the products.  Next: warp
// specialisation (producer and consumer warps), wgmma with TMA-fed tiles,
// and one launch for dx and dhead (the score pass done once).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_primitives.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kPadLogit = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) & ~size_t(127); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float masked(float s, int col, int vocab_size) {
  return col < vocab_size ? s : kPadLogit;
}

// The score plus the head bias of its column (fp32), where there is one.
__device__ __forceinline__ float biased(float s, const float* bias, int col) {
  return bias != nullptr ? s + bias[col] : s;
}

// True in the block that arrives last at `counter` (of `expected`); that
// block then sees every other block's global writes (read them with
// __ldcg, past the incoherent L1) and sets the counter back to 0, ready
// for the next launch.
__device__ bool last_block(int* counter, int expected) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    is_last = atomicAdd(counter, 1) == expected - 1;
    if (is_last) *counter = 0;
  }
  __syncthreads();
  if (is_last) __threadfence();
  return is_last != 0;
}

// --------------------------------------------------------------------------
// forward: the splits' partials and their merge (both dtypes)
// --------------------------------------------------------------------------

// Each vocab split leaves, per row, in part [splits][3][n] fp32: the
// running max of its scores in log2 units, the sum of 2^(s log2(e) - max)
// over its columns, and the label's logit if the label is one of its
// columns below vocab_size (else 0).  The block that arrives last at its
// row tile folds them, rows r = tid, tid + nthreads, ... of the tile: lse
// = (max + log2 sum) ln 2, nll = lse - the label's logit (-1e9 for a
// label in [vocab_size, V), JAX's pad logit; 0 outside [0, V)).
__device__ void merge_splits(const float* part, const int* labels, float* nll, float* lse,
                             int row0, int rows, int n, int v, int vocab_size, int splits,
                             int tid, int nthreads) {
  for (int r = tid; r < rows; r += nthreads) {
    const int row = row0 + r;
    if (row >= n) continue;
    float mm = -INFINITY;
    for (int j = 0; j < splits; ++j) mm = fmaxf(mm, __ldcg(part + (size_t)j * 3 * n + row));
    float ls = 0.f, lab = 0.f;
    for (int j = 0; j < splits; ++j) {   // in split order, whatever the order of arrival
      const float lj = __ldcg(part + ((size_t)j * 3 + 1) * n + row);
      if (lj > 0.f) ls += lj * exp2f(__ldcg(part + (size_t)j * 3 * n + row) - mm);
      lab += __ldcg(part + ((size_t)j * 3 + 2) * n + row);
    }
    const int label = labels[row];
    if (label >= vocab_size && label < v) lab = kPadLogit;
    const float lse_r = (mm + log2f(ls)) * kLn2;
    lse[row] = lse_r;
    nll[row] = lse_r - lab;
  }
}

// --------------------------------------------------------------------------
// forward, bf16: warpgroup MMA on TMA-fed tiles
// --------------------------------------------------------------------------

constexpr int kWgRows = 128;             // x rows of a block: two consumer warpgroups of 64
constexpr int kWgCols = 256;             // vocab columns of a tile (m64n256k16)
constexpr int kWgK = 64;                 // E columns of a slice: one 128-byte swizzle row
constexpr int kWgStages = 4;             // ring stages of x and head slices
constexpr int kWgThreads = 384;          // warpgroup 0 produces, 1 and 2 consume
constexpr int kWgAcc = kWgCols / 2;      // fp32 accumulators a consumer thread holds
constexpr uint32_t kWgXBytes = kWgRows * kWgK * 2;
constexpr uint32_t kWgHeadBytes = kWgCols * kWgK * 2;
constexpr uint32_t kWgStageBytes = kWgXBytes + kWgHeadBytes;
// 1024 bytes of slack to align the ring (the 128-byte swizzle repeats every
// 1024 bytes), the ring, a full and an empty barrier per stage
constexpr size_t kWgSmem = 1024 + kWgStages * (size_t)kWgStageBytes + 16 * kWgStages;
constexpr float kWgMaxStart = -1e30f;    // the running max's start: finite, so 2^(-inf - m) = 0

struct FwdArgs {
  const int* labels;
  float* part;         // [splits][3][n]
  int* counters;       // one per row tile, 0 between launches
  float* nll;
  float* lse;
  int n, e, v, vocab_size, per_split;
  const float* bias;   // the head bias [v] fp32, or null
};

// Pins the accumulators in program order around the asynchronous products
// (the compiler does not see wgmma write them late).
__device__ __forceinline__ void fence_acc(float (&d)[kWgAcc]) {
#pragma unroll
  for (int i = 0; i < kWgAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define CE_ACC8(i)                                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A . B^T over 16 columns of E: A 64 rows, B 256 rows, both K-major
// in shared memory; `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[kWgAcc], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : CE_ACC8(0), CE_ACC8(8), CE_ACC8(16), CE_ACC8(24), CE_ACC8(32), CE_ACC8(40), CE_ACC8(48),
        CE_ACC8(56), CE_ACC8(64), CE_ACC8(72), CE_ACC8(80), CE_ACC8(88), CE_ACC8(96),
        CE_ACC8(104), CE_ACC8(112), CE_ACC8(120)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
#undef CE_ACC8

// The two consumer warpgroups' barrier (named barrier 1; the producer has
// left by then).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWgThreads - 128) : "memory");
}

template <bool kBias>
__global__ void __launch_bounds__(kWgThreads, 1)
ce_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_head, const FwdArgs a) {
  extern __shared__ unsigned char smem[];
  __shared__ int is_last;
  const uint32_t ring = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sx = ring, sh = ring + kWgStages * kWgXBytes;
  const uint32_t full = sh + kWgStages * kWgHeadBytes, empty = full + 8 * kWgStages;
  const int row0 = blockIdx.x * kWgRows;
  const int n_k = cdiv(a.e, kWgK);       // the last slice's columns past E are TMA's zeros
  const int t_begin = blockIdx.y * a.per_split;
  const int t_end = min(t_begin + a.per_split, cdiv(a.v, kWgCols));
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full + 8 * s, 1);        // the producer's arrival, with the stage's bytes
      mbar_init(empty + 8 * s, 2);       // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < t_end; ++t)
        for (int ks = 0; ks < n_k; ++ks) {
          mbar_wait(empty + 8 * stage, phase ^ 1);     // the consumers freed the stage
          mbar_expect(full + 8 * stage, kWgStageBytes);
          tma_load_2d(sx + stage * kWgXBytes, &tm_x, ks * kWgK, row0, full + 8 * stage);
          tma_load_2d(sh + stage * kWgHeadBytes, &tm_head, ks * kWgK, t * kWgCols,
                      full + 8 * stage);
          if (++stage == kWgStages) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of the tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ct = threadIdx.x - 128, cw = ct >> 7;
  const int lane = ct & 31, g = lane >> 2, t4 = lane & 3;
  const int rbase = row0 + cw * 64 + ((ct >> 5) & 3) * 16 + g;     // rows rbase, rbase + 8
  int label[2];
  float m[2], l[2], lab[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    label[r] = rbase + 8 * r < a.n ? a.labels[rbase + 8 * r] : -1;
    m[r] = kWgMaxStart;
    l[r] = 0.f;
    lab[r] = 0.f;
  }
  const uint64_t desc_x = sw128_desc(sx + cw * 64 * 128), desc_h = sw128_desc(sh);
  float d[kWgAcc];
  int stage = 0;
  uint32_t phase = 0;
  for (int t = t_begin; t < t_end; ++t) {
    int prev = 0;
    for (int ks = 0; ks < n_k; ++ks) {
      mbar_wait(full + 8 * stage, phase);
      wgmma_fence();
      const uint64_t dx = desc_x + ((stage * kWgXBytes) >> 4);
      const uint64_t dh = desc_h + ((stage * kWgHeadBytes) >> 4);
#pragma unroll
      for (int kk = 0; kk < kWgK / 16; ++kk)
        wgmma_m64n256k16(d, dx + 2 * kk, dh + 2 * kk, ks > 0 || kk > 0);
      wgmma_commit();
      if (ks > 0) {                       // the previous slice's products are done: free it
        wgmma_wait<1>();
        if ((ct & 127) == 0) mbar_arrive(empty + 8 * prev);
      }
      prev = stage;
      if (++stage == kWgStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(d);
    if ((ct & 127) == 0) mbar_arrive(empty + 8 * prev);

    // ---- the online softmax on the accumulators: d[4 j + 2 r + i] is row
    // rbase + 8 r, column col0 + 8 j + 2 t4 + i ----
    const int col0 = t * kWgCols;
    if (kBias) {   // the head bias joins the fp32 scores first, as in JAX's _score_block
#pragma unroll
      for (int j = 0; j < kWgCols / 8; ++j) {
        const int c = col0 + 8 * j + 2 * t4;
        const float b0 = c < a.v ? __ldg(a.bias + c) : 0.f;
        const float b1 = c + 1 < a.v ? __ldg(a.bias + c + 1) : 0.f;
        d[4 * j] += b0;
        d[4 * j + 1] += b1;
        d[4 * j + 2] += b0;
        d[4 * j + 3] += b1;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lc = label[r] - col0;
      if (lc >= 0 && lc < kWgCols && label[r] < a.vocab_size) {   // this tile holds the label
#pragma unroll
        for (int j = 0; j < kWgCols / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (8 * j + 2 * t4 + i == lc) lab[r] = d[4 * j + 2 * r + i];
      }
    }
    if (col0 + kWgCols > a.vocab_size) {  // pad columns and columns past V take no weight
#pragma unroll
      for (int j = 0; j < kWgCols / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (col0 + 8 * j + 2 * t4 + (i & 1) >= a.vocab_size) d[4 * j + i] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kWgCols / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], d[4 * j + i]);
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(m[r], __fmul_rn(quad_max(mx[r]), kLog2e));
      alpha[r] = exp2_approx(__fsub_rn(m[r], mx[r]));
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < kWgCols / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sum[i >> 1] += exp2_approx(fmaf(d[4 * j + i], kLog2e, -mx[i >> 1]));
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];   // this thread's columns
  }

  // ---- this split's partials; the last block of the row tile merges ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    lab[r] = quad_sum(lab[r]);
    const int row = rbase + 8 * r;
    if (t4 == 0 && row < a.n) {
      float* p = a.part + (size_t)blockIdx.y * 3 * a.n + row;
      p[0] = m[r];
      p[(size_t)a.n] = l[r];
      p[2 * (size_t)a.n] = lab[r];
    }
  }
  __threadfence();                       // this thread's partials are visible before the count
  consumer_sync();
  if (ct == 0) {
    int* arrivals = a.counters + blockIdx.x;
    is_last = atomicAdd(arrivals, 1) == (int)gridDim.y - 1;
    if (is_last) *arrivals = 0;          // every split has arrived: ready for the next launch
  }
  consumer_sync();
  if (!is_last) return;
  __threadfence();                       // the other splits' partials, as counted
  merge_splits(a.part, a.labels, a.nll, a.lse, row0, kWgRows, a.n, a.v, a.vocab_size, gridDim.y,
               ct, kWgThreads - 128);
}

// --------------------------------------------------------------------------
// forward, fp32: FMA score tiles (not redesigned)
// --------------------------------------------------------------------------

constexpr int kThreads = 256;                // fp32 forward block
constexpr int kBK = 32;                      // E columns per step of the score product
constexpr int kLd = kBK + 1;                 // odd stride: conflict-free column reads
constexpr int kFwdRows = 128, kFwdCols = 128;

// Shared memory of the fp32 forward: the score tile s and its two staging
// tiles.
struct FwdLayout {
  static constexpr size_t kA = align128(sizeof(float) * kFwdRows * (kFwdCols + 4));
  static constexpr size_t kB = kA + align128(sizeof(float) * kFwdRows * kLd);
  static constexpr size_t kBytes = kB + align128(sizeof(float) * kFwdCols * kLd);
};

// dst[r][0 : kBK) = src[row0 + r][k0 : k0 + kBK) for r < ROWS; rows at or
// past nrows and columns at or past e are zeros.
template <int ROWS>
__device__ __forceinline__ void stage_k(const float* __restrict__ src, int row0, int nrows, int e,
                                        int k0, float* __restrict__ dst) {
  for (int i = threadIdx.x; i < ROWS * kBK; i += kThreads) {
    const int r = i / kBK, k = i % kBK;
    const bool valid = row0 + r < nrows && k0 + k < e;
    dst[r * kLd + k] = valid ? src[(size_t)(row0 + r) * e + k0 + k] : 0.f;
  }
}

// s[BM][BN + 4] = x[row0 : row0 + BM] . head[col0 : col0 + BN]^T over all e
// columns, fp32 sums.  x rows past n and head rows past v count as zeros.
// Ends with a barrier, so s is ready for every thread.
template <int BM, int BN>
__device__ void score_tile(const float* __restrict__ x, const float* __restrict__ head, int row0,
                           int n, int col0, int v, int e, float* __restrict__ a,
                           float* __restrict__ b, float* __restrict__ s) {
  constexpr int kLdS = BN + 4;
  // thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j
  constexpr int RM = BM / 16, RN = BN / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < e; k0 += kBK) {
    stage_k<BM>(x, row0, n, e, k0, a);
    stage_k<BN>(head, col0, v, e, k0, b);
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
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const float* __restrict__ x, const float* __restrict__ head, const FwdArgs a) {
  constexpr int BM = kFwdRows, BN = kFwdCols, kLdS = BN + 4, kHalf = BN / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s = reinterpret_cast<float*>(smem);
  float* sa = reinterpret_cast<float*>(smem + FwdLayout::kA);
  float* sb = reinterpret_cast<float*>(smem + FwdLayout::kB);

  const int row0 = blockIdx.x * BM, split = blockIdx.y, splits = gridDim.y;
  const int t_begin = split * a.per_split;
  const int t_end = min(t_begin + a.per_split, (a.v + BN - 1) / BN);
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;   // two threads per row
  const int row = row0 + r;
  const int label = row < a.n ? a.labels[row] : -1;
  float m = -INFINITY, l = 0.f, ll = 0.f;
  for (int t = t_begin; t < t_end; ++t) {
    const int col0 = t * BN;
    score_tile<BM, BN>(x, head, row0, a.n, col0, a.v, a.e, sa, sb, s);
    const float* srow = s + r * kLdS + half * kHalf;
    const int c0 = col0 + half * kHalf;
    float tmax = -INFINITY;
    for (int c = 0; c < kHalf && c0 + c < a.v; ++c)
      tmax = fmaxf(tmax, masked(biased(srow[c], a.bias, c0 + c), c0 + c, a.vocab_size));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    float sum = 0.f, lab = 0.f;
    for (int c = 0; c < kHalf && c0 + c < a.v; ++c) {
      const float sv = masked(biased(srow[c], a.bias, c0 + c), c0 + c, a.vocab_size);
      sum += expf(sv - m_new);
      if (c0 + c == label && label < a.vocab_size) lab += sv;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    lab += __shfl_xor_sync(0xffffffffu, lab, 1);
    l = l * expf(m - m_new) + sum;
    ll += lab;
    m = m_new;
    __syncthreads();   // s is rewritten by the next tile
  }
  if (half == 0 && row < a.n) {        // the max goes to log2 units, as merge_splits reads it
    a.part[((size_t)split * 3 + 0) * a.n + row] = m * kLog2e;
    a.part[((size_t)split * 3 + 1) * a.n + row] = l;
    a.part[((size_t)split * 3 + 2) * a.n + row] = ll;
  }
  if (!last_block(a.counters + blockIdx.x, splits)) return;
  merge_splits(a.part, a.labels, a.nll, a.lse, row0, BM, a.n, a.v, a.vocab_size, splits,
               threadIdx.x, kThreads);
}

// --------------------------------------------------------------------------
// backward (dx and dhead)
// --------------------------------------------------------------------------

constexpr int kWMax = 208;            // most columns of E one block of a cluster owns
constexpr int kMaxCluster = 8;        // the portable cluster size
constexpr int kUpdN8 = 7;             // n8 tiles per update warp: every 4th of kWMax / 8

// Per dtype: resident rows and streamed rows per tile, the warps, and the
// two warp grids: the score tile [rows x stream] as
// kSR x kSC warps, the update [rows x slice] as kUR row groups x 4 column
// groups (group c takes n8 tiles c, c + 4, ...).
template <typename T> struct Bwd;
template <> struct Bwd<bf16> {
  static constexpr int kRows = 128, kStream = 64, kWarps = 8;
  static constexpr int kSR = 4, kSC = 2, kUR = 2;
  static constexpr int kLd = kWMax + 8;        // 432-byte rows: an odd number of 16-byte
                                               // chunks, so ldmatrix rows hit distinct banks
  static constexpr int kLdDs = kStream + 8;    // 144-byte rows, likewise
};
template <> struct Bwd<float> {
  static constexpr int kRows = 64, kStream = 32, kWarps = 4;
  static constexpr int kSR = 2, kSC = 2, kUR = 1;
  static constexpr int kLd = kWMax + 4;
  static constexpr int kLdDs = kStream + 4;
};
template <typename T> constexpr int kLdS = Bwd<T>::kStream + 4;     // fp32 partial scores
template <typename T> constexpr int kThr = Bwd<T>::kWarps * 32;
template <typename T> constexpr int kSM = Bwd<T>::kRows / Bwd<T>::kSR / 16;   // m16 per score warp
template <typename T> constexpr int kSN = Bwd<T>::kStream / Bwd<T>::kSC / 8;  // n8 per score warp
template <typename T> constexpr int kUM = Bwd<T>::kRows / Bwd<T>::kUR / 16;   // m16 per update warp
static_assert(Bwd<bf16>::kWarps == Bwd<bf16>::kSR * Bwd<bf16>::kSC &&
              Bwd<bf16>::kWarps == Bwd<bf16>::kUR * 4 &&
              Bwd<float>::kWarps == Bwd<float>::kSR * Bwd<float>::kSC &&
              Bwd<float>::kWarps == Bwd<float>::kUR * 4 && kUpdN8 * 4 >= kWMax / 8,
              "warp grids");

// Columns of E a block owns when c blocks share it (rounded up to 8, so
// every slice starts on a 16-byte boundary).
__host__ __device__ constexpr int slice_of(int e, int c) { return (cdiv(e, c) + 7) / 8 * 8; }

// Blocks per cluster for width e: the smallest power of two whose slice
// fits kWMax; 0 when e needs more than kMaxCluster blocks.
__host__ __device__ constexpr int cluster_of(int e) {
  for (int c = 1; c <= kMaxCluster; c *= 2)
    if (slice_of(e, c) <= kWMax) return c;
  return 0;
}

// Shared memory of a backward block: the resident slice; two ring slots
// of streamed tiles, each with its rows' lse and labels (dhead); the
// partial scores this block receives (one slot per block of the cluster)
// and those it sends; two ds tiles; the resident rows' lse and labels
// (dx); five transaction barriers (the partial scores received; each ds
// tile's rows received from the other blocks; each ring slot's rows).
template <typename T>
struct BwdLayout {
  using B = Bwd<T>;
  static constexpr size_t kSlotBytes = align128(sizeof(T) * B::kStream * B::kLd + 8 * B::kStream);
  static constexpr size_t kScoreBytes = align128(sizeof(float) * B::kRows * kLdS<T>);
  static constexpr size_t kDsBytes = align128(sizeof(T) * B::kRows * B::kLdDs);
  static constexpr size_t kRing = align128(sizeof(T) * B::kRows * B::kLd);
  static constexpr size_t kRecv = kRing + 2 * kSlotBytes;
  static constexpr size_t kSend = kRecv + kScoreBytes;
  static constexpr size_t kDs = kSend + kScoreBytes;
  static constexpr size_t kStats = kDs + 2 * kDsBytes;
  static constexpr size_t kBars = kStats + align128(8 * B::kRows);
  static constexpr size_t kBytes = kBars + 128;
  // bytes each barrier phase receives from the other blocks (padding
  // included): this block's rows' partial scores of one tile, and the rows
  // of a ds tile that the others form
  static __device__ uint32_t recv_tx(int C) {
    return sizeof(float) * (B::kRows - B::kRows / C) * kLdS<T>;
  }
  static __device__ uint32_t ds_tx(int C) {
    return sizeof(T) * (B::kRows - B::kRows / C) * B::kLdDs;
  }
};

struct BwdArgs {
  const void* x;
  const void* head;
  const int* labels;
  const float* lse;
  const float* gscale;
  void* out;
  float* part;         // dx over vocab splits: [splits][n_pad][e] fp32
  int* counters;       // dx over vocab splits: one per (row tile, slice), zeroed
  int n, e, v, vocab_size;
  int w;               // slice width (columns per block of the cluster)
  int per_split;       // streamed tiles per vocab split (dx)
  int n_pad;           // row tiles x rows per tile (dx)
};

// dst[r][0 : W16) = src[row0 + r][col0 : col0 + w) for r < ROWS, where W16
// is w rounded up to 16; columns past w and rows at or past nrows are
// zeros.  Asynchronous: commit, wait and a barrier before reading.
template <typename T, int ROWS>
__device__ __forceinline__ void load_slice(T* dst, const T* src, int row0, int nrows, int e,
                                           int col0, int w) {
  constexpr int kPer = 16 / sizeof(T);
  const int chunks = cdiv(w, 16) * 16 / kPer;       // per row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < ROWS; r += Bwd<T>::kWarps) {      // a warp per row, a lane per chunk
    const bool row_ok = row0 + r < nrows;
    const T* from = src + (size_t)(row_ok ? row0 + r : 0) * e + col0;
    for (int c = lane * kPer; c < chunks * kPer; c += 32 * kPer) {
      const bool valid = row_ok && c < w;
      copy16_async(dst + r * Bwd<T>::kLd + c, valid ? from + c : src, valid);
    }
  }
}

// The block's partial scores of one tile, s[m][n] the warp's m16 x n8
// accumulator tiles (warp grid kSR x kSC), over nk steps of 16 columns;
// each step's fragments are loaded while the previous step's products run.
__device__ __forceinline__ void block_scores(float (&s)[kSM<bf16>][kSN<bf16>][4], const bf16* res,
                                             const bf16* tile, int nk) {
  using B = Bwd<bf16>;
  constexpr int L = B::kLd, SM = kSM<bf16>, SN = kSN<bf16>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
  const bf16* a = res + ((warp / B::kSC) * (16 * SM) + (mi & 1) * 8 + r8) * L + (mi >> 1) * 8;
  const bf16* b = tile + ((warp % B::kSC) * (8 * SN) + (mi >> 1) * 8 + r8) * L + (mi & 1) * 8;
  uint32_t af[2][SM][4], bfr[2][SN / 2][4];
  auto load = [&](int kk, int buf) {
#pragma unroll
    for (int m = 0; m < SM; ++m) ldsm_x4(af[buf][m], a + m * 16 * L + kk * 16);
#pragma unroll
    for (int np = 0; np < SN / 2; ++np) ldsm_x4(bfr[buf][np], b + np * 16 * L + kk * 16);
  };
#pragma unroll
  for (int m = 0; m < SM; ++m)
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[m][n][i] = 0.f;
  load(0, 0);
#pragma unroll
  for (int kk = 0; kk < kWMax / 16; ++kk) {
    if (kk < nk) {
      if (kk + 1 < nk) load(kk + 1, (kk + 1) & 1);
      const int buf = kk & 1;
#pragma unroll
      for (int np = 0; np < SN / 2; ++np)
#pragma unroll
        for (int m = 0; m < SM; ++m) {
          const uint32_t(&x)[4] = af[buf][m];
          mma_bf16(s[m][2 * np], x[0], x[1], x[2], x[3], bfr[buf][np][0], bfr[buf][np][1]);
          mma_bf16(s[m][2 * np + 1], x[0], x[1], x[2], x[3], bfr[buf][np][2], bfr[buf][np][3]);
        }
    }
  }
}

__device__ __forceinline__ void block_scores(float (&s)[kSM<float>][kSN<float>][4],
                                             const float* res, const float* tile, int nk) {
  using B = Bwd<float>;
  constexpr int L = B::kLd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a = res + ((warp / B::kSC) * (16 * kSM<float>) + g) * L;
  const float* b = tile + ((warp % B::kSC) * (8 * kSN<float>) + 2 * t) * L;
#pragma unroll
  for (int m = 0; m < kSM<float>; ++m)
#pragma unroll
    for (int n = 0; n < kSN<float>; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[m][n][i] = 0.f;
  for (int d = 0; d < nk * 16; d += 4) {
    float4 av[kSM<float>][2], bv[kSN<float>][2];
#pragma unroll
    for (int m = 0; m < kSM<float>; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        av[m][h] = *reinterpret_cast<const float4*>(a + (m * 16 + 8 * h) * L + d);
#pragma unroll
    for (int n = 0; n < kSN<float>; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bv[n][e] = *reinterpret_cast<const float4*>(b + (n * 8 + e) * L + d);
#pragma unroll
    for (int m = 0; m < kSM<float>; ++m)
#pragma unroll
      for (int n = 0; n < kSN<float>; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 x = av[m][i >> 1], y = bv[n][i & 1];
          float c = s[m][n][i];
          c = fmaf(x.x, y.x, c);
          c = fmaf(x.y, y.y, c);
          c = fmaf(x.z, y.z, c);
          c = fmaf(x.w, y.w, c);
          s[m][n][i] = c;
        }
  }
}

// acc += ds . tile for the warp's update tile: rows [kRows / kUR) of its
// row group, n8 tiles j = (warp % 4) + 4 i below the slice's nt8.
__device__ __forceinline__ void block_update(float (&acc)[kUM<bf16>][kUpdN8][4], const bf16* ds,
                                             const bf16* tile, int nt8) {
  using B = Bwd<bf16>;
  constexpr int L = B::kLd, LD = B::kLdDs, UM = kUM<bf16>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
  const bf16* a = ds + ((warp / 4) * (16 * UM) + (mi & 1) * 8 + r8) * LD + (mi >> 1) * 8;
  const bf16* b = tile + (lane & 15) * L + (warp % 4) * 8;
#pragma unroll
  for (int kk = 0; kk < B::kStream / 16; ++kk) {
    uint32_t af[UM][4], bfr[kUpdN8][2];
#pragma unroll
    for (int m = 0; m < UM; ++m) ldsm_x4(af[m], a + m * 16 * LD + kk * 16);
#pragma unroll
    for (int i = 0; i < kUpdN8; ++i)
      if (warp % 4 + 4 * i < nt8) ldsm_x2_trans(bfr[i], b + kk * 16 * L + i * 32);
#pragma unroll
    for (int i = 0; i < kUpdN8; ++i)
      if (warp % 4 + 4 * i < nt8)
#pragma unroll
        for (int m = 0; m < UM; ++m)
          mma_bf16(acc[m][i], af[m][0], af[m][1], af[m][2], af[m][3], bfr[i][0], bfr[i][1]);
  }
}

__device__ __forceinline__ void block_update(float (&acc)[kUM<float>][kUpdN8][4],
                                             const float* ds, const float* tile, int nt8) {
  using B = Bwd<float>;
  constexpr int L = B::kLd, LD = B::kLdDs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a = ds + ((warp / 4) * (16 * kUM<float>) + g) * LD;
  const int c0 = warp % 4;
  for (int k = 0; k < B::kStream; ++k) {
    float dv[kUM<float>][2];
#pragma unroll
    for (int m = 0; m < kUM<float>; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) dv[m][h] = a[(m * 16 + 8 * h) * LD + k];
    const float* row = tile + k * L + 2 * t;
#pragma unroll
    for (int i = 0; i < kUpdN8; ++i) {
      const int j = c0 + 4 * i;
      if (j >= nt8) break;
      const float2 bv = *reinterpret_cast<const float2*>(row + j * 8);
#pragma unroll
      for (int m = 0; m < kUM<float>; ++m) {
        acc[m][i][0] = fmaf(dv[m][0], bv.x, acc[m][i][0]);
        acc[m][i][1] = fmaf(dv[m][0], bv.y, acc[m][i][1]);
        acc[m][i][2] = fmaf(dv[m][1], bv.x, acc[m][i][2]);
        acc[m][i][3] = fmaf(dv[m][1], bv.y, acc[m][i][3]);
      }
    }
  }
}

__device__ __forceinline__ void store4(float* dst, const float (&d)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(d[0], d[1], d[2], d[3]);
}
__device__ __forceinline__ void store4(bf16* dst, const float (&d)[4]) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_rn(d[0], d[1]), pack_rn(d[2], d[3]));
}

template <typename O> __device__ __forceinline__ void store2(O* dst, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<bf16>(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// out[row0 + r][col0 + c] = the warp's update tile, rows below nrows (row
// stride e).
template <typename T, typename O>
__device__ __forceinline__ void store_acc(O* out, int e, const float (&acc)[kUM<T>][kUpdN8][4],
                                          int row0, int nrows, int col0, int nt8) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = row0 + (warp / 4) * (16 * kUM<T>) + g;
#pragma unroll
  for (int m = 0; m < kUM<T>; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + m * 16 + 8 * h;
      if (r >= nrows) continue;
#pragma unroll
      for (int i = 0; i < kUpdN8; ++i) {
        const int j = warp % 4 + 4 * i;
        if (j < nt8)
          store2<O>(out + (size_t)r * e + col0 + j * 8 + 2 * t, acc[m][i][2 * h],
                    acc[m][i][2 * h + 1]);
      }
    }
}

// The warp's partial scores by row r: into this block's send tile (row
// order), or, for the rows this block owns, straight
// into its own receive slot, which has the same layout.
template <typename T>
__device__ __forceinline__ void stage_partial(const float (&s)[kSM<T>][kSN<T>][4], float* send,
                                              float* recv, int mine, int rank) {
  using B = Bwd<T>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (warp / B::kSC) * (16 * kSM<T>) + g, c0 = (warp % B::kSC) * (8 * kSN<T>) + 2 * t;
#pragma unroll
  for (int m = 0; m < kSM<T>; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + m * 16 + 8 * h;
      const bool own = r >= rank * mine && r < (rank + 1) * mine;
      float* dst = (own ? recv : send) + r * kLdS<T> + c0;
#pragma unroll
      for (int n = 0; n < kSN<T>; ++n)
        *reinterpret_cast<float2*>(dst + n * 8) = make_float2(s[m][n][2 * h], s[m][n][2 * h + 1]);
    }
}

// This block's rows of the cluster's ds tile for streamed tile str0 (rows
// rank * mine + i, i < mine): the C blocks' partial scores of each row
// summed in rank order (fixed: fp32 results are deterministic), ds formed
// in fp32 and rounded to T into those rows of this block's ds tile.
// Resident row r, streamed row j is (x row, vocab column) = (res0 + r,
// str0 + j) for dx and (str0 + j, res0 + r) for dhead; stat_lse / stat_lab
// hold the lse and label of each resident row (dx) or streamed row (dhead).
template <typename T, bool kDhead>
__device__ __forceinline__ void form_ds(const BwdArgs& a, const float* recv, T* ds,
                                        const float* stat_lse, const int* stat_lab, int C,
                                        int rank, int res0, int str0, float g) {
  using B = Bwd<T>;
  constexpr int kQuads = B::kStream / 4, kIters = B::kRows * kQuads / kThr<T>;
  const int mine = B::kRows / C;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {   // kIters / C of them do work
    const int idx = threadIdx.x + it * kThr<T>;
    if (idx >= mine * kQuads) continue;
    const int i = idx / kQuads, c = (idx % kQuads) * 4, r = rank * mine + i;
    float sv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int cc = 0; cc < kMaxCluster; ++cc) {      // the C partial scores, in rank order
      if (cc >= C) break;
      const float4 q = *reinterpret_cast<const float4*>(recv + (cc * mine + i) * kLdS<T> + c);
      sv[0] += q.x;
      sv[1] += q.y;
      sv[2] += q.z;
      sv[3] += q.w;
    }
    float d[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int row = kDhead ? str0 + c + k : res0 + r;
      const int col = kDhead ? res0 + r : str0 + c + k;
      const int st = kDhead ? c + k : r;
      d[k] = 0.f;
      if (row < a.n && col < a.v) {
        const float p = exp2_approx(__fmul_rn(masked(sv[k], col, a.vocab_size) - stat_lse[st],
                                              kLog2e));
        d[k] = (p - (col == stat_lab[st] ? 1.f : 0.f)) * g;
      }
    }
    store4(ds + r * B::kLdDs + c, d);
  }
}

// Streamed tile t into its ring slot: each of its rows' slice by one bulk
// copy counted off the slot's barrier `bar` (rows at or past str_n are not
// copied: the slot keeps earlier, finite values there, which only ever
// meet a ds of 0), and (dhead) its rows' lse and labels by cp.async after
// them (zeros past str_n).  Issued after a barrier past every read of the
// slot, each of those threads having fenced (proxy_fence).
template <typename T, bool kDhead>
__device__ __forceinline__ void load_stream(const BwdArgs& a, unsigned char* slot, uint32_t bar,
                                            const T* src, int str0, int str_n, int col0, int w) {
  using B = Bwd<T>;
  const int rows = min(B::kStream, str_n - str0);
  const uint32_t bytes = sizeof(T) * w;
  if (threadIdx.x == 0) mbar_expect(bar, rows * bytes);
  if (threadIdx.x < rows)
    bulk_load(smem_u32(slot) + threadIdx.x * sizeof(T) * B::kLd,
              src + (size_t)(str0 + threadIdx.x) * a.e + col0, bytes, bar);
  if (kDhead && threadIdx.x < 2 * B::kStream) {
    const int j = threadIdx.x % B::kStream, row = str0 + j;
    const bool lab = threadIdx.x >= B::kStream;
    unsigned char* stats = slot + sizeof(T) * B::kStream * B::kLd;
    copy4_async(stats + 4 * threadIdx.x, row < a.n ? (lab ? (const void*)(a.labels + row)
                                                          : (const void*)(a.lse + row))
                                                   : (const void*)a.lse, row < a.n);
  }
}

// dx (kDhead false): resident rows are x rows, streamed tiles head rows
// (vocab), from tile blockIdx.y * per_split on; dhead (kDhead true):
// resident rows are head rows, streamed tiles every row of x.  blockIdx.x
// is (resident tile) * C + rank in the cluster.
//
// Block c of the cluster owns rows [c mine, (c + 1) mine) of the tile,
// mine = rows / C.  Step t: compute tile t's partial scores (registers;
// meanwhile ds(t - 1) is in flight); wait for ds(t - 1); write the partial
// scores to the send tile and copy each owner's rows into its receive slot
// (one bulk copy per other owner; in flight while this block applies ds(t - 1)
// to its columns); wait for this block's rows' partial scores of tile t;
// form those rows of ds(t) in its ds tile and copy them into the other
// blocks' tiles.  Every exchange is a bulk copy into a peer's shared memory
// counted off a transaction barrier there, so a block waits only for the
// data it reads.  The partial scores of step t leave only once ds(t - 1)
// is whole (every owner has read those of step t - 1); ds(t) goes to the
// ds tile not in use (t % 2) and leaves only once every block's partial
// scores of step t have arrived (every block is past its use of ds(t -
// 2)).  Tile t + 1 streams in from the middle of step t, once tile t - 1's
// slot is free.
template <typename T, bool kDhead>
__global__ void __launch_bounds__(Bwd<T>::kWarps * 32, 1) ce_bwd_kernel(const BwdArgs a) {
  using B = Bwd<T>;
  using Lay = BwdLayout<T>;
  constexpr int kRows = B::kRows;
  extern __shared__ __align__(128) unsigned char smem[];
  T* res = reinterpret_cast<T*>(smem);
  unsigned char* ring = smem + Lay::kRing;
  float* recv = reinterpret_cast<float*>(smem + Lay::kRecv);
  float* send = reinterpret_cast<float*>(smem + Lay::kSend);
  float* res_lse = reinterpret_cast<float*>(smem + Lay::kStats);
  int* res_lab = reinterpret_cast<int*>(res_lse + kRows);
  const uint32_t bar_recv = smem_u32(smem + Lay::kBars);       // then ds [2], tile slots [2]
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int mine = kRows / C;
  const int res0 = (int)(blockIdx.x / C) * kRows;
  const int col0 = rank * a.w, w = min(a.w, a.e - col0), nk = cdiv(w, 16), nt8 = w / 8;
  const T* rsrc = static_cast<const T*>(kDhead ? a.head : a.x);
  const T* ssrc = static_cast<const T*>(kDhead ? a.x : a.head);
  const int res_n = kDhead ? a.v : a.n, str_n = kDhead ? a.n : a.v;
  const int n_str = cdiv(str_n, B::kStream);                    // streamed tiles
  const int t_begin = kDhead ? 0 : (int)blockIdx.y * a.per_split;
  const int nt = kDhead ? n_str : min(a.per_split, n_str - t_begin);
  const float g = *a.gscale;
  auto slot = [&](int t) { return ring + (size_t)(t & 1) * Lay::kSlotBytes; };
  auto slot_lse = [&](int t) {
    return reinterpret_cast<const float*>(slot(t) + sizeof(T) * B::kStream * B::kLd);
  };
  auto ds = [&](int t) { return reinterpret_cast<T*>(smem + Lay::kDs + (t & 1) * Lay::kDsBytes); };
  auto bar_ds = [&](int t) { return bar_recv + 8 * (1 + (t & 1)); };
  auto bar_tile = [&](int t) { return bar_recv + 8 * (3 + (t & 1)); };

  if (threadIdx.x == 0) {
    for (int b = 0; b < 5; ++b) mbar_init(bar_recv + 8 * b, 1);
    mbar_init_fence();
  }
  for (int i = threadIdx.x; i < (int)(2 * Lay::kSlotBytes / 16); i += kThr<T>)
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);   // the columns no copy writes
  proxy_fence();
  __syncthreads();
  load_slice<T, kRows>(res, rsrc, res0, res_n, a.e, col0, w);
  if (nt > 0)
    load_stream<T, kDhead>(a, slot(0), bar_tile(0), ssrc, t_begin * B::kStream, str_n, col0, w);
  commit_copies();
  if (!kDhead)
    for (int r = threadIdx.x; r < kRows; r += kThr<T>) {
      const int row = res0 + r;
      res_lse[r] = row < a.n ? a.lse[row] : 0.f;
      res_lab[r] = row < a.n ? a.labels[row] : -1;
    }
  float acc[kUM<T>][kUpdN8][4];
#pragma unroll
  for (int m = 0; m < kUM<T>; ++m)
#pragma unroll
    for (int i = 0; i < kUpdN8; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[m][i][k] = 0.f;
  wait_copies<0>();
  __syncthreads();                    // the resident slice (and tile 0's stats) have landed
  cluster_arrive();
  cluster_wait();                     // every block's barriers are set up
  if (threadIdx.x == 0) {             // the ds phases of tiles 0 and 1
    mbar_expect(bar_ds(0), Lay::ds_tx(C));
    mbar_expect(bar_ds(1), Lay::ds_tx(C));
  }
  for (int t = 0; t < nt; ++t) {
    if (threadIdx.x == 0) mbar_expect(bar_recv, Lay::recv_tx(C));
    mbar_wait(bar_tile(t), (t >> 1) & 1);                    // tile t has landed
    float s[kSM<T>][kSN<T>][4];
    block_scores(s, res, reinterpret_cast<const T*>(slot(t)), nk);
    if (t > 0) mbar_wait(bar_ds(t - 1), ((t - 1) >> 1) & 1);  // ds(t - 1) is whole
    stage_partial<T>(s, send, recv, mine, rank);
    proxy_fence();
    __syncthreads();
    // every thread is past its wait, so the barrier's next phase (tile t +
    // 1's, which completes at once when no other block sends rows) may open
    if (t > 0 && threadIdx.x == 0) mbar_expect(bar_ds(t + 1), Lay::ds_tx(C));
    if (threadIdx.x < C && threadIdx.x != rank) {   // owner o's rows, into its slot for us
      const uint32_t bytes = sizeof(float) * mine * kLdS<T>;
      bulk_to_peer(map_rank(smem_u32(recv) + rank * bytes, threadIdx.x),
                   smem_u32(send) + threadIdx.x * bytes, bytes, map_rank(bar_recv, threadIdx.x));
    }
    if (t > 0) block_update(acc, ds(t - 1), reinterpret_cast<const T*>(slot(t - 1)), nt8);
    proxy_fence();
    __syncthreads();                  // tile t - 1's slot is free
    if (t + 1 < nt)
      load_stream<T, kDhead>(a, slot(t + 1), bar_tile(t + 1), ssrc, (t_begin + t + 1) * B::kStream,
                             str_n, col0, w);
    commit_copies();
    mbar_wait(bar_recv, t & 1);       // every partial score of this block's rows of tile t
    form_ds<T, kDhead>(a, recv, ds(t), kDhead ? slot_lse(t) : res_lse,
                       kDhead ? reinterpret_cast<const int*>(slot_lse(t) + B::kStream) : res_lab,
                       C, rank, res0, (t_begin + t) * B::kStream, g);
    proxy_fence();
    __syncthreads();
    if (threadIdx.x < C && threadIdx.x != rank) {   // this block's rows, into the others' tiles
      const uint32_t bytes = sizeof(T) * mine * B::kLdDs;
      const uint32_t rows = smem_u32(ds(t)) + rank * bytes;
      bulk_to_peer(map_rank(rows, threadIdx.x), rows, bytes, map_rank(bar_ds(t), threadIdx.x));
    }
    wait_copies<0>();
    __syncthreads();                  // tile t + 1's stats have landed
  }
  if (nt > 0) {
    mbar_wait(bar_ds(nt - 1), ((nt - 1) >> 1) & 1);
    block_update(acc, ds(nt - 1), reinterpret_cast<const T*>(slot(nt - 1)), nt8);
  }
  cluster_arrive();
  cluster_wait();                     // no block leaves while a peer may still copy into it
  T* out = static_cast<T*>(a.out);
  if (kDhead || gridDim.y == 1) {
    store_acc<T>(out, a.e, acc, res0, res_n, col0, nt8);
    return;
  }
  // fp32 partial of this vocab split; the last split to finish sums them
  store_acc<T>(a.part + (size_t)blockIdx.y * a.n_pad * a.e, a.e, acc, res0, a.n_pad, col0, nt8);
  if (!last_block(a.counters + blockIdx.x, gridDim.y)) return;
  for (int i = threadIdx.x; i < kRows * w; i += kThr<T>) {
    const int row = res0 + i / w, c = col0 + i % w;
    if (row >= a.n) continue;
    float sum = __ldcg(a.part + (size_t)row * a.e + c);
    for (int j = 1; j < (int)gridDim.y; ++j)
      sum += __ldcg(a.part + ((size_t)j * a.n_pad + row) * a.e + c);
    out[(size_t)row * a.e + c] = from_f<T>(sum);
  }
}

// --------------------------------------------------------------------------
// backward at any width (dx and dhead past the cluster's 8 x 208 columns, or
// with a head bias): the vocab in chunks, each a ds pass and a product
// --------------------------------------------------------------------------
//
// Per chunk of `ld` vocab columns [v0, v0 + kc):
//   ds pass:  ds = (exp(x . head_chunk^T (+ bias) - lse) - onehot) * g,
//             rounded to the input dtype into a scratch [n][ld] (the
//             rounding of rows 5-6's kernels and their plain version);
//   dx:       dx (+)= ds . head_chunk, summed in fp32 in a buffer [n][e]
//             across the chunks in chunk order (the last chunk writes dx in
//             the input dtype);
//   dhead:    dhead[v0 : v0 + kc] = ds^T . x, and with a bias dbias = the
//             sum over rows of the fp32 ds, from per-row-tile column sums
//             the ds pass leaves, added in row-tile order.
// All three are one GEMM body with the operands' layouts and the epilogue
// as template parameters: a 128 x 128 tile per block of 8 warps (2 x 4, a
// warp 64 x 32), K in steps of 32 through a 3-stage cp.async ring; bf16
// through mma.sync m16n8k16 (fp32 accumulate) on ldmatrix fragments (.trans
// for an operand stored with M or N contiguous), fp32 through FMA in the
// same register layout.  Every sum has a fixed order, so two runs are
// bitwise equal.  Bound: operations, 2 n e kc per product and chunk; the
// ds pass is the forward's product again, so one backward entry point does
// two products of 2 n e V (wgmma and TMA, and one ds pass shared by dx and
// dhead, are later work).

constexpr int kGm = 128, kGn = 128, kGk = 32;   // block tile and K step
constexpr int kGThreads = 256;                   // 8 warps: 2 along M x 4 along N
constexpr int kGStages = 3;

// shared-memory pitch of a [rows][cols] operand tile (16 bytes past a
// multiple of 128 bytes every row, so ldmatrix rows hit distinct banks)
template <typename T> __host__ __device__ constexpr int gpad() { return 16 / (int)sizeof(T); }
// an operand tile: [kGm][kGk] when K is contiguous in memory, [kGk][kGm]
// when M (or N) is
template <typename T, bool kKContig> struct GTile {
  static constexpr int kRows = kKContig ? kGm : kGk;
  static constexpr int kCols = kKContig ? kGk : kGm;
  static constexpr int kLd = kCols + gpad<T>();
  static constexpr int kElems = kRows * kLd;
};

// dst = rows [r0, r0 + kRows) x columns [c0, c0 + kCols) of a row-major
// matrix with leading dimension ld; 16-byte chunks at or past (r_ext,
// c_ext) are zeros (c_ext a multiple of 16 bytes).  Asynchronous.
template <typename T, bool kKContig>
__device__ __forceinline__ void load_gtile(T* dst, const T* src, long long ld, int r0, int c0,
                                           int r_ext, int c_ext) {
  using G = GTile<T, kKContig>;
  constexpr int kE = 16 / sizeof(T), kChunks = G::kCols / kE;
  constexpr int kPer = G::kRows * kChunks / kGThreads;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = threadIdx.x + i * kGThreads;
    const int r = c / kChunks, col = (c % kChunks) * kE;
    const bool valid = r0 + r < r_ext && c0 + col < c_ext;
    copy16_async(dst + r * G::kLd + col, valid ? src + (long long)(r0 + r) * ld + c0 + col : src,
                 valid);
  }
}

// An operand: a row-major matrix, K contiguous ([MN][K]) or MN contiguous
// ([K][MN]), with its extents (rows, columns as stored).
template <typename T> struct GOperand {
  const T* p;
  long long ld;
  int rows, cols;
};

// acc[i][j][.]: the warp's m16 tile i, n8 tile j (rows g, g + 8 and columns
// 2t, 2t + 1 of each)
using GAcc = float[4][4][4];

template <bool kAK, bool kBK>
__device__ __forceinline__ void gemm_step(GAcc& acc, const bf16* sa, const bf16* sb) {
  constexpr int LA = GTile<bf16, kAK>::kLd, LB = GTile<bf16, kBK>::kLd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
#pragma unroll
  for (int kk = 0; kk < kGk / 16; ++kk) {
    uint32_t af[4][4], bfr[2][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = wm + i * 16;
      if (kAK)
        ldsm_x4(af[i], sa + (m + (mi & 1) * 8 + r8) * LA + kk * 16 + (mi >> 1) * 8);
      else
        ldsm_x4_trans(af[i], sa + (kk * 16 + (mi >> 1) * 8 + r8) * LA + m + (mi & 1) * 8);
    }
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      const int n = wn + jp * 16;
      if (kBK)
        ldsm_x4(bfr[jp], sb + (n + (mi >> 1) * 8 + r8) * LB + kk * 16 + (mi & 1) * 8);
      else
        ldsm_x4_trans(bfr[jp], sb + (kk * 16 + (mi & 1) * 8 + r8) * LB + n + (mi >> 1) * 8);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        mma_bf16(acc[i][2 * jp], af[i][0], af[i][1], af[i][2], af[i][3], bfr[jp][0], bfr[jp][1]);
        mma_bf16(acc[i][2 * jp + 1], af[i][0], af[i][1], af[i][2], af[i][3], bfr[jp][2],
                 bfr[jp][3]);
      }
  }
}

// fp32: the step's 32 products summed apart, then added to acc, so a sum
// over K is a chain of K / 32 partial sums, not of K products (at n_embd
// 4096 a 4096-long chain of FMAs drifts by ~1e-5 of the scores, past the
// fp32 tolerance of the plain version's blocked sums)
template <bool kAK, bool kBK>
__device__ __forceinline__ void gemm_step(GAcc& acc, const float* sa, const float* sb) {
  constexpr int LA = GTile<float, kAK>::kLd, LB = GTile<float, kBK>::kLd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  GAcc part = {};
#pragma unroll 4
  for (int k = 0; k < kGk; ++k) {
    float a[4][2], b[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm + i * 16 + g + 8 * h;
        a[i][h] = kAK ? sa[m * LA + k] : sa[k * LA + m];
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = wn + j * 8 + 2 * t + c;
        b[j][c] = kBK ? sb[n * LB + k] : sb[k * LB + n];
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[i][j][e] = fmaf(a[i][e >> 1], b[j][e & 1], part[i][j][e]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
}

// Blocks per SM __launch_bounds__ asks for: bf16 2 (128 registers a
// thread); fp32 1, whose step sums (64 registers beside the 64 of acc)
// would spill at 128.
template <typename T> __host__ __device__ constexpr int gemm_min_blocks() {
  return sizeof(T) == 2 ? 2 : 1;
}

// acc = A[m0 : m0 + 128, :K] . B[:K, n0 : n0 + 128] over K in steps of kGk,
// in order; A is [M][K] (kAK) or [K][M], B [N][K] (kBK) or [K][N].  Leaves
// every copy landed and the ring free for the epilogue.
template <typename T, bool kAK, bool kBK>
__device__ __forceinline__ void gemm_block(GAcc& acc, const GOperand<T>& A, const GOperand<T>& B,
                                           int m0, int n0, int K, T* smem) {
  constexpr int EA = GTile<T, kAK>::kElems, EB = GTile<T, kBK>::kElems;
  T* sa = smem;
  T* sb = smem + kGStages * EA;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int nk = cdiv(K, kGk);
  auto stage = [&](int kt, int s) {
    const int k0 = kt * kGk;
    if (kAK)
      load_gtile<T, true>(sa + s * EA, A.p, A.ld, m0, k0, A.rows, A.cols);
    else
      load_gtile<T, false>(sa + s * EA, A.p, A.ld, k0, m0, A.rows, A.cols);
    if (kBK)
      load_gtile<T, true>(sb + s * EB, B.p, B.ld, n0, k0, B.rows, B.cols);
    else
      load_gtile<T, false>(sb + s * EB, B.p, B.ld, k0, n0, B.rows, B.cols);
  };
#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < nk) stage(s, s);
    commit_copies();
  }
  for (int kt = 0, s = 0; kt < nk; ++kt, s = s + 1 == kGStages ? 0 : s + 1) {
    wait_copies<kGStages - 2>();       // step kt has landed
    __syncthreads();                   // ... for every thread, and step kt - 1's slot is free
    const int next = kt + kGStages - 1;
    if (next < nk) stage(next, s == 0 ? kGStages - 1 : s - 1);
    commit_copies();
    gemm_step<kAK, kBK>(acc, sa + s * EA, sb + s * EB);
  }
  wait_copies<0>();
  __syncthreads();
}

template <typename T>
constexpr size_t gemm_smem(bool a_kcontig, bool b_kcontig) {
  return sizeof(T) * kGStages *
         ((a_kcontig ? GTile<T, true>::kElems : GTile<T, false>::kElems) +
          (b_kcontig ? GTile<T, true>::kElems : GTile<T, false>::kElems));
}

struct WideArgs {
  const void* x;        // [n][e]
  const void* head;     // [v][e]
  const int* labels;
  const float* lse;
  const float* gscale;
  const float* bias;    // [v] fp32 or null
  void* ds;             // scratch [n][ld] in the input dtype
  float* colsum;        // [row tiles][ld] fp32: the ds pass's column sums, or null
  float* acc;           // dx's fp32 buffer [n][e]
  void* out;            // dx [n][e] or dhead [v][e]
  float* dbias;         // [v] fp32 or null
  int n, e, v, vocab_size, v0, ld, kc;
  int first, last;      // dx: this chunk is the first / the last
};

// Calls f(row, col, value, i, j, e) for every accumulator element of the
// thread (row and column within the block tile).
template <typename F>
__device__ __forceinline__ void for_acc(const GAcc& acc, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(wm + i * 16 + g + 8 * (e >> 1), wn + j * 8 + 2 * t + (e & 1), acc[i][j][e], i, j, e);
}

// The ds pass of one chunk: grid (row tiles of x, column tiles of the
// chunk).  kColSums: the dhead entry point's pass, which also leaves the
// fp32 column sums of its rows for dbias when there is a bias (colsum set).
template <typename T, bool kColSums>
__global__ void __launch_bounds__(kGThreads, gemm_min_blocks<T>())
    ce_wide_ds_kernel(const WideArgs a) {
  extern __shared__ __align__(128) unsigned char gsmem[];
  T* smem = reinterpret_cast<T*>(gsmem);
  const int m0 = blockIdx.x * kGm, n0 = blockIdx.y * kGn;
  const GOperand<T> A = {static_cast<const T*>(a.x), a.e, a.n, a.e};
  const GOperand<T> B = {static_cast<const T*>(a.head) + (long long)a.v0 * a.e, a.e, a.kc, a.e};
  GAcc acc;
  gemm_block<T, true, true>(acc, A, B, m0, n0, a.e, smem);
  const float g = *a.gscale;
  T* ds = static_cast<T*>(a.ds);
  float colsum[4][2] = {};
  for_acc(acc, [&](int r, int c, float s, int, int j, int e) {
    const int row = m0 + r, col = n0 + c, vcol = a.v0 + col;
    if (row >= a.n || col >= a.ld) return;
    float d = 0.f;                     // columns past V (the chunk's padding) are zeros
    if (vcol < a.v) {
      if (a.bias != nullptr) s += a.bias[vcol];
      if (vcol >= a.vocab_size) s = kPadLogit;
      const float p = exp2_approx(__fmul_rn(s, kLog2e) - __fmul_rn(a.lse[row], kLog2e));
      d = (p - (vcol == a.labels[row] ? 1.f : 0.f)) * g;
    }
    ds[(long long)row * a.ld + col] = from_f<T>(d);
    if (kColSums) colsum[j][e & 1] += d;
  });
  if (!kColSums || a.colsum == nullptr) return;
  // this warp's 64 rows, then the two warps along M in order
  float* red = reinterpret_cast<float*>(gsmem);          // [2][kGn]: the ring is free
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float v = colsum[j][c];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) red[(warp >> 2) * kGn + (warp & 3) * 32 + j * 8 + 2 * t + c] = v;
    }
  __syncthreads();
  if (threadIdx.x < kGn && n0 + (int)threadIdx.x < a.ld)
    a.colsum[(long long)blockIdx.x * a.ld + n0 + threadIdx.x] =
        red[threadIdx.x] + red[kGn + threadIdx.x];
}

// dx (+)= ds . head_chunk: grid (row tiles of x, column tiles of e).
template <typename T>
__global__ void __launch_bounds__(kGThreads, gemm_min_blocks<T>())
    ce_wide_dx_kernel(const WideArgs a) {
  extern __shared__ __align__(128) unsigned char gsmem[];
  const int m0 = blockIdx.x * kGm, n0 = blockIdx.y * kGn;
  // A = ds [n][ld] (its columns past kc are the ds pass's zeros), B = the
  // chunk's head rows [kc][e]
  const T* head_rows = static_cast<const T*>(a.head) + (long long)a.v0 * a.e;
  const GOperand<T> A = {static_cast<const T*>(a.ds), a.ld, a.n, a.ld};
  const GOperand<T> B = {head_rows, a.e, a.kc, a.e};
  GAcc acc;
  gemm_block<T, true, false>(acc, A, B, m0, n0, a.kc, reinterpret_cast<T*>(gsmem));
  T* out = static_cast<T*>(a.out);
  for_acc(acc, [&](int r, int c, float v, int, int, int) {
    const int row = m0 + r, col = n0 + c;
    if (row >= a.n || col >= a.e) return;
    const long long i = (long long)row * a.e + col;
    if (!a.first) v = __ldcg(a.acc + i) + v;       // the earlier chunks' sum, in chunk order
    if (a.last)
      out[i] = from_f<T>(v);
    else
      a.acc[i] = v;
  });
}

// dhead[v0 : v0 + kc] = ds^T . x: grid (row tiles of the chunk, column tiles
// of e); with a bias, the blocks of column tile 0 also write dbias.
template <typename T>
__global__ void __launch_bounds__(kGThreads, gemm_min_blocks<T>())
    ce_wide_dhead_kernel(const WideArgs a) {
  extern __shared__ __align__(128) unsigned char gsmem[];
  const int m0 = blockIdx.x * kGm, n0 = blockIdx.y * kGn;
  // A = ds^T: ds [n][ld] read with the chunk's columns as M; B = x [n][e]
  const GOperand<T> A = {static_cast<const T*>(a.ds), a.ld, a.n, a.ld};
  const GOperand<T> B = {static_cast<const T*>(a.x), a.e, a.n, a.e};
  GAcc acc;
  gemm_block<T, false, false>(acc, A, B, m0, n0, a.n, reinterpret_cast<T*>(gsmem));
  T* out = static_cast<T*>(a.out) + (long long)a.v0 * a.e;
  for_acc(acc, [&](int r, int c, float v, int, int, int) {
    const int row = m0 + r, col = n0 + c;
    if (row < a.kc && col < a.e) out[(long long)row * a.e + col] = from_f<T>(v);
  });
  if (a.dbias == nullptr || blockIdx.y != 0 || threadIdx.x >= kGm) return;
  const int row = m0 + threadIdx.x;
  if (row >= a.kc) return;
  float sum = 0.f;
  for (int rt = 0; rt < cdiv(a.n, kGm); ++rt) sum += a.colsum[(long long)rt * a.ld + row];
  a.dbias[a.v0 + row] = sum;
}


// --------------------------------------------------------------------------
// launches
// --------------------------------------------------------------------------

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool aligned(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// build links no -lcuda); null if the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a row-major bf16 [rows][cols] matrix read in boxes of
// box_rows x kWgK with the 128-byte swizzle; reads past either edge fill
// zeros.
bool bf16_tile_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)kWgK, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// One forward launch: row tiles along x, `splits` vocab splits along y.
cudaError_t launch_fwd(const void* x, const void* head, FwdArgs a, int bf16_inputs, int splits,
                       cudaStream_t st) {
  if (bf16_inputs) {
    a.per_split = cdiv(cdiv(a.v, kWgCols), splits);
    CUtensorMap tm_x, tm_head;
    if (!bf16_tile_map(&tm_x, x, a.n, a.e, kWgRows) ||
        !bf16_tile_map(&tm_head, head, a.v, a.e, kWgCols))
      return cudaErrorInvalidValue;
    const auto kernel = a.bias != nullptr ? ce_fwd_wgmma_kernel<true> : ce_fwd_wgmma_kernel<false>;
    cudaError_t err = prepare(kernel, kWgSmem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(cdiv(a.n, kWgRows), splits), kWgThreads, kWgSmem, st>>>(tm_x, tm_head, a);
    return cudaGetLastError();
  }
  a.per_split = cdiv(cdiv(a.v, kFwdCols), splits);
  cudaError_t err = prepare(ce_fwd_kernel, FwdLayout::kBytes);
  if (err != cudaSuccess) return err;
  ce_fwd_kernel<<<dim3(cdiv(a.n, kFwdRows), splits), kThreads, FwdLayout::kBytes, st>>>(
      (const float*)x, (const float*)head, a);
  return cudaGetLastError();
}

// One backward launch: clusters of C blocks along x, `splits` along y.
template <typename T, bool kDhead>
cudaError_t launch_bwd(BwdArgs a, int splits, cudaStream_t st) {
  const int C = cluster_of(a.e);
  a.w = slice_of(a.e, C);
  const int tiles = cdiv(kDhead ? a.v : a.n, Bwd<T>::kRows);
  a.n_pad = tiles * Bwd<T>::kRows;
  a.per_split = cdiv(cdiv(a.v, Bwd<T>::kStream), splits);
  const size_t smem = BwdLayout<T>::kBytes;
  cudaError_t err = prepare(ce_bwd_kernel<T, kDhead>, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * C, splits);
  cfg.blockDim = dim3(Bwd<T>::kWarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ce_bwd_kernel<T, kDhead>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
int active_clusters(int e) {
  const int C = cluster_of(e);
  const size_t smem = BwdLayout<T>::kBytes;
  if (prepare(ce_bwd_kernel<T, false>, smem) != cudaSuccess) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * 1024);
  cfg.blockDim = dim3(Bwd<T>::kWarps * 32);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, ce_bwd_kernel<T, false>, &cfg) == cudaSuccess ? n : 0;
}

bool shape_ok(int n, int e, int v, int vocab_size, int dtype) {
  return n > 0 && e > 0 && e % 8 == 0 && v > 0 && vocab_size > 0 && vocab_size <= v &&
         (dtype == 0 || dtype == 1);
}

// One launch of the wide backward: which 0 the ds pass of dx, 1 that of
// dhead, 2 the dx product, 3 the dhead product.
template <typename T>
cudaError_t launch_wide(int which, const WideArgs& a, cudaStream_t st) {
  const int row_tiles = cdiv(which == 3 ? a.kc : a.n, kGm);
  const int col_tiles = cdiv(which <= 1 ? a.kc : a.e, kGn);
  const dim3 grid(row_tiles, col_tiles);
  auto run = [&](auto kernel, size_t smem) {
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kGThreads, smem, st>>>(a);
    return cudaGetLastError();
  };
  switch (which) {
    case 0: return run(ce_wide_ds_kernel<T, false>, gemm_smem<T>(true, true));
    case 1: return run(ce_wide_ds_kernel<T, true>, gemm_smem<T>(true, true));
    case 2: return run(ce_wide_dx_kernel<T>, gemm_smem<T>(true, false));
    default: return run(ce_wide_dhead_kernel<T>, gemm_smem<T>(false, false));
  }
}

// The chunk [v0, v0 + ld) of the wide backward: checks, then one launch.
int wide(int which, WideArgs a, int dtype, void* stream) {
  if (!shape_ok(a.n, a.e, a.v, a.vocab_size, dtype) || a.ld <= 0 || a.ld % kGn || a.v0 < 0 ||
      a.v0 >= a.v || a.v0 % kGn || (which == 2 && a.acc == nullptr && !(a.first && a.last)) ||
      cdiv(a.ld, kGn) > 65535 || cdiv(a.e, kGn) > 65535 || !aligned(a.x) || !aligned(a.head) ||
      !aligned(a.ds))
    return (int)cudaErrorInvalidValue;
  a.kc = a.v - a.v0 < a.ld ? a.v - a.v0 : a.ld;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0 ? launch_wide<float>(which, a, st) : launch_wide<bf16>(which, a, st));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Each returns a cudaError_t (0 = launched).
// part: [splits][3][n] fp32 scratch; counters: ceil(n / 128) ints, 0 before
// the first launch (each launch leaves them so).  bf16 reads vocab tiles of
// 256 columns, fp32 of 128; splits <= the vocab tiles.
int dst_ce_forward(const void* x, const void* head, const int* labels, const float* bias,
                   float* part, int* counters, float* nll, float* lse, int n, int e, int v,
                   int vocab_size, int splits, int dtype, void* stream) {
  const int v_tiles = cdiv(v, dtype == 1 ? kWgCols : kFwdCols);
  if (!shape_ok(n, e, v, vocab_size, dtype) || splits <= 0 || splits > v_tiles ||
      splits > 65535 || !aligned(x) || !aligned(head))
    return (int)cudaErrorInvalidValue;
  const FwdArgs a = {labels, part, counters, nll, lse, n, e, v, vocab_size, 0, bias};
  return (int)launch_fwd(x, head, a, dtype == 1, splits, (cudaStream_t)stream);
}

// Blocks of the forward kernel for `dtype` one SM holds at once (0 on an
// error); its dynamic shared memory per block in *smem_bytes.
int dst_ce_forward_occupancy(int dtype, int* smem_bytes) {
  if ((dtype != 0 && dtype != 1) || smem_bytes == nullptr) return 0;
  int n = 0;
  if (dtype == 1) {
    *smem_bytes = (int)kWgSmem;
    if (prepare(ce_fwd_wgmma_kernel<false>, kWgSmem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ce_fwd_wgmma_kernel<false>, kWgThreads,
                                                      kWgSmem) != cudaSuccess)
      return 0;
  } else {
    *smem_bytes = (int)FwdLayout::kBytes;
    if (prepare(ce_fwd_kernel, FwdLayout::kBytes) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ce_fwd_kernel, kThreads,
                                                      FwdLayout::kBytes) != cudaSuccess)
      return 0;
  }
  return n;
}

// Clusters of the dx kernel the current device holds at once at width e
// (0 if it holds none, or e is not taken).
int dst_ce_backward_active_clusters(int e, int dtype) {
  if (e <= 0 || e % 8 || cluster_of(e) == 0 || (dtype != 0 && dtype != 1)) return 0;
  return dtype == 0 ? active_clusters<float>(e) : active_clusters<bf16>(e);
}

// With splits > 1 (vocab splits of dx), part is [splits][ceil(n / R) * R][e]
// fp32 scratch and counters ceil(n / R) * 8 zeroed ints (a cluster has at
// most 8 blocks), R = 128 rows per tile in bf16, 64 in fp32.  gscale: one fp32 on the device
// (dloss / N).
int dst_ce_backward_dx(const void* x, const void* head, const int* labels, const float* lse,
                       const float* gscale, void* dx, float* part, int* counters, int n, int e,
                       int v, int vocab_size, int splits, int dtype, void* stream) {
  if (!shape_ok(n, e, v, vocab_size, dtype) || cluster_of(e) == 0 || splits <= 0 ||
      splits > 65535 || !aligned(x) || !aligned(head))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a = {x, head, labels, lse, gscale, dx, part, counters, n, e, v, vocab_size,
                     0, 0, 0};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0 ? launch_bwd<float, false>(a, splits, st)
                          : launch_bwd<bf16, false>(a, splits, st));
}

int dst_ce_backward_dhead(const void* x, const void* head, const int* labels, const float* lse,
                          const float* gscale, void* dh, int n, int e, int v, int vocab_size,
                          int dtype, void* stream) {
  if (!shape_ok(n, e, v, vocab_size, dtype) || cluster_of(e) == 0 || !aligned(x) ||
      !aligned(head))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a = {x, head, labels, lse, gscale, dh, nullptr, nullptr, n, e, v, vocab_size,
                     0, 0, 0};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0 ? launch_bwd<float, true>(a, 1, st) : launch_bwd<bf16, true>(a, 1, st));
}

// The wide backward (any e that is a multiple of 8; a head bias), one chunk
// of ld vocab columns [v0, v0 + ld) per call (ld and v0 multiples of 128).
// ds: scratch [n][ld] in the input dtype.  The ds pass (for_dhead: the
// dhead entry point's, which with a bias also writes colsum [ceil(n / 128)]
// [ld] fp32); bias fp32 [v] or null.
int dst_ce_wide_ds(const void* x, const void* head, const int* labels, const float* lse,
                   const float* gscale, const float* bias, void* ds, float* colsum, int n, int e,
                   int v, int vocab_size, int v0, int ld, int for_dhead, int dtype,
                   void* stream) {
  WideArgs a = {};
  a.x = x; a.head = head; a.labels = labels; a.lse = lse; a.gscale = gscale; a.bias = bias;
  a.ds = ds; a.colsum = for_dhead ? colsum : nullptr;
  a.n = n; a.e = e; a.v = v; a.vocab_size = vocab_size; a.v0 = v0; a.ld = ld;
  return wide(for_dhead ? 1 : 0, a, dtype, stream);
}

// dx (+)= ds . head[v0 : v0 + ld]: first / last mark the chunk's place;
// acc is the fp32 buffer [n][e] the chunks sum in (unused when the one
// chunk is both), dx [n][e] is written by the last.
int dst_ce_wide_dx(const void* x, const void* head, const void* ds, float* acc, void* dx, int n,
                   int e, int v, int vocab_size, int v0, int ld, int first, int last, int dtype,
                   void* stream) {
  WideArgs a = {};
  a.x = x; a.head = head; a.ds = const_cast<void*>(ds); a.acc = acc; a.out = dx;
  a.n = n; a.e = e; a.v = v; a.vocab_size = vocab_size; a.v0 = v0; a.ld = ld;
  a.first = first; a.last = last;
  return wide(2, a, dtype, stream);
}

// dhead[v0 : v0 + ld] = ds^T . x; with dbias (fp32 [v]) also dbias[v0 : v0 +
// ld] from the ds pass's colsum.
int dst_ce_wide_dhead(const void* x, const void* head, const void* ds, const float* colsum,
                      void* dhead, float* dbias, int n, int e, int v, int vocab_size, int v0,
                      int ld, int dtype, void* stream) {
  WideArgs a = {};
  a.x = x; a.head = head; a.ds = const_cast<void*>(ds); a.colsum = const_cast<float*>(colsum);
  a.out = dhead;
  a.dbias = colsum != nullptr ? dbias : nullptr;
  a.n = n; a.e = e; a.v = v; a.vocab_size = vocab_size; a.v0 = v0; a.ld = ld;
  return wide(3, a, dtype, stream);
}

}  // extern "C"
