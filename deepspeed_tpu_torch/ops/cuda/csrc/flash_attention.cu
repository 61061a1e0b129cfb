// Flash attention for Hopper (sm_90a): the forward, dQ and dKV kernels.
//
// Replaces ops/pallas/flash_attention.py:_fwd_kernel, :_bwd_dq_kernel and
// :_bwd_dkv_kernel of the JAX package.  Per (batch b, query head h, kv head
// hk = h / group), with s = q . k^T * scale in fp32, plus an optional dense
// fp32 bias and ALiBi slope_h * (key - query), causal columns past the row
// masked:
//     forward: o = softmax(s) . v,  lse = m + log(l)  (online softmax)
//     dQ:      dq = ds . k
//     dKV:     dk = sum over the group's heads of ds^T . q,  dv = sum p^T . do
// where p = exp(s - lse) and ds = p * (dp - delta) * scale with
// dp = do . v^T and delta = rowsum(do * o) (computed outside, as in JAX).
// Rounding as JAX's kernels: products accumulate in fp32; p is rounded to
// v's (and do's) dtype before p . v and p^T . do, ds to the input dtype
// before ds . k and ds^T . q; o, dq, dk, dv are written in the input dtype.
//
// Bound: at GPT-2's training shape (B 8, S 512, H 12, D 64, bf16, causal)
// the forward moves 25 MB and does 3.2 GFLOP: about 7.6 us of memory time
// against 3.3 us of tensor-core time, so bytes bind; dQ and dKV do two to
// three times the products over a few more tensors and sit near the same
// line.  At Llama-3-8B's training shape (B 4, S 2048, H 32 over 8 kv heads,
// D 128, bf16) the forward does 137 GFLOP over 168 MB: 0.14 ms of
// tensor-core time against 0.05 ms of memory time, so there operations
// bind.  What a simple kernel does about it: each input tile is read from
// device memory once per block that needs it, scores and probabilities never
// leave registers, and fully masked key tiles are skipped.
//
// Design (wgmma, TMA and warp specialisation are later work).  All three
// kernels share it:
// * One block of 4 warps per 64-row tile, each warp 16 rows: query rows in
//   the forward and dQ, key rows in dKV (at head_dim 256: the bf16 forward
//   8 warps, 128 rows; dKV two warps per 16 rows; fp32 dQ and dKV 32 rows a
//   block).  The forward's grid is query tiles
//   x heads x batch, each head's longest causal rows first; dQ's and dKV's
//   is heads x batch x tiles, so that every head's longest causal walk is
//   dispatched before any shorter one (12-13 % faster at GPT-2's training
//   shape than each head's tiles together: the short walks fill the tail).
// * The rows the block owns are staged once; the other side's tiles stream
//   through two shared-memory buffers (one in fp32 at 256) by cp.async (K
//   and V in the forward and dQ; Q, dO, lse and delta in dKV).  dQ and dKV
//   issue the next tile's copies right after their one barrier per tile,
//   which also tells every warp is done with the buffer being refilled.
// * bf16: the warp's own rows are loaded once by ldmatrix and held in
//   registers as mma.sync m16n8k16 A fragments (RowFragments: Q in the
//   forward, Q and dO in dQ, K and V in dKV); the streamed tile's fragments
//   come by ldmatrix for s = rows . tile^T and by ldmatrix.trans for acc +=
//   p . tile (pv_tile), one instruction per four 8x8 matrices.  fp32 keeps
//   FMA products (product_nt / product_pv) in the same register layout (no
//   TF32), p and ds passed between the four threads of a row group by
//   shuffles.
// * The score tile stays in the mma accumulator layout (thread: rows g and
//   g + 8, columns 2t and 2t + 1 of each 8-column slice), which is also the
//   A-operand layout of the next product, so p and ds go to the tensor cores
//   from registers.  dQ forms its score tiles 32 keys wide (kDqCols), so
//   that a warp skips the half of its diagonal tile past its last row and
//   the score tile and dp take half the registers; dKV forms them 64
//   queries wide (kDkvCols).
// * Exponentials in log2 units, one ex2.approx each.  The forward keeps its
//   scores and running max there (q . k * scale * log2(e); the running max
//   starts at -1e30 * log2(e), so a row a bias masks wholly still averages
//   uniformly) and converts lse back at the end, lse = (m2 + log2 l) * ln 2,
//   the natural-log value dQ, dKV and remat read.  dQ and dKV form p =
//   2^(s * scale * log2(e) - lse * log2(e)), dQ with lse converted once per
//   row in registers, dKV once per column pair as it reads lse from shared
//   memory (lse and delta arrive there by asynchronous copies, a float2 of
//   each per 8-column slice read, not one per score); ds = p (dp - delta) *
//   scale keeps its natural units.
// * Masking by value only on edge tiles: a warp's causal diagonal tile and a
//   tile that crosses S (in its rows or its columns).  A tile wholly past a
//   warp's causal range is skipped by that warp.  The no-bias, no-ALiBi path
//   (GPT-2's) is its own instantiation, with the scale folded into the
//   exponential's FFMA: one multiply-add per score.
// * Blocks per SM fixed by __launch_bounds__ after measuring the options
//   (PERF.md; python -m deepspeed_tpu_torch.ops.cuda.flash_variants): the
//   forward 3 (up to 168 registers a thread), so that one block's loads and
//   softmax overlap another's products; dQ 3 on GPT-2's bf16 path, 2 on the
//   others, where 168 registers would spill; dKV 2 (K, V, dK and dV take 96
//   registers a thread before any score: at 168 it spills).
// * head_dim 128 (LLaMA, BLOOM): every kernel is a template on the width D,
//   and the 64-wide instantiations are the code above.  At 128 the row
//   tiles double (a 64-row tile of 128 bf16 is 17 KB), so a forward block
//   takes 87 KB of shared memory in bf16 (169 KB in fp32), dQ 102 KB (198
//   KB) and dKV 103 KB (199 KB): two blocks an SM in bf16, one in fp32, and
//   __launch_bounds__ asks for 2 (255 registers a thread).  The forward's
//   and dQ's accumulators double to 64 registers a thread; dKV's dK and dV
//   to 128, so there K and V stay in shared memory and are read by
//   ldmatrix at each product (SharedRows) instead of held in registers,
//   and its score tiles are 32 queries wide: registers for dK, dV, s and dp
//   (~192) instead of ~256 with K and V held.
// * head_dim 96 (GPT-NeoX-20B) and 256 (GPT-J).  At 96 the tiles are 12
//   ldmatrix columns of 8 (rows of 208 bytes, still conflict-free) and every
//   kernel is the 128 one at three quarters of the width: a forward block
//   takes 65 KB in bf16, dQ 80 KB (154 KB in fp32), dKV 81 KB (155 KB).
//   At 256 the forward's and dQ's accumulators are 128 registers a thread,
//   so their own rows (Q; Q and dO) stay in shared memory (SharedRows) and
//   __launch_bounds__ asks for one block an SM: the bf16 forward a block of
//   8 warps, 128 query rows (198 KB; fwd_warps), bf16 dQ 4 warps and two K
//   and V buffers (198 KB).  fp32 does not fit so: its forward keeps 4
//   warps and one K and one V buffer (195 KB; fwd_bufs), its dQ 32 query
//   rows (2 warps) and one buffer (195 KB; half_block), so their next tile's
//   copies wait for the barrier that ends the current one.  dKV's dK and dV
//   at 256 would be 256 registers a thread, past the 255 a thread may
//   have: each is split over a pair of warps (dkv_halves), which take the
//   same 16 key rows and one column half of dK and dV each (8 warps a
//   block, 199 KB in bf16).  Both warps of a pair need the same p and ds,
//   and each forms them itself (s and dp over the full depth): 1.5 times
//   the products of one warp doing all of it, where summing half-depth
//   partial scores through shared memory would take 16 KB more and two
//   pair barriers a score tile.  fp32 dKV at 256 takes 32 key rows (4
//   warps) and one Q, dO buffer (196 KB; half_block).
// * The online softmax keeps m, l and the accumulator in fp32 registers;
//   out-of-range and causally masked columns are -inf, exactly zero weight,
//   never 0/0 (l = 0 gives o = 0).
// * Causal: the forward and dQ walk key tiles up to the query tile's last
//   row, dKV walks query tiles from the key tile on.
// * GQA: the forward and dQ read kv head h / group; dKV loops over the
//   group's query heads inside one block, so grouped K/V are never expanded
//   and dK/dV are summed in a fixed order with no atomics.
// * Inputs are read by strides ([B, S, H, D] views, e.g. of the model's qkv
//   product), head_dim contiguous; outputs are written contiguous.  Rows past
//   S are zero-filled in shared memory and never written.

#include <type_traits>

#include "attention_tile.cuh"

namespace {

struct Params {
  const void* q; const void* k; const void* v; const void* dout;
  const float* bias; const float* slopes; const float* lse_in; const float* delta;
  void* o; float* lse; void* dq; void* dk; void* dv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh;
  long long b_sb, b_sh, b_sq, b_sk;   // bias strides (0 where it broadcasts)
  int S, H, Hkv, group, causal;
  float scale;
};

// --------------------------------------------------------------------------
// forward: one block of 4 warps per (64-query tile, head, batch)
// --------------------------------------------------------------------------

constexpr int kFwdBlocksPerSm = 3;                // head_dim 64: up to 168 registers a thread
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Blocks per SM __launch_bounds__ asks for: kFwdBlocksPerSm at head_dim 64;
// at 96 and 128 two (a cap of 255 registers a thread: the accumulator alone
// is 48 or 64), which is all the shared memory holds at 128 in bf16 (87 KB a
// block; fp32's 169 KB holds one); at 256 one (the accumulator is 128
// registers; a bf16 block takes 165 KB, an fp32 one 195 KB)
template <int D>
constexpr int fwd_min_blocks() {
  return D == 64 ? kFwdBlocksPerSm : D <= 128 ? 2 : 1;
}

// Warps of a forward block, 16 query rows each: 4; 8 in bf16 at 256, where
// one block fills an SM's shared memory, so that 8 warps (not 4) hide its
// latency and each K and V tile staged serves 128 query rows
template <typename T, int D>
__host__ __device__ constexpr int fwd_warps() {
  return sizeof(T) == 2 && D == 256 ? 8 : 4;
}

template <typename T, int D>
__host__ __device__ constexpr int fwd_rows() {    // query rows of a forward block
  return 16 * fwd_warps<T, D>();
}

template <typename T, int D>
__host__ __device__ constexpr int fwd_threads() {
  return 32 * fwd_warps<T, D>();
}

// K and V buffers of a forward block: two each, so the next key tile loads
// while this one is used, where they fit beside the query tile; one each
// for fp32 at 256 (the query tile and four buffers would be 325 KB)
template <typename T, int D>
__host__ __device__ constexpr int fwd_bufs() {
  return sizeof(T) * (fwd_rows<T, D>() + 4 * kTile) * Tr<T, D>::kLd <= kMaxSmem ? 2 : 1;
}

template <typename T, int D>
constexpr size_t fwd_smem_bytes() {               // the query tile, the K and V buffers
  return sizeof(T) * (fwd_rows<T, D>() + 2 * fwd_bufs<T, D>() * kTile) * Tr<T, D>::kLd;
}

// The warp's query rows (the forward's Q, dQ's Q and dO) as A operands:
// held in registers as ldmatrix fragments, except at 256, where they would
// take 64 registers a thread each beside the accumulator's 128, so they
// stay in shared memory and each product reads them by ldmatrix
// (SharedRows)
template <typename T, int D>
using QueryRows = std::conditional_t<D == 256, SharedRows<T, D>, RowFragments<T, D>>;

// With extras (a bias or ALiBi): s <- s * scale (+ bias) (+ slope * (key -
// query)), times log2(e).  Without (GPT-2's path) s stays as it is: the
// caller folds scale * log2(e) into the exponential's argument.  -inf where
// causally masked or out of range (kMask).  The tile's rows start at row0
// and its columns at col0; kKeyRows: rows are keys and columns queries (dKV).
template <bool kExtras, bool kMask, bool kKeyRows = false, int NJ>
__device__ __forceinline__ void scores_log2(float (&s)[NJ][4], const Params& p, const float* bias,
                                            float slope, int row0, int col0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + g + 8 * (i >> 1), c = col0 + j * 8 + 2 * t + (i & 1);
      const int qi = kKeyRows ? c : r, ki = kKeyRows ? r : c;
      float x = -INFINITY;
      if (!kMask || (qi < p.S && ki < p.S && !(p.causal && ki > qi))) {
        if (kExtras) {
          x = __fmul_rn(s[j][i], p.scale);
          if (bias != nullptr) x = __fadd_rn(x, bias[qi * p.b_sq + ki * p.b_sk]);
          if (p.slopes != nullptr) x = __fadd_rn(x, __fmul_rn(slope, (float)(ki - qi)));
          x = __fmul_rn(x, kLog2e);
        } else {
          x = s[j][i];
        }
      }
      s[j][i] = x;
    }
}

template <typename T, int D, bool kExtras>
__global__ void __launch_bounds__((fwd_threads<T, D>()), (fwd_min_blocks<D>()))
    flash_fwd_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TE = kTileElems<T, D>, L = Tr<T, D>::kLd, ND = D / 8, NB = fwd_bufs<T, D>();
  constexpr int kFwdRows = fwd_rows<T, D>(), kFwdThreads = fwd_threads<T, D>();
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = sq + kFwdRows * L;        // NB buffers each
  T* sv = sk + NB * TE;
  const int qt = gridDim.x - 1 - blockIdx.x;      // the longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = qt * kFwdRows, wrow0 = row0 + warp * 16;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const float* bias = kExtras && p.bias != nullptr ? p.bias + b * p.b_sb + h * p.b_sh : nullptr;
  const float slope = kExtras && p.slopes != nullptr ? p.slopes[h] : 0.f;
  // the factor from s to log2 units: folded into each exponential's FFMA on
  // the plain path; with extras s is already in log2 units
  const float to_log2 = kExtras ? 1.f : p.scale * kLog2e;
  const int n_all = cdiv(p.S, kTile);
  const int n_kv = p.causal ? min(cdiv(row0 + kFwdRows, kTile), n_all) : n_all;

  load_rows<T, kFwdRows, kFwdThreads, D>(sq, q, p.q_ss, row0, p.S);
  load_rows<T, kTile, kFwdThreads, D>(sk, k, p.k_ss, 0, p.S);
  load_rows<T, kTile, kFwdThreads, D>(sv, v, p.v_ss, 0, p.S);
  commit_copies();
  // m in log2 units; its start is JAX's -1e30 scaled as a score is, so a
  // row whose every column a bias sets to -1e30 still averages uniformly
  const float m0 = __fmul_rn(kNegInf, kLog2e);
  float m[2] = {m0, m0}, l[2] = {0.f, 0.f};
  float acc[ND][4];
  zero(acc);
  QueryRows<T, D> qf;
  for (int j = 0; j < n_kv; ++j) {
    const int buf = NB == 2 ? j & 1 : 0;
    if (NB == 2 && j + 1 < n_kv) {
      load_rows<T, kTile, kFwdThreads, D>(sk + (buf ^ 1) * TE, k, p.k_ss, (j + 1) * kTile, p.S);
      load_rows<T, kTile, kFwdThreads, D>(sv + (buf ^ 1) * TE, v, p.v_ss, (j + 1) * kTile, p.S);
      commit_copies();
      wait_copies<1>();
    } else {
      if (NB == 1 && j > 0) {         // the barrier ending the last tile freed the buffer
        load_rows<T, kTile, kFwdThreads, D>(sk, k, p.k_ss, j * kTile, p.S);
        load_rows<T, kTile, kFwdThreads, D>(sv, v, p.v_ss, j * kTile, p.S);
        commit_copies();
      }
      wait_copies<0>();
    }
    __syncthreads();
    if (j == 0) qf.load(sq + warp * 16 * L);
    const int col0 = j * kTile;
    // a key tile wholly past the warp's last row leaves its state as it is
    if (!p.causal || col0 <= wrow0 + 15) {
      float s[8][4];
      qf.product_nt(s, sk + buf * TE);
      // only the diagonal tile and a tile that crosses S are masked by value
      const bool edge =
          (p.causal && col0 + kTile - 1 > wrow0) || col0 + kTile > p.S || wrow0 + 16 > p.S;
      if (edge)
        scores_log2<kExtras, true>(s, p, bias, slope, wrow0, col0);
      else if (kExtras)
        scores_log2<kExtras, false>(s, p, bias, slope, wrow0, col0);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[jj][i]);
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {   // the running max in log2 units (to_log2 > 0)
        mx[r] = fmaxf(m[r], __fmul_rn(quad_max(mx[r]), to_log2));
        alpha[r] = exp2_approx(__fsub_rn(m[r], mx[r]));
        m[r] = mx[r];
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[jj][i] = exp2_approx(fmaf(s[jj][i], to_log2, -mx[i >> 1]));
          sum[i >> 1] += s[jj][i];
        }
      if (__any_sync(kFull, alpha[0] != 1.f || alpha[1] != 1.f)) {   // a row's max moved
#pragma unroll
        for (int jj = 0; jj < ND; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[jj][i] *= alpha[i >> 1];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];   // this thread's columns
      pv_tile(acc, s, sv + buf * TE);
    }
    __syncthreads();                   // every warp is done with buf before it is refilled
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
  T* o = static_cast<T*>(p.o) + (long long)b * p.S * p.H * D + h * D;
  store_rows<T>(o, (long long)p.H * D, acc, wrow0, p.S, inv);
  if (t == 0) {
    float* lse = p.lse + ((long long)b * p.H + h) * p.S;
#pragma unroll
    for (int r = 0; r < 2; ++r) {    // back to natural-log units, as dQ and dKV read it
      const int row = wrow0 + g + 8 * r;
      if (row < p.S) lse[row] = __fmul_rn(__fadd_rn(m[r], log2f(l[r])), kLn2);
    }
  }
}

// --------------------------------------------------------------------------
// dQ and dKV: a ring of kStages buffers for the streamed tiles, a tile's
// copies issued kStages - 1 tiles ahead, right after the one barrier per
// tile (a third buffer, copies two tiles ahead, measured no faster); fp32
// at head_dim 256 has one buffer, refilled after a second barrier a tile
// --------------------------------------------------------------------------

constexpr int kStages = 2;

// fp32 at head_dim 256: a dQ block with Q, dO and two K and V buffers would
// take 390 KB of shared memory (one buffer each: 260 KB), a dKV block with
// K, V and one Q and dO buffer 260 KB; so both take half the rows a block
// (dq_rows, dkv_rows) and one buffer for the streamed tiles: 195-196 KB
template <typename T, int D>
__host__ __device__ constexpr bool half_block() {
  return sizeof(T) == 4 && D == 256;
}

template <typename T, int D>
__host__ __device__ constexpr int bwd_stages() { // buffers of each streamed tile
  return half_block<T, D>() ? 1 : kStages;
}

// --------------------------------------------------------------------------
// dQ: one block per (query tile, head, batch), walking the key tiles
// --------------------------------------------------------------------------

constexpr int kDqWarps = 4;
constexpr int kDqRows = 16 * kDqWarps;            // query rows of a dQ block
constexpr int kDqBlocksPerSm = 3;                 // bf16 without extras (GPT-2's path)
constexpr int kDqCols = 32;                       // key columns of a score tile

// Blocks per SM __launch_bounds__ asks for: GPT-2's path kDqBlocksPerSm (up
// to 168 registers a thread); the bias / ALiBi and fp32 paths 2, where they
// spill nothing (fp32's shared memory holds two blocks an SM anyway).  At
// head_dim 96 and 128, 2: Q's and dO's fragments and the accumulator take
// 96 or 128 registers a thread before any score, and the shared memory (80
// or 102 KB a block in bf16, 154 or 198 KB in fp32) holds two blocks an SM
// at most.  At 256, 1: the accumulator alone is 128 registers a thread
// (Q and dO are read from shared memory) and a block takes 195-198 KB.
template <typename T, int D, bool kExtras>
constexpr int dq_min_blocks() {
  return D == 64 && sizeof(T) == 2 && !kExtras ? kDqBlocksPerSm : D == 256 ? 1 : 2;
}

template <typename T, int D>
__host__ __device__ constexpr int dq_rows() {    // query rows of a dQ block
  return half_block<T, D>() ? kDqRows / 2 : kDqRows;
}

template <typename T, int D>
__host__ __device__ constexpr int dq_threads() {
  return 2 * dq_rows<T, D>();                     // a warp per 16 rows
}

template <typename T, int D>
constexpr size_t dq_smem_bytes() {                // Q and dO, the K and V buffers
  return sizeof(T) * (2 * dq_rows<T, D>() + 2 * bwd_stages<T, D>() * kTile) * Tr<T, D>::kLd;
}

// grid: heads x batch x query tiles, the longest causal rows dispatched first
template <typename T, int D, bool kExtras>
__global__ void __launch_bounds__((dq_threads<T, D>()), (dq_min_blocks<T, D, kExtras>()))
    flash_dq_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TE = kTileElems<T, D>, L = Tr<T, D>::kLd, NS = bwd_stages<T, D>();
  constexpr int NJ = kDqCols / 8, ND = D / 8, kRows = dq_rows<T, D>();
  constexpr int kThreads = dq_threads<T, D>();
  T* sq = reinterpret_cast<T*>(smem);
  T* sdo = sq + kRows * L;
  T* sk = sdo + kRows * L;          // NS buffers each
  T* sv = sk + NS * TE;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / p.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int row0 = qt * kRows, wrow0 = row0 + warp * 16;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const float* bias = kExtras && p.bias != nullptr ? p.bias + b * p.b_sb + h * p.b_sh : nullptr;
  const float slope = kExtras && p.slopes != nullptr ? p.slopes[h] : 0.f;
  const float to_log2 = kExtras ? 1.f : p.scale * kLog2e;
  const int n_all = cdiv(p.S, kTile);
  const int n_kv = p.causal ? min(cdiv(row0 + kRows, kTile), n_all) : n_all;
  const long long stat0 = ((long long)b * p.H + h) * p.S;
  float lse2[2], delta[2];          // lse in log2 units
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow0 + g + 8 * r;
    lse2[r] = row < p.S ? __fmul_rn(p.lse_in[stat0 + row], kLog2e) : 0.f;
    delta[r] = row < p.S ? p.delta[stat0 + row] : 0.f;
  }

  load_rows<T, kRows, kThreads, D>(sq, q, p.q_ss, row0, p.S);
  load_rows<T, kRows, kThreads, D>(sdo, dout, p.do_ss, row0, p.S);
#pragma unroll
  for (int st = 0; st < (NS > 1 ? NS - 1 : 1); ++st) {   // one buffer: the first tile
    if (st < n_kv) {
      load_rows<T, kTile, kThreads, D>(sk + st * TE, k, p.k_ss, st * kTile, p.S);
      load_rows<T, kTile, kThreads, D>(sv + st * TE, v, p.v_ss, st * kTile, p.S);
    }
    commit_copies();
  }
  float dq[ND][4];
  zero(dq);
  QueryRows<T, D> qf, dof;
  for (int j = 0, buf = 0; j < n_kv; ++j, buf = buf + 1 == NS ? 0 : buf + 1) {
    if constexpr (NS == 1) {
      if (j > 0) {   // one K and V buffer: refilled once every warp is done with tile j - 1
        __syncthreads();
        load_rows<T, kTile, kThreads, D>(sk, k, p.k_ss, j * kTile, p.S);
        load_rows<T, kTile, kThreads, D>(sv, v, p.v_ss, j * kTile, p.S);
        commit_copies();
      }
      wait_copies<0>();                // key tile j has landed
      __syncthreads();
    } else {
      wait_copies<NS - 2>();           // key tile j has landed
      __syncthreads();
      const int next = j + NS - 1, nbuf = buf == 0 ? NS - 1 : buf - 1;
      if (next < n_kv) {
        load_rows<T, kTile, kThreads, D>(sk + nbuf * TE, k, p.k_ss, next * kTile, p.S);
        load_rows<T, kTile, kThreads, D>(sv + nbuf * TE, v, p.v_ss, next * kTile, p.S);
      }
      commit_copies();
    }
    if (j == 0) {
      qf.load(sq + warp * 16 * L);
      dof.load(sdo + warp * 16 * L);
    }
#pragma unroll 1
    for (int c = 0; c < kTile; c += kDqCols) {
      const int col0 = j * kTile + c;
      // key columns wholly past the warp's last row add nothing to its rows
      if (p.causal && col0 > wrow0 + 15) break;
      const T* k_cols = sk + buf * TE + c * L;
      float s[NJ][4], dp[NJ][4];
      qf.product_nt(s, k_cols);
      dof.product_nt(dp, sv + buf * TE + c * L);
      // only the diagonal and columns or rows that cross S are masked by value
      const bool diagonal = p.causal && col0 + kDqCols - 1 > wrow0;
      if (diagonal || col0 + kDqCols > p.S || wrow0 + 16 > p.S)
        scores_log2<kExtras, true>(s, p, bias, slope, wrow0, col0);
      else if (kExtras)
        scores_log2<kExtras, false>(s, p, bias, slope, wrow0, col0);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pr = exp2_approx(fmaf(s[jj][i], to_log2, -lse2[i >> 1]));
          s[jj][i] = pr * (dp[jj][i] - delta[i >> 1]) * p.scale;    // ds
        }
      pv_tile(dq, s, k_cols);
    }
  }
  const float one[2] = {1.f, 1.f};
  T* out = static_cast<T*>(p.dq) + (long long)b * p.S * p.H * D + h * D;
  store_rows<T>(out, (long long)p.H * D, dq, wrow0, p.S, one);
}

// --------------------------------------------------------------------------
// dKV: one block per (key tile, kv head, batch), walking the group's query
// heads and, for each, the query tiles from the diagonal on
// --------------------------------------------------------------------------

constexpr int kDkvWarps = 4;
constexpr int kDkvRows = 16 * kDkvWarps;          // key rows of a dKV block
constexpr int kDkvBlocksPerSm = 2;

// Query columns of a score tile: 64 at head_dim 64; 32 at 96, 128 and 256,
// where dK and dV alone take 96 or more registers a thread and a 64-wide s
// and dp 64 more.
template <int D>
__host__ __device__ constexpr int dkv_cols() {
  return D == 64 ? 64 : 32;
}

// Column halves of dK and dV, one warp each of a pair that shares 16 key
// rows: 2 at head_dim 256, where one warp's dK and dV would take 256
// registers a thread; 1 below
template <int D>
__host__ __device__ constexpr int dkv_halves() {
  return D == 256 ? 2 : 1;
}

template <typename T, int D>
__host__ __device__ constexpr int dkv_rows() {   // key rows of a dKV block
  return half_block<T, D>() ? kDkvRows / 2 : kDkvRows;
}

template <typename T, int D>
__host__ __device__ constexpr int dkv_threads() {
  return 2 * dkv_rows<T, D>() * dkv_halves<D>();  // a warp per 16 rows and column half
}

// Blocks per SM __launch_bounds__ asks for: kDkvBlocksPerSm; at 256 one
// (a block takes 196-199 KB of shared memory)
template <int D>
constexpr int dkv_min_blocks() {
  return D == 256 ? 1 : kDkvBlocksPerSm;
}

// K's and V's rows as A operands: held in registers at head_dim 64 (32
// registers a thread for both in bf16); wider, they stay in shared memory
// and each product reads them by ldmatrix (held, with dK, dV, s and dp,
// they would need ~256 registers a thread at 128).
template <typename T, int D>
using DkvRows = std::conditional_t<D == 64, RowFragments<T, D>, SharedRows<T, D>>;

template <typename T, int D>
constexpr size_t dkv_smem_bytes() {   // K and V, the Q, dO, lse and delta buffers
  constexpr int NS = bwd_stages<T, D>();
  return sizeof(T) * (2 * dkv_rows<T, D>() + 2 * NS * kTile) * Tr<T, D>::kLd +
         2 * NS * kTile * sizeof(float);
}

// Stage query tile `qt` of head h: Q and dO, lse and delta (zeros past S),
// all by cp.async, by THREADS threads.
template <typename T, int D, int THREADS>
__device__ __forceinline__ void load_query_tile(const Params& p, T* sq, T* sdo, float* slse,
                                                float* sdelta, int b, int h, int qt) {
  static_assert(THREADS >= 2 * kTile, "lse and delta take one thread per row each");
  const int row0 = qt * kTile;
  load_rows<T, kTile, THREADS, D>(sq, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh,
                                  p.q_ss, row0, p.S);
  load_rows<T, kTile, THREADS, D>(
      sdo, static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh, p.do_ss, row0, p.S);
  if (threadIdx.x < 2 * kTile) {
    const bool is_lse = threadIdx.x < kTile;
    const int i = threadIdx.x & (kTile - 1), row = row0 + i;
    const bool valid = row < p.S;
    const float* src = (is_lse ? p.lse_in : p.delta) + ((long long)b * p.H + h) * p.S;
    copy4_async((is_lse ? slse : sdelta) + i, valid ? src + row : src, valid);
  }
}

// grid: kv heads x batch x key tiles, the longest causal walks dispatched
// first
template <typename T, int D, bool kExtras>
__global__ void __launch_bounds__((dkv_threads<T, D>()), (dkv_min_blocks<D>()))
    flash_dkv_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TE = kTileElems<T, D>, L = Tr<T, D>::kLd, NS = bwd_stages<T, D>();
  constexpr int kDkvCols = dkv_cols<D>(), NJ = kDkvCols / 8;
  constexpr int kRows = dkv_rows<T, D>(), kThreads = dkv_threads<T, D>(), kGroups = kRows / 16;
  constexpr int DH = D / dkv_halves<D>(), ND = DH / 8;     // a warp's columns of dK and dV
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = sk + kRows * L;
  T* sq = sv + kRows * L;           // NS buffers each
  T* sdo = sq + NS * TE;
  float* slse = reinterpret_cast<float*>(sdo + NS * TE);    // [NS][kTile]
  float* sdelta = slse + NS * kTile;
  const int kt = blockIdx.z, hk = blockIdx.x, b = blockIdx.y;
  // the warp's 16 key rows (row group rg of the block's) and its column half
  const int rg = (threadIdx.x >> 5) % kGroups, half = (threadIdx.x >> 5) / kGroups;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int key0 = kt * kRows, wkey0 = key0 + rg * 16;
  const int n_q = cdiv(p.S, kTile), first = p.causal ? key0 / kTile : 0, per_head = n_q - first;
  const int total = p.group * per_head;
  const float to_log2 = kExtras ? 1.f : p.scale * kLog2e;
  // stage item `it` (query head it / per_head of the group, query tile
  // first + it % per_head) into buffer `buf`
  auto stage = [&](int it, int buf) {
    load_query_tile<T, D, kThreads>(p, sq + buf * TE, sdo + buf * TE, slse + buf * kTile,
                                    sdelta + buf * kTile, b, hk * p.group + it / per_head,
                                    first + it % per_head);
  };

  load_rows<T, kRows, kThreads, D>(
      sk, static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh, p.k_ss, key0, p.S);
  load_rows<T, kRows, kThreads, D>(
      sv, static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_ss, key0, p.S);
#pragma unroll
  for (int st = 0; st < (NS > 1 ? NS - 1 : 1); ++st) {   // one buffer: the first item
    if (st < total) stage(st, st);
    commit_copies();
  }
  float dk[ND][4], dv[ND][4];
  zero(dk);
  zero(dv);
  DkvRows<T, D> kf, vf;
  for (int it = 0, buf = 0; it < total; ++it, buf = buf + 1 == NS ? 0 : buf + 1) {
    if constexpr (NS == 1) {
      if (it > 0) {   // one buffer: refilled once every warp is done with item it - 1
        __syncthreads();
        stage(it, 0);
        commit_copies();
      }
      wait_copies<0>();                // item it has landed
      __syncthreads();
    } else {
      wait_copies<NS - 2>();           // item it has landed
      __syncthreads();
      if (it + NS - 1 < total) stage(it + NS - 1, buf == 0 ? NS - 1 : buf - 1);
      commit_copies();
    }
    if (it == 0) {
      kf.load(sk + rg * 16 * L);
      vf.load(sv + rg * 16 * L);
    }
    const int h = hk * p.group + it / per_head, q0 = (first + it % per_head) * kTile;
    const float* bias = kExtras && p.bias != nullptr ? p.bias + b * p.b_sb + h * p.b_sh : nullptr;
    const float slope = kExtras && p.slopes != nullptr ? p.slopes[h] : 0.f;
#pragma unroll 1
    for (int c = 0; c < kTile; c += kDkvCols) {
      const int qc = q0 + c;
      // query columns wholly before the warp's first key add nothing to its rows
      if (p.causal && qc + kDkvCols - 1 < wkey0) continue;
      const float* lse = slse + buf * kTile + c;
      const float* delta = sdelta + buf * kTile + c;
      const T* q_cols = sq + buf * TE + c * L;
      const T* do_cols = sdo + buf * TE + c * L;
      float s[NJ][4], dp[NJ][4];
      kf.product_nt(s, q_cols);                         // s^T: keys x queries
      vf.product_nt(dp, do_cols);                       // dp^T = v . do^T
      // only the diagonal and columns or rows that cross S are masked by value
      const bool edge =
          (p.causal && wkey0 + 15 > qc) || qc + kDkvCols > p.S || wkey0 + 16 > p.S;
      if (edge)
        scores_log2<kExtras, true, true>(s, p, bias, slope, wkey0, qc);
      else if (kExtras)
        scores_log2<kExtras, false, true>(s, p, bias, slope, wkey0, qc);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {   // p^T; lse read and put in log2 units per column pair
        const float2 l = *reinterpret_cast<const float2*>(lse + jj * 8 + 2 * t);
        const float l0 = __fmul_rn(l.x, kLog2e), l1 = __fmul_rn(l.y, kLog2e);
        s[jj][0] = exp2_approx(fmaf(s[jj][0], to_log2, -l0));
        s[jj][1] = exp2_approx(fmaf(s[jj][1], to_log2, -l1));
        s[jj][2] = exp2_approx(fmaf(s[jj][2], to_log2, -l0));
        s[jj][3] = exp2_approx(fmaf(s[jj][3], to_log2, -l1));
      }
      pv_tile<D>(dv, s, do_cols + half * DH);           // dv += p^T . do, the warp's columns
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {   // ds^T, delta read once per column pair
        const float2 d = *reinterpret_cast<const float2*>(delta + jj * 8 + 2 * t);
        s[jj][0] = s[jj][0] * (dp[jj][0] - d.x) * p.scale;
        s[jj][1] = s[jj][1] * (dp[jj][1] - d.y) * p.scale;
        s[jj][2] = s[jj][2] * (dp[jj][2] - d.x) * p.scale;
        s[jj][3] = s[jj][3] * (dp[jj][3] - d.y) * p.scale;
      }
      pv_tile<D>(dk, s, q_cols + half * DH);            // dk += ds^T . q, the warp's columns
    }
  }
  const float one[2] = {1.f, 1.f};
  const long long off = (long long)b * p.S * p.Hkv * D + hk * D + half * DH;
  store_rows<T>(static_cast<T*>(p.dk) + off, (long long)p.Hkv * D, dk, wkey0, p.S, one);
  store_rows<T>(static_cast<T*>(p.dv) + off, (long long)p.Hkv * D, dv, wkey0, p.S, one);
}

// --------------------------------------------------------------------------
// launches
// --------------------------------------------------------------------------

enum Which { kForward, kDq, kDkv };

template <typename T, int D>
cudaError_t run(Which which, const Params& p, int B, cudaStream_t st) {
  const bool extras = p.bias != nullptr || p.slopes != nullptr;
  switch (which) {
    case kForward: {
      const dim3 grid(cdiv(p.S, fwd_rows<T, D>()), p.H, B);
      constexpr size_t smem = fwd_smem_bytes<T, D>();
      constexpr int threads = fwd_threads<T, D>();
      return extras ? launch(flash_fwd_kernel<T, D, true>, grid, smem, p, st, threads)
                    : launch(flash_fwd_kernel<T, D, false>, grid, smem, p, st, threads);
    }
    case kDq: {
      const dim3 grid(p.H, B, cdiv(p.S, dq_rows<T, D>()));
      constexpr size_t smem = dq_smem_bytes<T, D>();
      constexpr int threads = dq_threads<T, D>();
      return extras ? launch(flash_dq_kernel<T, D, true>, grid, smem, p, st, threads)
                    : launch(flash_dq_kernel<T, D, false>, grid, smem, p, st, threads);
    }
    default: {
      const dim3 grid(p.Hkv, B, cdiv(p.S, dkv_rows<T, D>()));
      constexpr size_t smem = dkv_smem_bytes<T, D>();
      constexpr int threads = dkv_threads<T, D>();
      return extras ? launch(flash_dkv_kernel<T, D, true>, grid, smem, p, st, threads)
                    : launch(flash_dkv_kernel<T, D, false>, grid, smem, p, st, threads);
    }
  }
}

// Blocks of `kernel` that one SM holds at once with `smem` bytes of dynamic
// shared memory each (registers and shared memory both counted); 0 on an
// error.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, size_t smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess)
    return 0;
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) == cudaSuccess
             ? n
             : 0;
}

template <typename T, int D>
int occupancy(Which which, bool extras, int* smem) {
  switch (which) {
    case kForward: {
      *smem = (int)fwd_smem_bytes<T, D>();
      constexpr int threads = fwd_threads<T, D>();
      return extras ? blocks_per_sm(flash_fwd_kernel<T, D, true>, threads, *smem)
                    : blocks_per_sm(flash_fwd_kernel<T, D, false>, threads, *smem);
    }
    case kDq: {
      *smem = (int)dq_smem_bytes<T, D>();
      constexpr int threads = dq_threads<T, D>();
      return extras ? blocks_per_sm(flash_dq_kernel<T, D, true>, threads, *smem)
                    : blocks_per_sm(flash_dq_kernel<T, D, false>, threads, *smem);
    }
    default: {
      *smem = (int)dkv_smem_bytes<T, D>();
      constexpr int threads = dkv_threads<T, D>();
      return extras ? blocks_per_sm(flash_dkv_kernel<T, D, true>, threads, *smem)
                    : blocks_per_sm(flash_dkv_kernel<T, D, false>, threads, *smem);
    }
  }
}

// The head_dims every kernel is compiled for: 64, 96, 128 and 256.
bool head_dim_ok(int D) {
  return D == 64 || D == 96 || D == 128 || D == 256;
}

// strides: [q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, do_b, do_s, do_h,
// bias_b, bias_h, bias_q, bias_k], in elements.
int dispatch(Which which, Params p, const long long* strides, int B, int D, int dtype,
             void* stream) {
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.do_sb = strides[9]; p.do_ss = strides[10]; p.do_sh = strides[11];
  p.b_sb = strides[12]; p.b_sh = strides[13]; p.b_sq = strides[14]; p.b_sk = strides[15];
  const int vec = dtype == 0 ? 4 : 8;             // elements per 16 bytes
  // dQ's and dKV's tiles (of 32 rows in fp32 at 256) are the grid's z dimension
  bool ok = B > 0 && p.S > 0 && p.H > 0 && p.Hkv > 0 && p.H % p.Hkv == 0 && B <= 65535 &&
            p.H <= 65535 && (which == kForward || cdiv(p.S, kTile / 2) <= 65535) &&
            (dtype == 0 || dtype == 1) && head_dim_ok(D) && aligned16(p.q) &&
            aligned16(p.k) && aligned16(p.v) && (p.dout == nullptr || aligned16(p.dout));
  for (int i = 0; i < 12; ++i) ok = ok && strides[i] % vec == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  p.group = p.H / p.Hkv;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return (int)(dtype == 0 ? run<float, 64>(which, p, B, st) : run<bf16, 64>(which, p, B, st));
    case 128:
      return (int)(dtype == 0 ? run<float, 128>(which, p, B, st)
                              : run<bf16, 128>(which, p, B, st));
    case 96:
      return (int)(dtype == 0 ? run<float, 96>(which, p, B, st) : run<bf16, 96>(which, p, B, st));
    default:
      return (int)(dtype == 0 ? run<float, 256>(which, p, B, st)
                              : run<bf16, 256>(which, p, B, st));
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; D (head_dim): 64, 96, 128 or 256.
// Each returns a
// cudaError_t (0 = launched).  q [B, S, H, D], k and v [B, S, Hkv, D] by
// strides; bias fp32 by strides or null; slopes fp32 [H] or null; o
// contiguous [B, S, H, D]; lse fp32 contiguous [B, H, S].
int dst_flash_forward(const void* q, const void* k, const void* v, const float* bias,
                      const float* slopes, void* o, float* lse, const long long* strides, int B,
                      int S, int H, int Hkv, int D, float scale, int causal, int dtype,
                      void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.bias = bias; p.slopes = slopes; p.o = o; p.lse = lse;
  p.S = S; p.H = H; p.Hkv = Hkv; p.scale = scale; p.causal = causal;
  return dispatch(kForward, p, strides, B, D, dtype, stream);
}

// dout by strides like q; lse and delta fp32 contiguous [B, H, S]; dq
// contiguous [B, S, H, D].
int dst_flash_backward_dq(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, const float* bias,
                          const float* slopes, void* dq, const long long* strides, int B, int S,
                          int H, int Hkv, int D, float scale, int causal, int dtype,
                          void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse_in = lse; p.delta = delta; p.bias = bias;
  p.slopes = slopes; p.dq = dq;
  p.S = S; p.H = H; p.Hkv = Hkv; p.scale = scale; p.causal = causal;
  return dispatch(kDq, p, strides, B, D, dtype, stream);
}

// dk, dv contiguous [B, S, Hkv, D].
int dst_flash_backward_dkv(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, const float* bias,
                           const float* slopes, void* dk, void* dv, const long long* strides,
                           int B, int S, int H, int Hkv, int D, float scale, int causal,
                           int dtype, void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse_in = lse; p.delta = delta; p.bias = bias;
  p.slopes = slopes; p.dk = dk; p.dv = dv;
  p.S = S; p.H = H; p.Hkv = Hkv; p.scale = scale; p.causal = causal;
  return dispatch(kDkv, p, strides, B, D, dtype, stream);
}

// Blocks of one kernel (which: 0 forward, 1 dQ, 2 dKV; D: 64, 96, 128 or
// 256; extras: its bias / ALiBi instantiation) that one SM holds at once; its
// dynamic shared memory per block in *smem_bytes.  0 on an error.
int dst_flash_occupancy(int which, int dtype, int D, int extras, int* smem_bytes) {
  if (which < 0 || which > 2 || (dtype != 0 && dtype != 1) || !head_dim_ok(D) ||
      smem_bytes == nullptr)
    return 0;
  const Which w = (Which)which;
  const bool x = extras != 0;
  switch (D) {
    case 64:
      return dtype == 0 ? occupancy<float, 64>(w, x, smem_bytes)
                        : occupancy<bf16, 64>(w, x, smem_bytes);
    case 128:
      return dtype == 0 ? occupancy<float, 128>(w, x, smem_bytes)
                        : occupancy<bf16, 128>(w, x, smem_bytes);
    case 96:
      return dtype == 0 ? occupancy<float, 96>(w, x, smem_bytes)
                        : occupancy<bf16, 96>(w, x, smem_bytes);
    default:
      return dtype == 0 ? occupancy<float, 256>(w, x, smem_bytes)
                        : occupancy<bf16, 256>(w, x, smem_bytes);
  }
}

}  // extern "C"
