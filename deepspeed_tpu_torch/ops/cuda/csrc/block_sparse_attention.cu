// Block-sparse attention for Hopper (sm_90a): the forward, dQ and dKV
// kernels over a sparsity layout's lookup tables.
//
// Replaces ops/pallas/block_sparse_attention.py:_fwd_kernel, :_dq_kernel and
// :_dkv_kernel of the JAX package.  The layout is [H, nb, nb] blocks of 64
// tokens; the row LUT lists, for head h and query block i, the key blocks of
// layout row i (ascending), the column LUT, for key block j, the query blocks
// of layout column j.  Per (batch b, head h), with s = q . k^T * scale in
// fp32 over the listed blocks only, and under `causal` the keys past the
// query masked (inside a diagonal block; a listed block wholly in the future
// gives p = 0 everywhere, as JAX's where(s <= NEG_INF / 2, 0, ...) does):
//     forward: o = softmax(s) . v,  lse = m + log(max(l, 1e-30))
//     dQ:      dq = ds . k                   (over the row LUT)
//     dKV:     dk = ds^T . q,  dv = p^T . do  (over the column LUT)
// where p = exp(s - lse), ds = p * (dp - delta) * scale, dp = do . v^T and
// delta = rowsum(do * o) (computed outside, as in JAX).  A row with no
// listed block (or only future ones) gives o = 0, lse = -1e30 (JAX's
// -1e30 + log(1e-30) in fp32) and zero gradients.
// Rounding: products accumulate in fp32; the bf16 kernels round p to bf16
// before p . v and p^T . do, and ds before ds . k and ds^T . q (the tensor
// cores take bf16 operands; JAX's kernels keep p and ds in fp32, so the plain
// versions offer this rounding as an option); outputs in the input dtype.
//
// Bound: at the training path's shape (B 2, S 4096, H 12, D 64, bf16, the
// Sparse Transformer "fixed" layout with 640 of 4096 blocks per head) the
// forward moves 50.7 MB and does 16 GFLOP: about 15 us of memory time
// against 16 us of tensor-core time, so both lines meet; dQ and dKV do 1.5x
// and 2x the products over a few more tensors and are bound by operations.
// What a simple kernel does about it: only listed blocks are read or
// multiplied, each block's own tile is read once, scores and probabilities
// never leave registers.
//
// Design of the forward (flash forward's tile body over a work list made on
// the host; redesigned for Hopper):
// * The wrapper builds, once per layout and `causal`, a work list
//   (block_sparse_attention.py: build_fwd_tasks): a task is one (head,
//   query block) row's live key blocks (the causal filter applied on the
//   host, so no thread copies or filters a LUT row), marked where its last
//   block is the causal diagonal; every row has a task, an empty one
//   writing o = 0 and lse = -1e30.  Tasks run longest first across heads
//   and the grid is tasks x batch, batch fastest, so the longest walks of
//   every head start first and the short ones fill the tail.  The block
//   copies its task's entries to shared memory once, all threads together.
// * Per tile, the flash forward's body: Q held as ldmatrix fragments in
//   registers (RowFragments), K by ldmatrix and V by ldmatrix.trans
//   (pv_tile), scores in log2 units (scale * log2(e) folded into the
//   exponential's FFMA, one ex2.approx each), masking by value only on the
//   diagonal block, a ring of kFwdStages key / value buffers filled by
//   cp.async with one barrier per tile, blocks per SM by __launch_bounds__
//   (kFwdBlocksPerSm), read back by the occupancy query.  An empty row
//   writes JAX's lse = -1e30 directly: the log2 formula (m + log2 l) ln 2
//   would give -inf there (l = 0), and a running max started at -1e30
//   unscaled would give -1e30 ln 2.
// * What holds it (H100 SXM, 700 W; PERF.md, section 6): a live tile now
//   costs about what the flash forward's tile costs, so the tile body
//   (mma.sync on 16-row warp tiles) is the limit, not the walk; the
//   longest-first order is worth ~15 % (forward_variants.py).
//
// Design of dQ (the forward's work list; bf16 on warpgroup MMA; redesigned
// for Hopper):
// * dQ walks what the forward walks: each (head, query block) row's live
//   key blocks.  So it takes the forward's work list (build_fwd_tasks),
//   with its grid of tasks x batch, batch fastest, rows longest first
//   across heads, and the block's copy of its task's entries by all
//   threads.  Each dQ row is written by one block: no atomics, and two
//   launches on the same inputs give the same bits.  An empty task writes
//   dq = 0.
// * bf16 (sparse_dq_wgmma_kernel): the block's 4 warps are one warpgroup
//   and its 64 query rows the m64 of wgmma.  s = Q . K^T and dp = dO . V^T
//   take Q's and dO's ldmatrix fragments from registers (the A-operand
//   layout of mma.sync is wgmma's) and K or V from shared memory as a
//   K-major operand; dq += ds . K takes ds from registers and the same K
//   tile as an MN-major operand.  K and V land by cp.async with the
//   128-byte swizzle the descriptors name, in a ring of kStages buffers,
//   one barrier per tile.  The accumulators keep the mma.sync layout per
//   warp, so the mask, the exponentials and ds are the fp32 body's code.
//   About a quarter faster than the same walk on mma.sync
//   (forward_variants.py, "sparse-dq-mma-sync"; PERF.md, section 6).
// * fp32 (sparse_dq_kernel): flash dQ's tile body: Q and dO held in
//   shared memory, FMA products in the mma.sync register layout, score
//   tiles 32 keys wide (kDqCols), so that on the diagonal block a warp
//   skips the columns past its last row.
// * Both: lse put in log2 units once per row in registers, p = ex2.approx
//   of one FFMA (scale * log2(e) folded in), ds = p (dp - delta) * scale in
//   natural units, masking by value only on the task's diagonal block;
//   blocks per SM by __launch_bounds__ (kDqBlocksPerSm: bf16 3, fp32 2),
//   read back by the occupancy query.
//
// Design of dKV (flash dKV's tile body over a work list made on the host):
// * Under the "fixed" layout a global key block is listed by every later
//   query block (61 of 64 at S 4096) while a local one is listed by at most
//   4, so a grid of one block per key block has a long tail.  The wrapper
//   builds, once per layout, a work list (block_sparse_attention.py:
//   build_dkv_tasks): a task is one key block's live query blocks (the
//   causal filter applied on the host, so no block copies or filters its
//   LUT row), a column longer than the split length cut into near-equal
//   splits, every task sorted by walk length, longest first, across heads.
//   The grid is tasks x batch (batch fastest), so the longest walks start
//   first and the short ones fill the tail.  The split length is by default
//   the launch's balanced walk (its live tiles over the card's block slots):
//   cutting walks shorter than that costs more in partials than it saves.
// * A split writes its fp32 partial dK and dV to its own workspace slot and
//   counts its arrival on the column's counter (__threadfence, atomicAdd).
//   The block that arrives last sums the column's partials in split order
//   (its own from registers), so the result does not depend on the order
//   of arrival, writes dK and dV, and sets the counter back to 0 for the
//   next launch (or CUDA graph replay): one launch, no memset.  An unsplit
//   column writes dK and dV directly.  The workspace and counters belong to
//   one (layout, batch, device) and to one stream at a time.
// * Per tile, flash dKV's tools: the block's own K and V held as
//   ldmatrix fragments in registers (RowFragments), Q and dO tiles read by
//   ldmatrix / ldmatrix.trans (pv_tile), p = ex2.approx of one FFMA on a
//   log2-unit lse (scale * log2(e) folded in), lse and delta staged by
//   cp.async in the same group as Q and dO, a ring of kStages buffers with
//   one barrier per tile, masking by value only on the causal diagonal tile
//   (block 64 = tile 64, S a multiple of 64: no other edge).  Blocks per SM
//   by __launch_bounds__ (kDkvBlocksPerSm), read back by the occupancy query
//   (dst_sparse_occupancy).
// * Inputs are read by strides ([B, S, H, D] views, e.g. of the model's qkv
//   product), head_dim contiguous; outputs are written contiguous.  Block 64
//   and head_dim 64 only (S a multiple of 64).

#include "attention_tile.cuh"

namespace {

struct Params {
  const void* q; const void* k; const void* v; const void* dout;
  const float* lse_in; const float* delta;
  const int* tasks; const int* entries;   // the forward's or dKV's work list and live blocks
  float* partials; int* counters;     // dKV: [B][n_slots][2][64 * 64] and [B][n_counters]
  void* o; float* lse; void* dq; void* dk; void* dv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh;
  int S, H, nb, causal, B, n_slots, n_counters;
  float scale;
};

template <typename T> __device__ __forceinline__ const T* at(const void* base, long long off) {
  return static_cast<const T*>(base) + off;
}

// -inf where the key is past the query: the warp's 16 rows of the diagonal
// block against its key columns c0 .. c0 + 8 NJ - 1.
template <int NJ>
__device__ __forceinline__ void mask_future_keys(float (&s)[NJ][4], int c0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c0 + jj * 8 + 2 * t + (i & 1) > warp * 16 + g + 8 * (i >> 1)) s[jj][i] = -INFINITY;
}

// --------------------------------------------------------------------------
// forward: one block per (task of the work list, batch), walking the task's
// live key blocks; flash's forward tile body
// --------------------------------------------------------------------------

constexpr int kFwdTaskInts = 5;         // head, query block, first, count, diagonal
constexpr int kFwdStages = 2;           // key / value buffers in the ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Blocks per SM __launch_bounds__ asks for: bf16 3 (up to 168 registers a
// thread, the flash forward's), fp32 2 (its shared memory holds 2).
template <typename T> constexpr int kFwdBlocksPerSm = 3;
template <> constexpr int kFwdBlocksPerSm<float> = 2;

template <typename T>
constexpr size_t fwd_smem_bytes(int nb) {   // Q, kFwdStages K and V buffers, the live list
  return sizeof(T) * (1 + 2 * kFwdStages) * kTileElems<T> + nb * sizeof(int);
}

// grid: tasks x batch, batch fastest; the tasks come longest first
template <typename T>
__global__ void __launch_bounds__(kThreads, kFwdBlocksPerSm<T>) sparse_fwd_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TE = kTileElems<T>, L = Tr<T>::kLd, NS = kFwdStages;
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = sq + TE;                  // NS buffers each
  T* sv = sk + NS * TE;
  int* live = reinterpret_cast<int*>(sv + NS * TE);
  const int* task = p.tasks + (long long)(blockIdx.x / p.B) * kFwdTaskInts;
  const int h = task[0], qb = task[1], first = task[2], n = task[3], diagonal = task[4];
  const int b = blockIdx.x % p.B;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = qb * kTile, wrow0 = row0 + warp * 16;
  const T* k = at<T>(p.k, b * p.k_sb + h * p.k_sh);
  const T* v = at<T>(p.v, b * p.v_sb + h * p.v_sh);
  const float to_log2 = p.scale * kLog2e;
  auto stage = [&](int it, int buf) {
    load_tile(sk + buf * TE, k, p.k_ss, live[it] * kTile, p.S);
    load_tile(sv + buf * TE, v, p.v_ss, live[it] * kTile, p.S);
  };

  for (int i = threadIdx.x; i < n; i += kThreads) live[i] = p.entries[first + i];
  if (n > 0) load_tile(sq, at<T>(p.q, b * p.q_sb + h * p.q_sh), p.q_ss, row0, p.S);
  __syncthreads();
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (st < n) stage(st, st);
    commit_copies();                   // the first group also holds Q
  }
  // m in log2 units from JAX's -1e30 scaled as a score is
  const float m0 = __fmul_rn(kNegInf, kLog2e);
  float m[2] = {m0, m0}, l[2] = {0.f, 0.f};
  float acc[8][4];
  zero(acc);
  RowFragments<T> qf;
  for (int it = 0, buf = 0; it < n; ++it, buf = buf + 1 == NS ? 0 : buf + 1) {
    wait_copies<NS - 2>();             // key block it has landed
    __syncthreads();                   // ... for every thread; every warp is done with it - 1
    if (it + NS - 1 < n) stage(it + NS - 1, buf == 0 ? NS - 1 : buf - 1);
    commit_copies();
    if (it == 0) qf.load(sq + warp * 16 * L);
    float s[8][4];
    qf.product_nt(s, sk + buf * TE);
    // only the causal diagonal block (the walk's last, which the work list
    // marks) is masked by value: keys past the query take no weight
    if (diagonal && it == n - 1) mask_future_keys(s, 0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[jj][i]);
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {      // the running max in log2 units (to_log2 > 0)
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
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[jj][i] *= alpha[i >> 1];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];   // this thread's columns
    pv_tile(acc, s, sv + buf * TE);
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;   // a row with nothing live: o = 0
  }
  T* o = static_cast<T*>(p.o) + (long long)b * p.S * p.H * kD + h * kD;
  store_rows<T>(o, (long long)p.H * kD, acc, wrow0, p.S, inv);
  if (t == 0) {
    float* lse = p.lse + ((long long)b * p.H + h) * p.S;
#pragma unroll
    for (int r = 0; r < 2; ++r) {      // natural-log units, as dQ and dKV read it
      const float row_lse = __fmul_rn(__fadd_rn(m[r], log2f(l[r])), kLn2);
      lse[wrow0 + g + 8 * r] = n > 0 ? row_lse : kNegInf;   // an empty row: JAX's -1e30
    }
  }
}

// --------------------------------------------------------------------------
// dQ: one block per (task of the forward's work list, batch), walking the
// task's live key blocks.  bf16 on warpgroup MMA (sparse_dq_wgmma_kernel),
// fp32 on flash dQ's FMA tile body (sparse_dq_kernel)
// --------------------------------------------------------------------------

constexpr int kStages = 2;              // streamed buffers in dQ's and dKV's rings
constexpr int kDqCols = 32;             // key columns of a dQ score tile (the fp32 body)
// bf16 dQ runs on wgmma (sparse_dq_wgmma_kernel), fp32 on sparse_dq_kernel
template <typename T> constexpr bool kDqWgmma = sizeof(T) == 2;

// Blocks per SM __launch_bounds__ asks for: bf16 3 (up to 168 registers a
// thread), fp32 2 (its shared memory holds 2).
template <typename T> constexpr int kDqBlocksPerSm = 3;
template <> constexpr int kDqBlocksPerSm<float> = 2;

template <typename T>
constexpr size_t dq_smem_bytes(int nb) {   // Q and dO, kStages K and V buffers, the live list
  return sizeof(T) * (2 + 2 * kStages) * kTileElems<T> + nb * sizeof(int);
}

// The warp's two rows' lse, in log2 units, and delta.
__device__ __forceinline__ void dq_row_stats(const Params& p, int b, int h, int row,
                                             float (&lse2)[2], float (&delta)[2]) {
  const long long stat = ((long long)b * p.H + h) * p.S + row;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = __fmul_rn(p.lse_in[stat + 8 * r], kLog2e);
    delta[r] = p.delta[stat + 8 * r];
  }
}

// s <- ds = p (dp - delta) * scale, p = 2^(s * scale * log2(e) - lse2).
template <int NJ>
__device__ __forceinline__ void ds_tile(float (&s)[NJ][4], const float (&dp)[NJ][4],
                                        float to_log2, const float (&lse2)[2],
                                        const float (&delta)[2], float scale) {
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float pr = exp2_approx(fmaf(s[jj][i], to_log2, -lse2[i >> 1]));
      s[jj][i] = pr * (dp[jj][i] - delta[i >> 1]) * scale;
    }
}

// grid: tasks x batch, batch fastest; the tasks come longest first
template <typename T>
__global__ void __launch_bounds__(kThreads, kDqBlocksPerSm<T>) sparse_dq_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TE = kTileElems<T>, L = Tr<T>::kLd, NS = kStages, NJ = kDqCols / 8;
  T* sq = reinterpret_cast<T*>(smem);
  T* sdo = sq + TE;
  T* sk = sdo + TE;                 // NS buffers each
  T* sv = sk + NS * TE;
  int* live = reinterpret_cast<int*>(sv + NS * TE);
  const int* task = p.tasks + (long long)(blockIdx.x / p.B) * kFwdTaskInts;
  const int h = task[0], qb = task[1], first = task[2], n = task[3], diagonal = task[4];
  const int b = blockIdx.x % p.B;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int row0 = qb * kTile, wrow0 = row0 + warp * 16;
  const T* k = at<T>(p.k, b * p.k_sb + h * p.k_sh);
  const T* v = at<T>(p.v, b * p.v_sb + h * p.v_sh);
  const float to_log2 = p.scale * kLog2e;
  auto stage = [&](int it, int buf) {
    load_tile(sk + buf * TE, k, p.k_ss, live[it] * kTile, p.S);
    load_tile(sv + buf * TE, v, p.v_ss, live[it] * kTile, p.S);
  };

  for (int i = threadIdx.x; i < n; i += kThreads) live[i] = p.entries[first + i];
  if (n > 0) {
    load_tile(sq, at<T>(p.q, b * p.q_sb + h * p.q_sh), p.q_ss, row0, p.S);
    load_tile(sdo, at<T>(p.dout, b * p.do_sb + h * p.do_sh), p.do_ss, row0, p.S);
  }
  __syncthreads();
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (st < n) stage(st, st);
    commit_copies();                   // the first group also holds Q and dO
  }
  float lse2[2], delta[2];
  dq_row_stats(p, b, h, wrow0 + g, lse2, delta);
  float dq[8][4];
  zero(dq);
  RowFragments<T> qf, dof;
  for (int it = 0, buf = 0; it < n; ++it, buf = buf + 1 == NS ? 0 : buf + 1) {
    wait_copies<NS - 2>();             // key block it has landed
    __syncthreads();                   // ... for every thread; every warp is done with it - 1
    if (it + NS - 1 < n) stage(it + NS - 1, buf == 0 ? NS - 1 : buf - 1);
    commit_copies();
    if (it == 0) {
      qf.load(sq + warp * 16 * L);
      dof.load(sdo + warp * 16 * L);
    }
    // only the causal diagonal block (the walk's last, which the work list
    // marks) is masked by value
    const bool diag = diagonal && it == n - 1;
#pragma unroll 1
    for (int c = 0; c < kTile; c += kDqCols) {
      // on the diagonal, key columns wholly past the warp's last row add nothing
      if (diag && c > warp * 16 + 15) break;
      const T* k_cols = sk + buf * TE + c * L;
      float s[NJ][4], dp[NJ][4];
      qf.product_nt(s, k_cols);
      dof.product_nt(dp, sv + buf * TE + c * L);
      if (diag && c + kDqCols - 1 > warp * 16) mask_future_keys(s, c);
      ds_tile(s, dp, to_log2, lse2, delta, p.scale);
      pv_tile(dq, s, k_cols);
    }
  }
  const float one[2] = {1.f, 1.f};
  T* out = static_cast<T*>(p.dq) + (long long)b * p.S * p.H * kD + h * kD;
  store_rows<T>(out, (long long)p.H * kD, dq, wrow0, p.S, one);
}

// ---- bf16 on warpgroup MMA: the block's 4 warps are one warpgroup, its 64
// query rows the m64 of wgmma ----

constexpr int kSwTileElems = kTile * kD;    // a swizzled [64][64] bf16 tile: 8 KB, no padding

constexpr size_t dq_wgmma_smem_bytes(int nb) {   // alignment slack, K, V ring, Q, dO, live list
  return 1024 + sizeof(bf16) * (2 * kStages * kSwTileElems + 2 * kTileElems<bf16>) +
         nb * sizeof(int);
}

// dst = rows row0 .. row0 + 63 of src ([row][kD] bf16 by stride ss) with the
// 128-byte swizzle: 16-byte chunk c of row r at chunk c ^ (r % 8).  dst is
// 1024-byte aligned.  Asynchronous, as load_tile.
__device__ __forceinline__ void load_tile_sw128(bf16* dst, const bf16* src, long long ss,
                                                int row0) {
#pragma unroll
  for (int i = 0; i < kTile * 8 / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads, r = c >> 3, ch = c & 7;
    copy16_async(dst + r * kD + ((ch ^ (r & 7)) << 3), src + (row0 + r) * ss + (ch << 3), true);
  }
}

// Pins registers in program order around the asynchronous products (the
// compiler does not see wgmma read or write them late).
__device__ __forceinline__ void fence_acc(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}
__device__ __forceinline__ void fence_frag(uint32_t (&a)[kD / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i])::"memory");
}

#define DQ_ACC4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
// d (+)= A . B over 16 of k: A the warpgroup's 64 rows from registers (a0 ..
// a3: the mma.sync A fragment of the warp's 16 rows), B 64 columns from
// shared memory (kTransB 0: K-major, 1: MN-major); `accumulate` 0
// overwrites d, which keeps the mma.sync accumulator layout per warp.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : DQ_ACC4(0), DQ_ACC4(1), DQ_ACC4(2), DQ_ACC4(3), DQ_ACC4(4), DQ_ACC4(5), DQ_ACC4(6),
        DQ_ACC4(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(kTransB));
}
#undef DQ_ACC4

// grid: tasks x batch, batch fastest; the tasks come longest first
__global__ void __launch_bounds__(kThreads, kDqBlocksPerSm<bf16>)
    sparse_dq_wgmma_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TE = kTileElems<bf16>, L = Tr<bf16>::kLd, NS = kStages, SW = kSwTileElems;
  bf16* sk = reinterpret_cast<bf16*>(smem + ((1024 - (smem_u32(smem) & 1023)) & 1023));
  bf16* sv = sk + NS * SW;          // NS buffers each, 1024-byte aligned
  bf16* sq = sv + NS * SW;
  bf16* sdo = sq + TE;
  int* live = reinterpret_cast<int*>(sdo + TE);
  const int* task = p.tasks + (long long)(blockIdx.x / p.B) * kFwdTaskInts;
  const int h = task[0], qb = task[1], first = task[2], n = task[3], diagonal = task[4];
  const int b = blockIdx.x % p.B;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int row0 = qb * kTile, wrow0 = row0 + warp * 16;
  const bf16* k = at<bf16>(p.k, b * p.k_sb + h * p.k_sh);
  const bf16* v = at<bf16>(p.v, b * p.v_sb + h * p.v_sh);
  const float to_log2 = p.scale * kLog2e;
  auto stage = [&](int it, int buf) {
    load_tile_sw128(sk + buf * SW, k, p.k_ss, live[it] * kTile);
    load_tile_sw128(sv + buf * SW, v, p.v_ss, live[it] * kTile);
  };

  for (int i = threadIdx.x; i < n; i += kThreads) live[i] = p.entries[first + i];
  if (n > 0) {
    load_tile(sq, at<bf16>(p.q, b * p.q_sb + h * p.q_sh), p.q_ss, row0, p.S);
    load_tile(sdo, at<bf16>(p.dout, b * p.do_sb + h * p.do_sh), p.do_ss, row0, p.S);
  }
  __syncthreads();
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (st < n) stage(st, st);
    commit_copies();                   // the first group also holds Q and dO
  }
  float lse2[2], delta[2];
  dq_row_stats(p, b, h, wrow0 + g, lse2, delta);
  float dq[8][4];
  zero(dq);
  for (int it = 0, buf = 0; it < n; ++it, buf = buf + 1 == NS ? 0 : buf + 1) {
    wait_copies<NS - 2>();             // key block it has landed
    proxy_fence();                     // ... visible to wgmma's (async proxy) reads
    __syncthreads();                   // ... for every thread; every product of it - 1 is done
    if (it + NS - 1 < n) stage(it + NS - 1, buf == 0 ? NS - 1 : buf - 1);
    commit_copies();
    // Q's and dO's fragments are loaded anew for each tile: held in
    // registers from one tile to the next, they reached the products wrong
    // from the second tile on (measured), as the compiler does not see
    // wgmma read them late
    RowFragments<bf16> qf, dof;
    qf.load(sq + warp * 16 * L);
    dof.load(sdo + warp * 16 * L);
    const uint64_t desc_k = sw128_desc(smem_u32(sk + buf * SW));
    const uint64_t desc_v = sw128_desc(smem_u32(sv + buf * SW));
    float s[8][4], dp[8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)   // s = Q . K^T, K K-major
      wgmma_m64n64k16_rs<0>(s, qf.f[kk], desc_k + 2 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)   // dp = dO . V^T
      wgmma_m64n64k16_rs<0>(dp, dof.f[kk], desc_v + 2 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    fence_frag(qf.f);
    fence_frag(dof.f);
    // only the causal diagonal block (the walk's last, which the work list
    // marks) is masked by value
    if (it == n - 1 && diagonal) mask_future_keys(s, 0);
    ds_tile(s, dp, to_log2, lse2, delta, p.scale);
    uint32_t a[kTile / 16][4];         // ds in bf16, the A operand of dq += ds . K
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      a[kk][0] = pack_rn(s[2 * kk][0], s[2 * kk][1]);
      a[kk][1] = pack_rn(s[2 * kk][2], s[2 * kk][3]);
      a[kk][2] = pack_rn(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[kk][3] = pack_rn(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)   // dq += ds . K, K MN-major
      wgmma_m64n64k16_rs<1>(dq, a[kk], desc_k + 128 * kk, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dq);
    fence_frag(a);
  }
  const float one[2] = {1.f, 1.f};
  bf16* out = static_cast<bf16*>(p.dq) + (long long)b * p.S * p.H * kD + h * kD;
  store_rows<bf16>(out, (long long)p.H * kD, dq, wrow0, p.S, one);
}

// --------------------------------------------------------------------------
// dKV: one block per (task of the work list, batch), walking the task's live
// query blocks; a split column's last block to arrive sums its partials
// --------------------------------------------------------------------------

constexpr int kDkvBlocksPerSm = 2;      // K, V, dK and dV fragments take 96 registers a thread
constexpr int kTaskInts = 8;            // h, key block, first, count, split, splits, slot, counter
constexpr int kPartFloats = kTile * kD;     // one fp32 [64][64] partial

template <typename T>
constexpr size_t dkv_smem_bytes(int nb) {   // K and V, kStages Q, dO, lse and delta, live list
  return sizeof(T) * (2 + 2 * kStages) * kTileElems<T> + 2 * kStages * kTile * sizeof(float) +
         nb * sizeof(int);
}

// Stage query block `qb` of head h: Q and dO, lse and delta, all by
// cp.async (one commit group).
template <typename T>
__device__ __forceinline__ void load_query_block(const Params& p, T* sq, T* sdo, float* slse,
                                                 float* sdelta, int b, int h, int qb) {
  static_assert(kThreads == 2 * kTile, "lse and delta take one thread per row each");
  const int row0 = qb * kTile;
  load_tile(sq, at<T>(p.q, b * p.q_sb + h * p.q_sh), p.q_ss, row0, p.S);
  load_tile(sdo, at<T>(p.dout, b * p.do_sb + h * p.do_sh), p.do_ss, row0, p.S);
  const bool is_lse = threadIdx.x < kTile;
  const int i = threadIdx.x & (kTile - 1);
  const float* src = (is_lse ? p.lse_in : p.delta) + ((long long)b * p.H + h) * p.S + row0 + i;
  copy4_async((is_lse ? slse : sdelta) + i, src, true);
}

// -inf where the key is past the query, on the diagonal tile under
// `causal`.  Rows: the warp's 16 keys; columns: the tile's 64 queries.
__device__ __forceinline__ void mask_future_queries(float (&s)[8][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (warp * 16 + g + 8 * (i >> 1) > j * 8 + 2 * t + (i & 1)) s[j][i] = -INFINITY;
}

// A warp's [16][64] fp32 tile, in its register layout, at the warp's place
// in a [64][64] partial: lane-consecutive float4s, past L1 (other SMs read
// them).
__device__ __forceinline__ void store_partial(float* part, const float (&c)[8][4]) {
  float4* dst = reinterpret_cast<float4*>(part) + (threadIdx.x >> 5) * 8 * 32 + (threadIdx.x & 31);
#pragma unroll
  for (int j = 0; j < 8; ++j) __stcg(dst + j * 32, make_float4(c[j][0], c[j][1], c[j][2], c[j][3]));
}

__device__ __forceinline__ void add_partial(float (&acc)[8][4], const float* part) {
  const float4* src =
      reinterpret_cast<const float4*>(part) + (threadIdx.x >> 5) * 8 * 32 + (threadIdx.x & 31);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 x = __ldcg(src + j * 32);
    acc[j][0] += x.x;
    acc[j][1] += x.y;
    acc[j][2] += x.z;
    acc[j][3] += x.w;
  }
}

__device__ __forceinline__ void add_tile(float (&acc)[8][4], const float (&c)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] += c[j][i];
}

// grid: tasks x batch, batch fastest; the tasks come longest first
template <typename T>
__global__ void __launch_bounds__(kThreads, kDkvBlocksPerSm) sparse_dkv_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;
  constexpr int TE = kTileElems<T>, L = Tr<T>::kLd, NS = kStages;
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = sk + TE;
  T* sq = sv + TE;                  // NS buffers each
  T* sdo = sq + NS * TE;
  float* slse = reinterpret_cast<float*>(sdo + NS * TE);     // [NS][kTile]
  float* sdelta = slse + NS * kTile;
  int* live = reinterpret_cast<int*>(sdelta + NS * kTile);   // the task's query blocks
  const int4* task = reinterpret_cast<const int4*>(p.tasks + (blockIdx.x / p.B) * kTaskInts);
  const int4 t0 = task[0], t1 = task[1];
  const int h = t0.x, kb = t0.y, first = t0.z, n = t0.w;
  const int split = t1.x, n_split = t1.y, slot = t1.z, counter = t1.w;
  const int b = blockIdx.x % p.B;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int key0 = kb * kTile, wkey0 = key0 + warp * 16;
  const float to_log2 = p.scale * kLog2e;
  auto stage = [&](int it, int buf) {
    load_query_block<T>(p, sq + buf * TE, sdo + buf * TE, slse + buf * kTile,
                        sdelta + buf * kTile, b, h, live[it]);
  };

  load_tile(sk, at<T>(p.k, b * p.k_sb + h * p.k_sh), p.k_ss, key0, p.S);
  load_tile(sv, at<T>(p.v, b * p.v_sb + h * p.v_sh), p.v_ss, key0, p.S);
  for (int i = threadIdx.x; i < n; i += kThreads) live[i] = p.entries[first + i];
  __syncthreads();
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (st < n) stage(st, st);
    commit_copies();
  }
  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);
  RowFragments<T> kf, vf;
  for (int it = 0, buf = 0; it < n; ++it, buf = buf + 1 == NS ? 0 : buf + 1) {
    wait_copies<NS - 2>();             // query block it has landed
    __syncthreads();                   // ... for every thread; every warp is done with it - 1
    if (it + NS - 1 < n) stage(it + NS - 1, buf == 0 ? NS - 1 : buf - 1);
    commit_copies();
    if (it == 0) {
      kf.load(sk + warp * 16 * L);
      vf.load(sv + warp * 16 * L);
    }
    const float* lse = slse + buf * kTile;
    const float* delta = sdelta + buf * kTile;
    const T* q_tile = sq + buf * TE;
    const T* do_tile = sdo + buf * TE;
    float s[8][4], dp[8][4];
    kf.product_nt(s, q_tile);                           // s^T: keys x queries
    vf.product_nt(dp, do_tile);                         // dp^T = v . do^T
    if (p.causal && live[it] == kb) mask_future_queries(s);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {   // p^T; lse read and put in log2 units per column pair
      const float2 l = *reinterpret_cast<const float2*>(lse + jj * 8 + 2 * t);
      const float l0 = __fmul_rn(l.x, kLog2e), l1 = __fmul_rn(l.y, kLog2e);
      s[jj][0] = exp2_approx(fmaf(s[jj][0], to_log2, -l0));
      s[jj][1] = exp2_approx(fmaf(s[jj][1], to_log2, -l1));
      s[jj][2] = exp2_approx(fmaf(s[jj][2], to_log2, -l0));
      s[jj][3] = exp2_approx(fmaf(s[jj][3], to_log2, -l1));
    }
    pv_tile(dv, s, do_tile);                            // dv += p^T . do
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {   // ds^T, delta read once per column pair
      const float2 d = *reinterpret_cast<const float2*>(delta + jj * 8 + 2 * t);
      s[jj][0] = s[jj][0] * (dp[jj][0] - d.x) * p.scale;
      s[jj][1] = s[jj][1] * (dp[jj][1] - d.y) * p.scale;
      s[jj][2] = s[jj][2] * (dp[jj][2] - d.x) * p.scale;
      s[jj][3] = s[jj][3] * (dp[jj][3] - d.y) * p.scale;
    }
    pv_tile(dk, s, q_tile);                             // dk += ds^T . q
  }
  wait_copies<0>();                    // the K and V copies of a column with nothing live
  const float one[2] = {1.f, 1.f};
  const long long off = (long long)b * p.S * p.H * kD + h * kD;
  T* dk_out = static_cast<T*>(p.dk) + off;
  T* dv_out = static_cast<T*>(p.dv) + off;
  if (n_split == 1) {
    store_rows<T>(dk_out, (long long)p.H * kD, dk, wkey0, p.S, one);
    store_rows<T>(dv_out, (long long)p.H * kD, dv, wkey0, p.S, one);
    return;
  }
  // a split: publish the partial, count the arrival; the last to arrive sums
  float* parts = p.partials + ((long long)b * p.n_slots + slot - split) * 2 * kPartFloats;
  store_partial(parts + 2 * split * kPartFloats, dk);
  store_partial(parts + (2 * split + 1) * kPartFloats, dv);
  __threadfence();                     // this thread's partial is visible before the count
  __syncthreads();
  int* arrivals = p.counters + (long long)b * p.n_counters + counter;
  if (threadIdx.x == 0) {
    last = atomicAdd(arrivals, 1) == n_split - 1;
    if (last) *arrivals = 0;           // every split has arrived: ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();                     // the other splits' partials, as counted
  float sum_k[8][4], sum_v[8][4];
  zero(sum_k);
  zero(sum_v);
  for (int sp = 0; sp < n_split; ++sp) {   // in split order, whatever the order of arrival
    if (sp == split) {
      add_tile(sum_k, dk);
      add_tile(sum_v, dv);
    } else {
      add_partial(sum_k, parts + 2 * sp * kPartFloats);
      add_partial(sum_v, parts + (2 * sp + 1) * kPartFloats);
    }
  }
  store_rows<T>(dk_out, (long long)p.H * kD, sum_k, wkey0, p.S, one);
  store_rows<T>(dv_out, (long long)p.H * kD, sum_v, wkey0, p.S, one);
}

// --------------------------------------------------------------------------
// launches
// --------------------------------------------------------------------------

enum Which { kForward, kDq, kDkv };

template <typename T>
size_t smem_bytes(Which which, int nb) {
  switch (which) {
    case kForward: return fwd_smem_bytes<T>(nb);
    case kDq: return kDqWgmma<T> ? dq_wgmma_smem_bytes(nb) : dq_smem_bytes<T>(nb);
    default: return dkv_smem_bytes<T>(nb);
  }
}

template <typename T>
cudaError_t run(Which which, const Params& p, int n_tasks, cudaStream_t st) {
  const size_t smem = smem_bytes<T>(which, p.nb);
  switch (which) {
    case kForward: return launch(sparse_fwd_kernel<T>, dim3(n_tasks * p.B), smem, p, st);
    case kDq:
      if constexpr (kDqWgmma<T>)
        return launch(sparse_dq_wgmma_kernel, dim3(n_tasks * p.B), smem, p, st);
      else
        return launch(sparse_dq_kernel<T>, dim3(n_tasks * p.B), smem, p, st);
    default: return launch(sparse_dkv_kernel<T>, dim3(n_tasks * p.B), smem, p, st);
  }
}

// Blocks of one kernel that one SM holds at once, registers and shared
// memory (at nb layout blocks) both counted; 0 on an error.
template <typename T>
int occupancy(Which which, int nb, int* smem) {
  *smem = (int)smem_bytes<T>(which, nb);
  auto query = [&](auto kernel) {
    int n = 0;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, *smem) != cudaSuccess)
      return 0;
    return n;
  };
  switch (which) {
    case kForward: return query(sparse_fwd_kernel<T>);
    case kDq:
      if constexpr (kDqWgmma<T>)
        return query(sparse_dq_wgmma_kernel);
      else
        return query(sparse_dq_kernel<T>);
    default: return query(sparse_dkv_kernel<T>);
  }
}

// strides: [q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, do_b, do_s, do_h], in
// elements.
int dispatch(Which which, Params p, const long long* strides, int n_tasks, int dtype,
             void* stream) {
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.do_sb = strides[9]; p.do_ss = strides[10]; p.do_sh = strides[11];
  const int vec = dtype == 0 ? 4 : 8;             // elements per 16 bytes
  bool ok = p.B > 0 && p.B <= 65535 && p.H > 0 && p.H <= 65535 && p.S > 0 &&
            p.S % kTile == 0 && (dtype == 0 || dtype == 1) && aligned16(p.q) &&
            aligned16(p.k) && aligned16(p.v) && (p.dout == nullptr || aligned16(p.dout));
  if (which == kDkv)
    ok = ok && n_tasks > 0 && (long long)n_tasks * p.B <= 0x7fffffffLL && p.n_slots >= 0 &&
         p.n_counters >= 0 && aligned16(p.tasks);
  else                                   // the forward's list: one task per (head, query block)
    ok = ok && (long long)n_tasks == (long long)p.H * (p.S / kTile) &&
         (long long)n_tasks * p.B <= 0x7fffffffLL && p.tasks != nullptr;
  for (int i = 0; i < 12; ++i) ok = ok && strides[i] % vec == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  p.nb = p.S / kTile;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0 ? run<float>(which, p, n_tasks, st) : run<bf16>(which, p, n_tasks, st));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Each returns a cudaError_t (0 = launched).
// q, k, v [B, S, H, 64] by strides, S a multiple of 64; the work list of
// build_fwd_tasks: tasks int32 [H * S / 64][5] (head, query block, first
// entry, count, diagonal), longest first, and entries int32 (the tasks' live
// key blocks); o contiguous [B, S, H, 64]; lse fp32 contiguous [B, H, S].
int dst_sparse_forward(const void* q, const void* k, const void* v, const int* tasks,
                       const int* entries, int n_tasks, void* o, float* lse,
                       const long long* strides, int B, int S, int H, float scale, int causal,
                       int dtype, void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.tasks = tasks; p.entries = entries; p.o = o; p.lse = lse;
  p.B = B; p.S = S; p.H = H; p.scale = scale; p.causal = causal;
  return dispatch(kForward, p, strides, n_tasks, dtype, stream);
}

// dout by strides like q; lse and delta fp32 contiguous [B, H, S]; the
// forward's work list (tasks, entries, n_tasks) as dst_sparse_forward takes
// it; dq contiguous [B, S, H, 64].
int dst_sparse_backward_dq(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, const int* tasks,
                           const int* entries, int n_tasks, void* dq, const long long* strides,
                           int B, int S, int H, float scale, int causal, int dtype,
                           void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse_in = lse; p.delta = delta;
  p.tasks = tasks; p.entries = entries; p.dq = dq;
  p.B = B; p.S = S; p.H = H; p.scale = scale; p.causal = causal;
  return dispatch(kDq, p, strides, n_tasks, dtype, stream);
}

// The work list of build_dkv_tasks: tasks int32 [n_tasks][8] (head, key
// block, first entry, count, split, splits, slot, counter), entries int32
// (the tasks' live query blocks); partials fp32 [B][n_slots][2][64 * 64]
// and counters int32 [B][n_counters], all 0 before the first launch (each
// launch leaves them so).  dk, dv contiguous [B, S, H, 64].
int dst_sparse_backward_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, const int* tasks,
                            const int* entries, int n_tasks, float* partials, int n_slots,
                            int* counters, int n_counters, void* dk, void* dv,
                            const long long* strides, int B, int S, int H, float scale,
                            int causal, int dtype, void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse_in = lse; p.delta = delta;
  p.tasks = tasks; p.entries = entries; p.partials = partials; p.counters = counters;
  p.n_slots = n_slots; p.n_counters = n_counters; p.dk = dk; p.dv = dv;
  p.B = B; p.S = S; p.H = H; p.scale = scale; p.causal = causal;
  return dispatch(kDkv, p, strides, n_tasks, dtype, stream);
}

// Blocks of one kernel (which: 0 forward, 1 dQ, 2 dKV) that one SM holds
// at once at S / 64 = nb layout blocks; its dynamic shared memory per block
// in *smem_bytes.  0 on an error.
int dst_sparse_occupancy(int which, int dtype, int nb, int* smem_bytes) {
  if (which < 0 || which > 2 || (dtype != 0 && dtype != 1) || nb <= 0 || smem_bytes == nullptr)
    return 0;
  const Which w = (Which)which;
  return dtype == 0 ? occupancy<float>(w, nb, smem_bytes) : occupancy<bf16>(w, nb, smem_bytes);
}

}  // extern "C"
