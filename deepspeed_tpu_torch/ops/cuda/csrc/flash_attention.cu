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
// line.  What a simple kernel does about it: each input tile is read from
// device memory once per block that needs it, scores and probabilities never
// leave registers, and fully masked key tiles are skipped.
//
// Design (wgmma, TMA and warp specialisation are later work):
// * The forward (redesigned for Hopper): one block of 4 warps per 64-query
//   tile (grid: query tiles x heads x batch, the longest causal rows
//   first), each warp 16 rows, at up to 168 registers a thread so that
//   three blocks share an SM and one block's loads and softmax overlap
//   another's products.  (8 warps per 128-query tile at one block per SM,
//   and four blocks per SM at 128 registers with spills, both ran slower.)
//   - bf16: the warp's Q fragments are loaded once by ldmatrix and held in
//     registers; K fragments come by ldmatrix, V by ldmatrix.trans (one
//     instruction per four 8x8 matrices, not 16-bit or 32-bit loads).
//   - Scores are kept in log2 units (q . k * scale * log2(e)), so each
//     exponential (p and the rescale alpha) is one ex2.approx; lse is
//     converted back at the end, lse = (m2 + log2 l) * ln 2, the natural-log
//     value dQ, dKV and remat read.  The running max starts at -1e30 *
//     log2(e), so a row a bias masks wholly still averages uniformly.
//   - Masking by value only on a warp's diagonal key tile and a ragged last
//     tile; a key tile wholly past a warp's rows is skipped by that warp.
//     The no-bias, no-ALiBi path (GPT-2's) is its own instantiation, with
//     one multiply per score.
//   - fp32 keeps FMA products (product_nt / product_pv) in the same layout.
// * dQ and dKV: one block of 4 warps per 64-row tile: query rows for dQ
//   (grid: query tiles x heads x batch), key rows for dKV (grid: key tiles
//   x kv heads x batch).  Each warp owns 16 of the rows.  bf16 products use
//   mma.sync m16n8k16 (fp32 accumulate) with fragments read straight from
//   shared memory; fp32 uses fp32 FMA in the same register layout (no
//   TF32), p and ds passed between the four threads of a row group by
//   shuffles.
// * The score tile stays in the mma accumulator layout (thread: rows g and
//   g + 8, columns 2t and 2t + 1 of each 8-column slice), which is also the
//   A-operand layout of the next product, so p and ds go to the tensor cores
//   from registers.
// * The streamed tiles (K and V in the forward and dQ; Q, dO, lse, delta in
//   dKV) are double-buffered in shared memory with cp.async: the next tile
//   is in flight while the current one is used.
// * The online softmax keeps m, l and the accumulator in fp32 registers;
//   out-of-range and causally masked columns are -inf, exactly zero weight,
//   never 0/0 (l = 0 gives o = 0).
// * Causal: the forward and dQ walk key tiles up to the query tile's last
//   row, dKV walks query tiles from the key tile on; only the diagonal tile
//   is masked by value.
// * GQA: the forward and dQ read kv head h / group; dKV loops over the
//   group's query heads inside one block, so grouped K/V are never expanded
//   and dK/dV are summed in a fixed order with no atomics.
// * Inputs are read by strides ([B, S, H, D] views, e.g. of the model's qkv
//   product), head_dim contiguous; outputs are written contiguous.  Rows past
//   S are zero-filled in shared memory and never written.  head_dim 64 only.

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

// s <- s * scale (+ bias) (+ slope * (key - query)), -inf where causally
// masked or out of range.  The tile's rows start at row0 and its columns at
// col0; kKeyRows: rows are keys and columns queries (the dKV kernel).
template <bool kKeyRows>
__device__ __forceinline__ void scores(float (&s)[8][4], const Params& p, const float* bias,
                                       float slope, int row0, int col0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + g + 8 * (i >> 1), c = col0 + j * 8 + 2 * t + (i & 1);
      const int qi = kKeyRows ? c : r, ki = kKeyRows ? r : c;
      float x = -INFINITY;
      if (qi < p.S && ki < p.S && !(p.causal && ki > qi)) {
        x = __fmul_rn(s[j][i], p.scale);
        if (bias != nullptr) x = __fadd_rn(x, bias[qi * p.b_sq + ki * p.b_sk]);
        if (p.slopes != nullptr) x = __fadd_rn(x, __fmul_rn(slope, (float)(ki - qi)));
      }
      s[j][i] = x;
    }
}

// --------------------------------------------------------------------------
// forward: one block of 8 warps per (128-query tile, head, batch)
// --------------------------------------------------------------------------

constexpr int kFwdWarps = 4;
constexpr int kFwdRows = 16 * kFwdWarps;          // query rows of a forward block
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdBlocksPerSm = 3;                // up to 168 registers a thread
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
constexpr size_t fwd_smem_bytes() {               // the query tile, two K and two V buffers
  return sizeof(T) * (kFwdRows + 4 * kTile) * Tr<T>::kLd;
}

// With extras (a bias or ALiBi): s <- s * scale (+ bias) (+ slope * (key -
// query)), times log2(e), as scores<> forms it in natural units.  Without
// (GPT-2's path) s stays as it is: the caller folds scale * log2(e) into
// the exponential's argument.  -inf where causally masked or out of range
// (kMask).
template <bool kExtras, bool kMask>
__device__ __forceinline__ void scores_log2(float (&s)[8][4], const Params& p, const float* bias,
                                            float slope, int row0, int col0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + g + 8 * (i >> 1), c = col0 + j * 8 + 2 * t + (i & 1);
      float x = -INFINITY;
      if (!kMask || (r < p.S && c < p.S && !(p.causal && c > r))) {
        if (kExtras) {
          x = __fmul_rn(s[j][i], p.scale);
          if (bias != nullptr) x = __fadd_rn(x, bias[r * p.b_sq + c * p.b_sk]);
          if (p.slopes != nullptr) x = __fadd_rn(x, __fmul_rn(slope, (float)(c - r)));
          x = __fmul_rn(x, kLog2e);
        } else {
          x = s[j][i];
        }
      }
      s[j][i] = x;
    }
}

template <typename T, bool kExtras>
__global__ void __launch_bounds__(kFwdThreads, kFwdBlocksPerSm) flash_fwd_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TE = kTileElems<T>, L = Tr<T>::kLd;
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = sq + kFwdRows * L;        // two buffers each
  T* sv = sk + 2 * TE;
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

  load_rows<T, kFwdRows, kFwdThreads>(sq, q, p.q_ss, row0, p.S);
  load_rows<T, kTile, kFwdThreads>(sk, k, p.k_ss, 0, p.S);
  load_rows<T, kTile, kFwdThreads>(sv, v, p.v_ss, 0, p.S);
  commit_copies();
  // m in log2 units; its start is JAX's -1e30 scaled as a score is, so a
  // row whose every column a bias sets to -1e30 still averages uniformly
  const float m0 = __fmul_rn(kNegInf, kLog2e);
  float m[2] = {m0, m0}, l[2] = {0.f, 0.f};
  float acc[8][4];
  zero(acc);
  QFragments<T> qf;
  for (int j = 0; j < n_kv; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_kv) {
      load_rows<T, kTile, kFwdThreads>(sk + (buf ^ 1) * TE, k, p.k_ss, (j + 1) * kTile, p.S);
      load_rows<T, kTile, kFwdThreads>(sv + (buf ^ 1) * TE, v, p.v_ss, (j + 1) * kTile, p.S);
      commit_copies();
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    __syncthreads();
    if (j == 0) qf.load(sq + warp * 16 * L);
    const int col0 = j * kTile;
    // a key tile wholly past the warp's last row leaves its state as it is
    if (!p.causal || col0 <= wrow0 + 15) {
      float s[8][4];
      qf.scores(s, sk + buf * TE);
      // only the diagonal tile and a ragged last tile are masked by value
      const bool edge = (p.causal && col0 + kTile - 1 > wrow0) || col0 + kTile > p.S;
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
        for (int jj = 0; jj < 8; ++jj)
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
  T* o = static_cast<T*>(p.o) + (long long)b * p.S * p.H * kD + h * kD;
  store_rows<T>(o, (long long)p.H * kD, acc, wrow0, p.S, inv);
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
// dQ: one block per (query tile, head, batch), walking the key tiles
// --------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TE = kTileElems<T>, L = Tr<T>::kLd;
  T* sq = reinterpret_cast<T*>(smem);
  T* sdo = sq + TE;
  T* sk = sdo + TE;                 // two buffers each
  T* sv = sk + 2 * TE;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int row0 = qt * kTile, wrow0 = row0 + warp * 16;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const float* bias = p.bias != nullptr ? p.bias + b * p.b_sb + h * p.b_sh : nullptr;
  const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
  const int n_kv = p.causal ? qt + 1 : cdiv(p.S, kTile);
  const long long stat0 = ((long long)b * p.H + h) * p.S;
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow0 + g + 8 * r;
    lse[r] = row < p.S ? p.lse_in[stat0 + row] : 0.f;
    delta[r] = row < p.S ? p.delta[stat0 + row] : 0.f;
  }

  load_tile(sq, q, p.q_ss, row0, p.S);
  load_tile(sdo, dout, p.do_ss, row0, p.S);
  load_tile(sk, k, p.k_ss, 0, p.S);
  load_tile(sv, v, p.v_ss, 0, p.S);
  commit_copies();
  float dq[8][4];
  zero(dq);
  for (int j = 0; j < n_kv; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_kv) {
      load_tile(sk + (buf ^ 1) * TE, k, p.k_ss, (j + 1) * kTile, p.S);
      load_tile(sv + (buf ^ 1) * TE, v, p.v_ss, (j + 1) * kTile, p.S);
      commit_copies();
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    __syncthreads();
    float s[8][4], dp[8][4];
    product_nt(s, sq + warp * 16 * L, sk + buf * TE);
    scores<false>(s, p, bias, slope, wrow0, j * kTile);
    product_nt(dp, sdo + warp * 16 * L, sv + buf * TE);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pr = expf(s[jj][i] - lse[i >> 1]);
        s[jj][i] = pr * (dp[jj][i] - delta[i >> 1]) * p.scale;    // ds
      }
    product_pv(dq, s, sk + buf * TE);
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  T* out = static_cast<T*>(p.dq) + (long long)b * p.S * p.H * kD + h * kD;
  store_rows<T>(out, (long long)p.H * kD, dq, wrow0, p.S, one);
}

// --------------------------------------------------------------------------
// dKV: one block per (key tile, kv head, batch), walking the group's query
// heads and, for each, the query tiles from the diagonal on
// --------------------------------------------------------------------------

// Stage query tile `qt` of head h into buffer `buf`: Q and dO by cp.async,
// lse and delta (zeros past S) by plain loads.
template <typename T>
__device__ __forceinline__ void load_query_tile(const Params& p, T* sq, T* sdo, float* slse,
                                                float* sdelta, int b, int h, int qt) {
  const int row0 = qt * kTile;
  load_tile(sq, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss, row0, p.S);
  load_tile(sdo, static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh, p.do_ss, row0,
            p.S);
  const int i = threadIdx.x & (kTile - 1), row = row0 + i;
  const float* src = threadIdx.x < kTile ? p.lse_in : p.delta;
  const float val = row < p.S ? src[((long long)b * p.H + h) * p.S + row] : 0.f;
  (threadIdx.x < kTile ? slse : sdelta)[i] = val;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TE = kTileElems<T>, L = Tr<T>::kLd;
  static_assert(kThreads == 2 * kTile, "lse and delta take one thread per row each");
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = sk + TE;
  T* sq = sv + TE;                  // two buffers each
  T* sdo = sq + 2 * TE;
  float* slse = reinterpret_cast<float*>(sdo + 2 * TE);     // [2][kTile]
  float* sdelta = slse + 2 * kTile;
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key0 = kt * kTile, wkey0 = key0 + warp * 16;
  const int n_q = cdiv(p.S, kTile), first = p.causal ? kt : 0, per_head = n_q - first;
  const int total = p.group * per_head;

  load_tile(sk, static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh, p.k_ss, key0, p.S);
  load_tile(sv, static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_ss, key0, p.S);
  load_query_tile<T>(p, sq, sdo, slse, sdelta, b, hk * p.group, first);
  commit_copies();
  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);
  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    if (it + 1 < total) {
      const int nb = buf ^ 1, nh = hk * p.group + (it + 1) / per_head;
      load_query_tile<T>(p, sq + nb * TE, sdo + nb * TE, slse + nb * kTile,
                         sdelta + nb * kTile, b, nh, first + (it + 1) % per_head);
      commit_copies();
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    __syncthreads();
    const int h = hk * p.group + it / per_head, q0 = (first + it % per_head) * kTile;
    const float* bias = p.bias != nullptr ? p.bias + b * p.b_sb + h * p.b_sh : nullptr;
    const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
    const float* lse = slse + buf * kTile;
    const float* delta = sdelta + buf * kTile;
    const T* q_tile = sq + buf * TE;
    const T* do_tile = sdo + buf * TE;
    float s[8][4], dp[8][4];
    product_nt(s, sk + warp * 16 * L, q_tile);          // s^T: keys x queries
    scores<true>(s, p, bias, slope, wkey0, q0);
    const int t = lane & 3;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[jj][i] = expf(s[jj][i] - lse[jj * 8 + 2 * t + (i & 1)]);
    product_pv(dv, s, do_tile);                         // p^T . do
    product_nt(dp, sv + warp * 16 * L, do_tile);        // dp^T = v . do^T
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[jj][i] = s[jj][i] * (dp[jj][i] - delta[jj * 8 + 2 * t + (i & 1)]) * p.scale;
    product_pv(dk, s, q_tile);                          // ds^T . q
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  const long long off = (long long)b * p.S * p.Hkv * kD + hk * kD;
  store_rows<T>(static_cast<T*>(p.dk) + off, (long long)p.Hkv * kD, dk, wkey0, p.S, one);
  store_rows<T>(static_cast<T*>(p.dv) + off, (long long)p.Hkv * kD, dv, wkey0, p.S, one);
}

// --------------------------------------------------------------------------
// launches
// --------------------------------------------------------------------------

enum Which { kForward, kDq, kDkv };

template <typename T>
cudaError_t run(Which which, const Params& p, int B, cudaStream_t st) {
  const int tiles = cdiv(p.S, kTile);
  switch (which) {
    case kForward: {
      const dim3 grid(cdiv(p.S, kFwdRows), p.H, B);
      return p.bias != nullptr || p.slopes != nullptr
                 ? launch(flash_fwd_kernel<T, true>, grid, fwd_smem_bytes<T>(), p, st, kFwdThreads)
                 : launch(flash_fwd_kernel<T, false>, grid, fwd_smem_bytes<T>(), p, st,
                          kFwdThreads);
    }
    case kDq:
      return launch(flash_dq_kernel<T>, dim3(tiles, p.H, B), 6 * tile_bytes<T>(), p, st);
    default:
      return launch(flash_dkv_kernel<T>, dim3(tiles, p.Hkv, B),
                    6 * tile_bytes<T>() + 4 * kTile * sizeof(float), p, st);
  }
}

// strides: [q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, do_b, do_s, do_h,
// bias_b, bias_h, bias_q, bias_k], in elements.
int dispatch(Which which, Params p, const long long* strides, int B, int dtype, void* stream) {
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.do_sb = strides[9]; p.do_ss = strides[10]; p.do_sh = strides[11];
  p.b_sb = strides[12]; p.b_sh = strides[13]; p.b_sq = strides[14]; p.b_sk = strides[15];
  const int vec = dtype == 0 ? 4 : 8;             // elements per 16 bytes
  bool ok = B > 0 && p.S > 0 && p.H > 0 && p.Hkv > 0 && p.H % p.Hkv == 0 && B <= 65535 &&
            p.H <= 65535 && (dtype == 0 || dtype == 1) && aligned16(p.q) && aligned16(p.k) &&
            aligned16(p.v) && (p.dout == nullptr || aligned16(p.dout));
  for (int i = 0; i < 12; ++i) ok = ok && strides[i] % vec == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  p.group = p.H / p.Hkv;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0 ? run<float>(which, p, B, st) : run<bf16>(which, p, B, st));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Each returns a cudaError_t (0 = launched).
// q [B, S, H, 64], k and v [B, S, Hkv, 64] by strides; bias fp32 by strides
// or null; slopes fp32 [H] or null; o contiguous [B, S, H, 64]; lse fp32
// contiguous [B, H, S].
int dst_flash_forward(const void* q, const void* k, const void* v, const float* bias,
                      const float* slopes, void* o, float* lse, const long long* strides, int B,
                      int S, int H, int Hkv, float scale, int causal, int dtype, void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.bias = bias; p.slopes = slopes; p.o = o; p.lse = lse;
  p.S = S; p.H = H; p.Hkv = Hkv; p.scale = scale; p.causal = causal;
  return dispatch(kForward, p, strides, B, dtype, stream);
}

// dout by strides like q; lse and delta fp32 contiguous [B, H, S]; dq
// contiguous [B, S, H, 64].
int dst_flash_backward_dq(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, const float* bias,
                          const float* slopes, void* dq, const long long* strides, int B, int S,
                          int H, int Hkv, float scale, int causal, int dtype, void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse_in = lse; p.delta = delta; p.bias = bias;
  p.slopes = slopes; p.dq = dq;
  p.S = S; p.H = H; p.Hkv = Hkv; p.scale = scale; p.causal = causal;
  return dispatch(kDq, p, strides, B, dtype, stream);
}

// dk, dv contiguous [B, S, Hkv, 64].
int dst_flash_backward_dkv(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, const float* bias,
                           const float* slopes, void* dk, void* dv, const long long* strides,
                           int B, int S, int H, int Hkv, float scale, int causal, int dtype,
                           void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse_in = lse; p.delta = delta; p.bias = bias;
  p.slopes = slopes; p.dk = dk; p.dv = dv;
  p.S = S; p.H = H; p.Hkv = Hkv; p.scale = scale; p.causal = causal;
  return dispatch(kDkv, p, strides, B, dtype, stream);
}

}  // extern "C"
