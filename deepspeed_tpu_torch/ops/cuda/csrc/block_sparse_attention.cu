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
// Design (simple and right first; the tile code is flash's,
// attention_tile.cuh):
// * One block of 4 warps per 64-row tile: a query block for the forward and
//   dQ (grid: query blocks x heads x batch, the longest rows of a causal
//   layout first), a key block for dKV (grid: key blocks x heads x batch).
// * Each block reads its own count and LUT row and walks only the listed
//   blocks (not a padded walk of the densest row's length, as the Pallas
//   grid does): thread 0 copies the live entries (under `causal` those not
//   wholly in the future) to shared memory, then the loop runs to that
//   count.  The streamed tiles (K and V in the forward and dQ; Q, dO, lse
//   and delta in dKV) are double-buffered with cp.async, the next listed
//   block in flight while the current one is used.
// * Load imbalance: under the "fixed" layout a global key block is listed by
//   every later query block (61 of 64 at S 4096) while a local one is listed
//   by at most 4, so the dKV grid has a long tail; not addressed here.
// * Inputs are read by strides ([B, S, H, D] views, e.g. of the model's qkv
//   product), head_dim contiguous; outputs are written contiguous.  Block 64
//   and head_dim 64 only (S a multiple of 64).

#include "attention_tile.cuh"

namespace {

struct Params {
  const void* q; const void* k; const void* v; const void* dout;
  const float* lse_in; const float* delta;
  const int* lut; const int* cnt;     // [H * nb, max_n] and [H * nb]
  void* o; float* lse; void* dq; void* dk; void* dv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh;
  int S, H, nb, max_n, causal;
  float scale;
};

// Thread 0 copies the live entries of this block's LUT row to `live`:
// all of them, or under `causal` those on the past side of block `own`
// (at or before it for a query block's keys, at or after it for a key
// block's queries).  Returns their count to every thread.
template <bool kKeyRows>
__device__ __forceinline__ int live_entries(const Params& p, int h, int own, int* live) {
  __shared__ int count;
  if (threadIdx.x == 0) {
    const long long row = (long long)h * p.nb + own;
    const int* lut = p.lut + row * p.max_n;
    const int n = p.cnt[row];
    int m = 0;
    for (int j = 0; j < n; ++j) {
      const int other = lut[j];
      if (!p.causal || (kKeyRows ? other >= own : other <= own)) live[m++] = other;
    }
    count = m;
  }
  __syncthreads();
  return count;
}

// s <- s * scale, -inf where the key is past the query (only in a diagonal
// block under `causal`).  Local indices: the warp's 16 rows, 64 columns;
// kKeyRows: rows are keys and columns queries (the dKV kernel).
template <bool kKeyRows>
__device__ __forceinline__ void scale_mask(float (&s)[8][4], float scale, bool diag) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 16 + g + 8 * (i >> 1), c = j * 8 + 2 * t + (i & 1);
      const int qi = kKeyRows ? c : r, ki = kKeyRows ? r : c;
      s[j][i] = diag && ki > qi ? -INFINITY : __fmul_rn(s[j][i], scale);
    }
}

template <typename T> __device__ __forceinline__ const T* at(const void* base, long long off) {
  return static_cast<const T*>(base) + off;
}

// --------------------------------------------------------------------------
// forward: one block per (query block, head, batch), walking the row LUT
// --------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) sparse_fwd_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TE = kTileElems<T>, L = Tr<T>::kLd;
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = sq + TE;                  // two buffers each
  T* sv = sk + 2 * TE;
  int* live = reinterpret_cast<int*>(sv + 2 * TE);
  const int qb = gridDim.x - 1 - blockIdx.x;      // the longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = qb * kTile, wrow0 = row0 + warp * 16;
  const T* q = at<T>(p.q, b * p.q_sb + h * p.q_sh);
  const T* k = at<T>(p.k, b * p.k_sb + h * p.k_sh);
  const T* v = at<T>(p.v, b * p.v_sb + h * p.v_sh);
  const int n = live_entries<false>(p, h, qb, live);

  load_tile(sq, q, p.q_ss, row0, p.S);
  if (n > 0) {
    load_tile(sk, k, p.k_ss, live[0] * kTile, p.S);
    load_tile(sv, v, p.v_ss, live[0] * kTile, p.S);
  }
  commit_copies();
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[8][4];
  zero(acc);
  for (int j = 0; j < n; ++j) {
    const int buf = j & 1;
    if (j + 1 < n) {
      load_tile(sk + (buf ^ 1) * TE, k, p.k_ss, live[j + 1] * kTile, p.S);
      load_tile(sv + (buf ^ 1) * TE, v, p.v_ss, live[j + 1] * kTile, p.S);
      commit_copies();
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    __syncthreads();
    float s[8][4];
    product_nt(s, sq + warp * 16 * L, sk + buf * TE);
    scale_mask<false>(s, p.scale, p.causal && live[j] == qb);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[jj][i]);
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[jj][i] = expf(s[jj][i] - mx[i >> 1]);
        sum[i >> 1] += s[jj][i];
        acc[jj][i] *= alpha[i >> 1];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];   // this thread's columns
    product_pv(acc, s, sv + buf * TE);
    __syncthreads();                   // every warp is done with buf before it is refilled
  }
  wait_copies<0>();                    // the q tile of a row with nothing listed
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = fmaxf(quad_sum(l[r]), 1e-30f);      // a row with nothing listed: o = 0
    inv[r] = 1.f / l[r];
  }
  T* o = static_cast<T*>(p.o) + (long long)b * p.S * p.H * kD + h * kD;
  store_rows<T>(o, (long long)p.H * kD, acc, wrow0, p.S, inv);
  if (t == 0) {
    float* lse = p.lse + ((long long)b * p.H + h) * p.S;
#pragma unroll
    for (int r = 0; r < 2; ++r) lse[wrow0 + g + 8 * r] = m[r] + logf(l[r]);
  }
}

// --------------------------------------------------------------------------
// dQ: one block per (query block, head, batch), walking the row LUT
// --------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) sparse_dq_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TE = kTileElems<T>, L = Tr<T>::kLd;
  T* sq = reinterpret_cast<T*>(smem);
  T* sdo = sq + TE;
  T* sk = sdo + TE;                 // two buffers each
  T* sv = sk + 2 * TE;
  int* live = reinterpret_cast<int*>(sv + 2 * TE);
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int row0 = qb * kTile, wrow0 = row0 + warp * 16;
  const T* q = at<T>(p.q, b * p.q_sb + h * p.q_sh);
  const T* dout = at<T>(p.dout, b * p.do_sb + h * p.do_sh);
  const T* k = at<T>(p.k, b * p.k_sb + h * p.k_sh);
  const T* v = at<T>(p.v, b * p.v_sb + h * p.v_sh);
  const long long stat0 = ((long long)b * p.H + h) * p.S;
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse[r] = p.lse_in[stat0 + wrow0 + g + 8 * r];
    delta[r] = p.delta[stat0 + wrow0 + g + 8 * r];
  }
  const int n = live_entries<false>(p, h, qb, live);

  load_tile(sq, q, p.q_ss, row0, p.S);
  load_tile(sdo, dout, p.do_ss, row0, p.S);
  if (n > 0) {
    load_tile(sk, k, p.k_ss, live[0] * kTile, p.S);
    load_tile(sv, v, p.v_ss, live[0] * kTile, p.S);
  }
  commit_copies();
  float dq[8][4];
  zero(dq);
  for (int j = 0; j < n; ++j) {
    const int buf = j & 1;
    if (j + 1 < n) {
      load_tile(sk + (buf ^ 1) * TE, k, p.k_ss, live[j + 1] * kTile, p.S);
      load_tile(sv + (buf ^ 1) * TE, v, p.v_ss, live[j + 1] * kTile, p.S);
      commit_copies();
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    __syncthreads();
    float s[8][4], dp[8][4];
    product_nt(s, sq + warp * 16 * L, sk + buf * TE);
    scale_mask<false>(s, p.scale, p.causal && live[j] == qb);
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
  wait_copies<0>();
  const float one[2] = {1.f, 1.f};
  T* out = static_cast<T*>(p.dq) + (long long)b * p.S * p.H * kD + h * kD;
  store_rows<T>(out, (long long)p.H * kD, dq, wrow0, p.S, one);
}

// --------------------------------------------------------------------------
// dKV: one block per (key block, head, batch), walking the column LUT
// --------------------------------------------------------------------------

// Stage query block `qb` into buffer slots: Q and dO by cp.async, lse and
// delta by plain loads.
template <typename T>
__device__ __forceinline__ void load_query_block(const Params& p, T* sq, T* sdo, float* slse,
                                                 float* sdelta, int b, int h, int qb) {
  const int row0 = qb * kTile;
  load_tile(sq, at<T>(p.q, b * p.q_sb + h * p.q_sh), p.q_ss, row0, p.S);
  load_tile(sdo, at<T>(p.dout, b * p.do_sb + h * p.do_sh), p.do_ss, row0, p.S);
  const int i = threadIdx.x & (kTile - 1);
  const float* src = threadIdx.x < kTile ? p.lse_in : p.delta;
  (threadIdx.x < kTile ? slse : sdelta)[i] = src[((long long)b * p.H + h) * p.S + row0 + i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads) sparse_dkv_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TE = kTileElems<T>, L = Tr<T>::kLd;
  static_assert(kThreads == 2 * kTile, "lse and delta take one thread per row each");
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = sk + TE;
  T* sq = sv + TE;                  // two buffers each
  T* sdo = sq + 2 * TE;
  float* slse = reinterpret_cast<float*>(sdo + 2 * TE);     // [2][kTile]
  float* sdelta = slse + 2 * kTile;
  int* live = reinterpret_cast<int*>(sdelta + 2 * kTile);
  const int kb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int key0 = kb * kTile, wkey0 = key0 + warp * 16;
  const int n = live_entries<true>(p, h, kb, live);

  load_tile(sk, at<T>(p.k, b * p.k_sb + h * p.k_sh), p.k_ss, key0, p.S);
  load_tile(sv, at<T>(p.v, b * p.v_sb + h * p.v_sh), p.v_ss, key0, p.S);
  if (n > 0) load_query_block<T>(p, sq, sdo, slse, sdelta, b, h, live[0]);
  commit_copies();
  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);
  for (int j = 0; j < n; ++j) {
    const int buf = j & 1;
    if (j + 1 < n) {
      const int nb = buf ^ 1;
      load_query_block<T>(p, sq + nb * TE, sdo + nb * TE, slse + nb * kTile,
                          sdelta + nb * kTile, b, h, live[j + 1]);
      commit_copies();
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    __syncthreads();
    const float* lse = slse + buf * kTile;
    const float* delta = sdelta + buf * kTile;
    const T* q_tile = sq + buf * TE;
    const T* do_tile = sdo + buf * TE;
    float s[8][4], dp[8][4];
    product_nt(s, sk + warp * 16 * L, q_tile);          // s^T: keys x queries
    scale_mask<true>(s, p.scale, p.causal && live[j] == kb);
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
  wait_copies<0>();
  const float one[2] = {1.f, 1.f};
  const long long off = (long long)b * p.S * p.H * kD + h * kD;
  store_rows<T>(static_cast<T*>(p.dk) + off, (long long)p.H * kD, dk, wkey0, p.S, one);
  store_rows<T>(static_cast<T*>(p.dv) + off, (long long)p.H * kD, dv, wkey0, p.S, one);
}

// --------------------------------------------------------------------------
// launches
// --------------------------------------------------------------------------

enum Which { kForward, kDq, kDkv };

template <typename T>
cudaError_t run(Which which, const Params& p, int B, cudaStream_t st) {
  const dim3 grid(p.nb, p.H, B);
  const size_t live = sizeof(int) * p.max_n;
  switch (which) {
    case kForward:
      return launch(sparse_fwd_kernel<T>, grid, 5 * tile_bytes<T>() + live, p, st);
    case kDq:
      return launch(sparse_dq_kernel<T>, grid, 6 * tile_bytes<T>() + live, p, st);
    default:
      return launch(sparse_dkv_kernel<T>, grid,
                    6 * tile_bytes<T>() + 4 * kTile * sizeof(float) + live, p, st);
  }
}

// strides: [q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, do_b, do_s, do_h], in
// elements.
int dispatch(Which which, Params p, const long long* strides, int B, int dtype, void* stream) {
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.do_sb = strides[9]; p.do_ss = strides[10]; p.do_sh = strides[11];
  const int vec = dtype == 0 ? 4 : 8;             // elements per 16 bytes
  bool ok = B > 0 && B <= 65535 && p.H > 0 && p.H <= 65535 && p.S > 0 && p.S % kTile == 0 &&
            p.max_n > 0 && p.max_n <= p.S / kTile && (dtype == 0 || dtype == 1) &&
            aligned16(p.q) && aligned16(p.k) && aligned16(p.v) &&
            (p.dout == nullptr || aligned16(p.dout));
  for (int i = 0; i < 12; ++i) ok = ok && strides[i] % vec == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  p.nb = p.S / kTile;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0 ? run<float>(which, p, B, st) : run<bf16>(which, p, B, st));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Each returns a cudaError_t (0 = launched).
// q, k, v [B, S, H, 64] by strides, S a multiple of 64; lut int32
// [H * S / 64, max_n] and cnt int32 [H * S / 64], the row LUT (forward, dQ)
// or the column LUT (dKV) of build_luts; o contiguous [B, S, H, 64]; lse
// fp32 contiguous [B, H, S].
int dst_sparse_forward(const void* q, const void* k, const void* v, const int* lut,
                       const int* cnt, void* o, float* lse, const long long* strides, int B,
                       int S, int H, int max_n, float scale, int causal, int dtype,
                       void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.lut = lut; p.cnt = cnt; p.o = o; p.lse = lse;
  p.S = S; p.H = H; p.max_n = max_n; p.scale = scale; p.causal = causal;
  return dispatch(kForward, p, strides, B, dtype, stream);
}

// dout by strides like q; lse and delta fp32 contiguous [B, H, S]; dq
// contiguous [B, S, H, 64].
int dst_sparse_backward_dq(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, const int* lut, const int* cnt,
                           void* dq, const long long* strides, int B, int S, int H, int max_n,
                           float scale, int causal, int dtype, void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse_in = lse; p.delta = delta;
  p.lut = lut; p.cnt = cnt; p.dq = dq;
  p.S = S; p.H = H; p.max_n = max_n; p.scale = scale; p.causal = causal;
  return dispatch(kDq, p, strides, B, dtype, stream);
}

// dk, dv contiguous [B, S, H, 64].
int dst_sparse_backward_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, const int* lut, const int* cnt,
                            void* dk, void* dv, const long long* strides, int B, int S, int H,
                            int max_n, float scale, int causal, int dtype, void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse_in = lse; p.delta = delta;
  p.lut = lut; p.cnt = cnt; p.dk = dk; p.dv = dv;
  p.S = S; p.H = H; p.max_n = max_n; p.scale = scale; p.causal = causal;
  return dispatch(kDkv, p, strides, B, dtype, stream);
}

}  // extern "C"
