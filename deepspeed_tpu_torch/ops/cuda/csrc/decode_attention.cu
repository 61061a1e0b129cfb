// KV-cache decode attention for Hopper (sm_90a): the paged (block-table)
// kernel of the serving engine and the contiguous-cache kernel of
// generate().
//
// Replaces ops/pallas/decode_attention.py:_paged_kernel and :_decode_kernel
// of the JAX package.  Both compute, per (row b, head h, query i at global
// position len_b + i):
//     out = softmax(q . K^T / sqrt(D), causal: col <= len_b + i) . V
// over only the live cache tiles, with an online softmax in fp32.
//
// Bound: bytes.  A decode step reads every live K/V element once and does
// 4 flops per element read (the score and the PV product), far below the
// card's ~295 flops/byte ridge, so the floor is live K/V bytes / 3.35 TB/s.
//
// Design (simple and correct first; wgmma, TMA and split-KV are later work):
// * compiled for the one shape the GPT-2 family serves: tiles of kTile = 16
//   keys (the arena's block size) at head_dim kHeadDim = 64.  The wrappers
//   raise on any other; a configuration that needs another adds its own
//   instantiation.
// * grid (H, B, ceil(S_q / 32)): one block per (head, row, 32-query group).
//   The TPU grid is (B,) with one DMA feeding all heads; here 8 decode rows
//   x 25 heads give 200 blocks to spread over the 132 SMs.
// * each block walks its row's live tiles in logical order.  Each of the
//   128 threads loads 8 contiguous elements of the next tile's K and V (one
//   or two 16-byte loads each) into registers while the current tile is
//   consumed, then stages them in shared memory as fp32.  Each warp updates
//   the running max, sum and accumulator of its query rows (kept in shared
//   memory across tiles).
// * within a warp, lane (j, part) computes half of the score of key j; one
//   shuffle completes it.  The PV product runs with lanes over the head
//   dimension, keys in order.  Both loops visit only the columns the causal
//   mask keeps, so the result of a row does not depend on how many masked
//   columns or tiles the block also walks.
// * the two kernels share attend_rows(); only the address of a key differs
//   (a block-table lookup or a stride).  They therefore give bit-identical
//   fp32 results, which generate() == serve relies on.
// * the loop bound is min(ceil((len + S_q) / kTile), MB) for the paged
//   kernel (a padded prefill chunk can push len + S_q past MB * BS) and
//   ceil(min(len + S_q, T) / kTile) for the contiguous one (ragged T masked).
// * masked scores are -1e30 and the PV product takes p rounded to the cache
//   dtype, as the JAX kernels have them; the output is written in q's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTile = 16;           // keys per tile = the arena's block size
constexpr int kHeadDim = 64;        // GPT-2 family head_dim
constexpr int kRowsPerBlock = 32;   // query rows one block owns
constexpr int kThreads = 128;       // 4 warps: all load, each owns query rows
constexpr int kVec = kTile * kHeadDim / kThreads;   // elements one thread loads per tile
constexpr int kThreadsPerKey = kHeadDim / kVec;
constexpr int kParts = 32 / kTile;  // lanes that share one key's score
constexpr int kLdk = kHeadDim + 2;  // k_s row stride: lanes (j, part) hit 32 distinct banks
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kVec * kThreadsPerKey == kHeadDim && kTile * kThreadsPerKey == kThreads,
              "one tile is one load per thread");
static_assert(kHeadDim % 32 == 0 && 32 % kTile == 0, "lane mapping");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// kVec elements of T as raw 16-byte words: 1 for bf16, 2 for fp32.
template <typename T> struct Raw {
  static constexpr int kWords = kVec * sizeof(T) / 16;
  uint4 w[kWords];
};

__device__ __forceinline__ void unpack(const Raw<float>& r, float* f) {
#pragma unroll
  for (int i = 0; i < Raw<float>::kWords; ++i) {
    f[4 * i + 0] = __uint_as_float(r.w[i].x);
    f[4 * i + 1] = __uint_as_float(r.w[i].y);
    f[4 * i + 2] = __uint_as_float(r.w[i].z);
    f[4 * i + 3] = __uint_as_float(r.w[i].w);
  }
}

// bf16 -> fp32 is exact: the bf16 bits are the high half of the fp32 bits
// (the first element is the low half of the 32-bit word, little-endian).
__device__ __forceinline__ void unpack_pair(unsigned u, float* f) {
  f[0] = __uint_as_float(u << 16);
  f[1] = __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ void unpack(const Raw<__nv_bfloat16>& r, float* f) {
#pragma unroll
  for (int i = 0; i < Raw<__nv_bfloat16>::kWords; ++i) {
    unpack_pair(r.w[i].x, f + 8 * i);
    unpack_pair(r.w[i].y, f + 8 * i + 2);
    unpack_pair(r.w[i].z, f + 8 * i + 4);
    unpack_pair(r.w[i].w, f + 8 * i + 6);
  }
}

// Element offset of key column `col` of one (row, kv head) stream.
struct PagedAddr {
  const int* table;   // this row's block table, MB entries
  int hkv_count, hkv;
  __device__ __forceinline__ long long operator()(int col) const {
    const long long phys = table[col / kTile];
    return ((phys * kTile + col % kTile) * hkv_count + hkv) * kHeadDim;
  }
};

struct DenseAddr {
  long long row_base;  // b * T
  int h_count, h;
  __device__ __forceinline__ long long operator()(int col) const {
    return ((row_base + col) * h_count + h) * kHeadDim;
  }
};

// This thread's slice of tile t: key tid / kThreadsPerKey, elements
// [c0, c0 + kVec).  Columns at or past n_cols (the ragged end of a
// contiguous cache) are zero and never read from memory.
template <typename T, typename Addr>
__device__ __forceinline__ void load_tile(const T* __restrict__ k, const T* __restrict__ v,
                                          const Addr& addr, int t, int n_cols, Raw<T>& kr,
                                          Raw<T>& vr) {
  const int col = t * kTile + threadIdx.x / kThreadsPerKey;
  const int c0 = (threadIdx.x % kThreadsPerKey) * kVec;
  if (col < n_cols) {
    const long long off = addr(col) + c0;
    const uint4* kp = reinterpret_cast<const uint4*>(k + off);
    const uint4* vp = reinterpret_cast<const uint4*>(v + off);
#pragma unroll
    for (int i = 0; i < Raw<T>::kWords; ++i) {
      kr.w[i] = __ldg(kp + i);
      vr.w[i] = __ldg(vp + i);
    }
  } else {
#pragma unroll
    for (int i = 0; i < Raw<T>::kWords; ++i) kr.w[i] = vr.w[i] = make_uint4(0, 0, 0, 0);
  }
}

template <typename T>
__device__ __forceinline__ void stage_tile(float* k_s, float* v_s, const Raw<T>& kr,
                                           const Raw<T>& vr) {
  const int jj = threadIdx.x / kThreadsPerKey;
  const int c0 = (threadIdx.x % kThreadsPerKey) * kVec;
  float kf[kVec], vf[kVec];
  unpack(kr, kf);
  unpack(vr, vf);
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    k_s[jj * kLdk + c0 + e] = kf[e];
    v_s[jj * kLdk + c0 + e] = vf[e];
  }
}

size_t smem_bytes(int rows) {
  return sizeof(float) * (size_t)(2 * kTile * kLdk + 2 * rows * kHeadDim + 2 * rows);
}

// One block: query rows [row0, row0 + nrows) of (b, h) against n_cols key
// columns (only the first min(len + row0 + nrows, n_cols) are live).
template <typename T, typename Addr>
__device__ void attend_rows(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ out,
                            const Addr addr, int b, int h, int sq, int h_count, int len,
                            int n_cols, float scale) {
  constexpr int d = kHeadDim;
  extern __shared__ float smem[];
  const int row0 = blockIdx.z * kRowsPerBlock;
  const int rows = min(sq, kRowsPerBlock);          // shared-memory row stride
  const int nrows = min(kRowsPerBlock, sq - row0);
  float* k_s = smem;
  float* v_s = k_s + kTile * kLdk;
  float* q_s = v_s + kTile * kLdk;
  float* acc_s = q_s + rows * d;
  float* m_s = acc_s + rows * d;
  float* l_s = m_s + rows;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = kThreads >> 5;

  for (int i = tid; i < nrows * d; i += kThreads) {
    const int r = i / d, c = i % d;
    q_s[i] = to_f(q[(((long long)b * sq + row0 + r) * h_count + h) * d + c]);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < nrows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int last_col = min(len + row0 + nrows - 1, n_cols - 1);
  const int n_tiles = last_col / kTile + 1;
  const int j = lane % kTile, part = lane / kTile;

  Raw<T> kr, vr;
  load_tile(k, v, addr, 0, n_cols, kr, vr);
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();                                // previous tile consumed
    stage_tile<T>(k_s, v_s, kr, vr);
    if (t + 1 < n_tiles) load_tile(k, v, addr, t + 1, n_cols, kr, vr);
    __syncthreads();

    for (int r = warp; r < nrows; r += nwarps) {
      const int qpos = len + row0 + r;
      // columns of this tile the causal mask keeps for row r (a prefix)
      const int n_valid = min(min(qpos, n_cols - 1) - t * kTile + 1, kTile);
      if (n_valid <= 0) continue;                   // warp-uniform

      const float* qrow = q_s + r * d;
      const float* krow = k_s + j * kLdk;
      float s = 0.f;
#pragma unroll
      for (int c = part; c < d; c += kParts) s += qrow[c] * krow[c];
#pragma unroll
      for (int off = kTile; off < 32; off <<= 1) s += __shfl_xor_sync(kFull, s, off);
      const bool keep = j < n_valid;
      s = keep ? s * scale : kNegInf;

      float mt = s;
#pragma unroll
      for (int off = 1; off < kTile; off <<= 1) mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mt);
      const float p = keep ? expf(s - m_new) : 0.f;
      float ps = p;
#pragma unroll
      for (int off = 1; off < kTile; off <<= 1) ps += __shfl_xor_sync(kFull, ps, off);
      const float alpha = expf(m_old - m_new);
      const float pv = to_f(from_f<T>(p));          // PV takes p in the cache dtype

      float a[d / 32];
#pragma unroll
      for (int i = 0; i < d / 32; ++i) a[i] = 0.f;
#pragma unroll
      for (int jj = 0; jj < kTile; ++jj) {
        if (jj < n_valid) {                         // warp-uniform
          const float pj = __shfl_sync(kFull, pv, jj);
          const float* vrow = v_s + jj * kLdk;
#pragma unroll
          for (int i = 0; i < d / 32; ++i) a[i] += pj * vrow[i * 32 + lane];
        }
      }
      float* ar = acc_s + r * d;
#pragma unroll
      for (int i = 0; i < d / 32; ++i) ar[i * 32 + lane] = ar[i * 32 + lane] * alpha + a[i];
      __syncwarp();                                 // every lane has read m_s[r]
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + ps;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = tid; i < nrows * d; i += kThreads) {
    const int r = i / d, c = i % d;
    out[(((long long)b * sq + row0 + r) * h_count + h) * d + c] =
        from_f<T>(acc_s[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages, const int* __restrict__ block_tables,
                       const int* __restrict__ lengths, T* __restrict__ out, int sq,
                       int h_count, int hkv_count, int mb, float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const PagedAddr addr{block_tables + (long long)b * mb, hkv_count,
                       h / (h_count / hkv_count)};
  attend_rows<T>(q, k_pages, v_pages, out, addr, b, h, sq, h_count, lengths[b], mb * kTile,
                 scale);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ ck,
                        const T* __restrict__ cv, T* __restrict__ out, int sq, int h_count,
                        int t_len, int pos, float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const DenseAddr addr{(long long)b * t_len, h_count, h};
  attend_rows<T>(q, ck, cv, out, addr, b, h, sq, h_count, pos, t_len, scale);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

dim3 grid_for(int h, int b, int sq) {
  return dim3(h, b, (sq + kRowsPerBlock - 1) / kRowsPerBlock);
}

bool aligned(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
int dst_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                        const int* block_tables, const int* lengths, void* out, int b,
                        int sq, int h, int hkv, int d, int bs, int mb, float scale,
                        int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || d != kHeadDim ||
      bs != kTile || mb <= 0 || b > 65535 || (dtype != 0 && dtype != 1) ||
      !aligned(k_pages) || !aligned(v_pages))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(std::min(sq, kRowsPerBlock));
  const dim3 grid = grid_for(h, b, sq);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 0) {
    err = prepare(paged_attention_kernel<float>, smem);
    if (err != cudaSuccess) return (int)err;
    paged_attention_kernel<float><<<grid, kThreads, smem, st>>>(
        (const float*)q, (const float*)k_pages, (const float*)v_pages, block_tables, lengths,
        (float*)out, sq, h, hkv, mb, scale);
  } else {
    err = prepare(paged_attention_kernel<__nv_bfloat16>, smem);
    if (err != cudaSuccess) return (int)err;
    paged_attention_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
        (const __nv_bfloat16*)v_pages, block_tables, lengths, (__nv_bfloat16*)out, sq, h,
        hkv, mb, scale);
  }
  return (int)cudaGetLastError();
}

int dst_decode_attention(const void* q, const void* ck, const void* cv, void* out, int b,
                         int sq, int h, int d, int t_len, int pos, float scale, int dtype,
                         void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0 || d != kHeadDim || t_len <= 0 || pos < 0 ||
      b > 65535 || (dtype != 0 && dtype != 1) || !aligned(ck) || !aligned(cv))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(std::min(sq, kRowsPerBlock));
  const dim3 grid = grid_for(h, b, sq);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 0) {
    err = prepare(decode_attention_kernel<float>, smem);
    if (err != cudaSuccess) return (int)err;
    decode_attention_kernel<float><<<grid, kThreads, smem, st>>>(
        (const float*)q, (const float*)ck, (const float*)cv, (float*)out, sq, h, t_len, pos,
        scale);
  } else {
    err = prepare(decode_attention_kernel<__nv_bfloat16>, smem);
    if (err != cudaSuccess) return (int)err;
    decode_attention_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)ck, (const __nv_bfloat16*)cv,
        (__nv_bfloat16*)out, sq, h, t_len, pos, scale);
  }
  return (int)cudaGetLastError();
}

const char* dst_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
