// KV-cache attention for Hopper (sm_90a): the paged (block-table) kernel of
// the serving engine and the contiguous-cache kernel of generate().
//
// Replaces ops/pallas/decode_attention.py:_paged_kernel and :_decode_kernel
// of the JAX package.  Both compute, per (row b, head h, query i at global
// position len_b + i):
//     out = softmax(q . K^T / sqrt(D) + slope_h (col - len_b - i),
//                   causal: col <= len_b + i) . V
// against kv head h / (H / Hkv) of the cache (grouped-query attention; the
// ALiBi term only where slopes are given, as JAX's reference adds its bias
// (ops/pallas/decode_attention.py:193), and in log2 units as every score
// here) over only the live cache columns, with an online softmax in fp32: masked
// scores are -1e30 and carry weight 0, the running max starts at -1e30, PV
// takes p rounded to the cache dtype, out = acc / max(l, 1e-30) in q's
// dtype, and columns past the cache (a contiguous cache's ragged tail, a
// table row's end) are masked.
//
// Bound: bytes.  Every live K/V element is read once and takes 4 flops
// (score and PV), far below the card's ~295 flops/byte ridge, so the floor
// is the live K/V bytes over 3.35 TB/s (a 64-query prefill chunk does 64x
// the flops on the same bytes and stays below the ridge in bf16).  Short
// rows do not fill the card, so the rest is latency: each path keeps its
// dependent reads few (length and block table read together, K/V copies
// issued before the query tile is needed) and many loads in flight.
//
// Two paths, picked on the host by S_q alone (never by T, MB, the lengths
// or the addressing), so both kernels take the same one for the same call:
//
// * decode, S_q <= kDecodeMaxRows (4): CUDA cores.  One block of 8 warps per
//   (row b, head h), all S_q query rows in registers.  The live 16-key
//   blocks (aligned to absolute positions 0, 16, ...) are dealt to the warps
//   round robin: block n goes to warp n % 8, so each warp walks every 8th
//   block and all 8 warps stream one row's keys at once.  A warp copies a
//   block with 16 bytes a lane (a key row per D / 8 lanes in bf16, D / 4 in
//   fp32, rounded up to a power of two at head_dim 96, whose last lanes
//   copy nothing; fp32 at 256 two chunks a lane and the block in two parts
//   of 8 keys, see Lanes) into a ring in its own shared memory by cp.async,
//   as deep as 16 KB a warp holds (at most 3 parts: bf16 3 at head_dim 64,
//   2 at 96 and 128, 1 at 256; fp32 2, then 1), 128 KB a block of 8 warps
//   at most; each lane reads back only
//   what it copied, so the ring needs no barrier.  Each warp keeps its own
//   (m, l, acc) per row; at the end the 8 partial states are merged in
//   shared memory in warp order 0..7, each rescaled to the row's overall
//   max.  A warp with no live block leaves m = -1e30, l = 0, acc = 0,
//   which the merge weights by exp(-1e30 - m) = 0: no NaN.
// * prefill, S_q > 4: tensor cores.  Per (64-query tile, head, row) a
//   cluster of 4 blocks of 4 warps on neighbouring SMs, each warp 16 query
//   rows; block g of the cluster walks 64-key tiles g, g + 4, ... (4 arena
//   blocks each, looked up through the table; positions 0, 64, ...) double
//   buffered in shared memory with cp.async, and block 0 merges the 4
//   states through distributed shared memory in rank order.  bf16 products
//   are mma.sync m16n8k16 with fragments loaded by ldmatrix (.trans for V);
//   fp32 uses FMA in the same register layout (attention_tile.cuh), no
//   TF32 (wgmma would not help: a call is ~0.3 GFLOP, far from the tensor
//   cores' limit; the time is latency and the exponentials).  Key tiles
//   wholly past the tile's last query are not visited; the mask is applied
//   by value only where some column of the tile lies past a row's position.
//   Key rows past the tile's last live column (its last query's position,
//   or the end of the table or cache) are zero-filled and never read, so a
//   tile that crosses a table row's end reads no table entry at or past
//   MB.  Query rows past S_q are zero-filled and never written.
//
// Scores are kept in log2 units (q . k * log2(e) / sqrt(D)) so that each
// exponential is one ex2.approx instruction; exp2(0) = 1 exactly.
//
// Why paged and contiguous agree bit for bit in fp32: both run the same
// device function for each path and differ only in the address of a key
// row (a table lookup, or a stride), and the split of the keys over warps
// and tiles depends only on absolute key positions.
//
// Row independence: within each path, a query row's fp32 result depends
// only on its own position and the keys.  Its tiles are fixed by absolute
// position; a block or warp may also visit a tile that lies wholly past the
// row (for the sake of later rows), and such a tile leaves m, l and acc
// exactly as they were (alpha = exp2(0) = 1, p = 0); a warp or cluster
// block with nothing live for the row adds exactly 0 in the merge.  So a prompt prefilled
// whole (generate()) and in chunks (the serving engine) gives the same rows.
// The two paths differ from each other in summation order.
//
// Compiled for arena blocks of 16 keys and head_dim 64 (GPT-2), 96
// (GPT-NeoX-20B), 128 (the LLaMA and BLOOM widths users serve) and 256
// (GPT-J), a template on D; the wrappers raise on any other.  A prefill
// block's shared memory is a query tile and two K and V tiles: 87 KB in
// bf16 and 169 KB in fp32 at D 128, 165 KB in bf16 at 256; fp32 at 256
// keeps one K and one V tile (195 KB; kPrefillBufs), so its next tile's
// copies wait for the barrier that ends the current one.  A decode block's
// ring is 128 KB at 256 (one 16 KB part a warp) beside 32 KB of merge
// state at S_q 4.

#include <cooperative_groups.h>

#include "attention_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 16;              // keys per arena block
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDecodeMaxRows = 4;       // S_q up to this takes the decode path
constexpr int kDecodeWarps = 8;
constexpr int kDecodeThreads = 32 * kDecodeWarps;
static_assert(kTile % kBlock == 0, "a prefill key tile is whole arena blocks");

__device__ __forceinline__ bool aligned_ptr(const void* p) { return ((uintptr_t)p & 15u) == 0; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// --------------------------------------------------------------------------
// addressing: the two kernels differ only here
// --------------------------------------------------------------------------

// handle(n) names the sequence's 16-key block n (called only for n < MB);
// offset(hnd, key) is the element offset of key row `key` (0..15) of it,
// for kv head hkv.
template <int D> struct PagedAddr {
  const int* table;   // this row's block table, MB entries
  int hkv_count, hkv;
  __device__ __forceinline__ int handle(int n) const { return table[n]; }
  __device__ __forceinline__ long long offset(int hnd, int key) const {
    return (((long long)hnd * kBlock + key) * hkv_count + hkv) * D;
  }
};

template <int D> struct DenseAddr {
  long long row_base;  // b * T
  int hkv_count, hkv;
  __device__ __forceinline__ int handle(int n) const { return n; }
  __device__ __forceinline__ long long offset(int hnd, int key) const {
    return ((row_base + (long long)hnd * kBlock + key) * hkv_count + hkv) * D;
  }
};

template <typename T> struct Args {
  const T* q; const T* k; const T* v; T* out;
  const int* tables; const int* lengths;  // paged
  const float* slopes;                    // ALiBi slopes [H], or null
  int sq, h_count, hkv_count, mb;         // mb: table width (paged)
  int t_len, pos;                         // contiguous
  float scale_log2;                       // log2(e) / sqrt(D)
};

// The row's cache length: the position of its first query.
template <typename T> __device__ __forceinline__ int a_len(const Args<T>& a, int b) {
  return a.lengths != nullptr ? a.lengths[b] : a.pos;
}

// Query head h reads kv head h / G, G = H / Hkv query heads a kv head.
template <typename T> __device__ __forceinline__ int kv_head(const Args<T>& a, int h) {
  return h / (a.h_count / a.hkv_count);
}

// Head h's ALiBi slope in log2 units; 0 without ALiBi.
template <typename T> __device__ __forceinline__ float slope_log2(const Args<T>& a, int h) {
  return a.slopes != nullptr ? __fmul_rn(a.slopes[h], kLog2e) : 0.f;
}

// A score in log2 units: q . k scaled, plus the ALiBi term slope * (key -
// query position), which is <= 0 for every live key (exactly the scaled
// product when the slope is 0).
__device__ __forceinline__ float score_log2(float dot, float scale_log2, float slope2, int key,
                                            int qpos) {
  return fmaf(slope2, (float)(key - qpos), __fmul_rn(dot, scale_log2));
}

// --------------------------------------------------------------------------
// decode path
// --------------------------------------------------------------------------

constexpr int pow2_ceil(int n) { return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2); }

// How a warp holds key rows, at (bf16 | fp32) and head_dim 64, 96, 128, 256.
// A key row is kChunks 16-byte chunks; a lane holds kWide of them (2 only
// for fp32 at 256, whose 64 chunks outnumber the lanes), so kPerKey lanes,
// a power of two, share a key row and reduce its scores by xor shuffles.
// At head_dim 96 a row's 12 (24) chunks spread over 16 (32) lanes: the 4
// (8) lanes past them copy and hold zeros (a quarter of the warp idle, in
// exchange for the power-of-two reductions of the other widths).  A warp
// copies kKeysPerLoad keys a load; a 16-key block is kSplit parts of
// kPartKeys keys, a part being what one stage of the ring holds: the whole
// block except fp32 at 256 (32 KB of K and V, two parts of 16 KB).
template <typename T, int D> struct Lanes {
  static constexpr int kElems = 16 / sizeof(T);         // per 16-byte chunk: 8 bf16, 4 fp32
  static constexpr int kChunks = D / kElems;            // 8, 12, 16, 32 | 16, 24, 32, 64
  static constexpr int kWide = (kChunks + 31) / 32;     // chunks a lane holds of a key row
  static constexpr int kCols = kWide * kElems;          // columns a lane holds: 8 | 4, 8 at 256
  static constexpr int kPerKey = pow2_ceil(kChunks / kWide);   // 8, 16, 16, 32 | 16, 32, 32, 32
  static constexpr int kKeysPerLoad = 32 / kPerKey;     // 4, 2, 2, 1 | 2, 1, 1, 1
  static constexpr int kBlockBytes = 2 * kBlock / kKeysPerLoad * kWide * 512;   // K and V
  static constexpr int kSplit = kBlockBytes > 16384 ? 2 : 1;
  static constexpr int kPartKeys = kBlock / kSplit;
  static constexpr int kLoads = kPartKeys / kKeysPerLoad;   // warp loads a part: 4, 8, 8, 16 | 8, 16, 16, 8
  // parts in a warp's ring: as many as 16 KB holds, at most 3 (bf16 3, 2, 2,
  // 1; fp32 2, 1, 1, 1)
  static constexpr int kStageBytes = 2 * kLoads * kWide * 512;
  static constexpr int kStages = 16384 / kStageBytes < 3 ? 16384 / kStageBytes : 3;
  static_assert(kPerKey * kWide >= kChunks && kPerKey <= 32, "a key row fits the lanes");
  static_assert(kStages >= 1, "a warp's ring holds a part");
};

__device__ __forceinline__ void unpack16(const uint4& w, float (&f)[4]) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}

// bf16 -> fp32 is exact: the bf16 bits are the high half of the fp32 bits
// (the first element is the low half of the 32-bit word, little-endian).
__device__ __forceinline__ void unpack16(const uint4& w, float (&f)[8]) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// One part of a 16-key block, K and V, as this lane holds it: for load i,
// key part * kPartKeys + i * kKeysPerLoad + lane / kPerKey, chunks
// lane % kPerKey + w * kPerKey (w < kWide).
template <typename T, int D> struct KV {
  uint4 k[Lanes<T, D>::kLoads][Lanes<T, D>::kWide], v[Lanes<T, D>::kLoads][Lanes<T, D>::kWide];
};

// A warp's stage holds one part: K then V, each kLoads x kWide x 32 lanes
// x 16 bytes, lane-major, so a warp's copy or read of one slot is 512
// contiguous bytes.  Each lane reads back only what it copied itself, so
// the ring needs no barrier, only cp.async.wait_group.
template <typename T, int D>
__device__ __forceinline__ int slot_offset(int i, int w, bool is_v) {
  using L = Lanes<T, D>;
  return (((is_v ? L::kLoads * L::kWide : 0) + i * L::kWide + w) * 32 + (threadIdx.x & 31)) * 16;
}

// Copy part `part` of block n (handle hnd) into a stage; keys past last_col
// and chunks past the row (head_dim 96's idle lanes) are zeros and are not
// read.  Asynchronous: commit, then wait before read_part.
template <typename T, int D, typename Addr>
__device__ __forceinline__ void copy_part(unsigned char* stage, const T* k, const T* v,
                                          const Addr& addr, int hnd, int n, int part,
                                          int last_col) {
  using L = Lanes<T, D>;
  const int lane = threadIdx.x & 31, j = lane / L::kPerKey, ch0 = lane % L::kPerKey;
#pragma unroll
  for (int i = 0; i < L::kLoads; ++i) {
    const int key = part * L::kPartKeys + i * L::kKeysPerLoad + j;
    const bool live = n * kBlock + key <= last_col;
    const long long row = live ? addr.offset(hnd, key) : 0;
#pragma unroll
    for (int w = 0; w < L::kWide; ++w) {
      const int ch = ch0 + w * L::kPerKey;
      const bool valid = live && ch < L::kChunks;
      const long long off = valid ? row + ch * L::kElems : 0;
      copy16_async(stage + slot_offset<T, D>(i, w, false), k + off, valid);
      copy16_async(stage + slot_offset<T, D>(i, w, true), v + off, valid);
    }
  }
}

template <typename T, int D>
__device__ __forceinline__ void read_part(KV<T, D>& kv, const unsigned char* stage) {
  using L = Lanes<T, D>;
#pragma unroll
  for (int i = 0; i < L::kLoads; ++i)
#pragma unroll
    for (int w = 0; w < L::kWide; ++w) {
      kv.k[i][w] = *reinterpret_cast<const uint4*>(stage + slot_offset<T, D>(i, w, false));
      kv.v[i][w] = *reinterpret_cast<const uint4*>(stage + slot_offset<T, D>(i, w, true));
    }
}

// The warp's running state of its rows: m and l are whole-warp values once a
// part is folded in (l summed over this lane's key group only, until the
// end), acc is this lane's kCols columns over its key group.
template <typename T, int D, int kRows> struct RowState {
  float m[kRows], l[kRows], acc[kRows][Lanes<T, D>::kCols];
};

template <typename T, int D, int kRows>
__device__ __forceinline__ void attend_part(RowState<T, D, kRows>& st, const KV<T, D>& kv,
                                            const float (&qf)[kRows][Lanes<T, D>::kCols],
                                            int n, int part, int len, int n_cols,
                                            float scale_log2, float slope2) {
  using L = Lanes<T, D>;
  constexpr int E = L::kElems, W = L::kWide, C = L::kCols;
  const int first = n * kBlock + part * L::kPartKeys;   // the part's first key
  const int j = (threadIdx.x & 31) / L::kPerKey;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int lim = min(len + r, n_cols - 1);       // last column row r attends to
    if (first > lim) continue;                      // warp-uniform: the part is past row r
    float s[L::kLoads];
#pragma unroll
    for (int i = 0; i < L::kLoads; ++i) {
      float d = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        float kf[E];
        unpack16(kv.k[i][w], kf);
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qf[r][w * E + e], kf[e], d);
      }
#pragma unroll
      for (int off = 1; off < L::kPerKey; off <<= 1) d = __fadd_rn(d, __shfl_xor_sync(kFull, d, off));
      const int key = first + i * L::kKeysPerLoad + j;
      s[i] = key <= lim ? score_log2(d, scale_log2, slope2, key, len + r) : kNegInf;
    }
    float mt = s[0];
#pragma unroll
    for (int i = 1; i < L::kLoads; ++i) mt = fmaxf(mt, s[i]);
#pragma unroll
    for (int off = L::kPerKey; off < 32; off <<= 1) mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
    const float m_new = fmaxf(st.m[r], mt);
    const float alpha = exp2_approx(__fsub_rn(st.m[r], m_new));
    float ps = 0.f, pv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) pv[c] = 0.f;
#pragma unroll
    for (int i = 0; i < L::kLoads; ++i) {
      const bool keep = first + i * L::kKeysPerLoad + j <= lim;
      const float p = keep ? exp2_approx(__fsub_rn(s[i], m_new)) : 0.f;
      ps = __fadd_rn(ps, p);
      const float pr = to_f(from_f<T>(p));          // PV takes p in the cache dtype
#pragma unroll
      for (int w = 0; w < W; ++w) {
        float vf[E];
        unpack16(kv.v[i][w], vf);
#pragma unroll
        for (int e = 0; e < E; ++e) pv[w * E + e] = fmaf(pr, vf[e], pv[w * E + e]);
      }
    }
    st.l[r] = fmaf(st.l[r], alpha, ps);
#pragma unroll
    for (int c = 0; c < C; ++c) st.acc[r][c] = fmaf(st.acc[r][c], alpha, pv[c]);
    st.m[r] = m_new;
  }
}

// One block: the kRows (= S_q) query rows of (b, h).
template <typename T, int D, int kRows, typename Addr>
__device__ __forceinline__ void decode_rows(const Args<T>& a, const Addr& addr, int b, int h,
                                            int n_cols) {
  using L = Lanes<T, D>;
  constexpr int E = L::kElems, W = L::kWide, C = L::kCols, S = L::kStages, P = L::kSplit;
  __shared__ float s_m[kDecodeWarps][kRows], s_l[kDecodeWarps][kRows];
  __shared__ float s_acc[kDecodeWarps][kRows][D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ch0 = lane % L::kPerKey;          // this lane's chunks: ch0 + w * kPerKey
  const long long row_stride = (long long)a.h_count * D;
  const long long base = (long long)b * kRows * row_stride + (long long)h * D;
  const float slope2 = slope_log2(a, h);

  float qf[kRows][C];
  RowState<T, D, kRows> st;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int ch = ch0 + w * L::kPerKey;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        qf[r][w * E + e] =
            ch < L::kChunks ? to_f(a.q[base + r * row_stride + ch * E + e]) : 0.f;
        st.acc[r][w * E + e] = 0.f;
      }
    }
    st.m[r] = kNegInf;
    st.l[r] = 0.f;
  }

  // this warp's blocks: warp, warp + 8, ... up to the last live one, each
  // walked as its P parts (items i: block i / P, part i % P).  Lane l holds
  // the handle of the warp's block 32 * (n / 32) + l; the first 32 are read
  // before the length is known (the table is read only below its width
  // n_cols / 16), so the two reads overlap
  const auto block_of = [&](int i) { return warp + i * kDecodeWarps; };
  int hnd = block_of(lane) * kBlock < n_cols ? addr.handle(block_of(lane)) : 0;
  const int len = a_len(a, b);
  const int last_col = min(len + kRows - 1, n_cols - 1);
  const int n_blocks = last_col / kBlock + 1;
  const int count = warp < n_blocks ? (n_blocks - 1 - warp) / kDecodeWarps + 1 : 0;
  const int items = count * P;

  extern __shared__ __align__(128) unsigned char ring[];   // kStages parts per warp
  constexpr int kStage = L::kStageBytes;
  unsigned char* my = ring + warp * S * kStage;
#pragma unroll
  for (int s = 0; s + 1 < S; ++s) {
    if (s < items)
      copy_part<T, D>(my + s * kStage, a.k, a.v, addr, __shfl_sync(kFull, hnd, s / P),
                      block_of(s / P), s % P, last_col);
    commit_copies();
  }
  for (int i = 0; i < items; ++i) {
    const int next = i + S - 1;
    if (next < items) {
      const int nb = next / P;
      if ((nb & 31) == 0 && next % P == 0)
        hnd = nb + lane < count ? addr.handle(block_of(nb + lane)) : 0;
      copy_part<T, D>(my + (next % S) * kStage, a.k, a.v, addr, __shfl_sync(kFull, hnd, nb & 31),
                      block_of(nb), next % P, last_col);
    }
    commit_copies();
    wait_copies<S - 1>();                           // item i has landed
    KV<T, D> kv;
    read_part(kv, my + (i % S) * kStage);
    attend_part<T, D, kRows>(st, kv, qf, block_of(i / P), i % P, len, n_cols, a.scale_log2,
                             slope2);
  }

  // the warp's state: sum l and acc over the lane groups of different keys
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int off = L::kPerKey; off < 32; off <<= 1) {
      st.l[r] = __fadd_rn(st.l[r], __shfl_xor_sync(kFull, st.l[r], off));
#pragma unroll
      for (int c = 0; c < C; ++c)
        st.acc[r][c] = __fadd_rn(st.acc[r][c], __shfl_xor_sync(kFull, st.acc[r][c], off));
    }
  if (lane < L::kPerKey)
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int ch = ch0 + w * L::kPerKey;
      if (ch < L::kChunks)
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int e = 0; e < E; ++e) s_acc[warp][r][ch * E + e] = st.acc[r][w * E + e];
    }
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      s_m[warp][r] = st.m[r];
      s_l[warp][r] = st.l[r];
    }
  __syncthreads();

  // merge the warps in order 0..7, each rescaled to the row's max
  for (int i = threadIdx.x; i < kRows * D; i += kDecodeThreads) {
    const int r = i / D, c = i % D;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) m = fmaxf(m, s_m[w][r]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float f = exp2_approx(__fsub_rn(s_m[w][r], m));
      l = fmaf(f, s_l[w][r], l);
      acc = fmaf(f, s_acc[w][r][c], acc);
    }
    a.out[base + r * row_stride + c] = from_f<T>(__fdiv_rn(acc, fmaxf(l, 1e-30f)));
  }
}

// --------------------------------------------------------------------------
// prefill path
// --------------------------------------------------------------------------

// c = a . b^T for the warp's 16 rows of a and the 64 rows of b ([row][D] in
// shared memory).  Lane l addresses row l % 8 of 8x8 matrix l / 8; the four
// matrices of one ldmatrix are A's (rows 0-7 | 8-15) x (columns 0-7 | 8-15)
// of a 16-deep slice, or B's two halves of that slice for two 8-key slices.
template <int D>
__device__ __forceinline__ void scores_tile(float (&c)[8][4], const bf16* a, const bf16* b) {
  constexpr int L = Tr<bf16, D>::kLd;
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
  zero(c);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + ((mi & 1) * 8 + r8) * L + kk * 16 + (mi >> 1) * 8);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t bfr[4];
      ldsm_x4(bfr, b + ((2 * jp + (mi >> 1)) * 8 + r8) * L + kk * 16 + (mi & 1) * 8);
      mma_bf16(c[2 * jp], af[0], af[1], af[2], af[3], bfr[0], bfr[1]);
      mma_bf16(c[2 * jp + 1], af[0], af[1], af[2], af[3], bfr[2], bfr[3]);
    }
  }
}

template <int D>
__device__ __forceinline__ void scores_tile(float (&c)[8][4], const float* a, const float* b) {
  product_nt<8, D>(c, a, b);
}

// The blocks of one query tile form a cluster of kPrefillCluster blocks on
// neighbouring SMs: block g walks key tiles g, g + G, ... of the tile's 64
// rows (each warp 16 rows), so G key tiles are in flight and in the tensor
// cores at once, and block 0 merges the G states through distributed shared
// memory at the end.
constexpr int kPrefillCluster = 4;

// K and V buffers of a prefill block: two each (the next key tile loads
// while this one is used) where the query tile and four buffers fit a
// block's shared memory, else one each (fp32 at head_dim 256: 5 x 65 KB
// would not fit; 3 x 65 KB does, and the next tile's copies wait for the
// barrier that ends this one)
template <typename T, int D>
constexpr int kPrefillBufs = 5 * sizeof(T) * kTileElems<T, D> <= kMaxSmem ? 2 : 1;

// Shared memory of a prefill block: the query tile and the K and V buffers.
template <typename T, int D>
constexpr size_t kPrefillSmem = (1 + 2 * kPrefillBufs<T, D>) * sizeof(T) * kTileElems<T, D>;

// The query tile: rows [row0, row0 + 64) of q (row stride `stride`, a
// multiple of 16 bytes), rows at or past S_q zero.  16-byte cp.async copies
// when q is 16-byte aligned (as a fresh tensor is), else element loads.
template <typename T, int D>
__device__ __forceinline__ void load_query_tile(T* dst, const T* q, long long stride, int row0,
                                                int sq) {
  constexpr int L = Tr<T, D>::kLd, kElems = 16 / sizeof(T), kChunks = D / kElems;
  if (aligned_ptr(q)) {
    for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
      const int r = c / kChunks, e = (c % kChunks) * kElems;
      const bool valid = row0 + r < sq;
      copy16_async(dst + r * L + e, valid ? q + (row0 + r) * stride + e : q, valid);
    }
    return;
  }
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * L + c] = row0 + r < sq ? q[(row0 + r) * stride + c] : from_f<T>(0.f);
  }
}

// Key tile `tile` of K and V (keys [64 tile, 64 tile + 64)) through the
// addressing; keys past last_col are zero-filled and neither they nor their
// table entries are read.  Asynchronous: commit, wait and a barrier first.
template <typename T, int D, typename Addr>
__device__ __forceinline__ void load_key_tile(T* dk, T* dv, const T* k, const T* v,
                                              const Addr& addr, int tile, int last_col) {
  constexpr int kElems = 16 / sizeof(T), kChunks = D / kElems;
  constexpr int kPer = kTile * kChunks / kThreads, L = Tr<T, D>::kLd;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kChunks, e = (c % kChunks) * kElems;
    const int col = tile * kTile + r;
    const bool valid = col <= last_col;
    const long long off = valid ? addr.offset(addr.handle(col / kBlock), col % kBlock) + e : 0;
    copy16_async(dk + r * L + e, k + off, valid);
    copy16_async(dv + r * L + e, v + off, valid);
  }
}

// One block: key tiles rank, rank + G, ... of query rows [64 qt, 64 qt + 64)
// of (b, h); the longest query tiles first.
template <typename T, int D, typename Addr>
__device__ __forceinline__ void prefill_rows(const Args<T>& a, const Addr& addr, int b, int h,
                                             int n_cols) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int G = kPrefillCluster, TE = kTileElems<T, D>, L = Tr<T, D>::kLd, ND = D / 8;
  constexpr int NB = kPrefillBufs<T, D>;
  // the merge's state of a thread (acc, then m and l of its two rows) fits
  // the two tiles past the query tile it reuses (two K buffers, or K and V)
  constexpr int kAcc = 4 * ND;
  static_assert((kAcc + 4) * kThreads * sizeof(float) <= 2 * TE * sizeof(T), "merge state");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  T* s_q = reinterpret_cast<T*>(smem);
  T* s_k = s_q + TE;                   // NB buffers each
  T* s_v = s_k + NB * TE;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = qt * kTile, wrow0 = row0 + warp * 16;
  const int len = a_len(a, b);
  const int last_col = min(len + min(row0 + kTile, a.sq) - 1, n_cols - 1);
  const int all_live = min(len + row0, n_cols - 1);   // every row attends to columns 0..all_live
  const int n_kv = last_col / kTile + 1;
  const long long stride = (long long)a.h_count * D;
  const long long base = (long long)b * a.sq * stride + (long long)h * D;
  // the position of each of this thread's two rows (wrow0 + g, + 8), and
  // the last column it attends to
  const int qpos[2] = {len + wrow0 + g, len + wrow0 + g + 8};
  const int lim[2] = {min(qpos[0], n_cols - 1), min(qpos[1], n_cols - 1)};
  const float slope2 = slope_log2(a, h);

  load_query_tile<T, D>(s_q, a.q + base, stride, row0, a.sq);
  commit_copies();
  if (rank < n_kv) load_key_tile<T, D>(s_k, s_v, a.k, a.v, addr, rank, last_col);
  commit_copies();
  wait_copies<1>();                    // this thread's part of the query tile
  __syncthreads();                     // everyone's
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[ND][4];
  zero(acc);
  for (int j = rank, it = 0; j < n_kv; j += G, ++it) {
    const int buf = NB == 2 ? it & 1 : 0;
    if (NB == 2 && j + G < n_kv) {
      load_key_tile<T, D>(s_k + (buf ^ 1) * TE, s_v + (buf ^ 1) * TE, a.k, a.v, addr, j + G,
                          last_col);
      commit_copies();
      wait_copies<1>();
    } else {
      if (NB == 1 && it > 0) {         // the barrier ending the last tile freed the buffer
        load_key_tile<T, D>(s_k, s_v, a.k, a.v, addr, j, last_col);
        commit_copies();
      }
      wait_copies<0>();
    }
    __syncthreads();
    float s[8][4];
    scores_tile<D>(s, s_q + warp * 16 * L, s_k + buf * TE);
    const bool band = j * kTile + kTile - 1 > all_live;   // some column lies past a row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = j * kTile + jj * 8 + 2 * t + (i & 1);
        const float x = band && col > lim[i >> 1]
                            ? kNegInf
                            : score_log2(s[jj][i], a.scale_log2, slope2, col, qpos[i >> 1]);
        s[jj][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2_approx(__fsub_rn(m[r], mx[r]));
      m[r] = mx[r];
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = j * kTile + jj * 8 + 2 * t + (i & 1);
        const float p =
            band && col > lim[i >> 1] ? 0.f : exp2_approx(__fsub_rn(s[jj][i], mx[i >> 1]));
        s[jj][i] = p;
        sum[i >> 1] = __fadd_rn(sum[i >> 1], p);
      }
#pragma unroll
    for (int jj = 0; jj < ND; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[jj][i] = __fmul_rn(acc[jj][i], alpha[i >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], sum[r]);   // this thread's columns
    pv_tile(acc, s, s_v + buf * TE);
    __syncthreads();                   // every warp is done with buf before it is refilled
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);

  // merge: blocks 1.. leave their state in their K buffers, block 0 reads
  // them through distributed shared memory and folds them in in rank order,
  // each rescaled to the row's max (a block with no live tile for a row
  // holds m = -1e30, l = 0, acc = 0 and adds exactly 0)
  float* st = reinterpret_cast<float*>(s_k);
  constexpr int kStride = kThreads;    // element-major: lanes write neighbouring words
  if (rank > 0) {
#pragma unroll
    for (int jj = 0; jj < ND; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[(jj * 4 + i) * kStride + threadIdx.x] = acc[jj][i];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      st[(kAcc + r) * kStride + threadIdx.x] = m[r];
      st[(kAcc + 2 + r) * kStride + threadIdx.x] = l[r];
    }
  }
  cluster.sync();
  if (rank == 0) {
    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int gg = 1; gg < G; ++gg) {
      const float* so = cluster.map_shared_rank(st, gg);
#pragma unroll
      for (int r = 0; r < 2; ++r) mt[r] = fmaxf(mt[r], so[(kAcc + r) * kStride + threadIdx.x]);
    }
    float f[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      f[r] = exp2_approx(__fsub_rn(m[r], mt[r]));
      l[r] = __fmul_rn(f[r], l[r]);
    }
#pragma unroll
    for (int jj = 0; jj < ND; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[jj][i] = __fmul_rn(f[i >> 1], acc[jj][i]);
#pragma unroll
    for (int gg = 1; gg < G; ++gg) {
      const float* so = cluster.map_shared_rank(st, gg);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        f[r] = exp2_approx(__fsub_rn(so[(kAcc + r) * kStride + threadIdx.x], mt[r]));
        l[r] = fmaf(f[r], so[(kAcc + 2 + r) * kStride + threadIdx.x], l[r]);
      }
#pragma unroll
      for (int jj = 0; jj < ND; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[jj][i] = fmaf(f[i >> 1], so[(jj * 4 + i) * kStride + threadIdx.x], acc[jj][i]);
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) inv[r] = __frcp_rn(fmaxf(l[r], 1e-30f));
    store_rows<T>(a.out + base, stride, acc, wrow0, a.sq, inv);
  }
  cluster.sync();                      // keep every block's state alive until block 0 has read it
}

// --------------------------------------------------------------------------
// kernels: grid (H, B) for decode, (H, B, query tiles) for prefill
// --------------------------------------------------------------------------

template <int D, typename T>
__device__ __forceinline__ PagedAddr<D> paged_addr(const Args<T>& a, int b, int h) {
  return PagedAddr<D>{a.tables + (long long)b * a.mb, a.hkv_count, kv_head(a, h)};
}

template <int D, typename T>
__device__ __forceinline__ DenseAddr<D> dense_addr(const Args<T>& a, int b, int h) {
  return DenseAddr<D>{(long long)b * a.t_len, a.hkv_count, kv_head(a, h)};
}

template <typename T, int D, int kRows>
__global__ void __launch_bounds__(kDecodeThreads) paged_decode_kernel(const Args<T> a) {
  const int h = blockIdx.x, b = blockIdx.y;
  decode_rows<T, D, kRows>(a, paged_addr<D>(a, b, h), b, h, a.mb * kBlock);
}

template <typename T, int D, int kRows>
__global__ void __launch_bounds__(kDecodeThreads) contiguous_decode_kernel(const Args<T> a) {
  const int h = blockIdx.x, b = blockIdx.y;
  decode_rows<T, D, kRows>(a, dense_addr<D>(a, b, h), b, h, a.t_len);
}

template <typename T, int D>
__global__ void __cluster_dims__(kPrefillCluster, 1, 1) __launch_bounds__(kThreads)
    paged_prefill_kernel(const Args<T> a) {
  const int h = blockIdx.x / kPrefillCluster, b = blockIdx.y;
  prefill_rows<T, D>(a, paged_addr<D>(a, b, h), b, h, a.mb * kBlock);
}

template <typename T, int D>
__global__ void __cluster_dims__(kPrefillCluster, 1, 1) __launch_bounds__(kThreads)
    contiguous_prefill_kernel(const Args<T> a) {
  const int h = blockIdx.x / kPrefillCluster, b = blockIdx.y;
  prefill_rows<T, D>(a, dense_addr<D>(a, b, h), b, h, a.t_len);
}

// Above the default 48 KB a kernel's dynamic shared memory must be raised
// first: once per kernel and device (the call costs host time on the
// decode step, which is host-bound).
template <auto kKernel, typename T>
cudaError_t launch_kernel(dim3 grid, int threads, size_t smem, cudaStream_t st, const Args<T>& a) {
  static thread_local int ready = -1;
  if (smem > 48 * 1024) {
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && dev != ready)
      err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    ready = dev;
  }
  kKernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
constexpr size_t kDecodeSmem = (size_t)kDecodeWarps * Lanes<T, D>::kStages * Lanes<T, D>::kStageBytes;

// One launch: the decode path for S_q <= kDecodeMaxRows, else the prefill path.
template <typename T, int D, bool kPaged>
cudaError_t launch_attention(const Args<T>& a, int b, int h, cudaStream_t st) {
  static_assert(kDecodeMaxRows == 4, "one case per decode row count");
  const dim3 grid(h, b);
  constexpr size_t ds = kDecodeSmem<T, D>, ps = kPrefillSmem<T, D>;
  constexpr int dt = kDecodeThreads;
  const dim3 prefill_grid(h * kPrefillCluster, b, cdiv(a.sq, kTile));
  switch (kPaged ? -a.sq : a.sq) {                  // one case per path, kernel and row count
    case 1: return launch_kernel<contiguous_decode_kernel<T, D, 1>>(grid, dt, ds, st, a);
    case 2: return launch_kernel<contiguous_decode_kernel<T, D, 2>>(grid, dt, ds, st, a);
    case 3: return launch_kernel<contiguous_decode_kernel<T, D, 3>>(grid, dt, ds, st, a);
    case 4: return launch_kernel<contiguous_decode_kernel<T, D, 4>>(grid, dt, ds, st, a);
    case -1: return launch_kernel<paged_decode_kernel<T, D, 1>>(grid, dt, ds, st, a);
    case -2: return launch_kernel<paged_decode_kernel<T, D, 2>>(grid, dt, ds, st, a);
    case -3: return launch_kernel<paged_decode_kernel<T, D, 3>>(grid, dt, ds, st, a);
    case -4: return launch_kernel<paged_decode_kernel<T, D, 4>>(grid, dt, ds, st, a);
    default:
      if (kPaged)
        return launch_kernel<paged_prefill_kernel<T, D>>(prefill_grid, kThreads, ps, st, a);
      return launch_kernel<contiguous_prefill_kernel<T, D>>(prefill_grid, kThreads, ps, st, a);
  }
}

template <typename T, bool kPaged>
int dispatch_dim(const Args<T>& a, int d, int b, int h, cudaStream_t st) {
  switch (d) {
    case 64: return (int)launch_attention<T, 64, kPaged>(a, b, h, st);
    case 96: return (int)launch_attention<T, 96, kPaged>(a, b, h, st);
    case 128: return (int)launch_attention<T, 128, kPaged>(a, b, h, st);
    default: return (int)launch_attention<T, 256, kPaged>(a, b, h, st);
  }
}

template <typename T, bool kPaged>
int dispatch(const void* q, const void* k, const void* v, const float* slopes, void* out,
             const int* tables, const int* lengths, int b, int sq, int h, int hkv, int d, int mb,
             int t_len, int pos, float scale, void* stream) {
  return dispatch_dim<T, kPaged>(
      Args<T>{(const T*)q, (const T*)k, (const T*)v, (T*)out, tables, lengths, slopes, sq, h, hkv,
              mb, t_len, pos, scale * kLog2e},
      d, b, h, (cudaStream_t)stream);
}

bool head_dim_ok(int d) { return d == 64 || d == 96 || d == 128 || d == 256; }

}  // namespace

// Each dtype's kernels may compile in a translation unit of their own, so
// that the two halves build in parallel: -DDST_DECODE_DTYPE=0 gives the
// float32 kernels and the entry points, -DDST_DECODE_DTYPE=1 the bfloat16
// kernels.  Without the macro this file holds both.
#if !defined(DST_DECODE_DTYPE) || DST_DECODE_DTYPE == 0
#define DST_DECODE_ENTRY 1
#define DST_DECODE_FLOAT 1
#endif
#if !defined(DST_DECODE_DTYPE) || DST_DECODE_DTYPE == 1
#define DST_DECODE_BF16 1
#endif

extern "C" {

// One dtype's dispatch: paged (block tables) or contiguous.
int dst_decode_dispatch_f32(int paged, const void* q, const void* k, const void* v,
                            const float* slopes, void* out, const int* tables,
                            const int* lengths, int b, int sq, int h, int hkv, int d, int mb,
                            int t_len, int pos, float scale, void* stream);
int dst_decode_dispatch_bf16(int paged, const void* q, const void* k, const void* v,
                             const float* slopes, void* out, const int* tables,
                             const int* lengths, int b, int sq, int h, int hkv, int d, int mb,
                             int t_len, int pos, float scale, void* stream);

#ifdef DST_DECODE_FLOAT
int dst_decode_dispatch_f32(int paged, const void* q, const void* k, const void* v,
                            const float* slopes, void* out, const int* tables,
                            const int* lengths, int b, int sq, int h, int hkv, int d, int mb,
                            int t_len, int pos, float scale, void* stream) {
  auto fn = paged ? &dispatch<float, true> : &dispatch<float, false>;
  return fn(q, k, v, slopes, out, tables, lengths, b, sq, h, hkv, d, mb, t_len, pos, scale, stream);
}
#endif

#ifdef DST_DECODE_BF16
int dst_decode_dispatch_bf16(int paged, const void* q, const void* k, const void* v,
                             const float* slopes, void* out, const int* tables,
                             const int* lengths, int b, int sq, int h, int hkv, int d, int mb,
                             int t_len, int pos, float scale, void* stream) {
  auto fn = paged ? &dispatch<bf16, true> : &dispatch<bf16, false>;
  return fn(q, k, v, slopes, out, tables, lengths, b, sq, h, hkv, d, mb, t_len, pos, scale, stream);
}
#endif

#ifdef DST_DECODE_ENTRY
// dtype: 0 = float32, 1 = bfloat16; slopes: ALiBi slopes [h] fp32, or null.
// Returns a cudaError_t (0 = launched).
int dst_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                        const int* block_tables, const int* lengths, const float* slopes,
                        void* out, int b, int sq, int h, int hkv, int d, int bs, int mb,
                        float scale, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || !head_dim_ok(d) ||
      bs != kBlock || mb <= 0 || b > 65535 || (dtype != 0 && dtype != 1) ||
      !aligned16(k_pages) || !aligned16(v_pages))
    return (int)cudaErrorInvalidValue;
  return (dtype == 0 ? dst_decode_dispatch_f32 : dst_decode_dispatch_bf16)(
      1, q, k_pages, v_pages, slopes, out, block_tables, lengths, b, sq, h, hkv, d, mb, 0, 0,
      scale, stream);
}

int dst_decode_attention(const void* q, const void* ck, const void* cv, const float* slopes,
                         void* out, int b, int sq, int h, int hkv, int d, int t_len, int pos,
                         float scale, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || !head_dim_ok(d) ||
      t_len <= 0 || pos < 0 || b > 65535 || (dtype != 0 && dtype != 1) || !aligned16(ck) ||
      !aligned16(cv))
    return (int)cudaErrorInvalidValue;
  return (dtype == 0 ? dst_decode_dispatch_f32 : dst_decode_dispatch_bf16)(
      0, q, ck, cv, slopes, out, nullptr, nullptr, b, sq, h, hkv, d, 0, t_len, pos, scale,
      stream);
}

const char* dst_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
#endif

}  // extern "C"
