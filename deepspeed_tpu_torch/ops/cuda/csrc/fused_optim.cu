// One-pass Adam/AdamW over many fp32 leaves in one launch, for Hopper
// (sm_90a).
//
// Replaces ops/pallas/fused_optim.py:_adam_kernel of the JAX package (one
// pallas_call per leaf).  Per element, in this order and rounding every
// operation to fp32 (no FMA contraction: __fmul_rn / __fadd_rn / __fdiv_rn
// / __fsqrt_rn), as the JAX kernel and optax do:
//     g  = (g * inv) * clip
//     mu = (1 - b1) * g + b1 * mu
//     nu = (1 - b2) * (g * g) + b2 * nu
//     u  = (mu / bc1) / (sqrt(nu / bc2) + eps)
//     u  = u + wd * p          (only when wd != 0: 0 * inf is not a no-op)
//     p  = p + neg_lr * u
// p, mu and nu are updated in place.  The scalars [inv, clip, neg_lr, bc1,
// bc2] are read from a device buffer, so the clip factor and the bias
// corrections never pass through the host.
//
// Bound: bytes.  Each element reads p, g, mu, nu and writes p, mu, nu:
// 28 bytes for ~20 flops, so the floor is 28 B x elements / 3.35 TB/s.
// What holds a simple kernel below it is the bytes it keeps in flight and
// the last, partly empty wave of blocks.
//
// Design: a persistent multi-tensor kernel.
// * The wrapper builds, once, a device table of the leaves' pointers and a
//   plan of equal chunks of kChunk elements (fused_optim.py:plan_chunks):
//   each chunk is one leaf's [start, start + count) and is either a vector
//   chunk (count a multiple of 4, the range 16-byte aligned in p, g, mu
//   and nu) or a scalar chunk (a leaf's last n % 4 elements, or a leaf
//   whose four base pointers are not all 16-byte aligned, as a gradient
//   view into a flat buffer behind a leaf of odd size is).
// * The grid is the number of blocks the card holds at once (SMs x blocks
//   per SM by the occupancy query, made once per table); block i takes
//   chunks i, i + grid, ..., so every block runs until the plan is done and
//   no partial last wave is left.  The next chunk's entry is read before
//   the current chunk is worked.
// * A vector chunk: each thread issues kVec float4 loads of each of p, g,
//   mu and nu (256 bytes) before any arithmetic, then stores p, mu and nu
//   as float4.  A scalar chunk: each thread takes kChunk / kThreads
//   elements, four at a time (loads first), with the same per-element
//   arithmetic.
// The parameters are updated in place, so the table stays valid for the
// life of the optimizer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                                   // float4s per thread per tensor
constexpr int kChunk = kThreads * kVec * 4;               // elements per chunk: 4096
constexpr int kScalarPer = kChunk / kThreads;             // elements per thread, scalar chunk
constexpr int kMinBlocks = 2;                             // per SM, for __launch_bounds__

struct Hyper {
  float b1, b2, one_minus_b1, one_minus_b2, eps, wd;
  int has_wd;
};

// The update of one element: returns the new p and writes the new moments.
__device__ __forceinline__ float adam_update(float pi, float g, float& mu, float& nu,
                                             const Hyper& h, float inv, float clip, float neg_lr,
                                             float bc1, float bc2) {
  const float gi = __fmul_rn(__fmul_rn(g, inv), clip);
  const float m = __fadd_rn(__fmul_rn(h.one_minus_b1, gi), __fmul_rn(h.b1, mu));
  const float v =
      __fadd_rn(__fmul_rn(h.one_minus_b2, __fmul_rn(gi, gi)), __fmul_rn(h.b2, nu));
  float u = __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), h.eps));
  if (h.has_wd) u = __fadd_rn(u, __fmul_rn(h.wd, pi));
  mu = m;
  nu = v;
  return __fadd_rn(pi, __fmul_rn(neg_lr, u));
}

// chunks: int32 [n_chunks][4] = leaf, vector (1) or scalar (0), count, start
__global__ void __launch_bounds__(kThreads, kMinBlocks)
adam_kernel(const int64_t* __restrict__ table, int n_leaves, const int4* __restrict__ chunks,
            int n_chunks, const float* __restrict__ scal, Hyper h) {
  const float inv = scal[0], clip = scal[1], neg_lr = scal[2], bc1 = scal[3], bc2 = scal[4];
  int c = blockIdx.x;
  int4 next = c < n_chunks ? chunks[c] : make_int4(0, 0, 0, 0);
  for (; c < n_chunks; c += gridDim.x) {
    const int4 ch = next;
    if (c + (int)gridDim.x < n_chunks) next = chunks[c + gridDim.x];
    const int leaf = ch.x, count = ch.z;
    const int64_t start = ch.w;
    float* __restrict__ p = reinterpret_cast<float*>(table[leaf]) + start;
    const float* __restrict__ g = reinterpret_cast<const float*>(table[n_leaves + leaf]) + start;
    float* __restrict__ mu = reinterpret_cast<float*>(table[2 * n_leaves + leaf]) + start;
    float* __restrict__ nu = reinterpret_cast<float*>(table[3 * n_leaves + leaf]) + start;
    if (ch.y) {
      const int n4 = count >> 2;
      float4 P[kVec], G[kVec], M[kVec], V[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int i = threadIdx.x + k * kThreads;
        if (i < n4) {
          P[k] = reinterpret_cast<const float4*>(p)[i];
          G[k] = reinterpret_cast<const float4*>(g)[i];
          M[k] = reinterpret_cast<const float4*>(mu)[i];
          V[k] = reinterpret_cast<const float4*>(nu)[i];
        }
      }
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int i = threadIdx.x + k * kThreads;
        if (i < n4) {
          P[k].x = adam_update(P[k].x, G[k].x, M[k].x, V[k].x, h, inv, clip, neg_lr, bc1, bc2);
          P[k].y = adam_update(P[k].y, G[k].y, M[k].y, V[k].y, h, inv, clip, neg_lr, bc1, bc2);
          P[k].z = adam_update(P[k].z, G[k].z, M[k].z, V[k].z, h, inv, clip, neg_lr, bc1, bc2);
          P[k].w = adam_update(P[k].w, G[k].w, M[k].w, V[k].w, h, inv, clip, neg_lr, bc1, bc2);
          reinterpret_cast<float4*>(p)[i] = P[k];
          reinterpret_cast<float4*>(mu)[i] = M[k];
          reinterpret_cast<float4*>(nu)[i] = V[k];
        }
      }
    } else {
#pragma unroll 1
      for (int k0 = 0; k0 < kScalarPer; k0 += 4) {   // four elements of each tensor in flight
        float P[4], G[4], M[4], V[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = threadIdx.x + (k0 + k) * kThreads;
          if (i < count) {
            P[k] = p[i];
            G[k] = g[i];
            M[k] = mu[i];
            V[k] = nu[i];
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = threadIdx.x + (k0 + k) * kThreads;
          if (i < count) {
            p[i] = adam_update(P[k], G[k], M[k], V[k], h, inv, clip, neg_lr, bc1, bc2);
            mu[i] = M[k];
            nu[i] = V[k];
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// table: int64 [4][n_leaves] = p, g, mu, nu pointers; chunks: int32
// [n_chunks][4] (leaf, vector, count, start) of the wrapper's plan; grid:
// the blocks to launch (dst_fused_adam_grid); scal: fp32 [inv, clip,
// neg_lr, bc1, bc2] on the device.  Returns a cudaError_t (0 = launched).
int dst_fused_adam(const int64_t* table, int n_leaves, const int* chunks, int n_chunks,
                   int grid, const float* scal, float b1, float b2, float one_minus_b1,
                   float one_minus_b2, float eps, float wd, int has_wd, void* stream) {
  if (n_leaves <= 0 || n_chunks <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  const Hyper h = {b1, b2, one_minus_b1, one_minus_b2, eps, wd, has_wd};
  adam_kernel<<<grid < n_chunks ? grid : n_chunks, kThreads, 0, (cudaStream_t)stream>>>(
      table, n_leaves, reinterpret_cast<const int4*>(chunks), n_chunks, scal, h);
  return (int)cudaGetLastError();
}

// Elements per chunk of the plan.
int dst_fused_adam_chunk() { return kChunk; }

// Blocks the current device holds at once: SMs x blocks per SM (occupancy
// query); 0 on an error.
int dst_fused_adam_grid() {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adam_kernel, kThreads, 0) !=
          cudaSuccess)
    return 0;
  return sms * per_sm;
}

}  // extern "C"
