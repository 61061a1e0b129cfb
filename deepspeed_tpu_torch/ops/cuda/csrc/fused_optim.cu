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
//
// Design: a multi-tensor kernel.  The wrapper builds, once, a device table
// of the leaves' pointers and sizes and a list of chunks (leaf, start); one
// block takes one chunk of up to kChunk elements, with consecutive threads
// on consecutive elements (coalesced).  The parameters are updated in
// place, so the table stays valid for the life of the optimizer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunk = 32768;   // elements per block; the wrapper cuts chunks to this

__global__ void __launch_bounds__(kThreads)
adam_kernel(const int64_t* __restrict__ table, int n_leaves, const int* __restrict__ chunk_leaf,
            const int64_t* __restrict__ chunk_start, const float* __restrict__ scal, float b1,
            float b2, float one_minus_b1, float one_minus_b2, float eps, float wd, int has_wd) {
  const int leaf = chunk_leaf[blockIdx.x];
  float* __restrict__ p = reinterpret_cast<float*>(table[leaf]);
  const float* __restrict__ g = reinterpret_cast<const float*>(table[n_leaves + leaf]);
  float* __restrict__ mu = reinterpret_cast<float*>(table[2 * n_leaves + leaf]);
  float* __restrict__ nu = reinterpret_cast<float*>(table[3 * n_leaves + leaf]);
  const int64_t size = table[4 * n_leaves + leaf];
  const int64_t start = chunk_start[blockIdx.x];
  const int64_t end = min(start + kChunk, size);
  const float inv = scal[0], clip = scal[1], neg_lr = scal[2], bc1 = scal[3], bc2 = scal[4];
  for (int64_t i = start + threadIdx.x; i < end; i += kThreads) {
    const float gi = __fmul_rn(__fmul_rn(g[i], inv), clip);
    const float m = __fadd_rn(__fmul_rn(one_minus_b1, gi), __fmul_rn(b1, mu[i]));
    const float v = __fadd_rn(__fmul_rn(one_minus_b2, __fmul_rn(gi, gi)), __fmul_rn(b2, nu[i]));
    const float pi = p[i];
    float u = __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), eps));
    if (has_wd) u = __fadd_rn(u, __fmul_rn(wd, pi));
    p[i] = __fadd_rn(pi, __fmul_rn(neg_lr, u));
    mu[i] = m;
    nu[i] = v;
  }
}

}  // namespace

extern "C" {

// table: int64 [5][n_leaves] = p, g, mu, nu pointers and sizes (elements);
// chunk_leaf / chunk_start: one entry per chunk of at most 32768 elements;
// scal: fp32 [inv, clip, neg_lr, bc1, bc2] on the device.  Returns a
// cudaError_t (0 = launched).
int dst_fused_adam(const int64_t* table, int n_leaves, const int* chunk_leaf,
                   const int64_t* chunk_start, int n_chunks, const float* scal, float b1,
                   float b2, float one_minus_b1, float one_minus_b2, float eps, float wd,
                   int has_wd, void* stream) {
  if (n_leaves <= 0 || n_chunks <= 0 || n_chunks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  adam_kernel<<<n_chunks, kThreads, 0, (cudaStream_t)stream>>>(
      table, n_leaves, chunk_leaf, chunk_start, scal, b1, b2, one_minus_b1, one_minus_b2, eps, wd,
      has_wd);
  return (int)cudaGetLastError();
}

int dst_fused_adam_chunk() { return (int)kChunk; }

}  // extern "C"
