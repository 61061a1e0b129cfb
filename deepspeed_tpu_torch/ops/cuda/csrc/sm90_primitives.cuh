// Device primitives shared by the package's Hopper (sm_90a) kernels:
// asynchronous 16- and 4-byte copies into shared memory, ldmatrix fragment
// loads, the bf16 mma.sync m16n8k16 product (fp32 accumulate), wgmma's
// swizzled-tile descriptor, fence, commit and wait, the one-instruction
// base-2 exponential, row-group (quad) max and sum, transaction barriers
// (mbarrier), tensor-map (TMA) tile loads, and for thread-block clusters
// the split cluster barrier, peer addresses and bulk copies (from global
// memory, or into a peer's shared memory).
//
// mma.m16n8k16 register layouts, with g = lane / 4 and t = lane % 4:
// * accumulator c[4]: rows g (c[0], c[1]) and g + 8 (c[2], c[3]), columns
//   2t and 2t + 1 of the 8-column slice;
// * A (16 x 16, row major) a0..a3: (rows g | g + 8) x (k 2t, 2t + 1 | +8),
//   as a0 = (g, 0-7), a1 = (g + 8, 0-7), a2 = (g, 8-15), a3 = (g + 8, 8-15);
// * B (16 x 8, "col": stored n-major) b0 = k 2t, 2t + 1, b1 = k + 8, at n = g.
// So an accumulator tile of two neighbouring 8-column slices, rounded to
// bf16 and packed in pairs, is the A operand of the next product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// 16 bytes global -> shared without a register round trip; an invalid
// source fills zeros (and reads nothing).
__device__ __forceinline__ void copy16_async(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N of this thread's committed groups are in flight (a
// barrier then publishes the landed copies to the other threads).
template <int N> __device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8; thread (g, t) receives r[i] = matrix i's row g,
// columns 2t and 2t + 1 (.trans: column g, rows 2t and 2t + 1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Two 8x8 matrices (lanes 0-15 give the row addresses), as ldsm_x4.trans.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// 4 bytes global -> shared, asynchronously (zeros for an invalid source).
__device__ __forceinline__ void copy4_async(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// The two halves of a thread-block cluster barrier: arrive releases this
// thread's prior writes (distributed shared memory included), wait returns
// once every thread of the cluster has arrived and acquires their writes.
// Work placed between the two overlaps the barrier's latency.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---- bulk copies with transaction barriers ----
// A block waits for data copied into its shared memory (from global memory,
// or from a cluster peer's shared memory) on an mbarrier there: each bulk
// copy counts its bytes off the barrier's current phase, which completes
// once the local arrive (with the phase's expected byte count) and all the
// bytes are in.  No cluster-wide barrier or release fence is needed per
// exchange.  A phase that expects 0 bytes completes at its arrive, so a
// barrier's next phase may open only once every thread is past its wait
// on the current one (a parity wait cannot tell phases two apart).

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address in the cluster's shared window of `addr` in block `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Make initialised barriers visible to the cluster (then a cluster barrier).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// This block's one arrival on the phase, expecting `bytes` from st.async.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Wait for the phase of parity `parity` to complete.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One arrival on the barrier's current phase (no bytes expected).
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// A 2-D tile of the tensor map `map` (a __grid_constant__ kernel parameter)
// at element coordinates (c0 innermost, c1) into this block's shared memory
// at `dst`, by the tensor memory accelerator, counting its bytes off `bar`.
// Elements past the map's edges arrive as zeros (and are counted).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) of this
// block's shared memory at `src` to a peer's at `dst` (a cluster address
// from map_rank) by the bulk-copy engine, counting off the peer's barrier
// `bar`.  The block's writes to src must be fenced for the async proxy
// (proxy_fence, then a barrier) before one thread issues the copy.
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, uint32_t src, uint32_t bytes,
                                             uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}
// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global memory at `src` into this block's shared memory at `dst` by the
// bulk-copy engine, counting off this block's barrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
// Orders this thread's generic shared-memory accesses before later bulk
// copies (async proxy) that read or overwrite the same memory.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- warpgroup MMA (wgmma) ----

// A shared-memory matrix descriptor of wgmma for a tile of 128-byte rows
// with the 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8),
// the tile 1024-byte aligned): 8-row groups 1024 bytes apart.  As a
// K-major operand a k step of 16 bf16 advances the start by 32 bytes (+2);
// as an MN-major one (the transpose bit set) by 16 rows, 2048 bytes (+128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed product groups are in
// flight.
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  return pack_raw(__float2bfloat16(lo), __float2bfloat16(hi));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 2^x in one instruction (relative error ~2^-22; results below 2^-126 flush
// to 0; 2^-inf = 0 and 2^0 = 1 exactly).  A kernel that keeps its scores in
// log2 units (scaled by log2(e)) computes exp(s - m) as exp2_approx(s' - m').
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Max and sum over the four threads of an mma row group (lanes 4 g .. 4 g
// + 3 hold one row's columns in the accumulator layout).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace
