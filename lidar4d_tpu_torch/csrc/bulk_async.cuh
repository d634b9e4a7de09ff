// Hopper's bulk asynchronous copies (the non-tensor TMA path) between
// global and shared memory, shared by the kernels that stage a table in
// shared memory (hash_grid_fwd.cu, plane_bilinear_vjp.cu) or flush a shared
// accumulator with bulk reductions (plane_bilinear_bwd.cu,
// plane_bilinear_vjp.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Orders this thread's generic-proxy writes to shared memory before later
// bulk operations (async proxy) that read it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A staging: bulk copies counted on an mbarrier in shared memory that one
// thread initialises for one arrival, arms with the bytes to come and
// starts the copies on; every thread then waits for the phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// dst (shared) = src (global), `bytes` a multiple of 16, both 16-byte aligned.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// dst[0:n] += src[0:n] (float32) for a global `dst` and a shared `src` whose
// addresses agree modulo 16 bytes, by the 32 lanes of one warp: the aligned
// middle as one bulk reduction issued by lane 0, the ragged head and tail
// (< 4 floats each) by atomics. Lane 0 waits until the bulk operation has
// read its source.
__device__ __forceinline__ void reduce_row(float* dst, const float* src, int n, int lane) {
  const int head = min((int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / 4, n);
  const int mid = (n - head) & ~3;
  if (lane < head) atomicAdd(dst + lane, src[lane]);
  const int t = head + mid + lane - 4;
  if (lane >= 4 && lane < 8 && t < n) atomicAdd(dst + t, src[t]);
  if (lane == 0 && mid > 0) {
    asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
                 ::"l"(dst + head), "r"(smem_addr(src + head)), "r"((uint32_t)mid * 4u)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

}  // namespace
