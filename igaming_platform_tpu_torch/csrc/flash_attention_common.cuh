// Pieces both flash-attention sources share: the cp.async primitives and the
// choice of narrow (16-row) blocks. Included by flash_attention_fwd.cu and
// flash_attention_bwd.cu; ops/_build.py hashes it with each of them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one committed group of this thread is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Waits until every committed group of this thread has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 64 rows a block, or 16 when 64-row blocks would leave SMs idle.
bool narrow_blocks(int BH, int S) {
  static const int n_sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      n = 132;
    }
    return n;
  }();
  return static_cast<long long>(BH) * ((S + 63) / 64) < n_sms;
}

}  // namespace
