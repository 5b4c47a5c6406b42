// A kernel's dynamic shared memory limit, set on each card it launches on.
//
// cudaFuncSetAttribute applies to the current device only. A limit set once
// per process (a function-local static) leaves every other card at the 48 KB
// default, where a launch that asks for more fails with cudaErrorInvalidValue.
// The Python wrappers launch under their operands' device
// (torch.cuda.device), so the current device is the launch's card.
#pragma once

#include <atomic>

#include <cuda_runtime.h>

constexpr int kMaxCards = 64;

// `set` is the call site's own flags, one a card: static storage, so they
// start false. Setting the limit twice (two threads at once) is harmless.
inline cudaError_t smem_limit_on_current_card(std::atomic<bool>* set, const void* kernel,
                                              int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) {
    return err;
  }
  if (dev < 0 || dev >= kMaxCards) {
    return cudaErrorInvalidDevice;
  }
  if (set[dev].load(std::memory_order_acquire)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) {
    set[dev].store(true, std::memory_order_release);
  }
  return err;
}
