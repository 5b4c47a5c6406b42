// The card's mma.sync rate, for the attention kernels' bounds: each warp runs
// eight independent accumulator chains of one mma shape on constant
// registers, no memory traffic, so the time is the tensor cores' alone.
// chip_smoke.py times it beside the attention kernels (TF32 m16n8k8 is the
// forward's product, bf16 m16n8k16 the backward's); not on any serving or
// training path.
//
// Also an empty kernel: its time, through the same ctypes path as the forest
// kernel, is the floor under any launch's time on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 8;

template <bool kTf32>
__global__ void __launch_bounds__(128) mma_rate_kernel(float* out, int iters) {
  float c[kChains][4] = {};
  const uint32_t a0 = 0x3f800000u + threadIdx.x, a1 = 0x3f000000u, a2 = 0x3e800000u;
  const uint32_t a3 = 0x3f400000u, b0 = 0x3f800000u ^ (threadIdx.x << 13), b1 = 0x3c000000u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      if (kTf32) {
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kChains; ++j) {
    s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;  // keeps the chains alive
}

__global__ void empty_kernel() {}

}  // namespace

// Launches `blocks` blocks of 128 threads, each warp doing iters * 8 mma.sync
// of TF32 m16n8k8 (tf32 != 0) or bf16 m16n8k16; out holds blocks * 128
// floats. Returns cudaGetLastError().
extern "C" int mma_rate_launch(int tf32, int blocks, int iters, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tf32) {
    mma_rate_kernel<true><<<blocks, 128, 0, st>>>(static_cast<float*>(out), iters);
  } else {
    mma_rate_kernel<false><<<blocks, 128, 0, st>>>(static_cast<float*>(out), iters);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches one block of 32 threads that does nothing. Returns
// cudaGetLastError().
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
