// What one mma.sync does to its float32 accumulator, for the CPU emulations
// of the attention kernels' arithmetic: each warp takes one case, loads the
// A, B and C tiles given in memory into the fragment layouts of the PTX ISA,
// runs one mma.sync, and writes D back. The tests model the tensor core's
// k-step sum from these outputs; chip_smoke.py holds that model against them
// on the card. Not on any serving or training path.
//
// Shapes per case: A [16, K] row-major, B [K, 8] row-major, C and D [16, 8];
// K = 8 for TF32 m16n8k8, 16 for bf16 m16n8k16. A and B are given as float32
// holding values the operand type represents exactly (TF32: the low 13 bits
// zero; bf16: the low 16 bits zero), so no conversion rounds them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

template <bool kTf32>
__global__ void __launch_bounds__(32) mma_probe_kernel(const float* a, const float* b,
                                                       const float* c, float* d) {
  constexpr int K = kTf32 ? 8 : 16;
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  a += size_t(blockIdx.x) * 16 * K;
  b += size_t(blockIdx.x) * K * 8;
  c += size_t(blockIdx.x) * 16 * 8;
  d += size_t(blockIdx.x) * 16 * 8;
  // Accumulator: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
  float acc[4] = {c[g * 8 + 2 * t], c[g * 8 + 2 * t + 1], c[(g + 8) * 8 + 2 * t],
                  c[(g + 8) * 8 + 2 * t + 1]};
  if (kTf32) {
    // A: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
    // B: b0 (k = t, n = g), b1 (k = t + 4, n = g).
    const uint32_t a0 = __float_as_uint(a[g * K + t]), a1 = __float_as_uint(a[(g + 8) * K + t]);
    const uint32_t a2 = __float_as_uint(a[g * K + t + 4]);
    const uint32_t a3 = __float_as_uint(a[(g + 8) * K + t + 4]);
    const uint32_t b0 = __float_as_uint(b[t * 8 + g]), b1 = __float_as_uint(b[(t + 4) * 8 + g]);
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  } else {
    // A: a0 (g, 2t..2t+1), a1 (g + 8, 2t..2t+1), a2 (g, 2t+8..2t+9),
    // a3 (g + 8, 2t+8..2t+9); B: b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8..2t+9).
    const uint32_t a0 = bf16x2(a[g * K + 2 * t], a[g * K + 2 * t + 1]);
    const uint32_t a1 = bf16x2(a[(g + 8) * K + 2 * t], a[(g + 8) * K + 2 * t + 1]);
    const uint32_t a2 = bf16x2(a[g * K + 2 * t + 8], a[g * K + 2 * t + 9]);
    const uint32_t a3 = bf16x2(a[(g + 8) * K + 2 * t + 8], a[(g + 8) * K + 2 * t + 9]);
    const uint32_t b0 = bf16x2(b[(2 * t) * 8 + g], b[(2 * t + 1) * 8 + g]);
    const uint32_t b1 = bf16x2(b[(2 * t + 8) * 8 + g], b[(2 * t + 9) * 8 + g]);
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  d[g * 8 + 2 * t] = acc[0];
  d[g * 8 + 2 * t + 1] = acc[1];
  d[(g + 8) * 8 + 2 * t] = acc[2];
  d[(g + 8) * 8 + 2 * t + 1] = acc[3];
}

}  // namespace

// Runs n cases, one warp each: TF32 m16n8k8 (tf32 != 0) or bf16 m16n8k16.
// a holds n * 16 * K floats, b n * K * 8, c and d n * 16 * 8. Returns
// cudaGetLastError().
extern "C" int mma_probe_launch(int tf32, int n, const void* a, const void* b, const void* c,
                                void* d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fa = static_cast<const float*>(a), *fb = static_cast<const float*>(b);
  const float* fc = static_cast<const float*>(c);
  float* fd = static_cast<float*>(d);
  if (tf32) {
    mma_probe_kernel<true><<<n, 32, 0, st>>>(fa, fb, fc, fd);
  } else {
    mma_probe_kernel<false><<<n, 32, 0, st>>>(fa, fb, fc, fd);
  }
  return static_cast<int>(cudaGetLastError());
}
