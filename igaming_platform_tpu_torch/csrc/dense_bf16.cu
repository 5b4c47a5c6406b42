// The MLP layers' dense product for Hopper (sm_90a), with a sum order that no
// batch size can change.
//
// Not a TPU kernel: the JAX package leaves this product to XLA
// (igaming_platform_tpu/models/mlp.py:64-74, _dense). It computes
//     out[b, n] = sum_k bf16(x[b, k]) * w[k, n] + bias[n]
// in float32, where w already holds bf16-rounded values (models/mlp.py's
// Dense keeps them so). Every product of two bf16 values is exact in
// float32 (8 + 8 significant bits), so a result is fixed by the order of its
// additions alone. cuBLAS's float32 GEMM picks its kernel, and with it that
// order, by M: the same row summed differently inside a 256-row and a
// 4096-row batch. Here the order is one function of nothing but k:
//
// - 8 partial sums interleave: partial p adds the products of k = p, p + 8,
//   p + 16, ... in ascending k, from +0.0f, one fmaf each (an fma of an
//   exact product rounds as the product's add would);
// - the partials fold in a fixed tree, ((p0 + p1) + (p2 + p3)) +
//   ((p4 + p5) + (p6 + p7)), then the bias is added.
//
// ops/dense.py::dense_plain adds in the same order with torch ops, so the two
// agree bit for bit (on the card and against the CPU) wherever no product
// underflows below float32's normal range. Zero padding past K adds +0 or -0
// to a partial that is never -0, which leaves it as it was.
//
// What bounds it on an H100: at the serving shapes (B = 4096, K and N up to
// 256) the 2*B*K*N float32 operations at 67 TFLOP/s, about 8 us at
// 256 -> 256, over its bytes (about 2.5 us). Design, simple first: a block of
// 256 threads takes a 32-row by 64-column tile of the output and walks K in
// tiles of 32: x (rounded to bf16 as it is stored) and w are staged in shared
// memory, and each thread keeps 2 rows x 4 columns x 8 partials in registers.
// CUDA-core FMAs, no tensor cores: the card's mma.sync sum is not IEEE
// (ops/tensor_core_model.py) and would lose the equality with dense_plain.
// One launch a call, no allocation, no sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPartials = 8;  // ops/dense.py PARTIALS
constexpr int kBM = 32;       // rows a block
constexpr int kBN = 64;       // columns a block
constexpr int kBK = 32;       // k a stage: a multiple of kPartials
constexpr int kTM = 2;        // rows a thread
constexpr int kTN = 4;        // columns a thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);
constexpr int kXStride = kBM + 2;  // even (8-byte aligned pairs), two-way bank conflicts on store

static_assert(kBK % kPartials == 0, "a stage must hold whole cycles of the partials");
static_assert(kThreads == 256, "the tile mapping assumes 256 threads");

__global__ void __launch_bounds__(kThreads)
dense_bf16_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ out, int B, int K, int N) {
  __shared__ __align__(16) float xs[kBK][kXStride];  // [k][row], bf16-rounded
  __shared__ __align__(16) float ws[kBK][kBN];       // [k][column]
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const int col0 = blockIdx.y * kBN;

  float acc[kPartials][kTM][kTN];
#pragma unroll
  for (int p = 0; p < kPartials; ++p)
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[p][i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // Consecutive threads read consecutive k of a row: coalesced on x.
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;
      const long long gr = row0 + r;
      const int gk = k0 + kk;
      const float v = (gr < B && gk < K) ? x[gr * K + gk] : 0.0f;
      xs[kk][r] = __bfloat162float(__float2bfloat16_rn(v));
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, c = i % kBN;
      const int gk = k0 + kk, gc = col0 + c;
      ws[kk][c] = (gk < K && gc < N) ? w[static_cast<long long>(gk) * N + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += kPartials) {
#pragma unroll
      for (int p = 0; p < kPartials; ++p) {
        const float2 xv = *reinterpret_cast<const float2*>(&xs[kk + p][ty * kTM]);
        const float4 wv = *reinterpret_cast<const float4*>(&ws[kk + p][tx * kTN]);
        const float xa[kTM] = {xv.x, xv.y};
        const float wa[kTN] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[p][i][j] = fmaf(xa[i], wa[j], acc[p][i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long r = row0 + ty * kTM + i;
    if (r >= B) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tx * kTN + j;
      if (c >= N) continue;
      const float s01 = __fadd_rn(acc[0][i][j], acc[1][i][j]);
      const float s23 = __fadd_rn(acc[2][i][j], acc[3][i][j]);
      const float s45 = __fadd_rn(acc[4][i][j], acc[5][i][j]);
      const float s67 = __fadd_rn(acc[6][i][j], acc[7][i][j]);
      const float s = __fadd_rn(__fadd_rn(s01, s23), __fadd_rn(s45, s67));
      out[r * N + c] = __fadd_rn(s, bias[c]);
    }
  }
}

}  // namespace

// x [B, K], w [K, N], bias [N], out [B, N]: contiguous float32 on the card.
// Launches on `stream`; returns the CUDA error of the launch (0 on success).
// Allocates nothing, does not sync.
extern "C" int dense_bf16_launch(const void* x, const void* w, const void* bias, void* out,
                                 int B, int K, int N, void* stream) {
  if (B <= 0 || K <= 0 || N <= 0 || (N + kBN - 1) / kBN > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((B + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  dense_bf16_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), B, K, N);
  return static_cast<int>(cudaGetLastError());
}
