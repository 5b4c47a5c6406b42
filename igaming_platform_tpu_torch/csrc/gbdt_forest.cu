// Fused oblivious-forest inference for Hopper (sm_90a).
//
// Replaces the TPU kernel igaming_platform_tpu/ops/pallas/gbdt_kernel.py::_kernel
// (launched by _run, wrapped by gbdt_raw_pallas). Same function: for each row b,
//     leaf[b, t] = sum_d (x[b, feat[t, d]] > thr[t, d]) << d
//     out[b]     = sum_t leaves[t, leaf[b, t]] + bias
// i.e. raw margins, exactly what models/gbdt.py::gbdt_raw computes.
//
// The TPU kernel gathers the split features with a one-hot [F, T*D] matrix
// product, because a cross-lane gather serialises on the TPU's vector unit
// while its matrix unit sits idle. Here that product would be pure waste, and
// in TF32 it would round the gathered value and flip splits near a threshold.
// This kernel reads x[b, feat[t, d]] directly from shared memory, so every
// compare sees the exact float32 feature, with the same `>` as gbdt.py.
//
// What bounds it: bytes. Per call it must read B*F*4 bytes of features and the
// forest (T*D*8 + T*2^D*4 + 4 bytes, about 6 KB at T=64, D=4) and write B*4
// bytes. At B=4096, F=30 that is about 0.51 MB, about 0.15 us at 3.35 TB/s;
// the arithmetic (B*T*D compares) is smaller still. So one launch costs its
// launch latency, a few microseconds, far above the bound. The design keeps
// it to ONE launch that allocates nothing and does not synchronise: the whole
// forest and the rows' feature slab are staged in shared memory once per
// block, and nothing goes back to device memory but the [B] margins.
//
// Layout: a block of 256 threads (8 warps) takes 32 rows. It stages feat, thr
// and leaves, and its [rows, F] slab of x with coalesced loads. Each warp then
// takes one row at a time; lane l sums the trees l, l+32, ... in float32, and a
// butterfly of warp shuffles adds the 32 partial sums. The last block masks the
// ragged edge itself, so any B >= 1 works.
//
// Limits, checked by the launcher and by the Python wrapper: 1 <= D <= 8, and
// the forest plus one block's slab of rows fit in 48 KB of shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 32;
constexpr int kMaxDepth = 8;
constexpr size_t kMaxSharedBytes = 48 * 1024;

size_t shared_bytes(int F, int T, int D) {
  return static_cast<size_t>(T) * D * (sizeof(int) + sizeof(float)) +
         static_cast<size_t>(T) * (1u << D) * sizeof(float) +
         static_cast<size_t>(kRowsPerBlock) * F * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
gbdt_forest_kernel(const float* __restrict__ x, const int* __restrict__ feat,
                   const float* __restrict__ thr, const float* __restrict__ leaves,
                   const float* __restrict__ bias, float* __restrict__ out, int B, int F,
                   int T, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int td = T * D;
  const int n_leaves = 1 << D;
  int* s_feat = reinterpret_cast<int*>(smem);
  float* s_thr = reinterpret_cast<float*>(s_feat + td);
  float* s_leaves = s_thr + td;
  float* s_x = s_leaves + T * n_leaves;

  const int row0 = blockIdx.x * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, B - row0);

  for (int i = threadIdx.x; i < td; i += blockDim.x) {
    // Clamped so that a bad feature id can never read outside its row; the
    // Python side rejects such a forest before it reaches the card.
    s_feat[i] = min(max(feat[i], 0), F - 1);
    s_thr[i] = thr[i];
  }
  for (int i = threadIdx.x; i < T * n_leaves; i += blockDim.x) {
    s_leaves[i] = leaves[i];
  }
  // The block's rows are one contiguous run of rows*F floats.
  const float* xb = x + static_cast<size_t>(row0) * F;
  for (int i = threadIdx.x; i < rows * F; i += blockDim.x) {
    s_x[i] = xb[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const float b0 = *bias;
  for (int r = warp; r < rows; r += n_warps) {
    const float* xr = s_x + r * F;
    float acc = 0.0f;
    for (int t = lane; t < T; t += 32) {
      const int* ft = s_feat + t * D;
      const float* tt = s_thr + t * D;
      int leaf = 0;
      for (int d = 0; d < D; ++d) {
        leaf |= static_cast<int>(xr[ft[d]] > tt[d]) << d;
      }
      acc += s_leaves[t * n_leaves + leaf];
    }
    for (int offset = 16; offset > 0; offset >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, offset);
    }
    if (lane == 0) {
      out[row0 + r] = acc + b0;
    }
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(): 0 when the
// launch was accepted. All pointers are device pointers: x [B, F] float32,
// feat [T, D] int32, thr [T, D] float32, leaves [T, 2^D] float32, bias [1]
// float32, out [B] float32, all contiguous. Allocates nothing, does not sync.
extern "C" int gbdt_forest_launch(const void* x, const void* feat, const void* thr,
                                  const void* leaves, const void* bias, void* out, int B,
                                  int F, int T, int D, void* stream) {
  if (B <= 0 || F <= 0 || T <= 0 || D < 1 || D > kMaxDepth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = shared_bytes(F, T, D);
  if (smem > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  gbdt_forest_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(feat),
      static_cast<const float*>(thr), static_cast<const float*>(leaves),
      static_cast<const float*>(bias), static_cast<float*>(out), B, F, T, D);
  return static_cast<int>(cudaGetLastError());
}
