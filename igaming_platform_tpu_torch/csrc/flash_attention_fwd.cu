// Flash-attention forward for Hopper (sm_90a), float32 on the CUDA cores.
//
// Replaces both forward TPU kernels of
// igaming_platform_tpu/ops/pallas/flash_attention.py: _kernel_resident (launched
// by _run_resident, S <= 4096, the whole K/V of a head resident in VMEM) and
// _kernel_tiled (launched by _run_tiled, S > 4096, m/l/acc carried in scratch
// across a sequential kv grid axis). Same function for every (b*h, row):
//     s_j = (q . k_j) * scale,  scale = 1/sqrt(Dh) applied as a multiply
//     m   = max_j s_j,  l = sum_j exp(s_j - m),  acc = sum_j exp(s_j - m) v_j
//     o   = acc / l,    lse = m + log(l)
// computed as a running (online) softmax over key tiles, all in float32 with
// expf/logf (no fast-math intrinsics, no TF32): the bar is the JAX tests'
// rtol/atol 2e-5 against the dense einsum.
//
// The TPU needed two kernels because a resident K/V of more than 4096 rows
// overflowed its 16 MB scoped VMEM. Here one kernel covers every S: a block
// stages 32-key tiles of K and V in shared memory and loops over them, so its
// memory does not grow with S. Keys past S are masked to -inf inside the
// kernel and rows past S are not written, so S need not be a multiple of any
// block (the JAX package takes its dense einsum for such S: the same function).
//
// What bounds it: operations. Per (b*h) it does 2*S*S*Dh multiply-adds (QK^T
// and PV), 4*BH*S^2*Dh floating-point operations, against 4*BH*S*Dh*4 bytes of
// q, k, v and o. At S=2048, Dh=64 that is 17 GFLOP, about 0.26 ms at the
// card's 67 TFLOP/s float32 rate, while its 8 MB move in 2.5 us. At the abuse
// detector's S=64 both bounds are far below the launch latency.
//
// Layout. A block of 128 threads takes one (b*h) and kRows query rows. Each
// query row belongs to kTpr adjacent threads (1 for Dh <= 32, Dh/32 above),
// and each of those holds Dh/kTpr elements of q and of the accumulator in
// registers, as float4s interleaved over the row's threads so that their
// shared-memory reads fall in different banks. A row's dot product is summed
// over its threads with warp shuffles. Per tile: stage K and V (coalesced
// float4 loads, zero past S), the 32 scores of each row into registers, one
// rescale of m, l and acc, then the weighted sum of V.
//
// A simple kernel that is right: no tensor cores (their TF32 would not meet
// 2e-5), no TMA or double-buffered staging. Making it fast is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileK = 32;

template <int Dh>
struct Layout {
  static constexpr int kTpr = Dh > 32 ? Dh / 32 : 1;  // threads per query row
  static constexpr int kVec = Dh / 4;                 // float4s per row of q, k, v
  static constexpr int kVpt = kVec / kTpr;            // float4s each thread holds
  static constexpr int kRows = kThreads / kTpr;       // query rows per block
  static_assert(Dh % 4 == 0 && kVec % kTpr == 0 && 32 % kTpr == 0, "bad head size");
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int Dh>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int S, float scale) {
  using L = Layout<Dh>;
  __shared__ float4 ks[kTileK * L::kVec];
  __shared__ float4 vs[kTileK * L::kVec];

  const int bh = blockIdx.x;
  const int sub = threadIdx.x % L::kTpr;  // this thread's share of its row
  const int row = blockIdx.y * L::kRows + threadIdx.x / L::kTpr;
  const bool live = row < S;
  const size_t head = static_cast<size_t>(bh) * S * L::kVec;  // in float4s
  const float4* q4 = reinterpret_cast<const float4*>(q) + head;
  const float4* k4 = reinterpret_cast<const float4*>(k) + head;
  const float4* v4 = reinterpret_cast<const float4*>(v) + head;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  float4 qr[L::kVpt];
  float4 acc[L::kVpt];
#pragma unroll
  for (int i = 0; i < L::kVpt; ++i) {
    qr[i] = live ? q4[static_cast<size_t>(row) * L::kVec + sub + L::kTpr * i] : zero;
    acc[i] = zero;
  }
  float m = -INFINITY;
  float l = 0.0f;

  for (int k0 = 0; k0 < S; k0 += kTileK) {
    const int n_valid = min(kTileK, S - k0);
    // The tile's rows are one contiguous run of kTileK * Dh floats.
    const float4* kt = k4 + static_cast<size_t>(k0) * L::kVec;
    const float4* vt = v4 + static_cast<size_t>(k0) * L::kVec;
    for (int i = threadIdx.x; i < kTileK * L::kVec; i += kThreads) {
      const bool ok = i / L::kVec < n_valid;
      ks[i] = ok ? kt[i] : zero;
      vs[i] = ok ? vt[i] : zero;
    }
    __syncthreads();

    float s[kTileK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTileK; ++j) {
      float d = 0.0f;
#pragma unroll
      for (int i = 0; i < L::kVpt; ++i) {
        d = dot4(qr[i], ks[j * L::kVec + sub + L::kTpr * i], d);
      }
#pragma unroll
      for (int off = 1; off < L::kTpr; off <<= 1) {
        d += __shfl_xor_sync(0xffffffffu, d, off);
      }
      s[j] = j < n_valid ? d * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    // The first tile always holds a valid key, so m_new is finite and the
    // correction of the empty start, exp(-inf), is 0.
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < L::kVpt; ++i) {
      acc[i].x *= corr;
      acc[i].y *= corr;
      acc[i].z *= corr;
      acc[i].w *= corr;
    }
#pragma unroll
    for (int j = 0; j < kTileK; ++j) {
      const float p = expf(s[j] - m_new);  // 0 for a masked key
      l += p;
#pragma unroll
      for (int i = 0; i < L::kVpt; ++i) {
        const float4 vv = vs[j * L::kVec + sub + L::kTpr * i];
        acc[i].x = fmaf(p, vv.x, acc[i].x);
        acc[i].y = fmaf(p, vv.y, acc[i].y);
        acc[i].z = fmaf(p, vv.z, acc[i].z);
        acc[i].w = fmaf(p, vv.w, acc[i].w);
      }
    }
    m = m_new;
    __syncthreads();
  }

  if (live) {
    float4* o4 = reinterpret_cast<float4*>(o) + head + static_cast<size_t>(row) * L::kVec;
#pragma unroll
    for (int i = 0; i < L::kVpt; ++i) {
      o4[sub + L::kTpr * i] =
          make_float4(acc[i].x / l, acc[i].y / l, acc[i].z / l, acc[i].w / l);
    }
    if (sub == 0) {
      lse[static_cast<size_t>(bh) * S + row] = m + logf(l);
    }
  }
}

template <int Dh>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int S,
           float scale, cudaStream_t stream) {
  using L = Layout<Dh>;
  const int q_blocks = (S + L::kRows - 1) / L::kRows;
  if (q_blocks > 65535) {  // gridDim.y
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(BH, q_blocks);
  flash_attention_fwd_kernel<Dh><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), S, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(): 0 when the
// launch was accepted. Device pointers, all contiguous float32 and 16-byte
// aligned: q, k, v and o [BH, S, Dh], lse [BH, S] (the caller's [BH, S, 1]).
// Dh is one of 8, 16, 32, 64, 128. Allocates nothing, does not synchronise.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                          void* lse, int BH, int S, int Dh, float scale,
                                          void* stream) {
  if (BH <= 0 || S <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 8: return launch<8>(q, k, v, o, lse, BH, S, scale, st);
    case 16: return launch<16>(q, k, v, o, lse, BH, S, scale, st);
    case 32: return launch<32>(q, k, v, o, lse, BH, S, scale, st);
    case 64: return launch<64>(q, k, v, o, lse, BH, S, scale, st);
    case 128: return launch<128>(q, k, v, o, lse, BH, S, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
