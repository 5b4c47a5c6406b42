// Flash-attention backward for Hopper (sm_90a), float32 on the CUDA cores.
//
// Replaces the two backward TPU kernels of
// igaming_platform_tpu/ops/pallas/flash_attention.py, both launched by _run_bwd:
// _kernel_bwd_dq (the pallas_call at :251) and _kernel_bwd_dkv (:261). With the
// forward's row logsumexp L saved, the softmax probabilities are recomputed
// exactly, P = exp(S - L) with S = (q . k) * scale, and per (b*h):
//     D  = rowsum(dO * O)             (computed by the caller, as the JAX
//                                      package computes it in XLA)
//     dS = P * (dO . V^T - D) * scale
//     dQ = dS K                        (flash_attention_bwd_dq_kernel)
//     dV = P^T dO,  dK = dS^T Q        (flash_attention_bwd_dkv_kernel)
// all in float32 with expf (no fast-math intrinsics, no TF32): the bar is the
// JAX tests' rtol/atol 2e-4 for gradients.
//
// Each output row has one owner, as in the TPU design: a dQ row belongs to the
// block that owns its query row and loops over every key; a dK/dV row to the
// block that owns its key row and loops over every query. No atomics, so the
// results repeat bit for bit from run to run.
//
// The TPU kernels held the loop's far side resident in VMEM and so stopped at
// S = 2048; longer S took an XLA recompute. Here a block stages 32-row tiles
// of the far side in shared memory and loops over them, so its memory does not
// grow with S and one kernel of each kind covers every S. Keys past S count as
// P = 0, query rows past S as P = 0 in the dK/dV loop, and rows past S are
// neither read (their LSE would be garbage) nor written, so S need not be a
// multiple of any block.
//
// What bounds them: operations. dQ does three products (Q K^T, dO V^T, dS K),
// 6*BH*S^2*Dh floating-point operations; dK/dV four (K Q^T, V dO^T, P^T dO,
// dS^T Q), 8*BH*S^2*Dh. Against 67 TFLOP/s float32 that is 0.385 ms and
// 0.513 ms at BH=16, S=2048, Dh=64, while the bytes they move (q, k, v, dO and
// the outputs, five or six [BH, S, Dh] arrays, 42-50 MB) take 13-15 us at
// 3.35 TB/s. At the abuse trainer's S=64 both bounds are about 1.5 us, below
// the launch latency.
//
// Layout, as in flash_attention_fwd.cu: a block of 128 threads takes one
// (b*h) and kRows rows of its own side. Each row belongs to kTpr adjacent
// threads (1 for Dh <= 32, Dh/32 above), and each of those holds Dh/kTpr
// elements of every per-row vector in registers, as float4s interleaved over
// the row's threads so that their shared-memory reads fall in different
// banks. A row's dot products are summed over its threads with warp shuffles.
//
// A simple kernel that is right: no tensor cores (their TF32 would not meet
// the bar), no TMA or double-buffered staging. Making it fast is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // rows of the far side staged per loop step

template <int Dh>
struct Layout {
  static constexpr int kTpr = Dh > 32 ? Dh / 32 : 1;  // threads per owned row
  static constexpr int kVec = Dh / 4;                 // float4s per row
  static constexpr int kVpt = kVec / kTpr;            // float4s each thread holds
  static constexpr int kRows = kThreads / kTpr;       // owned rows per block
  static_assert(Dh % 4 == 0 && kVec % kTpr == 0 && 32 % kTpr == 0, "bad head size");
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

// Sum of a row's partial dot product over its kTpr adjacent threads.
template <int kTpr>
__device__ __forceinline__ float row_sum(float d) {
#pragma unroll
  for (int off = 1; off < kTpr; off <<= 1) {
    d += __shfl_xor_sync(0xffffffffu, d, off);
  }
  return d;
}

// Stages rows [r0, r0 + kTile) of two [S, Dh] arrays of one head into shared
// memory, zero past S. The tile is one contiguous run of kTile * Dh floats.
template <int Dh>
__device__ __forceinline__ void stage(const float4* a, const float4* b, float4* as, float4* bs,
                                      int r0, int n_valid) {
  using L = Layout<Dh>;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4* at = a + static_cast<size_t>(r0) * L::kVec;
  const float4* bt = b + static_cast<size_t>(r0) * L::kVec;
  for (int i = threadIdx.x; i < kTile * L::kVec; i += kThreads) {
    const bool ok = i / L::kVec < n_valid;
    as[i] = ok ? at[i] : zero;
    bs[i] = ok ? bt[i] : zero;
  }
}

// dQ: a block owns kRows query rows of one (b*h) and loops over key tiles.
template <int Dh>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ dmat,
                              float* __restrict__ dq, int S, float scale) {
  using L = Layout<Dh>;
  __shared__ float4 ks[kTile * L::kVec];
  __shared__ float4 vs[kTile * L::kVec];

  const int bh = blockIdx.x;
  const int sub = threadIdx.x % L::kTpr;
  const int row = blockIdx.y * L::kRows + threadIdx.x / L::kTpr;
  const bool live = row < S;
  const size_t head = static_cast<size_t>(bh) * S * L::kVec;  // in float4s
  const size_t own = head + static_cast<size_t>(row) * L::kVec + sub;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  float4 qr[L::kVpt], dor[L::kVpt], acc[L::kVpt];
#pragma unroll
  for (int i = 0; i < L::kVpt; ++i) {
    qr[i] = live ? reinterpret_cast<const float4*>(q)[own + L::kTpr * i] : zero;
    dor[i] = live ? reinterpret_cast<const float4*>(dout)[own + L::kTpr * i] : zero;
    acc[i] = zero;
  }
  const float row_lse = live ? lse[static_cast<size_t>(bh) * S + row] : 0.0f;
  const float row_d = live ? dmat[static_cast<size_t>(bh) * S + row] : 0.0f;

  const float4* k4 = reinterpret_cast<const float4*>(k) + head;
  const float4* v4 = reinterpret_cast<const float4*>(v) + head;
  for (int k0 = 0; k0 < S; k0 += kTile) {
    const int n_valid = min(kTile, S - k0);
    stage<Dh>(k4, v4, ks, vs, k0, n_valid);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float4 kj[L::kVpt];
      float s = 0.0f;
      float dp = 0.0f;
#pragma unroll
      for (int i = 0; i < L::kVpt; ++i) {
        kj[i] = ks[j * L::kVec + sub + L::kTpr * i];
        s = dot4(qr[i], kj[i], s);
        dp = dot4(dor[i], vs[j * L::kVec + sub + L::kTpr * i], dp);
      }
      s = row_sum<L::kTpr>(s);
      dp = row_sum<L::kTpr>(dp);
      const float p = j < n_valid ? expf(s * scale - row_lse) : 0.0f;
      const float ds = p * (dp - row_d) * scale;
#pragma unroll
      for (int i = 0; i < L::kVpt; ++i) {
        axpy4(ds, kj[i], acc[i]);
      }
    }
    __syncthreads();
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < L::kVpt; ++i) {
      reinterpret_cast<float4*>(dq)[own + L::kTpr * i] = acc[i];
    }
  }
}

// dK and dV: a block owns kRows key rows of one (b*h) and loops over query
// tiles (q, dO, LSE and D).
template <int Dh>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ dmat,
                               float* __restrict__ dk, float* __restrict__ dv, int S,
                               float scale) {
  using L = Layout<Dh>;
  __shared__ float4 qs[kTile * L::kVec];
  __shared__ float4 dos[kTile * L::kVec];
  __shared__ float lse_tile[kTile];
  __shared__ float d_tile[kTile];

  const int bh = blockIdx.x;
  const int sub = threadIdx.x % L::kTpr;
  const int row = blockIdx.y * L::kRows + threadIdx.x / L::kTpr;
  const bool live = row < S;
  const size_t head = static_cast<size_t>(bh) * S * L::kVec;  // in float4s
  const size_t own = head + static_cast<size_t>(row) * L::kVec + sub;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  float4 kr[L::kVpt], vr[L::kVpt], dka[L::kVpt], dva[L::kVpt];
#pragma unroll
  for (int i = 0; i < L::kVpt; ++i) {
    kr[i] = live ? reinterpret_cast<const float4*>(k)[own + L::kTpr * i] : zero;
    vr[i] = live ? reinterpret_cast<const float4*>(v)[own + L::kTpr * i] : zero;
    dka[i] = zero;
    dva[i] = zero;
  }

  const float4* q4 = reinterpret_cast<const float4*>(q) + head;
  const float4* do4 = reinterpret_cast<const float4*>(dout) + head;
  const float* lse_h = lse + static_cast<size_t>(bh) * S;
  const float* d_h = dmat + static_cast<size_t>(bh) * S;
  for (int q0 = 0; q0 < S; q0 += kTile) {
    const int n_valid = min(kTile, S - q0);
    stage<Dh>(q4, do4, qs, dos, q0, n_valid);
    if (threadIdx.x < kTile) {
      const bool ok = threadIdx.x < n_valid;
      lse_tile[threadIdx.x] = ok ? lse_h[q0 + threadIdx.x] : 0.0f;
      d_tile[threadIdx.x] = ok ? d_h[q0 + threadIdx.x] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float4 qj[L::kVpt], doj[L::kVpt];
      float s = 0.0f;
      float dp = 0.0f;
#pragma unroll
      for (int i = 0; i < L::kVpt; ++i) {
        qj[i] = qs[j * L::kVec + sub + L::kTpr * i];
        doj[i] = dos[j * L::kVec + sub + L::kTpr * i];
        s = dot4(kr[i], qj[i], s);
        dp = dot4(vr[i], doj[i], dp);
      }
      s = row_sum<L::kTpr>(s);
      dp = row_sum<L::kTpr>(dp);
      const float p = j < n_valid ? expf(s * scale - lse_tile[j]) : 0.0f;
      const float ds = p * (dp - d_tile[j]) * scale;
#pragma unroll
      for (int i = 0; i < L::kVpt; ++i) {
        axpy4(p, doj[i], dva[i]);
        axpy4(ds, qj[i], dka[i]);
      }
    }
    __syncthreads();
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < L::kVpt; ++i) {
      reinterpret_cast<float4*>(dk)[own + L::kTpr * i] = dka[i];
      reinterpret_cast<float4*>(dv)[own + L::kTpr * i] = dva[i];
    }
  }
}

template <int Dh>
dim3 grid_for(int BH, int S) {
  return dim3(BH, (S + Layout<Dh>::kRows - 1) / Layout<Dh>::kRows);
}

template <int Dh>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* dmat, void* dq, int BH, int S, float scale, cudaStream_t stream) {
  const dim3 grid = grid_for<Dh>(BH, S);
  if (grid.y > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  flash_attention_bwd_dq_kernel<Dh><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dmat), static_cast<float*>(dq), S, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int Dh>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* dmat, void* dk, void* dv, int BH, int S, float scale,
               cudaStream_t stream) {
  const dim3 grid = grid_for<Dh>(BH, S);
  if (grid.y > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  flash_attention_bwd_dkv_kernel<Dh><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dmat), static_cast<float*>(dk), static_cast<float*>(dv), S,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entry points launch one kernel on `stream` and return
// cudaGetLastError(): 0 when the launch was accepted. Device pointers, all
// contiguous float32 and 16-byte aligned: q, k, v, dout and the outputs
// [BH, S, Dh]; lse and dmat (= rowsum(dout * o)) [BH, S]. Dh is one of 8, 16,
// 32, 64, 128. They allocate nothing and do not synchronise.
extern "C" int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse,
                                             const void* dmat, void* dq, int BH, int S, int Dh,
                                             float scale, void* stream) {
  if (BH <= 0 || S <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 8: return launch_dq<8>(q, k, v, dout, lse, dmat, dq, BH, S, scale, st);
    case 16: return launch_dq<16>(q, k, v, dout, lse, dmat, dq, BH, S, scale, st);
    case 32: return launch_dq<32>(q, k, v, dout, lse, dmat, dq, BH, S, scale, st);
    case 64: return launch_dq<64>(q, k, v, dout, lse, dmat, dq, BH, S, scale, st);
    case 128: return launch_dq<128>(q, k, v, dout, lse, dmat, dq, BH, S, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse,
                                              const void* dmat, void* dk, void* dv, int BH,
                                              int S, int Dh, float scale, void* stream) {
  if (BH <= 0 || S <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 8: return launch_dkv<8>(q, k, v, dout, lse, dmat, dk, dv, BH, S, scale, st);
    case 16: return launch_dkv<16>(q, k, v, dout, lse, dmat, dk, dv, BH, S, scale, st);
    case 32: return launch_dkv<32>(q, k, v, dout, lse, dmat, dk, dv, BH, S, scale, st);
    case 64: return launch_dkv<64>(q, k, v, dout, lse, dmat, dk, dv, BH, S, scale, st);
    case 128: return launch_dkv<128>(q, k, v, dout, lse, dmat, dk, dv, BH, S, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
