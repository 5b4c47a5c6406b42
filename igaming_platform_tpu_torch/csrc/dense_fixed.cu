// Dense products for Hopper (sm_90a) with a sum order that no batch size and
// no launch plan can change: the MLP layers' bf16 product and the sequence
// model's float32 one.
//
// Not a TPU kernel: the JAX package leaves both products to XLA
// (igaming_platform_tpu/models/mlp.py:64-74, _dense, bf16 operands; the
// float32 x @ w + b of models/sequence.py's layers). Two modes of one kernel:
//     bf16: out[b, n] = sum_k bf16(x[b, k]) * w[k, n] + bias[n], where w
//           already holds bf16-rounded values (models/mlp.py's Dense keeps
//           them so); each product of two bf16 values is exact in float32,
//           so one fmaf per product rounds as the add alone would;
//     f32:  out[b, n] = sum_k x[b, k] * w[k, n] + bias[n] on the float32
//           operands as given; a float32 product is not exact, so each is
//           rounded on its own (__fmul_rn) and then added (__fadd_rn): the
//           two intrinsics keep nvcc from contracting them into an FMA.
// cuBLAS's float32 GEMM picks its kernel, and with it the order of the
// additions, by M: the same row summed differently inside a 256-row and a
// 4096-row batch. Here the order is one function of nothing but k:
//
// - 8 partial sums interleave: partial p adds the products of k = p, p + 8,
//   p + 16, ... in ascending k, from +0.0f;
// - the partials fold in a fixed tree, ((p0 + p1) + (p2 + p3)) +
//   ((p4 + p5) + (p6 + p7)), then the bias is added.
//
// ops/dense.py's dense_plain and dense_f32_plain add in the same order with
// torch ops, so kernel and plain versions agree bit for bit (on the card and
// against the CPU) wherever no product underflows below float32's normal
// range. Zero padding past K adds +0 or -0 to a partial that is never -0,
// which leaves it as it was.
//
// What bounds it on an H100: 2*B*K*N float32 operations at 67 TFLOP/s (8 us
// at B = 4096, 256 -> 256), or at small K its bytes. Design. Since the order
// is fixed by k alone, any tiling keeps it, so the partial index is a
// parallel dimension: a block's 8 warps all own the block's whole tile of
// outputs, warp p its partial p, i.e. the k = p (mod 8) of every staged
// stage. Within a warp every lane reads the same k, so its 32 lanes sit as
// a classic GEMM warp (4 x 8, 8 x 4 or 16 x 2 lanes, 8 x 8 outputs each):
// per k a lane reads 8 x and 8 w values from shared memory, four 16-byte
// loads that the warp's lanes share (4 or 8 distinct addresses, one bank
// pass each), for 64 FMAs, with 64 accumulators in registers. x (rounded to
// bf16 in that mode) and w are staged in shared memory as float32, k-major,
// in 32-k stages, double buffered: the next stage's global loads go to
// registers before this stage's products, to shared memory after them, one
// barrier a stage. (A cp.async ring of float32 stages, and the bf16 mode
// staged as packed bf16, were no faster at the main path's shapes: PERF.md.)
// The fold goes through shared memory: each warp writes its partial tile over
// the staging buffers, then each thread adds the 8 partials of its outputs
// in the tree above, adds the bias and writes whole rows, 16 bytes a
// thread. The lanes' layout is the one whose block width (64, 32 or 16
// columns) wastes the fewest of N's columns, and at small B a lane takes 4
// or 2 rows instead of 8, so the grid still gives each SM two blocks.
// CUDA-core arithmetic, no tensor cores: the card's mma.sync sum is not
// IEEE (ops/tensor_core_model.py) and would lose the equality with the plain
// versions. One launch a call, no allocation, no sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Timing probes (chip_smoke.py's dense_variants), wrong answers: 1 reads
// each warp's first k of a stage for all its k (the operand loads out of
// the loop); 2 also stages nothing past the first stage.
#ifndef DENSE_PROBE
#define DENSE_PROBE 0
#endif

namespace {

constexpr int kPartials = 8;   // ops/dense.py PARTIALS: one a warp
constexpr int kThreads = 32 * kPartials;
constexpr int kBK = 32;        // k a stage: 4 of each warp's partial
constexpr int kPad = 4;        // floats past each staged row: 16-byte aligned rows

static_assert(kBK % kPartials == 0, "a stage must hold whole cycles of the partials");

// A warp's lanes sit kLR down the tile's rows by 32 / kLR across its
// columns; a lane takes kTM rows (in chunks of up to 4, kLR * chunk apart)
// and 8 columns (two chunks of 4, 4 * 32 / kLR apart).
template <int kLR, int kTM>
struct Tile {
  static constexpr int kLC = 32 / kLR;
  static constexpr int kBM = kLR * kTM;  // rows a block
  static constexpr int kBN = kLC * 8;    // columns a block
  static constexpr int kRC = kTM < 4 ? kTM : 4;  // rows a chunk
  static constexpr int kXLd = kBM + kPad;  // floats a staged k row of x
  static constexpr int kWLd = kBN + kPad;  // of w; and a row of a partial tile
  static constexpr int kXPer = kBM * kBK / kThreads;  // x values a thread stages
  static constexpr int kWPer = kBN * kBK / kThreads;  // w values
  static constexpr int kWRows = kThreads / kBN;       // w k rows a pass of the block
  static constexpr int kStage = 2 * kBK * (kXLd + kWLd);
  static constexpr int kFold = kPartials * kBM * kWLd;
  static constexpr int kSmemBytes = 4 * (kStage > kFold ? kStage : kFold);
  static_assert(kBM % 8 == 0 && kXPer >= 1 && kWPer >= 1, "bad tile");
};

template <bool kF32>
__device__ __forceinline__ float mac(float x, float w, float acc) {
  if constexpr (kF32) {
    return __fadd_rn(acc, __fmul_rn(x, w));
  } else {
    return fmaf(x, w, acc);  // x and w are bf16 values: the product is exact
  }
}

template <int kN>
__device__ __forceinline__ void load_vec(float* v, const float* p) {
  if constexpr (kN == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    static_assert(kN == 2, "chunks of 4 or 2 values");
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  }
}

template <bool kF32, int kLR, int kTM>
__global__ void __launch_bounds__(kThreads, 2)
dense_fixed_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out, int B, int K, int N) {
  using T = Tile<kLR, kTM>;
  extern __shared__ float4 smem4[];
  float* const xs = reinterpret_cast<float*>(smem4);  // [stage][k][row]
  float* const ws = xs + 2 * kBK * T::kXLd;           // [stage][k][column]

  const int tid = threadIdx.x;
  const int lane = tid & 31, p = tid >> 5;  // the warp is partial p
  const int lr = lane / T::kLC, lc = lane % T::kLC;
  const long long row0 = static_cast<long long>(blockIdx.x) * T::kBM;
  const int col0 = blockIdx.y * T::kBN;

  // Staging: x by a warp per row, lanes along k (coalesced); w by rows of
  // N, lanes along columns.
  const int sk = tid & (kBK - 1), srow = tid / kBK;
  const int scol = tid % T::kBN, skr = tid / T::kBN;
  float xr[T::kXPer], wr[T::kWPer];
  auto load = [&](int k0) {
    const int gk = k0 + sk;
#pragma unroll
    for (int j = 0; j < T::kXPer; ++j) {
      const long long gr = row0 + srow + j * (kThreads / kBK);
      xr[j] = (gr < B && gk < K) ? __ldg(x + gr * K + gk) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < T::kWPer; ++j) {
      const int kk = k0 + skr + j * T::kWRows, gc = col0 + scol;
      wr[j] = (kk < K && gc < N) ? __ldg(w + static_cast<long long>(kk) * N + gc) : 0.0f;
    }
  };
  auto store = [&](int buf) {
    float* xb = xs + buf * kBK * T::kXLd;
    float* wb = ws + buf * kBK * T::kWLd;
#pragma unroll
    for (int j = 0; j < T::kXPer; ++j) {
      xb[sk * T::kXLd + srow + j * (kThreads / kBK)] =
          kF32 ? xr[j] : __bfloat162float(__float2bfloat16_rn(xr[j]));
    }
#pragma unroll
    for (int j = 0; j < T::kWPer; ++j) wb[(skr + j * T::kWRows) * T::kWLd + scol] = wr[j];
  };

  float acc[kTM * 8];
#pragma unroll
  for (int i = 0; i < kTM * 8; ++i) acc[i] = 0.0f;

  load(0);
  store(0);
  __syncthreads();
  for (int k0 = 0, buf = 0; k0 < K; k0 += kBK, buf ^= 1) {
    const bool more = DENSE_PROBE < 2 && k0 + kBK < K;
    if (more) load(k0 + kBK);  // in flight while this stage's products run
    const float* xb = xs + buf * kBK * T::kXLd + lr * T::kRC;
    const float* wb = ws + buf * kBK * T::kWLd + lc * 4;
#pragma unroll
    for (int c = 0; c < kBK / kPartials; ++c) {
      const int kc = (DENSE_PROBE ? 0 : c * kPartials) + p;  // this warp's k, ascending
      float xv[kTM], wv[8];
#pragma unroll
      for (int h = 0; h < kTM / T::kRC; ++h) {
        load_vec<T::kRC>(xv + h * T::kRC, xb + kc * T::kXLd + h * T::kRC * kLR);
      }
      load_vec<4>(wv, wb + kc * T::kWLd);
      load_vec<4>(wv + 4, wb + kc * T::kWLd + 4 * T::kLC);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i * 8 + j] = mac<kF32>(xv[i], wv[j], acc[i * 8 + j]);
    }
    if (more) store(buf ^ 1);  // the other buffer: last read before the previous barrier
    __syncthreads();
  }

  // The fold: each warp's partial tile over the staging buffers, then each
  // thread's outputs, 4 columns at a time, in the fixed tree, plus the bias.
  float* const part = xs;  // [partial][row][column]
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = (i / T::kRC) * T::kRC * kLR + lr * T::kRC + i % T::kRC;
    float* dst = part + (p * T::kBM + r) * T::kWLd + lc * 4;
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[i * 8], acc[i * 8 + 1], acc[i * 8 + 2], acc[i * 8 + 3]);
    *reinterpret_cast<float4*>(dst + 4 * T::kLC) =
        make_float4(acc[i * 8 + 4], acc[i * 8 + 5], acc[i * 8 + 6], acc[i * 8 + 7]);
  }
  __syncthreads();
  const bool vec = (N & 3) == 0;
  for (int v = tid; v < T::kBM * T::kBN / 4; v += kThreads) {
    const int r = v / (T::kBN / 4), c = (v % (T::kBN / 4)) * 4;
    const long long gr = row0 + r;
    const int gc = col0 + c;
    if (gr >= B || gc >= N) continue;
    float s[kPartials][4];
#pragma unroll
    for (int q = 0; q < kPartials; ++q) load_vec<4>(s[q], part + (q * T::kBM + r) * T::kWLd + c);
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float s01 = __fadd_rn(s[0][j], s[1][j]), s23 = __fadd_rn(s[2][j], s[3][j]);
      const float s45 = __fadd_rn(s[4][j], s[5][j]), s67 = __fadd_rn(s[6][j], s[7][j]);
      const float sum = __fadd_rn(__fadd_rn(s01, s23), __fadd_rn(s45, s67));
      o[j] = gc + j < N ? __fadd_rn(sum, bias[gc + j]) : 0.0f;
    }
    float* dst = out + gr * N + gc;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (gc + j < N) dst[j] = o[j];
      }
    }
  }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      v = 132;
    }
    return v;
  }();
  return n;
}

template <bool kF32, int kLR, int kTM>
int launch_tile(const void* x, const void* w, const void* bias, void* out, int B, int K, int N,
                cudaStream_t stream) {
  using T = Tile<kLR, kTM>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(dense_fixed_kernel<kF32, kLR, kTM>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (attr != cudaSuccess) {
    return static_cast<int>(attr);
  }
  const dim3 grid((B + T::kBM - 1) / T::kBM, (N + T::kBN - 1) / T::kBN);
  if (grid.y > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dense_fixed_kernel<kF32, kLR, kTM><<<grid, kThreads, T::kSmemBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), B, K, N);
  return static_cast<int>(cudaGetLastError());
}

template <bool kF32, int kLR>
int launch_rows(const void* x, const void* w, const void* bias, void* out, int B, int K, int N,
                cudaStream_t stream) {
  // 8 rows a lane, or 4 or 2 while the grid would give an SM fewer than two
  // blocks. The plan changes the speed, never the bits.
  const long long col_blocks = (N + Tile<kLR, 8>::kBN - 1) / Tile<kLR, 8>::kBN;
  auto blocks = [&](int tm) {
    const long long rows = static_cast<long long>(kLR) * tm;
    return (B + rows - 1) / rows * col_blocks;
  };
  const long long want = 2LL * sm_count();
  if (blocks(8) >= want) return launch_tile<kF32, kLR, 8>(x, w, bias, out, B, K, N, stream);
  if (blocks(4) >= want) return launch_tile<kF32, kLR, 4>(x, w, bias, out, B, K, N, stream);
  return launch_tile<kF32, kLR, 2>(x, w, bias, out, B, K, N, stream);
}

template <bool kF32>
int launch(const void* x, const void* w, const void* bias, void* out, int B, int K, int N,
           void* stream) {
  if (B <= 0 || K <= 0 || N <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The lanes' layout whose block width (64, 32 or 16 columns) wastes the
  // fewest of N's columns; the wider one on a tie.
  const int rows_of_lanes[3] = {4, 8, 16};
  int best = 4, waste = 1 << 30;
  for (int lr : rows_of_lanes) {
    const int width = 32 / lr * 8, over = (N + width - 1) / width * width - N;
    if (over < waste) best = lr, waste = over;
  }
  switch (best) {
    case 4: return launch_rows<kF32, 4>(x, w, bias, out, B, K, N, st);
    case 8: return launch_rows<kF32, 8>(x, w, bias, out, B, K, N, st);
    default: return launch_rows<kF32, 16>(x, w, bias, out, B, K, N, st);
  }
}

}  // namespace

// x [B, K], w [K, N], bias [N], out [B, N]: contiguous float32 on the card.
// Launches on `stream`; returns the CUDA error of the launch (0 on success).
// Allocates nothing, does not sync.
extern "C" int dense_bf16_launch(const void* x, const void* w, const void* bias, void* out,
                                 int B, int K, int N, void* stream) {
  return launch<false>(x, w, bias, out, B, K, N, stream);
}

extern "C" int dense_f32_launch(const void* x, const void* w, const void* bias, void* out,
                                int B, int K, int N, void* stream) {
  return launch<true>(x, w, bias, out, B, K, N, stream);
}
