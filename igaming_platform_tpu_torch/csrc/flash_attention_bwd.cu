// Flash-attention backward for Hopper (sm_90a): split-bf16 products on the
// tensor cores (mma.sync), float32 everywhere else.
//
// Replaces the two backward TPU kernels of
// igaming_platform_tpu/ops/pallas/flash_attention.py, both launched by _run_bwd:
// _kernel_bwd_dq (:190, the pallas_call at :251) and _kernel_bwd_dkv (:213,
// the pallas_call at :261). With the forward's row logsumexp L saved, the
// softmax probabilities are recomputed exactly, P = exp(S - L) with
// S = (q . k) * scale, and per (b*h):
//     D  = rowsum(dO * O)             (computed by the caller, as the JAX
//                                      package computes it in XLA)
//     dS = P * (dO . V^T - D) * scale
//     dQ = dS K                        (flash_attention_bwd_dq_kernel)
//     dV = P^T dO,  dK = dS^T Q        (flash_attention_bwd_dkv_kernel)
//
// Arithmetic. The bar is the JAX tests' rtol/atol 2e-4 for gradients, which
// one-term TF32 or bf16 misses. Every float32 operand x is split into
// hi = bf16_rn(x) and lo = bf16_rn(x - hi), and every product a.b is taken as
// lo_a.hi_b + hi_a.lo_b + hi_a.hi_b (small terms first) by
// mma.sync.m16n8k16.bf16 with a float32 accumulator: the dropped lo.lo term is
// 2^-16 of the product. exp, the splits and dS = P * (dP - D) * scale stay in
// float32 on the CUDA cores (expf, no fast-math intrinsics, no TF32).
//
// Tiles. A warp owns 16 rows of its own side (one m16 tile: query rows in dQ,
// key rows in dK/dV), held in registers as split A fragments for the whole
// kernel, with its float32 accumulators. The far side (K and V in dQ; Q, dO,
// L and D in dK/dV) streams through shared memory in tiles of 64 rows (32 at
// Dh 128): 16-byte cp.async copies into a two-stage float32 ring, so the next
// tile is in flight while the block works on this one; then one pass per tile
// splits it into hi/lo bf16 planes (not once per warp per use), whose rows are
// padded by 8 elements so that every ldmatrix phase hits 8 distinct 16-byte
// bank groups. Per 16-row chunk of a far tile, each warp computes
//   dQ:    S = Q K^T, dP = dO V^T  (B fragments by ldmatrix from K and V rows)
//          dQ += dS K              (B by ldmatrix.trans from the same planes)
//   dK/dV: S^T = K Q^T, dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q
// The float32 accumulator of a score product over two adjacent n8 tiles is
// element for element the A fragment of the next k16 product, so P and dS go
// from one product to the next in registers, split, with no shuffle and no
// trip through shared memory (the FlashAttention-2 layout). The dK/dV kernel
// computes the transposed tile directly, so P^T and dS^T come out in A layout;
// L and D are indexed by column there and staged with the query tile.
//
// Rows per block. A block is 4 warps and owns 64 rows, unless BH * ceil(S / 64)
// blocks would leave SMs idle: then it owns 16 rows, its 4 warps take every
// fourth 16-row chunk of each far tile, and their partial sums are added in
// warp order at the end. A training step at S = 64 gets 512 blocks instead of
// 128, and (4, 300, 32) 76 instead of 20; a lone warp on an SM would leave
// three of its four tensor-core partitions idle.
//
// One owner per output row, as in the TPU design: the dQ kernel recomputes S,
// P and dP for its query rows and the dK/dV kernel again for its key rows, so
// the pair does 14 * BH*S^2*Dh floating-point operations where the gradient
// needs 10 (five products). The recompute buys no atomics and a fixed loop
// order: two launches on the same inputs give bit-identical outputs. Keys past
// S count as P = 0 in dQ, query columns past S as zero P^T columns in dK/dV
// (their L and D are zero-filled, never garbage), and rows past S are neither
// read nor written, so S need not be a multiple of any tile. Dh 8 pads the
// Dh reduction of the score products to k16 with zeros in registers.
//
// What bounds them: operations, at 989/3 TFLOP/s of float32-accurate work
// (three bf16 products per float32 product). dQ does 6 and dK/dV 8 x
// BH*S^2*Dh; at BH=16, S=2048, Dh=64 that is 0.078 and 0.104 ms, while the
// bytes they move (q, k, v, dO and the outputs, 42-50 MB) take 13-15 us at
// 3.35 TB/s. At the abuse trainer's S = 64 both bounds are far below the
// launch latency. wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_attr.cuh"
#include "flash_attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps a block

template <int Dh>
struct Geo {
  static constexpr int kTile = Dh > 64 ? 32 : 64;  // far-side rows per staged tile
  static constexpr int kDp = Dh < 16 ? 16 : Dh;    // Dh padded to the score products' k16
  static constexpr int kLd = kDp + 8;              // bf16 row stride of a plane
  static constexpr int kKs = kDp / 16;             // k16 steps of a score product
  static constexpr int kNd = Dh / 8;               // n8 tiles of an output row
  static constexpr int kVec = Dh / 4;              // float4s per row
  static constexpr int kStage = kTile * Dh;        // floats of one staged array
  static constexpr int kPlane = kTile * kLd;       // bf16s of one plane
  static_assert(Dh % 8 == 0 && (kNd == 1 || kNd % 2 == 0), "bad head size");
};

// Shared memory of a block: the float32 ring [2 stages][2 arrays][kStage],
// four bf16 planes (hi, lo of array 0; hi, lo of array 1), and in dK/dV the
// L and D ring [2][2][kTile] and the current tile's L and D [2][kTile].
template <int Dh, bool kVecs>
constexpr int smem_bytes() {
  using G = Geo<Dh>;
  return 2 * 2 * G::kStage * 4 + 4 * G::kPlane * 2 + (kVecs ? 6 * G::kTile * 4 : 0);
}

// 4 bytes from global to shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// c += a . b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in split bf16, the small terms first.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  mma(c, al, bh0, bh1);
  mma(c, ah, bl0, bl1);
  mma(c, ah, bh0, bh1);
}

// (x, y) -> packed bf16 pairs hi = rn(x, y), lo = rn((x, y) - hi); x in the
// low half, as a fragment register holds its lower column.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The split A fragment of rows [r0, r0 + 16) and columns [16 ks, 16 ks + 16)
// of a [S, Dh] float32 array: zero past S and past Dh.
template <int Dh>
__device__ __forceinline__ void load_a(const float* x, int r0, int S, int ks, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + g + 8 * (i & 1);
    const int col = 16 * ks + 2 * t + 8 * (i >> 1);
    float2 v = make_float2(0.0f, 0.0f);
    if (row < S && col < Dh) {
      v = *reinterpret_cast<const float2*>(x + static_cast<size_t>(row) * Dh + col);
    }
    split2(v.x, v.y, hi[i], lo[i]);
  }
}

// Starts the copies of rows [r0, r0 + kTile) of two [S, Dh] arrays of one head
// into one stage of the ring (and, with vecs, of two [S] vectors), zero past S.
template <int Dh>
__device__ __forceinline__ void stage_tile(float* dst, const float* a, const float* b,
                                           float* vdst, const float* va, const float* vb,
                                           int r0, int S) {
  using G = Geo<Dh>;
  const uint32_t base = smem_addr(dst);
  for (int i = threadIdx.x; i < G::kTile * G::kVec; i += kThreads) {
    const bool ok = r0 + i / G::kVec < S;
    const size_t off = ok ? static_cast<size_t>(r0) * Dh + 4 * static_cast<size_t>(i) : 0;
    cp_async16(base + 16 * i, a + off, ok);
    cp_async16(base + 4 * (G::kStage + 4 * i), b + off, ok);
  }
  if (vdst != nullptr) {
    const uint32_t vbase = smem_addr(vdst);
    for (int i = threadIdx.x; i < G::kTile; i += kThreads) {
      const bool ok = r0 + i < S;
      const int off = ok ? r0 + i : 0;
      cp_async4(vbase + 4 * i, va + off, ok);
      cp_async4(vbase + 4 * (G::kTile + i), vb + off, ok);
    }
  }
}

// Splits one landed stage into the four hi/lo planes (and copies its vectors
// out of the ring, which the next copy overwrites while this tile is in use).
template <int Dh>
__device__ __forceinline__ void split_tile(const float* src, bf16* planes, const float* vsrc,
                                           float* vdst) {
  using G = Geo<Dh>;
  for (int i = threadIdx.x; i < 2 * G::kTile * G::kVec; i += kThreads) {
    const int arr = i / (G::kTile * G::kVec);
    const int e = i - arr * G::kTile * G::kVec;
    const int row = e / G::kVec, col = 4 * (e - row * G::kVec);
    const float4 x = reinterpret_cast<const float4*>(src)[i];
    uint2 hi, lo;
    split2(x.x, x.y, hi.x, lo.x);
    split2(x.z, x.w, hi.y, lo.y);
    bf16* p = planes + 2 * arr * G::kPlane + row * G::kLd + col;
    *reinterpret_cast<uint2*>(p) = hi;
    *reinterpret_cast<uint2*>(p + G::kPlane) = lo;
  }
  if (vsrc != nullptr) {
    for (int i = threadIdx.x; i < 2 * G::kTile; i += kThreads) {
      vdst[i] = vsrc[i];
    }
  }
}

// s[nt] = A . X^T over the far rows [c0 + 8 nt, c0 + 8 nt + 8) of a plane pair
// (X row-major [rows][Dh]): the warp's 16 own rows against 16 far rows, the
// reduction over Dh. B fragments come by ldmatrix, matrices (rows, cols):
// (c0, k0), (c0, k0 + 8), (c0 + 8, k0), (c0 + 8, k0 + 8).
template <int Dh>
__device__ __forceinline__ void score16(float (&s)[2][4], const uint32_t (&ah)[Geo<Dh>::kKs][4],
                                        const uint32_t (&al)[Geo<Dh>::kKs][4], const bf16* hi,
                                        const bf16* lo, int c0) {
  using G = Geo<Dh>;
  const int lane = threadIdx.x & 31;
  const int m = lane >> 3, r = lane & 7;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[nt][i] = 0.0f;
    }
  }
#pragma unroll
  for (int ks = 0; ks < G::kKs; ++ks) {
    const int off = (c0 + r + 8 * (m >> 1)) * G::kLd + 16 * ks + 8 * (m & 1);
    uint32_t bh[4], bl[4];
    ldsm_x4(bh, smem_addr(hi + off));
    ldsm_x4(bl, smem_addr(lo + off));
    if (Dh < 16) {  // columns 8..15 are padding: zero in registers
      bh[1] = bh[3] = bl[1] = bl[3] = 0u;
    }
    mma3(s[0], ah[ks], al[ks], bh[0], bh[1], bl[0], bl[1]);
    mma3(s[1], ah[ks], al[ks], bh[2], bh[3], bl[2], bl[3]);
  }
}

// acc[nd] += A . X over the far rows [c0, c0 + 16) of a plane pair: A is the
// warp's 16 x 16 split fragment (P, dS or their transposes), X row-major
// [rows][Dh], read transposed by ldmatrix.trans, matrices (rows, cols):
// (c0, n0), (c0 + 8, n0), (c0, n0 + 8), (c0 + 8, n0 + 8).
template <int Dh>
__device__ __forceinline__ void accum16(float (&acc)[Geo<Dh>::kNd][4], const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], const bf16* hi, const bf16* lo,
                                        int c0) {
  using G = Geo<Dh>;
  const int lane = threadIdx.x & 31;
  if (G::kNd == 1) {
    const int off = (c0 + (lane & 15)) * G::kLd;
    uint32_t bh[2], bl[2];
    ldsm_x2_t(bh, smem_addr(hi + off));
    ldsm_x2_t(bl, smem_addr(lo + off));
    mma3(acc[0], ah, al, bh[0], bh[1], bl[0], bl[1]);
  } else {
    const int m = lane >> 3, r = lane & 7;
#pragma unroll
    for (int np = 0; np < G::kNd / 2; ++np) {
      const int off = (c0 + r + 8 * (m & 1)) * G::kLd + 16 * np + 8 * (m >> 1);
      uint32_t bh[4], bl[4];
      ldsm_x4_t(bh, smem_addr(hi + off));
      ldsm_x4_t(bl, smem_addr(lo + off));
      mma3(acc[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
      mma3(acc[2 * np + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
    }
  }
}

// A block is 4 warps. With kSplit = 1 each warp owns its own 16 rows and
// takes every chunk of a far tile; with kSplit = 4 the four warps share 16
// rows and take every fourth chunk, and their partial sums are added in warp
// order at the end (park, then gather), so the result still repeats bit for
// bit. `red` is shared memory the block no longer needs.
template <int kN>
__device__ __forceinline__ void park(const float (&acc)[kN][4], float* red, int sp) {
  const int lane = threadIdx.x & 31;
  if (sp > 0) {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        red[((sp - 1) * kN * 4 + 4 * n + i) * 32 + lane] = acc[n][i];
      }
    }
  }
}

template <int kN, int kSplit>
__device__ __forceinline__ void gather(float (&acc)[kN][4], const float* red) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int sp = 1; sp < kSplit; ++sp) {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[n][i] += red[((sp - 1) * kN * 4 + 4 * n + i) * 32 + lane];
      }
    }
  }
}

// dQ: a block owns 64 / kSplit query rows of one (b*h) and loops over key tiles.
template <int Dh, int kSplit>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ dmat,
                              float* __restrict__ dq, int S, float scale) {
  using G = Geo<Dh>;
  static_assert(kSplit == 1 || kSplit == 4, "4 warps: 4 row groups or 1");
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  bf16* planes = reinterpret_cast<bf16*>(smem + 2 * 2 * G::kStage * 4);  // K hi, lo, V hi, lo

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int sp = warp / (4 / kSplit);  // which chunks of a far tile this warp takes
  const int r0 = (blockIdx.y * (4 / kSplit) + warp % (4 / kSplit)) * 16;
  const size_t head = static_cast<size_t>(blockIdx.x) * S;
  const float* kh = k + head * Dh;
  const float* vh = v + head * Dh;
  const int n_tiles = (S + G::kTile - 1) / G::kTile;
  stage_tile<Dh>(ring, kh, vh, nullptr, nullptr, nullptr, 0, S);
  cp_async_commit();

  uint32_t qh[G::kKs][4], ql[G::kKs][4], oh[G::kKs][4], ol[G::kKs][4];
#pragma unroll
  for (int ks = 0; ks < G::kKs; ++ks) {
    load_a<Dh>(q + head * Dh, r0, S, ks, qh[ks], ql[ks]);
    load_a<Dh>(dout + head * Dh, r0, S, ks, oh[ks], ol[ks]);
  }
  float row_lse[2], row_d[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    row_lse[h] = row < S ? lse[head + row] : 0.0f;
    row_d[h] = row < S ? dmat[head + row] : 0.0f;
  }
  float acc[G::kNd][4];
#pragma unroll
  for (int nd = 0; nd < G::kNd; ++nd) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[nd][i] = 0.0f;
    }
  }

#pragma unroll 1
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      stage_tile<Dh>(ring + ((j + 1) & 1) * 2 * G::kStage, kh, vh, nullptr, nullptr,
                               nullptr, (j + 1) * G::kTile, S);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // tile j has landed for every thread; tile j - 1's planes are free
    const int t0 = j * G::kTile;
    split_tile<Dh>(ring + (j & 1) * 2 * G::kStage, planes, nullptr, nullptr);
    __syncthreads();
#pragma unroll 1
    for (int c0 = 16 * sp; c0 < G::kTile && t0 + c0 < S; c0 += 16 * kSplit) {
      float s[2][4], dp[2][4];
      score16<Dh>(s, qh, ql, planes, planes + G::kPlane, c0);
      score16<Dh>(dp, oh, ol, planes + 2 * G::kPlane, planes + 3 * G::kPlane, c0);
      uint32_t dsh[4], dsl[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int key = t0 + c0 + 8 * nt + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p0 = key < S ? expf(s[nt][2 * h] * scale - row_lse[h]) : 0.0f;
          const float p1 = key + 1 < S ? expf(s[nt][2 * h + 1] * scale - row_lse[h]) : 0.0f;
          split2(p0 * (dp[nt][2 * h] - row_d[h]) * scale,
                 p1 * (dp[nt][2 * h + 1] - row_d[h]) * scale, dsh[2 * nt + h], dsl[2 * nt + h]);
        }
      }
      accum16<Dh>(acc, dsh, dsl, planes, planes + G::kPlane, c0);
    }
  }

  if (kSplit > 1) {
    float* red = ring;
    __syncthreads();  // every warp is done with the ring and the planes
    park(acc, red, sp);
    __syncthreads();
    if (sp > 0) {
      return;
    }
    gather<G::kNd, kSplit>(acc, red);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row < S) {
      float* out = dq + (head + row) * Dh + 2 * t;
#pragma unroll
      for (int nd = 0; nd < G::kNd; ++nd) {
        *reinterpret_cast<float2*>(out + 8 * nd) = make_float2(acc[nd][2 * h], acc[nd][2 * h + 1]);
      }
    }
  }
}

// dK and dV: a block owns 64 / kSplit key rows of one (b*h) and loops over
// query tiles (q, dO, L and D).
template <int Dh, int kSplit>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ dmat,
                               float* __restrict__ dk, float* __restrict__ dv, int S,
                               float scale) {
  using G = Geo<Dh>;
  static_assert(kSplit == 1 || kSplit == 4, "4 warps: 4 row groups or 1");
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  bf16* planes = reinterpret_cast<bf16*>(smem + 2 * 2 * G::kStage * 4);  // Q hi, lo, dO hi, lo
  float* vring = reinterpret_cast<float*>(smem + 2 * 2 * G::kStage * 4 + 4 * G::kPlane * 2);
  float* vtile = vring + 2 * 2 * G::kTile;  // L then D of the current query tile

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int sp = warp / (4 / kSplit);  // which chunks of a far tile this warp takes
  const int r0 = (blockIdx.y * (4 / kSplit) + warp % (4 / kSplit)) * 16;
  const size_t head = static_cast<size_t>(blockIdx.x) * S;
  const float* qh = q + head * Dh;
  const float* doh = dout + head * Dh;
  const int n_tiles = (S + G::kTile - 1) / G::kTile;
  stage_tile<Dh>(ring, qh, doh, vring, lse + head, dmat + head, 0, S);
  cp_async_commit();

  uint32_t kh[G::kKs][4], kl[G::kKs][4], vh[G::kKs][4], vl[G::kKs][4];
#pragma unroll
  for (int ks = 0; ks < G::kKs; ++ks) {
    load_a<Dh>(k + head * Dh, r0, S, ks, kh[ks], kl[ks]);
    load_a<Dh>(v + head * Dh, r0, S, ks, vh[ks], vl[ks]);
  }
  float dka[G::kNd][4], dva[G::kNd][4];
#pragma unroll
  for (int nd = 0; nd < G::kNd; ++nd) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dka[nd][i] = 0.0f;
      dva[nd][i] = 0.0f;
    }
  }

#pragma unroll 1
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      const int nxt = (j + 1) & 1;
      stage_tile<Dh>(ring + nxt * 2 * G::kStage, qh, doh, vring + nxt * 2 * G::kTile,
                               lse + head, dmat + head, (j + 1) * G::kTile, S);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // tile j has landed for every thread; tile j - 1's planes are free
    const int t0 = j * G::kTile;
    split_tile<Dh>(ring + (j & 1) * 2 * G::kStage, planes,
                             vring + (j & 1) * 2 * G::kTile, vtile);
    __syncthreads();
#pragma unroll 1
    for (int c0 = 16 * sp; c0 < G::kTile && t0 + c0 < S; c0 += 16 * kSplit) {
      float s[2][4], dp[2][4];
      score16<Dh>(s, kh, kl, planes, planes + G::kPlane, c0);
      score16<Dh>(dp, vh, vl, planes + 2 * G::kPlane, planes + 3 * G::kPlane, c0);
      uint32_t ph[4], pl[4], dsh[4], dsl[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = c0 + 8 * nt + 2 * t;  // query column within the tile
        const bool ok0 = t0 + col < S, ok1 = t0 + col + 1 < S;
        const float l0 = vtile[col], l1 = vtile[col + 1];
        const float d0 = vtile[G::kTile + col], d1 = vtile[G::kTile + col + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p0 = ok0 ? expf(s[nt][2 * h] * scale - l0) : 0.0f;
          const float p1 = ok1 ? expf(s[nt][2 * h + 1] * scale - l1) : 0.0f;
          split2(p0, p1, ph[2 * nt + h], pl[2 * nt + h]);
          split2(p0 * (dp[nt][2 * h] - d0) * scale, p1 * (dp[nt][2 * h + 1] - d1) * scale,
                 dsh[2 * nt + h], dsl[2 * nt + h]);
        }
      }
      accum16<Dh>(dva, ph, pl, planes + 2 * G::kPlane, planes + 3 * G::kPlane, c0);
      accum16<Dh>(dka, dsh, dsl, planes, planes + G::kPlane, c0);
    }
  }

  if (kSplit > 1) {
    float* red = ring;
    __syncthreads();  // every warp is done with the ring and the planes
    park(dka, red, sp);
    park(dva, red + (kSplit - 1) * G::kNd * 4 * 32, sp);
    __syncthreads();
    if (sp > 0) {
      return;
    }
    gather<G::kNd, kSplit>(dka, red);
    gather<G::kNd, kSplit>(dva, red + (kSplit - 1) * G::kNd * 4 * 32);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row < S) {
      const size_t off = (head + row) * Dh + 2 * t;
#pragma unroll
      for (int nd = 0; nd < G::kNd; ++nd) {
        *reinterpret_cast<float2*>(dk + off + 8 * nd) =
            make_float2(dka[nd][2 * h], dka[nd][2 * h + 1]);
        *reinterpret_cast<float2*>(dv + off + 8 * nd) =
            make_float2(dva[nd][2 * h], dva[nd][2 * h + 1]);
      }
    }
  }
}

// Launches a kernel (its dynamic shared memory limit set by the caller) over
// (BH, row blocks).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int bytes, int BH, int S, int rows, cudaStream_t stream,
           Args... args) {
  const dim3 grid(BH, (S + rows - 1) / rows);
  if (grid.y > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<grid, kThreads, bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int Dh, int kSplit>
int launch_dq(const float* q, const float* k, const float* v, const float* dout,
              const float* lse, const float* dmat, float* dq, int BH, int S, float scale,
              cudaStream_t stream) {
  constexpr int bytes = smem_bytes<Dh, false>();
  static_assert((kSplit - 1) * Geo<Dh>::kNd * 4 * 32 <= 2 * 2 * Geo<Dh>::kStage, "red");
  static std::atomic<bool> smem_set[kMaxCards];
  const cudaError_t attr = smem_limit_on_current_card(
      smem_set, (const void*)flash_attention_bwd_dq_kernel<Dh, kSplit>, bytes);
  if (attr != cudaSuccess) {
    return static_cast<int>(attr);
  }
  return launch(flash_attention_bwd_dq_kernel<Dh, kSplit>, bytes, BH, S, 64 / kSplit, stream, q,
                k, v, dout, lse, dmat, dq, S, scale);
}

template <int Dh, int kSplit>
int launch_dkv(const float* q, const float* k, const float* v, const float* dout,
               const float* lse, const float* dmat, float* dk, float* dv, int BH, int S,
               float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<Dh, true>();
  static_assert(2 * (kSplit - 1) * Geo<Dh>::kNd * 4 * 32 <= 2 * 2 * Geo<Dh>::kStage, "red");
  static std::atomic<bool> smem_set[kMaxCards];
  const cudaError_t attr = smem_limit_on_current_card(
      smem_set, (const void*)flash_attention_bwd_dkv_kernel<Dh, kSplit>, bytes);
  if (attr != cudaSuccess) {
    return static_cast<int>(attr);
  }
  return launch(flash_attention_bwd_dkv_kernel<Dh, kSplit>, bytes, BH, S, 64 / kSplit, stream, q,
                k, v, dout, lse, dmat, dk, dv, S, scale);
}

template <int Dh>
int dq_for(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* dmat, void* dq, int BH, int S, float scale, cudaStream_t st) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (narrow_blocks(BH, S)) {
    return launch_dq<Dh, 4>(f(q), f(k), f(v), f(dout), f(lse), f(dmat), static_cast<float*>(dq),
                            BH, S, scale, st);
  }
  return launch_dq<Dh, 1>(f(q), f(k), f(v), f(dout), f(lse), f(dmat), static_cast<float*>(dq),
                          BH, S, scale, st);
}

template <int Dh>
int dkv_for(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* dmat, void* dk, void* dv, int BH, int S, float scale, cudaStream_t st) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (narrow_blocks(BH, S)) {
    return launch_dkv<Dh, 4>(f(q), f(k), f(v), f(dout), f(lse), f(dmat),
                             static_cast<float*>(dk), static_cast<float*>(dv), BH, S, scale, st);
  }
  return launch_dkv<Dh, 1>(f(q), f(k), f(v), f(dout), f(lse), f(dmat), static_cast<float*>(dk),
                           static_cast<float*>(dv), BH, S, scale, st);
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
    case 8: return dq_for<8>(q, k, v, dout, lse, dmat, dq, BH, S, scale, st);
    case 16: return dq_for<16>(q, k, v, dout, lse, dmat, dq, BH, S, scale, st);
    case 32: return dq_for<32>(q, k, v, dout, lse, dmat, dq, BH, S, scale, st);
    case 64: return dq_for<64>(q, k, v, dout, lse, dmat, dq, BH, S, scale, st);
    case 128: return dq_for<128>(q, k, v, dout, lse, dmat, dq, BH, S, scale, st);
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
    case 8: return dkv_for<8>(q, k, v, dout, lse, dmat, dk, dv, BH, S, scale, st);
    case 16: return dkv_for<16>(q, k, v, dout, lse, dmat, dk, dv, BH, S, scale, st);
    case 32: return dkv_for<32>(q, k, v, dout, lse, dmat, dk, dv, BH, S, scale, st);
    case 64: return dkv_for<64>(q, k, v, dout, lse, dmat, dk, dv, BH, S, scale, st);
    case 128: return dkv_for<128>(q, k, v, dout, lse, dmat, dk, dv, BH, S, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
