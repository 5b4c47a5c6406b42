// Flash-attention forward for Hopper (sm_90a): 3xTF32 products on the tensor
// cores (mma.sync), float32 everywhere else.
//
// Replaces both forward TPU kernels of
// igaming_platform_tpu/ops/pallas/flash_attention.py: _kernel_resident (:51,
// the pallas_call of _run_resident at :85, S <= 4096, the whole K/V of a head
// resident in VMEM) and _kernel_tiled (:105, the pallas_call of _run_tiled at
// :142, m/l/acc carried in scratch across a sequential kv grid axis). Same
// function for every (b*h, row):
//     s_j = (q . k_j) * scale,  scale = 1/sqrt(Dh) applied as a multiply
//     m   = max_j s_j,  l = sum_j exp(s_j - m),  acc = sum_j exp(s_j - m) v_j
//     o   = acc / l,    lse = m + log(l)
// as a running (online) softmax over key tiles. The TPU needed two kernels
// because more than 4096 resident K/V rows overflowed its scoped VMEM; here K
// and V stream through shared memory, so one kernel covers every S. Keys past
// S are masked and rows past S are not written.
//
// Arithmetic. The bar is the JAX tests' rtol/atol 2e-5. One-term TF32 misses
// it 20x and more; split bf16 (the backward's scheme, about 16 bits of each
// operand) misses it 3-15x once q, k and v have amplitude 2-3 (numpy
// emulation, tests/test_torch_flash_attention.py). So every float32 operand x
// is split into big = tf32_rna(x) and small = tf32_rna(x - big), about 22 bits
// together, and each product a.b is taken as small_a.big_b + big_a.small_b +
// big_a.big_b by mma.sync.m16n8k8.tf32 with float32 accumulators. How the
// products are summed matters as much: exp turns a score's absolute error into
// p's relative error, and a float32 sum of 64 products of magnitude 80 is off
// by several 1e-6; at amplitude 3 the float32 dense version itself lies 1-2.3x
// the bar from float64. So a score keeps two accumulators. The small terms
// chain on the tensor cores into `lo`. The big.big products chain over two k8
// steps from zero, then join `hi` on the CUDA cores with their rounding error
// kept apart (Fast2Sum) and added to `lo` at the end; a chain over all of Dh
// with no compensation missed the bar from float64 on the card at amplitude
// 3. The exponent is fma(lo, scale, fma(hi, scale, -m)), so the score is
// never rounded to float32 at its full magnitude. Each pass's P.V starts from zero
// as well and joins the running sum in one fma with the rescale. exp and log
// are expf and logf.
//
// Tiles. A warp owns 16 query rows (one m16 tile). For Dh <= 64 it holds their
// split A fragments in registers for the whole kernel; at Dh 128 that would be
// 128 registers beside a 64-register accumulator, so the block's Q sits split
// in shared memory instead. K and V stream in tiles of 64 keys (128 in
// 128-row blocks, 32 at Dh 128) through 16-byte cp.async copies. Each thread
// splits the very float4s it copied, so its own cp.async wait is all the
// split needs, then copies the next tile into the slots it freed; that tile
// lands while the block works on this one. The planes hold each B fragment's
// four values side by side, (b0 big, b1 big, b0 small, b1 small), so one
// 16-byte load feeds the three products with no register moves: K by key
// row, dims (t, t + 4) of each k8 step together; V by key pair (2u, 2u + 1),
// each dim's two keys together. Their row strides (2 Dh + 16 and 4 Dh + 8
// floats; 2 Dh at Dh 8) keep every quarter-warp of those loads on distinct
// banks. The score accumulator holds keys (2t, 2t+1) of row g where the
// m16n8k8 A fragment of P.V wants k = (t, t+4): the kernel reads column 2t as
// k = t and 2t+1 as k = t+4, and takes V's B fragment from keys 2t and 2t+1
// to match, so P goes from one product to the next in registers, with no
// shuffle. A row's max and sum are taken across its quad (__shfl_xor 1, 2),
// and masked keys enter exp as -inf, so the softmax has no branches.
//
// Rows per block. Every block splits each staged tile once for all its warps,
// and at 64 rows a block that split and its two barriers were the largest
// cost a timing diagnostic found, so long sequences (Dh <= 64, S >= 256,
// BH * ceil(S/128) blocks filling the SMs) take 128-row blocks of 8 warps
// with 128-key tiles: a split serves twice the rows and a barrier twice the
// keys; at 255 registers a thread that is still 8 warps an SM. Otherwise a
// block is 4 warps and owns 64 rows, unless BH * ceil(S/64) blocks would
// leave SMs idle: then it owns 16 rows and each of its 4 warps takes a
// quarter of every key tile with its own (m, l, acc); the four are merged in
// warp order at the end, so relaunches repeat bit for bit. A warp that saw
// no key (S = 16 against 64-key tiles) has m = -inf and l = 0, and adds
// exactly 0. (4, 300, 32) gets 76 blocks instead of 12, one check() (2, 64,
// 32) 8 instead of 2. Where S <= 64 at Dh <= 32 a 64-row block's warps sum
// in the same quarters (fwd_for), so the two layouts agree bit for bit.
//
// What bounds it: operations, 4 * BH*S^2*Dh (QK^T and PV) against 16 * BH*S*Dh
// bytes of q, k, v and o. chip_smoke.py takes them at 989/3 TFLOP/s (the bf16
// rate over three products); 3xTF32 runs at the TF32 rate over three, 495/3,
// so this kernel can reach at most half of that bound: at BH=16, S=2048,
// Dh=64, 0.104 ms against the bound's 0.052. wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_attr.cuh"
#include "flash_attention_common.cuh"

namespace {

// A block of kWarps warps owns 16 * kWarps / kSplit rows: kSplit 1, each
// warp its own 16 rows (4 or 8 warps); kSplit 4, 4 warps sharing 16 rows and
// splitting each tile.
template <int Dh, int kSplit, int kWarps>
struct Geo {
  static constexpr int kBlock = 32 * kWarps;  // threads of a block
  static constexpr int kTile = Dh > 64 ? 32 : (kWarps == 8 ? 128 : 64);  // keys per staged tile
  static constexpr int kSub = Dh > 32 ? 32 : 64;   // keys a warp takes in one pass (registers)
  static constexpr int kKs = Dh / 8;               // k8 steps of a score; n8 tiles of O
  static constexpr int kVec = Dh / 4;              // float4s per row
  static constexpr int kStage = kTile * Dh;        // floats of one staged array
  static constexpr int kUnits = kTile * kVec / 2;  // a thread's share: 2 float4s of K, of V
  static constexpr int kLdK = 2 * Dh + (Dh == 8 ? 0 : 16);  // floats per K (and Q) row
  static constexpr int kLdV = 4 * Dh + 8;          // floats per V key pair
  static constexpr int kPlanes = kTile * kLdK + kTile / 2 * kLdV;
  static constexpr bool kQShared = Dh > 64;        // Q's fragments from shared memory
  // Shared memory, in floats: the staged tile [K, V][kStage], its planes, and
  // at Dh 128 the plane of the block's Q rows.
  static constexpr int kSmem = 2 * kStage + kPlanes + (kQShared ? 16 * kWarps / kSplit * kLdK : 0);
  static_assert(Dh % 8 == 0, "bad head size");
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// c += a . b on the tensor cores: a 16x8 tf32 (row), b 8x8 tf32 (col).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], float b0, float b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
}

// x -> big = tf32_rna(x), small = tf32_rna(x - big).
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// (big x, big y, small x, small y) at dst (16-byte aligned).
__device__ __forceinline__ void store_split(float* dst, float x, float y) {
  uint4 r;
  split(x, r.x, r.z);
  split(y, r.y, r.w);
  *reinterpret_cast<uint4*>(dst) = r;
}

// Dims [8c, 8c + 8) of one row (x0: the first four, x1: the next) into a K
// or Q plane row: dims t and t + 4 side by side.
__device__ __forceinline__ void store_k8(float* row, int c, float4 x0, float4 x1) {
  store_split(row + 16 * c, x0.x, x1.x);
  store_split(row + 16 * c + 4, x0.y, x1.y);
  store_split(row + 16 * c + 8, x0.z, x1.z);
  store_split(row + 16 * c + 12, x0.w, x1.w);
}

// Thread unit i of a tile: K row i / (kVec / 2), dims [8c, 8c + 8); V rows
// 2u and 2u + 1, u = i / kVec, dims [4e, 4e + 4).
template <int Dh, int kSplit, int kWarps>
struct Unit {
  using G = Geo<Dh, kSplit, kWarps>;
  int kr, c, u, e;
  __device__ __forceinline__ explicit Unit(int i)
      : kr(i / (G::kVec / 2)), c(i - kr * (G::kVec / 2)), u(i / G::kVec), e(i - u * G::kVec) {}
};

// Starts this thread's copies of keys [r0, r0 + kTile) of K and V into the
// staged tile (row-major [kTile][Dh] each), zero past S.
template <int Dh, int kSplit, int kWarps>
__device__ __forceinline__ void stage_tile(float* dst, const float* kh, const float* vh, int r0,
                                           int S) {
  using G = Geo<Dh, kSplit, kWarps>;
  const uint32_t base = smem_addr(dst);
  for (int i = threadIdx.x; i < G::kUnits; i += G::kBlock) {
    const Unit<Dh, kSplit, kWarps> n(i);
    const bool ok = r0 + n.kr < S;
    const float* src = kh + (ok ? static_cast<size_t>(r0 + n.kr) * Dh + 8 * n.c : 0);
    const int off = n.kr * Dh + 8 * n.c;
    cp_async16(base + 4 * off, src, ok);
    cp_async16(base + 4 * (off + 4), src + 4, ok);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 2 * n.u + h;
      const bool vok = r0 + row < S;
      cp_async16(base + 4 * (G::kStage + row * Dh + 4 * n.e),
                 vh + (vok ? static_cast<size_t>(r0 + row) * Dh + 4 * n.e : 0), vok);
    }
  }
}

// Splits the float4s of the landed tile that this thread copied itself into
// the K plane at kp and the V plane after it.
template <int Dh, int kSplit, int kWarps>
__device__ __forceinline__ void split_own(const float* src, float* kp) {
  using G = Geo<Dh, kSplit, kWarps>;
  float* vp = kp + G::kTile * G::kLdK;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int i = threadIdx.x; i < G::kUnits; i += G::kBlock) {
    const Unit<Dh, kSplit, kWarps> n(i);
    const int k4 = (n.kr * Dh + 8 * n.c) / 4;
    store_k8(kp + n.kr * G::kLdK, n.c, s4[k4], s4[k4 + 1]);
    const float4 a = s4[(G::kStage + 2 * n.u * Dh) / 4 + n.e];
    const float4 b = s4[(G::kStage + (2 * n.u + 1) * Dh) / 4 + n.e];
    float* dst = vp + n.u * G::kLdV + 16 * n.e;
    store_split(dst, a.x, b.x);
    store_split(dst + 4, a.y, b.y);
    store_split(dst + 8, a.z, b.z);
    store_split(dst + 12, a.w, b.w);
  }
}

// The state (m, l, acc) of a row's earlier keys merged with (mo, lo, ao) of
// later ones: both rescaled to the larger max. One fixed sequence of
// roundings (explicit fmaf), so that a tile merged across warps (16-row
// blocks) and one merged in quarters within a warp (kQuarters) agree bit for
// bit. m is finite (its keys include a valid one); mo = -inf adds exactly 0.
template <int kKs>
__device__ __forceinline__ void merge_state(float (&m)[2], float (&l)[2], float (&acc)[kKs][4],
                                            const float (&mo)[2], const float (&lo)[2],
                                            const float (&ao)[kKs][4]) {
  float fs[2], fo[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mn = fmaxf(m[h], mo[h]);
    fs[h] = expf(m[h] - mn);
    fo[h] = mo[h] == -INFINITY ? 0.0f : expf(mo[h] - mn);
    l[h] = fmaf(l[h], fs[h], __fmul_rn(lo[h], fo[h]));
    m[h] = mn;
  }
#pragma unroll
  for (int nd = 0; nd < kKs; ++nd) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[nd][i] = fmaf(acc[nd][i], fs[i >> 1], __fmul_rn(ao[nd][i], fo[i >> 1]));
    }
  }
}

// A block owns 64 / kSplit query rows of one (b*h) and loops over key tiles.
// kQuarters (4 warps, 64 rows, a single key tile): each warp sums the tile's
// keys in four quarters, each from an empty state, merged in order: the
// arithmetic of the 16-row layout, whose 4 warps take a quarter each.
template <int Dh, int kSplit, int kWarps, bool kQuarters = false>
__global__ void __launch_bounds__(32 * kWarps)
flash_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int S, float scale) {
  using G = Geo<Dh, kSplit, kWarps>;
  static_assert((kSplit == 4 && kWarps == 4) || kSplit == 1, "4 warps split keys, or none");
  static_assert(!kQuarters || (kSplit == 1 && kWarps == 4), "quarters emulate 4 warps' split");
  constexpr int kRows = 16 * kWarps / kSplit;  // query rows of a block
  constexpr int kChunk = G::kTile / (kQuarters ? 4 : kSplit);  // keys of each tile a pass group takes
  constexpr int kPass = kChunk < G::kSub ? kChunk : G::kSub;  // ... in one pass
  constexpr int kNt = kPass / 8;             // n8 score tiles of a pass
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                    // the staged tile: K then V, [kTile][Dh] each
  float* planes = ring + 2 * G::kStage;  // K plane, then V plane
  float* qp = planes + G::kPlanes;

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int sp = kSplit > 1 ? warp : 0;       // which quarter of each key tile (narrow)
  const int wr = kSplit > 1 ? 0 : 16 * warp;  // the warp's first row within the block
  const int r0 = blockIdx.y * kRows + wr;     // ... within the head
  const size_t head = static_cast<size_t>(blockIdx.x) * S;
  const float* kh = k + head * Dh;
  const float* vh = v + head * Dh;
  const int n_tiles = (S + G::kTile - 1) / G::kTile;
  stage_tile<Dh, kSplit, kWarps>(ring, kh, vh, 0, S);
  cp_async_commit();

  // Q split once, zero past S: A fragments [k8 step][big, small] in registers,
  // or at Dh 128 the block's rows as a plane laid out as K's.
  uint32_t qf[G::kQShared ? 1 : G::kKs][2][4];
  if constexpr (G::kQShared) {
    const int b0 = blockIdx.y * kRows;
    for (int i = threadIdx.x; i < kRows * G::kKs; i += G::kBlock) {
      const int row = i / G::kKs, c = i - row * G::kKs;
      float4 x0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), x1 = x0;
      if (b0 + row < S) {
        const float4* src = reinterpret_cast<const float4*>(q + (head + b0 + row) * Dh + 8 * c);
        x0 = src[0];
        x1 = src[1];
      }
      store_k8(qp + row * G::kLdK, c, x0, x1);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < G::kKs; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // a0..a3: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
        const int row = r0 + g + 8 * (i & 1);
        const int col = 8 * kk + t + 4 * (i >> 1);
        split(row < S ? q[(head + row) * Dh + col] : 0.0f, qf[kk][0][i], qf[kk][1][i]);
      }
    }
  }

  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8
  float l[2] = {0.0f, 0.0f};            // this thread's share of their running sums
  float acc[G::kKs][4];
#pragma unroll
  for (int nd = 0; nd < G::kKs; ++nd) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[nd][i] = 0.0f;
    }
  }
  // kQuarters: the merged state of the quarters done so far.
  float mq[2] = {-INFINITY, -INFINITY}, lq[2] = {0.0f, 0.0f}, aq[G::kKs][4];
  int quarters = 0;

#pragma unroll 1
  for (int j = 0; j < n_tiles; ++j) {
    // This thread's copies of tile j have landed; once every warp is done
    // with tile j - 1, it splits them into the planes and refills its slots
    // with tile j + 1, which lands while the block works on tile j.
    cp_async_wait_all();
    __syncthreads();
    split_own<Dh, kSplit, kWarps>(ring, planes);
    if (j + 1 < n_tiles) {
      stage_tile<Dh, kSplit, kWarps>(ring, kh, vh, (j + 1) * G::kTile, S);
      cp_async_commit();
    }
    __syncthreads();

    const float* kp = planes;
    const float* vp = kp + G::kTile * G::kLdK;
#pragma unroll 1
    for (int c0 = sp * kChunk; c0 < (kQuarters ? G::kTile : (sp + 1) * kChunk);
         c0 += kPass) {                  // within the tile
      const int key0 = j * G::kTile + c0;  // ... within the head
      if (key0 >= S) {
        break;  // a warp past the last key
      }

      // Scores of the pass: hi, lo and hi's rounding errors as the header says.
      float hi[kNt][4], lo[kNt][4], err[kNt][4], bb[kNt][4];
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hi[nt][i] = lo[nt][i] = err[nt][i] = bb[nt][i] = 0.0f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < G::kKs; ++kk) {
        uint32_t ab[4], as[4];
        if constexpr (G::kQShared) {
          const float4 x = *reinterpret_cast<const float4*>(qp + (wr + g) * G::kLdK + 16 * kk +
                                                            4 * t);
          const float4 y = *reinterpret_cast<const float4*>(
              qp + (wr + g + 8) * G::kLdK + 16 * kk + 4 * t);
          const float a[2][4] = {{x.x, y.x, x.y, y.y}, {x.z, y.z, x.w, y.w}};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ab[i] = __float_as_uint(a[0][i]);
            as[i] = __float_as_uint(a[1][i]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ab[i] = qf[kk][0][i];
            as[i] = qf[kk][1][i];
          }
        }
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          // Key c0 + 8 nt + g, dims 8 kk + t and 8 kk + t + 4: (b0, b1) big, small.
          const float4 b = *reinterpret_cast<const float4*>(
              kp + (c0 + 8 * nt + g) * G::kLdK + 16 * kk + 4 * t);
          mma(lo[nt], as, b.x, b.y);
          mma(lo[nt], ab, b.z, b.w);
          mma(bb[nt], ab, b.x, b.y);
          if (kk % 2 == 1 || kk == G::kKs - 1) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {  // hi += bb, its rounding error kept (Fast2Sum)
              const float sum = hi[nt][i] + bb[nt][i];
              err[nt][i] += bb[nt][i] - (sum - hi[nt][i]);
              hi[nt][i] = sum;
              bb[nt][i] = 0.0f;
            }
          }
        }
      }

      // Online softmax. Element i of score tile nt is row g + 8 (i >> 1), key
      // key0 + 8 nt + 2t + (i & 1); key0 is a valid key, so every row's max
      // is finite and the first pass's correction exp(-inf) is 0.
      bool valid[kNt][4];
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          valid[nt][i] = key0 + 8 * nt + 2 * t + (i & 1) < S;
          lo[nt][i] += err[nt][i];
          mx[i >> 1] = fmaxf(mx[i >> 1], valid[nt][i] ? hi[nt][i] * scale : -INFINITY);
        }
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        corr[h] = expf(m[h] - m_new);
        m[h] = m_new;
        l[h] *= corr[h];
      }
      float p[kNt][4];
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float arg = fmaf(lo[nt][i], scale, fmaf(hi[nt][i], scale, -m[i >> 1]));
          p[nt][i] = expf(valid[nt][i] ? arg : -INFINITY);
          l[i >> 1] += p[nt][i];
        }
      }

      // The pass's P.V from zero: A takes accumulator column 2t as k = t and
      // 2t + 1 as k = t + 4; B rows are keys 2t and 2t + 1 to match.
      float ta[G::kKs][4];
#pragma unroll
      for (int nd = 0; nd < G::kKs; ++nd) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ta[nd][i] = 0.0f;
        }
      }
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        uint32_t pb[4], ps[4];
        split(p[nt][0], pb[0], ps[0]);  // (g, key 2t) as (g, k = t)
        split(p[nt][2], pb[1], ps[1]);  // (g + 8, key 2t) as (g + 8, k = t)
        split(p[nt][1], pb[2], ps[2]);  // (g, key 2t + 1) as (g, k = t + 4)
        split(p[nt][3], pb[3], ps[3]);  // (g + 8, key 2t + 1) as (g + 8, k = t + 4)
        const float* vr = vp + ((c0 + 8 * nt) / 2 + t) * G::kLdV + 4 * g;
#pragma unroll
        for (int nd = 0; nd < G::kKs; ++nd) {  // dim 8 nd + g, keys (2t, 2t + 1)
          const float4 b = *reinterpret_cast<const float4*>(vr + 32 * nd);
          mma(ta[nd], ps, b.x, b.y);
          mma(ta[nd], pb, b.z, b.w);
          mma(ta[nd], pb, b.x, b.y);
        }
      }
#pragma unroll
      for (int nd = 0; nd < G::kKs; ++nd) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[nd][i] = fmaf(acc[nd][i], corr[i >> 1], ta[nd][i]);
        }
      }
      if constexpr (kQuarters) {  // this quarter into the merged state, then empty again
        if (quarters++ == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h) mq[h] = m[h], lq[h] = l[h];
#pragma unroll
          for (int nd = 0; nd < G::kKs; ++nd)
#pragma unroll
            for (int i = 0; i < 4; ++i) aq[nd][i] = acc[nd][i];
        } else {
          merge_state<G::kKs>(mq, lq, aq, m, l, acc);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) m[h] = -INFINITY, l[h] = 0.0f;
#pragma unroll
        for (int nd = 0; nd < G::kKs; ++nd)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nd][i] = 0.0f;
      }
    }
  }
  if constexpr (kQuarters) {
    // Quarters past the last key merge as the 16-row layout's idle warps do
    // (an empty state: exactly 0), then the merged state is the row's.
    for (; quarters < 4; ++quarters) merge_state<G::kKs>(mq, lq, aq, m, l, acc);
#pragma unroll
    for (int h = 0; h < 2; ++h) m[h] = mq[h], l[h] = lq[h];
#pragma unroll
    for (int nd = 0; nd < G::kKs; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nd][i] = aq[nd][i];
  }

  if (kSplit > 1) {
    // Warps 1-3 park (m, l, acc) in the staged tile, which no thread reads
    // after its last split and no copy writes; warp 0 merges them in warp
    // order. Warp 0 saw key 0, so its m is finite; a warp with m = -inf adds
    // exactly 0.
    constexpr int kPark = 4 + 4 * G::kKs;  // floats a lane parks
    static_assert((kSplit - 1) * kPark * 32 <= 2 * G::kStage, "the staged tile holds the park");
    float* red = ring;
    if (sp > 0) {
      float* r = red + (sp - 1) * kPark * 32 + lane;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        r[32 * h] = m[h];
        r[32 * (2 + h)] = l[h];
      }
#pragma unroll
      for (int nd = 0; nd < G::kKs; ++nd) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          r[32 * (4 + 4 * nd + i)] = acc[nd][i];
        }
      }
    }
    __syncthreads();
    if (sp > 0) {
      return;
    }
#pragma unroll 1
    for (int w = 1; w < kSplit; ++w) {
      const float* r = red + (w - 1) * kPark * 32 + lane;
      float mo[2], lo[2], ao[G::kKs][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mo[h] = r[32 * h];
        lo[h] = r[32 * (2 + h)];
      }
#pragma unroll
      for (int nd = 0; nd < G::kKs; ++nd) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ao[nd][i] = r[32 * (4 + 4 * nd + i)];
        }
      }
      merge_state<G::kKs>(m, l, acc, mo, lo, ao);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = r0 + g + 8 * h;
    if (row < S) {
      float* out = o + (head + row) * Dh + 2 * t;
#pragma unroll
      for (int nd = 0; nd < G::kKs; ++nd) {
        *reinterpret_cast<float2*>(out + 8 * nd) =
            make_float2(acc[nd][2 * h] / l[h], acc[nd][2 * h + 1] / l[h]);
      }
      if (t == 0) {
        lse[head + row] = m[h] + logf(l[h]);
      }
    }
  }
}

template <int Dh, int kSplit, int kWarps, bool kQuarters = false>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int S,
               float scale, cudaStream_t stream) {
  using G = Geo<Dh, kSplit, kWarps>;
  constexpr int bytes = G::kSmem * 4;
  static std::atomic<bool> smem_set[kMaxCards];
  const cudaError_t attr = smem_limit_on_current_card(
      smem_set, (const void*)flash_attention_fwd_kernel<Dh, kSplit, kWarps, kQuarters>, bytes);
  if (attr != cudaSuccess) {
    return static_cast<int>(attr);
  }
  constexpr int rows = 16 * kWarps / kSplit;
  const dim3 grid(BH, (S + rows - 1) / rows);
  if (grid.y > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  flash_attention_fwd_kernel<Dh, kSplit, kWarps, kQuarters><<<grid, G::kBlock, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), S, scale);
  return static_cast<int>(cudaGetLastError());
}

// The layout may follow BH only where it cannot change a row's bits. The
// 16-row layout's four warps each sum a quarter of every key tile and merge
// (merge_state), another order than one warp's pass over the tile. So where
// the keys fit one tile (S <= 64) at Dh <= 32 (the abuse detector, the
// session head), the 64-row layout sums that tile in quarters merged the
// same way (kQuarters), and a row gets the same bits in either layout: one
// check() as inside a batch. Past one tile, or at Dh 64 and 128, a few
// heads still take the 16-row layout, whose bits then differ from a large
// batch's.
template <int Dh>
int fwd_for(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int S,
            float scale, cudaStream_t st) {
  if (narrow_blocks(BH, S)) {
    return launch_fwd<Dh, 4, 4>(q, k, v, o, lse, BH, S, scale, st);
  }
  if constexpr (Dh <= 32) {
    if (S <= 64) {
      return launch_fwd<Dh, 1, 4, true>(q, k, v, o, lse, BH, S, scale, st);
    }
  }
  if constexpr (Dh <= 64) {
    // BH * ceil(S / 128) = BH * ceil(ceil(S / 2) / 64) blocks fill the SMs.
    if (S >= 256 && !narrow_blocks(BH, (S + 1) / 2)) {
      return launch_fwd<Dh, 1, 8>(q, k, v, o, lse, BH, S, scale, st);
    }
  }
  return launch_fwd<Dh, 1, 4>(q, k, v, o, lse, BH, S, scale, st);
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
    case 8: return fwd_for<8>(q, k, v, o, lse, BH, S, scale, st);
    case 16: return fwd_for<16>(q, k, v, o, lse, BH, S, scale, st);
    case 32: return fwd_for<32>(q, k, v, o, lse, BH, S, scale, st);
    case 64: return fwd_for<64>(q, k, v, o, lse, BH, S, scale, st);
    case 128: return fwd_for<128>(q, k, v, o, lse, BH, S, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
