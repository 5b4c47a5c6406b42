// Fused oblivious-forest inference for Hopper (sm_90a), for a forest of any
// size.
//
// Replaces the TPU kernel igaming_platform_tpu/ops/pallas/gbdt_kernel.py::_kernel
// (launched by _run, wrapped by gbdt_raw_pallas). Same function: for each row b,
//     leaf[b, t] = sum_d (x[b, feat[t, d]] > thr[t, d]) << d
//     out[b]     = sum_t leaves[t, leaf[b, t]] + bias
// i.e. raw margins, exactly what models/gbdt.py::gbdt_raw computes, for any
// number of trees T and any depth 1 <= D <= 30 (at 31 the JAX function's
// int32 leaf index 1 << d overflows).
//
// The TPU kernel keeps the whole forest in VMEM and gathers the split
// features with a one-hot [F, T*D] matrix product, because a cross-lane
// gather serialises on the TPU's vector unit. Here that product would be
// waste, and in TF32 it would flip splits near a threshold: this kernel
// reads x[b, feat[t, d]] from shared memory, so every compare sees the exact
// float32 feature, with the same `>` as gbdt.py (a tie and a NaN go left).
//
// What bounds it: at a serving forest (T=64, D=4) bytes, B*F*4 of features
// and a 6 KB forest, about 0.15 us at B=4096, far under a launch; at
// production forests (T=1000, D=6) the B*T*D compares. Design:
//
// - A lane is a row, or two. A block takes `rows` rows (32, or 64 at large
//   batches, where each lane takes rows l and l + 32) and `groups` warps;
//   warp g walks the trees g, g + groups, ... of each chunk for all of the
//   block's rows. All lanes of a warp read the same split (feat, thr) at
//   once, a broadcast, and the features of 32 rows from a slab whose row
//   stride is odd, so no two lanes hit one bank. Two rows a lane halve the
//   forest bytes a batch reads from L2, and the loads of each split.
// - The forest streams through shared memory in chunks of `chunk` trees, a
//   ring of two stages filled by 16-byte cp.async copies, the next chunk in
//   flight while the current one is evaluated. Shared memory bounds the chunk,
//   not the forest. Up to depth 8 a chunk's leaves come with it; deeper, a
//   tree's leaves (4 KB and up) are read in place through the read-only path.
// - The block's features come with coalesced 16-byte loads into the slab.
// - A batch of few rows leaves most SMs idle, and one block walks every tree
//   of its rows. So up to 8 blocks of a thread-block cluster share one set of
//   rows, each a slice of `span` trees, and the first adds the others' sums
//   from their shared memory (distributed shared memory) after a cluster
//   barrier.
// - A row's tree sum associates in one order, fixed by the forest and not by
//   the launch plan (ops/gbdt_kernel.py::sum_order): the trees fall in tree
//   blocks of `tree_block` consecutive trees; inside a tree block, `groups`
//   partial sums interleave (partial p adds the tree block's trees p,
//   p + groups, ... in order, from 0); a tree block's sum adds its partials
//   in order, and the row's sum adds the tree blocks' sums in order, then
//   the bias. Warp g keeps partial g of each tree block; a chunk takes whole
//   tree blocks or a whole share of one, a cluster rank whole tree blocks;
//   each tree block's sum lands in shared memory and the first rank adds
//   every tree block of the cluster in order. So a row gives the same bits
//   alone or inside any batch, and two launches give the same bits.
//
// The launch plan (rows, groups, chunk, cluster, span, tree_block) comes from the
// caller, ops/gbdt_kernel.py::launch_plan, and is checked here.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_attr.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxDepth = 30;
constexpr int kMaxSharedLeafDepth = 8;   // deeper trees read their leaves in place
constexpr int kMaxSharedBytes = 232448;  // 227 KB, what one block may take on Hopper
constexpr int kChunkMultiple = 4;        // keeps each chunk's sources 16-byte aligned
constexpr int kMaxCluster = 8;           // the portable cluster size

// Odd, so 32 consecutive rows read one feature from 32 different banks.
__host__ __device__ inline int slab_stride(int F) { return F | 1; }

__host__ __device__ inline long long align16(long long bytes) { return (bytes + 15) & ~15LL; }

// Bytes of one stage: feat and thr of `chunk` trees, and their leaves when
// they live in shared memory.
__host__ __device__ inline long long stage_bytes(int chunk, int D) {
  return 2 * align16(4LL * chunk * D) +
         (D <= kMaxSharedLeafDepth ? align16(static_cast<long long>(chunk) << (D + 2)) : 0);
}

// Tree blocks that `trees` consecutive trees from a tree block's start touch:
// the most a chunk ends, and those of the forest.
__host__ __device__ inline int tree_blocks(int trees, int tree_block) {
  return (trees + tree_block - 1) / tree_block;
}

// The block's dynamic shared memory: the feature slab, the warps' partial
// sums of the tree blocks a chunk ends, a sum for every tree block of the
// forest and the stages. In 64 bits: the launcher checks it before the
// kernel sizes anything in int.
long long shared_bytes(int F, int D, int T, int rows, int groups, int chunk, int stages,
                       int tree_block) {
  return align16(4LL * rows * slab_stride(F)) +
         align16(4LL * rows * groups * tree_blocks(chunk, tree_block)) +
         align16(4LL * rows * tree_blocks(T, tree_block)) + stages * stage_bytes(chunk, D);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// n words from global to shared, asynchronously, shared among the block's
// threads: 16 bytes a copy when both ends are 16-byte aligned.
__device__ __forceinline__ void copy_async(void* dst, const void* src, int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const char* s = static_cast<const char*>(src);
  const uint32_t d = smem_addr(dst);
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | d) & 15) == 0) {
    const int n16 = n >> 2;
    for (int i = tid; i < n16; i += nt) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + 16 * i),
                   "l"(s + 16 * i)
                   : "memory");
    }
    done = n16 << 2;
  }
  for (int i = done + tid; i < n; i += nt) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d + 4 * i), "l"(s + 4 * i)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The D words of one tree's splits from shared memory: one broadcast load
// of 16 or 8 bytes where the depth allows, else D loads.
template <int kD>
__device__ __forceinline__ void load_splits(const int* p, int (&v)[kD]) {
  if constexpr (kD % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kD / 4; ++i) {
      const int4 q = reinterpret_cast<const int4*>(p)[i];
      v[4 * i] = q.x, v[4 * i + 1] = q.y, v[4 * i + 2] = q.z, v[4 * i + 3] = q.w;
    }
  } else if constexpr (kD % 2 == 0) {
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) {
      const int2 q = reinterpret_cast<const int2*>(p)[i];
      v[2 * i] = q.x, v[2 * i + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kD; ++i) v[i] = p[i];
  }
}

// kD in 1..8: the depth is known at compile time and a chunk's leaves come
// into shared memory with it. kD == 0: the depth D is read at run time and
// the leaves are read in place. kRows: rows a lane (rows == 32 * kRows).
template <int kD, int kRows>
__global__ void __launch_bounds__(kMaxThreads)
gbdt_forest_kernel(const float* __restrict__ x, const int* __restrict__ feat,
                   const float* __restrict__ thr, const float* __restrict__ leaves,
                   const float* __restrict__ bias, float* __restrict__ out, int B, int F,
                   int T, int D_rt, int rows, int groups, int chunk, int cluster, int span,
                   int tree_block) {
  constexpr bool kSharedLeaves = kD > 0;
  const int D = kD > 0 ? kD : D_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  const int xs = slab_stride(F);
  float* s_x = reinterpret_cast<float*>(smem);
  const int slab_bytes = static_cast<int>(align16(rows * xs * 4));
  // s_part[q][g][row]: warp g's partial of the q-th tree block this chunk ends.
  float* s_part = reinterpret_cast<float*>(smem + slab_bytes);
  const int part_bytes =
      static_cast<int>(align16(rows * groups * tree_blocks(chunk, tree_block) * 4));
  // s_tree[k][row]: the sum of the rank's k-th tree block; in the first rank
  // of a cluster, at the end, of the forest's k-th.
  const int n_forest_blocks = tree_blocks(T, tree_block);
  float* s_tree = reinterpret_cast<float*>(smem + slab_bytes + part_bytes);
  unsigned char* s_stage =
      smem + slab_bytes + part_bytes + static_cast<int>(align16(rows * n_forest_blocks * 4));
  const int split_bytes = static_cast<int>(align16(chunk * D * 4));
  const int stage = static_cast<int>(stage_bytes(chunk, D));

  const int tid = threadIdx.x;
  const int r = tid % 32;  // this thread's first row in the block
  const int g = tid / 32;  // its warp, which walks every groups-th tree
  // A cluster's blocks are consecutive in x: they share rows, each takes a
  // slice of the trees.
  const int rank = blockIdx.x % cluster;
  const int row0 = blockIdx.x / cluster * rows;
  const int n_rows = min(rows, B - row0);
  const int t_begin = min(T, rank * span);
  const int t_end = min(T, t_begin + span);
  const int n_chunks = (t_end - t_begin + chunk - 1) / chunk;

  auto fill = [&](int c) {
    const int t0 = t_begin + c * chunk;
    const int n = min(chunk, t_end - t0);
    unsigned char* st = s_stage + (c & 1) * stage;
    copy_async(st, feat + static_cast<size_t>(t0) * D, n * D);
    copy_async(st + split_bytes, thr + static_cast<size_t>(t0) * D, n * D);
    if (kSharedLeaves) {
      copy_async(st + 2 * split_bytes, leaves + (static_cast<size_t>(t0) << D), n << D);
    }
    cp_async_commit();
  };
  if (n_chunks > 0) fill(0);

  // The block's rows are one contiguous run of n_rows * F floats; word w
  // lands at row w / F, column w % F of the slab.
  {
    const float* xb = x + static_cast<size_t>(row0) * F;
    const int n = n_rows * F;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(xb) & 15) == 0) {
      const int n16 = n >> 2;
      for (int i = tid; i < n16; i += blockDim.x) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(xb) + i);
        const float vs[4] = {v.x, v.y, v.z, v.w};
        int row = (4 * i) / F, col = 4 * i - row * F;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s_x[row * xs + col] = vs[k];
          if (++col == F) col = 0, ++row;
        }
      }
      done = n16 << 2;
    }
    for (int w = done + tid; w < n; w += blockDim.x) {
      const int row = w / F;
      s_x[row * xs + (w - row * F)] = __ldg(xb + w);
    }
  }

  const unsigned char* xr[kRows];
  float acc[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    xr[k] = reinterpret_cast<const unsigned char*>(s_x + (r + 32 * k) * xs);
    acc[k] = 0.0f;
  }
  // A segment: the trees of one tree block inside one chunk.
  const int seg = min(tree_block, chunk);
  int n_tree = 0;  // tree blocks of this rank summed into s_tree
  // The sums of the `count` tree blocks whose partials are in s_part: their
  // partials added in order, one thread a (tree block, row). Runs between
  // two barriers that s_part's writes sit outside of.
  auto fold = [&](int count) {
    for (int i = tid; i < count * rows; i += blockDim.x) {
      const int q = i / rows, row = i - q * rows;
      const float* p = s_part + q * groups * rows + row;
      float sum = p[0];
#pragma unroll 16
      for (int k = 1; k < groups; ++k) sum += p[k * rows];
      s_tree[(n_tree + q) * rows + row] = sum;
    }
    n_tree += count;
  };
  int ended = 0;  // tree blocks the last chunk ended
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      fill(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    fold(ended);  // the last chunk's tree blocks, before this one writes s_part
    ended = 0;
    const int t0 = t_begin + c * chunk;
    const int n = min(chunk, t_end - t0);
    unsigned char* st = s_stage + (c & 1) * stage;
    // Once a chunk, each feature id becomes the byte offset of its feature in
    // a slab row, clamped so that a bad id can never read outside the row
    // (the Python side rejects such a forest before it gets here). A split
    // then costs one add for its address.
    int* s_feat = reinterpret_cast<int*>(st);
    for (int i = tid; i < n * D; i += blockDim.x) {
      s_feat[i] = min(static_cast<unsigned>(s_feat[i]), static_cast<unsigned>(F - 1)) * 4;
    }
    __syncthreads();
    const float* s_thr = reinterpret_cast<const float*>(st + split_bytes);
    for (int s0 = 0; s0 < n; s0 += seg) {
      const int s1 = min(n, s0 + seg);
      if constexpr (kSharedLeaves) {
        const float* s_leaves = reinterpret_cast<const float*>(st + 2 * split_bytes);
#pragma unroll 2
        for (int j = s0 + g; j < s1; j += groups) {
          int f[kD], tb[kD];
          load_splits<kD>(s_feat + j * kD, f);
          load_splits<kD>(reinterpret_cast<const int*>(s_thr) + j * kD, tb);
          int leaf[kRows] = {};
#pragma unroll
          for (int d = 0; d < kD; ++d) {
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
              const float v = *reinterpret_cast<const float*>(xr[k] + f[d]);
              leaf[k] |= static_cast<int>(v > __int_as_float(tb[d])) << d;
            }
          }
#pragma unroll
          for (int k = 0; k < kRows; ++k) acc[k] += s_leaves[(j << kD) + leaf[k]];
        }
      } else {
        const float* g_leaves = leaves + (static_cast<size_t>(t0) << D);
        for (int j = s0 + g; j < s1; j += groups) {
          const int* fj = s_feat + j * D;
          const float* tj = s_thr + j * D;
          int leaf[kRows] = {};
          for (int d = 0; d < D; ++d) {
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
              leaf[k] |= static_cast<int>(*reinterpret_cast<const float*>(xr[k] + fj[d]) > tj[d])
                         << d;
            }
          }
          const float* lj = g_leaves + (static_cast<size_t>(j) << D);
#pragma unroll
          for (int k = 0; k < kRows; ++k) acc[k] += __ldg(lj + leaf[k]);
        }
      }
      // A tree block ends at a multiple of `tree_block` trees past the
      // rank's first tree, or at its last tree: each warp hands over its
      // partial.
      if ((t0 + s1 - t_begin) % tree_block == 0 || t0 + s1 == t_end) {
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          s_part[(ended * groups + g) * rows + r + 32 * k] = acc[k];
          acc[k] = 0.0f;
        }
        ++ended;
      }
    }
    if (c + 2 < n_chunks) __syncthreads();  // this stage is refilled next
  }
  __syncthreads();
  if (cluster == 1 && n_forest_blocks == 1) {
    // One tree block (the serving forests): its partials added in order,
    // then the bias, as fold and the row's sum below would, in one pass,
    // without their barrier and second sweep: 4-8% of a 64 x 4 launch at
    // B = 1 to 4096 on an H100 (chip_smoke.forest_turns against a copy
    // without this branch).
    for (int row = tid; row < n_rows; row += blockDim.x) {
      float sum = s_part[row];
#pragma unroll 16
      for (int k = 1; k < groups; ++k) sum += s_part[k * rows + row];
      out[row0 + row] = sum + *bias;
    }
    return;
  }
  fold(ended);
  if (cluster > 1) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();  // every rank's tree block sums are in its shared memory
    if (rank == 0) {
      // The later ranks' tree block sums, copied in beside the first rank's
      // (independent loads, issued together), so that the row's sum below
      // adds them all from local shared memory.
      const int per_rank = span / tree_block;
      for (int i = n_tree * rows + tid; i < n_forest_blocks * rows; i += blockDim.x) {
        const int k = i / rows, row = i - k * rows;
        const int q = k / per_rank;
        s_tree[i] = cl.map_shared_rank(s_tree, q)[(k - q * per_rank) * rows + row];
      }
    }
    cl.sync();  // no block leaves while its sums are read
    if (rank != 0) return;
  } else {
    __syncthreads();  // every tree block's sum is in s_tree
  }
  // The row's sum: the forest's tree blocks in order, then the bias.
  for (int row = tid; row < n_rows; row += blockDim.x) {
    float sum = s_tree[row];
#pragma unroll 8
    for (int k = 1; k < n_forest_blocks; ++k) sum += s_tree[k * rows + row];
    out[row0 + row] = sum + *bias;
  }
}

template <int kD, int kRows>
int launch(const void* x, const void* feat, const void* thr, const void* leaves,
           const void* bias, void* out, int B, int F, int T, int D, int rows, int groups,
           int chunk, int cluster, int span, int tree_block, int smem, cudaStream_t stream) {
  // Once per depth variant and card: allow dynamic shared memory above 48 KB.
  static std::atomic<bool> smem_set[kMaxCards];
  const cudaError_t attr = smem_limit_on_current_card(
      smem_set, (const void*)gbdt_forest_kernel<kD, kRows>, kMaxSharedBytes);
  if (attr != cudaSuccess) {
    return static_cast<int>(attr);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B + rows - 1) / rows * cluster);
  cfg.blockDim = dim3(32 * groups);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute dims[1];
  dims[0].id = cudaLaunchAttributeClusterDimension;
  dims[0].val.clusterDim.x = cluster;
  dims[0].val.clusterDim.y = 1;
  dims[0].val.clusterDim.z = 1;
  cfg.attrs = dims;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, gbdt_forest_kernel<kD, kRows>, static_cast<const float*>(x),
      static_cast<const int*>(feat), static_cast<const float*>(thr),
      static_cast<const float*>(leaves),
      static_cast<const float*>(bias), static_cast<float*>(out), B, F, T, D, rows, groups, chunk,
      cluster, span, tree_block);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(): 0 when the
// launch was accepted. All pointers are device pointers: x [B, F] float32,
// feat [T, D] int32, thr [T, D] float32, leaves [T, 2^D] float32, bias [1]
// float32, out [B] float32, all contiguous. The plan: `rows` rows a block
// (32, or 64 for two rows a lane), `groups` warps a block (at most 32), one
// for each interleaved partial sum of a tree block of `tree_block` trees (a
// multiple of 4 and of groups), `cluster` blocks (1, 2, 4 or 8) sharing each
// set of rows, each taking `span` trees (T when cluster is 1, else a
// multiple of tree_block with cluster * span >= T), `chunk` trees a stage
// (span, or below it a multiple of 4 and of groups that divides tree_block
// or that tree_block divides: a ring of two stages then). Allocates nothing,
// does not sync.
extern "C" int gbdt_forest_launch(const void* x, const void* feat, const void* thr,
                                  const void* leaves, const void* bias, void* out, int B,
                                  int F, int T, int D, int rows, int groups, int chunk,
                                  int cluster, int span, int tree_block, void* stream) {
  if (B <= 0 || F <= 0 || T <= 0 || D < 1 || D > kMaxDepth || (rows != 32 && rows != 64) ||
      groups <= 0 || 32 * groups > kMaxThreads || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0 || tree_block <= 0 || tree_block % kChunkMultiple != 0 ||
      tree_block % groups != 0 ||
      (cluster == 1 ? span != T
                    : span % tree_block != 0 || static_cast<long long>(span) * cluster < T) ||
      chunk <= 0 || chunk > span ||
      (chunk < span && (chunk % kChunkMultiple != 0 || chunk % groups != 0 ||
                        (chunk % tree_block != 0 && tree_block % chunk != 0))) ||
      (B + rows - 1) / rows > (1 << 30) / cluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem =
      shared_bytes(F, D, T, rows, groups, chunk, chunk < span ? 2 : 1, tree_block);
  if (smem > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D * 2 + (rows == 64)) {
#define GBDT_CASE(d, k)                                                                      \
  case d * 2 + (k - 1):                                                                      \
    return launch<d, k>(x, feat, thr, leaves, bias, out, B, F, T, D, rows, groups, chunk, \
                        cluster, span, tree_block, static_cast<int>(smem), st);
#define GBDT_DEPTH(d) GBDT_CASE(d, 1) GBDT_CASE(d, 2)
    GBDT_DEPTH(1) GBDT_DEPTH(2) GBDT_DEPTH(3) GBDT_DEPTH(4)
    GBDT_DEPTH(5) GBDT_DEPTH(6) GBDT_DEPTH(7) GBDT_DEPTH(8)
#undef GBDT_DEPTH
#undef GBDT_CASE
    default:
      return rows == 64
                 ? launch<0, 2>(x, feat, thr, leaves, bias, out, B, F, T, D, rows, groups, chunk,
                                cluster, span, tree_block, static_cast<int>(smem), st)
                 : launch<0, 1>(x, feat, thr, leaves, bias, out, B, F, T, D, rows, groups, chunk,
                                cluster, span, tree_block, static_cast<int>(smem), st);
  }
}
