// Multiresolution hash-grid encode, forward, for V tables and V point sets.
//
// Replaces the TPU kernels of lidar4d_tpu/ops/hash_onehot.py:
//   _fwd_kernel              (through _fwd_call: hash_encode_onehot, the
//                             classic route at the table's own F)
//   _fwd_kernel_fact_gather  (reached through _fwd_call_fact and
//                             _fwd_call_fact_grouped)
//   _fwd_kernel_fact_grouped (the one-hot fallback tiling of the same call)
// i.e. hash_encode_onehot_fact (static hash, hashed static plane),
// hash_encode_folded (flow grid) and hash_encode_fact_multi_folded (the
// three-variant dynamic sweep). On the TPU those kernels read corner rows
// and weights that XLA precomputed into [L, 2^d, N] arrays and replaced the
// row gather with a one-hot matmul. Here a thread computes one point's
// corner rows and weights from x itself, bit-identical to
// lidar4d_tpu/ops/hash_enc.py::_level_indices (uint32 products with the
// primes (1, 2654435761, 805459861), xor, & (size - 1); dense levels
// strided by res + 1), and gathers the [rows, F] rows directly.
//
// What bounds it on the H100: bytes, d floats read and L * F written a
// point (204 B a point for the static hash; 0.103 ms a flagship fact train
// step and 1.64 ms a 16,384-ray render chunk at 3.35 TB/s). The first design
// (one thread a point walking all L levels, 128 threads a block, rows
// gathered through L1) took 0.461 ms a fact step and 7.9 ms a render chunk:
// a warp's lanes stored 16-byte pieces L * F floats apart, the folded
// tables of the three dynamic-plane variants (3 x 96 KB) did not fit L1,
// and neither did the static hash's six 64 KB levels.
//
// This design has two paths; the wrapper picks one a call
// (ops/hash_onehot.py::hash_fwd_launch):
// - The tile path. A thread still owns a point (its corner rows and weights
//   computed once an axis, not once a corner) but writes its outputs to a
//   [256 points, L * F] tile in shared memory; the block then stores the
//   tile, contiguous in the output, with 16-byte stores that neighbouring
//   threads make to neighbouring addresses, so device memory sees whole
//   lines. Where the variant's whole table fits beside the tile (the
//   folded dynamic planes, 48-96 KB; the folded flow grid, 64 KB), a block
//   of a persistent grid first stages it in shared memory (one
//   cp.async.bulk copy a level, completed on an mbarrier) and gathers from
//   there. Where it does not (the static hash, 384 KB; the classic route's
//   F = 8 tables), rows are gathered through L1, and the launch asks for no
//   more shared memory than the resident blocks' tiles need, so that 96 KB
//   of each SM's unified memory stay L1: with the driver's choice (shared
//   memory for four 53 KB tiles, ~40 KB of L1) the static hash took 1.3x
//   longer.
// - The gather path, the first design's launch (128 threads a block, one
//   point a thread, rows through L1, each thread storing its own outputs)
//   as a kernel instance of its own, for calls that cannot spread a block's
//   fixed costs (fewer than 65,536 points: the flow loss's clouds) and for
//   a spec whose point output is one 32-byte sector written by 16-byte
//   stores already (the hashed static plane, L = 1, F = 8).
// Both paths load a level's 2^D corner rows before summing them, in corner
// order, so the sums are those of the first design.
//
// Tables over the L2 (the reference configuration's static hash, 67 MB, and
// flow grid, 60 MB; ops/hash_onehot.py::tables_over_l2) are bound by the
// L2's rate of sector requests: 786,432 points x 8 levels x 8 corners, a
// 32-byte sector each, ~50 M requests a reference step's call, which the
// static hash's 0.326 ms serves at ~150 G a second. They take the tile path
// through L1 with at least 512 threads an SM resident: the flow grid's
// 272-byte output rows made a 70 KB tile a 256-point block, and beside
// 96 KB of L1 one block an SM kept too few gathers in flight (0.576 ms a
// step's call, 2.210 a 3,145,728-point render call; two blocks: 0.385 and
// 1.516, NVIDIA H100 80GB HBM3 at 700 W, scripts/kernels_bench.py). A
// level-major route (a grid of point blocks x level groups, so that the
// blocks in flight gather from one level's slice while it stays in the L2)
// was built and timed against them: 0.431 ms static, 0.507 flow. It cuts
// device-memory traffic, which is not their bound, and runs one level after
// another where the tile path overlaps the coarse levels' L1 hits with the
// fine levels' L2 requests; it is not kept.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_async.cuh"

namespace {

constexpr int kMaxLevels = 16;
constexpr int kMaxThreads = 512;       // HASH_FWD_MAX_THREADS in ops/hash_onehot.py
constexpr int kGatherThreads = 128;    // HASH_FWD_GATHER_THREADS
constexpr int kSmemLimit = 227 * 1024;

// Floats a point takes in the output tile for k levels of F features: k * F
// rounded up to 4, plus 4 where that is a multiple of 8, so that the
// 16-byte stores of eight neighbouring threads hit distinct banks
// (hash_fwd_tile_pitch in ops/hash_onehot.py).
__host__ __device__ inline int tile_pitch(int levels, int features) {
  const int w = (levels * features + 3) & ~3;
  return w % 8 == 0 ? w + 4 : w;
}

template <int F, bool kShared>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float (&v)[F]) {
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int j = 0; j < F / 4; ++j) {
      const float4 q = kShared ? reinterpret_cast<const float4*>(p)[j]
                               : __ldg(reinterpret_cast<const float4*>(p) + j);
      v[4 * j + 0] = q.x;
      v[4 * j + 1] = q.y;
      v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    }
  } else if constexpr (F == 2) {
    const float2 q = kShared ? *reinterpret_cast<const float2*>(p)
                             : __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int j = 0; j < F; ++j) v[j] = kShared ? p[j] : __ldg(p + j);
  }
}

// A point's F outputs of one level to p: shared memory (the tile) or global
// memory, each F % 4 == 0 row as 16-byte stores. The global stores are
// explicit vector stores (st.global.v4.f32): written as float4 assignments,
// the gather path's compiled to four 4-byte stores each and ran 3x longer.
template <int F, bool kGlobal>
__device__ __forceinline__ void store_row(float* __restrict__ p, const float (&v)[F]) {
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int j = 0; j < F / 4; ++j) {
      if constexpr (kGlobal)
        asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p + 4 * j),
                     "f"(v[4 * j]), "f"(v[4 * j + 1]), "f"(v[4 * j + 2]), "f"(v[4 * j + 3])
                     : "memory");
      else
        reinterpret_cast<float4*>(p)[j] =
            make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    }
  } else if constexpr (F == 2) {
    if constexpr (kGlobal)
      asm volatile("st.global.v2.f32 [%0], {%1, %2};\n" ::"l"(p), "f"(v[0]), "f"(v[1])
                   : "memory");
    else reinterpret_cast<float2*>(p)[0] = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int j = 0; j < F; ++j) p[j] = v[j];
  }
}

// One level's F outputs of a point at x: the 2^D corner rows of table t
// (the level's rows, in shared memory when kShared) weighted and summed in
// corner order. lev = (resolution, rows, row offset, dense flag). Every
// corner's row is loaded before the first is summed, so that all 2^D loads
// are in flight at once (summed as each arrived, the gather path's
// compiler issued them in three or four dependent rounds).
template <int D, int F, bool kShared>
__device__ __forceinline__ void encode_level(const float (&x)[D], int4 lev,
                                             const float* __restrict__ t, float (&acc)[F]) {
  constexpr int kCorners = 1 << D;
  const int res = lev.x;
  const bool dense = lev.w != 0;
  uint32_t h[D][2];                    // per axis: lower / upper corner's row term
  float wt[D][2];                      // per axis: lower / upper corner's weight
  uint32_t stride = 1u;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float pos = x[k] * (float)res;
    const float f0 = floorf(pos);
    const int x0 = (int)f0;
    const float fr = pos - f0;
    const uint32_t m = dense ? stride : (k == 0 ? 1u : k == 1 ? 2654435761u : 805459861u);
    h[k][0] = (uint32_t)min(max(x0, 0), res) * m;
    h[k][1] = (uint32_t)min(max(x0 + 1, 0), res) * m;
    wt[k][0] = 1.f - fr;
    wt[k][1] = fr;
    stride *= (uint32_t)res + 1u;
  }
  const uint32_t mask = (uint32_t)(lev.y - 1);
  float g[kCorners][F];
  float w[kCorners];
#pragma unroll
  for (int c = 0; c < kCorners; ++c) {
    w[c] = 1.f;
    uint32_t row = h[0][c & 1];
#pragma unroll
    for (int k = 0; k < D; ++k) w[c] = w[c] * wt[k][(c >> k) & 1];
#pragma unroll
    for (int k = 1; k < D; ++k) row = dense ? row + h[k][(c >> k) & 1] : row ^ h[k][(c >> k) & 1];
    if (!dense) row &= mask;
    load_row<F, kShared>(t + (size_t)row * F, g[c]);
  }
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.f;
#pragma unroll
  for (int c = 0; c < kCorners; ++c) {
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += w[c] * g[c][f];
  }
}

// grid: (point blocks, variants), blockDim.x threads, one point of a tile
// each. Block b takes the `run` tiles of blockDim.x points from point
// b * run * blockDim.x. table_floats > 0: the block first copies the
// variant's table to shared memory (each level at a multiple of 4 floats,
// in order; table_floats in all) and gathers from there, else it gathers
// through L1. tile: the block stages each tile's outputs in shared memory
// (after the table) and stores them contiguously, else each thread stores
// its own point's outputs. kGather: the gather path's instance (no table,
// no tile, at most kGatherThreads threads), compiled without either and
// launched with the driver's own shared-memory configuration.
template <int D, int F, bool kGather>
__global__ void __launch_bounds__(kGather ? kGatherThreads : kMaxThreads)
hash_grid_fwd_kernel(const float* __restrict__ x, const float* __restrict__ tables,
                     const int4* __restrict__ levels, float* __restrict__ out, int n,
                     int n_levels, long long rows, int run, int table_floats, bool tile_out) {
  extern __shared__ __align__(128) float smem[];
  __shared__ int4 lv[kMaxLevels];
  __shared__ int soff[kMaxLevels];
  __shared__ __align__(8) uint64_t bar;
  const bool staged = !kGather && table_floats > 0;
  const bool tile = !kGather && tile_out;
  const int v = blockIdx.y;
  const int threads = blockDim.x;
  const float* __restrict__ tab = tables + (long long)v * rows * F;
  float* __restrict__ stage = smem + table_floats;      // the output tile
  const int pitch = tile_pitch(n_levels, F);

  if (threadIdx.x < n_levels) lv[threadIdx.x] = levels[threadIdx.x];
  __syncthreads();
  if (staged) {
    // A level whose rows start 16-byte aligned goes by one bulk copy, the
    // others float by float.
    auto bulk = [&](int l) {
      return (reinterpret_cast<uintptr_t>(tab + (long long)lv[l].z * F) & 15) == 0 &&
             (lv[l].y * F) % 4 == 0;
    };
    if (threadIdx.x == 0) {
      int off = 0;
      uint32_t bytes = 0;
      for (int l = 0; l < n_levels; ++l) {
        soff[l] = off;
        off += (lv[l].y * F + 3) & ~3;
        if (bulk(l)) bytes += (uint32_t)lv[l].y * F * 4u;
      }
      mbar_init(&bar);
      mbar_arrive_expect_tx(&bar, bytes);
      for (int l = 0; l < n_levels; ++l)
        if (bulk(l))
          bulk_load(smem + soff[l], tab + (long long)lv[l].z * F, (uint32_t)lv[l].y * F * 4u,
                    &bar);
    }
    __syncthreads();
    for (int l = 0; l < n_levels; ++l) {
      if (bulk(l)) continue;
      const float* src = tab + (long long)lv[l].z * F;
      for (int k = threadIdx.x; k < lv[l].y * F; k += threads) smem[soff[l] + k] = __ldg(src + k);
    }
    mbar_wait(&bar, 0);
    __syncthreads();
  }

  const int lf = n_levels * F;
  const float* __restrict__ xv = x + (long long)v * n * D;
  float* __restrict__ ov = out + (long long)v * n * lf;
  const bool vec = lf % 4 == 0 && (reinterpret_cast<uintptr_t>(ov) & 15) == 0;
  for (int r = 0; r < run; ++r) {
    const long long pt0 = ((long long)blockIdx.x * run + r) * threads;
    if (pt0 >= n) break;
    const int cnt = (int)min((long long)threads, n - pt0);
    if ((int)threadIdx.x < cnt) {
      float xin[D];
#pragma unroll
      for (int k = 0; k < D; ++k) xin[k] = __ldg(xv + (pt0 + threadIdx.x) * D + k);
      for (int l = 0; l < n_levels; ++l) {
        float acc[F];
        if (staged) encode_level<D, F, true>(xin, lv[l], smem + soff[l], acc);
        else encode_level<D, F, false>(xin, lv[l], tab + (long long)lv[l].z * F, acc);
        if (tile) store_row<F, false>(stage + threadIdx.x * pitch + l * F, acc);
        else store_row<F, true>(ov + (pt0 + threadIdx.x) * lf + l * F, acc);
      }
    }
    if (!tile) continue;
    __syncthreads();
    // The tile to the output, whose cnt * L * F floats are contiguous there:
    // neighbouring threads store neighbouring 16-byte pieces.
    if (vec) {
      const int q = lf / 4;
      for (int k = threadIdx.x; k < cnt * q; k += threads) {
        const int i = k / q;
        const int j = k - i * q;
        reinterpret_cast<float4*>(ov + (pt0 + i) * lf)[j] =
            *reinterpret_cast<const float4*>(stage + i * pitch + 4 * j);
      }
    } else {
      for (int k = threadIdx.x; k < cnt * lf; k += threads) {
        const int i = k / lf;
        const int j = k - i * lf;
        ov[(pt0 + i) * lf + j] = stage[i * pitch + j];
      }
    }
    __syncthreads();
  }
}

// The dynamic shared memory of a launch, and the share of the SM's unified
// L1 / shared memory (percent) to configure as shared memory: a launch that
// gathers through L1 asks for no more than its resident blocks need, so that
// the rest stays L1.
template <int D, int F, bool kGather>
cudaError_t set_smem(int smem_floats, int carveout) {
  if (kGather) return cudaSuccess;
  const size_t smem = (size_t)smem_floats * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(hash_grid_fwd_kernel<D, F, kGather>,
                                       cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
  if (e != cudaSuccess || smem <= 48 * 1024) return e;
  return cudaFuncSetAttribute(hash_grid_fwd_kernel<D, F, kGather>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Dynamic shared memory: the staged table and, with `tile`, the output tile.
int smem_floats(int table_floats, int n_levels, int features, int threads, int tile) {
  return table_floats + (tile ? threads * tile_pitch(n_levels, features) : 0);
}

template <int D, int F, bool kGather>
cudaError_t launch(const float* x, const float* tables, const int4* levels, float* out,
                   int n_variants, int n, int n_levels, long long rows, int table_floats,
                   int threads, int tile, int carveout, int run, cudaStream_t stream) {
  const int smem = smem_floats(table_floats, n_levels, F, threads, tile);
  const cudaError_t e = set_smem<D, F, kGather>(smem, carveout);
  if (e != cudaSuccess) return e;
  const long long per_block = (long long)threads * run;
  const dim3 grid((unsigned)((n + per_block - 1) / per_block), n_variants);
  hash_grid_fwd_kernel<D, F, kGather><<<grid, threads, (size_t)smem * sizeof(float), stream>>>(
      x, tables, levels, out, n, n_levels, rows, run, table_floats, tile != 0);
  return cudaGetLastError();
}

template <int D, int F, bool kGather>
int blocks_per_sm(int smem, int threads, int carveout) {
  if (set_smem<D, F, kGather>(smem, carveout) != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, hash_grid_fwd_kernel<D, F, kGather>, threads,
          (size_t)smem * sizeof(float)) != cudaSuccess)
    return -1;
  return blocks;
}

bool valid_shape(int n_dims, int n_levels, int n_features, int table_floats, int threads,
                 int tile, int carveout) {
  return (n_dims == 2 || n_dims == 3) && n_levels >= 1 && n_levels <= kMaxLevels &&
         carveout >= -1 && carveout <= 100 &&
         (n_features == 1 || n_features == 2 || n_features == 4 || n_features == 8) &&
         threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 && table_floats >= 0 &&
         table_floats % 4 == 0 &&
         (long long)smem_floats(table_floats, n_levels, n_features, threads, tile) * 4 <=
             kSmemLimit;
}

}  // namespace

#define LIDAR4D_HASH_DISPATCH(EXPR)                                  \
  switch (n_dims * 10 + n_features) {                                \
    case 21: { constexpr int DD = 2, FF = 1; return EXPR; }          \
    case 22: { constexpr int DD = 2, FF = 2; return EXPR; }          \
    case 24: { constexpr int DD = 2, FF = 4; return EXPR; }          \
    case 28: { constexpr int DD = 2, FF = 8; return EXPR; }          \
    case 31: { constexpr int DD = 3, FF = 1; return EXPR; }          \
    case 32: { constexpr int DD = 3, FF = 2; return EXPR; }          \
    case 34: { constexpr int DD = 3, FF = 4; return EXPR; }          \
    case 38: { constexpr int DD = 3, FF = 8; return EXPR; }          \
  }

// x [V, N, D] f32, tables [V, rows, F] f32 (16-byte aligned), levels [L, 4]
// int32, out [V, N, L*F] f32 (16-byte aligned). table_floats: 0 to gather
// through L1, else the floats of a variant's table staged in shared memory,
// each level rounded up to 4 (see hash_fwd_launch in ops/hash_onehot.py).
// threads: points a tile (a multiple of 32, at most 512). tile: stage the
// outputs in shared memory. Table and tile together at most 227 KB.
// carveout: the SM's shared-memory share in percent (-1: the driver's
// choice). run: tiles a block takes (the grid has ceil(N / (threads * run))
// blocks per variant). Returns a cudaError_t (0 = launched).
extern "C" int lidar4d_hash_grid_fwd(const void* x, const void* tables, const void* levels,
                                     void* out, int n_variants, int n, int n_levels,
                                     int n_dims, int n_features, long long rows,
                                     int table_floats, int threads, int tile, int carveout,
                                     int run, void* stream) {
  if (n_variants < 1 || n_variants > 65535 || run < 1 ||
      !valid_shape(n_dims, n_levels, n_features, table_floats, threads, tile, carveout))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const float* xp = static_cast<const float*>(x);
  const float* tp = static_cast<const float*>(tables);
  const int4* lp = static_cast<const int4*>(levels);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_floats == 0 && !tile) {
    if (threads > kGatherThreads) return (int)cudaErrorInvalidValue;
    LIDAR4D_HASH_DISPATCH((int)(launch<DD, FF, true>(xp, tp, lp, op, n_variants, n, n_levels,
                                                     rows, 0, threads, 0, carveout, run, s)))
  }
  LIDAR4D_HASH_DISPATCH((int)(launch<DD, FF, false>(xp, tp, lp, op, n_variants, n, n_levels,
                                                    rows, table_floats, threads, tile, carveout,
                                                    run, s)))
  return (int)cudaErrorInvalidValue;
}

// Resident blocks of the kernel per SM for this launch (the wrapper sizes
// the grid from it); -1 on an error.
extern "C" int lidar4d_hash_grid_fwd_blocks_per_sm(int n_dims, int n_levels, int n_features,
                                                   int table_floats, int threads, int tile,
                                                   int carveout) {
  if (!valid_shape(n_dims, n_levels, n_features, table_floats, threads, tile, carveout))
    return -1;
  if (table_floats == 0 && !tile) {
    if (threads > kGatherThreads) return -1;
    LIDAR4D_HASH_DISPATCH((blocks_per_sm<DD, FF, true>(0, threads, carveout)))
  }
  LIDAR4D_HASH_DISPATCH((blocks_per_sm<DD, FF, false>(
      smem_floats(table_floats, n_levels, FF, threads, tile), threads, carveout)))
  return -1;
}
#undef LIDAR4D_HASH_DISPATCH
