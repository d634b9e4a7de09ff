// Multiresolution hash-grid encode, backward: the table gradient of V
// tables from V point sets and the output cotangent.
//
// Replaces the TPU kernels of lidar4d_tpu/ops/hash_onehot.py:
//   _bwd_kernel       (through _bwd_call: hash_encode_onehot, the classic
//                      route at the table's own F)
//   _bwd_kernel_fact  (through _bwd_call_fact: hash_encode_onehot_fact,
//                      the static hash and the hashed static plane)
//   _bwd_kernel_fact_grouped  (through _folded_table_bwd: hash_encode_folded,
//                      the flow grid, and hash_encode_fact_multi_folded,
//                      variant 0 of the dynamic sweep)
// i.e. dT_l[r, f] = sum_n sum_c w[l, c, n] * [idx[l, c, n] == r] * cot[n, l*F + f].
// On the TPU this was a bf16 one-hot matmul over corner rows and weights
// that XLA had written to [L, 2^d, N] arrays. Here the corner rows and
// weights are recomputed from x in registers, bit-identical to
// hash_grid_fwd.cu (uint32 products with the primes (1, 2654435761,
// 805459861), xor, & (size - 1); dense levels strided by res + 1), and the
// weighted cotangent is scattered with float32 atomics. The caller scatters
// only the first `n_variants` variants (the multi-variant sweep trains
// variant 0 alone).
//
// What bounds it on the H100: the shared-memory atomics. Per point and
// level it reads d + F floats and issues 2^d * F additions into a level of
// 2^11 rows at the flagship widths (0.064 ms of bytes a fact step against
// 100 M additions for the static hash's fine call alone). The first design
// (one thread per point, all F features, 2,048 points a block, the level's
// slice added to global memory by every block) took 3.240 ms a fact step
// and 6.656 a classic one: 124 registers left 16 warps resident per SM;
// for a fixed feature the 32 lanes of a warp hit rows * F + f, only 32 / F
// banks, so each shared atomic replayed up to F-way; and the 128 blocks of a
// level each added its whole 16,384-float slice to global memory.
//
// This design takes 0.85 ms a fact step and 1.23 a classic one (NVIDIA
// H100 80GB HBM3 at 700 W, scripts/bwd_kernels_bench.py); it is still
// bound by the shared atomics, which compile to compare-and-swap loops
// (ATOMS.CAST.SPIN), not native adds:
// - A group of F lanes takes one point, lane f its feature f: a lane keeps
//   the 2^d corner sums of one feature (64 registers at D = 3, F = 8, so 32
//   warps are resident per SM instead of 16), the lanes of a group hit F
//   consecutive banks, and a group reads its point's F cotangent floats of
//   the level as one contiguous segment.
// - Each group walks `run` consecutive points (neighbouring samples of a
//   ray) and keeps each corner's sum while that corner's row stays the
//   same, adding it to the accumulator only when the row changes; the next
//   point's x and cotangent are loaded while the current one is scattered.
//   A warp's groups sit `run` points apart along the rays, so they rarely
//   add to the same row at once.
// - The grid is sized to the card (the wrapper computes `run` from the SM
//   count and the occupancy for two resident waves), so a level is
//   accumulated by a few blocks per SM instead of one per 2,048 points, and
//   each block adds its slice to the global gradient once, as one bulk
//   reduction (cp.reduce.async.bulk) that the memory system performs,
//   instead of 16,384 atomics. One wave: 3% slower; four: within 1%; a
//   minimum run of 16 points instead of 4: 12% slower.
// - A level too large for shared memory adds to the global gradient
//   directly.
//
// Large tables (the reference configuration's static hash, flow grid and
// xy planes: 2^15-2^19 rows a level, none of which fits even 227 KB of
// shared memory) add every level to the global gradient, and there the L2's
// rate of reductions bounds the kernel, not bytes: each kept corner sum is
// one reduction of a row in the L2. A reference step's static call makes
// 41.3 M of them (786,432 points x 8 levels x 8 corners, less the run
// merges), its flow call 22.8 M rows of 32 bytes, its xy call 20.2 M
// (scripts/kernels_bench.py --cases reference counts them). The lane route,
// F scalar reductions a row from F lanes, took 1.018, 0.687 and 0.408 ms
// there. The design for them:
// - The vector route (F = 4 or 8, 16-byte aligned rows): lane j of a
//   point's group owns kOwn (corner, 4-feature chunk) units (2 at D = 3, 1
//   at D = 2), reads its chunk of the cotangent as one 16-byte load and adds
//   each unit's 4 sums with one red.global.add.v4.f32: a quarter of the
//   reductions at F = 4, half at F = 8.
// - Level-major where the gradient is over the L2 (67 MB static, 60 MB
//   flow; ops/hash_onehot.py::hash_bwd_launch): each level's grid is two
//   resident waves of the card on its own, so the blocks in flight add to
//   one level's 8 MB slice while it stays in the L2. The xy planes' 4.2 MB
//   stay in the L2 anyway; their levels run at once (0.275 ms, level-major
//   0.295).
// Static 0.658 ms, flow 0.579 (NVIDIA H100 80GB HBM3 at 700 W, against the
// lane route in turns): 63 and 79 G reductions a second. Each lever alone,
// static: vector over all levels at once 0.963, scalar level-major 0.746.
// Summing the lanes of a warp that add to one row first (__match_any_sync
// and shuffles) gained nothing (0.692 against 0.686: a warp's groups sit
// `run` points apart, so few share a row) and is not kept.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Hopper's bulk asynchronous reduction (the non-tensor TMA path) of the
// shared-memory accumulator into global memory, as inline PTX for sm_90.
// Every address and size given to a bulk operation must be a multiple of 16
// bytes.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Orders this thread's generic-proxy writes to shared memory before later
// bulk operations (async proxy) that read it. Every writing thread runs it,
// then __syncthreads(), then one thread issues the bulk operation.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// dst[k] += src[k] (float32) for `bytes` / 4 floats: global += shared, the
// additions done by the memory system. The issuing thread must call
// bulk_wait_read() before the block exits.
__device__ __forceinline__ void bulk_reduce_add(float* dst, const float* src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until every bulk operation this thread committed has read its source.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// dst[0:n] += src[0:n] for a global `dst` and a shared `src` whose addresses
// agree modulo 16 bytes: the aligned middle as one bulk reduction (issued by
// thread 0), the ragged head and tail (< 4 floats each) by atomics. Every
// thread of the block calls it after fence_proxy_async() and __syncthreads().
__device__ __forceinline__ void reduce_to_global(float* dst, const float* src, int n) {
  const int head = min((int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / 4, n);
  const int mid = (n - head) & ~3;
  if (threadIdx.x < head) atomicAdd(dst + threadIdx.x, src[threadIdx.x]);
  const int t = head + mid + (int)threadIdx.x - 4;
  if (threadIdx.x >= 4 && threadIdx.x < 8 && t < n) atomicAdd(dst + t, src[t]);
  if (threadIdx.x == 0 && mid > 0) {
    bulk_reduce_add(dst + head, src + head, (uint32_t)mid * 4u);
    bulk_wait_read();
  }
}

constexpr int kMaxLevels = 16;
constexpr int kThreads = 512;          // HASH_BWD_THREADS in ops/hash_onehot.py
constexpr int kMinBlocks = 2;          // launch bound: at most 64 registers a thread
constexpr int kSmemFloats = 16384;     // 64 KB: one 2^11 x 8 level

// The row of corner c (bit k = upper neighbour along axis k) of the cell at
// x0, for a level of resolution res: dense levels strided by res + 1, hashed
// ones with the NGP primes, as hash_grid_fwd.cu computes it.
template <int D>
__device__ __forceinline__ uint32_t corner_row(const int (&x0)[D], int c, int res, int size,
                                               bool dense) {
  uint32_t cp[D];
#pragma unroll
  for (int k = 0; k < D; ++k) cp[k] = (uint32_t)min(max(x0[k] + ((c >> k) & 1), 0), res);
  if (dense) {
    const uint32_t stride = (uint32_t)res + 1u;
    uint32_t row = cp[0];
    if constexpr (D > 1) row += cp[1] * stride;
    if constexpr (D > 2) row += cp[2] * stride * stride;
    return row;
  }
  uint32_t h = cp[0];
  if constexpr (D > 1) h ^= cp[1] * 2654435761u;
  if constexpr (D > 2) h ^= cp[2] * 805459861u;
  return h & (uint32_t)(size - 1);
}

// grid: (point chunks, levels, variants). Block b's group g (F lanes) takes
// points [(b * groups + g) * run, ... + run). levels: [L] int4 = (resolution,
// rows, row offset, dense flag). dtab must be zeroed by the caller. Dynamic
// shared memory: smem_floats + 4 floats.
template <int D, int F>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
hash_grid_bwd_kernel(const float* __restrict__ x, const float* __restrict__ cot,
                     const int4* __restrict__ levels, float* __restrict__ dtab, int n,
                     int n_levels, long long rows, int run, int smem_floats) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kCorners = 1 << D;
  constexpr int kGroups = kThreads / F;
  const int l = blockIdx.y;
  const int v = blockIdx.z;
  const int4 lev = levels[l];
  const int res = lev.x;
  const bool dense = lev.w != 0;
  const int level_floats = lev.y * F;
  const bool shared = level_floats <= smem_floats;
  float* __restrict__ dlev = dtab + ((long long)v * rows + lev.z) * F;
  // The accumulator starts at the same address modulo 16 bytes as dlev, so
  // that the final bulk reduction finds both ends aligned.
  float* __restrict__ acc = smem + ((reinterpret_cast<uintptr_t>(dlev) >> 2) & 3);
  const int f = threadIdx.x % F;
  if (shared) {
    for (int k = threadIdx.x; k < level_floats; k += kThreads) acc[k] = 0.f;
    __syncthreads();
  }
  // shared is uniform over the block, so the branch costs no divergence, and
  // the shared-memory pointer stays visible to the compiler as such.
  auto add = [&](uint32_t row, float s) {
    if (shared) atomicAdd(acc + row * F + f, s);
    else atomicAdd(dlev + (size_t)row * F + f, s);
  };

  const long long first = ((long long)blockIdx.x * kGroups + threadIdx.x / F) * run;
  const long long last = min(first + run, (long long)n);
  const float* __restrict__ xv = x + (long long)v * n * D;
  const long long cstride = (long long)n_levels * F;
  const float* __restrict__ cv = cot + (long long)v * n * cstride + l * F + f;

  uint32_t corner_rows[kCorners];
  float sums[kCorners];
  float px[D], pg = 0.f;
  if (first < last) {
#pragma unroll
    for (int k = 0; k < D; ++k) px[k] = __ldg(xv + first * D + k);
    pg = __ldg(cv + first * cstride);
  }
  for (long long i = first; i < last; ++i) {
    int x0[D];
    float fr[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float pos = px[k] * (float)res;
      const float f0 = floorf(pos);
      fr[k] = pos - f0;
      x0[k] = (int)f0;
    }
    const float g = pg;
    if (i + 1 < last) {                // the next point's loads overlap this one's scatter
#pragma unroll
      for (int k = 0; k < D; ++k) px[k] = __ldg(xv + (i + 1) * D + k);
      pg = __ldg(cv + (i + 1) * cstride);
    }
#pragma unroll
    for (int c = 0; c < kCorners; ++c) {
      float w = 1.f;
#pragma unroll
      for (int k = 0; k < D; ++k) w = w * (((c >> k) & 1) ? fr[k] : 1.f - fr[k]);
      const uint32_t row = corner_row<D>(x0, c, res, lev.y, dense);
      if (i == first || row != corner_rows[c]) {
        if (i != first) add(corner_rows[c], sums[c]);
        corner_rows[c] = row;
        sums[c] = 0.f;
      }
      sums[c] += w * g;
    }
  }
  if (first < last) {
#pragma unroll
    for (int c = 0; c < kCorners; ++c) add(corner_rows[c], sums[c]);
  }

  if (shared) {
    fence_proxy_async();
    __syncthreads();
    reduce_to_global(dlev, acc, level_floats);
  }
}

// dst[0:4] += v as one vector reduction in the L2 (sm_90's
// red.global.add.v4.f32, through the float4 overload of atomicAdd). dst
// must be 16-byte aligned.
__device__ __forceinline__ void red_add4(float* dst, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(dst), v);
}

// The vector route, for levels that all add to global memory at F = 4 or 8
// (16-byte aligned rows). A group of F lanes still takes `run` consecutive
// points, but lane j owns kOwn (corner, 4-feature chunk) units of each point
// instead of one feature of all 2^D corners: it computes only its corners'
// rows and weights, reads its chunk of the cotangent as one 16-byte load,
// keeps each unit's 4 sums while the unit's row stays the same, and adds
// them with one vector reduction when it changes, where the lane route
// issues F scalar reductions a row from F lanes. grid: (point chunks,
// levels, variants) as the lane route's.
template <int D, int F>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
hash_grid_bwd_vec_kernel(const float* __restrict__ x, const float* __restrict__ cot,
                         const int4* __restrict__ levels, float* __restrict__ dtab, int n,
                         int n_levels, long long rows, int run) {
  constexpr int kCorners = 1 << D;
  constexpr int kChunks = F / 4;
  constexpr int kOwn = kCorners * kChunks / F;   // units a lane owns: 2 at D = 3, 1 at D = 2
  constexpr int kGroups = kThreads / F;
  constexpr uint32_t kNone = 0xffffffffu;        // no row (rows are < 2^24)
  static_assert(F % 4 == 0 && kOwn >= 1 && kOwn <= kCorners, "vector route shape");
  const int l = blockIdx.y;
  const int v = blockIdx.z;
  const int4 lev = levels[l];
  const int res = lev.x;
  const bool dense = lev.w != 0;
  const int j = threadIdx.x % F;
  const int chunk = j * kOwn / kCorners;         // the lane's units share one chunk
  const int c0 = j * kOwn % kCorners;
  float* __restrict__ dlev = dtab + ((long long)v * rows + lev.z) * F + chunk * 4;
  const long long first = ((long long)blockIdx.x * kGroups + threadIdx.x / F) * run;
  const float* __restrict__ xv = x + (long long)v * n * D;
  const long long cstride = (long long)n_levels * F;
  const float* __restrict__ cv = cot + (long long)v * n * cstride + l * F + chunk * 4;

  uint32_t cur[kOwn];
  float4 sums[kOwn];
#pragma unroll
  for (int u = 0; u < kOwn; ++u) {
    cur[u] = kNone;
    sums[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float px[D];
  float4 pg = make_float4(0.f, 0.f, 0.f, 0.f);
  if (first < n) {
#pragma unroll
    for (int k = 0; k < D; ++k) px[k] = __ldg(xv + first * D + k);
    pg = __ldg(reinterpret_cast<const float4*>(cv + first * cstride));
  }
  for (int r = 0; r < run && first + r < n; ++r) {
    const long long i = first + r;
    int x0[D];
    float fr[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float pos = px[k] * (float)res;
      const float f0 = floorf(pos);
      fr[k] = pos - f0;
      x0[k] = (int)f0;
    }
    const float4 g = pg;
    if (r + 1 < run && i + 1 < n) {      // the next point's loads overlap this one's scatter
#pragma unroll
      for (int k = 0; k < D; ++k) px[k] = __ldg(xv + (i + 1) * D + k);
      pg = __ldg(reinterpret_cast<const float4*>(cv + (i + 1) * cstride));
    }
#pragma unroll
    for (int u = 0; u < kOwn; ++u) {
      const int c = c0 + u;
      float w = 1.f;
#pragma unroll
      for (int k = 0; k < D; ++k) w = w * (((c >> k) & 1) ? fr[k] : 1.f - fr[k]);
      const uint32_t row = corner_row<D>(x0, c, res, lev.y, dense);
      if (row != cur[u]) {
        if (cur[u] != kNone) red_add4(dlev + (size_t)cur[u] * F, sums[u]);
        cur[u] = row;
        sums[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      sums[u] = make_float4(sums[u].x + w * g.x, sums[u].y + w * g.y, sums[u].z + w * g.z,
                            sums[u].w + w * g.w);
    }
  }
#pragma unroll
  for (int u = 0; u < kOwn; ++u)
    if (cur[u] != kNone) red_add4(dlev + (size_t)cur[u] * F, sums[u]);
}

template <int D, int F>
cudaError_t set_smem(int smem_floats) {
  const size_t smem = (size_t)(smem_floats + 4) * sizeof(float);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(hash_grid_bwd_kernel<D, F>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

dim3 grid_of(int n, int n_features, int run, int n_levels, int n_variants) {
  const long long per_block = (long long)(kThreads / n_features) * run;
  return dim3((unsigned)((n + per_block - 1) / per_block), n_levels, n_variants);
}

template <int D, int F>
cudaError_t launch(const float* x, const float* cot, const int4* levels, float* dtab,
                   int n_variants, int n, int n_levels, long long rows, int run,
                   int smem_floats, cudaStream_t stream) {
  const cudaError_t e = set_smem<D, F>(smem_floats);
  if (e != cudaSuccess) return e;
  hash_grid_bwd_kernel<D, F><<<grid_of(n, F, run, n_levels, n_variants), kThreads,
                               (smem_floats + 4) * sizeof(float), stream>>>(
      x, cot, levels, dtab, n, n_levels, rows, run, smem_floats);
  return cudaGetLastError();
}

template <int D, int F>
cudaError_t launch_vec(const float* x, const float* cot, const int4* levels, float* dtab,
                       int n_variants, int n, int n_levels, long long rows, int run,
                       cudaStream_t stream) {
  hash_grid_bwd_vec_kernel<D, F>
      <<<grid_of(n, F, run, n_levels, n_variants), kThreads, 0, stream>>>(
          x, cot, levels, dtab, n, n_levels, rows, run);
  return cudaGetLastError();
}

template <int D, int F>
int blocks_per_sm(int smem_floats) {
  if (set_smem<D, F>(smem_floats) != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, hash_grid_bwd_kernel<D, F>, kThreads,
          (smem_floats + 4) * sizeof(float)) != cudaSuccess)
    return -1;
  return blocks;
}

template <int D, int F>
int blocks_per_sm_vec() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, hash_grid_bwd_vec_kernel<D, F>, kThreads, 0) != cudaSuccess)
    return -1;
  return blocks;
}

bool valid_shape(int n_dims, int n_features) {
  return (n_dims == 2 || n_dims == 3) &&
         (n_features == 1 || n_features == 2 || n_features == 4 || n_features == 8);
}

// The routes of lidar4d_hash_grid_bwd (HASH_BWD_ROUTES in ops/hash_onehot.py).
enum Route { kLanes = 0, kVector = 1 };

// The vector route takes F = 4 or 8, every level in global memory, and a
// 16-byte aligned cotangent and gradient.
bool valid_route(int route, int n_features, int smem_floats, const void* cot,
                 const void* dtab) {
  if (route == kLanes) return true;
  return route == kVector && (n_features == 4 || n_features == 8) && smem_floats == 0 &&
         (reinterpret_cast<uintptr_t>(cot) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(dtab) & 15) == 0;
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

#define LIDAR4D_HASH_VEC_DISPATCH(EXPR)                              \
  switch (n_dims * 10 + n_features) {                                \
    case 24: { constexpr int DD = 2, FF = 4; return EXPR; }          \
    case 28: { constexpr int DD = 2, FF = 8; return EXPR; }          \
    case 34: { constexpr int DD = 3, FF = 4; return EXPR; }          \
    case 38: { constexpr int DD = 3, FF = 8; return EXPR; }          \
  }

// x [V', N, D] f32, cot [V', N, L*F] f32, levels [L, 4] int32, dtab
// [>= V, rows, F] f32 zeroed (16-byte aligned); only the first V =
// n_variants variants of x and cot are read. run: consecutive points a
// group of F lanes takes (the grid has ceil(N / (512 / F * run)) blocks per
// level and variant). smem_floats: the largest level slice rows_l * F that
// is <= 16384 (0 if none); levels above it add to dtab directly. route:
// kLanes (lane f of a group adds feature f, in shared memory or global),
// kVector (16-byte vector reductions into global memory; F = 4 or 8,
// smem_floats = 0, cot 16-byte aligned). Returns a
// cudaError_t (0 = launched).
extern "C" int lidar4d_hash_grid_bwd(const void* x, const void* cot, const void* levels,
                                     void* dtab, int n_variants, int n, int n_levels,
                                     int n_dims, int n_features, long long rows, int run,
                                     int smem_floats, int route, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_variants < 1 || n_variants > 65535 ||
      smem_floats < 0 || smem_floats > kSmemFloats || run < 1 ||
      !valid_shape(n_dims, n_features) || !valid_route(route, n_features, smem_floats, cot, dtab))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(cot);
  const int4* lp = static_cast<const int4*>(levels);
  float* dp = static_cast<float*>(dtab);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kVector)
    LIDAR4D_HASH_VEC_DISPATCH((int)(launch_vec<DD, FF>(xp, cp, lp, dp, n_variants, n, n_levels,
                                                       rows, run, s)))
  LIDAR4D_HASH_DISPATCH((int)(launch<DD, FF>(xp, cp, lp, dp, n_variants, n, n_levels, rows,
                                             run, smem_floats, s)))
  return (int)cudaErrorInvalidValue;
}

// Resident blocks of the kernel per SM for this shape, accumulator and
// route (the wrapper sizes the grid from it); -1 on an error.
extern "C" int lidar4d_hash_grid_bwd_blocks_per_sm(int n_dims, int n_features,
                                                   int smem_floats, int route) {
  if (smem_floats < 0 || smem_floats > kSmemFloats || !valid_shape(n_dims, n_features) ||
      !valid_route(route, n_features, smem_floats, nullptr, nullptr))
    return -1;
  if (route == kVector) LIDAR4D_HASH_VEC_DISPATCH((blocks_per_sm_vec<DD, FF>()))
  LIDAR4D_HASH_DISPATCH((blocks_per_sm<DD, FF>(smem_floats)))
  return -1;
}
#undef LIDAR4D_HASH_VEC_DISPATCH
#undef LIDAR4D_HASH_DISPATCH
