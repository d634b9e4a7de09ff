// Multiresolution hash-grid encode, backward: the table gradient of V
// tables from V point sets and the output cotangent.
//
// Replaces the TPU kernels of lidar4d_tpu/ops/hash_onehot.py:
//   _bwd_kernel_fact          (through _bwd_call_fact: hash_encode_onehot_fact,
//                              the static hash and the hashed static plane)
//   _bwd_kernel_fact_grouped  (through _folded_table_bwd: hash_encode_folded,
//                              the flow grid, and hash_encode_fact_multi_folded,
//                              variant 0 of the dynamic sweep)
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
// What bounds it: the atomics, then bytes. Per point and level it reads
// d + F floats and issues 2^d * F additions into a level of at most 2^11
// rows at the flagship widths, so neighbouring samples of a ray hit the
// same rows and global atomics would serialise on them. The design: one
// block owns one level of one variant for a run of kPoints points; when the
// level's [rows, F] slice fits kSmemFloats it accumulates in shared memory
// (shared-memory atomics) and adds its nonzero entries to the global
// gradient once at the end; a level too large for shared memory (only
// dense levels of large specs) adds to the global gradient directly. Each
// thread walks kRun consecutive points (neighbouring samples of one ray)
// and keeps each corner's sum in registers while that corner's row stays
// the same, adding it to the accumulator only when the row changes: at the
// coarse levels, where many samples share a cell, most points cost no
// atomic at all.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 256;
constexpr int kRun = 8;                 // consecutive points per thread
constexpr int kPoints = kThreads * kRun;
constexpr int kSmemFloats = 16384;     // 64 KB: one 2^11 x 8 level

template <int F>
__device__ __forceinline__ void load_cot(const float* __restrict__ p, float (&v)[F]) {
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int j = 0; j < F / 4; ++j) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p) + j);
      v[4 * j + 0] = q.x;
      v[4 * j + 1] = q.y;
      v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    }
  } else if constexpr (F == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int j = 0; j < F; ++j) v[j] = __ldg(p + j);
  }
}

// Add a corner's sums to row `row` of the shared-memory accumulator
// (`shared`) or of the level's global gradient `dlev`.
template <int F>
__device__ __forceinline__ void add_row(float* __restrict__ dlev, bool shared, uint32_t row,
                                        const float (&sums)[F]) {
  if (shared) {
    extern __shared__ float acc[];
#pragma unroll
    for (int f = 0; f < F; ++f) atomicAdd(acc + row * F + f, sums[f]);
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) atomicAdd(dlev + (long long)row * F + f, sums[f]);
  }
}

// grid: (point runs, levels, variants). levels: [L] int4 = (resolution,
// rows, row offset, dense flag). dtab must be zeroed by the caller.
template <int D, int F>
__global__ void __launch_bounds__(kThreads)
hash_grid_bwd_kernel(const float* __restrict__ x, const float* __restrict__ cot,
                     const int4* __restrict__ levels, float* __restrict__ dtab, int n,
                     int n_levels, long long rows) {
  extern __shared__ float acc[];
  const int l = blockIdx.y;
  const int v = blockIdx.z;
  const int4 lev = levels[l];
  const int res = lev.x;
  const int level_floats = lev.y * F;
  const bool shared = level_floats <= kSmemFloats;
  float* __restrict__ dlev = dtab + ((long long)v * rows + lev.z) * F;

  if (shared) {
    for (int k = threadIdx.x; k < level_floats; k += kThreads) acc[k] = 0.f;
    __syncthreads();
  }

  constexpr int kCorners = 1 << D;
  uint32_t corner_rows[kCorners];
  float sums[kCorners][F];
  const int first = blockIdx.x * kPoints + threadIdx.x * kRun;
  const int last = min(first + kRun, n);
  for (int i = first; i < last; ++i) {
    const long long pt = (long long)v * n + i;
    float g[F];
    load_cot<F>(cot + pt * (long long)(n_levels * F) + l * F, g);
    int x0[D];
    float fr[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float pos = __ldg(x + pt * D + k) * (float)res;
      const float f0 = floorf(pos);
      fr[k] = pos - f0;
      x0[k] = (int)f0;
    }
#pragma unroll
    for (int c = 0; c < kCorners; ++c) {
      uint32_t cp[D];
      float w = 1.f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const int b = (c >> k) & 1;
        cp[k] = (uint32_t)min(max(x0[k] + b, 0), res);
        w = w * (b ? fr[k] : 1.f - fr[k]);
      }
      uint32_t row;
      if (lev.w) {
        const uint32_t stride = (uint32_t)res + 1u;
        row = cp[0];
        if constexpr (D > 1) row += cp[1] * stride;
        if constexpr (D > 2) row += cp[2] * stride * stride;
      } else {
        uint32_t h = cp[0];
        if constexpr (D > 1) h ^= cp[1] * 2654435761u;
        if constexpr (D > 2) h ^= cp[2] * 805459861u;
        row = h & (uint32_t)(lev.y - 1);
      }
      if (i == first || row != corner_rows[c]) {
        if (i != first) add_row<F>(dlev, shared, corner_rows[c], sums[c]);
        corner_rows[c] = row;
#pragma unroll
        for (int f = 0; f < F; ++f) sums[c][f] = 0.f;
      }
#pragma unroll
      for (int f = 0; f < F; ++f) sums[c][f] += w * g[f];
    }
  }
  if (first < last) {
#pragma unroll
    for (int c = 0; c < kCorners; ++c) add_row<F>(dlev, shared, corner_rows[c], sums[c]);
  }

  if (shared) {
    __syncthreads();
    for (int k = threadIdx.x; k < level_floats; k += kThreads) {
      const float a = acc[k];
      if (a != 0.f) atomicAdd(dlev + k, a);
    }
  }
}

template <int D, int F>
cudaError_t launch(const float* x, const float* cot, const int4* levels, float* dtab,
                   int n_variants, int n, int n_levels, long long rows, int smem_floats,
                   cudaStream_t stream) {
  const size_t smem = (size_t)smem_floats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hash_grid_bwd_kernel<D, F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((n + kPoints - 1) / kPoints, n_levels, n_variants);
  hash_grid_bwd_kernel<D, F><<<grid, kThreads, smem, stream>>>(x, cot, levels, dtab, n,
                                                               n_levels, rows);
  return cudaGetLastError();
}

}  // namespace

// x [V', N, D] f32, cot [V', N, L*F] f32 (16-byte aligned), levels [L, 4]
// int32, dtab [>= V, rows, F] f32 zeroed; only the first V = n_variants
// variants of x and cot are read. smem_floats: the largest level slice
// rows_l * F that is <= 16384 (0 if none); levels above it add to dtab
// directly. Returns a cudaError_t (0 = launched).
extern "C" int lidar4d_hash_grid_bwd(const void* x, const void* cot, const void* levels,
                                     void* dtab, int n_variants, int n, int n_levels,
                                     int n_dims, int n_features, long long rows,
                                     int smem_floats, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_variants < 1 || n_variants > 65535 ||
      smem_floats < 0 || smem_floats > kSmemFloats)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(cot);
  const int4* lp = static_cast<const int4*>(levels);
  float* dp = static_cast<float*>(dtab);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LIDAR4D_HASH_CASE(DD, FF)                                                        \
  if (n_dims == DD && n_features == FF)                                                  \
    return (int)launch<DD, FF>(xp, cp, lp, dp, n_variants, n, n_levels, rows, smem_floats, \
                               s);
  LIDAR4D_HASH_CASE(2, 1)
  LIDAR4D_HASH_CASE(2, 2)
  LIDAR4D_HASH_CASE(2, 4)
  LIDAR4D_HASH_CASE(2, 8)
  LIDAR4D_HASH_CASE(3, 1)
  LIDAR4D_HASH_CASE(3, 2)
  LIDAR4D_HASH_CASE(3, 4)
  LIDAR4D_HASH_CASE(3, 8)
#undef LIDAR4D_HASH_CASE
  return (int)cudaErrorInvalidValue;
}
