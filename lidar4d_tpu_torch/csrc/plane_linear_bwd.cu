// 1-D linear interpolation of P feature tables at P coordinate sets,
// backward: the table gradient, and the coordinate gradient of the tables
// from `lead` on.
//
// Replaces lidar4d_tpu/ops/plane_onehot.py::_lin_bwd_kernel (through
// _lin_vjp_bwd, i.e. plane_linear(coord_grad_lead=...)): the time-collapsed
// dynamic K-planes, grid [9, 8, S] for three flow-warp variants x three
// axes, where lead = 3 planes (the unwarped variant) need no coordinate
// gradient. With u = clip(x, 0, 1) * (W - 1), j0 = floor(u),
// j1 = min(j0 + 1, W - 1), f = u - j0:
//   dG[p, c, j0] += (1 - f) cot[p, n, c],  dG[p, c, j1] += f cot[p, n, c]
//   dx[p, n] = (W - 1) [0 <= x <= 1] sum_c cot[p, n, c] (G[p, c, j1] - G[p, c, j0])
// for p >= lead, and dx = 0 (no work) for p < lead. The TPU kernel built the
// tent one-hot and its derivative and contracted them as bf16 matmuls; here
// the sums are exact float32.
//
// What bounds it on the H100: bytes. Per point it reads 1 + C floats and
// writes one, 0.169 ms a flagship train step at 3.35 TB/s. The first design
// (each thread walking 16 points with all C channels, one block per 4,096
// points) took 0.740 ms a step: every point was a dependent chain (x, then
// the grid columns, then C shared atomics on a column change), few bytes
// were in flight, the grid ran 1.09 waves at 262,144 points, and both the
// cotangent rows and dx were read and written at a stride of 16 points.
//
// This design, 0.41 ms a step (NVIDIA H100 80GB HBM3 at 700 W,
// scripts/bwd_kernels_bench.py; 2.0-2.6x the byte bound at 262,144 points):
// - A group of C lanes takes `run` consecutive points of one table, lane c
//   its channel c. The group reads a point's C cotangent floats as one
//   contiguous segment and x as C consecutive floats, C points at a time,
//   all issued before any is used, so every warp keeps C + 1 loads in
//   flight. x reaches the group's lanes by shuffles.
// - A lane keeps the two column sums of its channel while the points stay
//   on the same column pair, and adds them to a [W][C] shared-memory
//   gradient only when the column changes: the group's lanes hit C
//   consecutive banks.
// - dx: each lane forms its channel's term of each of the C points, and a
//   reduce-scatter over the group (C - 1 shuffles) leaves point i's sum on
//   lane i, so the group stores C consecutive dx floats at once. The table
//   is read from a [W][C] copy in shared memory where the copy fits beside
//   the gradient (through L1 instead: 20% slower), else through L1.
// - The grid is sized to the card (the wrapper computes `run` from the SM
//   count and the occupancy): one resident wave, no tail, and each block
//   adds its [C, W] gradient to the global one once (2 or 4 waves: 4-8%
//   slower).
// Tried and not kept, each within 2% of this design: loading the next
// chunk while the current one is scattered; one bulk reduction
// (cp.reduce.async.bulk) per block instead of the flush's atomics; handing
// the shared column's sum on across a one-column step instead of adding it.
// A ring of cotangent tiles staged by cp.async.bulk, with one thread per
// 9-point run, took twice the first design's time.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;           // LIN_BWD_THREADS in ops/plane_onehot.py
constexpr int kSmemLimit = 227 * 1024;

// Dynamic shared memory: the [W][C] gradient, and the [W][C] table copy if
// `copy` (the wrapper takes the copy whenever both fit kSmemLimit).
long long smem_bytes(int channels, int width, bool copy) {
  return (copy ? 2LL : 1LL) * channels * width * 4;
}

// v[i] summed over the C lanes of the group, left on lane i (lane = c):
// recursive halving, C - 1 shuffles.
template <int C>
__device__ __forceinline__ float reduce_scatter(float (&v)[C], unsigned mask, int c) {
#pragma unroll
  for (int o = C / 2; o >= 1; o /= 2) {
    const bool upper = (c & o) != 0;
#pragma unroll
    for (int k = 0; k < o; ++k) {
      const float send = upper ? v[k] : v[k + o];
      const float keep = upper ? v[k + o] : v[k];
      v[k] = keep + __shfl_xor_sync(mask, send, o, C);
    }
  }
  return v[0];
}

// grid: (point chunks, tables). Block b's group g (C lanes) takes points
// [(b * groups + g) * run, ... + run) of table blockIdx.y.
template <int C, bool kCopy>
__global__ void __launch_bounds__(kThreads)
plane_linear_bwd_kernel(const float* __restrict__ grid, const float* __restrict__ x,
                        const float* __restrict__ cot, float* __restrict__ dgrid,
                        float* __restrict__ dx, int n, int width, int lead, int run) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kGroups = kThreads / C;
  const int p = blockIdx.y;
  const bool want_dx = p >= lead;
  const int c = threadIdx.x % C;
  const unsigned group = ((1u << C) - 1u) << ((threadIdx.x & 31) & ~(C - 1));
  const float* __restrict__ g = grid + (long long)p * C * width;
  float* __restrict__ dg = dgrid + (long long)p * C * width;
  float* const acc = smem;                 // [width][C]
  float* const gs = smem + C * width;      // [width][C] copy of the table if kCopy

  for (int k = threadIdx.x; k < C * width; k += kThreads) {
    acc[k] = 0.f;
    if (kCopy && want_dx) gs[k] = __ldg(g + (k % C) * width + k / C);
  }
  __syncthreads();
  auto table = [&](int j) { return kCopy ? gs[j * C + c] : __ldg(g + c * width + j); };
  auto add = [&](int j0, float s0, float s1) {
    atomicAdd(acc + j0 * C + c, s0);
    atomicAdd(acc + min(j0 + 1, width - 1) * C + c, s1);
  };

  const long long first = ((long long)blockIdx.x * kGroups + threadIdx.x / C) * run;
  const long long last = min(first + run, (long long)n);
  const float* __restrict__ xp = x + (long long)p * n;
  const float* __restrict__ cp = cot + (long long)p * n * C + c;
  float* __restrict__ dxp = dx + (long long)p * n;
  const float scale = (float)(width - 1);

  int cur = -1;                           // the column j0 that a0 / a1 belong to
  float a0 = 0.f, a1 = 0.f;
  for (long long base = first; base < last; base += C) {
    const int cnt = (int)min((long long)C, last - base);     // uniform over the group
    const float xq = c < cnt ? __ldg(xp + base + c) : 0.f;
    float cv[C];
#pragma unroll
    for (int i = 0; i < C; ++i) cv[i] = i < cnt ? __ldg(cp + (base + i) * C) : 0.f;
    float d[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const float xv = __shfl_sync(group, xq, i, C);
      d[i] = 0.f;
      if (i < cnt) {
        const float u = fminf(fmaxf(xv, 0.f), 1.f) * scale;
        const int j0 = min(max((int)floorf(u), 0), width - 1);
        const float f = u - (float)j0;
        if (j0 != cur) {
          if (cur >= 0) add(cur, a0, a1);
          cur = j0;
          a0 = a1 = 0.f;
        }
        a0 += (1.f - f) * cv[i];
        a1 += f * cv[i];
        if (want_dx && xv >= 0.f && xv <= 1.f)
          d[i] = cv[i] * (table(min(j0 + 1, width - 1)) - table(j0));
      }
    }
    const float dsum = want_dx ? reduce_scatter<C>(d, group, c) * scale : 0.f;
    if (c < cnt) dxp[base + c] = dsum;
  }
  if (cur >= 0) add(cur, a0, a1);

  __syncthreads();
  for (int k = threadIdx.x; k < C * width; k += kThreads) {
    const int cc = k / width;
    const float a = acc[(k - cc * width) * C + cc];
    if (a != 0.f) atomicAdd(dg + k, a);
  }
}

template <int C, bool kCopy>
cudaError_t set_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(plane_linear_bwd_kernel<C, kCopy>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int C, bool kCopy>
cudaError_t launch(const float* grid, const float* x, const float* cot, float* dgrid,
                   float* dx, int n_planes, int n, int width, int lead, int run,
                   cudaStream_t stream) {
  const size_t smem = (size_t)smem_bytes(C, width, kCopy);
  const cudaError_t e = set_smem<C, kCopy>(smem);
  if (e != cudaSuccess) return e;
  const long long per_block = (long long)(kThreads / C) * run;
  const dim3 blocks((unsigned)((n + per_block - 1) / per_block), n_planes);
  plane_linear_bwd_kernel<C, kCopy><<<blocks, kThreads, smem, stream>>>(
      grid, x, cot, dgrid, dx, n, width, lead, run);
  return cudaGetLastError();
}

template <int C, bool kCopy>
int blocks_per_sm(int width) {
  const size_t smem = (size_t)smem_bytes(C, width, kCopy);
  if (set_smem<C, kCopy>(smem) != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, plane_linear_bwd_kernel<C, kCopy>, kThreads, smem) != cudaSuccess)
    return -1;
  return blocks;
}

bool valid_shape(int channels, int width, int copy) {
  return (channels == 4 || channels == 8 || channels == 16) && width >= 1 &&
         (long long)channels * width <= 57344 &&
         smem_bytes(channels, width, copy != 0) <= kSmemLimit;
}

}  // namespace

#define LIDAR4D_LIN_DISPATCH(EXPR)                                              \
  switch (channels * 2 + (copy ? 1 : 0)) {                                      \
    case 8: { constexpr int CC = 4; constexpr bool CP = false; return EXPR; }   \
    case 9: { constexpr int CC = 4; constexpr bool CP = true; return EXPR; }    \
    case 16: { constexpr int CC = 8; constexpr bool CP = false; return EXPR; }  \
    case 17: { constexpr int CC = 8; constexpr bool CP = true; return EXPR; }   \
    case 32: { constexpr int CC = 16; constexpr bool CP = false; return EXPR; } \
    case 33: { constexpr int CC = 16; constexpr bool CP = true; return EXPR; }  \
  }

// grid [P, C, W] f32, x [P, N] f32, cot [P, N, C] f32, dgrid [P, C, W] f32
// zeroed, dx [P, N] f32 (every entry written). C must be 4, 8 or 16 and
// C * W at most 57344 (the [W][C] gradient in shared memory). run:
// consecutive points a group of C lanes takes (the grid has
// ceil(N / (256 / C * run)) blocks per table). copy: read G from a [W][C]
// copy in shared memory (2 * C * W floats in all, at most 227 KB), else
// through L1. Returns a cudaError_t (0 = launched).
extern "C" int lidar4d_plane_linear_bwd(const void* grid, const void* x, const void* cot,
                                        void* dgrid, void* dx, int n_planes, int n,
                                        int channels, int width, int lead, int run,
                                        int copy, void* stream) {
  if (n_planes < 1 || n_planes > 65535 || run < 1 || !valid_shape(channels, width, copy))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const float* gp = static_cast<const float*>(grid);
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(cot);
  float* dgp = static_cast<float*>(dgrid);
  float* dxp = static_cast<float*>(dx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LIDAR4D_LIN_DISPATCH((int)(launch<CC, CP>(gp, xp, cp, dgp, dxp, n_planes, n, width, lead,
                                            run, s)))
  return (int)cudaErrorInvalidValue;
}

// Resident blocks of the kernel per SM for C channels and W columns, with
// or without the table copy (the wrapper sizes the grid from it); -1 on an
// error.
extern "C" int lidar4d_plane_linear_bwd_blocks_per_sm(int channels, int width, int copy) {
  if (!valid_shape(channels, width, copy)) return -1;
  LIDAR4D_LIN_DISPATCH((blocks_per_sm<CC, CP>(width)))
  return -1;
}
#undef LIDAR4D_LIN_DISPATCH
