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
// each thread takes one point of one table in exact float32.
//
// What bounds it: the atomics. All N points of a table land on W <= 256
// columns, so global atomics would serialise on a few addresses. The
// design: one block owns one table for a run of kPoints points and
// accumulates its [C, W] gradient (8 KB at C = 8, W = 256) in shared memory,
// then adds it to the global gradient once. Each thread walks kRun
// consecutive points (neighbouring samples of one ray), sums their
// contributions in registers while they stay on the same column pair, and
// adds the sums to shared memory only when the column changes, so most
// points cost no atomic at all. dx is written directly, one float per point,
// from the cotangent row (read as float4 vectors) and the two table columns
// (cached reads).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;                        // consecutive points per thread
constexpr int kPoints = kThreads * kRun;        // points per block

template <int C>
__device__ __forceinline__ void flush(float* acc, int width, int j0, const float (&a0)[C],
                                      const float (&a1)[C]) {
  const int j1 = min(j0 + 1, width - 1);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    atomicAdd(acc + c * width + j0, a0[c]);
    atomicAdd(acc + c * width + j1, a1[c]);
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
plane_linear_bwd_kernel(const float* __restrict__ grid, const float* __restrict__ x,
                        const float* __restrict__ cot, float* __restrict__ dgrid,
                        float* __restrict__ dx, int n, int width, int lead) {
  extern __shared__ float acc[];   // [C, width]
  const int p = blockIdx.y;
  const bool want_dx = p >= lead;
  for (int k = threadIdx.x; k < C * width; k += kThreads) acc[k] = 0.f;
  __syncthreads();

  const float* __restrict__ g = grid + (long long)p * C * width;
  const int first = blockIdx.x * kPoints + threadIdx.x * kRun;
  const int last = min(first + kRun, n);
  int cur = -1;                    // the column j0 that a0 / a1 belong to
  float a0[C], a1[C];
  for (int i = first; i < last; ++i) {
    const long long pt = (long long)p * n + i;
    const float xv = __ldg(x + pt);
    const float u = fminf(fmaxf(xv, 0.f), 1.f) * (float)(width - 1);
    const int j0 = min(max((int)floorf(u), 0), width - 1);
    const int j1 = min(j0 + 1, width - 1);
    const float f = u - (float)j0;
    float cv[C];
    const float4* __restrict__ cp = reinterpret_cast<const float4*>(cot + pt * C);
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const float4 v = __ldg(cp + q);
      cv[4 * q + 0] = v.x;
      cv[4 * q + 1] = v.y;
      cv[4 * q + 2] = v.z;
      cv[4 * q + 3] = v.w;
    }
    if (j0 != cur) {
      if (cur >= 0) flush<C>(acc, width, cur, a0, a1);
      cur = j0;
#pragma unroll
      for (int c = 0; c < C; ++c) a0[c] = a1[c] = 0.f;
    }
    float d = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      a0[c] += (1.f - f) * cv[c];
      a1[c] += f * cv[c];
      if (want_dx) d += cv[c] * (__ldg(g + c * width + j1) - __ldg(g + c * width + j0));
    }
    const bool in_range = xv >= 0.f && xv <= 1.f;
    dx[pt] = (want_dx && in_range) ? d * (float)(width - 1) : 0.f;
  }
  if (cur >= 0) flush<C>(acc, width, cur, a0, a1);

  __syncthreads();
  float* __restrict__ dg = dgrid + (long long)p * C * width;
  for (int k = threadIdx.x; k < C * width; k += kThreads) {
    const float a = acc[k];
    if (a != 0.f) atomicAdd(dg + k, a);
  }
}

template <int C>
cudaError_t launch(const float* grid, const float* x, const float* cot, float* dgrid,
                   float* dx, int n_planes, int n, int width, int lead, cudaStream_t stream) {
  const size_t smem = (size_t)C * width * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        plane_linear_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 blocks((n + kPoints - 1) / kPoints, n_planes);
  plane_linear_bwd_kernel<C><<<blocks, kThreads, smem, stream>>>(grid, x, cot, dgrid, dx, n,
                                                                 width, lead);
  return cudaGetLastError();
}

}  // namespace

// grid [P, C, W] f32, x [P, N] f32, cot [P, N, C] f32 (16-byte aligned),
// dgrid [P, C, W] f32 zeroed, dx [P, N] f32 (every entry written). C must be
// 4, 8 or 16 and C * W at most 57344 (the shared-memory accumulator).
// Returns a cudaError_t (0 = launched).
extern "C" int lidar4d_plane_linear_bwd(const void* grid, const void* x, const void* cot,
                                        void* dgrid, void* dx, int n_planes, int n,
                                        int channels, int width, int lead, void* stream) {
  if (n_planes < 1 || n_planes > 65535 || width < 1 || (long long)channels * width > 57344)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const float* gp = static_cast<const float*>(grid);
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(cot);
  float* dgp = static_cast<float*>(dgrid);
  float* dxp = static_cast<float*>(dx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels == 4) return (int)launch<4>(gp, xp, cp, dgp, dxp, n_planes, n, width, lead, s);
  if (channels == 8) return (int)launch<8>(gp, xp, cp, dgp, dxp, n_planes, n, width, lead, s);
  if (channels == 16) return (int)launch<16>(gp, xp, cp, dgp, dxp, n_planes, n, width, lead, s);
  return (int)cudaErrorInvalidValue;
}
