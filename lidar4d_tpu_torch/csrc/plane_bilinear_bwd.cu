// Bilinear sample of P feature planes at P point sets, backward: the plane
// gradient only (the point gradient is zero by contract).
//
// Replaces lidar4d_tpu/ops/plane_onehot.py::_bwd_kernel_tables (through
// _vjp_bwd_tables, i.e. plane_bilinear(coord_grad=False)): the dense static
// K-planes at scales 32/64/128, whose lookup points are ray positions. On
// the TPU the kernel contracted the weighted 2-hot vectors with the
// cotangent as a bf16 matmul per channel. Here a thread recomputes each
// point's four corners and weights with the align_corners=True /
// border-clamp arithmetic of plane_bilinear_fwd.cu and adds w * cot[p, c, n]
// to the four corner pixels of every channel:
//   dG[p, c, y, x] = sum_n tent(v_n - y) tent(u_n - x) cot[p, c, n].
//
// What bounds it: the atomics. Per point it reads 2 + C floats and issues
// 4 * C additions, and the samples of a ray fall on the same few pixels.
// The design: one block owns one plane for a run of kPoints points; when
// the plane's C * H * W floats fit kSmemFloats (the 32^2 scale at C = 8) it
// accumulates in shared memory and adds the nonzero pixels to the global
// gradient once at the end; a larger plane adds to the global gradient
// directly. Each thread walks kRun consecutive points (neighbouring samples
// of one ray) and keeps the sums of the current 2x2 pixel cell in registers,
// adding them to the accumulator only when the cell changes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;                       // consecutive points per thread
constexpr int kPoints = kThreads * kRun;
constexpr int kSmemFloats = 12288;             // 48 KB

// Add the four corner sums of a cell (offsets o[4]) for every channel.
template <int C>
__device__ __forceinline__ void add_cell(float* __restrict__ dg, bool shared, int plane,
                                         const int (&o)[4], const float (&sums)[4][C]) {
  extern __shared__ float acc[];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (shared) {
        atomicAdd(acc + c * plane + o[k], sums[k][c]);
      } else {
        atomicAdd(dg + (long long)c * plane + o[k], sums[k][c]);
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
plane_bilinear_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ cot,
                          float* __restrict__ dgrid, int n, int height, int width) {
  extern __shared__ float acc[];
  const int p = blockIdx.y;
  const int plane = height * width;
  const bool shared = (long long)plane * C <= kSmemFloats;
  float* __restrict__ dg = dgrid + (long long)p * C * plane;

  if (shared) {
    for (int k = threadIdx.x; k < plane * C; k += kThreads) acc[k] = 0.f;
    __syncthreads();
  }

  const int first = blockIdx.x * kPoints + threadIdx.x * kRun;
  const int last = min(first + kRun, n);
  int cell = -1;                     // y0 * width + x0 of the cell the sums belong to
  int o[4];
  float sums[4][C];
  for (int i = first; i < last; ++i) {
    const float2 pt = __ldg(reinterpret_cast<const float2*>(pts) + (long long)p * n + i);
    const float x = fminf(fmaxf(pt.x, 0.f), 1.f) * (float)(width - 1);
    const float y = fminf(fmaxf(pt.y, 0.f), 1.f) * (float)(height - 1);
    const float x0 = floorf(x);
    const float y0 = floorf(y);
    const float tx = x - x0;
    const float ty = y - y0;
    const int x0i = min(max((int)x0, 0), width - 1);
    const int x1i = min(max(x0i + 1, 0), width - 1);
    const int y0i = min(max((int)y0, 0), height - 1);
    const int y1i = min(max(y0i + 1, 0), height - 1);
    const float w[4] = {(1.f - tx) * (1.f - ty), tx * (1.f - ty), (1.f - tx) * ty, tx * ty};
    const int here = y0i * width + x0i;
    if (here != cell) {
      if (cell >= 0) add_cell<C>(dg, shared, plane, o, sums);
      cell = here;
      o[0] = y0i * width + x0i;
      o[1] = y0i * width + x1i;
      o[2] = y1i * width + x0i;
      o[3] = y1i * width + x1i;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int c = 0; c < C; ++c) sums[k][c] = 0.f;
      }
    }
    const float* __restrict__ cp = cot + (long long)p * C * n + i;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float g = __ldg(cp + (long long)c * n);
#pragma unroll
      for (int k = 0; k < 4; ++k) sums[k][c] += w[k] * g;
    }
  }
  if (cell >= 0) add_cell<C>(dg, shared, plane, o, sums);

  if (shared) {
    __syncthreads();
    for (int k = threadIdx.x; k < plane * C; k += kThreads) {
      const float a = acc[k];
      if (a != 0.f) atomicAdd(dg + k, a);
    }
  }
}

template <int C>
cudaError_t launch(const float* pts, const float* cot, float* dgrid, int n_planes, int n,
                   int height, int width, cudaStream_t stream) {
  const long long plane_floats = (long long)C * height * width;
  const size_t smem = plane_floats <= kSmemFloats ? (size_t)plane_floats * sizeof(float) : 0;
  const dim3 blocks((n + kPoints - 1) / kPoints, n_planes);
  plane_bilinear_bwd_kernel<C><<<blocks, kThreads, smem, stream>>>(pts, cot, dgrid, n, height,
                                                                   width);
  return cudaGetLastError();
}

}  // namespace

// pts [P, N, 2] f32 (8-byte aligned), cot [P, C, N] f32, dgrid [P, C, H, W]
// f32 zeroed; C must be 4, 8 or 16. Returns a cudaError_t (0 = launched).
extern "C" int lidar4d_plane_bilinear_bwd(const void* pts, const void* cot, void* dgrid,
                                          int n_planes, int n, int channels, int height,
                                          int width, void* stream) {
  if (n_planes < 1 || n_planes > 65535 || height < 1 || width < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const float* pp = static_cast<const float*>(pts);
  const float* cp = static_cast<const float*>(cot);
  float* dp = static_cast<float*>(dgrid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels == 4) return (int)launch<4>(pp, cp, dp, n_planes, n, height, width, s);
  if (channels == 8) return (int)launch<8>(pp, cp, dp, n_planes, n, height, width, s);
  if (channels == 16) return (int)launch<16>(pp, cp, dp, n_planes, n, height, width, s);
  return (int)cudaErrorInvalidValue;
}
