// Bilinear sample of P feature planes at P point sets, backward: the plane
// gradient and the point gradient in one pass over the points.
//
// Replaces lidar4d_tpu/ops/plane_onehot.py::_vjp_bwd (Pallas _bwd_kernel),
// the backward of plane_bilinear(coord_grad=True): the K-planes lookup of
// Planes4D.forward_dynamic / __call__ at a per-sample time, whose point
// gradient trains the flow net through warped plane lookups. On the TPU the
// kernel contracted the weighted 2-hot vectors and their tent derivatives
// with the plane and the cotangent as three bf16 matmuls per block of
// points. Here a thread takes a run of points; for each it recomputes the
// four corners and weights with plane_bilinear_fwd.cu's align_corners /
// border-clamp arithmetic, gathers the 2x2 cell of every channel and writes
//   dpts[p, n, 0] = (W - 1) [0 <= px <= 1]
//                   sum_c cot[p, c, n] sum_{y, x} tent(v - y) tent'(u - x) G[p, c, y, x]
// and dpts[p, n, 1] likewise on H, with the reference kernel's subgradient
// tent'(d) = sign(-d) [|d| < 1]: zero at an exact integer u (or v), the
// border included. The plane gradient is plane_bilinear_bwd.cu's:
//   dG[p, c, y, x] = sum_n tent(v_n - y) tent(u_n - x) cot[p, c, n].
//
// What bounds it: bytes for the point gradient (grid, pts and cot read
// once, dpts written once, no atomics: each thread owns its points), the
// atomics for the plane gradient. A time plane [C, T, S] has T = 8 rows,
// and the samples of one ray share their time, so a run of points lands on
// the same two rows and contends there. The design: one block owns one
// plane for a run of kPoints points and accumulates dG in shared memory
// when the plane's C * H * W floats fit kSmemFloats (64 KB, above the
// default 48 KB by cudaFuncSetAttribute: every flagship time plane
// [8, 8, S <= 256]), adding its nonzero pixels to the global gradient once
// at the end; a larger plane adds to the global gradient directly. Each
// thread walks kRun consecutive points (neighbouring samples of one ray)
// and keeps the sums of the current 2x2 cell in registers, adding them to
// the accumulator only when the cell changes. The pixel coordinates are
// rounded products (__fmul_rn, never contracted into an FMA), so an exact
// integer u is found as in the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;                       // consecutive points per thread
constexpr int kPoints = kThreads * kRun;
constexpr int kSmemFloats = 16384;             // 64 KB
constexpr int kDefaultSmemBytes = 48 * 1024;

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
plane_bilinear_vjp_kernel(const float* __restrict__ grid, const float* __restrict__ pts,
                          const float* __restrict__ cot, float* __restrict__ dgrid,
                          float* __restrict__ dpts, int n, int height, int width) {
  extern __shared__ float acc[];
  const int p = blockIdx.y;
  const int plane = height * width;
  const bool shared = (long long)plane * C <= kSmemFloats;
  const float* __restrict__ g = grid + (long long)p * C * plane;
  float* __restrict__ dg = dgrid + (long long)p * C * plane;

  if (shared) {
    for (int k = threadIdx.x; k < plane * C; k += kThreads) acc[k] = 0.f;
    __syncthreads();
  }

  const float sx = (float)(width - 1);
  const float sy = (float)(height - 1);
  const int first = blockIdx.x * kPoints + threadIdx.x * kRun;
  const int last = min(first + kRun, n);
  int cell = -1;                     // y0 * width + x0 of the cell the sums belong to
  int o[4] = {0, 0, 0, 0};
  float sums[4][C];
  for (int i = first; i < last; ++i) {
    const long long pi = (long long)p * n + i;
    const float2 pt = __ldg(reinterpret_cast<const float2*>(pts) + pi);
    const float x = __fmul_rn(fminf(fmaxf(pt.x, 0.f), 1.f), sx);
    const float y = __fmul_rn(fminf(fmaxf(pt.y, 0.f), 1.f), sy);
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
    float du = 0.f;
    float dv = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float k_c = __ldg(cp + (long long)c * n);
      const float* __restrict__ gc = g + c * plane;
      const float g00 = __ldg(gc + o[0]);
      const float g01 = __ldg(gc + o[1]);
      const float g10 = __ldg(gc + o[2]);
      const float g11 = __ldg(gc + o[3]);
      du += k_c * ((1.f - ty) * (g01 - g00) + ty * (g11 - g10));
      dv += k_c * ((1.f - tx) * (g10 - g00) + tx * (g11 - g01));
#pragma unroll
      for (int k = 0; k < 4; ++k) sums[k][c] += w[k] * k_c;
    }
    const bool live_x = tx != 0.f && pt.x >= 0.f && pt.x <= 1.f;
    const bool live_y = ty != 0.f && pt.y >= 0.f && pt.y <= 1.f;
    reinterpret_cast<float2*>(dpts)[pi] =
        make_float2(live_x ? du * sx : 0.f, live_y ? dv * sy : 0.f);
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
cudaError_t launch(const float* grid, const float* pts, const float* cot, float* dgrid,
                   float* dpts, int n_planes, int n, int height, int width,
                   cudaStream_t stream) {
  const long long plane_floats = (long long)C * height * width;
  const size_t smem = plane_floats <= kSmemFloats ? (size_t)plane_floats * sizeof(float) : 0;
  if (smem > kDefaultSmemBytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        plane_bilinear_vjp_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 blocks((n + kPoints - 1) / kPoints, n_planes);
  plane_bilinear_vjp_kernel<C><<<blocks, kThreads, smem, stream>>>(grid, pts, cot, dgrid, dpts,
                                                                   n, height, width);
  return cudaGetLastError();
}

}  // namespace

// grid [P, C, H, W] f32, pts [P, N, 2] f32 (8-byte aligned), cot [P, C, N]
// f32, dgrid [P, C, H, W] f32 zeroed, dpts [P, N, 2] f32 (8-byte aligned);
// C must be 4, 8 or 16. Returns a cudaError_t (0 = launched).
extern "C" int lidar4d_plane_bilinear_vjp(const void* grid, const void* pts, const void* cot,
                                          void* dgrid, void* dpts, int n_planes, int n,
                                          int channels, int height, int width, void* stream) {
  if (n_planes < 1 || n_planes > 65535 || height < 1 || width < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const float* gp = static_cast<const float*>(grid);
  const float* pp = static_cast<const float*>(pts);
  const float* cp = static_cast<const float*>(cot);
  float* dg = static_cast<float*>(dgrid);
  float* dp = static_cast<float*>(dpts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels == 4) return (int)launch<4>(gp, pp, cp, dg, dp, n_planes, n, height, width, s);
  if (channels == 8) return (int)launch<8>(gp, pp, cp, dg, dp, n_planes, n, height, width, s);
  if (channels == 16) return (int)launch<16>(gp, pp, cp, dg, dp, n_planes, n, height, width, s);
  return (int)cudaErrorInvalidValue;
}
