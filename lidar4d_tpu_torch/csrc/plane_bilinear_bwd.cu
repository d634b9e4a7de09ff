// Bilinear sample of P feature planes at P point sets, backward: the plane
// gradient only (the point gradient is zero by contract).
//
// Replaces lidar4d_tpu/ops/plane_onehot.py::_bwd_kernel_tables (through
// _vjp_bwd_tables, i.e. plane_bilinear(coord_grad=False)): the dense static
// K-planes at scales 32/64/128, whose lookup points are ray positions. On
// the TPU the kernel contracted the weighted 2-hot vectors with the
// cotangent as a bf16 matmul per channel. Here each point's four corners
// and weights are recomputed with the align_corners=True / border-clamp
// arithmetic of plane_bilinear_fwd.cu and w * cot[p, c, n] is added to the
// four corner pixels of every channel:
//   dG[p, c, y, x] = sum_n tent(v_n - y) tent(u_n - x) cot[p, c, n].
//
// What bounds it on the H100: bytes, 40 B a point at C = 8 (0.043 ms a
// flagship train step at 3.35 TB/s) against 4 * C additions a point. The
// first design (each thread walking 16 points with all C channels, blocks of
// 4,096 points, a 48 KB accumulator) took 0.568 ms a step: only the 32^2
// plane fit its shared accumulator, so the 64^2 and 128^2 planes issued
// 4 * C global atomics a cell change; a warp's lanes read the cotangent
// 64 bytes apart, one channel a load; the grid was 96 or 192 blocks; and the
// shared path flushed every nonzero float with its own global atomic.
//
// This design, 0.183 ms a step against the first design's 0.567-0.577 in
// the same calls (NVIDIA H100 80GB HBM3 at 700 W, scripts/kernels_bench.py;
// 3.5-6.1x the byte bound a call):
// - A block owns one plane and a slice of `CB` channels, and accumulates the
//   slice [CB, H, W] in shared memory at every flagship shape (the wrapper
//   chooses CB from the shape and the opt-in 227 KB: 32^2 x 8, 64^2 x 4,
//   128^2 x 1 at C = 8). Channel k of the slice starts at k * stride floats
//   (stride = H * W rounded up to 4, plus 4): the pad spreads the slice's
//   channels over the banks, since a group's lanes add to the same pixel of
//   each channel at once.
// - A group of CB lanes walks a run of consecutive points (neighbouring
//   samples of a ray), lane k its channel k. It loads 8 points at a time:
//   one 32-byte segment of its own channel's cotangent a lane (two 16-byte
//   loads) and the chunk's 64 bytes of coordinates. A lane keeps the four
//   corner sums of the current cell while the cell stays the same and adds
//   them to shared memory only when it changes, so a ray's samples on one
//   cell cost one set of shared atomics. The shared float atomicAdd compiles
//   to a compare-and-swap loop (ATOMS.CAST.SPIN) on this card; the merging
//   is what keeps their number low.
// - The grid is persistent: the wrapper sizes `run` from the SM count and
//   the occupancy so that the P * C / CB slices together fill one resident
//   wave of the card (`_cuda.persistent_run`); two waves took 24% longer,
//   and the whole 227 KB for one block a SM (64^2 x 8, 128^2 x 2) 16%.
// - Each block ends with one bulk reduction (cp.reduce.async.bulk, Hopper's
//   asynchronous reduction into global memory) per channel of its slice, in
//   place of per-float atomics. The wrapper zeroes dG.
// - A plane whose single channel does not fit shared memory (256^2 and up,
//   as in the reference architecture's dense planes) adds to the global
//   gradient directly, with native global float atomics (CB = 0 from the
//   wrapper).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_async.cuh"

namespace {

constexpr int kThreads = 512;          // PLANE_BWD_THREADS in ops/plane_onehot.py
constexpr int kChunk = 8;              // PLANE_BWD_CHUNK: points loaded at once
constexpr int kSmemLimit = 227 * 1024;

// grid: (point chunks, C / CB channel slices, planes). Block b's group g
// (CB lanes) takes points [(b * groups + g) * run, ... + run); run is a
// multiple of kChunk. kShared: accumulate in shared memory (CB * stride
// floats) and flush once, else add to dgrid directly.
template <int CB, bool kShared>
__global__ void __launch_bounds__(kThreads)
plane_bilinear_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ cot,
                          float* __restrict__ dgrid, int n, int channels, int height,
                          int width, int run, int stride) {
  extern __shared__ __align__(16) float acc[];
  constexpr int kGroups = kThreads / CB;
  const int p = blockIdx.z;
  const int c = threadIdx.x % CB;
  const int plane = height * width;
  const long long chan = (long long)p * channels + blockIdx.y * CB + c;
  float* __restrict__ dg = dgrid + chan * plane;
  // Channel c's accumulator starts at the same address modulo 16 bytes as
  // its global row, so that the bulk reduction finds both ends aligned.
  float* __restrict__ mine = acc + c * stride + ((reinterpret_cast<uintptr_t>(dg) >> 2) & 3);
  if (kShared) {
    float4* a4 = reinterpret_cast<float4*>(acc);
    for (int k = threadIdx.x; k < CB * stride / 4; k += kThreads)
      a4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
  }

  const long long first = ((long long)blockIdx.x * kGroups + threadIdx.x / CB) * run;
  const long long last = min(first + run, (long long)n);
  const float* __restrict__ cp = cot + chan * n;
  const float2* __restrict__ pp = reinterpret_cast<const float2*>(pts) + (long long)p * n;
  // 16-byte loads of both the cotangent row and the coordinates when every
  // chunk starts 16-byte aligned (n % 4 == 0; run and first are multiples of
  // kChunk).
  const bool vec = (n & 3) == 0 && (reinterpret_cast<uintptr_t>(cot) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(pts) & 15) == 0;
  const float sx = (float)(width - 1);
  const float sy = (float)(height - 1);

  int cell = -1;                     // y0 * width + x0 of the cell the sums belong to
  int o[4];
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  auto add = [&]() {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (kShared) atomicAdd(mine + o[k], s[k]);
      else atomicAdd(dg + o[k], s[k]);
    }
  };
  for (long long base = first; base < last; base += kChunk) {
    const int cnt = (int)min((long long)kChunk, last - base);
    float g[kChunk];
    float2 q[kChunk];
    if (vec && cnt == kChunk) {
      const float4* c4 = reinterpret_cast<const float4*>(cp + base);
      const float4 a = __ldg(c4), b = __ldg(c4 + 1);
      g[0] = a.x; g[1] = a.y; g[2] = a.z; g[3] = a.w;
      g[4] = b.x; g[5] = b.y; g[6] = b.z; g[7] = b.w;
      const float4* p4 = reinterpret_cast<const float4*>(pp + base);
#pragma unroll
      for (int k = 0; k < kChunk / 2; ++k) {
        const float4 v = __ldg(p4 + k);
        q[2 * k] = make_float2(v.x, v.y);
        q[2 * k + 1] = make_float2(v.z, v.w);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        g[i] = i < cnt ? __ldg(cp + base + i) : 0.f;
        q[i] = i < cnt ? __ldg(pp + base + i) : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i >= cnt) break;
      const float x = fminf(fmaxf(q[i].x, 0.f), 1.f) * sx;
      const float y = fminf(fmaxf(q[i].y, 0.f), 1.f) * sy;
      const float x0 = floorf(x);
      const float y0 = floorf(y);
      const float tx = x - x0;
      const float ty = y - y0;
      const int x0i = min(max((int)x0, 0), width - 1);
      const int y0i = min(max((int)y0, 0), height - 1);
      const int here = y0i * width + x0i;
      if (here != cell) {
        if (cell >= 0) add();
        cell = here;
        const int x1i = min(x0i + 1, width - 1);
        const int y1i = min(y0i + 1, height - 1);
        o[0] = here;
        o[1] = y0i * width + x1i;
        o[2] = y1i * width + x0i;
        o[3] = y1i * width + x1i;
        s[0] = s[1] = s[2] = s[3] = 0.f;
      }
      const float gi = g[i];
      s[0] += (1.f - tx) * (1.f - ty) * gi;
      s[1] += tx * (1.f - ty) * gi;
      s[2] += (1.f - tx) * ty * gi;
      s[3] += tx * ty * gi;
    }
  }
  if (cell >= 0) add();

  if (kShared) {
    fence_proxy_async();
    __syncthreads();
    const int w = threadIdx.x / 32;
    if (w < CB) {
      float* row = dgrid + ((long long)p * channels + blockIdx.y * CB + w) * plane;
      reduce_row(row, acc + w * stride + ((reinterpret_cast<uintptr_t>(row) >> 2) & 3), plane,
                 threadIdx.x % 32);
    }
  }
}

long long smem_bytes(int cb, int stride) { return (long long)cb * stride * 4; }

template <int CB, bool kShared>
cudaError_t set_smem(int stride) {
  const long long smem = kShared ? smem_bytes(CB, stride) : 0;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(plane_bilinear_bwd_kernel<CB, kShared>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int CB, bool kShared>
cudaError_t launch(const float* pts, const float* cot, float* dgrid, int n_planes, int n,
                   int channels, int height, int width, int run, int stride,
                   cudaStream_t stream) {
  const cudaError_t e = set_smem<CB, kShared>(stride);
  if (e != cudaSuccess) return e;
  const long long per_block = (long long)(kThreads / CB) * run;
  const dim3 grid((unsigned)((n + per_block - 1) / per_block), channels / CB, n_planes);
  const size_t smem = kShared ? (size_t)smem_bytes(CB, stride) : 0;
  plane_bilinear_bwd_kernel<CB, kShared><<<grid, kThreads, smem, stream>>>(
      pts, cot, dgrid, n, channels, height, width, run, stride);
  return cudaGetLastError();
}

template <int CB, bool kShared>
int blocks_per_sm(int stride) {
  if (set_smem<CB, kShared>(stride) != cudaSuccess) return -1;
  int blocks = 0;
  const size_t smem = kShared ? (size_t)smem_bytes(CB, stride) : 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, plane_bilinear_bwd_kernel<CB, kShared>, kThreads, smem) != cudaSuccess)
    return -1;
  return blocks;
}

// slice: CB channels a block accumulates in shared memory (0: the global
// path, which runs groups of min(C, 8) lanes). stride: floats a channel
// takes in shared memory, H * W rounded up to 4 plus 4.
bool valid_shape(int channels, int slice, int height, int width, int stride) {
  if (!(channels == 4 || channels == 8 || channels == 16) || height < 1 || width < 1)
    return false;
  if (slice == 0) return true;
  const long long plane = (long long)height * width;
  return (slice == 1 || slice == 2 || slice == 4 || slice == 8 || slice == 16) &&
         channels % slice == 0 && stride == ((plane + 3) & ~3LL) + 4 &&
         smem_bytes(slice, stride) <= kSmemLimit;
}

}  // namespace

#define LIDAR4D_PLANE_BWD_DISPATCH(EXPR)                                              \
  switch (slice == 0 ? (channels < 8 ? -channels : -8) : slice) {                                   \
    case 1: { constexpr int CB = 1; constexpr bool SH = true; return EXPR; }          \
    case 2: { constexpr int CB = 2; constexpr bool SH = true; return EXPR; }          \
    case 4: { constexpr int CB = 4; constexpr bool SH = true; return EXPR; }          \
    case 8: { constexpr int CB = 8; constexpr bool SH = true; return EXPR; }          \
    case 16: { constexpr int CB = 16; constexpr bool SH = true; return EXPR; }        \
    case -4: { constexpr int CB = 4; constexpr bool SH = false; return EXPR; }        \
    case -8: { constexpr int CB = 8; constexpr bool SH = false; return EXPR; }        \
  }

// pts [P, N, 2] f32 (8-byte aligned), cot [P, C, N] f32, dgrid [P, C, H, W]
// f32 zeroed; C must be 4, 8 or 16. slice: channels a block accumulates in
// shared memory (1, 2, 4, 8 or 16, dividing C, slice * stride floats at
// most 227 KB), or 0 for the global path. run: consecutive points a group
// of lanes takes, a multiple of 8 (the grid has ceil(N / (512 / lanes *
// run)) blocks per slice and plane). Returns a cudaError_t (0 = launched).
extern "C" int lidar4d_plane_bilinear_bwd(const void* pts, const void* cot, void* dgrid,
                                          int n_planes, int n, int channels, int height,
                                          int width, int slice, int run, int stride,
                                          void* stream) {
  if (n_planes < 1 || n_planes > 65535 || run < kChunk || run % kChunk != 0 ||
      !valid_shape(channels, slice, height, width, stride))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const float* pp = static_cast<const float*>(pts);
  const float* cp = static_cast<const float*>(cot);
  float* dp = static_cast<float*>(dgrid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LIDAR4D_PLANE_BWD_DISPATCH((int)(launch<CB, SH>(pp, cp, dp, n_planes, n, channels, height,
                                                  width, run, stride, s)))
  return (int)cudaErrorInvalidValue;
}

// Resident blocks of the kernel per SM for this slice and stride (the
// wrapper sizes the grid from it); -1 on an error.
extern "C" int lidar4d_plane_bilinear_bwd_blocks_per_sm(int channels, int slice, int height,
                                                        int width, int stride) {
  if (!valid_shape(channels, slice, height, width, stride)) return -1;
  LIDAR4D_PLANE_BWD_DISPATCH((blocks_per_sm<CB, SH>(stride)))
  return -1;
}
#undef LIDAR4D_PLANE_BWD_DISPATCH
