// Bilinear sample of P feature planes at P point sets, backward: the plane
// gradient and the point gradient in one pass over the points.
//
// Replaces lidar4d_tpu/ops/plane_onehot.py::_vjp_bwd (Pallas _bwd_kernel),
// the backward of plane_bilinear(coord_grad=True): the K-planes lookup of
// Planes4D.forward_dynamic / __call__ at a per-sample time, whose point
// gradient trains the flow net through warped plane lookups. On the TPU the
// kernel contracted the weighted 2-hot vectors and their tent derivatives
// with the plane and the cotangent as three bf16 matmuls per block of
// points. Here the four corners and weights of a point are recomputed with
// plane_bilinear_fwd.cu's align_corners / border-clamp arithmetic and
//   dpts[p, n, 0] = (W - 1) [0 <= px <= 1]
//                   sum_c cot[p, c, n] sum_{y, x} tent(v - y) tent'(u - x) G[p, c, y, x]
// and dpts[p, n, 1] likewise on H, with the reference kernel's subgradient
// tent'(d) = sign(-d) [|d| < 1]: zero at an exact integer u (or v), the
// border included. The plane gradient is plane_bilinear_bwd.cu's:
//   dG[p, c, y, x] = sum_n tent(v_n - y) tent(u_n - x) cot[p, c, n].
// The pixel coordinates are rounded products (__fmul_rn, never contracted
// into an FMA), so an exact integer u is found as in the plain PyTorch
// version.
//
// What bounds it on the H100: bytes. A point reads 2 + C floats and writes
// 2 (48 B at C = 8): 0.0113 ms for the three time planes [3, 8, 8, S] of
// one scale on 262,144 points at 3.35 TB/s, whatever S. The first design
// took 0.092-0.150 ms a call, growing with S: each thread walked 16
// consecutive points, so a warp's lanes read the coordinates 128 bytes
// apart and the cotangent 64 bytes apart one float a load and stored dpts
// 128 bytes apart; the grid was 192 blocks; and each block added every
// nonzero float of its [C, T, S] shared accumulator to the global gradient
// with its own atomic, 64 blocks a plane onto the same addresses.
//
// This design, 0.030-0.048 ms a call (2.7-4.2x the bound; NVIDIA H100
// 80GB HBM3 at 700 W, scripts/kernels_bench.py, Planes4D.__call__'s points
// warped by the seeded flow net; 0.033-0.073 ms where a trained flow net
// moves them across more cells), carries over plane_bilinear_bwd.cu's and
// plane_linear_bwd.cu's:
// - A group of C lanes walks a run of consecutive points (neighbouring
//   samples of one ray), lane c its channel c. It loads 8 points at a time:
//   its own channel's 32-byte cotangent segment (two 16-byte loads) and the
//   chunk's 64 bytes of coordinates, so every sector a warp loads is used
//   whole.
// - A lane keeps, while the points stay on one cell, the cell's four corner
//   sums of its channel's plane gradient and the plane's four corner
//   values: a point costs no shared atomic and no plane read. The samples
//   of one ray share their time, so a ray stays on one cell row and its
//   cell changes as u crosses a pixel, mostly by one column: then the
//   shared column's two sums and two plane values are handed on to the new
//   cell, and the step costs two shared atomics and two plane reads a lane
//   (S = 256: 0.058 -> 0.047 ms; a quarter of its points change cell).
// - dpts: each lane forms its channel's share of du and dv of the chunk's
//   8 points, and a reduce-scatter over the group (shuffles) leaves the
//   sums of point k on lane k (C = 8; C = 4: points 2k, 2k + 1; C = 16:
//   one float), so the group stores the chunk's 64 bytes of dpts at once.
//   dpts is complete inside the group: no atomics, no second pass.
// - dG: a block owns one plane and accumulates its whole [C, H, W] gradient
//   in shared memory where it fits (every flagship time plane: 8, 16, 32
//   and 64 KB at S = 32 .. 256), channel c at c * stride floats (stride =
//   H * W rounded up to 4, plus 4: the group's lanes add to the same pixel
//   of each channel at once, and the pad puts them on different banks). It
//   ends with one bulk reduction (cp.reduce.async.bulk) into the global
//   gradient per channel row, not one atomic per float. A plane that does
//   not fit adds to the global gradient directly (native float atomics).
// - The plane for the cell changes' reads: staged in shared memory beside
//   the accumulator by one bulk copy per channel on an mbarrier where two
//   blocks an SM still fit (S <= 128), else read through L1 with a set
//   share of shared memory and L1 (the carveout: S = 256, where staging
//   leaves one block an SM and took 0.053 ms against 0.047); the wrapper
//   chooses (ops/plane_onehot.py::plane_bilinear_vjp_plan).
// - The grid is persistent: the wrapper sizes `run` from the SM count and
//   the occupancy so that the P planes' blocks together fill one resident
//   wave, and each block's accumulator is flushed once (two waves, or
//   256-thread blocks: slower).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_async.cuh"

namespace {

constexpr int kMaxThreads = 512;        // PLANE_VJP_MAX_THREADS in ops/plane_onehot.py
constexpr int kChunk = 8;               // PLANE_VJP_CHUNK: points loaded at once
constexpr int kSmemLimit = 227 * 1024;  // PLANE_VJP_SMEM_LIMIT

// How a block accumulates dG and reads the plane (PLANE_VJP_GLOBAL,
// PLANE_VJP_SHARED and PLANE_VJP_STAGED in ops/plane_onehot.py).
enum Mode { kGlobal = 0, kShared = 1, kStaged = 2 };

// A compile-time index, converting to int on the device.
template <int I>
struct Index {
  __host__ __device__ constexpr operator int() const { return I; }
};

// f(0), f(1), .. f(N - 1), each index a compile-time constant (Index<i>), so
// that register arrays are only ever indexed by constants: with `#pragma
// unroll` loops around the cell change's atomics the compiler kept the
// chunk's dpts shares in local memory (a 64-byte stack frame).
template <int N, typename F>
__device__ __forceinline__ void unroll(F&& f) {
  if constexpr (N > 0) {
    unroll<N - 1>(f);
    f(Index<N - 1>());
  }
}

__host__ __device__ constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x / 2); }

// v[C * M] summed over the C lanes of the group, block by block: lane c is
// left with the sums of v[c * M .. c * M + M) in v[0 .. M) (recursive
// halving, M * (C - 1) shuffles).
template <int C, int M>
__device__ __forceinline__ void reduce_scatter(float (&v)[C * M], unsigned mask, int c) {
  unroll<log2i(C)>([&](auto step) {
    constexpr int o = C >> (int(decltype(step)()) + 1);
    const bool upper = (c & o) != 0;
    unroll<o * M>([&](auto k) {
      const float lo = v[k], hi = v[k + o * M];
      v[k] = (upper ? hi : lo) + __shfl_xor_sync(mask, upper ? lo : hi, o, C);
    });
  });
}

// grid: (point chunks, planes); blockDim.x threads, a multiple of 32. Block
// b's group g (C lanes) takes points [(b * groups + g) * run, ... + run);
// run is a multiple of kChunk. Shared memory (kShared, kStaged): the [C]
// [stride] accumulator; kStaged: then the [C][stride] plane and the
// mbarrier.
template <int C, int kMode>
__global__ void __launch_bounds__(kMaxThreads)
plane_bilinear_vjp_kernel(const float* __restrict__ grid, const float* __restrict__ pts,
                          const float* __restrict__ cot, float* __restrict__ dgrid,
                          float* __restrict__ dpts, int n, int height, int width, int run,
                          int stride) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kVals = 2 * kChunk;               // a chunk's dpts floats
  constexpr int M = kVals / C;                    // of which a lane stores M
  const int p = blockIdx.y;
  const int c = threadIdx.x % C;
  const int plane = height * width;
  const long long chan = (long long)p * C + c;
  const float* __restrict__ g = grid + chan * plane;
  float* __restrict__ dg = dgrid + chan * plane;
  // Channel c's accumulator starts at the same address modulo 16 bytes as
  // its global row, so that the bulk reduction finds both ends aligned.
  float* const mine = smem + c * stride + ((reinterpret_cast<uintptr_t>(dg) >> 2) & 3);
  const float* const staged = smem + (C + c) * stride;
  uint64_t* const bar = reinterpret_cast<uint64_t*>(smem + 2 * C * stride);
  if (kMode != kGlobal) {
    if (kMode == kStaged && threadIdx.x == 0) {
      mbar_init(bar);
      mbar_arrive_expect_tx(bar, (uint32_t)(C * plane * 4));
      for (int k = 0; k < C; ++k)
        bulk_load(smem + (C + k) * stride, grid + ((long long)p * C + k) * plane,
                  (uint32_t)plane * 4u, bar);
    }
    float4* a4 = reinterpret_cast<float4*>(smem);
    for (int k = threadIdx.x; k < C * stride / 4; k += blockDim.x)
      a4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    if (kMode == kStaged) mbar_wait(bar, 0);
  }
  auto at = [&](int off) { return kMode == kStaged ? staged[off] : __ldg(g + off); };

  const long long first = ((long long)blockIdx.x * (blockDim.x / C) + threadIdx.x / C) * run;
  const long long last = min(first + run, (long long)n);
  const unsigned mask = ((1u << C) - 1u) << ((threadIdx.x & 31) & ~(C - 1));
  const float* __restrict__ cp = cot + chan * n;
  const float2* __restrict__ pp = reinterpret_cast<const float2*>(pts) + (long long)p * n;
  float* __restrict__ dp = dpts + (long long)p * n * 2;
  // 16-byte loads of both the cotangent row and the coordinates when every
  // chunk starts 16-byte aligned (n % 4 == 0; run and first are multiples of
  // kChunk).
  const bool vec = (n & 3) == 0 && (reinterpret_cast<uintptr_t>(cot) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(pts) & 15) == 0;
  const float sx = (float)(width - 1);
  const float sy = (float)(height - 1);

  // The cell the registers hold: its corners are cell, cell + ox, cell + oy
  // and cell + ox + oy (ox = 0 on the last column, oy = 0 on the last row).
  int cell = -1, ox = 0, oy = 0;
  float s[4] = {0.f, 0.f, 0.f, 0.f};   // the corners' gradient sums
  float gc[4] = {0.f, 0.f, 0.f, 0.f};  // the plane at the corners
  auto add = [&](int k) {
    const int off = cell + (k & 1 ? ox : 0) + (k & 2 ? oy : 0);
    if (kMode != kGlobal) atomicAdd(mine + off, s[k]);
    else atomicAdd(dg + off, s[k]);
  };
  for (long long base = first; base < last; base += kChunk) {
    const int cnt = (int)min((long long)kChunk, last - base);   // uniform over the group
    float k_c[kChunk];
    float2 q[kChunk];
    if (vec && cnt == kChunk) {
      const float4* c4 = reinterpret_cast<const float4*>(cp + base);
      const float4 a = __ldg(c4), b = __ldg(c4 + 1);
      k_c[0] = a.x; k_c[1] = a.y; k_c[2] = a.z; k_c[3] = a.w;
      k_c[4] = b.x; k_c[5] = b.y; k_c[6] = b.z; k_c[7] = b.w;
      const float4* p4 = reinterpret_cast<const float4*>(pp + base);
      unroll<kChunk / 2>([&](auto k) {
        const float4 w = __ldg(p4 + k);
        q[2 * k] = make_float2(w.x, w.y);
        q[2 * k + 1] = make_float2(w.z, w.w);
      });
    } else {
      unroll<kChunk>([&](auto i) {
        k_c[i] = i < cnt ? __ldg(cp + base + i) : 0.f;
        q[i] = i < cnt ? __ldg(pp + base + i) : make_float2(0.f, 0.f);
      });
    }
    float v[kVals];
    unroll<kChunk>([&](auto i) {
      v[2 * i] = v[2 * i + 1] = 0.f;
      if (i >= cnt) return;
      const float x = __fmul_rn(fminf(fmaxf(q[i].x, 0.f), 1.f), sx);
      const float y = __fmul_rn(fminf(fmaxf(q[i].y, 0.f), 1.f), sy);
      const float x0 = floorf(x);
      const float y0 = floorf(y);
      const float tx = x - x0;
      const float ty = y - y0;
      const int x0i = min(max((int)x0, 0), width - 1);
      const int y0i = min(max((int)y0, 0), height - 1);
      const int here = y0i * width + x0i;
      if (here != cell) {
        const int dx = x0i < width - 1 ? 1 : 0;
        const int dy = y0i < height - 1 ? width : 0;
        // A step of one column along the row hands the shared column's sums
        // and plane values on to the new cell; the other column's sums go
        // to the accumulator and its plane values are read anew.
        if (here == cell + ox && dy == oy) {
          add(0), add(2);
          s[0] = s[1], s[2] = s[3], s[1] = s[3] = 0.f;
          gc[0] = gc[1], gc[2] = gc[3], gc[1] = at(here + dx), gc[3] = at(here + dx + dy);
        } else if (cell >= 0 && here + dx == cell && dy == oy) {
          add(1), add(3);
          s[1] = s[0], s[3] = s[2], s[0] = s[2] = 0.f;
          gc[1] = gc[0], gc[3] = gc[2], gc[0] = at(here), gc[2] = at(here + dy);
        } else {
          if (cell >= 0) add(0), add(1), add(2), add(3);
          s[0] = s[1] = s[2] = s[3] = 0.f;
          gc[0] = at(here), gc[1] = at(here + dx);
          gc[2] = at(here + dy), gc[3] = at(here + dx + dy);
        }
        cell = here, ox = dx, oy = dy;
      }
      const float k = k_c[i];
      s[0] += (1.f - tx) * (1.f - ty) * k;
      s[1] += tx * (1.f - ty) * k;
      s[2] += (1.f - tx) * ty * k;
      s[3] += tx * ty * k;
      const bool live_x = tx != 0.f && q[i].x >= 0.f && q[i].x <= 1.f;
      const bool live_y = ty != 0.f && q[i].y >= 0.f && q[i].y <= 1.f;
      if (live_x) v[2 * i] = k * ((1.f - ty) * (gc[1] - gc[0]) + ty * (gc[3] - gc[2]));
      if (live_y) v[2 * i + 1] = k * ((1.f - tx) * (gc[2] - gc[0]) + tx * (gc[3] - gc[1]));
    });
    reduce_scatter<C, M>(v, mask, c);
    // Lane c holds the chunk's dpts floats [c * M, c * M + M): float f is
    // point f / 2's du (f even) or dv (f odd).
    float* out = dp + base * 2 + c * M;
    if constexpr (M == 1) {
      if (c / 2 < cnt) out[0] = v[0] * ((c & 1) ? sy : sx);
    } else {
      unroll<M / 2>([&](auto j) {
        if (c * M / 2 + j < cnt)
          reinterpret_cast<float2*>(out)[j] = make_float2(v[2 * j] * sx, v[2 * j + 1] * sy);
      });
    }
  }
  if (cell >= 0) add(0), add(1), add(2), add(3);

  if (kMode != kGlobal) {
    fence_proxy_async();
    __syncthreads();
    for (int w = threadIdx.x / 32; w < C; w += blockDim.x / 32) {
      float* row = dgrid + ((long long)p * C + w) * plane;
      reduce_row(row, smem + w * stride + ((reinterpret_cast<uintptr_t>(row) >> 2) & 3), plane,
                 threadIdx.x % 32);
    }
  }
}

long long smem_bytes(int channels, int mode, int stride) {
  if (mode == kGlobal) return 0;
  return mode == kStaged ? 2LL * channels * stride * 4 + 16 : (long long)channels * stride * 4;
}

// The dynamic shared memory of a launch and the share of the SM's unified
// L1 / shared memory (percent) to configure as shared memory (-1: the
// default).
template <int C, int kMode>
cudaError_t set_smem(int stride, int carveout) {
  const cudaError_t e = cudaFuncSetAttribute(
      plane_bilinear_vjp_kernel<C, kMode>, cudaFuncAttributePreferredSharedMemoryCarveout,
      carveout);
  if (e != cudaSuccess) return e;
  const long long smem = smem_bytes(C, kMode, stride);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(plane_bilinear_vjp_kernel<C, kMode>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int C, int kMode>
cudaError_t launch(const float* grid, const float* pts, const float* cot, float* dgrid,
                   float* dpts, int n_planes, int n, int height, int width, int threads,
                   int run, int stride, int carveout, cudaStream_t stream) {
  const cudaError_t e = set_smem<C, kMode>(stride, carveout);
  if (e != cudaSuccess) return e;
  const long long per_block = (long long)(threads / C) * run;
  const dim3 blocks((unsigned)((n + per_block - 1) / per_block), n_planes);
  plane_bilinear_vjp_kernel<C, kMode>
      <<<blocks, threads, (size_t)smem_bytes(C, kMode, stride), stream>>>(
          grid, pts, cot, dgrid, dpts, n, height, width, run, stride);
  return cudaGetLastError();
}

template <int C, int kMode>
int blocks_per_sm(int threads, int stride, int carveout) {
  if (set_smem<C, kMode>(stride, carveout) != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, plane_bilinear_vjp_kernel<C, kMode>, threads,
          (size_t)smem_bytes(C, kMode, stride)) != cudaSuccess)
    return -1;
  return blocks;
}

// mode: kGlobal, kShared or kStaged. stride: floats a channel takes in
// shared memory, H * W rounded up to 4 plus 4 (any value on the global
// path). kStaged copies each channel with one 16-byte-granular bulk copy:
// H * W a multiple of 4.
bool valid_shape(int channels, int mode, int height, int width, int threads, int stride,
                 int carveout) {
  if (!(channels == 4 || channels == 8 || channels == 16) || height < 1 || width < 1 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || carveout < -1 ||
      carveout > 100 || mode < kGlobal || mode > kStaged)
    return false;
  if (mode == kGlobal) return true;
  const long long plane = (long long)height * width;
  return stride == ((plane + 3) & ~3LL) + 4 && smem_bytes(channels, mode, stride) <= kSmemLimit &&
         (mode != kStaged || plane % 4 == 0);
}

}  // namespace

#define LIDAR4D_PLANE_VJP_DISPATCH(EXPR)                                          \
  switch (channels * 4 + mode) {                                                  \
    case 16: { constexpr int CC = 4; constexpr int MM = kGlobal; return EXPR; }   \
    case 17: { constexpr int CC = 4; constexpr int MM = kShared; return EXPR; }   \
    case 18: { constexpr int CC = 4; constexpr int MM = kStaged; return EXPR; }   \
    case 32: { constexpr int CC = 8; constexpr int MM = kGlobal; return EXPR; }   \
    case 33: { constexpr int CC = 8; constexpr int MM = kShared; return EXPR; }   \
    case 34: { constexpr int CC = 8; constexpr int MM = kStaged; return EXPR; }   \
    case 64: { constexpr int CC = 16; constexpr int MM = kGlobal; return EXPR; }  \
    case 65: { constexpr int CC = 16; constexpr int MM = kShared; return EXPR; }  \
    case 66: { constexpr int CC = 16; constexpr int MM = kStaged; return EXPR; }  \
  }

// grid [P, C, H, W] f32 (16-byte aligned for mode 2), pts [P, N, 2] f32
// (8-byte aligned), cot [P, C, N] f32, dgrid [P, C, H, W] f32 zeroed, dpts
// [P, N, 2] f32 (every entry written); C must be 4, 8 or 16. mode: 0 adds
// dG to global memory directly, 1 accumulates it in shared memory (C *
// stride floats at most 227 KB), 2 also stages the plane there (2 * C *
// stride floats + 16 bytes at most 227 KB, H * W a multiple of 4). threads:
// a block's threads, a multiple of 32 up to 512. run: consecutive points a
// group of C lanes takes, a multiple of 8 (the grid has ceil(N / (threads /
// C * run)) blocks per plane). carveout: the shared-memory share of the
// SM's unified memory in percent, -1 for the default. Returns a
// cudaError_t (0 = launched).
extern "C" int lidar4d_plane_bilinear_vjp(const void* grid, const void* pts, const void* cot,
                                          void* dgrid, void* dpts, int n_planes, int n,
                                          int channels, int height, int width, int mode,
                                          int threads, int run, int stride, int carveout,
                                          void* stream) {
  if (n_planes < 1 || n_planes > 65535 || run < kChunk || run % kChunk != 0 ||
      !valid_shape(channels, mode, height, width, threads, stride, carveout) ||
      (mode == kStaged && (reinterpret_cast<uintptr_t>(grid) & 15) != 0))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const float* gp = static_cast<const float*>(grid);
  const float* pp = static_cast<const float*>(pts);
  const float* cp = static_cast<const float*>(cot);
  float* dg = static_cast<float*>(dgrid);
  float* dp = static_cast<float*>(dpts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LIDAR4D_PLANE_VJP_DISPATCH((int)(launch<CC, MM>(gp, pp, cp, dg, dp, n_planes, n, height,
                                                  width, threads, run, stride, carveout, s)))
  return (int)cudaErrorInvalidValue;
}

// Resident blocks of the kernel per SM for this channel count, mode, block
// size, stride and carveout (the wrapper sizes the grid from it); -1 on an
// error.
extern "C" int lidar4d_plane_bilinear_vjp_blocks_per_sm(int channels, int mode, int height,
                                                        int width, int threads, int stride,
                                                        int carveout) {
  if (!valid_shape(channels, mode, height, width, threads, stride, carveout)) return -1;
  LIDAR4D_PLANE_VJP_DISPATCH((blocks_per_sm<CC, MM>(threads, stride, carveout)))
  return -1;
}
#undef LIDAR4D_PLANE_VJP_DISPATCH
