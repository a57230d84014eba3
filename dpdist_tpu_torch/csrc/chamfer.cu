// Nearest-neighbour squared distances without the N x M matrix:
//   dist[b, n] = min over m of |a[b, n] - p[b, m]|^2.
//
// Replaces the TPU kernel dpdist_tpu/kernels/chamfer_pallas.py:_min_kernel
// (reached through nn_min_sqdist_pallas and chamfer_distance_pallas,
// `pl.pallas_call` at :74). Same math as that kernel and as the native
// pn_min_distances (dpdist_tpu/native/src/pointcloud_native.cpp:67-106):
// exact per-dimension squared differences, summed as
// fma(dz, dz, fma(dy, dy, dx * dx)) with explicit intrinsics (so the
// rounding does not depend on how nvcc contracts), then a running minimum.
//
// What bounds it on an H100: issue slots. A pair costs 7 instructions
// (3 FADD, 1 FMUL, 2 FFMA, 1 FMNMX) and no two pairs share one, so a pair
// takes 7 / 32 of a warp-instruction slot; an SM issues 4 a clock. The
// matmul identity |a|^2 + |p|^2 - 2 a.p would take 4, but it cancels
// badly at large coordinates, and the TPU kernel keeps exact differences
// too. The points themselves are a few hundred KB.
//
// The design, one launch per call:
//   - Work units: (cloud b, a tile of kTileN points of a, a chunk of
//     `chunk` points of p). The host (kernels/chamfer.py:plan_nn_min)
//     chooses the chunk so that the units spread evenly over exactly the
//     blocks the card holds at once; a block walks units
//     blockIdx.x, blockIdx.x + gridDim.x, ... (no counter to reset).
//   - Each thread keeps kPts points of a and their minima in registers; a
//     warp owns 32 * kPts consecutive points, and a warp whose points all
//     lie past N skips the unit's loop.
//   - A unit's chunk of p is one contiguous span of (M, 3) rows. Its
//     16-byte-aligned body arrives in shared memory by one bulk copy
//     (cp.async.bulk, completion on an mbarrier), double-buffered so that
//     the next unit's copy runs during this unit's loop; the at most 3
//     points before and after the body are read from device memory. In
//     the body every thread of a warp reads the same 4 points as three
//     float4 broadcasts: 0.75 shared loads per point of p.
//   - Units merge their minima into dist with atomicMin on the unsigned
//     bits (for floats >= +0 that order is the floats' order); the caller
//     fills dist with 0xFF bytes first. A minimum does not depend on the
//     order of its terms and each pair's value does not depend on its
//     unit, so the result is the same from run to run.
//
// Plain C interface for ctypes; no PyTorch headers. Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "row_groups.cuh"

namespace {

using dpdist::bulk_load;
using dpdist::fence_proxy_async;
using dpdist::mbar_expect;
using dpdist::mbar_init;
using dpdist::mbar_wait;

constexpr int kThreads = 128;
constexpr int kPts = 8;                     // points of a per thread
constexpr int kTileN = kThreads * kPts;     // points of a per unit
constexpr int kMaxChunk = 1024;             // points of p per unit, at most
constexpr int kBufFloats = kMaxChunk * 3;   // one span buffer (12 KB)

struct Points {
  float x[kPts], y[kPts], z[kPts], best[kPts];

  // One point of p against the thread's points: 7 instructions a pair.
  __device__ __forceinline__ void take(float px, float py, float pz) {
#pragma unroll
    for (int i = 0; i < kPts; ++i) {
      const float dx = __fsub_rn(x[i], px), dy = __fsub_rn(y[i], py), dz = __fsub_rn(z[i], pz);
      best[i] = fminf(best[i], __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx))));
    }
  }
};

// Unit u's span of p in flat point indices [g0, g1) (b * M + m), and its
// body [ga, gb): the points whose rows start on 16-byte boundaries of
// device memory, a multiple of 4 points. `phase` is p's offset from a
// 16-byte boundary in floats; row gi starts on a boundary where
// 3 gi + phase = 0 mod 4, that is gi = phase mod 4.
struct Span {
  int64_t g0, g1, ga, gb;
};

__device__ __forceinline__ Span span_of(int u, int M, int splits, int tiles, int chunk,
                                        int phase) {
  const int s = u % splits;
  const int64_t b = u / splits / tiles;
  Span sp;
  sp.g0 = b * M + static_cast<int64_t>(s) * chunk;
  sp.g1 = b * M + min(M, (s + 1) * chunk);
  sp.ga = sp.g0 + ((phase - static_cast<int>(sp.g0 & 3)) & 3);
  if (sp.ga >= sp.g1) sp.ga = sp.g1;
  sp.gb = sp.ga + ((sp.g1 - sp.ga) & ~static_cast<int64_t>(3));
  return sp;
}

__global__ void __launch_bounds__(kThreads) nn_min_kernel(
    const float* __restrict__ a,   // (B, N, 3)
    const float* __restrict__ p,   // (B, M, 3)
    unsigned* __restrict__ dist,   // (B, N) float bits, filled with 0xFF bytes
    int N, int M, int tiles, int splits, int chunk, int units) {
  __shared__ __align__(128) float span_s[2][kBufFloats];
  __shared__ __align__(8) uint64_t bars[2];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int phase = static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);

  auto stage = [&](int u, int slot) {   // one thread
    const Span sp = span_of(u, M, splits, tiles, chunk, phase);
    const uint32_t bytes = static_cast<uint32_t>(sp.gb - sp.ga) * 12u;
    fence_proxy_async();
    mbar_expect(&bars[slot], bytes);
    if (bytes) bulk_load(span_s[slot], p + 3 * sp.ga, bytes, &bars[slot]);
  };

  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) stage(blockIdx.x, 0);

  int it = 0;   // units this block has taken
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++it) {
    const int slot = it & 1;
    // The other buffer's last reader, the previous unit, is done (the
    // barrier at the end of its loop).
    if (tid == 0 && u + static_cast<int>(gridDim.x) < units) stage(u + gridDim.x, slot ^ 1);

    const Span sp = span_of(u, M, splits, tiles, chunk, phase);
    const int64_t b = u / splits / tiles;
    const int n0 = (u / splits % tiles) * kTileN + warp * 32 * kPts;   // this warp's first point
    const bool active = n0 < N;
    Points pt;
    if (active) {
      const float* ab = a + b * N * 3;
#pragma unroll
      for (int i = 0; i < kPts; ++i) {
        const float* q = ab + static_cast<int64_t>(min(n0 + i * 32 + lane, N - 1)) * 3;
        pt.x[i] = __ldg(q);
        pt.y[i] = __ldg(q + 1);
        pt.z[i] = __ldg(q + 2);
        pt.best[i] = INFINITY;
      }
    }
    mbar_wait(&bars[slot], (it >> 1) & 1);
    if (active) {
      for (int64_t g = sp.g0; g < sp.ga; ++g)
        pt.take(__ldg(p + 3 * g), __ldg(p + 3 * g + 1), __ldg(p + 3 * g + 2));
      const float4* body = reinterpret_cast<const float4*>(span_s[slot]);
      const int groups = static_cast<int>(sp.gb - sp.ga) / 4;
#pragma unroll 2
      for (int j = 0; j < groups; ++j) {
        const float4 r0 = body[3 * j], r1 = body[3 * j + 1], r2 = body[3 * j + 2];
        pt.take(r0.x, r0.y, r0.z);
        pt.take(r0.w, r1.x, r1.y);
        pt.take(r1.z, r1.w, r2.x);
        pt.take(r2.y, r2.z, r2.w);
      }
      for (int64_t g = sp.gb; g < sp.g1; ++g)
        pt.take(__ldg(p + 3 * g), __ldg(p + 3 * g + 1), __ldg(p + 3 * g + 2));
      unsigned* db = dist + b * N;
#pragma unroll
      for (int i = 0; i < kPts; ++i) {
        const int n = n0 + i * 32 + lane;
        if (n < N) atomicMin(db + n, __float_as_uint(pt.best[i]));
      }
    }
    __syncthreads();   // this unit's buffer is no longer read
  }
}

}  // namespace

extern "C" {

// Points of a per unit, and the most points of p a unit takes.
int dpdist_nn_min_tile_points() { return kTileN; }
int dpdist_nn_min_max_chunk() { return kMaxChunk; }

// Blocks of the kernel an SM holds at once, or minus a CUDA error.
int dpdist_nn_min_blocks_per_sm(int device) {
  cudaError_t err = cudaSetDevice(device);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, nn_min_kernel, kThreads, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Fills dist with 0xFF bytes and launches the kernel on `stream` over
// `grid` blocks; returns cudaGetLastError() after the launch (0 on
// success) or cudaErrorInvalidValue for a plan the kernel does not take.
// The plan: `tiles` = ceil(N / kTileN) tiles of a per cloud, M cut into
// `splits` chunks of `chunk` points (a multiple of 4, at most kMaxChunk;
// the last chunk may be shorter), B * tiles * splits units.
int dpdist_nn_min_sqdist(const float* a, const float* p, float* dist, int B, int N, int M,
                         int tiles, int splits, int chunk, int grid, int device, void* stream) {
  const int64_t units = static_cast<int64_t>(B) * tiles * splits;
  if (B < 1 || N < 1 || M < 1 || tiles != (N + kTileN - 1) / kTileN || chunk < 4 ||
      chunk % 4 != 0 || chunk > kMaxChunk || splits != (M + chunk - 1) / chunk || grid < 1 ||
      grid > units || units >= (int64_t{1} << 31) || reinterpret_cast<uintptr_t>(p) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(dist, 0xFF, static_cast<size_t>(B) * N * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  nn_min_kernel<<<grid, kThreads, 0, s>>>(a, p, reinterpret_cast<unsigned*>(dist), N, M, tiles,
                                          splits, chunk, static_cast<int>(units));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
