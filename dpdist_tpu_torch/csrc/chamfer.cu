// Nearest-neighbour squared distances without the N x M matrix:
//   dist[b, n] = min over m of |a[b, n] - p[b, m]|^2.
//
// Replaces the TPU kernel dpdist_tpu/kernels/chamfer_pallas.py:_min_kernel
// (reached through nn_min_sqdist_pallas and chamfer_distance_pallas,
// `pl.pallas_call` at :74). Same math as that kernel and as the native
// pn_min_distances (dpdist_tpu/native/src/pointcloud_native.cpp:67-106):
// exact per-dimension squared differences (nvcc contracts them to FMA, so
// the last bits may differ from a plain PyTorch version), then a running
// minimum. The TPU kernel revisits a row-minimum block across a sequential
// grid axis over tiles of p; blocks on Hopper run in no order, so:
//
//   1. nn_min_partial_kernel: each thread owns kPts points of a and keeps
//      their running minima in registers while tiles of p, laid out as
//      x, y and z arrays (SoA), stream through shared memory; every thread
//      of a warp reads the same p point, a broadcast. The grid is
//      (point blocks, splits of M, B): a cloud of eval_pair's size (B = 1,
//      N = 10,000) has only 10 point blocks, so M is split until the grid
//      holds about two blocks per SM, and each split writes its partial
//      minima;
//   2. min_over_splits_kernel: the minimum over the splits (skipped when
//      there is one split, which then writes dist directly).
//
// What bounds it on an H100: operations, about 9 float32 operations per
// (a, p) pair (3 subtractions, 3 products, 2 additions, 1 minimum); at
// N = M = 10,000 that is 0.9 G operations per direction, against 0.3 MB of
// points read. A minimum does not depend on order, so the result is the
// same from run to run.
//
// Plain C interface for ctypes; no PyTorch headers. Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kPts = 4;        // points of a per thread
constexpr int kTileM = 1024;   // points of p per shared-memory tile

__global__ void nn_min_partial_kernel(const float* __restrict__ a,  // (B, N, 3)
                                      const float* __restrict__ p,  // (B, M, 3)
                                      float* __restrict__ out,      // (B, splits, N)
                                      int N, int M, int m_per_split) {
  __shared__ float px_s[kTileM], py_s[kTileM], pz_s[kTileM];
  const int b = blockIdx.z;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int base = blockIdx.x * blockDim.x * kPts + threadIdx.x;

  float ax[kPts], ay[kPts], az[kPts], best[kPts];
#pragma unroll
  for (int i = 0; i < kPts; ++i) {
    const int n = base + i * blockDim.x;
    const float* q = a + (static_cast<size_t>(b) * N + min(n, N - 1)) * 3;
    ax[i] = q[0];
    ay[i] = q[1];
    az[i] = q[2];
    best[i] = INFINITY;
  }

  const int m_begin = split * m_per_split;
  const int m_end = min(M, m_begin + m_per_split);
  const float* pb = p + static_cast<size_t>(b) * M * 3;
  for (int t0 = m_begin; t0 < m_end; t0 += kTileM) {
    const int T = min(kTileM, m_end - t0);
    __syncthreads();  // the previous tile is consumed
    for (int j = threadIdx.x; j < T; j += blockDim.x) {
      const float* q = pb + static_cast<size_t>(t0 + j) * 3;
      px_s[j] = q[0];
      py_s[j] = q[1];
      pz_s[j] = q[2];
    }
    __syncthreads();
    for (int j = 0; j < T; ++j) {
      const float x = px_s[j], y = py_s[j], z = pz_s[j];
#pragma unroll
      for (int i = 0; i < kPts; ++i) {
        const float dx = ax[i] - x, dy = ay[i] - y, dz = az[i] - z;
        best[i] = fminf(best[i], dx * dx + dy * dy + dz * dz);
      }
    }
  }

  float* ob = out + (static_cast<size_t>(b) * splits + split) * N;
#pragma unroll
  for (int i = 0; i < kPts; ++i) {
    const int n = base + i * blockDim.x;
    if (n < N) ob[n] = best[i];
  }
}

__global__ void min_over_splits_kernel(const float* __restrict__ partial,  // (B, splits, N)
                                       float* __restrict__ dist,           // (B, N)
                                       int B, int N, int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(B) * N) return;
  const size_t b = i / N, n = i % N;
  const float* pp = partial + b * splits * N + n;
  float m = pp[0];
  for (int s = 1; s < splits; ++s) m = fminf(m, pp[static_cast<size_t>(s) * N]);
  dist[i] = m;
}

}  // namespace

extern "C" {

// Points of a that one block of `threads` threads covers.
int dpdist_nn_min_points_per_block(int threads) { return threads * kPts; }

// Launches on `stream`; returns cudaGetLastError() after the launches (0 on
// success) or cudaErrorInvalidValue for sizes the kernels do not take.
// `partial` holds B * splits * N floats when splits > 1 (unused otherwise).
// Split s covers points [s * ceil(M / splits), ...) of p; a split left
// empty writes +inf, which never wins the minimum.
int dpdist_nn_min_sqdist(const float* a, const float* p, float* dist, float* partial, int B,
                         int N, int M, int splits, int threads, int device, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || M < 1 || splits < 1 || splits > 65535 || threads < 32 ||
      threads > 1024 || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m_per_split = (M + splits - 1) / splits;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_block = threads * kPts;
  const dim3 grid((N + per_block - 1) / per_block, splits, B);
  nn_min_partial_kernel<<<grid, threads, 0, s>>>(a, p, splits > 1 ? partial : dist, N, M,
                                                 m_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long total = static_cast<long long>(B) * N;
  const int reduce_threads = 256;
  min_over_splits_kernel<<<static_cast<unsigned>((total + reduce_threads - 1) / reduce_threads),
                           reduce_threads, 0, s>>>(partial, dist, B, N, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
