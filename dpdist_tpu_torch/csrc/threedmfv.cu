// Streaming 3DmFV encode: (B, N, 3) points -> (B, G, 20) normalised full
// Fisher vectors, for any N.
//
// Replaces the TPU kernel dpdist_tpu/kernels/threedmfv_pallas.py:_kernel
// (reached through threedmfv_pallas, `pl.pallas_call` in
// _threedmfv_pallas_impl, whose XLA tail does the finalisation). The TPU
// kernel tiles points x G for its vector unit and revisits a (bt, 20, G)
// accumulator across a sequential grid axis; blocks on Hopper run in no
// order, so the revisited accumulator becomes partial pools and a merge:
//   1. `partial_kernel`, grid (B, S): block (b, s) folds chunk s of cloud
//      b's points (`chunk` points, the last one ragged) into per-Gaussian
//      pools (sum, max, min of the 20 channels) with fv_encode.cuh's
//      pool_points, and writes them to float32 scratch (B, S, 20, G) that
//      the wrapper allocates. At S = 1 the block finalises its cloud
//      itself and step 2 is skipped: one launch;
//   2. `merge_kernel`, one block per cloud and group of channels (more
//      groups where there are few clouds; one block per cloud writes its
//      result coalesced from shared memory): merges the S partials in the order s = 0, 1, ... (sums add; max and min take max
//      and min), so the result is the same from run to run, then finalises
//      (mean over the whole cloud's N, signed sqrt, the L2 norm over G in a
//      fixed order) and writes the (G, 20) layout.
// The wrapper (kernels/threedmfv.py:split_plan) picks S so that B*S about
// fills the card's two blocks per SM with chunks of whole 32-point tiles:
// at B = 1, N = 10,000 (eval_pair) 157 blocks share the cloud; from
// B = 133 on, S = 1. pi_scale and 1/N are the whole cloud's, never a
// chunk's.
//
// What bounds it on an H100: operations. Each (point, Gaussian) pair costs
// about 50 float32 operations and an exp (its logit, the softmax, the 20
// pools); the bytes (N*3 floats in, G*20 out per cloud, the partials) are
// small. At B = 256 clouds of N = 256 points and G = 512 that is 33.5 M
// pairs; fv_encode.cuh computes each logit once.
//
// Plain C interface for ctypes; no PyTorch headers. Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
// (no --use_fast_math; expf, not __expf).

#include <cuda_runtime.h>
#include <stddef.h>

#include "fv_encode.cuh"

namespace {

using dpdist::kWarp;

constexpr int kC = dpdist::kFvChannels;

// Block (b, s) folds chunk s of cloud b into partial pools. With S = 1
// (kFinal) the block holds the whole cloud and finalises it directly,
// writing the (G, 20) result coalesced through shared memory. At most 64
// registers a thread, so two 512-thread blocks share an SM.
template <bool kFinal>
__global__ void __launch_bounds__(1024)
    partial_kernel(const float* __restrict__ points,  // (B, N, 3)
                   const float* __restrict__ mu,      // (G, 3)
                   float* __restrict__ partial,       // (B, S, 20, G); kFinal: out (B, G, 20)
                   int N, int chunk, int G, dpdist::EncodeConsts consts) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const int n0 = s * chunk;
  dpdist::Pools pools;
  dpdist::init_pools(pools);
  dpdist::pool_points(points + (static_cast<size_t>(b) * N + n0) * 3, min(chunk, N - n0), mu, G,
                      consts, smem, pools);
  if (kFinal) {
    float ch[kC];
    dpdist::finalize_channels(pools, G, consts, smem, ch);
    if (threadIdx.x < G) {
#pragma unroll
      for (int c = 0; c < kC; ++c) smem[threadIdx.x * kC + c] = ch[c];   // the logit tile is free
    }
    __syncthreads();
    float* ob = partial + static_cast<size_t>(b) * G * kC;
    for (int i = threadIdx.x; i < G * kC; i += blockDim.x) ob[i] = smem[i];
  } else if (threadIdx.x < G) {
    float* o = partial + (static_cast<size_t>(b) * S + s) * kC * G + threadIdx.x;
#pragma unroll
    for (int c = 0; c < kC; ++c) o[static_cast<size_t>(c) * G] = pools.v[c];
  }
}

// Block (b, y): channels c = y, y + gridDim.y, ... of cloud b, thread j
// for Gaussian j; one block reduction for all of them. With one block per
// cloud (gridDim.y == 1) the (G, 20) result is staged in shared memory
// (out_s, G * 20 floats) and written in one coalesced run.
__global__ void merge_kernel(const float* __restrict__ partial,  // (B, S, 20, G)
                             float* __restrict__ out,            // (B, G, 20)
                             int S, int G, dpdist::EncodeConsts consts) {
  extern __shared__ float out_s[];
  __shared__ float red_s[1024 / kWarp * kC];
  __shared__ float nrm_s[kC];
  const int b = blockIdx.x, y = blockIdx.y, gy = gridDim.y;
  const int j = threadIdx.x, lane = j % kWarp, warp = j / kWarp;
  float ch[kC];
#pragma unroll
  for (int k = 0; k < kC; ++k) {
    const int c = y + k * gy;
    ch[k] = 0.f;
    if (c < kC && j < G) {
      const int kind = dpdist::pool_kind(c);
      float v = kind == 0 ? 0.f : (kind == 1 ? -INFINITY : INFINITY);
      const float* p = partial + (static_cast<size_t>(b) * S * kC + c) * G + j;
#pragma unroll 4
      for (int s = 0; s < S; ++s) {
        const float x = p[static_cast<size_t>(s) * kC * G];
        v = kind == 0 ? v + x : (kind == 1 ? fmaxf(v, x) : fminf(v, x));
      }
      ch[k] = dpdist::channel_value(c, v, consts);
    }
  }
  // 1 / the L2 norm over G of each channel, summed in a fixed order.
#pragma unroll
  for (int k = 0; k < kC; ++k) {
    const float s = dpdist::warp_sum(ch[k] * ch[k]);
    if (lane == 0) red_s[warp * kC + k] = s;
  }
  __syncthreads();
  if (j < kC) {
    float t = 0.f;
    for (int i = 0; i < static_cast<int>(blockDim.x / kWarp); ++i) t += red_s[i * kC + j];
    nrm_s[j] = 1.f / sqrtf(fmaxf(t, dpdist::kFvEps));
  }
  __syncthreads();
  float* ob = out + static_cast<size_t>(b) * G * kC;
#pragma unroll
  for (int k = 0; k < kC; ++k) {
    const int c = y + k * gy;
    if (c < kC && j < G) (gy == 1 ? out_s : ob)[j * kC + c] = ch[k] * nrm_s[k];
  }
  if (gy == 1) {
    __syncthreads();
    for (int i = j; i < G * kC; i += blockDim.x) ob[i] = out_s[i];
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory bytes the partial kernel takes; N does not matter.
size_t dpdist_threedmfv_smem(int G, int threads) {
  return 4 * dpdist::encode_smem_floats(G, threads / kWarp);
}

// Launches the partial pass over a (B, S) grid and the merge over a
// (B, merge_groups) grid on `stream`, or at S = 1 the one pass that
// finalises; returns the first cudaGetLastError() that is not 0 (0 on
// success), or cudaErrorInvalidValue for sizes the kernels do not take.
// partial is (B, S, 20, G) float32 scratch (unused at S = 1); chunks of
// `chunk` points must cover N with none empty: (S - 1) * chunk < N <=
// S * chunk. The scalars are those of dpdist::EncodeConsts for clouds of N
// points.
int dpdist_threedmfv(const float* points, const float* mu, float* partial, float* out, int B,
                     int N, int S, int chunk, int merge_groups, int G, float sigma, float w,
                     float pi_scale, float sw, float sw2, float inv_n, int threads, int device,
                     void* stream) {
  if (B < 1 || N < 1 || S < 1 || S > 65535 || chunk < 1 || merge_groups < 1 ||
      merge_groups > kC ||
      static_cast<long long>(S - 1) * chunk >= N || static_cast<long long>(S) * chunk < N ||
      G < 1 || G > threads || threads > 1024 || threads % kWarp != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = dpdist_threedmfv_smem(G, threads);
  const dpdist::EncodeConsts consts = dpdist::make_consts(sigma, w, pi_scale, sw, sw2, inv_n);
  const auto s = static_cast<cudaStream_t>(stream);
  if (S == 1) {
    err = dpdist::set_smem(partial_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    partial_kernel<true><<<dim3(B, 1), threads, smem, s>>>(points, mu, out, N, chunk, G, consts);
    return static_cast<int>(cudaGetLastError());
  }
  err = dpdist::set_smem(partial_kernel<false>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  partial_kernel<false><<<dim3(B, S), threads, smem, s>>>(points, mu, partial, N, chunk, G, consts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t out_smem = merge_groups == 1 ? static_cast<size_t>(G) * kC * sizeof(float) : 0;
  err = dpdist::set_smem(merge_kernel, out_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<dim3(B, merge_groups), threads, out_smem, s>>>(partial, out, S, G, consts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
