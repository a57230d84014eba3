// Streaming 3DmFV encode: (B, N, 3) points -> (B, G, 20) normalised full
// Fisher vectors, for any N.
//
// Replaces the TPU kernel dpdist_tpu/kernels/threedmfv_pallas.py:_kernel
// (reached through threedmfv_pallas, `pl.pallas_call` in
// _threedmfv_pallas_impl, whose XLA tail does the finalisation). The TPU
// kernel tiles points x G for its vector unit and revisits a (bt, 20, G)
// accumulator across a sequential grid axis; blocks on Hopper run in no
// order, so here one block owns one cloud: a thread per Gaussian keeps its
// 20 running pools (sum, max, min) in registers while point tiles of any N
// stream through shared memory, and the same block finalises (mean / N,
// signed sqrt, the L2 norm over G) and writes the (G, 20) layout. The encode
// itself is fv_encode.cuh, which mfv_gather.cu shares.
//
// What bounds it on an H100: operations. Each (point, Gaussian) pair costs
// about 50 float32 operations and an exp (its logit, the softmax, the 20
// pools), and the per-point softmax statistics recompute the logits; the
// bytes (N*3 floats in, G*20 out per cloud) are negligible. At B = 256
// clouds of N = 256 points and G = 512 that is 33.5 M pairs. One block per
// cloud fills the card at that batch; a single large cloud (eval_pair's
// B = 1) runs on one SM.
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

__global__ void threedmfv_kernel(const float* __restrict__ points,  // (B, N, 3)
                                 const float* __restrict__ mu,      // (G, 3)
                                 float* __restrict__ out,           // (B, G, 20)
                                 int N, int G, dpdist::EncodeConsts consts) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  float ch[kC];
  dpdist::encode_cloud(points + static_cast<size_t>(b) * N * 3, N, mu, G, consts, smem, ch);
  if (threadIdx.x < G) {
    float* o = out + (static_cast<size_t>(b) * G + threadIdx.x) * kC;
#pragma unroll
    for (int c = 0; c < kC; ++c) o[c] = ch[c];
  }
}

}  // namespace

extern "C" {

// Shared memory bytes the kernel takes; N does not matter.
size_t dpdist_threedmfv_smem(int G, int threads) {
  return 4 * dpdist::encode_smem_floats(G, threads / kWarp);
}

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success) or cudaErrorInvalidValue for sizes the kernel does not take.
// The scalars are those of dpdist::EncodeConsts for clouds of N points.
int dpdist_threedmfv(const float* points, const float* mu, float* out, int B, int N, int G,
                     float sigma, float w, float pi_scale, float sw, float sw2, float inv_n,
                     int threads, int device, void* stream) {
  if (B < 1 || N < 1 || G < 1 || G > threads || threads > 1024 || threads % kWarp != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = dpdist_threedmfv_smem(G, threads);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(threedmfv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dpdist::EncodeConsts consts{sigma, w, pi_scale, sw, sw2, inv_n};
  threedmfv_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(points, mu, out, N,
                                                                            G, consts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
