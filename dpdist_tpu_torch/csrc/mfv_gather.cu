// Fused 3DmFV encode + k^3 patch gather: points and queries -> decoder input.
//
// Replaces the TPU kernel dpdist_tpu/kernels/mfv_gather_pallas.py:_mfv_x_kernel
// (reached through mfv_table_gather_x). Same function, not the TPU layout:
// the TPU kernel builds a lanes-major (E, V) patch table and gathers with a
// one-hot matmul to feed its matrix unit; here one cloud's finalised FV
// volume (G x 20 floats, 40 KB at G = 512) sits in shared memory and each
// output element reads its value from there by index.
//
// One block per cloud b (the grid is the 2B stacked clouds):
//   1. the cloud's finalised FV volume, by the streaming encode of
//      fv_encode.cuh (point tiles through shared memory, one thread per
//      Gaussian pooling 20 channels, then signed sqrt and the L2 norm over
//      G), kept in shared memory;
//   2. voxel id and delta of each query (cells strict below, inclusive
//      above; off-grid queries read cell 0);
//   3. one warp per query row writes x[b, n, :] = [delta, patch], lanes on
//      neighbouring addresses; patch element e = o*20 + c reads channel c
//      of the neighbour voxel at offset o, or 0 outside the grid.
//
// x is written as float32 or, for the bf16 serving path ("auto" in
// bfloat16), as bfloat16: each value rounded once to nearest even, as the
// reference's .astype(dtype) on its table and on delta
// (mfv_gather_pallas.py:169-175). Forward only.
//
// What bounds it on an H100: the write of x. At 2B = 512 clouds and
// N = 64 queries that is 512*64*2503*4 B = 328 MB; the inputs are 0.8 MB
// and the encode is ~17 M exp. The design keeps everything else on chip
// (the FV volume and the patch table never reach device memory) and makes
// the write coalesced; the (o, c) split of the row walk is carried
// incrementally so no integer division sits in the write loop.
//
// Steps 2 and 3 use the helpers of patch_rows.cuh, which table_gather.cu
// shares; step 1 is the encode that threedmfv.cu runs alone.
//
// Plain C interface for ctypes; no PyTorch headers. Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
// (no --use_fast_math: it changes division and ceil at cell edges, and so
// which voxel a boundary point gets).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "fv_encode.cuh"
#include "patch_rows.cuh"

namespace {

using dpdist::kWarp;

constexpr int kC = dpdist::kFvChannels;

template <typename T>
__global__ void mfv_gather_x_kernel(const float* __restrict__ points,   // (B, M, 3)
                                    const float* __restrict__ queries,  // (B, N, 3)
                                    const float* __restrict__ mu,       // (G, 3)
                                    const float* __restrict__ centers,  // (G, 3)
                                    T* __restrict__ x,                  // (B, N, 3 + k^3*20)
                                    int* __restrict__ vox_out,          // (B, N)
                                    int M, int N, int g, int k, dpdist::EncodeConsts consts) {
  extern __shared__ float smem[];
  const int G = g * g * g;
  const int K3 = k * k * k;
  const int E = K3 * kC;
  const int W = 3 + E;
  const int nwarps = blockDim.x / kWarp;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int b = blockIdx.x;

  float* fv_s = smem;                                            // G * 20
  float* enc_s = fv_s + G * kC;                                  // the encode's scratch
  float* qd_s = enc_s + dpdist::encode_smem_floats(G, nwarps);   // N * 3
  int* qv_s = reinterpret_cast<int*>(qd_s + N * 3);              // N
  int* offs_s = qv_s + N;                                        // K3: flat neighbour offset
  char4* off3_s = reinterpret_cast<char4*>(offs_s + K3);         // K3: (sx, sy, sz)

  // 1. The FV volume of cloud b (the encode's barriers also publish the
  //    window offsets).
  dpdist::stage_window_offsets(offs_s, off3_s, g, k);
  float ch[kC];
  dpdist::encode_cloud(points + static_cast<size_t>(b) * M * 3, M, mu, G, consts, enc_s, ch);
  if (tid < G) {
#pragma unroll
    for (int c = 0; c < kC; ++c) fv_s[tid * kC + c] = ch[c];
  }

  // 2. Queries: voxel id (flat v = iy*g^2 + ix*g + iz) and delta.
  for (int n = tid; n < N; n += blockDim.x) {
    const float* q = queries + (static_cast<size_t>(b) * N + n) * 3;
    const int v = dpdist::assign_voxel(q, g);
    qv_s[n] = v;
    vox_out[static_cast<size_t>(b) * N + n] = v;
#pragma unroll
    for (int d = 0; d < 3; ++d) qd_s[n * 3 + d] = q[d] - centers[v * 3 + d];
  }
  __syncthreads();

  // 3. Rows of x: one warp per query, lanes on neighbouring addresses.
  for (int n = warp; n < N; n += nwarps)
    dpdist::write_x_row(x + (static_cast<size_t>(b) * N + n) * W, qd_s + n * 3, qv_s[n], fv_s,
                        offs_s, off3_s, g, kC, E, lane);
}

}  // namespace

extern "C" {

const char* dpdist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory bytes the kernel takes for these sizes; the encoded clouds
// stream through it, so their point count does not matter.
size_t dpdist_mfv_gather_x_smem(int N, int g, int k, int threads) {
  const size_t G = static_cast<size_t>(g) * g * g;
  const size_t K3 = static_cast<size_t>(k) * k * k;
  return 4 * (G * kC + dpdist::encode_smem_floats(static_cast<int>(G), threads / kWarp) +
              static_cast<size_t>(N) * 4 + K3 * 2);
}

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success) or cudaErrorInvalidValue for sizes the kernel does not take. x is
// float32, or bfloat16 where out_bf16 is set.
int dpdist_mfv_gather_x(const float* points, const float* queries, const float* mu,
                        const float* centers, void* x, int* vox, int B, int M, int N,
                        int g, int k, float sigma, float w, float pi_scale, float sw,
                        float sw2, float inv_m, int threads, int out_bf16, int device,
                        void* stream) {
  const int G = g * g * g;
  if (B < 1 || M < 1 || N < 1 || g < 1 || k < 1 || (k % 2) == 0 || G > threads ||
      threads > 1024 || threads % kWarp != 0 || k > 2 * g + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = dpdist_mfv_gather_x_smem(N, g, k, threads);
  const dpdist::EncodeConsts consts{sigma, w, pi_scale, sw, sw2, inv_m};
  const auto s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    err = dpdist::set_smem(mfv_gather_x_kernel<__nv_bfloat16>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    mfv_gather_x_kernel<<<B, threads, smem, s>>>(points, queries, mu, centers,
                                                 static_cast<__nv_bfloat16*>(x), vox, M, N, g, k,
                                                 consts);
  } else {
    err = dpdist::set_smem(mfv_gather_x_kernel<float>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    mfv_gather_x_kernel<<<B, threads, smem, s>>>(points, queries, mu, centers,
                                                 static_cast<float*>(x), vox, M, N, g, k, consts);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
