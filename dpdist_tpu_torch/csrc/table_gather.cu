// Patch gather from a Fisher-vector volume, and its adjoint.
//
// table_gather_x replaces the TPU kernel
// dpdist_tpu/kernels/table_gather_pallas.py:_x_kernel (reached through
// table_gather_x, `pl.pallas_call` in _table_gather_x_impl): from a cloud's
// (V, C) FV volume and its (N, 3) queries it writes the decoder input
// x = [delta, patch] (N, 3 + k^3*C) and each query's voxel. The TPU kernel
// builds a (V, k^3*C) patch table in VMEM and gathers rows with a one-hot
// matmul for its matrix unit; here the (V, C) volume (40 KB at the canonical
// V = 512, C = 20) sits in shared memory and every element of x reads its
// value by index, so the patch table never exists. One block per (cloud,
// tile of queries); one warp per query row, lanes on neighbouring addresses.
// The output is a pure copy plus q - centre, so it equals the plain
// PyTorch composition exactly.
//
// table_gather replaces the TPU kernel
// dpdist_tpu/kernels/table_gather_pallas.py:_kernel (reached through
// table_gather, `pl.pallas_call` in _table_gather_impl): the same patch rows
// without voxel assignment and delta, for given voxel ids,
// (V, C) volume + (N,) vox -> (N, k^3*C). The reference takes it for
// N > 128 queries, where its VMEM budget forces that split. Here it is
// table_gather_x's design without the delta: the volume in shared memory,
// one warp per row. Off-grid queries carry vox = 0 and read cell 0's patch,
// as the reference does; the model's mask zeroes them later. A vox outside
// [0, V) (never made by voxel_assign) gives a zero row. A pure copy: it
// equals the plain gather_patches(extract_patches(fv), vox) exactly.
//
// table_gather_bwd replaces dpdist_tpu/kernels/table_gather_pallas.py:
// _bwd_kernel + _fold_and_emit (`pl.pallas_call` in _table_gather_bwd_impl),
// and with it the two V-in-lanes layouts of the same adjoint
// (_table_gather_bwd_transposed_ng, _table_gather_bwd_transposed):
//   dfv[v, c] = sum of grad[n, o*C + c] over the (n, o) whose neighbour of
//   vox[n] at offset o is v; neighbours outside the grid add nothing.
// On the TPU it is a transposed one-hot matmul and a fold; here it is a
// scatter-add. One block per cloud keeps a (V, C) float32 accumulator in
// shared memory; for each query in turn the block's threads walk its k^3*C
// grad entries coalesced and add each into the accumulator. Within one
// query distinct offsets hit distinct voxels, so no two threads add into
// one slot, and a barrier between queries fixes the order of the sums:
// the result is the same from run to run (no atomics). Off-grid queries
// carry vox = 0 and scatter into cell 0's neighbourhood, as the reference
// does; the kernel follows vox, never the mask.
//
// What bounds all three on an H100: device memory. At B = 256 clouds,
// N = 64 queries, k = 5, C = 20, table_gather_x writes 164 MB of x and
// table_gather_bwd reads 164 MB of grad (about 0.05 ms each at 3.35 TB/s);
// at N = 256, table_gather writes 655 MB (about 0.2 ms); the volumes are
// 10 MB. The designs keep the volume on chip, touch each
// x / grad element once, coalesced, and do no integer division per element.
//
// Plain C interface for ctypes; no PyTorch headers. Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <stdint.h>

#include "patch_rows.cuh"

namespace {

using dpdist::kWarp;

__global__ void table_gather_x_kernel(const float* __restrict__ fv,       // (B, G, C)
                                      const float* __restrict__ queries,  // (B, N, 3)
                                      const float* __restrict__ centers,  // (G, 3)
                                      float* __restrict__ x,              // (B, N, 3 + k^3*C)
                                      int* __restrict__ vox_out,          // (B, N)
                                      int N, int g, int k, int C, int rows_per_block) {
  extern __shared__ float smem[];
  const int G = g * g * g;
  const int K3 = k * k * k;
  const int E = K3 * C;
  const int W = 3 + E;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int nwarps = blockDim.x / kWarp;
  const int b = blockIdx.x;
  const int n0 = blockIdx.y * rows_per_block;
  const int n1 = min(N, n0 + rows_per_block);

  float* fv_s = smem;                                     // G * C
  int* offs_s = reinterpret_cast<int*>(fv_s + G * C);     // K3
  char4* off3_s = reinterpret_cast<char4*>(offs_s + K3);  // K3

  const float* fb = fv + static_cast<size_t>(b) * G * C;
  for (int i = threadIdx.x; i < G * C; i += blockDim.x) fv_s[i] = fb[i];
  dpdist::stage_window_offsets(offs_s, off3_s, g, k);
  __syncthreads();

  for (int n = n0 + warp; n < n1; n += nwarps) {
    const size_t row = static_cast<size_t>(b) * N + n;
    const float* q = queries + row * 3;
    const int v = dpdist::assign_voxel(q, g);   // every lane, same value
    if (lane == 0) vox_out[row] = v;
    float delta[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) delta[d] = q[d] - centers[v * 3 + d];
    dpdist::write_x_row(x + row * W, delta, v, fv_s, offs_s, off3_s, g, C, E, lane);
  }
}

__global__ void table_gather_kernel(const float* __restrict__ fv,   // (B, G, C)
                                    const int* __restrict__ vox,    // (B, N)
                                    float* __restrict__ out,        // (B, N, k^3*C)
                                    int N, int g, int k, int C, int rows_per_block) {
  extern __shared__ float smem[];
  const int G = g * g * g;
  const int K3 = k * k * k;
  const int E = K3 * C;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int nwarps = blockDim.x / kWarp;
  const int b = blockIdx.x;
  const int n0 = blockIdx.y * rows_per_block;
  const int n1 = min(N, n0 + rows_per_block);

  float* fv_s = smem;                                     // G * C
  int* offs_s = reinterpret_cast<int*>(fv_s + G * C);     // K3
  char4* off3_s = reinterpret_cast<char4*>(offs_s + K3);  // K3

  const float* fb = fv + static_cast<size_t>(b) * G * C;
  for (int i = threadIdx.x; i < G * C; i += blockDim.x) fv_s[i] = fb[i];
  dpdist::stage_window_offsets(offs_s, off3_s, g, k);
  __syncthreads();

  for (int n = n0 + warp; n < n1; n += nwarps) {
    const size_t row = static_cast<size_t>(b) * N + n;
    const int v = vox[row];   // every lane, same value
    float* orow = out + row * E;
    if (v >= 0 && v < G) {
      dpdist::write_patch_row(orow, v, fv_s, offs_s, off3_s, g, C, E, lane);
    } else {
      for (int e = lane; e < E; e += kWarp) orow[e] = 0.f;
    }
  }
}

__global__ void table_gather_bwd_kernel(const int* __restrict__ vox,     // (B, N)
                                        const float* __restrict__ grad,  // (B, N, k^3*C), strided
                                        int64_t stride_b, int64_t stride_n,
                                        float* __restrict__ dfv,         // (B, G, C)
                                        int N, int g, int k, int C) {
  extern __shared__ float smem[];
  const int G = g * g * g;
  const int K3 = k * k * k;
  const int E = K3 * C;
  const int b = blockIdx.x;

  float* acc = smem;                                      // G * C
  int* offs_s = reinterpret_cast<int*>(acc + G * C);      // K3
  char4* off3_s = reinterpret_cast<char4*>(offs_s + K3);  // K3

  for (int i = threadIdx.x; i < G * C; i += blockDim.x) acc[i] = 0.f;
  dpdist::stage_window_offsets(offs_s, off3_s, g, k);
  __syncthreads();

  const float* gb = grad + b * stride_b;
  for (int n = 0; n < N; ++n) {
    const int v = vox[static_cast<size_t>(b) * N + n];
    if (v >= 0 && v < G) {   // the same for every thread of the block
      const float* grow = gb + n * stride_n;
      dpdist::for_each_patch_element(v, threadIdx.x, blockDim.x, g, C, E, offs_s, off3_s,
                                     [&](int e, int u, int c) {
                                       if (u >= 0) acc[u * C + c] += grow[e];
                                     });
    }
    __syncthreads();
  }

  float* db = dfv + static_cast<size_t>(b) * G * C;
  for (int i = threadIdx.x; i < G * C; i += blockDim.x) db[i] = acc[i];
}

bool bad_window(int g, int k, int C) {
  return g < 1 || k < 1 || (k % 2) == 0 || k > 2 * g + 1 || C < 1;
}

}  // namespace

extern "C" {

// Shared memory bytes each kernel takes: the (G, C) volume and the
// window's offset tables.
size_t dpdist_table_gather_smem(int g, int k, int C) {
  const size_t G = static_cast<size_t>(g) * g * g;
  const size_t K3 = static_cast<size_t>(k) * k * k;
  return 4 * (G * C + K3 * 2);
}

// All three launch on `stream` and return cudaGetLastError() after the launch (0
// on success) or cudaErrorInvalidValue for sizes the kernels do not take.
int dpdist_table_gather_x(const float* fv, const float* queries, const float* centers, float* x,
                          int* vox, int B, int N, int g, int k, int C, int rows_per_block,
                          int threads, int device, void* stream) {
  if (B < 1 || N < 1 || bad_window(g, k, C) || rows_per_block < 1 || threads < kWarp ||
      threads > 1024 || threads % kWarp != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = dpdist_table_gather_smem(g, k, C);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(table_gather_x_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B, (N + rows_per_block - 1) / rows_per_block);
  table_gather_x_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      fv, queries, centers, x, vox, N, g, k, C, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

int dpdist_table_gather(const float* fv, const int* vox, float* out, int B, int N, int g, int k,
                        int C, int rows_per_block, int threads, int device, void* stream) {
  if (B < 1 || N < 1 || bad_window(g, k, C) || rows_per_block < 1 || threads < kWarp ||
      threads > 1024 || threads % kWarp != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = dpdist_table_gather_smem(g, k, C);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(table_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B, (N + rows_per_block - 1) / rows_per_block);
  table_gather_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      fv, vox, out, N, g, k, C, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

int dpdist_table_gather_bwd(const int* vox, const float* grad, int64_t stride_b, int64_t stride_n,
                            float* dfv, int B, int N, int g, int k, int C, int threads,
                            int device, void* stream) {
  if (B < 1 || N < 1 || bad_window(g, k, C) || threads < kWarp || threads > 1024 ||
      threads % kWarp != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = dpdist_table_gather_smem(g, k, C);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(table_gather_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  table_gather_bwd_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      vox, grad, stride_b, stride_n, dfv, N, g, k, C);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
