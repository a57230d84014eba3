// Per-query patch gather with the query's membership mask: the C channels
// of each (query, offset) row's neighbour cell, zero where that neighbour
// lies outside the grid or where the query itself is off the grid.
//
// Replaces the TPU kernel dpdist_tpu/kernels/gather_pallas.py:_kernel
// (reached through gather_patches_fused, `pl.pallas_call` in
// _gather_fused_impl, with neighbor_ids built in XLA before it): from a
// cloud's (V, C) FV volume, its queries' voxels and mask, the (N, k^3*C)
// patches, which equal gather_patches(extract_patches(fv), vox) * mask. The
// TPU kernel one-hot encodes each tile of (query, offset) rows against the
// voxel axis and runs a (tile, V) @ (V, C) matmul, which exists only to feed
// its matrix unit. Here the volume (40 KB float32 at the canonical V = 512,
// C = 20) sits in shared memory and each element of a row reads its value by
// index (patch_rows.cuh:gather_patch_rows, the body of table_gather.cu's
// patch-only gather): one block per (cloud, tile of queries), one warp per
// query row, lanes on neighbouring addresses. The neighbour ids never reach
// device memory. Unlike the patch-only gather, a query whose mask is 0 gets a
// zero row, not cell 0's patch. A pure copy: it equals the plain version
// exactly.
//
// What bounds it on an H100: device memory. At B = 256 clouds, N = 64
// queries, k = 5, C = 20 it writes 164 MB of float32 patches (about
// 0.05 ms at 3.35 TB/s) and reads 10.5 MB of volumes.
//
// Plain C interface for ctypes; no PyTorch headers. Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <stddef.h>

#include "patch_rows.cuh"

namespace {

using dpdist::kWarp;

__global__ void gather_fused_kernel(const float* __restrict__ fv,    // (B, G, C)
                                    const int* __restrict__ vox,     // (B, N)
                                    const float* __restrict__ mask,  // (B, N)
                                    float* __restrict__ out,         // (B, N, k^3*C)
                                    int N, int g, int k, int C, int rows_per_block) {
  dpdist::gather_patch_rows(fv, vox, out, N, g, k, C, rows_per_block,
                            [&](size_t row) { return mask[row] > 0.f; });
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success) or cudaErrorInvalidValue for sizes the kernel does not take.
// Shared memory: dpdist_table_gather_smem(g, k, C) bytes.
int dpdist_gather_patches_fused(const float* fv, const int* vox, const float* mask, float* out,
                                int B, int N, int g, int k, int C, int rows_per_block,
                                int threads, int device, void* stream) {
  if (B < 1 || N < 1 || g < 1 || k < 1 || (k % 2) == 0 || k > 2 * g + 1 || C < 1 ||
      rows_per_block < 1 || threads < kWarp || threads > 1024 || threads % kWarp != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = 4 * dpdist::patch_rows_smem_floats(g, k, C);
  err = dpdist::set_smem(gather_fused_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, (N + rows_per_block - 1) / rows_per_block);
  gather_fused_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      fv, vox, mask, out, N, g, k, C, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
