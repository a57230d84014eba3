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
// C = 20) sits in shared memory and each chunk of a row reads its values by
// index; the neighbour ids never reach device memory. A query whose mask is
// 0, or whose vox lies outside [0, V), gets a zero row: its row description
// places it far outside the grid, so every chunk's window test fails and no
// volume value is read. A pure copy: it equals the plain version exactly.
//
// What bounds it on an H100: device memory. At B = 256 clouds, N = 64
// queries, k = 5, C = 20 it writes 164 MB of float32 patches (about
// 0.05 ms at 3.35 TB/s) and reads 10.5 MB of volumes. The design is
// table_gather.cu's table_gather_x (row 2) without voxel assignment and
// delta, on the same code (row_groups.cuh:gather_rows), so that the copy
// engine writes while the threads build rows:
//   - one persistent block per SM walks work items (a cloud's run of at most
//     128 rows); each item's volume arrives by one bulk copy (cp.async.bulk,
//     completion on an mbarrier), the next item's volume loading into a
//     second buffer meanwhile;
//   - a row is k^3*C floats (10,000 B at the canonical sizes, so every row
//     starts 16-byte aligned); rows are built in shared memory in groups of
//     up to 40 KB (4 rows there) and each group leaves by one bulk store from
//     a double buffer;
//   - a thread builds chunks of 4 elements of one neighbour cell (C a
//     multiple of 4; else 1): one window test and one 16-byte shared load a
//     chunk.
// What holds it on the card is, as for row 2, the bulk stores' rate into
// device memory (PERF.md).
//
// Plain C interface for ctypes; no PyTorch headers. Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "patch_rows.cuh"
#include "row_groups.cuh"

namespace {

constexpr int kThreads = 512;        // threads of a block
constexpr int kGroupBytes = 40064;   // a row group's size, as row 2's

// The patch rows of given voxels, zero where the mask is not positive or
// the voxel lies outside the grid.
struct MaskedRows {
  static constexpr int kLead = 0;
  const int* vox;      // (rows,)
  const float* mask;   // (rows,)
  int g, C;

  __device__ __forceinline__ dpdist::XRow operator()(int64_t r) const {
    const int v = vox[r];
    return (mask[r] > 0.f && v >= 0 && v < g * g * g) ? dpdist::cell_row(v, g, C)
                                                      : dpdist::zero_row();
  }
};

// CW: elements per chunk (4 where C is a multiple of 4, else 1); J: chunks
// per thread per pass, so that 512 * 5 * 4 covers a group of 4 rows at
// k^3*C = 2,500.
template <int CW, int J>
__global__ void __launch_bounds__(kThreads, 1)
    gather_fused_kernel(const float* __restrict__ fv,    // (B, G, C)
                        const int* __restrict__ vox,     // (B, N)
                        const float* __restrict__ mask,  // (B, N)
                        float* __restrict__ out,         // (B, N, k^3*C)
                        int N, int g, int k, int C, const dpdist::XPlan plan) {
  dpdist::gather_rows<kThreads, float, CW, J>(fv, out, N, g, k, C, k * k * k * C, plan,
                                              MaskedRows{vox, mask, g, C});
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success) or cudaErrorInvalidValue for sizes the kernel does not take.
int dpdist_gather_patches_fused(const float* fv, const int* vox, const float* mask, float* out,
                                int B, int N, int g, int k, int C, int device, void* stream) {
  if (B < 1 || N < 1 || g < 1 || k < 1 || (k % 2) == 0 || k > 2 * g + 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_sm = 0, max_smem = 0, sm_smem = 0;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device)) ||
      (err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) ||
      (err = cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                    device)))
    return static_cast<int>(err);
  const dpdist::XPlan plan = dpdist::plan_rows(
      B, N, g * g * g, C, k * k * k * C, 4, kGroupBytes,
      reinterpret_cast<uintptr_t>(fv) % 16 == 0, reinterpret_cast<uintptr_t>(out) % 16 == 0,
      n_sm, max_smem);
  if (plan.smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  // Persistent blocks: as many as fit on the card at once, or one per item.
  const int per_sm =
      std::max(1, std::min(2048 / kThreads, sm_smem / static_cast<int>(plan.smem + 1024)));
  const int grid = std::min(plan.n_items, n_sm * per_sm);
  auto kernel = C % 4 == 0 ? gather_fused_kernel<4, 5> : gather_fused_kernel<1, 5>;
  err = dpdist::set_smem(kernel, plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, plan.smem, static_cast<cudaStream_t>(stream)>>>(fv, vox, mask, out, N,
                                                                          g, k, C, plan);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
