// Fused 3DmFV encode + k^3 patch gather: points and queries -> decoder input.
//
// Replaces the TPU kernel dpdist_tpu/kernels/mfv_gather_pallas.py:_mfv_x_kernel
// (reached through mfv_table_gather_x). Same function, not the TPU layout:
// the TPU kernel builds a lanes-major (E, V) patch table and gathers with a
// one-hot matmul to feed its matrix unit; here one cloud's finalised FV
// volume (G x 20 floats, 40 KB at G = 512) sits in shared memory and the
// rows x[b, n, :] = [delta, patch] are built from it by index.
//
// What bounds it on an H100: the write of x. At 2B = 512 clouds and
// N = 64 queries that is 512*64*2503*4 B = 328 MB (0.098 ms at 3.35 TB/s);
// the inputs are 0.8 MB. The encode is ~17 M (point, Gaussian) pairs, a few
// tens of microseconds of the card's float32 units if it stood alone. The
// design hides the encode behind the stores, with warps specialised for
// each, in one persistent block per SM that walks the clouds b = blockIdx.x,
// b + gridDim.x, ...:
//   - the encode warps (one thread per Gaussian, at least 128 threads)
//     run the streaming encode of fv_encode.cuh on their own named barrier:
//     point tiles through shared memory, pools in registers, then the
//     finalisation over the whole cloud (signed sqrt, L2 norm over G). They
//     pool cloud i + 1 while the row warps write cloud i, and write a
//     cloud's channels into the block's one volume buffer only once the row
//     warps are done reading the previous cloud (barrier "empty"); then
//     they signal "full". The pools live in registers, so one volume buffer
//     is enough for the encode of one cloud to overlap the rows of another;
//   - the row warps (256 threads) take each cloud's rows in runs of at most
//     128: voxel id and delta of each query (cells strict below, inclusive
//     above; off-grid queries read cell 0; true division and ceilf, delta
//     = q - centre in float32), then the rows of row_groups.cuh: chunks of
//     4 elements of one neighbour cell (one window test and one 16-byte
//     shared load a chunk), built in shared memory in groups of R rows whose
//     span in x starts on a 16-byte boundary (4 float32 rows of 2,503, or 8
//     two-byte ones: 40,048 B either way), each group leaving by one bulk
//     store (cp.async.bulk) from a double buffer. A row off such a boundary
//     (the head or tail of a cloud's rows where N is not a multiple of R) is
//     written by per-thread stores; at N = 64 there is none.
// Shared memory at G = 512, k = 5: the volume (40 KB), the encode's
// scratch (67.8 KB), two group buffers (80 KB) and the run's row
// descriptions: 191 KB, one block per SM. Where the group buffers do not
// fit, every row is written by per-thread stores.
// What holds it on the card (PERF.md): not the stores' rate alone. The
// encode warps and the row warps share the SM's issue slots and shared
// memory, so each runs slower beside the other than alone, and the first
// cloud's encode on each SM is hidden by nothing.
//
// x is written as float32 or, for the bf16 and fp16 serving paths ("auto"
// in bfloat16 or float16), as bfloat16 or float16: each value rounded once
// to nearest even, as the reference's .astype(dtype) on its table and on
// delta (mfv_gather_pallas.py:169-175). Forward only. The encode is the
// code row 7 runs (threedmfv.cu), on a team of warps instead of the whole
// block, so its numerics are row 7's: true division where sigma is not a
// power of two, expf, the finalisation over the whole cloud.
//
// Plain C interface for ctypes; no PyTorch headers. Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
// (no --use_fast_math: it changes division and ceil at cell edges, and so
// which voxel a boundary point gets).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "fv_encode.cuh"
#include "patch_rows.cuh"
#include "row_groups.cuh"

namespace {

using dpdist::kWarp;

constexpr int kC = dpdist::kFvChannels;
constexpr int kRowThreads = 256;         // the row warps, where the block has room for them
constexpr int kMinEncodeThreads = 128;   // the encode stages a tile of 32 points x 3 floats
// Chunks a row thread keeps: 256 * 3 cover one row's 625, worked out once
// per kernel. At 5 (two rows) the kernel spilled registers and ran slower.
constexpr int kJ = 3;
// Named barriers: 0 is __syncthreads, which the kernel does not use.
constexpr int kEncodeBar = 1, kRowBar = 2, kFullBar = 3, kEmptyBar = 4;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// Warps [first / 32, (first + n) / 32) of the block, on named barrier id.
struct WarpTeam {
  int first, n, id;
  __device__ __forceinline__ int rank() const { return threadIdx.x - first; }
  __device__ __forceinline__ int size() const { return n; }
  __device__ __forceinline__ void sync() const { bar_sync(id, n); }
};

// What the host decides for one launch.
struct MfvPlan {
  int enc_threads;       // the encode warps' threads; the rest of the block builds rows
  int group_rows;        // R; 0: every row by per-thread stores
  uint32_t enc_off, buf_off, buf_stride, rows_off;
  size_t smem;           // 0: no layout fits
};

template <typename T, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads, 1)
    mfv_gather_x_kernel(const float* __restrict__ points,   // (B, M, 3)
                        const float* __restrict__ queries,  // (B, N, 3)
                        const float* __restrict__ mu,       // (G, 3)
                        const float* __restrict__ centers,  // (G, 3)
                        T* __restrict__ x,                  // (B, N, 3 + k^3*20)
                        int* __restrict__ vox_out,          // (B, N)
                        int B, int M, int N, int g, int k, dpdist::EncodeConsts consts,
                        const MfvPlan plan) {
  extern __shared__ __align__(128) unsigned char mfv_smem[];
  const int G = g * g * g;
  const int W = 3 + k * k * k * kC;
  const int ne = plan.enc_threads, nr = blockDim.x - ne, all = blockDim.x;
  float* fv_s = reinterpret_cast<float*>(mfv_smem);   // G * 20: the volume in hand

  if (threadIdx.x < ne) {
    // The encode warps: cloud after cloud into fv_s.
    const WarpTeam team{0, ne, kEncodeBar};
    float* enc_s = reinterpret_cast<float*>(mfv_smem + plan.enc_off);
    int it = 0;
    for (int b = blockIdx.x; b < B; b += gridDim.x, ++it) {
      float ch[kC];
      dpdist::encode_cloud(points + static_cast<size_t>(b) * M * 3, M, mu, G, consts, enc_s, ch,
                           team);
      if (it > 0) bar_sync(kEmptyBar, all);   // the row warps are done with the last volume
      if (team.rank() < G) {
#pragma unroll
        for (int c = 0; c < kC; ++c) fv_s[team.rank() * kC + c] = ch[c];
      }
      bar_arrive(kFullBar, all);
    }
    return;
  }

  // The row warps: each cloud's rows, in runs of at most kMaxRows.
  const WarpTeam team{ne, nr, kRowBar};
  const int t = team.rank();
  const int R = plan.group_rows;
  dpdist::XRow* rows_s = reinterpret_cast<dpdist::XRow*>(mfv_smem + plan.rows_off);
  const dpdist::QueryRows rows{queries, centers, vox_out, g, kC};
  dpdist::RunState<kJ> st;
  st.cached = dpdist::cached_rows(R, (W - 3) / 4, kJ * nr);
  st.ready = false;
  st.group = 0;
  auto sync = [&] { team.sync(); };
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    for (int n0 = 0; n0 < N; n0 += dpdist::kMaxRows) {
      const int n1 = min(N, n0 + dpdist::kMaxRows);
      const int64_t r0 = static_cast<int64_t>(b) * N + n0, r1 = r0 + (n1 - n0);
      for (int i = t; i < n1 - n0; i += nr) rows_s[i] = rows(r0 + i);
      if (n0 == 0) {
        bar_sync(kFullBar, all);   // the cloud's volume is in fv_s (and rows_s is written)
      } else {
        team.sync();
      }
      dpdist::emit_run<T, 4, 3>(x, rows_s, r0, r1, R, mfv_smem + plan.buf_off, plan.buf_stride,
                                st, fv_s, W, g, k, kC, t, nr, sync);
      team.sync();   // the run's rows and the volume are no longer read
    }
    if (b + static_cast<int>(gridDim.x) < B) bar_arrive(kEmptyBar, all);
  }
  if (t == 0) dpdist::bulk_wait_all();
}

// The layout for these sizes: the volume, the encode's scratch, two
// row-group buffers and a run's row descriptions; without the group
// buffers (rows by per-thread stores) where they do not fit.
MfvPlan plan_mfv(int g, int k, int out_bytes, bool x_aligned, int enc_threads, size_t max_smem) {
  MfvPlan p{};
  const int G = g * g * g;
  const int W = 3 + k * k * k * kC;
  p.enc_threads = enc_threads;
  p.enc_off = dpdist::align128(static_cast<size_t>(G) * kC * 4);
  const uint32_t enc_bytes =
      dpdist::align128(4 * dpdist::encode_smem_floats(G, enc_threads / kWarp));
  const int R = x_aligned ? dpdist::group_rows(W, out_bytes, 0) : 0;
  for (const int groups : {1, 0}) {
    if (groups && R == 0) continue;
    p.group_rows = groups ? R : 0;
    p.buf_off = p.enc_off + enc_bytes;
    p.buf_stride = groups ? dpdist::align128(static_cast<size_t>(R) * W * out_bytes) : 0;
    p.rows_off = p.buf_off + 2 * p.buf_stride;
    p.smem = p.rows_off + dpdist::kMaxRows * sizeof(dpdist::XRow);
    if (p.smem <= max_smem) return p;
  }
  p.smem = 0;
  return p;
}

}  // namespace

extern "C" {

const char* dpdist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most Gaussians the kernel takes: one encode thread each, and at
// least one warp for the rows in a block of 1,024.
int dpdist_mfv_gather_x_max_gaussians() { return 1024 - kWarp; }

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success) or cudaErrorInvalidValue for sizes or types the kernel does not
// take. x is of the type of out_type (dpdist::OutType: float32, bfloat16 or
// float16).
int dpdist_mfv_gather_x(const float* points, const float* queries, const float* mu,
                        const float* centers, void* x, int* vox, int B, int M, int N, int g,
                        int k, float sigma, float w, float pi_scale, float sw, float sw2,
                        float inv_m, int out_type, int device, void* stream) {
  const int G = g * g * g;
  const int out_bytes = dpdist::out_bytes(out_type);
  if (B < 1 || M < 1 || N < 1 || g < 1 || k < 1 || (k % 2) == 0 || k > 2 * g + 1 ||
      G > dpdist_mfv_gather_x_max_gaussians() || out_bytes == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_sm = 0, max_smem = 0;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device)) ||
      (err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)))
    return static_cast<int>(err);
  // The encode warps: one thread per Gaussian; the row warps: kRowThreads
  // in a block of at most 768 (80 registers a thread), else what a block of
  // 1,024 leaves (64 registers a thread).
  const int ne = std::max(kMinEncodeThreads, (G + kWarp - 1) / kWarp * kWarp);
  const bool small = ne + kRowThreads <= 768;
  const int threads = small ? ne + kRowThreads : 1024;
  const MfvPlan plan = plan_mfv(g, k, out_bytes, reinterpret_cast<uintptr_t>(x) % 16 == 0, ne,
                                max_smem);
  if (plan.smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  const dpdist::EncodeConsts consts = dpdist::make_consts(sigma, w, pi_scale, sw, sw2, inv_m);
  const auto s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel, auto* out) {
    cudaError_t e = dpdist::set_smem(kernel, plan.smem);
    if (e != cudaSuccess) return e;
    int per_sm = 0;   // persistent blocks: as many as fit on the card at once
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, plan.smem);
    if (e != cudaSuccess) return e;
    const int grid = std::min(B, n_sm * std::max(1, per_sm));
    kernel<<<grid, threads, plan.smem, s>>>(points, queries, mu, centers, out, vox, B, M, N, g, k,
                                            consts, plan);
    return cudaGetLastError();
  };
  err = dpdist::with_out_type(out_type, [&](auto* type) {
    using T = std::remove_pointer_t<decltype(type)>;
    return small ? launch(mfv_gather_x_kernel<T, 768>, static_cast<T*>(x))
                 : launch(mfv_gather_x_kernel<T, 1024>, static_cast<T*>(x));
  });
  return static_cast<int>(err);
}

}  // extern "C"
