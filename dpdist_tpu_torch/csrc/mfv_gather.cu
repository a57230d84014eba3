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
//   1. stage the cloud's M points and the Gaussian centres in shared memory;
//   2. softmax statistics per point (max and sum of exp over G), one warp
//      per point with shuffles;
//   3. one thread per Gaussian pools the 20 channels over the M points
//      (sum, max, min), then the finalize: mean rows divided by M, signed
//      sqrt, and an L2 norm per channel over G (block reduction);
//   4. voxel id and delta of each query (cells strict below, inclusive
//      above; off-grid queries read cell 0);
//   5. one warp per query row writes x[b, n, :] = [delta, patch], lanes on
//      neighbouring addresses; patch element e = o*20 + c reads channel c
//      of the neighbour voxel at offset o, or 0 outside the grid.
//
// What bounds it on an H100: the write of x. At 2B = 512 clouds and
// N = 64 queries that is 512*64*2503*4 B = 328 MB; the inputs are 0.8 MB
// and the encode is ~17 M exp. The design keeps everything else on chip
// (the FV volume and the patch table never reach device memory) and makes
// the write coalesced; the (o, c) split of the row walk is carried
// incrementally so no integer division sits in the write loop.
//
// Steps 1 (offsets), 4 and 5 use the helpers of patch_rows.cuh, which
// table_gather.cu shares.
//
// Plain C interface for ctypes; no PyTorch headers. Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
// (no --use_fast_math: it changes division and ceil at cell edges, and so
// which voxel a boundary point gets).

#include <cuda_runtime.h>
#include <math.h>

#include "patch_rows.cuh"

namespace {

using dpdist::kWarp;

constexpr int kC = 20;          // FV channels (full_fv, D = 3)
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// -0.5 * ||(p - mu) / sigma||^2, the per-dimension form of the TPU kernel.
__device__ __forceinline__ float logit_of(float px, float py, float pz,
                                          float mx, float my, float mz, float sigma) {
  const float dx = (px - mx) / sigma;
  const float dy = (py - my) / sigma;
  const float dz = (pz - mz) / sigma;
  return -0.5f * (dx * dx + dy * dy + dz * dz);
}

__device__ __forceinline__ float signed_sqrt(float v) {
  const float s = (v > 0.f) ? 1.f : ((v < 0.f) ? -1.f : 0.f);
  return s * sqrtf(fmaxf(fabsf(v), kEps));
}

__global__ void mfv_gather_x_kernel(const float* __restrict__ points,   // (B, M, 3)
                                    const float* __restrict__ queries,  // (B, N, 3)
                                    const float* __restrict__ mu,       // (G, 3)
                                    const float* __restrict__ centers,  // (G, 3)
                                    float* __restrict__ x,              // (B, N, 3 + k^3*20)
                                    int* __restrict__ vox_out,          // (B, N)
                                    int M, int N, int g, int k, float sigma,
                                    float w, float pi_scale, float sw, float sw2,
                                    float inv_m) {
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

  float* fv_s = smem;                    // G * 20
  float* mu_s = fv_s + G * kC;           // G * 3
  float* pts_s = mu_s + G * 3;           // M * 3
  float* pmax_s = pts_s + M * 3;         // M
  float* psum_s = pmax_s + M;            // M
  float* red_s = psum_s + M;             // nwarps * 20
  float* nrm_s = red_s + nwarps * kC;    // 20
  float* qd_s = nrm_s + kC;              // N * 3
  int* qv_s = reinterpret_cast<int*>(qd_s + N * 3);  // N
  int* offs_s = qv_s + N;                // K3: flat neighbour offset
  char4* off3_s = reinterpret_cast<char4*>(offs_s + K3);  // K3: (sx, sy, sz)

  // 1. Stage points, centres and the k^3 offsets.
  const float* pb = points + static_cast<size_t>(b) * M * 3;
  for (int i = tid; i < M * 3; i += blockDim.x) pts_s[i] = pb[i];
  for (int i = tid; i < G * 3; i += blockDim.x) mu_s[i] = mu[i];
  dpdist::stage_window_offsets(offs_s, off3_s, g, k);
  __syncthreads();

  // 2. Softmax statistics over G per point: one warp per point.
  for (int m = warp; m < M; m += nwarps) {
    const float px = pts_s[m * 3], py = pts_s[m * 3 + 1], pz = pts_s[m * 3 + 2];
    float mx = -INFINITY;
    for (int j = lane; j < G; j += kWarp)
      mx = fmaxf(mx, logit_of(px, py, pz, mu_s[j * 3], mu_s[j * 3 + 1], mu_s[j * 3 + 2], sigma));
    mx = warp_max(mx);
    float s = 0.f;
    for (int j = lane; j < G; j += kWarp)
      s += expf(logit_of(px, py, pz, mu_s[j * 3], mu_s[j * 3 + 1], mu_s[j * 3 + 2], sigma) - mx);
    s = warp_sum(s);
    if (lane == 0) {
      pmax_s[m] = mx;
      psum_s[m] = s;
    }
  }
  __syncthreads();

  // 3. Pool the 20 channels over the points: thread j owns Gaussian j.
  float ch[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) ch[c] = 0.f;
  const int j = tid;
  if (j < G) {
    const float mx = mu_s[j * 3], my = mu_s[j * 3 + 1], mz = mu_s[j * 3 + 2];
    float pi_sum = 0.f, pi_max = -INFINITY;
    float mu_sum[3] = {0.f, 0.f, 0.f}, mu_max[3], mu_min[3];
    float sg_sum[3] = {0.f, 0.f, 0.f}, sg_max[3], sg_min[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      mu_max[d] = -INFINITY; mu_min[d] = INFINITY;
      sg_max[d] = -INFINITY; sg_min[d] = INFINITY;
    }
    for (int m = 0; m < M; ++m) {
      const float px = pts_s[m * 3], py = pts_s[m * 3 + 1], pz = pts_s[m * 3 + 2];
      const float q = expf(logit_of(px, py, pz, mx, my, mz, sigma) - pmax_s[m]) / psum_s[m];
      const float dpi = (q - w) / pi_scale;
      pi_sum += dpi;
      pi_max = fmaxf(pi_max, dpi);
      const float diff[3] = {(px - mx) / sigma, (py - my) / sigma, (pz - mz) / sigma};
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float tm = q * diff[d];
        const float ts = q * (diff[d] * diff[d] - 1.f);
        mu_sum[d] += tm;
        mu_max[d] = fmaxf(mu_max[d], tm);
        mu_min[d] = fminf(mu_min[d], tm);
        sg_sum[d] += ts;
        sg_max[d] = fmaxf(sg_max[d], ts);
        sg_min[d] = fminf(sg_min[d], ts);
      }
    }
    // Channel rows: [pi_mean, pi_max, mu_mean(3), mu_max(3), mu_min(3),
    //                sig_mean(3), sig_max(3), sig_min(3)]; mean rows / M.
    ch[0] = pi_sum * inv_m;
    ch[1] = pi_max;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      ch[2 + d] = mu_sum[d] / sw * inv_m;
      ch[5 + d] = mu_max[d] / sw;
      ch[8 + d] = mu_min[d] / sw;
      ch[11 + d] = sg_sum[d] / sw2 * inv_m;
      ch[14 + d] = sg_max[d] / sw2;
      ch[17 + d] = sg_min[d] / sw2;
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) ch[c] = signed_sqrt(ch[c]);
  }
  // L2 norm of each channel over G (threads past G hold zeros).
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const float s = warp_sum(ch[c] * ch[c]);
    if (lane == 0) red_s[warp * kC + c] = s;
  }
  __syncthreads();
  if (tid < kC) {
    float s = 0.f;
    for (int i = 0; i < nwarps; ++i) s += red_s[i * kC + tid];
    nrm_s[tid] = 1.f / sqrtf(fmaxf(s, kEps));
  }
  __syncthreads();
  if (j < G) {
#pragma unroll
    for (int c = 0; c < kC; ++c) fv_s[j * kC + c] = ch[c] * nrm_s[c];
  }

  // 4. Queries: voxel id (flat v = iy*g^2 + ix*g + iz) and delta.
  for (int n = tid; n < N; n += blockDim.x) {
    const float* q = queries + (static_cast<size_t>(b) * N + n) * 3;
    const int v = dpdist::assign_voxel(q, g);
    qv_s[n] = v;
    vox_out[static_cast<size_t>(b) * N + n] = v;
#pragma unroll
    for (int d = 0; d < 3; ++d) qd_s[n * 3 + d] = q[d] - centers[v * 3 + d];
  }
  __syncthreads();

  // 5. Rows of x: one warp per query, lanes on neighbouring addresses.
  for (int n = warp; n < N; n += nwarps)
    dpdist::write_x_row(x + (static_cast<size_t>(b) * N + n) * W, qd_s + n * 3, qv_s[n], fv_s,
                        offs_s, off3_s, g, kC, E, lane);
}

}  // namespace

extern "C" {

const char* dpdist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory bytes the kernel takes for these sizes.
size_t dpdist_mfv_gather_x_smem(int M, int N, int g, int k, int threads) {
  const size_t G = static_cast<size_t>(g) * g * g;
  const size_t K3 = static_cast<size_t>(k) * k * k;
  const size_t nwarps = threads / kWarp;
  return 4 * (G * kC + G * 3 + static_cast<size_t>(M) * 5 + nwarps * kC + kC +
              static_cast<size_t>(N) * 4 + K3 * 2);
}

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success) or cudaErrorInvalidValue for sizes the kernel does not take.
int dpdist_mfv_gather_x(const float* points, const float* queries, const float* mu,
                        const float* centers, float* x, int* vox, int B, int M, int N,
                        int g, int k, float sigma, float w, float pi_scale, float sw,
                        float sw2, float inv_m, int threads, int device, void* stream) {
  const int G = g * g * g;
  if (B < 1 || M < 1 || N < 1 || g < 1 || k < 1 || (k % 2) == 0 || G > threads ||
      threads > 1024 || threads % kWarp != 0 || k > 2 * g + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = dpdist_mfv_gather_x_smem(M, N, g, k, threads);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(mfv_gather_x_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mfv_gather_x_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      points, queries, mu, centers, x, vox, M, N, g, k, sigma, w, pi_scale, sw, sw2, inv_m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
