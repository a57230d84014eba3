// The normalised full 3DmFV encode of one cloud by one block, streaming its
// points through shared memory in tiles, so that any number of points fits.
// Shared by threedmfv.cu (the encode alone) and mfv_gather.cu (the encode
// fused with the patch gather).
//
// Per tile of kEncodeTile points:
//   1. stage the tile's points in shared memory;
//   2. softmax statistics per point (max and sum of exp over the G
//      Gaussians), one warp per point with shuffles;
//   3. one thread per Gaussian folds the tile into its 20 running pools
//      (sum, max, min) in registers.
// Then the finalisation: mean rows divided by N, signed sqrt with eps 1e-12,
// and an L2 norm per channel over G (a block reduction).
//
// Numerics follow the port's plain encode (ops/threedmfv.py): squared
// distances summed from per-dimension differences (p - mu) / sigma, true
// division, expf (not __expf). Points far outside the grid underflow Q to 0
// for all but their nearest Gaussians; the max term of each point's sum is
// exp(0) = 1, so no sum is 0 and nothing becomes inf or NaN.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "patch_rows.cuh"

namespace dpdist {

constexpr int kFvChannels = 20;   // full FV, D = 3
constexpr int kEncodeTile = 256;  // points per shared-memory tile
constexpr float kFvEps = 1e-12f;

// Scalars of the encode, computed by the caller for a cloud of n points:
// w = 1/G, pi_scale = sqrt(w) * n, sw = sqrt(w), sw2 = sqrt(2w), inv_n = 1/n.
struct EncodeConsts {
  float sigma, w, pi_scale, sw, sw2, inv_n;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// -0.5 * ||(p - mu) / sigma||^2, the per-dimension form of the TPU kernel.
__device__ __forceinline__ float logit_of(float px, float py, float pz, float mx, float my,
                                          float mz, float sigma) {
  const float dx = (px - mx) / sigma;
  const float dy = (py - my) / sigma;
  const float dz = (pz - mz) / sigma;
  return -0.5f * (dx * dx + dy * dy + dz * dz);
}

__device__ __forceinline__ float signed_sqrt(float v) {
  const float s = (v > 0.f) ? 1.f : ((v < 0.f) ? -1.f : 0.f);
  return s * sqrtf(fmaxf(fabsf(v), kFvEps));
}

// Floats of shared memory encode_cloud takes: the Gaussian centres (G*3),
// one tile of points (kEncodeTile*3), the tile's softmax max and sum
// (kEncodeTile each), and the norm reduction (nwarps*20 + 20).
__host__ __device__ inline size_t encode_smem_floats(int G, int nwarps) {
  return static_cast<size_t>(G) * 3 + kEncodeTile * 5 + static_cast<size_t>(nwarps) * kFvChannels +
         kFvChannels;
}

// Encodes the n points pts (n, 3) of one cloud. Every thread of the block
// calls it; blockDim.x is a multiple of 32 and at least G. Thread j < G
// returns the normalised channels of Gaussian j in ch, in the layout
//   [pi_mean, pi_max, mu_mean(3), mu_max(3), mu_min(3),
//    sig_mean(3), sig_max(3), sig_min(3)];
// threads past G return zeros. mu is (G, 3) in device memory; smem holds
// encode_smem_floats(G, blockDim.x / 32) floats.
__device__ inline void encode_cloud(const float* __restrict__ pts, int n,
                                    const float* __restrict__ mu, int G, const EncodeConsts& p,
                                    float* smem, float (&ch)[kFvChannels]) {
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int nwarps = blockDim.x / kWarp;
  float* mu_s = smem;                          // G * 3
  float* tile_s = mu_s + G * 3;                // kEncodeTile * 3
  float* pmax_s = tile_s + kEncodeTile * 3;    // kEncodeTile
  float* psum_s = pmax_s + kEncodeTile;        // kEncodeTile
  float* red_s = psum_s + kEncodeTile;         // nwarps * 20
  float* nrm_s = red_s + nwarps * kFvChannels; // 20

  for (int i = tid; i < G * 3; i += blockDim.x) mu_s[i] = mu[i];

  const int j = tid;
  const bool owner = j < G;
  const float mx = owner ? mu[j * 3] : 0.f;
  const float my = owner ? mu[j * 3 + 1] : 0.f;
  const float mz = owner ? mu[j * 3 + 2] : 0.f;
  float pi_sum = 0.f, pi_max = -INFINITY;
  float mu_sum[3] = {0.f, 0.f, 0.f}, mu_max[3], mu_min[3];
  float sg_sum[3] = {0.f, 0.f, 0.f}, sg_max[3], sg_min[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    mu_max[d] = -INFINITY;
    mu_min[d] = INFINITY;
    sg_max[d] = -INFINITY;
    sg_min[d] = INFINITY;
  }

  for (int t0 = 0; t0 < n; t0 += kEncodeTile) {
    const int T = min(kEncodeTile, n - t0);
    __syncthreads();  // the previous tile is pooled; mu_s is staged
    for (int i = tid; i < T * 3; i += blockDim.x) tile_s[i] = pts[static_cast<size_t>(t0) * 3 + i];
    __syncthreads();

    // 2. Softmax statistics over G per point: one warp per point.
    for (int m = warp; m < T; m += nwarps) {
      const float px = tile_s[m * 3], py = tile_s[m * 3 + 1], pz = tile_s[m * 3 + 2];
      float mxl = -INFINITY;
      for (int g = lane; g < G; g += kWarp)
        mxl = fmaxf(mxl, logit_of(px, py, pz, mu_s[g * 3], mu_s[g * 3 + 1], mu_s[g * 3 + 2],
                                  p.sigma));
      mxl = warp_max(mxl);
      float s = 0.f;
      for (int g = lane; g < G; g += kWarp)
        s += expf(logit_of(px, py, pz, mu_s[g * 3], mu_s[g * 3 + 1], mu_s[g * 3 + 2], p.sigma) -
                  mxl);
      s = warp_sum(s);
      if (lane == 0) {
        pmax_s[m] = mxl;
        psum_s[m] = s;
      }
    }
    __syncthreads();

    // 3. Fold the tile into the pools: thread j owns Gaussian j.
    if (owner) {
      for (int m = 0; m < T; ++m) {
        const float px = tile_s[m * 3], py = tile_s[m * 3 + 1], pz = tile_s[m * 3 + 2];
        const float q = expf(logit_of(px, py, pz, mx, my, mz, p.sigma) - pmax_s[m]) / psum_s[m];
        const float dpi = (q - p.w) / p.pi_scale;
        pi_sum += dpi;
        pi_max = fmaxf(pi_max, dpi);
        const float diff[3] = {(px - mx) / p.sigma, (py - my) / p.sigma, (pz - mz) / p.sigma};
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
    }
  }

  // Finalise: mean rows / n, divide by sqrt(w) or sqrt(2w), signed sqrt.
#pragma unroll
  for (int c = 0; c < kFvChannels; ++c) ch[c] = 0.f;
  if (owner) {
    ch[0] = pi_sum * p.inv_n;
    ch[1] = pi_max;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      ch[2 + d] = mu_sum[d] / p.sw * p.inv_n;
      ch[5 + d] = mu_max[d] / p.sw;
      ch[8 + d] = mu_min[d] / p.sw;
      ch[11 + d] = sg_sum[d] / p.sw2 * p.inv_n;
      ch[14 + d] = sg_max[d] / p.sw2;
      ch[17 + d] = sg_min[d] / p.sw2;
    }
#pragma unroll
    for (int c = 0; c < kFvChannels; ++c) ch[c] = signed_sqrt(ch[c]);
  }
  // L2 norm of each channel over G (threads past G hold zeros).
#pragma unroll
  for (int c = 0; c < kFvChannels; ++c) {
    const float s = warp_sum(ch[c] * ch[c]);
    if (lane == 0) red_s[warp * kFvChannels + c] = s;
  }
  __syncthreads();
  if (tid < kFvChannels) {
    float s = 0.f;
    for (int i = 0; i < nwarps; ++i) s += red_s[i * kFvChannels + tid];
    nrm_s[tid] = 1.f / sqrtf(fmaxf(s, kFvEps));
  }
  __syncthreads();
  if (owner) {
#pragma unroll
    for (int c = 0; c < kFvChannels; ++c) ch[c] = ch[c] * nrm_s[c];
  }
}

}  // namespace dpdist
