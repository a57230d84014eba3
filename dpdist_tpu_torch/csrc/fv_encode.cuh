// The normalised full 3DmFV encode by one team of threads, in pieces: fold
// a run of points into running pools, finalise. Shared by threedmfv.cu
// (the encode alone, a cloud's points split over blocks; the team is the
// block) and mfv_gather.cu (the encode fused with the patch gather; the
// team is the block's encode warps, which encode one cloud after another).
//
// Thread j < G owns Gaussian j and keeps its 20 running pools (sum, max,
// min) in registers. Per tile of kEncodeTile points:
//   1. thread j forms each point's logit -0.5 * ||(p - mu_j) / sigma||^2,
//      stored once in a shared (kEncodeTile, G) tile;
//   2. one warp per point takes the max over G, replaces each logit l by
//      e = expf(l - max) in place and sums them;
//   3. thread j folds q = e * (1 / sum) of each point into its pools,
//      forming (p - mu_j) / sigma again (three subtractions and three
//      scalings).
// The tile's points sit in shared memory, staged during the previous
// tile's step 2. Each (point, Gaussian) pair thus costs one logit, one
// expf, and products by the point's 1 / sum and by 1 / pi_scale (each
// within an ulp of the division; a true division of the many denormal or
// zero e by the sum would take the division's slow path). Where sigma is a
// power of two (0.125 for the committed nets) the division by sigma is the
// multiplication by 1/sigma, which rounds the same real number and so
// gives the same bits; otherwise it stays a true division.
// Then the finalisation: mean rows divided by the whole cloud's N, signed
// sqrt with eps 1e-12, and an L2 norm per channel over G (a block
// reduction).
//
// Numerics follow the port's plain encode (ops/threedmfv.py): squared
// distances summed from per-dimension differences (p - mu) / sigma, true
// division, expf (not __expf); only the order of the sums differs. Points
// far outside the grid underflow Q to 0 for all but their nearest
// Gaussians; the max term of each point's sum is exp(0) = 1, so no sum is 0
// and nothing becomes inf or NaN.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "patch_rows.cuh"

namespace dpdist {

constexpr int kFvChannels = 20;   // full FV, D = 3
constexpr int kEncodeTile = 32;   // points per shared-memory logit tile
constexpr float kFvEps = 1e-12f;

// The threads that run an encode together. BlockTeam: the whole block
// (row 7); the fused kernel of row 1 encodes with its first warps only, on
// a named barrier (mfv_gather.cu).
struct BlockTeam {
  __device__ __forceinline__ int rank() const { return threadIdx.x; }
  __device__ __forceinline__ int size() const { return blockDim.x; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

// Scalars of the encode for the whole cloud of n points (never a chunk's):
// w = 1/G, inv_pi_scale = 1 / (sqrt(w) * n), sw = sqrt(w), sw2 = sqrt(2w),
// inv_n = 1/n; inv_sigma = 1/sigma where sigma is a power of two, else 0.
struct EncodeConsts {
  float sigma, w, inv_pi_scale, sw, sw2, inv_n, inv_sigma;
};

inline EncodeConsts make_consts(float sigma, float w, float pi_scale, float sw, float sw2,
                                float inv_n) {
  int e = 0;
  const bool pow2 = frexpf(sigma, &e) == 0.5f;
  return EncodeConsts{sigma, w, 1.f / pi_scale, sw, sw2, inv_n, pow2 ? ldexpf(1.f, 1 - e) : 0.f};
}

// (x - m) / sigma, bit for bit: kPow2 (inv_sigma != 0) multiplies by
// 1/sigma. A template parameter, so that no division is evaluated where it
// is not needed.
template <bool kPow2>
__device__ __forceinline__ float scaled_diff(float x, float m, const EncodeConsts& p) {
  return kPow2 ? (x - m) * p.inv_sigma : (x - m) / p.sigma;
}

// The running pools of one Gaussian, in the output's channel order:
// [pi_sum, pi_max, mu_sum(3), mu_max(3), mu_min(3), sg_sum(3), sg_max(3),
//  sg_min(3)].
struct Pools {
  float v[kFvChannels];
};

// 0: a sum, 1: a max, 2: a min.
__host__ __device__ constexpr int pool_kind(int c) {
  return (c == 1 || (c >= 5 && c < 8) || (c >= 14 && c < 17)) ? 1
         : ((c >= 8 && c < 11) || c >= 17)                    ? 2
                                                              : 0;
}

__device__ __forceinline__ void init_pools(Pools& p) {
#pragma unroll
  for (int c = 0; c < kFvChannels; ++c)
    p.v[c] = pool_kind(c) == 0 ? 0.f : (pool_kind(c) == 1 ? -INFINITY : INFINITY);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float signed_sqrt(float v) {
  const float s = (v > 0.f) ? 1.f : ((v < 0.f) ? -1.f : 0.f);
  return s * sqrtf(fmaxf(fabsf(v), kFvEps));
}

// Floats of shared memory the encode takes: the logit tile (kEncodeTile *
// G), the tile's softmax sums (kEncodeTile), two tiles of points
// (2 * kEncodeTile * 3), and the norm reduction (nwarps * 20 + 20).
__host__ __device__ inline size_t encode_smem_floats(int G, int nwarps) {
  return static_cast<size_t>(kEncodeTile) * G + kEncodeTile + 2 * kEncodeTile * 3 +
         static_cast<size_t>(nwarps) * kFvChannels + kFvChannels;
}

// Folds the n points pts (n, 3) into the pools of thread j = team.rank()
// (Gaussian j, centre mu[j] in device memory). Every thread of the team
// calls it; the team's size is a multiple of 32, at least G and at least
// 3 * kEncodeTile; threads past G keep their pools untouched. smem holds
// encode_smem_floats floats.
template <bool kPow2, typename Team>
__device__ inline void pool_points_as(const float* __restrict__ pts, int n,
                                      const float* __restrict__ mu, int G, const EncodeConsts& p,
                                      float* smem, Pools& pools, const Team& team) {
  const int j = team.rank();
  const int lane = j % kWarp;
  const int warp = j / kWarp;
  const int nwarps = team.size() / kWarp;
  float* lt = smem;                       // kEncodeTile * G: logits, then e
  float* sum_s = lt + kEncodeTile * G;    // kEncodeTile: 1 / each point's sum
  float* tile_s = sum_s + kEncodeTile;    // 2 * kEncodeTile * 3: this tile's and the next's points
  const bool owner = j < G;
  const float mx = owner ? mu[j * 3] : 0.f;
  const float my = owner ? mu[j * 3 + 1] : 0.f;
  const float mz = owner ? mu[j * 3 + 2] : 0.f;

  if (j < min(kEncodeTile, n) * 3) tile_s[j] = __ldg(pts + j);
  team.sync();
  for (int t0 = 0, buf = 0; t0 < n; t0 += kEncodeTile, buf ^= 1) {
    const int T = min(kEncodeTile, n - t0);
    const float* tp = tile_s + buf * kEncodeTile * 3;
    // 1. Logits, once per pair.
    if (owner) {
#pragma unroll 8
      for (int m = 0; m < T; ++m) {
        const float dx = scaled_diff<kPow2>(tp[m * 3], mx, p);
        const float dy = scaled_diff<kPow2>(tp[m * 3 + 1], my, p);
        const float dz = scaled_diff<kPow2>(tp[m * 3 + 2], mz, p);
        lt[m * G + j] = -0.5f * (dx * dx + dy * dy + dz * dz);
      }
    }
    team.sync();

    // 2. Softmax over G per point: one warp per point. Meanwhile the last
    //    warp's lanes stage the next tile's points.
    const int next = min(kEncodeTile, n - t0 - kEncodeTile) * 3;
    if (warp == nwarps - 1) {
      for (int i = lane; i < next; i += kWarp)
        tile_s[(buf ^ 1) * kEncodeTile * 3 + i] = __ldg(pts + static_cast<size_t>(t0 + kEncodeTile) * 3 + i);
    }
    for (int m = warp; m < T; m += nwarps) {
      float* row = lt + m * G;
      float mxl = -INFINITY;
      for (int g = lane; g < G; g += kWarp) mxl = fmaxf(mxl, row[g]);
      mxl = warp_max(mxl);
      float s = 0.f;
      for (int g = lane; g < G; g += kWarp) {
        const float e = expf(row[g] - mxl);
        row[g] = e;
        s += e;
      }
      s = warp_sum(s);
      if (lane == 0) sum_s[m] = 1.f / s;
    }
    team.sync();

    // 3. Fold the tile into the pools.
    if (owner) {
#pragma unroll 4
      for (int m = 0; m < T; ++m) {
        const float q = lt[m * G + j] * sum_s[m];
        const float dpi = (q - p.w) * p.inv_pi_scale;
        pools.v[0] += dpi;
        pools.v[1] = fmaxf(pools.v[1], dpi);
        const float diff[3] = {scaled_diff<kPow2>(tp[m * 3], mx, p),
                               scaled_diff<kPow2>(tp[m * 3 + 1], my, p),
                               scaled_diff<kPow2>(tp[m * 3 + 2], mz, p)};
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float tm = q * diff[d];
          const float ts = q * (diff[d] * diff[d] - 1.f);
          pools.v[2 + d] += tm;
          pools.v[5 + d] = fmaxf(pools.v[5 + d], tm);
          pools.v[8 + d] = fminf(pools.v[8 + d], tm);
          pools.v[11 + d] += ts;
          pools.v[14 + d] = fmaxf(pools.v[14 + d], ts);
          pools.v[17 + d] = fminf(pools.v[17 + d], ts);
        }
      }
    }
    team.sync();  // the tile's logits are read before the next overwrites them
  }
}

template <typename Team = BlockTeam>
__device__ inline void pool_points(const float* __restrict__ pts, int n,
                                   const float* __restrict__ mu, int G, const EncodeConsts& p,
                                   float* smem, Pools& pools, const Team& team = Team()) {
  if (p.inv_sigma != 0.f) {
    pool_points_as<true>(pts, n, mu, G, p, smem, pools, team);
  } else {
    pool_points_as<false>(pts, n, mu, G, p, smem, pools, team);
  }
}

// Channel c of a whole cloud's pool value v: mean rows / n, divided by
// sqrt(w) or sqrt(2w), then the signed sqrt (before the L2 norm over G).
__device__ __forceinline__ float channel_value(int c, float v, const EncodeConsts& p) {
  float x;
  if (c == 0) {
    x = v * p.inv_n;
  } else if (c == 1) {
    x = v;
  } else if (c < 5) {
    x = v / p.sw * p.inv_n;
  } else if (c < 11) {
    x = v / p.sw;
  } else if (c < 14) {
    x = v / p.sw2 * p.inv_n;
  } else {
    x = v / p.sw2;
  }
  return signed_sqrt(x);
}

// Turns the whole cloud's pools into normalised channels: mean rows / n,
// divide by sqrt(w) or sqrt(2w), signed sqrt, then an L2 norm per channel
// over G. Every thread of the team calls it; thread j < G returns
// Gaussian j's channels in ch, threads past G zeros. smem as pool_points'.
template <typename Team = BlockTeam>
__device__ inline void finalize_channels(const Pools& pools, int G, const EncodeConsts& p,
                                         float* smem, float (&ch)[kFvChannels],
                                         const Team& team = Team()) {
  const int tid = team.rank();
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int nwarps = team.size() / kWarp;
  float* red_s = smem + kEncodeTile * G + kEncodeTile + 2 * kEncodeTile * 3;   // nwarps * 20
  float* nrm_s = red_s + nwarps * kFvChannels;           // 20
  const bool owner = tid < G;
#pragma unroll
  for (int c = 0; c < kFvChannels; ++c) ch[c] = owner ? channel_value(c, pools.v[c], p) : 0.f;
  // L2 norm of each channel over G (threads past G hold zeros).
#pragma unroll
  for (int c = 0; c < kFvChannels; ++c) {
    const float s = warp_sum(ch[c] * ch[c]);
    if (lane == 0) red_s[warp * kFvChannels + c] = s;
  }
  team.sync();
  if (tid < kFvChannels) {
    float s = 0.f;
    for (int i = 0; i < nwarps; ++i) s += red_s[i * kFvChannels + tid];
    nrm_s[tid] = 1.f / sqrtf(fmaxf(s, kFvEps));
  }
  team.sync();
  if (owner) {
#pragma unroll
    for (int c = 0; c < kFvChannels; ++c) ch[c] = ch[c] * nrm_s[c];
  }
}

// Encodes the n points pts (n, 3) of one cloud by a team: thread j < G
// returns the normalised channels of Gaussian j in ch (layout
// [pi_mean, pi_max, mu_mean(3), mu_max(3), mu_min(3), sig_mean(3),
//  sig_max(3), sig_min(3)]), threads past G zeros. Every thread of the team
// calls it.
template <typename Team>
__device__ inline void encode_cloud(const float* __restrict__ pts, int n,
                                    const float* __restrict__ mu, int G, const EncodeConsts& p,
                                    float* smem, float (&ch)[kFvChannels], const Team& team) {
  Pools pools;
  init_pools(pools);
  pool_points(pts, n, mu, G, p, smem, pools, team);
  finalize_channels(pools, G, p, smem, ch, team);
}

}  // namespace dpdist
