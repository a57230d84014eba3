// Device helpers shared by the patch-gather kernels (mfv_gather.cu,
// table_gather.cu, gather_fused.cu, fused_forward.cu): the k^3 window's
// offsets, a query's voxel, and the output's stores (float32 or, rounded
// once to nearest even, bfloat16). The persistent gathers' row machinery is
// in row_groups.cuh.
//
// Flat voxel order is the reference's meshgrid order, v = iy*g^2 + ix*g + iz;
// the window's offsets act on the three digits of v (v/g^2, (v/g)%g, v%g),
// and a patch element e = o*C + c is channel c of the neighbour at offset o.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace dpdist {

constexpr int kWarp = 32;

// Opts a kernel in to more than 48 KB of dynamic shared memory where it
// needs that.
template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Four consecutive bfloat16 values by one 8-byte store (p 8-byte aligned),
// each rounded once to nearest even.
__device__ __forceinline__ void store_out4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
}

// Flat shift and (sx, sy, sz) digit shifts of each offset o of the k^3
// window, o = (di*k + dj)*k + dl, shift (di - k/2, dj - k/2, dl - k/2).
__device__ inline void stage_window_offsets(int* offs_s, char4* off3_s, int g, int k) {
  const int kh = k / 2;
  const int K3 = k * k * k;
  for (int o = threadIdx.x; o < K3; o += blockDim.x) {
    const int sx = o / (k * k) - kh, sy = (o / k) % k - kh, sz = o % k - kh;
    offs_s[o] = sx * g * g + sy * g + sz;
    off3_s[o] = make_char4(static_cast<signed char>(sx), static_cast<signed char>(sy),
                           static_cast<signed char>(sz), 0);
  }
}

// The flat cell of query q: cells are strict below and inclusive above
// (u = (q+1)/step, idx = ceil(u) - 1); a query outside [-1, 1]^3 gets 0.
// True division and ceilf: --use_fast_math would move points on edges.
__device__ __forceinline__ int assign_voxel(const float* q, int g) {
  const float step = 2.f / static_cast<float>(g);
  int idx[3];
  bool inside = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float u = (q[d] + 1.f) / step;
    idx[d] = static_cast<int>(ceilf(u)) - 1;
    inside = inside && (u > 0.f) && (idx[d] <= g - 1);
    idx[d] = min(max(idx[d], 0), g - 1);
  }
  return inside ? idx[1] * g * g + idx[0] * g + idx[2] : 0;
}

}  // namespace dpdist
