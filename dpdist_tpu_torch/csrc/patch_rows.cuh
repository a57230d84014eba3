// Device helpers shared by the patch-gather kernels (mfv_gather.cu,
// table_gather.cu): the k^3 window's offsets, a query's voxel, and the
// walk over one patch row or decoder-input row x = [delta, patch].
//
// Flat voxel order is the reference's meshgrid order, v = iy*g^2 + ix*g + iz;
// the window's offsets act on the three digits of v (v/g^2, (v/g)%g, v%g),
// and a patch element e = o*C + c is channel c of the neighbour at offset o.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace dpdist {

constexpr int kWarp = 32;

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

// Walks the patch elements e = first, first + stride, ... < E of a query
// in voxel v and calls f(e, u, c) for each whose neighbour u (at offset
// o = e / C) lies inside the grid; c = e % C. The (o, c) split is carried
// incrementally, so no integer division sits in the loop. Within one call
// distinct e give distinct (u, c).
template <typename F>
__device__ __forceinline__ void for_each_patch_element(int v, int first, int stride, int g, int C,
                                                       int E, const int* offs_s,
                                                       const char4* off3_s, F f) {
  const int vx = v / (g * g), vy = (v / g) % g, vz = v % g;
  const int step_o = stride / C, step_c = stride % C;
  int o = first / C, c = first % C;
  for (int e = first; e < E; e += stride) {
    const char4 s = off3_s[o];
    const int nx = vx + s.x, ny = vy + s.y, nz = vz + s.z;
    f(e, (nx >= 0 && nx < g && ny >= 0 && ny < g && nz >= 0 && nz < g) ? v + offs_s[o] : -1, c);
    o += step_o;
    c += step_c;
    if (c >= C) {
      c -= C;
      o += 1;
    }
  }
}

// One warp writes the patch row of a query in voxel v, lanes on
// neighbouring addresses: patch element e reads channel c of the neighbour
// at offset o from the (G, C) volume fv_s, or 0 outside the grid.
__device__ __forceinline__ void write_patch_row(float* patch, int v, const float* fv_s,
                                                const int* offs_s, const char4* off3_s, int g,
                                                int C, int E, int lane) {
  for_each_patch_element(v, lane, kWarp, g, C, E, offs_s, off3_s, [&](int e, int u, int c) {
    patch[e] = (u >= 0) ? fv_s[u * C + c] : 0.f;
  });
}

// The same for a decoder-input row xrow = [delta, patch].
__device__ __forceinline__ void write_x_row(float* xrow, const float* delta, int v,
                                            const float* fv_s, const int* offs_s,
                                            const char4* off3_s, int g, int C, int E, int lane) {
  if (lane < 3) xrow[lane] = delta[lane];
  write_patch_row(xrow + 3, v, fv_s, offs_s, off3_s, g, C, E, lane);
}

}  // namespace dpdist
