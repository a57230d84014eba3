// Device helpers shared by the patch-gather kernels (mfv_gather.cu,
// table_gather.cu, gather_fused.cu, fused_forward.cu): the k^3 window's
// offsets, a query's voxel, the output's store (float32 or, rounded once to
// nearest even, bfloat16), and the warp-per-row patch gather of
// table_gather.cu's patch-only kernel (row 6). The persistent gathers' row
// machinery is in row_groups.cuh.
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
template <typename T>
__device__ __forceinline__ void write_patch_row(T* patch, int v, const float* fv_s,
                                                const int* offs_s, const char4* off3_s, int g,
                                                int C, int E, int lane) {
  for_each_patch_element(v, lane, kWarp, g, C, E, offs_s, off3_s, [&](int e, int u, int c) {
    store_out(patch + e, (u >= 0) ? fv_s[u * C + c] : 0.f);
  });
}

// Shared memory floats of gather_patch_rows: the (G, C) volume and the
// window's two offset tables.
__host__ __device__ inline size_t patch_rows_smem_floats(int g, int k, int C) {
  const size_t G = static_cast<size_t>(g) * g * g;
  const size_t K3 = static_cast<size_t>(k) * k * k;
  return G * C + K3 * 2;
}

// The body of a patch-gather block (row 6) on a 1-D grid of B * tiles
// blocks (a grid's y dimension stops at 65,535 tiles; x at 2^31 - 1): block
// blockIdx.x takes cloud blockIdx.x % B and its tile blockIdx.x / B of
// rows_per_block queries, the order of a (B, tiles) grid. Stages the
// cloud's (G, C) volume and the window offsets in shared memory, then one
// warp per query row writes out[b, n, :] (k^3*C wide). A row is zero where
// its vox lies outside [0, G) (never made by voxel_assign).
template <typename T>
__device__ __forceinline__ void gather_patch_rows(const float* __restrict__ fv,   // (B, G, C)
                                                  const int* __restrict__ vox,    // (B, N)
                                                  T* __restrict__ out,            // (B, N, k^3*C)
                                                  int N, int g, int k, int C, int rows_per_block) {
  extern __shared__ float smem[];
  const int G = g * g * g;
  const int K3 = k * k * k;
  const int E = K3 * C;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int nwarps = blockDim.x / kWarp;
  const int B = gridDim.x / ((N + rows_per_block - 1) / rows_per_block);
  const int tile = blockIdx.x / B;
  const int b = blockIdx.x - tile * B;
  const int n0 = tile * rows_per_block;
  const int n1 = min(N, n0 + rows_per_block);

  float* fv_s = smem;                                     // G * C
  int* offs_s = reinterpret_cast<int*>(fv_s + G * C);     // K3
  char4* off3_s = reinterpret_cast<char4*>(offs_s + K3);  // K3

  const float* fb = fv + static_cast<size_t>(b) * G * C;
  for (int i = threadIdx.x; i < G * C; i += blockDim.x) fv_s[i] = fb[i];
  stage_window_offsets(offs_s, off3_s, g, k);
  __syncthreads();

  for (int n = n0 + warp; n < n1; n += nwarps) {
    const size_t row = static_cast<size_t>(b) * N + n;
    const int v = vox[row];   // every lane, same value
    T* orow = out + row * E;
    if (v >= 0 && v < G) {
      write_patch_row(orow, v, fv_s, offs_s, off3_s, g, C, E, lane);
    } else {
      for (int e = lane; e < E; e += kWarp) store_out(orow + e, 0.f);
    }
  }
}

}  // namespace dpdist
