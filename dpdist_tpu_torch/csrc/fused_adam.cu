// Adam's update of every parameter leaf of a training step, in place, in
// one pass:
//   m <- (1 - b1) g + b1 m
//   v <- (1 - b2) g g + b2 v
//   p <- p - lr ((m / c1) / (sqrt(v / c2) + eps))
// for each element of each leaf (train/optim.py, Optimizer.step).
//
// Replaces no TPU kernel: the JAX package leaves Adam to optax under XLA,
// which fuses the update into a few passes. The port's list path runs the
// same update as 14 PyTorch ops a leaf, each a pass over the leaf, which
// moves about 33 tensor widths a step; this kernel reads p, g, m and v once
// and writes p, m and v once: 28 bytes a weight.
//
// What bounds it on an H100: bytes. One operation or so a byte, far below
// the card's line of about 20 float32 operations a byte, so the design
// keeps HBM busy and moves nothing twice:
//   - One launch for all the leaves. Their table (pointers, lengths, and
//     each leaf's first chunk) is a kernel parameter passed by value
//     (__grid_constant__, read from the constant bank), so no host copy
//     comes before the launch. A call with more than kMaxLeaves leaves
//     launches once for each kMaxLeaves.
//   - Each leaf is cut into chunks of kChunk elements; the chunks of all the
//     leaves form one sequence, a block a chunk, and a block finds its leaf
//     by a binary search of the table. A thread loads all kUnroll 16-byte
//     vectors of its four tensors before it computes (16 loads in flight a
//     thread), then stores. A leaf's last chunk takes whole vectors while
//     they fit, then the at most 3 elements left one by one. On the H100 a
//     block a chunk moved 90 % of 3.35 TB/s on a 402.7 M-weight leaf, as
//     many blocks as the card holds walking the chunks 85 % (a plain copy
//     kernel 84 %).
//   - Bit for bit with the list path on the card: each of its PyTorch ops
//     rounds once in float32, and nvcc's default -fmad=true would contract a
//     multiply and an add, so the arithmetic is written with the _rn
//     intrinsics in the list path's order. PyTorch divides a CUDA tensor by a
//     Python scalar by multiplying with the float reciprocal; the host
//     computes 1 / c1 and 1 / c2 in float32 the same way and passes them.
//
// Plain C interface for ctypes; no PyTorch headers. Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                        // 16-byte vectors of each tensor a thread
constexpr int kChunk = kThreads * kUnroll * 4;    // elements a chunk (4,096)
constexpr int kMaxLeaves = 64;                    // a launch's table and scalars: about 3.1 KB
                                                  // of the 4 KB of kernel parameters

struct Leaves {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  int64_t n[kMaxLeaves];
  int64_t first[kMaxLeaves + 1];   // leaf i's chunks are [first[i], first[i + 1])
  int count;
};

struct Step {
  float lr, one_minus_b1, b1, one_minus_b2, b2, inv_c1, inv_c2, eps;
};

// One element, in the list path's order of ops: (1 - b1) * g + b1 * m;
// (1 - b2) * g * g + b2 * v; p - lr * ((m * inv_c1) / (sqrt(v * inv_c2) + eps)).
__device__ __forceinline__ void adam(float& p, float g, float& m, float& v, const Step& s) {
  m = __fadd_rn(__fmul_rn(s.one_minus_b1, g), __fmul_rn(s.b1, m));
  v = __fadd_rn(__fmul_rn(__fmul_rn(s.one_minus_b2, g), g), __fmul_rn(s.b2, v));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.inv_c2)), s.eps);
  p = __fsub_rn(p, __fmul_rn(s.lr, __fdiv_rn(__fmul_rn(m, s.inv_c1), den)));
}

__device__ __forceinline__ void adam4(float4& p, const float4& g, float4& m, float4& v,
                                      const Step& s) {
  adam(p.x, g.x, m.x, v.x, s);
  adam(p.y, g.y, m.y, v.y, s);
  adam(p.z, g.z, m.z, v.z, s);
  adam(p.w, g.w, m.w, v.w, s);
}

__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(const __grid_constant__ Leaves L, const __grid_constant__ Step s) {
  const int64_t c = blockIdx.x;
  int lo = 0, hi = L.count - 1;   // the leaf whose chunks hold c: first[lo] <= c < first[lo + 1]
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (L.first[mid] <= c) lo = mid; else hi = mid - 1;
  }
  const int64_t base = (c - L.first[lo]) * kChunk;
  const int64_t left = L.n[lo] - base;
  float* p = L.p[lo] + base;
  const float* g = L.g[lo] + base;
  float* m = L.m[lo] + base;
  float* v = L.v[lo] + base;
  if (left >= kChunk) {
    float4 pv[kUnroll], gv[kUnroll], mv[kUnroll], vv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = u * kThreads + threadIdx.x;
      pv[u] = reinterpret_cast<const float4*>(p)[i];
      gv[u] = reinterpret_cast<const float4*>(g)[i];
      mv[u] = reinterpret_cast<const float4*>(m)[i];
      vv[u] = reinterpret_cast<const float4*>(v)[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = u * kThreads + threadIdx.x;
      adam4(pv[u], gv[u], mv[u], vv[u], s);
      reinterpret_cast<float4*>(p)[i] = pv[u];
      reinterpret_cast<float4*>(m)[i] = mv[u];
      reinterpret_cast<float4*>(v)[i] = vv[u];
    }
    return;
  }
  for (int i = 4 * threadIdx.x; i < left; i += 4 * kThreads) {
    if (i + 4 <= left) {
      float4 pv = *reinterpret_cast<const float4*>(p + i);
      float4 mv = *reinterpret_cast<const float4*>(m + i);
      float4 vv = *reinterpret_cast<const float4*>(v + i);
      adam4(pv, *reinterpret_cast<const float4*>(g + i), mv, vv, s);
      *reinterpret_cast<float4*>(p + i) = pv;
      *reinterpret_cast<float4*>(m + i) = mv;
      *reinterpret_cast<float4*>(v + i) = vv;
    } else {
      for (int j = i; j < left; ++j) adam(p[j], g[j], m[j], v[j], s);
    }
  }
}

}  // namespace

extern "C" {

// The most leaves one launch takes.
int dpdist_fused_adam_max_leaves() { return kMaxLeaves; }

// Updates the `count` leaves (p[i], g[i], m[i], v[i] of n[i] float32
// elements each, every pointer 16-byte aligned) in place on `stream`: one
// launch, a block a chunk, for each kMaxLeaves leaves. The step's
// scalars are float32: lr, 1 - b1, b1, 1 - b2, b2, 1 / c1, 1 / c2, eps.
// Returns cudaGetLastError() after the last launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int dpdist_fused_adam(void* const* p, const void* const* g, void* const* m, void* const* v,
                      const int64_t* n, int count, float lr, float one_minus_b1, float b1,
                      float one_minus_b2, float b2, float inv_c1, float inv_c2, float eps,
                      int device, void* stream) {
  if (count < 1) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < count; ++i) {
    const uintptr_t bits = reinterpret_cast<uintptr_t>(p[i]) | reinterpret_cast<uintptr_t>(g[i]) |
                           reinterpret_cast<uintptr_t>(m[i]) | reinterpret_cast<uintptr_t>(v[i]);
    if (n[i] < 0 || bits % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Step s{lr, one_minus_b1, b1, one_minus_b2, b2, inv_c1, inv_c2, eps};
  for (int lo = 0; lo < count; lo += kMaxLeaves) {
    Leaves L;
    L.count = count - lo < kMaxLeaves ? count - lo : kMaxLeaves;
    L.first[0] = 0;
    for (int i = 0; i < L.count; ++i) {
      L.p[i] = static_cast<float*>(p[lo + i]);
      L.g[i] = static_cast<const float*>(g[lo + i]);
      L.m[i] = static_cast<float*>(m[lo + i]);
      L.v[i] = static_cast<float*>(v[lo + i]);
      L.n[i] = n[lo + i];
      L.first[i + 1] = L.first[i] + (n[lo + i] + kChunk - 1) / kChunk;
    }
    const int64_t chunks = L.first[L.count];
    if (chunks == 0) continue;
    if (chunks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
    fused_adam_kernel<<<static_cast<unsigned>(chunks), kThreads, 0, st>>>(L, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
