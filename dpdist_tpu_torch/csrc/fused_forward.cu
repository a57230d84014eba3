// Fused patch gather + the whole conv_version = 1 decoder, in bfloat16 with
// float32 accumulation: the eval-only serving forward.
//
// Replaces the TPU kernel dpdist_tpu/kernels/fused_forward_pallas.py:_kernel
// (reached through fused_forward, `pl.pallas_call` at :121). Per query row of
// a cloud it computes the decoder's pre-activation output
//   h1 = relu([patch, bf16(delta)] @ W1 + b1)        (W1's rows reordered)
//   h  = relu(bf16(h) @ W_i + b_i)                     (further hidden layers)
//   y  = bf16(h) @ W_out + b_out                       (linear head, float32)
// with every weight and bias rounded to bfloat16, every product accumulated
// in float32, the bias added in float32, and h rounded to bfloat16 before
// each next product (fused_forward_pallas.py:51-76, :93-99). The reference
// splits the first layer as emb @ W1[3:] + delta @ W1[:3]; here W1 is packed
// as [W1[3:]; W1[:3]; zero rows up to a multiple of 16] and the A operand as
// [patch, bf16(delta), 0...], so the split sum runs in one accumulator.
//
// Design. The TPU kernel keeps all 9.3 MB of bf16 weights and a (V, k^3*C)
// patch table in VMEM; a Hopper block has at most 227 KB of shared memory.
// So the weights stay in device memory, where the 50 MB L2 holds them for
// every block, and a block takes a tile of kRows = 32 query rows of one cloud:
//   - the cloud's (V, C) FV volume in shared memory as bf16 (20 KB at
//     V = 512, C = 20). The first layer's A operand is gathered from it by
//     patch index, kChunk columns at a time, so no patch row reaches device
//     memory;
//   - the hidden activations ping-pong between two shared (32, width) bf16
//     tiles (2 x 64 KB at width 1024);
//   - products run on the tensor cores through nvcuda::wmma bf16 16x16x16
//     fragments with float32 accumulators; 16 warps each own up to four
//     16-column tiles of a layer's output across both 16-row tiles, and read
//     their B fragments straight from device memory (L2);
//   - each layer's accumulators pass through a per-warp shared scratch tile
//     to add the bias, apply ReLU and round to bf16;
//   - the head (width -> out, 3 for the committed nets) is a warp reduction
//     in float32 per (row, output).
// Off-grid queries carry vox 0 and compute cell 0's row; the caller's mask
// zeroes them. A vox outside [0, V) (never made by voxel_assign) gathers a
// zero patch.
//
// What bounds it on an H100: operations. Per query row the decoder takes
// 2 * (2503*1024 + 2*1024^2 + 1024*3) = 9.33 MFLOP; at 2B = 512 clouds of
// N = 64 queries that is 0.306 TFLOP, 0.31 ms at the H100 SXM's dense bf16
// tensor peak of 989 TFLOP/s. The bytes (fv, vox, delta in; y out; the
// weights once) are about 25 MB. This first design reads every weight once
// per block of 32 rows, from L2, so it is bound by L2 bandwidth well before
// the tensor cores (wgmma, TMA and larger row tiles are a later step).
//
// Plain C interface for ctypes; no PyTorch headers. Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>

#include "patch_rows.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;
using dpdist::kWarp;

constexpr int kRows = 32;                      // query rows per block: two 16-row tiles
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * kWarp;       // 512
constexpr int kTilesPerWarp = 4;               // 16-column output tiles per warp
constexpr int kMaxWidth = kWarps * kTilesPerWarp * 16;  // 1024
constexpr int kChunk = 128;                    // first-layer A columns gathered per step
constexpr int kPad = 8;                        // bf16 padding per shared row (ldm % 8 == 0)
constexpr int kMaxHidden = 8;

struct Decoder {
  const bf16* w[kMaxHidden];   // hidden layer i: (K_i, width_i) row-major; K_0 = k1 (packed)
  const float* b[kMaxHidden];  // (width_i,) bf16-rounded values
  int width[kMaxHidden];
  int n_hidden;
  int k1;                      // first layer's K: 3 + k^3*C rounded up to 16
  const float* w_out;          // (out, width_last) bf16-rounded values
  const float* b_out;          // (out,)
  int out;
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__host__ __device__ inline size_t up128(size_t bytes) { return (bytes + 127) / 128 * 128; }

// Byte offsets of the shared-memory regions, in order: the bf16 volume, the
// window offsets, per-row vox and delta, the two activation tiles, the
// first layer's A chunk and the per-warp scratch tiles.
struct Layout {
  size_t offs, rows, h0, h1, a, scratch, total;
  __host__ __device__ Layout(int g, int k, int C, int ldh) {
    const size_t G = static_cast<size_t>(g) * g * g;
    const size_t K3 = static_cast<size_t>(k) * k * k;
    offs = up128(G * C * sizeof(bf16));
    rows = up128(offs + K3 * (sizeof(int) + sizeof(char4)));
    h0 = up128(rows + kRows * (sizeof(int) + sizeof(char4) + 3 * sizeof(float)));
    h1 = up128(h0 + static_cast<size_t>(kRows) * ldh * sizeof(bf16));
    a = up128(h1 + static_cast<size_t>(kRows) * ldh * sizeof(bf16));
    scratch = up128(a + static_cast<size_t>(kRows) * (kChunk + kPad) * sizeof(bf16));
    total = scratch + static_cast<size_t>(kWarps) * 256 * sizeof(float);
  }
};

// Adds the bias in float32, applies ReLU, rounds to bf16 and stores the
// warp's accumulators into the (kRows, ldh) tile hout.
__device__ __forceinline__ void store_hidden(FragC (&acc)[2][kTilesPerWarp], const float* bias,
                                             int tiles, bf16* hout, int ldh, float* scratch,
                                             int warp, int lane) {
#pragma unroll
  for (int j = 0; j < kTilesPerWarp; ++j) {
    const int t = j * kWarps + warp;
    if (t >= tiles) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += kWarp) {
        const int r = e / 16, c = e % 16;
        const float v = fmaxf(scratch[e] + bias[t * 16 + c], 0.f);
        hout[(i * 16 + r) * ldh + t * 16 + c] = __float2bfloat16_rn(v);
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    fused_forward_kernel(const bf16* __restrict__ fv,      // (B, G, C)
                         const int* __restrict__ vox,      // (B, N)
                         const float* __restrict__ delta,  // (B, N, 3)
                         float* __restrict__ y,            // (B, N, out)
                         Decoder dec, int N, int g, int k, int C, int ldh) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Layout L(g, k, C, ldh);
  const int G = g * g * g;
  const int K3 = k * k * k;
  const int E = K3 * C;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * kRows;
  const int rows = min(kRows, N - n0);
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;

  bf16* fv_s = reinterpret_cast<bf16*>(smem_raw);
  int* offs_s = reinterpret_cast<int*>(smem_raw + L.offs);
  char4* off3_s = reinterpret_cast<char4*>(offs_s + K3);
  // Per row: its vox (G for a zero patch, -1 past the cloud's last query),
  // the vox's three digits, and delta.
  int* rv_s = reinterpret_cast<int*>(smem_raw + L.rows);            // kRows
  char4* rdig_s = reinterpret_cast<char4*>(rv_s + kRows);       // kRows
  float* rd_s = reinterpret_cast<float*>(rdig_s + kRows);       // kRows * 3
  bf16* h0 = reinterpret_cast<bf16*>(smem_raw + L.h0);
  bf16* h1 = reinterpret_cast<bf16*>(smem_raw + L.h1);
  bf16* a_s = reinterpret_cast<bf16*>(smem_raw + L.a);
  float* scratch = reinterpret_cast<float*>(smem_raw + L.scratch) + warp * 256;
  const int lda = kChunk + kPad;

  const bf16* fb = fv + static_cast<size_t>(b) * G * C;
  for (int i = tid; i < G * C; i += kThreads) fv_s[i] = fb[i];
  dpdist::stage_window_offsets(offs_s, off3_s, g, k);
  if (tid < kRows) {
    int v = -1;
    char4 dig = make_char4(0, 0, 0, 0);
    if (tid < rows) {
      const size_t row = static_cast<size_t>(b) * N + n0 + tid;
      v = vox[row];
      if (v >= 0 && v < G) {
        dig = make_char4(static_cast<signed char>(v / (g * g)),
                         static_cast<signed char>((v / g) % g),
                         static_cast<signed char>(v % g), 0);
      } else {
        v = G;   // a row with a zero patch
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) rd_s[tid * 3 + d] = delta[row * 3 + d];
    }
    rv_s[tid] = v;
    rdig_s[tid] = dig;
  }
  __syncthreads();

  // First layer: A = [patch (E), bf16(delta) (3), 0 ...] gathered kChunk
  // columns at a time; B = the packed W1 (k1, width_0).
  FragC acc[2][kTilesPerWarp];
  int tiles = dec.width[0] / 16;
#pragma unroll
  for (int j = 0; j < kTilesPerWarp; ++j) {
    wmma::fill_fragment(acc[0][j], 0.f);
    wmma::fill_fragment(acc[1][j], 0.f);
  }
  for (int kc = 0; kc < dec.k1; kc += kChunk) {
    const int kw = min(kChunk, dec.k1 - kc);
    for (int i = tid; i < kRows * kw; i += kThreads) {
      const int r = i / kw;
      const int col = kc + i - r * kw;
      const int v = rv_s[r];
      float val = 0.f;
      if (v >= 0) {
        if (col < E) {
          const int o = col / C;
          const int c = col - o * C;
          const char4 s = off3_s[o];
          const char4 d = rdig_s[r];
          const int nx = d.x + s.x, ny = d.y + s.y, nz = d.z + s.z;
          if (v < G && nx >= 0 && nx < g && ny >= 0 && ny < g && nz >= 0 && nz < g)
            val = __bfloat162float(fv_s[(v + offs_s[o]) * C + c]);
        } else if (col < E + 3) {
          val = rd_s[r * 3 + col - E];
        }
      }
      a_s[r * lda + (col - kc)] = __float2bfloat16_rn(val);
    }
    __syncthreads();
    for (int ks = 0; ks < kw; ks += 16) {
      FragA a0, a1;
      wmma::load_matrix_sync(a0, a_s + ks, lda);
      wmma::load_matrix_sync(a1, a_s + 16 * lda + ks, lda);
#pragma unroll
      for (int j = 0; j < kTilesPerWarp; ++j) {
        const int t = j * kWarps + warp;
        if (t >= tiles) continue;
        FragB w;
        wmma::load_matrix_sync(w, dec.w[0] + static_cast<size_t>(kc + ks) * dec.width[0] + t * 16,
                               dec.width[0]);
        wmma::mma_sync(acc[0][j], a0, w, acc[0][j]);
        wmma::mma_sync(acc[1][j], a1, w, acc[1][j]);
      }
    }
    __syncthreads();
  }
  store_hidden(acc, dec.b[0], tiles, h0, ldh, scratch, warp, lane);
  __syncthreads();

  // Further hidden layers: A = the previous activations in shared memory.
  bf16* hin = h0;
  bf16* hout = h1;
  for (int l = 1; l < dec.n_hidden; ++l) {
    const int K = dec.width[l - 1];
    const int H = dec.width[l];
    tiles = H / 16;
#pragma unroll
    for (int j = 0; j < kTilesPerWarp; ++j) {
      wmma::fill_fragment(acc[0][j], 0.f);
      wmma::fill_fragment(acc[1][j], 0.f);
    }
    for (int ks = 0; ks < K; ks += 16) {
      FragA a0, a1;
      wmma::load_matrix_sync(a0, hin + ks, ldh);
      wmma::load_matrix_sync(a1, hin + 16 * ldh + ks, ldh);
#pragma unroll
      for (int j = 0; j < kTilesPerWarp; ++j) {
        const int t = j * kWarps + warp;
        if (t >= tiles) continue;
        FragB w;
        wmma::load_matrix_sync(w, dec.w[l] + static_cast<size_t>(ks) * H + t * 16, H);
        wmma::mma_sync(acc[0][j], a0, w, acc[0][j]);
        wmma::mma_sync(acc[1][j], a1, w, acc[1][j]);
      }
    }
    store_hidden(acc, dec.b[l], tiles, hout, ldh, scratch, warp, lane);
    __syncthreads();
    bf16* t = hin;
    hin = hout;
    hout = t;
  }

  // Linear head in float32: one warp per (row, output).
  const int K = dec.width[dec.n_hidden - 1];
  for (int p = warp; p < rows * dec.out; p += kWarps) {
    const int r = p / dec.out;
    const int o = p - r * dec.out;
    const float* wo = dec.w_out + static_cast<size_t>(o) * K;
    float s = 0.f;
    for (int kk = lane; kk < K; kk += kWarp) s += __bfloat162float(hin[r * ldh + kk]) * wo[kk];
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) y[(static_cast<size_t>(b) * N + n0 + r) * dec.out + o] = s + dec.b_out[o];
  }
}

int max_width(const int* widths, int n_hidden) {
  int m = 0;
  for (int i = 0; i < n_hidden; ++i) m = widths[i] > m ? widths[i] : m;
  return m;
}

}  // namespace

extern "C" {

// Shared memory bytes the kernel takes for a (g^3, C) volume, window k and
// hidden layers of the given widths.
size_t dpdist_fused_forward_smem(int g, int k, int C, const int* widths, int n_hidden) {
  return Layout(g, k, C, max_width(widths, n_hidden) + kPad).total;
}

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success) or cudaErrorInvalidValue for sizes the kernel does not take.
// w[i], b[i] and widths[i] describe hidden layer i (host arrays of device
// pointers); w_out (out, widths[n_hidden - 1]) and b_out the linear head.
int dpdist_fused_forward(const void* fv, const int* vox, const float* delta, float* y,
                         const void* const* w, const float* const* b, const int* widths,
                         int n_hidden, int k1, const float* w_out, const float* b_out, int out,
                         int B, int N, int g, int k, int C, int device, void* stream) {
  if (B < 1 || N < 1 || g < 1 || g > 100 || k < 1 || (k % 2) == 0 || k > 2 * g + 1 || C < 1 ||
      n_hidden < 1 || n_hidden > kMaxHidden || out < 1 || k1 % 16 != 0 ||
      k1 < k * k * k * C + 3)
    return static_cast<int>(cudaErrorInvalidValue);
  Decoder dec{};
  for (int i = 0; i < n_hidden; ++i) {
    if (widths[i] < 16 || widths[i] % 16 != 0 || widths[i] > kMaxWidth)
      return static_cast<int>(cudaErrorInvalidValue);
    dec.w[i] = static_cast<const bf16*>(w[i]);
    dec.b[i] = b[i];
    dec.width[i] = widths[i];
  }
  dec.n_hidden = n_hidden;
  dec.k1 = k1;
  dec.w_out = w_out;
  dec.b_out = b_out;
  dec.out = out;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ldh = max_width(widths, n_hidden) + kPad;
  const size_t smem = Layout(g, k, C, ldh).total;
  err = dpdist::set_smem(fused_forward_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kRows - 1) / kRows, B);
  fused_forward_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(fv), vox, delta, y, dec, N, g, k, C, ldh);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
