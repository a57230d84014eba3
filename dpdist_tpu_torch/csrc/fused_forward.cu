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
// as [W1[3:]; W1[:3]; zero rows] and the A operand as [patch, bf16(delta),
// 0...], so the split sum runs in one accumulator.
//
// What bounds it on an H100: operations. Per query row the decoder takes
// 2 * (2503*1024 + 2*1024^2 + 1024*3) = 9.33 MFLOP; at 2B = 512 clouds of
// N = 64 queries that is 0.306 TFLOP, 0.31 ms at the H100 SXM's dense bf16
// tensor peak of 989 TFLOP/s. The bytes (fv, vox, delta in; y out; the
// weights once) are about 25 MB.
//
// Design. The TPU kernel keeps all 9.3 MB of bf16 weights in VMEM; a Hopper
// block has at most 227 KB of shared memory, and one row tile's activations
// at width 1024 (128 rows x 2 KB) do not fit beside a weight pipeline. So a
// call runs one launch per layer, and the hidden activations pass between
// launches as bf16 in device memory (R x width, 64 MB per layer at
// R = 32,768 rows):
//   - a block owns a 128-row tile and walks its 256-column output tiles in
//     turn; two consumer warpgroups (64 rows each) issue wgmma m64n256k16
//     (bf16 in, float32 accumulators in registers) on a ring of stages,
//     keeping one K step's group in flight while the next is issued. A
//     stage holds B (W_i^T, packed K-major, 256 x 64) and A (128 x 64),
//     both with the 128-byte swizzle, under full/empty mbarriers. A block
//     reads each weight byte once per 128 rows;
//   - layers 2.. (`layer_kernel<false>`): one producer warp fills the stages
//     by TMA (cp.async.bulk.tensor), A from the previous layer's h;
//   - layer 1 (`layer_kernel<true>`): A is gathered, never stored in device
//     memory. The block first stages the tile's cloud volumes (at most two
//     clouds, 20 KB each in bf16) in shared memory, and a table of each
//     row's k^3 neighbour cells (int16, -1 outside the grid). Then a
//     gathering warpgroup writes each stage's [patch, bf16(delta), 0] rows
//     straight into the swizzled A tile (lane l of a warp: two channels of
//     one neighbour, one 32-bit load), while its first lane loads B by TMA,
//     running ahead of the tensor cores. A tile whose rows span more clouds
//     than are staged reads the volumes from device memory (L2) instead;
//   - the producers run through every column tile without a break, so the
//     next tile's stages fill during the consumers' epilogue: bias in
//     float32, ReLU, bf16, stored 8 bytes a lane (lane pairs swap a packed
//     pair);
//   - the head (width -> out, 3 for the committed nets) is `head_kernel`,
//     one warp per row reducing in float32 in a fixed order (the same from
//     run to run).
// A call with n hidden layers makes n + 1 launches. The tensor maps are
// encoded on the host per call by cuTensorMapEncodeTiled, a libcuda entry
// point reached through the runtime (cudaGetDriverEntryPoint[ByVersion]),
// so the library needs no -lcuda; they are passed as __grid_constant__
// parameters.
//
// Shared memory per block: layers 2.., kStages = 4 stages of 48 KB (193 KB
// with the barriers and 1 KB of alignment slack); layer 1, kGatherStages =
// 3 stages (144 KB), the neighbour table (128 x 125 x 2 B = 31 KB), the row
// table (2 KB), the window's offsets (1 KB) and two staged volumes (40 KB):
// 220 KB. One block per SM.
//
// The pack (kernels/fused_forward.py:pack_decoder) pads K1 and every hidden
// width to a multiple of kAlign = 64 with zero weights and biases; a padded
// unit is relu(0) = 0 and meets zero rows in the next layer, so the outputs
// do not change. Off-grid queries carry vox 0 and compute cell 0's row; the
// caller's mask zeroes them. A vox outside [0, V) (never made by
// voxel_assign) gathers a zero patch, its delta kept.
//
// Plain C interface for ctypes; no PyTorch headers. Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "patch_rows.cuh"

namespace {

using bf16 = __nv_bfloat16;
using dpdist::kWarp;

constexpr int kBM = 128;                        // rows per block: two warpgroups of 64
constexpr int kBN = 256;                        // output columns per block (wgmma n256)
constexpr int kBK = 64;                         // K per stage: one 128-byte swizzle row
constexpr int kStages = 4;                      // layers 2..: A and B by TMA
constexpr int kGatherStages = 3;                // layer 1: B by TMA, A gathered
constexpr int kConsumerWarps = 8;               // two consumer warpgroups
constexpr int kGatherWarps = 4;                 // layer 1's gathering warpgroup
constexpr int kAlign = kBK;                     // the pack's K and width padding
constexpr int kMaxWidth = 1024;
constexpr int kMaxHidden = 8;
constexpr int kHeadWarps = 8;
constexpr size_t kMaxSmem = 232448;             // dynamic shared memory a block can use
constexpr int kBStage = kBN * kBK * 2;          // 32 KB
constexpr int kAStage = kBM * kBK * 2;          // 16 KB
constexpr int kAHalf = kAStage / 2;             // one warpgroup's 64 rows

// Per row of a tile: base, the element index of the row's cloud volume in
// the volumes staged in shared memory (where all the tile's clouds are
// staged) or in device memory, or -1 for a zero patch (vox outside [0, G),
// or a row past the last); bf16(delta) as two packed pairs.
struct RowInfo {
  int base;
  int vox;
  uint32_t d01, d2;
};

struct GatherArgs {
  const bf16* fv;       // (B, G, C)
  const int* vox;       // (R,)
  const float* delta;   // (R, 3)
  int N, g, k, C;
  int n_stage;          // clouds of a tile whose volume is staged in shared memory (0..2)
};

__host__ __device__ inline size_t align1k(size_t b) { return (b + 1023) / 1024 * 1024; }

// Byte offsets from the 1024-aligned base of shared memory. Layer 1 adds
// the tile's neighbour table (kBM x K3 int16), its row table, the window's
// offsets (K3) and vol_bytes of staged volumes.
struct Smem {
  int stages;
  size_t b, a, nbr, rows, offs, vol, bars, total;
  __host__ __device__ Smem(bool gather, int K3, size_t vol_bytes) {
    stages = gather ? kGatherStages : kStages;
    b = 0;
    a = b + static_cast<size_t>(stages) * kBStage;
    nbr = a + static_cast<size_t>(stages) * kAStage;
    rows = nbr + (gather ? (static_cast<size_t>(kBM) * K3 * sizeof(short) + 15) / 16 * 16 : 0);
    offs = rows + (gather ? kBM * sizeof(RowInfo) : 0);
    vol = offs + (gather ? (static_cast<size_t>(K3) * (sizeof(int) + sizeof(char4)) + 15) / 16 * 16
                         : 0);
    bars = align1k(vol + (gather ? vol_bytes : 0));
    total = bars + 2 * stages * sizeof(uint64_t) + 1024;   // + alignment slack
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Makes this thread's generic-proxy shared stores visible to wgmma (the
// async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kInFlight>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kInFlight) : "memory");
}

// Descriptor of a K-major tile with 128-byte rows and the 128-byte swizzle:
// 8-row core groups 1024 bytes apart (SBO), LBO unused (1), layout 1 at
// bits 62-63. Adding 2 steps the start 32 bytes (16 bf16) along K.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// D (64 x 256, float32, registers) += A (64 x 16, K-major) * B (16 x 256,
// K-major), both from shared memory. Thread t of the warpgroup holds
// d[4j + e] at row 16*(t/32) + (t%32)/4 + 8*(e/2), column 8j + 2*(t%4) + e%2.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// Whether every cloud of the tile from row m0 fits in the staged volumes.
__device__ __forceinline__ bool tile_staged(const GatherArgs& ga, int m0, int R) {
  return (min(m0 + kBM, R) - 1) / ga.N - m0 / ga.N < ga.n_stage;
}

// Layer 1's tables for the tile from row m0, built by the whole block: the
// row table; nbr[r * K3 + o], the cell of row r's neighbour at window
// offset o within its cloud, or -1 outside the grid; and, where the tile's
// clouds fit, their volumes in vol_s (contiguous in fv, copied as one run).
__device__ inline void build_tables(short* nbr, RowInfo* rows, int* offs_s, char4* off3_s,
                                    unsigned short* vol_s, const GatherArgs& ga, int m0, int R) {
  const int G = ga.g * ga.g * ga.g;
  const int K3 = ga.k * ga.k * ga.k;
  const int first = m0 / ga.N;
  const int staged = tile_staged(ga, m0, R) ? (min(m0 + kBM, R) - 1) / ga.N - first + 1 : 0;
  const size_t vol = static_cast<size_t>(G) * ga.C;   // elements of one volume
  const unsigned short* src =
      reinterpret_cast<const unsigned short*>(ga.fv) + static_cast<size_t>(first) * vol;
  const size_t n_copy = static_cast<size_t>(staged) * vol;
  if (vol % 8 == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(vol_s);
    for (size_t i = threadIdx.x; i < n_copy / 8; i += blockDim.x) d4[i] = __ldg(s4 + i);
  } else {
    for (size_t i = threadIdx.x; i < n_copy; i += blockDim.x) vol_s[i] = __ldg(src + i);
  }
  dpdist::stage_window_offsets(offs_s, off3_s, ga.g, ga.k);
  for (int t = threadIdx.x; t < kBM; t += blockDim.x) {
    const int r = m0 + t;
    RowInfo ri{-1, -1, 0u, 0u};
    if (r < R) {
      const int b = r / ga.N;
      const int v = ga.vox[r];
      if (v >= 0 && v < G) {
        ri.base = (staged ? b - first : b) * G * ga.C;
        ri.vox = v;
      }
      const float* d = ga.delta + static_cast<size_t>(r) * 3;
      ri.d01 = bf16_bits(d[0]) | (bf16_bits(d[1]) << 16);
      ri.d2 = bf16_bits(d[2]);
    }
    rows[t] = ri;
  }
  __syncthreads();
  // One warp per row, lanes over the window's offsets.
  for (int t = threadIdx.x / kWarp; t < kBM; t += blockDim.x / kWarp) {
    const int v = rows[t].vox;
    const int vx = v / (ga.g * ga.g), vy = (v / ga.g) % ga.g, vz = v % ga.g;
    for (int o = threadIdx.x % kWarp; o < K3; o += kWarp) {
      const char4 sh = off3_s[o];
      const int nx = vx + sh.x, ny = vy + sh.y, nz = vz + sh.z;
      const bool in = v >= 0 && nx >= 0 && nx < ga.g && ny >= 0 && ny < ga.g && nz >= 0 && nz < ga.g;
      nbr[t * K3 + o] = static_cast<short>(in ? v + offs_s[o] : -1);
    }
  }
}

// Elements of the staged volumes (kSmem) or of fv.
template <bool kSmem>
__device__ __forceinline__ uint32_t load_u16(int e, const unsigned short* vol_s,
                                             const unsigned short* fv) {
  return kSmem ? vol_s[e] : __ldg(fv + e);
}
template <bool kSmem>
__device__ __forceinline__ uint32_t load_u32(int e, const unsigned short* vol_s,
                                             const unsigned short* fv) {
  return kSmem ? *reinterpret_cast<const uint32_t*>(vol_s + e)
               : __ldg(reinterpret_cast<const unsigned int*>(fv + e));
}

// The bf16 bits of column col's value for a row: a patch element (col < E:
// channel col % C of the neighbour at offset col / C), bf16(delta) (E..E+2)
// or 0.
template <bool kSmem>
__device__ __forceinline__ uint32_t column_value(const RowInfo& ri, const short* nbr_row, int col,
                                                 const unsigned short* vol_s,
                                                 const unsigned short* fv, int C, int E) {
  if (col < E) {
    const int o = col / C;
    const int u = nbr_row[o];
    return (ri.base >= 0 && u >= 0) ? load_u16<kSmem>(ri.base + u * C + col - o * C, vol_s, fv)
                                    : 0u;
  }
  const int d = col - E;
  return d == 0 ? (ri.d01 & 0xffffu) : (d == 1 ? (ri.d01 >> 16) : (d == 2 ? ri.d2 : 0u));
}

// One warp of the gathering warpgroup writes 16 of 64 rows of A for K
// columns kc..kc+63 into the swizzled tile a (64 rows x 128 bytes): lane l
// of warp w writes columns kc+2l, kc+2l+1 of rows w, w+4, ..., so each
// warp store fills one 128-byte row. Where C is even the two columns are
// two channels of one neighbour, 4-byte aligned, and one 32-bit load
// fetches both. All 16 rows' loads are issued before the first store, so
// their latencies overlap.
template <bool kSmem>
__device__ inline void gather_a(unsigned char* a, int kc, const short* nbr, const RowInfo* rows,
                                const unsigned short* vol_s, const unsigned short* fv, int C,
                                int E, int K3, int warp4, int lane) {
  const int col = kc + 2 * lane;
  uint32_t v[16];
  if (C % 2 == 0 && col < E) {
    const int o = col / C;
    const int ch = col - o * C;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = warp4 + 4 * i;
      const int base = rows[r].base;
      const int u = nbr[r * K3 + o];
      v[i] = (base >= 0 && u >= 0) ? load_u32<kSmem>(base + u * C + ch, vol_s, fv) : 0u;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = warp4 + 4 * i;
      const RowInfo ri = rows[r];
      v[i] = column_value<kSmem>(ri, nbr + r * K3, col, vol_s, fv, C, E) |
             (column_value<kSmem>(ri, nbr + r * K3, col + 1, vol_s, fv, C, E) << 16);
    }
  }
  const uint32_t chunk = static_cast<uint32_t>(lane >> 2);
  const uint32_t within = static_cast<uint32_t>(lane & 3) << 2;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = warp4 + 4 * i;
    *reinterpret_cast<uint32_t*>(a + r * 128 + ((chunk ^ (r & 7)) << 4) + within) = v[i];
  }
}

// One 128 x 256 tile of relu(A @ W^T + bias) in bf16. Warps 0-7 are two
// consumer warpgroups (rows 0-63 and 64-127 of the tile) issuing wgmma on
// a ring of stages, each holding A (128 x 64) and W^T (256 x 64). Layers
// 2.. (kGather false): warp 8 loads A (the previous layer's h, map_a) and
// B (map_b) by TMA. Layer 1 (kGather): warps 8-11 gather A into the stage
// from the column and row tables while warp 8's lane 0 loads B by TMA, so
// the gather runs ahead of the tensor cores.
template <bool kGather>
__global__ void __launch_bounds__((kConsumerWarps + (kGather ? kGatherWarps : 1)) * kWarp, 1)
    layer_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                 const float* __restrict__ bias, bf16* __restrict__ h_out, int R, int K, int Npad,
                 GatherArgs ga) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int K3 = ga.k * ga.k * ga.k;
  const Smem L(kGather, K3,
               static_cast<size_t>(ga.n_stage) * ga.g * ga.g * ga.g * ga.C * sizeof(bf16));
  constexpr int kS = kGather ? kGatherStages : kStages;
  unsigned char* b_s = smem + L.b;
  unsigned char* a_s = smem + L.a;
  short* nbr = reinterpret_cast<short*>(smem + L.nbr);
  RowInfo* rows = reinterpret_cast<RowInfo*>(smem + L.rows);
  int* offs_s = reinterpret_cast<int*>(smem + L.offs);
  char4* off3_s = reinterpret_cast<char4*>(offs_s + K3);
  unsigned short* vol_s = reinterpret_cast<unsigned short*>(smem + L.vol);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + kS;

  const int m0 = blockIdx.x * kBM;
  const int nk = K / kBK;
  const int steps = (Npad + kBN - 1) / kBN * nk;   // (column tile, K step) pairs, in order
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      // Layer 1: the TMA thread's arrive.expect_tx and one arrive per gather warp.
      mbar_init(&full[s], kGather ? 1 + kGatherWarps : 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (kGather) build_tables(nbr, rows, offs_s, off3_s, vol_s, ga, m0, R);
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // Producers run through every column tile's K steps without a break,
    // so the next tile's first stages load during the consumers' epilogue.
    const int pw = warp - kConsumerWarps;
    if (kGather) {
      const unsigned short* fv = reinterpret_cast<const unsigned short*>(ga.fv);
      const bool staged = tile_staged(ga, m0, R);
      const int E = K3 * ga.C;
      const short* nbr_hi = nbr + 64 * K3;
      for (int it = 0; it < steps; ++it) {
        const int s = it % kS;
        const int kc = (it % nk) * kBK;
        mbar_wait(&empty[s], ((it / kS) & 1) ^ 1);
        if (pw == 0 && lane == 0) {
          mbar_expect_tx(&full[s], kBStage);
          tma_load_2d(b_s + s * kBStage, &map_b, &full[s], kc, (it / nk) * kBN);
        }
        unsigned char* a = a_s + s * kAStage;
        if (staged) {
          gather_a<true>(a, kc, nbr, rows, vol_s, fv, ga.C, E, K3, pw, lane);
          gather_a<true>(a + kAHalf, kc, nbr_hi, rows + 64, vol_s, fv, ga.C, E, K3, pw, lane);
        } else {
          gather_a<false>(a, kc, nbr, rows, vol_s, fv, ga.C, E, K3, pw, lane);
          gather_a<false>(a + kAHalf, kc, nbr_hi, rows + 64, vol_s, fv, ga.C, E, K3, pw, lane);
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[s]);
      }
    } else if (pw == 0 && lane == 0) {
      for (int it = 0; it < steps; ++it) {
        const int s = it % kS;
        const int kc = (it % nk) * kBK;
        mbar_wait(&empty[s], ((it / kS) & 1) ^ 1);
        mbar_expect_tx(&full[s], kBStage + kAStage);
        tma_load_2d(b_s + s * kBStage, &map_b, &full[s], kc, (it / nk) * kBN);
        tma_load_2d(a_s + s * kAStage, &map_a, &full[s], kc, m0);
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int r0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int q = lane % 4;
  for (int it = 0; it < steps; it += nk) {
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    // One K step's wgmma group stays in flight while the next is issued;
    // a stage is released once the group that read it has completed.
    for (int kb = 0; kb < nk; ++kb) {
      const int s = (it + kb) % kS;
      mbar_wait(&full[s], ((it + kb) / kS) & 1);
      const uint64_t da = smem_desc(a_s + s * kAStage + wg * kAHalf);
      const uint64_t db = smem_desc(b_s + s * kBStage);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) wgmma_m64n256k16(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();
      if (kb > 0 && lane == 0) mbar_arrive(&empty[(it + kb - 1) % kS]);
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[(it + nk - 1) % kS]);

    // Epilogue: bias in float32, ReLU, bf16. Lane pairs (q, q^1) swap one
    // packed pair, so that each lane stores 4 consecutive columns of one
    // row (8 bytes): row r0 from even lanes, row r0 + 8 from odd ones.
    const int n0 = it / nk * kBN;
    const int r = r0 + 8 * (q & 1);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + j * 8 + q * 2;
      const float b0 = col < Npad ? bias[col] : 0.f, b1 = col < Npad ? bias[col + 1] : 0.f;
      __nv_bfloat162 lo, hi;
      lo.x = __float2bfloat16_rn(fmaxf(acc[4 * j] + b0, 0.f));
      lo.y = __float2bfloat16_rn(fmaxf(acc[4 * j + 1] + b1, 0.f));
      hi.x = __float2bfloat16_rn(fmaxf(acc[4 * j + 2] + b0, 0.f));
      hi.y = __float2bfloat16_rn(fmaxf(acc[4 * j + 3] + b1, 0.f));
      const uint32_t mine = *reinterpret_cast<uint32_t*>((q & 1) ? &hi : &lo);
      const uint32_t other = __shfl_xor_sync(0xffffffffu,
                                             *reinterpret_cast<uint32_t*>((q & 1) ? &lo : &hi), 1);
      const int c4 = n0 + j * 8 + (q & 2) * 2;   // the first of the lane's 4 columns
      if (r < R && c4 < Npad) {
        const uint2 v = (q & 1) ? make_uint2(other, mine) : make_uint2(mine, other);
        *reinterpret_cast<uint2*>(h_out + static_cast<size_t>(r) * Npad + c4) = v;
      }
    }
  }
}

// y = h @ w_out^T + b_out in float32: one warp per row, lanes over columns
// in pairs, summed in a fixed order.
__global__ void head_kernel(const bf16* __restrict__ h, int ld, const float* __restrict__ w_out,
                            const float* __restrict__ b_out, int out, float* __restrict__ y,
                            int R) {
  const int r = blockIdx.x * kHeadWarps + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (r >= R) return;
  const __nv_bfloat162* hr = reinterpret_cast<const __nv_bfloat162*>(h + static_cast<size_t>(r) * ld);
  for (int o = 0; o < out; ++o) {
    const float2* wo = reinterpret_cast<const float2*>(w_out + static_cast<size_t>(o) * ld);
    float s = 0.f;
    for (int p = lane; p < ld / 2; p += kWarp) {
      const float2 hv = __bfloat1622float2(hr[p]);
      const float2 wv = wo[p];
      s += hv.x * wv.x + hv.y * wv.y;
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) y[static_cast<size_t>(r) * out + o] = s + b_out[o];
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p)
                                                                    : nullptr;
  }();
  return fn;
}

// A (rows, cols) row-major bf16 matrix cut in (box_rows, 64) boxes with the
// 128-byte swizzle; rows past the end read as zeros.
bool encode_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(bf16)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// Shared memory bytes the larger of the two layer kernels takes for a
// window of k^3 (no volume staged).
size_t dpdist_fused_forward_smem(int k) {
  const size_t a = Smem(true, k * k * k, 0).total, b = Smem(false, 0, 0).total;
  return a > b ? a : b;
}

// Launches on `stream`: n_hidden layer launches and the head; returns the
// first cudaGetLastError() that is not 0 (0 on success), or
// cudaErrorInvalidValue for sizes the kernels do not take (or a tensor map
// cuTensorMapEncodeTiled refuses). w[i] is hidden layer i's packed W^T (widths[i],
// K_i) in bf16 with K_0 = k1 and K_i = widths[i - 1]; b[i] its (widths[i],)
// float32 bias; w_out (out, widths[n_hidden - 1]) and b_out the head;
// h0 and h1 two (B*N, max width) bf16 scratch buffers. Every width and k1
// is a multiple of 64 (the pack pads them); g is at most 32, so that a cell
// index fits the int16 neighbour table.
int dpdist_fused_forward(const void* fv, const int* vox, const float* delta, float* y,
                         const void* const* w, const float* const* b, const int* widths,
                         int n_hidden, int k1, const float* w_out, const float* b_out, int out,
                         void* h0, void* h1, int B, int N, int g, int k, int C, int device,
                         void* stream) {
  const long long R = static_cast<long long>(B) * N;
  const long long G = static_cast<long long>(g) * g * g;
  if (B < 1 || N < 1 || g < 1 || g > 32 || k < 1 || (k % 2) == 0 || k > 2 * g + 1 || C < 1 ||
      n_hidden < 1 || n_hidden > kMaxHidden || out < 1 || k1 % kAlign != 0 ||
      k1 < k * k * k * C + 3 || B * G * C >= (1LL << 31) || R >= (1LL << 31) - kBM)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n_hidden; ++i)
    if (widths[i] < kAlign || widths[i] % kAlign != 0 || widths[i] > kMaxWidth)
      return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  // Stage as many of a tile's clouds (at most 2) as shared memory holds.
  const size_t vol_bytes = static_cast<size_t>(G) * C * sizeof(bf16);
  int n_stage = 2;
  const int K3 = k * k * k;
  while (n_stage > 0 && Smem(true, K3, n_stage * vol_bytes).total > kMaxSmem) --n_stage;
  const GatherArgs ga{static_cast<const bf16*>(fv), vox, delta, N, g, k, C, n_stage};
  const size_t smem_g = Smem(true, K3, n_stage * vol_bytes).total;
  const size_t smem_h = Smem(false, 0, 0).total;
  err = dpdist::set_smem(layer_kernel<true>, smem_g);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = dpdist::set_smem(layer_kernel<false>, smem_h);
  if (err != cudaSuccess) return static_cast<int>(err);

  void* bufs[2] = {h0, h1};
  int K = k1;
  for (int i = 0; i < n_hidden; ++i) {
    CUtensorMap map_a{}, map_b{};
    if (!encode_map(&map_b, w[i], widths[i], K, kBN)) return static_cast<int>(cudaErrorInvalidValue);
    bf16* out_h = static_cast<bf16*>(bufs[i % 2]);
    const dim3 grid(static_cast<unsigned>((R + kBM - 1) / kBM));
    if (i == 0) {
      map_a = map_b;   // unused by the gathering kernel
      layer_kernel<true><<<grid, (kConsumerWarps + kGatherWarps) * kWarp, smem_g, s>>>(
          map_a, map_b, b[i], out_h, static_cast<int>(R), K, widths[i], ga);
    } else {
      if (!encode_map(&map_a, bufs[(i - 1) % 2], static_cast<int>(R), K, kBM))
        return static_cast<int>(cudaErrorInvalidValue);
      layer_kernel<false><<<grid, (kConsumerWarps + 1) * kWarp, smem_h, s>>>(
          map_a, map_b, b[i], out_h, static_cast<int>(R), K, widths[i], ga);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    K = widths[i];
  }
  const unsigned head_blocks = static_cast<unsigned>((R + kHeadWarps - 1) / kHeadWarps);
  head_kernel<<<head_blocks, kHeadWarps * kWarp, 0, s>>>(
      static_cast<const bf16*>(bufs[(n_hidden - 1) % 2]), K, w_out, b_out, out, y,
      static_cast<int>(R));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
