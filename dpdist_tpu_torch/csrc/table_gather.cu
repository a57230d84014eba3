// Patch gather from a Fisher-vector volume, and its adjoint.
//
// table_gather_x replaces the TPU kernel
// dpdist_tpu/kernels/table_gather_pallas.py:_x_kernel (reached through
// table_gather_x, `pl.pallas_call` in _table_gather_x_impl): from a cloud's
// (V, C) FV volume and its (N, 3) queries it writes the decoder input
// x = [delta, patch] (N, W = 3 + k^3*C) and each query's voxel. The TPU
// kernel builds a (V, k^3*C) patch table in VMEM and gathers rows with a
// one-hot matmul for its matrix unit; here the (V, C) volume (40 KB at the
// canonical V = 512, C = 20) sits in shared memory and every element of x
// reads its value by index, so the patch table never exists. The output is
// a pure copy plus q - centre, so it equals the plain PyTorch composition
// exactly.
//   What bounds it on an H100: device memory, almost all of it the x it
//   writes (164 MB at B = 256 clouds, N = 64 queries, k = 5, C = 20: about
//   0.05 ms at 3.35 TB/s; 10.5 MB of volumes in). The design keeps the
//   copy engine writing while the threads build rows, and the volume loads
//   off the threads' path:
//   - one persistent block per SM walks work items (a cloud's run of at
//     most 128 rows); each item's volume arrives by one bulk copy
//     (cp.async.bulk, completion on an mbarrier), and the next item's
//     volume loads into a second buffer while this item's rows are built;
//   - rows are built in shared memory in groups of R rows whose span in x
//     starts on a 16-byte boundary and is a multiple of 16 bytes,
//     R = 16 / gcd(W * bytes, 16) (4 float32 rows of 2,503, or 8 bfloat16
//     ones: 40,048 B either way), and each group leaves by one bulk store
//     from a double buffer (commit_group; wait_group.read before a buffer
//     is refilled). A row off such a boundary (the head or tail of an item
//     when N is not a multiple of R) is written by per-thread stores;
//   - a thread builds chunks of 4 elements of one neighbour cell (C a
//     multiple of 4; else 1): one window test and one 16-byte shared load a
//     chunk, where the chunk lies and what it reads worked out once per
//     kernel.
//   What holds it on the card is the bulk stores' rate into device
//   memory (PERF.md).
//   Voxel assignment keeps true division and ceilf; delta is q - centre in
//   float32.
//
// table_gather replaces the TPU kernel
// dpdist_tpu/kernels/table_gather_pallas.py:_kernel (reached through
// table_gather, `pl.pallas_call` in _table_gather_impl): the same patch rows
// without voxel assignment and delta, for given voxel ids,
// (V, C) volume + (N,) vox -> (N, k^3*C). The reference takes it for
// N > 128 queries, where its VMEM budget forces that split. One block per
// (cloud, tile of queries) stages the volume in shared memory, then one warp
// per row (patch_rows.cuh:gather_patch_rows, which gather_fused.cu shares).
// Off-grid queries carry vox = 0 and read cell 0's patch, as the reference
// does; the model's mask zeroes them later. A vox outside [0, V) (never made
// by voxel_assign) gives a zero row. A pure copy: it equals the plain
// gather_patches(extract_patches(fv), vox) exactly.
//   What bounds it on an H100: device memory. At B = 256, N = 256 it writes
//   655 MB (about 0.2 ms at 3.35 TB/s); the design keeps the volume on chip
//   and touches each output element once, coalesced.
//
// Both forward kernels write float32 or, for the bf16 serving paths,
// bfloat16: each value of x (the patch and delta) is the float32 value
// rounded once to nearest even, as the reference's .astype(dtype) on its
// table and on delta (table_gather_pallas.py:84, :119). Forward only.
//
// table_gather_bwd replaces dpdist_tpu/kernels/table_gather_pallas.py:
// _bwd_kernel + _fold_and_emit (`pl.pallas_call` in _table_gather_bwd_impl),
// and with it the two V-in-lanes layouts of the same adjoint
// (_table_gather_bwd_transposed_ng, _table_gather_bwd_transposed):
//   dfv[v, c] = sum of grad[n, o*C + c] over the (n, o) whose neighbour of
//   vox[n] at offset o is v; neighbours outside the grid add nothing.
// On the TPU it is a transposed one-hot matmul and a fold. Here each output
// slot is owned by one thread, which pulls its terms in. One block per
// (cloud, slab), a slab being the g^2 cells that share the first digit of
// the flat cell, v / g^2 (g^2 * C = 1,280 slots at g = 8). A query's window
// meets a slab at one first-digit offset di, and its grad entries for that
// slab are one contiguous run of k^2 * C floats (2 KB); every in-grid
// (n, o, c) entry is read by exactly one (block, slot). The block lists, in
// query order, the queries whose window meets its slab (a vox outside
// [0, V) adds nothing), and their runs stream through a ring of 4 stages of
// 8 runs in shared memory, each run brought by one bulk copy (cp.async.bulk,
// a stage complete on its mbarrier). Each thread keeps its few slots in
// registers: no shared accumulator, no atomics, and one barrier per stage
// of 8 queries, not per query. Each slot sums over n = 0 .. N-1 from 0.0f
// in query order, so the result is the same from run to run and equals an
// ordered plain sum (one index_add_ per query, in query order) bit for bit.
// Off-grid queries carry vox = 0 and scatter into cell 0's neighbourhood, as
// the reference does; the kernel follows vox, never the mask.
//   What bounds it on an H100: device memory, the in-grid grad entries it
//   reads (about 150 MB at B = 256, N = 64: 0.048 ms at 3.35 TB/s). Up to
//   64 KB of runs are in flight per block, three blocks per SM, against
//   the one dependent load per add of a shared-memory scatter.
//
// Plain C interface for ctypes; no PyTorch headers. Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include "patch_rows.cuh"

namespace {

using dpdist::kWarp;
using dpdist::set_smem;
using dpdist::store_out;

// --- bulk copies (the copy engine), completion on an mbarrier or a bulk group

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(1u) : "memory");
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

// Orders this thread's generic-proxy shared memory accesses before the
// copy engine's (async proxy) accesses that follow.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One thread: arrives on `bar` (count 1), whose phase then completes once
// `bytes` have landed by bulk_load.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One thread: `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from device memory into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One thread: `bytes` from shared memory to device memory, as one bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
                   reinterpret_cast<uint64_t>(dst)),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Until at most one of this thread's bulk stores still reads shared memory.
__device__ __forceinline__ void bulk_wait_read_all_but_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
}

// Until all of this thread's bulk stores are complete.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// --- table_gather_x (row 2)

constexpr int kXThreads = 512;   // threads of a block
constexpr int kXMaxRows = 128;   // rows of one work item

// One query row of the item in hand.
struct XRow {
  int vC;         // v * C: the row of the query's cell in the volume
  char4 digits;   // (v / g^2, (v / g) % g, v % g)
  float delta[3];
};

// The patch elements of a run of rows fall into chunks of CW consecutive
// elements of one neighbour cell (CW divides C), numbered q = r * E / CW +
// e / CW. In one pass a thread owns chunks q0 + threadIdx.x + j * blockDim.x,
// j < J; for each it keeps where the chunk lies in the rows being built
// (pos = r * W + 3 + e), its offset in the volume from the row's cell
// (eoff = shift * C + c) and its digit shift (s.x, s.y, s.z), with its row
// in s.w (-1: no chunk).
template <int J>
struct Chunks {
  int pos[J];
  int eoff[J];
  char4 s[J];
};

template <int CW, int J>
__device__ __forceinline__ void fill_chunks(Chunks<J>& ch, int q0, int rows, int W, int g, int k,
                                            int C) {
  const int kh = k / 2;
  const int per_row = (W - 3) / CW;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int q = q0 + threadIdx.x + j * blockDim.x;
    ch.pos[j] = ch.eoff[j] = 0;
    ch.s[j] = make_char4(0, 0, 0, -1);
    if (q < rows * per_row) {
      const int r = q / per_row;
      const int e = (q - r * per_row) * CW;
      const int o = e / C, c = e - (e / C) * C;
      const int sx = o / (k * k) - kh, sy = (o / k) % k - kh, sz = o % k - kh;
      ch.pos[j] = r * W + 3 + e;
      ch.eoff[j] = (sx * g * g + sy * g + sz) * C + c;
      ch.s[j] = make_char4(static_cast<signed char>(sx), static_cast<signed char>(sy),
                           static_cast<signed char>(sz), static_cast<signed char>(r));
    }
  }
}

// Writes this thread's chunks of rows rows_s[0 ..) to dst (shared or device
// memory): each element from the volume fv_s, 0 outside the grid. All
// loads are issued before the first store, which might alias them.
template <int CW, int J, typename T>
__device__ __forceinline__ void emit_chunks(T* dst, const XRow* rows_s, const Chunks<J>& ch,
                                            const float* fv_s, int g) {
  float val[J][CW];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const char4 s = ch.s[j];
    const XRow& ri = rows_s[s.w < 0 ? 0 : s.w];
    const int vC = ri.vC;
    const char4 d = ri.digits;
    const bool in = s.w >= 0 &&
                    static_cast<unsigned>(d.x + s.x) < static_cast<unsigned>(g) &&
                    static_cast<unsigned>(d.y + s.y) < static_cast<unsigned>(g) &&
                    static_cast<unsigned>(d.z + s.z) < static_cast<unsigned>(g);
    const float* src = fv_s + (vC + ch.eoff[j]);
    if constexpr (CW == 4) {
      const float4 t = in ? *reinterpret_cast<const float4*>(src) : make_float4(0.f, 0.f, 0.f, 0.f);
      val[j][0] = t.x;
      val[j][1] = t.y;
      val[j][2] = t.z;
      val[j][3] = t.w;
    } else {
#pragma unroll
      for (int i = 0; i < CW; ++i) val[j][i] = in ? src[i] : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (ch.s[j].w >= 0) {
#pragma unroll
      for (int i = 0; i < CW; ++i) store_out(dst + ch.pos[j] + i, val[j][i]);
    }
}

// Rows rows_s[0 .. rows) of the item in hand, written to dst (their first
// row): the delta of each and its patch chunks, in passes of J chunks per
// thread. `cached` holds the first pass's chunks where the caller filled
// them for these many rows (passes == 1).
template <int CW, int J, typename T>
__device__ __forceinline__ void emit_rows(T* dst, const XRow* rows_s, int rows, Chunks<J>& ch,
                                          bool cached, const float* fv_s, int W, int g, int k,
                                          int C) {
  if (threadIdx.x < 3 * rows) {
    const int r = threadIdx.x / 3, d = threadIdx.x - (threadIdx.x / 3) * 3;
    store_out(dst + r * W + d, rows_s[r].delta[d]);
  }
  const int n_chunks = rows * ((W - 3) / CW);
  for (int q0 = 0; q0 < n_chunks; q0 += J * blockDim.x) {
    if (!cached) fill_chunks<CW>(ch, q0, rows, W, g, k, C);
    emit_chunks<CW>(dst, rows_s, ch, fv_s, g);
  }
}

// What the host decides for one launch of table_gather_x_kernel.
struct XPlan {
  int rows_per_item;     // L: an item is rows [n0, n0 + L) of one cloud
  int items_per_cloud;
  int n_items;
  int group_rows;        // R; 0: every row by per-thread stores
  int prefetch;          // 1: two volume buffers, the next item's volume loads during this one
  int bulk_volume;       // 1: a volume arrives by one bulk copy; 0: by per-thread loads
  uint32_t vol_bytes;    // G * C * 4
  uint32_t vol_stride;   // bytes of a volume buffer
  uint32_t buf_off, buf_stride, rows_off, bar_off;
  size_t smem;           // 0: no layout fits
};

// CW: elements per chunk (4 where C is a multiple of 4, else 1); J: chunks
// per thread per pass, so that 512 * J * CW covers a float32 group of 4
// rows or a bfloat16 group of 8 at W = 2,503.
template <typename T, int CW, int J>
__global__ void __launch_bounds__(kXThreads, 1)
    table_gather_x_kernel(const float* __restrict__ fv,       // (B, G, C)
                          const float* __restrict__ queries,  // (B, N, 3)
                          const float* __restrict__ centers,  // (G, 3)
                          T* __restrict__ x,                  // (B, N, W)
                          int* __restrict__ vox_out,          // (B, N)
                          int N, int g, int k, int C, const XPlan plan) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = g * g * g;
  const int W = 3 + k * k * k * C;
  const int R = plan.group_rows;
  const int tid = threadIdx.x, n_blocks = gridDim.x;
  XRow* rows_s = reinterpret_cast<XRow*>(smem + plan.rows_off);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + plan.bar_off);
  auto volume = [&](int slot) {
    return reinterpret_cast<float*>(smem + slot * plan.vol_stride);
  };
  auto stage = [&](int item, int slot) {   // one thread, bulk_volume only
    const size_t b = item / plan.items_per_cloud;
    fence_proxy_async();
    mbar_expect(&bars[slot], plan.vol_bytes);
    bulk_load(volume(slot), fv + b * G * C, plan.vol_bytes, &bars[slot]);
  };

  if (tid == 0 && plan.bulk_volume) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // A group's chunks, worked out once where one pass covers them.
  Chunks<J> ch;
  const bool cached = R > 0 && R * ((W - 3) / CW) <= J * kXThreads;
  bool ch_groups = false;   // ch holds the groups' chunks
  __syncthreads();
  if (tid == 0 && plan.bulk_volume) stage(blockIdx.x, 0);   // the grid has no more blocks than items

  int group = 0;   // groups this block has stored: which row buffer is next
  int it = 0;      // items this block has taken
  for (int item = blockIdx.x; item < plan.n_items; item += n_blocks, ++it) {
    const int b = item / plan.items_per_cloud;
    const int n0 = (item % plan.items_per_cloud) * plan.rows_per_item;
    const int n1 = min(N, n0 + plan.rows_per_item);
    const int slot = plan.prefetch ? (it & 1) : 0;
    const int64_t r0 = static_cast<int64_t>(b) * N + n0, r1 = r0 + (n1 - n0);

    if (tid < n1 - n0) {   // the item's rows: voxel, delta
      const float* q = queries + (r0 + tid) * 3;
      const int v = dpdist::assign_voxel(q, g);
      vox_out[r0 + tid] = v;
      XRow ri;
      ri.vC = v * C;
      ri.digits = make_char4(static_cast<signed char>(v / (g * g)),
                             static_cast<signed char>((v / g) % g),
                             static_cast<signed char>(v % g), 0);
#pragma unroll
      for (int d = 0; d < 3; ++d) ri.delta[d] = q[d] - centers[v * 3 + d];
      rows_s[tid] = ri;
    }
    float* fv_s = volume(slot);
    if (plan.bulk_volume) {
      // The other buffer's last reader, the previous item, is done (the
      // barrier at the end of its loop).
      if (tid == 0 && plan.prefetch && item + n_blocks < plan.n_items)
        stage(item + n_blocks, slot ^ 1);
      mbar_wait(&bars[slot], plan.prefetch ? (it >> 1) & 1 : it & 1);
    } else {
      const float* fb = fv + static_cast<size_t>(b) * G * C;
      for (int i0 = tid; i0 < G * C; i0 += kXThreads * 8) {
        float t[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = i0 + j * kXThreads;
          t[j] = i < G * C ? fb[i] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = i0 + j * kXThreads;
          if (i < G * C) fv_s[i] = t[j];
        }
      }
    }
    __syncthreads();

    // Rows [r0, a) and [z, r1) by per-thread stores, whole groups in [a, z).
    int64_t a = r1, z = r1;
    if (R > 0) {
      const int64_t first = (r0 + R - 1) / R * R, last = r1 / R * R;
      a = first < r1 ? first : r1;
      z = last > a ? last : a;
    }
    // A row by per-thread stores fills ch for itself; the groups' chunks
    // are worked out again after it.
    for (int64_t r = r0; r < a; ++r, ch_groups = false)
      emit_rows<CW>(x + r * W, rows_s + (r - r0), 1, ch, false, fv_s, W, g, k, C);
    if (cached && !ch_groups && a < z) {
      fill_chunks<CW>(ch, 0, R, W, g, k, C);
      ch_groups = true;
    }
    for (int64_t g0 = a; g0 < z; g0 += R, ++group) {
      T* buf = reinterpret_cast<T*>(smem + plan.buf_off + (group & 1) * plan.buf_stride);
      if (tid == 0) bulk_wait_read_all_but_one();   // the store that last read buf is done
      __syncthreads();
      emit_rows<CW>(buf, rows_s + (g0 - r0), R, ch, cached, fv_s, W, g, k, C);
      fence_proxy_async();
      __syncthreads();
      if (tid == 0) bulk_store(x + g0 * W, buf, static_cast<uint32_t>(R * W * sizeof(T)));
    }
    for (int64_t r = z; r < r1; ++r, ch_groups = false)
      emit_rows<CW>(x + r * W, rows_s + (r - r0), 1, ch, false, fv_s, W, g, k, C);
    __syncthreads();   // this item's volume and rows are no longer read
    if (tid == 0 && plan.bulk_volume && !plan.prefetch && item + n_blocks < plan.n_items)
      stage(item + n_blocks, 0);
  }
  if (tid == 0) bulk_wait_all();
}

uint32_t align128(size_t b) { return static_cast<uint32_t>((b + 127) / 128 * 128); }

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// The largest layout that fits: two volume buffers and two row-group
// buffers; else one volume; else rows by per-thread stores only.
XPlan plan_x(int B, int N, int g, int k, int C, int out_bytes, bool fv_aligned, bool x_aligned,
             int n_sm, size_t max_smem) {
  XPlan p{};
  const int G = g * g * g;
  const int W = 3 + k * k * k * C;
  p.vol_bytes = static_cast<uint32_t>(G) * C * 4;
  p.vol_stride = align128(p.vol_bytes);
  p.bulk_volume = fv_aligned && (G * C) % 4 == 0;
  const int R = x_aligned ? 16 / gcd(W * out_bytes, 16) : 0;
  const uint32_t buf_stride = align128(static_cast<size_t>(R) * W * out_bytes);
  const uint32_t rows_bytes = align128(kXMaxRows * sizeof(XRow));
  const int options[][2] = {{1, 1}, {1, 0}, {0, 1}, {0, 0}};   // {row groups, prefetch}
  for (const auto& o : options) {
    if ((o[0] && R == 0) || (o[1] && !p.bulk_volume)) continue;
    p.group_rows = o[0] ? R : 0;
    p.prefetch = o[1];
    p.buf_stride = p.group_rows ? buf_stride : 0;
    p.buf_off = p.vol_stride * (p.prefetch ? 2 : 1);
    p.rows_off = p.buf_off + 2 * p.buf_stride;
    p.bar_off = p.rows_off + rows_bytes;
    p.smem = p.bar_off + 2 * sizeof(uint64_t);
    if (p.smem <= max_smem) break;
    p.smem = 0;
  }
  // Rows per item: a multiple of R, at most kXMaxRows, halved while the
  // items do not fill the card.
  const int unit = p.group_rows > 0 ? p.group_rows : 1;
  int L = std::min((N + unit - 1) / unit * unit, kXMaxRows / unit * unit);
  while (L > unit && static_cast<int64_t>(B) * ((N + L - 1) / L) < n_sm)
    L = std::max(unit, (L / 2 + unit - 1) / unit * unit);
  p.rows_per_item = L;
  p.items_per_cloud = (N + L - 1) / L;
  p.n_items = B * p.items_per_cloud;
  return p;
}

// --- table_gather (row 6)

template <typename T>
__global__ void table_gather_kernel(const float* __restrict__ fv,   // (B, G, C)
                                    const int* __restrict__ vox,    // (B, N)
                                    T* __restrict__ out,            // (B, N, k^3*C)
                                    int N, int g, int k, int C, int rows_per_block) {
  dpdist::gather_patch_rows(fv, vox, out, N, g, k, C, rows_per_block,
                            [](size_t) { return true; });
}

// --- table_gather_bwd (rows 3, 4, 5)

constexpr int kBwdSlots = 5;         // dfv slots a thread owns in one pass
constexpr int kBwdMaxThreads = 256;  // 256 * 5 = 1,280 = a slab's slots at g = 8, C = 20
constexpr int kBwdStages = 4;        // stages of the ring of grad runs
constexpr int kBwdMaxPerStage = 8;   // queries' runs per stage

// Block (b, slab): dfv[b, slab * g^2 + cell, c] for the slab's g^2 cells.
// Slot s = cell * C + c; a thread owns slots tid + j * blockDim.x. For a
// query in voxel (vx, vy, vz) whose window meets the slab at di = slab -
// vx + k/2, slot (ny, nz, c) takes element (dj * k + dl) * C + c of the
// query's run grad[n, di * k^2 * C ..][0 .. k^2 * C), with dj = ny - vy +
// k/2, dl = nz - vz + k/2 when both lie in [0, k). The listed queries' runs
// stream through a ring of kBwdStages stages of `per_stage` runs in shared
// memory, each run brought by one bulk copy of its 16-byte-aligned span
// (`slot_floats` floats a run: k^2 * C and up to 3 before it, rounded up),
// a stage complete on its mbarrier; one barrier per stage frees it for the
// stage kBwdStages on.
__global__ void __launch_bounds__(kBwdMaxThreads)
    table_gather_bwd_kernel(const int* __restrict__ vox,     // (B, N)
                            const float* __restrict__ grad,  // (B, N, k^3*C), strided
                            int64_t stride_b, int stride_n,
                            float* __restrict__ dfv,         // (B, G, C)
                            int N, int g, int k, int C, int per_stage, int slot_floats) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int T = blockDim.x;
  float* ring = reinterpret_cast<float*>(smem);   // kBwdStages * per_stage * slot_floats
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kBwdStages * per_stage * slot_floats);
  int* run_s = reinterpret_cast<int*>(full + kBwdStages);   // T: a listed query's run, from gb
  int* yz_s = run_s + T;                                    // T: vy | vz << 8 | lead << 16
  int* warp_s = yz_s + T;                                   // T / 32: hits per warp
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int b = blockIdx.x, slab = blockIdx.y;
  const int gg = g * g, G = gg * g, kh = k / 2, run = k * k * C, slots = gg * C;
  const float* gb = grad + b * stride_b;
  const int* vb = vox + static_cast<size_t>(b) * N;
  float* db = dfv + (static_cast<size_t>(b) * G + static_cast<size_t>(slab) * gg) * C;

  if (tid == 0) {
    for (int s = 0; s < kBwdStages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // One thread: the runs of list entries [first, last) into ring stage
  // `stage`, each as its 16-byte-aligned span.
  auto span = [&](int i, uintptr_t& a0) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(gb + run_s[i]);
    a0 = a & ~uintptr_t{15};
    return static_cast<uint32_t>(((a + 4 * run + 15) & ~uintptr_t{15}) - a0);
  };
  auto fill = [&](int first, int last, int stage) {
    uintptr_t a0;
    uint32_t bytes = 0;
    for (int i = first; i < last; ++i) bytes += span(i, a0);
    mbar_expect(&full[stage], bytes);
    for (int i = first; i < last; ++i) {
      const uint32_t len = span(i, a0);
      bulk_load(ring + (stage * per_stage + i - first) * slot_floats,
                reinterpret_cast<const void*>(a0), len, &full[stage]);
    }
  };

  int uses = 0;   // stages this block has filled: which ring stage and parity are next
  for (int pass = 0; pass < slots; pass += T * kBwdSlots) {
    int off[kBwdSlots], ty[kBwdSlots], tz[kBwdSlots];
    float acc[kBwdSlots];
#pragma unroll
    for (int j = 0; j < kBwdSlots; ++j) {
      const int s = pass + tid + j * T;
      const int cell = s / C, c = s - (s / C) * C;
      const int ny = cell / g, nz = cell - (cell / g) * g;
      const bool mine = s < slots;
      ty[j] = mine ? ny + kh : INT_MIN / 2;   // never within k of a digit
      tz[j] = mine ? nz + kh : INT_MIN / 2;
      off[j] = mine ? (ty[j] * k + tz[j]) * C + c : 0;
      acc[j] = 0.f;
    }
    for (int n0 = 0; n0 < N; n0 += T) {
      // This chunk's queries whose window meets the slab, in query order.
      const int n = n0 + tid;
      bool hit = false;
      int run_n = 0, yz = 0;
      if (n < N) {
        const int v = vb[n];
        const int di = slab - v / gg + kh;
        if (v >= 0 && v < G && static_cast<unsigned>(di) < static_cast<unsigned>(k)) {
          const int vy = (v / g) % g, vz = v % g;
          hit = true;
          run_n = n * stride_n + di * run;
          const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(gb + run_n) & 15) / 4;
          yz = vy | (vz << 8) | (lead << 16);
        }
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      __syncthreads();   // the previous chunk's list and ring are read
      if (lane == 0) warp_s[warp] = __popc(m);
      __syncthreads();
      int pos = 0, count = 0;
      for (int w = 0; w < T / kWarp; ++w) {
        const int h = warp_s[w];
        pos += w < warp ? h : 0;
        count += h;
      }
      if (hit) {
        const int p = pos + __popc(m & ((1u << lane) - 1u));
        run_s[p] = run_n;
        yz_s[p] = yz;
      }
      __syncthreads();

      const int n_stages = (count + per_stage - 1) / per_stage;
      if (tid == 0) {
        fence_proxy_async();
        for (int st = 0; st < n_stages && st < kBwdStages; ++st)
          fill(st * per_stage, min(count, (st + 1) * per_stage), (uses + st) % kBwdStages);
      }
      for (int st = 0; st < n_stages; ++st, ++uses) {
        const int stage = uses % kBwdStages;
        const int first = st * per_stage, last = min(count, first + per_stage);
        mbar_wait(&full[stage], (uses / kBwdStages) & 1);
        for (int i = first; i < last; ++i) {
          const int qyz = yz_s[i];
          const int vy = qyz & 0xff, vz = (qyz >> 8) & 0xff;
          const float* r = ring + (stage * per_stage + i - first) * slot_floats;
          const int base = (qyz >> 16) - (vy * k + vz) * C;
          // Adding 0.0f to a sum that started at +0.0f changes no bit, so a
          // slot outside the query's window keeps the ordered sum's value.
#pragma unroll
          for (int j = 0; j < kBwdSlots; ++j) {
            const bool in = static_cast<unsigned>(ty[j] - vy) < static_cast<unsigned>(k) &&
                            static_cast<unsigned>(tz[j] - vz) < static_cast<unsigned>(k);
            acc[j] += in ? r[base + off[j]] : 0.f;
          }
        }
        __syncthreads();   // the stage is read
        if (tid == 0 && st + kBwdStages < n_stages) {
          fence_proxy_async();
          const int next = st + kBwdStages;
          fill(next * per_stage, min(count, (next + 1) * per_stage), stage);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kBwdSlots; ++j) {
      const int s = pass + tid + j * T;
      if (s < slots) db[s] = acc[j];
    }
  }
}

bool bad_window(int g, int k, int C) {
  return g < 1 || k < 1 || (k % 2) == 0 || k > 2 * g + 1 || C < 1;
}

}  // namespace

extern "C" {

// Shared memory bytes the patch-only gather takes: the (G, C) volume and
// the window's offset tables.
size_t dpdist_table_gather_smem(int g, int k, int C) {
  return 4 * dpdist::patch_rows_smem_floats(g, k, C);
}

// All three launch on `stream` and return cudaGetLastError() after the launch (0
// on success) or cudaErrorInvalidValue for sizes the kernels do not take. The
// two forward kernels write float32, or bfloat16 where out_bf16 is set.
int dpdist_table_gather_x(const float* fv, const float* queries, const float* centers, void* x,
                          int* vox, int B, int N, int g, int k, int C, int out_bf16, int device,
                          void* stream) {
  if (B < 1 || N < 1 || bad_window(g, k, C)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_sm = 0, max_smem = 0, sm_smem = 0;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device)) ||
      (err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) ||
      (err = cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                    device)))
    return static_cast<int>(err);
  const XPlan plan = plan_x(B, N, g, k, C, out_bf16 ? 2 : 4,
                            reinterpret_cast<uintptr_t>(fv) % 16 == 0,
                            reinterpret_cast<uintptr_t>(x) % 16 == 0, n_sm, max_smem);
  if (plan.smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  // Persistent blocks: as many as fit on the card at once, or one per item.
  const int per_sm =
      std::max(1, std::min(2048 / kXThreads, sm_smem / static_cast<int>(plan.smem + 1024)));
  const int grid = std::min(plan.n_items, n_sm * per_sm);
  const auto s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel, auto* out) {
    const cudaError_t e = set_smem(kernel, plan.smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kXThreads, plan.smem, s>>>(fv, queries, centers, out, vox, N, g, k, C, plan);
    return cudaGetLastError();
  };
  using bf16 = __nv_bfloat16;
  const bool by4 = C % 4 == 0;
  if (out_bf16)
    err = by4 ? launch(table_gather_x_kernel<bf16, 4, 10>, static_cast<bf16*>(x))
              : launch(table_gather_x_kernel<bf16, 1, 10>, static_cast<bf16*>(x));
  else
    err = by4 ? launch(table_gather_x_kernel<float, 4, 5>, static_cast<float*>(x))
              : launch(table_gather_x_kernel<float, 1, 5>, static_cast<float*>(x));
  return static_cast<int>(err);
}

int dpdist_table_gather(const float* fv, const int* vox, void* out, int B, int N, int g, int k,
                        int C, int rows_per_block, int threads, int out_bf16, int device,
                        void* stream) {
  if (B < 1 || N < 1 || bad_window(g, k, C) || rows_per_block < 1 || threads < kWarp ||
      threads > 1024 || threads % kWarp != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = dpdist_table_gather_smem(g, k, C);
  const dim3 grid(B, (N + rows_per_block - 1) / rows_per_block);
  const auto s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    err = set_smem(table_gather_kernel<__nv_bfloat16>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    table_gather_kernel<<<grid, threads, smem, s>>>(
        fv, vox, static_cast<__nv_bfloat16*>(out), N, g, k, C, rows_per_block);
  } else {
    err = set_smem(table_gather_kernel<float>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    table_gather_kernel<<<grid, threads, smem, s>>>(
        fv, vox, static_cast<float*>(out), N, g, k, C, rows_per_block);
  }
  return static_cast<int>(cudaGetLastError());
}

int dpdist_table_gather_bwd(const int* vox, const float* grad, int64_t stride_b, int64_t stride_n,
                            float* dfv, int B, int N, int g, int k, int C, int device,
                            void* stream) {
  // A cloud's grad rows are addressed with 32-bit offsets; digits fit a byte.
  if (B < 1 || N < 1 || bad_window(g, k, C) || g > 255 || stride_n < 0 ||
      (N - 1) * stride_n + static_cast<int64_t>(k) * k * k * C > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slots = g * g * C;
  const int per_thread = (slots + kBwdSlots - 1) / kBwdSlots;
  const int threads = std::min(kBwdMaxThreads, (per_thread + kWarp - 1) / kWarp * kWarp);
  // A run's 16-byte-aligned span: k^2 * C floats and up to 3 before them.
  const int slot_floats = (k * k * C + 3 + 3) / 4 * 4;
  const size_t fixed = kBwdStages * sizeof(uint64_t) + (2 * threads + threads / kWarp) * sizeof(int);
  const size_t stage_run = static_cast<size_t>(kBwdStages) * slot_floats * sizeof(float);
  const int per_stage =
      static_cast<int>(std::min<size_t>(kBwdMaxPerStage, (max_smem - fixed) / stage_run));
  if (per_stage < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = per_stage * stage_run + fixed;
  err = set_smem(table_gather_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  table_gather_bwd_kernel<<<dim3(B, g), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      vox, grad, stride_b, static_cast<int>(stride_n), dfv, N, g, k, C, per_stage, slot_floats);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
