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
//   0.05 ms at 3.35 TB/s; 10.5 MB of volumes in). The design, the
//   persistent gather of row_groups.cuh (which table_gather below,
//   gather_fused.cu and mfv_gather.cu share), keeps the copy engine
//   writing while the threads build rows, and the volume loads off the
//   threads' path:
//   - one persistent block per SM walks work items (a cloud's run of at
//     most 128 rows); each item's volume arrives by one bulk copy
//     (cp.async.bulk, completion on an mbarrier), and the next item's
//     volume loads into a second buffer while this item's rows are built;
//   - rows are built in shared memory in groups of R rows whose span in x
//     starts on a 16-byte boundary and is a multiple of 16 bytes,
//     R = 16 / gcd(W * bytes, 16) (4 float32 rows of 2,503, or 8 two-byte
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
// N > 128 queries, where its VMEM budget forces that split; dense
// evaluation gathers through it too. Off-grid queries carry vox = 0 and
// read cell 0's patch, as the reference does; the model's mask zeroes them
// later. A vox outside [0, V) (never made by voxel_assign) gives a zero
// row. A pure copy: it equals the plain gather_patches(extract_patches(fv),
// vox) exactly.
//   What bounds it on an H100: device memory, the rows it writes (655 MB of
//   float32 at B = 256, N = 256, k = 5, C = 20: about 0.2 ms at 3.35 TB/s;
//   half that in bfloat16 or float16). The design is table_gather_x's persistent
//   gather on the rows of given cells (CellRows: no delta, kLead = 0), the
//   design row 10 (gather_fused.cu) runs on masked rows: one block per SM
//   walks runs of at most 128 of a cloud's rows, each run's volume arriving
//   by one bulk copy into a second buffer while the last run is written, so
//   that a cloud's 40 KB volume is read from device memory once a run, not
//   once a tile of 32 queries; rows leave in groups of up to 40 KB (4
//   float32 rows of 10,000 B or 8 two-byte rows of 5,000 B) by bulk stores
//   from a double buffer, and a thread builds chunks of 4 elements of one
//   neighbour cell with one window test and one 16-byte shared load a chunk
//   (chunks of 1 where C is not a multiple of 4), a two-byte chunk leaving
//   by one 8-byte store. A run's head or tail off a group boundary
//   (two-byte rows start 16-byte aligned only at even rows) goes by
//   per-thread stores. What holds it on the card is, as for rows 2 and 10,
//   the rate at which the threads build groups and the bulk stores drain
//   them (PERF.md).
//   Limits: N <= 2^31 - 129 queries a cloud and B * ceil(N / L) <= 2^30 - 1
//   runs of L <= 128 rows (row_groups.cuh: kMaxCloudRows, kMaxItems), far
//   past 2,097,152 queries a cloud (a 128^3 field); row offsets are int64.
//
// Both forward kernels write float32 or, for the bf16 and fp16 paths,
// bfloat16 or float16: each value of x (the patch and delta) is the
// float32 value rounded once to nearest even (__float2bfloat16_rn,
// __float2half_rn: past float16's 65,504 to inf, subnormals kept), as the
// reference's .astype(dtype) on its table and on delta
// (table_gather_pallas.py:84, :119). A two-byte row is a two-byte row:
// float16 takes bfloat16's groups of 8 rows, its chunk stores and its
// handling of a run's odd head and tail. Forward only.
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
// The adjoint takes a float32, bfloat16 or float16 grad and writes dfv in
// the same type, as the reference's table_gather_bwd(dtype=) does
// (table_gather_pallas.py:159-256). The kernel above is instantiated for
// float32. A two-byte grad halves the bytes, and at half the bytes the
// kernel above was bound by its issue slots (about 9 a slot and query, a
// slot being one channel, 61 % of them adds of 0 outside the window) and
// its exposed prologue, not by memory: table_gather_bwd_b16_kernel is its
// own design, instantiated for bfloat16 and for float16. Persistent blocks
// walk (cloud, slab) items; a producer warp lists the next items' queries
// and keeps their runs in flight by bulk copies while consumer warps sum;
// a consumer thread owns 10 channels of one cell, tests the window once a
// query for all ten and reads them as pairs in 32-bit words (51
// instructions a query for the ten in its
// window, against about 90 for the kernel above's 5 slots x 9 and its
// adds of 0; a warp whose cells all miss the window skips the query). It
// sums in float32 registers in query order, as the float32 kernel does,
// and rounds each dfv value once to nearest even. The two types differ in
// the unpack alone: a bf16 is the top half of its float32 (a shift), a
// float16 takes a conversion (__half22float2, exact).
//   What bounds it on an H100: device memory, the in-grid two-byte grad
// entries (about 75 MB at B = 256, N = 64: 0.024 ms at 3.35 TB/s). What
// holds it on the card is its pipeline, not memory nor the sums: without
// any grad byte moved and without the sums, the producer warp's listing,
// copy issue and stage hand-offs take about 60 % of its time
// (scripts/torch_bwd_bf16_ablations.py, PERF.md).
//
// Plain C interface for ctypes; no PyTorch headers. Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <string.h>

#include <algorithm>
#include <type_traits>

#include "patch_rows.cuh"
#include "row_groups.cuh"

namespace {

using dpdist::bulk_load;
using dpdist::fence_proxy_async;
using dpdist::kWarp;
using dpdist::mbar_expect;
using dpdist::mbar_init;
using dpdist::mbar_wait;
using dpdist::set_smem;

// --- table_gather_x (row 2): the persistent gather of row_groups.cuh on
// decoder-input rows of queries.

constexpr int kXThreads = 512;   // threads of a block

// CW: elements per chunk (4 where C is a multiple of 4, else 1); J: chunks
// per thread per pass, so that 512 * J * CW covers a float32 group of 4
// rows or a two-byte group of 8 at W = 2,503.
template <typename T, int CW, int J>
__global__ void __launch_bounds__(kXThreads, 1)
    table_gather_x_kernel(const float* __restrict__ fv,       // (B, G, C)
                          const float* __restrict__ queries,  // (B, N, 3)
                          const float* __restrict__ centers,  // (G, 3)
                          T* __restrict__ x,                  // (B, N, W)
                          int* __restrict__ vox_out,          // (B, N)
                          int N, int g, int k, int C, const dpdist::XPlan plan) {
  dpdist::gather_rows<kXThreads, T, CW, J>(fv, x, N, g, k, C, 3 + k * k * k * C, plan,
                                           dpdist::QueryRows{queries, centers, vox_out, g, C});
}

// --- table_gather (row 6): the same persistent gather on the patch rows of
// given voxels.

// The patch row of each given voxel; a vox outside [0, G) gives a zero row.
struct CellRows {
  static constexpr int kLead = 0;
  const int* vox;   // (rows,)
  int g, C;

  __device__ __forceinline__ dpdist::XRow operator()(int64_t r) const {
    const int v = vox[r];
    return v >= 0 && v < g * g * g ? dpdist::cell_row(v, g, C) : dpdist::zero_row();
  }
};

// CW and J as table_gather_x_kernel's: 512 * J * CW covers a float32 group
// of 4 rows or a two-byte group of 8 at k^3*C = 2,500.
template <typename T, int CW, int J>
__global__ void __launch_bounds__(kXThreads, 1)
    table_gather_rows_kernel(const float* __restrict__ fv,   // (B, G, C)
                             const int* __restrict__ vox,    // (B, N)
                             T* __restrict__ out,            // (B, N, k^3*C)
                             int N, int g, int k, int C, const dpdist::XPlan plan) {
  dpdist::gather_rows<kXThreads, T, CW, J>(fv, out, N, g, k, C, k * k * k * C, plan,
                                           CellRows{vox, g, C});
}

// --- table_gather_bwd (rows 3, 4, 5)

constexpr int kBwdSlots = 5;         // dfv slots a thread owns in one pass
constexpr int kBwdMaxThreads = 256;  // 256 * 5 = 1,280 = a slab's slots at g = 8, C = 20
constexpr int kBwdStages = 4;        // stages of the ring of grad runs
constexpr int kBwdMaxPerStage = 8;   // queries' runs per stage

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Block (b, slab): dfv[b, slab * g^2 + cell, c] for the slab's g^2 cells.
// Slot s = cell * C + c; a thread owns slots tid + j * blockDim.x. For a
// query in voxel (vx, vy, vz) whose window meets the slab at di = slab -
// vx + k/2, slot (ny, nz, c) takes element (dj * k + dl) * C + c of the
// query's run grad[n, di * k^2 * C ..][0 .. k^2 * C), with dj = ny - vy +
// k/2, dl = nz - vz + k/2 when both lie in [0, k). The listed queries' runs
// stream through a ring of kBwdStages stages of `per_stage` runs in shared
// memory, each run brought by one bulk copy of its 16-byte-aligned span
// (`slot` elements of TG a run: k^2 * C and up to 16 bytes before it,
// rounded up to 16 bytes), a stage complete on its mbarrier; one barrier
// per stage frees it for the stage kBwdStages on. TG is the grad's type
// and TO dfv's; the sums are float32. It is instantiated on float only (a
// two-byte grad takes table_gather_bwd_b16_kernel below); the template
// stays as written so that the float32 kernel is unchanged. Off is the
// type of a run's offset within its cloud's grad rows: int, or int64_t for
// a cloud past 2^31 - 1 elements (the C entry picks it from the sizes, so
// that other clouds keep 32-bit offsets and their list's shared memory).
template <typename TG, typename TO, typename Off>
__global__ void __launch_bounds__(kBwdMaxThreads)
    table_gather_bwd_kernel(const int* __restrict__ vox,     // (B, N)
                            const TG* __restrict__ grad,     // (B, N, k^3*C), strided
                            int64_t stride_b, Off stride_n,
                            TO* __restrict__ dfv,            // (B, G, C)
                            int N, int g, int k, int C, int per_stage, int slot) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int T = blockDim.x;
  TG* ring = reinterpret_cast<TG*>(smem);   // kBwdStages * per_stage * slot
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kBwdStages * per_stage * slot);
  Off* run_s = reinterpret_cast<Off*>(full + kBwdStages);   // T: a listed query's run, from gb
  int* yz_s = reinterpret_cast<int*>(run_s + T);            // T: vy | vz << 8 | lead << 16
  int* warp_s = yz_s + T;                                   // T / 32: hits per warp
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int b = blockIdx.x, slab = blockIdx.y;
  const int gg = g * g, G = gg * g, kh = k / 2, run = k * k * C, slots = gg * C;
  const TG* gb = grad + b * stride_b;
  const int* vb = vox + static_cast<size_t>(b) * N;
  TO* db = dfv + (static_cast<size_t>(b) * G + static_cast<size_t>(slab) * gg) * C;

  if (tid == 0) {
    for (int s = 0; s < kBwdStages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // One thread: the runs of list entries [first, last) into ring stage
  // `stage`, each as its 16-byte-aligned span.
  auto span = [&](int i, uintptr_t& a0) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(gb + run_s[i]);
    a0 = a & ~uintptr_t{15};
    return static_cast<uint32_t>(((a + sizeof(TG) * run + 15) & ~uintptr_t{15}) - a0);
  };
  auto fill = [&](int first, int last, int stage) {
    uintptr_t a0;
    uint32_t bytes = 0;
    for (int i = first; i < last; ++i) bytes += span(i, a0);
    mbar_expect(&full[stage], bytes);
    for (int i = first; i < last; ++i) {
      const uint32_t len = span(i, a0);
      bulk_load(ring + (stage * per_stage + i - first) * slot,
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
      Off run_n = 0;
      int yz = 0;
      if (n < N) {
        const int v = vb[n];
        const int di = slab - v / gg + kh;
        if (v >= 0 && v < G && static_cast<unsigned>(di) < static_cast<unsigned>(k)) {
          const int vy = (v / g) % g, vz = v % g;
          hit = true;
          run_n = static_cast<Off>(n) * stride_n + di * run;
          const int lead = static_cast<int>((reinterpret_cast<uintptr_t>(gb + run_n) & 15) /
                                            sizeof(TG));
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
          const TG* r = ring + (stage * per_stage + i - first) * slot;
          const int base = (qyz >> 16) - (vy * k + vz) * C;
          // Adding 0.0f to a sum that started at +0.0f changes no bit, so a
          // slot outside the query's window keeps the ordered sum's value.
#pragma unroll
          for (int j = 0; j < kBwdSlots; ++j) {
            const bool in = static_cast<unsigned>(ty[j] - vy) < static_cast<unsigned>(k) &&
                            static_cast<unsigned>(tz[j] - vz) < static_cast<unsigned>(k);
            acc[j] += in ? to_float(r[base + off[j]]) : 0.f;
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
      if (s < slots) dpdist::store_out(db + s, acc[j]);
    }
  }
}

// --- table_gather_bwd on a two-byte grad (row 3 in bf16 and in fp16)

constexpr int kB16Group = 10;        // channels an owner sums: 5 words of pairs
constexpr int kB16Stages = 4;        // stages of the ring of grad runs
constexpr int kB16MaxRuns = 8;       // runs a stage
constexpr int kB16MaxConsumerWarps = 8;
constexpr int kB16VoxChunk = 128;    // queries' vox a producer chunk (4 a lane)
constexpr int kB16VoxDepth = 4;      // vox chunks in flight
constexpr int kB16BlocksPerSm = 4;
// A run's slot in the ring: its 16-byte-aligned span (k^2 * C elements and
// up to 7 before and after) and the kB16Group + 2 elements an owner's last
// word pair may read past its channels, in whole 16-byte groups.
__host__ __device__ constexpr int b16_slot(int run) { return (run + 14 + kB16Group + 2 + 7) / 8 * 8; }

// Shared memory with `runs` runs a stage: the ring of slots first, then
// byte offsets of the barriers, the runs' (vy | vz << 16, lead - (vy * k +
// vz) * C), the stages' headers, the vox chunks, and the total.
struct B16Layout {
  int runs, slot;   // runs a stage; elements a run's slot
  size_t bars, meta, header, vox, bytes;
};

__host__ __device__ inline B16Layout b16_layout(int run, int runs) {
  B16Layout l;
  l.runs = runs;
  l.slot = b16_slot(run);
  l.bars = static_cast<size_t>(kB16Stages) * runs * l.slot * 2;     // full, then empty
  l.meta = l.bars + 2 * kB16Stages * sizeof(uint64_t);              // int2 a run
  l.header = l.meta + static_cast<size_t>(kB16Stages) * runs * sizeof(int2);
  l.vox = l.header + kB16Stages * sizeof(int);
  l.bytes = l.vox + kB16VoxDepth * kB16VoxChunk * sizeof(int);
  return l;
}

__device__ __forceinline__ void mbar_init_count(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(dpdist::smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(dpdist::smem_u32(bar)) : "memory");
}

// Raises the bytes the barrier's current phase waits for, without arriving.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::"r"(
                   dpdist::smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dpdist::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// The two elements of a 32-bit word of pairs, the first in the low half, in
// float32 (exactly).
__device__ __forceinline__ float2 unpack_pair(uint32_t pair, const __nv_bfloat16*) {
  return make_float2(__uint_as_float(pair << 16), __uint_as_float(pair & 0xffff0000u));
}
__device__ __forceinline__ float2 unpack_pair(uint32_t pair, const __half*) {
  __half2 h;
  memcpy(&h, &pair, sizeof h);
  return __half22float2(h);
}

// The adjoint on a two-byte grad (T: __nv_bfloat16 or __half), redesigned
// for two bytes. A work item is
// (cloud b, slab, part): the slab's owners, an owner being kB16Group
// channels of one cell (owner = cell * Q + j, Q = ceil(C / kB16Group)),
// part p the owners [p * Tc, (p + 1) * Tc) for Tc consumer threads. Each
// block takes a contiguous range of items, so that a cloud's slabs follow
// each other and its vox comes from L1.
// - Warp 0 produces: it walks its items' queries in chunks of
//   kB16VoxChunk, their vox arriving by cp.async kB16VoxDepth chunks ahead,
//   lists the queries whose window meets the item's slab in query order
//   (a ballot), and brings each listed query's run (k^2 * C elements, its
//   16-byte-aligned span) into the ring by one bulk copy issued by the lane
//   that found it, with the query's (vy, vz) and the run's lead beside it.
//   A stage holds up to `runs` runs of one item; it is closed (its header:
//   count, last of its item) by one arrive on its full barrier, the
//   lanes having raised its expected bytes before their copies.
// - Warps 1.. consume: each thread owns one owner of the item and keeps its
//   kB16Group float32 sums in registers. For each listed query of a stage,
//   in order, one window test and one address for the owner's channels,
//   then its channels read as 32-bit words from shared memory, realigned
//   by one funnel shift where the run's element sits at an odd position,
//   and unpacked exactly (unpack_pair). A stage is released by one arrive a
//   warp on its empty barrier; after its item's last stage each owner
//   rounds its sums once to T and stores.
// Each dfv value is then the float32 sum over the queries that reach it,
// in query order, from +0.0f (a query whose window misses an owner's cell
// adds nothing, and +0.0f added changes no bit of such a sum), rounded
// once: bit for bit table_gather_bwd_ordered, the same from run to run.
template <typename T, typename Off>
__global__ void __launch_bounds__(32 * (1 + kB16MaxConsumerWarps))
    table_gather_bwd_b16_kernel(const int* __restrict__ vox,   // (B, N)
                                const T* __restrict__ grad,    // (B, N, k^3*C), strided
                                int64_t stride_b, Off stride_n,
                                T* __restrict__ dfv,           // (B, G, C)
                                int N, int g, int k, int C, int parts, int64_t n_items,
                                const B16Layout lay) {
  static_assert(sizeof(T) == 2, "a two-byte type");
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + kB16Stages;
  int2* meta = reinterpret_cast<int2*>(smem + lay.meta);
  int* header = reinterpret_cast<int*>(smem + lay.header);
  int* vring = reinterpret_cast<int*>(smem + lay.vox);
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int consumers = blockDim.x - kWarp;
  const int P = lay.runs, slot = lay.slot;
  const int gg = g * g, G = gg * g, kh = k / 2, run = k * k * C;
  const int Q = (C + kB16Group - 1) / kB16Group;
  const int64_t first = n_items * blockIdx.x / gridDim.x;
  const int64_t last = n_items * (blockIdx.x + 1) / gridDim.x;

  if (tid == 0) {
    for (int s = 0; s < kB16Stages; ++s) {
      mbar_init(&full[s]);
      mbar_init_count(&empty[s], consumers / kWarp);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // The producer. Vox chunks: item it's queries [n0, n0 + kB16VoxChunk),
    // issued by a cursor kB16VoxDepth chunks ahead of the one listed; each
    // lane copies and reads only its own elements.
    constexpr int U = kB16VoxChunk / kWarp;
    int64_t c_item = first;
    int c_n0 = 0;
    auto issue_vox = [&](int buf) {
      if (c_item < last) {
        const int* src = vox + (c_item / parts / g) * N;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int n = c_n0 + lane + u * kWarp;
          if (n < N) cp_async4(vring + buf * kB16VoxChunk + lane + u * kWarp, src + n);
        }
        c_n0 += kB16VoxChunk;
        if (c_n0 >= N) c_n0 = 0, ++c_item;
      }
      cp_async_commit();   // an empty group past the last item keeps the count
    };
    for (int d = 0; d < kB16VoxDepth; ++d) issue_vox(d);

    uint32_t uses = 0;   // stages acquired so far
    int stage = 0, fill = 0, buf = 0;
    bool held = false;   // the current stage is acquired
    auto acquire = [&] {
      if (held) return;
      if (uses >= static_cast<uint32_t>(kB16Stages))
        mbar_wait(&empty[stage], (uses / kB16Stages - 1) & 1);
      ++uses;
      held = true;
    };
    auto close = [&](bool last_of_item) {
      acquire();
      __syncwarp();
      if (lane == 0) {
        header[stage] = fill | (last_of_item ? INT_MIN : 0);
        __threadfence_block();
        mbar_arrive(&full[stage]);
      }
      __syncwarp();
      stage = (stage + 1) % kB16Stages;
      fill = 0;
      held = false;
    };

    for (int64_t item = first; item < last; ++item) {
      const int64_t bs = item / parts;
      const int slab = static_cast<int>(bs % g);
      const T* gb = grad + (bs / g) * stride_b;
      for (int n0 = 0; n0 < N; n0 += kB16VoxChunk) {
        cp_async_wait<kB16VoxDepth - 1>();
        int v[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          v[u] = n0 + lane + u * kWarp < N ? vring[buf * kB16VoxChunk + lane + u * kWarp] : -1;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int n = n0 + lane + u * kWarp;
          const int di = slab - v[u] / gg + kh;
          const bool hit = v[u] >= 0 && v[u] < G && static_cast<unsigned>(di) < static_cast<unsigned>(k);
          int2 mt = make_int2(0, 0);
          uintptr_t a0 = 0;
          uint32_t len = 0;
          if (hit) {
            const int vy = (v[u] / g) % g, vz = v[u] % g;
            const uintptr_t a = reinterpret_cast<uintptr_t>(
                gb + (static_cast<Off>(n) * stride_n + static_cast<Off>(di) * run));
            a0 = a & ~uintptr_t{15};
            len = static_cast<uint32_t>(((a + 2 * static_cast<uintptr_t>(run) + 15) &
                                         ~uintptr_t{15}) - a0);
            mt = make_int2(vy | (vz << 16), static_cast<int>((a & 15) / 2) - (vy * k + vz) * C);
          }
          unsigned m = __ballot_sync(0xffffffffu, hit);
          while (m) {
            acquire();
            const int room = P - fill;
            const int rank = __popc(m & ((1u << lane) - 1u));
            const bool go = ((m >> lane) & 1u) && rank < room;
            if (go) {
              const int i = stage * P + fill + rank;
              meta[i] = mt;
              mbar_expect_tx(&full[stage], len);
              dpdist::bulk_load(ring + static_cast<size_t>(i) * slot,
                                reinterpret_cast<const void*>(a0), len, &full[stage]);
            }
            fill += min(__popc(m), room);
            m &= ~__ballot_sync(0xffffffffu, go);
            if (fill == P) close(false);
          }
        }
        // This chunk's vox are used (the ballots above): refill its buffer.
        issue_vox(buf);
        buf = (buf + 1) % kB16VoxDepth;
      }
      close(true);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // The consumers: owner ctid of each item's part.
  const int ctid = tid - kWarp;
  uint32_t uses = 0;
  for (int64_t item = first; item < last; ++item) {
    const int64_t bs = item / parts;
    const int part = static_cast<int>(item - bs * parts);
    const int slab = static_cast<int>(bs % g);
    const int own = part * consumers + ctid;   // < parts * consumers <= 2^31 - 1 (the C entry)
    const int cell = own / Q, j = own - cell * Q;
    const bool mine = cell < gg;
    const int ty = mine ? cell / g + kh : INT_MIN / 2;   // never within k of a digit
    const int tz = mine ? cell % g + kh : INT_MIN / 2;
    const int off = mine ? (ty * k + tz) * C + j * kB16Group : 0;
    float acc[kB16Group];
#pragma unroll
    for (int i = 0; i < kB16Group; ++i) acc[i] = 0.f;
    bool last_of_item = false;
    while (!last_of_item) {
      const int stage = uses % kB16Stages;
      mbar_wait(&full[stage], (uses / kB16Stages) & 1);
      const int h = header[stage];
      last_of_item = h < 0;
      const int count = h & 0xffff;
      const int2* mts = meta + stage * P;
      const uint32_t* runs =
          reinterpret_cast<const uint32_t*>(ring + static_cast<size_t>(stage) * P * slot);
      for (int i = 0; i < count; ++i) {
        const int2 mt = mts[i];
        const int dj = ty - (mt.x & 0xffff), dl = tz - (mt.x >> 16);
        if (static_cast<unsigned>(dj) < static_cast<unsigned>(k) &&
            static_cast<unsigned>(dl) < static_cast<unsigned>(k)) {
          // Element p of the run's slot is this owner's first channel.
          const int p = mt.y + off;
          const uint32_t* w = runs + i * (slot / 2) + (p >> 1);
          const uint32_t sh = (p & 1) * 16;
          uint32_t word[kB16Group / 2 + 1];
#pragma unroll
          for (int m = 0; m <= kB16Group / 2; ++m) word[m] = w[m];
#pragma unroll
          for (int m = 0; m < kB16Group / 2; ++m) {
            const float2 pair = unpack_pair(__funnelshift_r(word[m], word[m + 1], sh), ring);
            acc[2 * m] += pair.x;
            acc[2 * m + 1] += pair.y;
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      ++uses;
    }
    if (mine) {
      const int c0 = j * kB16Group;
      T* out = dfv + ((bs / g) * G + static_cast<int64_t>(slab) * gg + cell) * C + c0;
#pragma unroll
      for (int i = 0; i < kB16Group; ++i)
        if (c0 + i < C) dpdist::store_out(out + i, acc[i]);
    }
  }
}

bool bad_window(int g, int k, int C) {
  return g < 1 || k < 1 || (k % 2) == 0 || k > 2 * g + 1 || C < 1;
}

// The two-byte adjoint's launch: consumer warps for a slab's owners (at most
// kB16MaxConsumerWarps; parts split the rest), the most runs a stage that
// fit the block's shared memory (at most kB16MaxRuns), up to
// kB16BlocksPerSm persistent blocks an SM, no more blocks than items.
struct B16Plan {
  int threads, parts, grid;
  int64_t n_items;
  B16Layout lay;
};

cudaError_t b16_plan(int B, int g, int k, int C, int device, B16Plan* plan) {
  const int64_t run = static_cast<int64_t>(k) * k * C;
  const int64_t owners = static_cast<int64_t>(g) * g * ((C + kB16Group - 1) / kB16Group);
  const int cw = static_cast<int>(std::min<int64_t>(kB16MaxConsumerWarps, (owners + 31) / 32));
  const int64_t parts = (owners + 32 * cw - 1) / (32 * cw);
  if (run > (1 << 24) || parts * 32 * cw > INT_MAX) return cudaErrorInvalidValue;
  int max_smem = 0, sm_smem = 0, n_sm = 0;
  cudaError_t err;
  if ((err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) ||
      (err = cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                    device)) ||
      (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device)))
    return err;
  int runs = kB16MaxRuns;
  while (runs > 0 && b16_layout(static_cast<int>(run), runs).bytes > static_cast<size_t>(max_smem))
    --runs;
  if (runs < 1) return cudaErrorInvalidValue;
  plan->lay = b16_layout(static_cast<int>(run), runs);
  plan->threads = 32 * (1 + cw);
  plan->parts = static_cast<int>(parts);
  plan->n_items = static_cast<int64_t>(B) * g * parts;
  const int per_sm = std::max(
      1, std::min({kB16BlocksPerSm, sm_smem / static_cast<int>(plan->lay.bytes + 1024),
                   2048 / plan->threads}));
  plan->grid = static_cast<int>(std::min<int64_t>(plan->n_items, static_cast<int64_t>(n_sm) * per_sm));
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Shared memory bytes of the smallest layout of the persistent gathers
// (rows 2, 6 and 10) for a (g^3, C) volume, whatever the window: where it
// does not fit a block, their C entries refuse the launch
// (kernels/table_gather.py:gather_smem mirrors it).
size_t dpdist_table_gather_smem(int g, int k, int C) {
  (void)k;
  return dpdist::min_rows_smem(g * g * g, C);
}

// All three launch on `stream` and return cudaGetLastError() after the launch (0
// on success) or cudaErrorInvalidValue for sizes or types the kernels do not
// take. The two forward kernels write the type of out_type (dpdist::OutType:
// float32, bfloat16 or float16); the adjoint reads a grad and writes dfv of
// the type of grad_type.
int dpdist_table_gather_x(const float* fv, const float* queries, const float* centers, void* x,
                          int* vox, int B, int N, int g, int k, int C, int out_type, int device,
                          void* stream) {
  const int out_bytes = dpdist::out_bytes(out_type);
  if (B < 1 || N < 1 || bad_window(g, k, C) || out_bytes == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dpdist::XLaunch l;
  cudaError_t err = dpdist::plan_launch(B, N, g * g * g, C, 3 + k * k * k * C, out_bytes, 0,
                                        fv, x, kXThreads, device, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel, auto* out) {
    const cudaError_t e = set_smem(kernel, l.plan.smem);
    if (e != cudaSuccess) return e;
    kernel<<<l.grid, kXThreads, l.plan.smem, s>>>(fv, queries, centers, out, vox, N, g, k, C,
                                                  l.plan);
    return cudaGetLastError();
  };
  const bool by4 = C % 4 == 0;
  err = dpdist::with_out_type(out_type, [&](auto* type) {
    using T = std::remove_pointer_t<decltype(type)>;
    constexpr int J = sizeof(T) == 2 ? 10 : 5;
    return by4 ? launch(table_gather_x_kernel<T, 4, J>, static_cast<T*>(x))
               : launch(table_gather_x_kernel<T, 1, J>, static_cast<T*>(x));
  });
  return static_cast<int>(err);
}

// Row 6: any N up to dpdist::kMaxCloudRows (2^31 - 129) queries a cloud and
// B * ceil(N / L) up to dpdist::kMaxItems (2^30 - 1) runs; a volume whose
// smallest layout does not fit a block is refused (plan.smem == 0).
int dpdist_table_gather(const float* fv, const int* vox, void* out, int B, int N, int g, int k,
                        int C, int out_type, int device, void* stream) {
  const int out_bytes = dpdist::out_bytes(out_type);
  if (B < 1 || N < 1 || N > dpdist::kMaxCloudRows || bad_window(g, k, C) || out_bytes == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dpdist::XLaunch l;
  cudaError_t err = dpdist::plan_launch(B, N, g * g * g, C, k * k * k * C, out_bytes,
                                        dpdist::kGroupBytes, fv, out, kXThreads, device, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel, auto* o) {
    const cudaError_t e = set_smem(kernel, l.plan.smem);
    if (e != cudaSuccess) return e;
    kernel<<<l.grid, kXThreads, l.plan.smem, s>>>(fv, vox, o, N, g, k, C, l.plan);
    return cudaGetLastError();
  };
  const bool by4 = C % 4 == 0;
  err = dpdist::with_out_type(out_type, [&](auto* type) {
    using T = std::remove_pointer_t<decltype(type)>;
    constexpr int J = sizeof(T) == 2 ? 10 : 5;
    return by4 ? launch(table_gather_rows_kernel<T, 4, J>, static_cast<T*>(out))
               : launch(table_gather_rows_kernel<T, 1, J>, static_cast<T*>(out));
  });
  return static_cast<int>(err);
}

int dpdist_table_gather_bwd(const int* vox, const void* grad, int64_t stride_b, int64_t stride_n,
                            void* dfv, int B, int N, int g, int k, int C, int grad_type,
                            int device, void* stream) {
  // Digits fit a byte. Strides count elements of the grad's type. A cloud's
  // grad rows past 2^31 - 1 elements take 64-bit run offsets (fault 5).
  if (B < 1 || N < 1 || bad_window(g, k, C) || g > 255 || stride_n < 0 ||
      dpdist::out_bytes(grad_type) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = (N - 1) * stride_n + static_cast<int64_t>(k) * k * k * C > INT_MAX;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grad_type != dpdist::kOutF32) {
    B16Plan plan;
    err = b16_plan(B, g, k, C, device, &plan);
    if (err != cudaSuccess) return static_cast<int>(err);
    auto launch = [&](auto* type) {
      using T = std::remove_pointer_t<decltype(type)>;
      auto go = [&](auto kernel, auto off) {
        const cudaError_t e = set_smem(kernel, plan.lay.bytes);
        if (e != cudaSuccess) return e;
        kernel<<<plan.grid, plan.threads, plan.lay.bytes, static_cast<cudaStream_t>(stream)>>>(
            vox, static_cast<const T*>(grad), stride_b, static_cast<decltype(off)>(stride_n),
            static_cast<T*>(dfv), N, g, k, C, plan.parts, plan.n_items, plan.lay);
        return cudaGetLastError();
      };
      return wide ? go(table_gather_bwd_b16_kernel<T, int64_t>, int64_t{0})
                  : go(table_gather_bwd_b16_kernel<T, int>, 0);
    };
    err = grad_type == dpdist::kOutBf16 ? launch(static_cast<__nv_bfloat16*>(nullptr))
                                        : launch(static_cast<__half*>(nullptr));
    return static_cast<int>(err);
  }
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slots = g * g * C;
  const int per_thread = (slots + kBwdSlots - 1) / kBwdSlots;
  const int threads = std::min(kBwdMaxThreads, (per_thread + kWarp - 1) / kWarp * kWarp);
  // The float32 kernel. A run's 16-byte-aligned span: k^2 * C elements and
  // up to one 16-byte group's worth before them.
  const int bytes = sizeof(float), per16 = 16 / bytes;
  const int slot = (k * k * C + 2 * (per16 - 1)) / per16 * per16;
  const size_t off_bytes = wide ? sizeof(int64_t) : sizeof(int);
  const size_t fixed = kBwdStages * sizeof(uint64_t) + threads * (off_bytes + sizeof(int)) +
                       threads / kWarp * sizeof(int);
  const size_t stage_run = static_cast<size_t>(kBwdStages) * slot * bytes;
  const int per_stage =
      static_cast<int>(std::min<size_t>(kBwdMaxPerStage, (max_smem - fixed) / stage_run));
  if (per_stage < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = per_stage * stage_run + fixed;
  const dim3 grid(B, g);
  const auto s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel, auto* in, auto* out, auto off) {
    const cudaError_t e = set_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, threads, smem, s>>>(vox, in, stride_b, static_cast<decltype(off)>(stride_n),
                                       out, N, g, k, C, per_stage, slot);
    return cudaGetLastError();
  };
  const auto* gf = static_cast<const float*>(grad);
  auto* df = static_cast<float*>(dfv);
  err = wide ? launch(table_gather_bwd_kernel<float, float, int64_t>, gf, df, int64_t{0})
             : launch(table_gather_bwd_kernel<float, float, int>, gf, df, 0);
  return static_cast<int>(err);
}

// The two-byte adjoint's launch (bfloat16 and float16 alike) for B clouds on
// `device`: out = {consumer
// threads a block, parts a slab, runs a stage, shared memory bytes, blocks,
// work items}. Returns 0, or cudaErrorInvalidValue for sizes it does not
// take (kernels/table_gather.py:bwd_bf16_plan mirrors it).
int dpdist_table_gather_bwd_bf16_plan(int B, int g, int k, int C, int device, int64_t* out) {
  if (B < 1 || bad_window(g, k, C) || g > 255) return static_cast<int>(cudaErrorInvalidValue);
  B16Plan plan;
  const cudaError_t err = b16_plan(B, g, k, C, device, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t v[6] = {plan.threads - kWarp, plan.parts, plan.lay.runs,
                        static_cast<int64_t>(plan.lay.bytes), plan.grid, plan.n_items};
  std::copy(v, v + 6, out);
  return 0;
}

}  // extern "C"
