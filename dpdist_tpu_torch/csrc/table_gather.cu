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
//   persistent gather of row_groups.cuh (which gather_fused.cu and
//   mfv_gather.cu share), keeps the copy engine writing while the threads
//   build rows, and the volume loads off the threads' path:
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
// per row (patch_rows.cuh:gather_patch_rows).
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
// The adjoint takes a float32 or a bfloat16 grad and writes dfv in the same
// type, as the reference's table_gather_bwd(dtype=) does
// (table_gather_pallas.py:159-256): the bfloat16 variant reads the bf16 grad
// (half the bytes), sums each slot in float32 registers in query order as
// the float32 one does, and rounds each dfv value once to nearest even. One
// kernel, templated on the two types.
//
// Plain C interface for ctypes; no PyTorch headers. Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

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
// rows or a bfloat16 group of 8 at W = 2,503.
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

// --- table_gather (row 6)

template <typename T>
__global__ void table_gather_kernel(const float* __restrict__ fv,   // (B, G, C)
                                    const int* __restrict__ vox,    // (B, N)
                                    T* __restrict__ out,            // (B, N, k^3*C)
                                    int N, int g, int k, int C, int rows_per_block) {
  dpdist::gather_patch_rows(fv, vox, out, N, g, k, C, rows_per_block);
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
// and TO dfv's (float or __nv_bfloat16); the sums are float32. Off is the
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
// two forward kernels write float32, or bfloat16 where out_bf16 is set; the
// adjoint reads a bfloat16 grad and writes a bfloat16 dfv where bf16 is set.
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
  const dpdist::XPlan plan = dpdist::plan_rows(
      B, N, g * g * g, C, 3 + k * k * k * C, out_bf16 ? 2 : 4, 0,
      reinterpret_cast<uintptr_t>(fv) % 16 == 0, reinterpret_cast<uintptr_t>(x) % 16 == 0, n_sm,
      max_smem);
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
      threads > 1024 || threads % kWarp != 0 || N > INT_MAX - rows_per_block)
    return static_cast<int>(cudaErrorInvalidValue);
  // One block per (cloud, tile of queries) on a 1-D grid: past 65,535
  // tiles a cloud no longer fits the grid's y dimension
  // (patch_rows.cuh:gather_patch_rows).
  const int64_t blocks = static_cast<int64_t>(B) * ((N + rows_per_block - 1) / rows_per_block);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = dpdist_table_gather_smem(g, k, C);
  const dim3 grid(static_cast<unsigned>(blocks));
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

int dpdist_table_gather_bwd(const int* vox, const void* grad, int64_t stride_b, int64_t stride_n,
                            void* dfv, int B, int N, int g, int k, int C, int bf16, int device,
                            void* stream) {
  // Digits fit a byte. Strides count elements of the grad's type. A cloud's
  // grad rows past 2^31 - 1 elements take 64-bit run offsets (fault 5).
  if (B < 1 || N < 1 || bad_window(g, k, C) || g > 255 || stride_n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = (N - 1) * stride_n + static_cast<int64_t>(k) * k * k * C > INT_MAX;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slots = g * g * C;
  const int per_thread = (slots + kBwdSlots - 1) / kBwdSlots;
  const int threads = std::min(kBwdMaxThreads, (per_thread + kWarp - 1) / kWarp * kWarp);
  // A run's 16-byte-aligned span: k^2 * C elements and up to one 16-byte
  // group's worth before them.
  const int bytes = bf16 ? 2 : 4, per16 = 16 / bytes;
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
  using bf = __nv_bfloat16;
  const auto* gf = static_cast<const float*>(grad);
  const auto* gh = static_cast<const bf*>(grad);
  auto* df = static_cast<float*>(dfv);
  auto* dh = static_cast<bf*>(dfv);
  if (bf16)
    err = wide ? launch(table_gather_bwd_kernel<bf, bf, int64_t>, gh, dh, int64_t{0})
               : launch(table_gather_bwd_kernel<bf, bf, int>, gh, dh, 0);
  else
    err = wide ? launch(table_gather_bwd_kernel<float, float, int64_t>, gf, df, int64_t{0})
               : launch(table_gather_bwd_kernel<float, float, int>, gf, df, 0);
  return static_cast<int>(err);
}

}  // extern "C"
