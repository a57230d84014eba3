// Rows of patch elements built in shared memory from a (G, C) volume and
// sent to device memory by the copy engine: the machinery of the
// persistent gathers (table_gather.cu's table_gather_x, row 2, and
// table_gather, row 6; gather_fused.cu, row 10; mfv_gather.cu, row 1).
//
// - Bulk copies (cp.async.bulk): a volume into shared memory, completion on
//   an mbarrier; a group of rows out of shared memory, completion on a bulk
//   group of the issuing thread.
// - The chunk builder: a row's patch elements fall into chunks of CW
//   elements of one neighbour cell (CW = 4 where C is a multiple of 4, else
//   1); a thread builds whole chunks, with one window test and one 16-byte
//   shared load a chunk. Where a chunk lies and what it reads are worked out
//   once per pass of chunks, or once per kernel where one pass covers a
//   group of rows. bfloat16 rows with no delta (kLead = 0) in chunks of 4
//   write a chunk by one 8-byte store wherever the rows start so aligned.
// - Runs of rows: a run's rows are built in groups of R rows whose span in
//   the output starts on a 16-byte boundary and is a multiple of 16 bytes;
//   each group leaves by one bulk store from a double buffer
//   (wait_group.read before a buffer is refilled). A row off such a
//   boundary (the head or tail of a run) is written by per-thread stores.
// - The persistent gather (gather_rows): one block per SM walks work items
//   (a cloud's run of at most kMaxRows rows); each item's volume arrives by
//   one bulk copy and the next item's volume loads into a second buffer
//   while this item's rows are built. Where a layout does not fit shared
//   memory, plan_rows falls back to one volume buffer, then to per-thread
//   stores; a volume that is not a multiple of 16 bytes is staged by the
//   threads.
//
// A row is described by an XRow: its cell's offset in the volume and its
// cell's three digits (a row whose digits lie far outside the grid reads
// nothing and is all zeros), and for decoder-input rows x = [delta, patch]
// (kLead = 3) its delta, written before the patch.
//
// Limits: a cloud of at most kMaxCloudRows rows, and at most kMaxItems work
// items a launch (plan_rows refuses more), so that item and row counters
// stay within an int; row offsets are int64.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include "patch_rows.cuh"

namespace dpdist {

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

// --- rows

constexpr int kMaxRows = 128;   // rows of one run (a work item of the persistent gather)
constexpr int kMaxCloudRows = INT_MAX - kMaxRows;   // rows of one cloud
constexpr int kMaxItems = INT_MAX / 2;   // work items: item + grid stays an int
constexpr int kGroupBytes = 40064;   // a row group's bytes at most (rows 6 and 10)

// One row of the run in hand.
struct XRow {
  int vC;         // v * C: the row of the row's cell in the volume
  char4 digits;   // (v / g^2, (v / g) % g, v % g)
  float delta[3];
};

// The row of a query in cell v, with no delta.
__device__ __forceinline__ XRow cell_row(int v, int g, int C) {
  XRow ri;
  ri.vC = v * C;
  ri.digits = make_char4(static_cast<signed char>(v / (g * g)),
                         static_cast<signed char>((v / g) % g), static_cast<signed char>(v % g), 0);
  ri.delta[0] = ri.delta[1] = ri.delta[2] = 0.f;
  return ri;
}

// A row of zeros: its digits lie so far outside the grid (k < 127) that
// every chunk's window test fails.
__device__ __forceinline__ XRow zero_row() {
  XRow ri = cell_row(0, 1, 0);
  ri.digits = make_char4(-64, -64, -64, 0);
  return ri;
}

// Decoder-input rows x = [delta, patch] of queries: the voxel of query r
// (written to vox_out) and delta = q - centre, in float32.
struct QueryRows {
  static constexpr int kLead = 3;
  const float* queries;   // (rows, 3)
  const float* centers;   // (G, 3)
  int* vox_out;           // (rows,)
  int g, C;

  __device__ __forceinline__ XRow operator()(int64_t r) const {
    const float* q = queries + r * 3;
    const int v = assign_voxel(q, g);
    vox_out[r] = v;
    XRow ri = cell_row(v, g, C);
#pragma unroll
    for (int d = 0; d < 3; ++d) ri.delta[d] = q[d] - centers[v * 3 + d];
    return ri;
  }
};

// The patch elements of a run of rows fall into chunks of CW consecutive
// elements of one neighbour cell (CW divides C), numbered q = r * E / CW +
// e / CW. In one pass thread t of a team of nt owns chunks q0 + t + j * nt,
// j < J; for each it keeps where the chunk lies in the rows being built
// (pos = r * W + kLead + e), its offset in the volume from the row's cell
// (eoff = shift * C + c) and its digit shift (s.x, s.y, s.z), with its row
// in s.w (-1: no chunk).
template <int J>
struct Chunks {
  int pos[J];
  int eoff[J];
  char4 s[J];
};

template <int CW, int kLead, int J>
__device__ __forceinline__ void fill_chunks(Chunks<J>& ch, int q0, int rows, int W, int g, int k,
                                            int C, int t, int nt) {
  const int kh = k / 2;
  const int per_row = (W - kLead) / CW;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int q = q0 + t + j * nt;
    ch.pos[j] = ch.eoff[j] = 0;
    ch.s[j] = make_char4(0, 0, 0, -1);
    if (q < rows * per_row) {
      const int r = q / per_row;
      const int e = (q - r * per_row) * CW;
      const int o = e / C, c = e - (e / C) * C;
      const int sx = o / (k * k) - kh, sy = (o / k) % k - kh, sz = o % k - kh;
      ch.pos[j] = r * W + kLead + e;
      ch.eoff[j] = (sx * g * g + sy * g + sz) * C + c;
      ch.s[j] = make_char4(static_cast<signed char>(sx), static_cast<signed char>(sy),
                           static_cast<signed char>(sz), static_cast<signed char>(r));
    }
  }
}

// Writes this thread's chunks of rows rows_s[0 ..) to dst (shared or device
// memory): each element from the volume fv_s, 0 outside the grid; where vec
// is set (bfloat16, CW = 4, every chunk 8-byte aligned), by one 8-byte store
// a chunk. All loads are issued before the first store, which might alias
// them.
template <int CW, int J, typename T>
__device__ __forceinline__ void emit_chunks(T* dst, const XRow* rows_s, const Chunks<J>& ch,
                                            const float* fv_s, int g, bool vec) {
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
      if constexpr (CW == 4 && sizeof(T) == 2) {
        if (vec) {
          store_out4(dst + ch.pos[j], val[j]);
          continue;
        }
      }
#pragma unroll
      for (int i = 0; i < CW; ++i) store_out(dst + ch.pos[j] + i, val[j][i]);
    }
}

// Rows rows_s[0 .. rows) written to dst (their first row) by a team of nt
// threads: the delta of each (kLead = 3) and its patch chunks. Where the
// caller filled ch with the chunks of `cached` rows (a divisor of rows),
// each block of that many rows is emitted from them; else (cached = 0) in
// passes of J chunks per thread, each worked out first.
template <int CW, int kLead, int J, typename T>
__device__ __forceinline__ void emit_rows(T* dst, const XRow* rows_s, int rows, Chunks<J>& ch,
                                          int cached, const float* fv_s, int W, int g, int k,
                                          int C, int t, int nt) {
  if (kLead == 3) {
    for (int i = t; i < 3 * rows; i += nt) {
      const int r = i / 3, d = i - (i / 3) * 3;
      store_out(dst + r * W + d, rows_s[r].delta[d]);
    }
  }
  // bfloat16 rows with no delta in chunks of 4 (so C and W are multiples of
  // 4): every chunk starts 8 bytes aligned wherever dst does. float32 chunks
  // keep their four stores: on an H100 one 16-byte store a chunk made row 10
  // 2.6 % slower and row 6 under 1 % faster, where the 8-byte store makes
  // row 6's bfloat16 rows 13 % faster (PERF.md).
  const bool vec = kLead == 0 && CW == 4 && sizeof(T) == 2 &&
                   reinterpret_cast<uintptr_t>(dst) % 8 == 0;
  if (cached > 0) {
    for (int r = 0; r < rows; r += cached)
      emit_chunks<CW>(dst + r * W, rows_s + r, ch, fv_s, g, vec);
    return;
  }
  const int n_chunks = rows * ((W - kLead) / CW);
  for (int q0 = 0; q0 < n_chunks; q0 += J * nt) {
    fill_chunks<CW, kLead>(ch, q0, rows, W, g, k, C, t, nt);
    emit_chunks<CW>(dst, rows_s, ch, fv_s, g, vec);
  }
}

// The rows of a group of R whose chunks one pass of a team covers
// (`capacity` = J chunks a thread times the team's size, `per_row` chunks
// a row): the largest divisor of R that fits; 0 where not even one row does.
__device__ __forceinline__ int cached_rows(int R, int per_row, int capacity) {
  for (int d = R; d >= 1; --d)
    if (R % d == 0 && d * per_row <= capacity) return d;
  return 0;
}

// What a team carries from one run to the next: its chunks, for how many
// rows they are worked out once (`cached`, 0: none; `ready`: ch holds
// them), and how many groups it has stored (which row buffer is next).
template <int J>
struct RunState {
  Chunks<J> ch;
  int cached;
  bool ready;
  int group;
};

// Rows [r0, r1) of the output x (W wide), whose descriptions are
// rows_s[0 .. r1 - r0), built from the volume fv_s by a team of nt threads
// (t = 0 issues the bulk stores; sync() is the team's barrier): rows
// [r0, a) and [z, r1) by per-thread stores, whole groups of R rows in
// [a, z) through the two row buffers bufs, bufs + buf_stride. The caller
// syncs the team before rows_s or fv_s change.
template <typename T, int CW, int kLead, int J, typename Sync>
__device__ __forceinline__ void emit_run(T* x, const XRow* rows_s, int64_t r0, int64_t r1, int R,
                                         unsigned char* bufs, uint32_t buf_stride,
                                         RunState<J>& st, const float* fv_s, int W, int g, int k,
                                         int C, int t, int nt, Sync sync) {
  int64_t a = r1, z = r1;
  if (R > 0) {
    const int64_t first = (r0 + R - 1) / R * R, last = r1 / R * R;
    a = first < r1 ? first : r1;
    z = last > a ? last : a;
  }
  // A row by per-thread stores fills ch for itself; the groups' chunks are
  // worked out again after it.
  for (int64_t r = r0; r < a; ++r, st.ready = false)
    emit_rows<CW, kLead>(x + r * W, rows_s + (r - r0), 1, st.ch, 0, fv_s, W, g, k, C, t, nt);
  if (st.cached > 0 && !st.ready && a < z) {
    fill_chunks<CW, kLead>(st.ch, 0, st.cached, W, g, k, C, t, nt);
    st.ready = true;
  }
  for (int64_t g0 = a; g0 < z; g0 += R, ++st.group) {
    T* buf = reinterpret_cast<T*>(bufs + (st.group & 1) * buf_stride);
    if (t == 0) bulk_wait_read_all_but_one();   // the store that last read buf is done
    sync();
    emit_rows<CW, kLead>(buf, rows_s + (g0 - r0), R, st.ch, st.cached, fv_s, W, g, k, C, t, nt);
    fence_proxy_async();
    sync();
    if (t == 0) bulk_store(x + g0 * W, buf, static_cast<uint32_t>(R * W * sizeof(T)));
  }
  for (int64_t r = z; r < r1; ++r, st.ready = false)
    emit_rows<CW, kLead>(x + r * W, rows_s + (r - r0), 1, st.ch, 0, fv_s, W, g, k, C, t, nt);
}

// Rows per group: R0 = 16 / gcd(W * bytes, 16) rows span a multiple of 16
// bytes; a group is the largest multiple of R0 within group_bytes and
// kMaxRows (at least R0; group_bytes = 0: R0).
inline int gcd_int(int a, int b) { return b == 0 ? a : gcd_int(b, a % b); }

inline int group_rows(int W, int out_bytes, int group_bytes) {
  const int r0 = 16 / gcd_int(W * out_bytes, 16);
  return r0 * std::max(1, std::min(group_bytes / (r0 * W * out_bytes), kMaxRows / r0));
}

inline uint32_t align128(size_t b) { return static_cast<uint32_t>((b + 127) / 128 * 128); }

// What the host decides for one launch of a persistent gather.
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

// The largest layout of a persistent gather that fits: two volume buffers
// and two row-group buffers; else one volume; else rows by per-thread
// stores only. W: the row's width; group_bytes as group_rows'. smem = 0
// where no layout fits, or past kMaxCloudRows rows a cloud or kMaxItems
// items.
inline XPlan plan_rows(int B, int N, int G, int C, int W, int out_bytes, int group_bytes,
                       bool fv_aligned, bool x_aligned, int n_sm, size_t max_smem) {
  XPlan p{};
  if (B < 1 || N < 1 || N > kMaxCloudRows) return p;
  p.vol_bytes = static_cast<uint32_t>(G) * C * 4;
  p.vol_stride = align128(p.vol_bytes);
  p.bulk_volume = fv_aligned && (G * C) % 4 == 0;
  const int R = x_aligned ? group_rows(W, out_bytes, group_bytes) : 0;
  const uint32_t buf_stride = align128(static_cast<size_t>(R) * W * out_bytes);
  const uint32_t rows_bytes = align128(kMaxRows * sizeof(XRow));
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
  // Rows per item: a multiple of R, at most kMaxRows, halved while the
  // items do not fill the card.
  const int unit = p.group_rows > 0 ? p.group_rows : 1;
  int L = std::min((N + unit - 1) / unit * unit, kMaxRows / unit * unit);
  while (L > unit && static_cast<int64_t>(B) * ((N + L - 1) / L) < n_sm)
    L = std::max(unit, (L / 2 + unit - 1) / unit * unit);
  p.rows_per_item = L;
  p.items_per_cloud = (N + L - 1) / L;
  if (static_cast<int64_t>(B) * p.items_per_cloud > kMaxItems) {
    p.smem = 0;
    return p;
  }
  p.n_items = B * p.items_per_cloud;
  return p;
}

// Shared memory bytes of plan_rows' smallest layout for a (G, C) volume:
// one volume buffer and a run's row descriptions, rows by per-thread
// stores. Where these do not fit a block, no layout does.
inline size_t min_rows_smem(int G, int C) {
  return plan_rows(1, 1, G, C, 1, 4, 0, false, false, 1, SIZE_MAX).smem;
}

// A persistent gather's launch of kThreads-thread blocks on `device`: its
// plan, and as many blocks as fit on the card at once, no more than items.
struct XLaunch {
  XPlan plan;
  int grid;
};

inline cudaError_t plan_launch(int B, int N, int G, int C, int W, int out_bytes, int group_bytes,
                               const void* fv, const void* x, int threads, int device,
                               XLaunch* launch) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int n_sm = 0, max_smem = 0, sm_smem = 0;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device)) ||
      (err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) ||
      (err = cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                    device)))
    return err;
  const XPlan plan = plan_rows(B, N, G, C, W, out_bytes, group_bytes,
                               reinterpret_cast<uintptr_t>(fv) % 16 == 0,
                               reinterpret_cast<uintptr_t>(x) % 16 == 0, n_sm, max_smem);
  if (plan.smem == 0) return cudaErrorInvalidValue;
  const int per_sm =
      std::max(1, std::min(2048 / threads, sm_smem / static_cast<int>(plan.smem + 1024)));
  launch->plan = plan;
  launch->grid = std::min(plan.n_items, n_sm * per_sm);
  return cudaSuccess;
}

// The body of a persistent gather kernel of kThreads threads a block:
// out (B, N, W) from the (B, G, C) volumes fv, row r of the output
// described by rows(r) (a QueryRows or the like; kLead from it). The grid
// has no more blocks than items.
template <int kThreads, typename T, int CW, int J, typename Rows>
__device__ __forceinline__ void gather_rows(const float* __restrict__ fv, T* __restrict__ out,
                                            int N, int g, int k, int C, int W, const XPlan& plan,
                                            const Rows& rows) {
  static_assert(kThreads >= kMaxRows, "a thread describes each row of an item");
  constexpr int kLead = Rows::kLead;
  extern __shared__ __align__(128) unsigned char rows_smem[];
  unsigned char* smem = rows_smem;
  const int G = g * g * g;
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
  auto sync = [] { __syncthreads(); };

  if (tid == 0 && plan.bulk_volume) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // A group's chunks, worked out once where one pass covers whole rows.
  RunState<J> st;
  st.cached = cached_rows(R, (W - kLead) / CW, J * kThreads);
  st.ready = false;
  st.group = 0;
  __syncthreads();
  if (tid == 0 && plan.bulk_volume) stage(blockIdx.x, 0);

  int it = 0;   // items this block has taken
  for (int item = blockIdx.x; item < plan.n_items; item += n_blocks, ++it) {
    const int b = item / plan.items_per_cloud;
    const int n0 = (item % plan.items_per_cloud) * plan.rows_per_item;
    const int n1 = min(N, n0 + plan.rows_per_item);
    const int slot = plan.prefetch ? (it & 1) : 0;
    const int64_t r0 = static_cast<int64_t>(b) * N + n0, r1 = r0 + (n1 - n0);

    if (tid < n1 - n0) rows_s[tid] = rows(r0 + tid);
    float* fv_s = volume(slot);
    if (plan.bulk_volume) {
      // The other buffer's last reader, the previous item, is done (the
      // barrier at the end of its loop).
      if (tid == 0 && plan.prefetch && item + n_blocks < plan.n_items)
        stage(item + n_blocks, slot ^ 1);
      mbar_wait(&bars[slot], plan.prefetch ? (it >> 1) & 1 : it & 1);
    } else {
      const float* fb = fv + static_cast<size_t>(b) * G * C;
      for (int i0 = tid; i0 < G * C; i0 += kThreads * 8) {
        float t[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = i0 + j * kThreads;
          t[j] = i < G * C ? fb[i] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = i0 + j * kThreads;
          if (i < G * C) fv_s[i] = t[j];
        }
      }
    }
    __syncthreads();

    emit_run<T, CW, kLead>(out, rows_s, r0, r1, R, smem + plan.buf_off, plan.buf_stride, st, fv_s,
                           W, g, k, C, tid, kThreads, sync);
    __syncthreads();   // this item's volume and rows are no longer read
    if (tid == 0 && plan.bulk_volume && !plan.prefetch && item + n_blocks < plan.n_items)
      stage(item + n_blocks, 0);
  }
  if (tid == 0) bulk_wait_all();
}

}  // namespace dpdist
