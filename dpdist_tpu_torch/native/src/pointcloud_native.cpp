// Native host-runtime components of dpdist_tpu_torch: the port's copy of
// dpdist_tpu/native/src/pointcloud_native.cpp, whose functions it keeps
// unchanged, so that both packages compute the same values on one host.
//
// The reference's host pipeline is numpy-bound: np.loadtxt parses the
// 10k-point GT files at ~100ms+ each (modelnet_dataset.py:119-129), and
// the offline GT generator runs scipy cdist single-threaded
// (dataset_sample_with_gt.py:90-92). These are the host paths that feed
// the device, so they get native implementations:
//
//   pn_parse_csv_floats : mmap + hand-rolled float scanner for the
//                         comma/whitespace-delimited point files.
//   pn_min_distances    : multithreaded blocked brute-force min-distance
//                         (query x dense), vectorizable inner loop.
//
// Exposed with plain C linkage for ctypes (no pybind11 in this image).

#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// Parse up to max_vals floats from a delimited text file.
// Returns the number of floats written to out, or -1 on IO error.
long pn_parse_csv_floats(const char* path, float* out, long max_vals) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -1; }
  size_t len = (size_t)st.st_size;
  if (len == 0) { close(fd); return 0; }
  const char* data =
      (const char*)mmap(nullptr, len, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (data == MAP_FAILED) return -1;

  long n = 0;
  const char* p = data;
  const char* end = data + len;
  while (p < end && n < max_vals) {
    // skip delimiters
    while (p < end && *p != '-' && *p != '+' && *p != '.' &&
           !(*p >= '0' && *p <= '9'))
      ++p;
    if (p >= end) break;
    char* next = nullptr;
    float v = strtof(p, &next);
    if (next == p) { ++p; continue; }
    out[n++] = v;
    p = next;
  }
  munmap((void*)data, len);
  return n;
}

// out[q] = min_m sqrt(|query[q] - dense[m]|^2); multithreaded over queries.
void pn_min_distances(const float* query, long nq, const float* dense,
                      long nd, float* out, int n_threads) {
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 4;
  }
  const long kBlock = 512;  // dense block kept hot in L1/L2
  std::atomic<long> next_q(0);

  auto worker = [&]() {
    for (;;) {
      long q0 = next_q.fetch_add(256);
      if (q0 >= nq) return;
      long q1 = std::min(q0 + 256, nq);
      for (long q = q0; q < q1; ++q) out[q] = 3.4e38f;
      for (long m0 = 0; m0 < nd; m0 += kBlock) {
        long m1 = std::min(m0 + kBlock, nd);
        for (long q = q0; q < q1; ++q) {
          const float qx = query[3 * q], qy = query[3 * q + 1],
                      qz = query[3 * q + 2];
          float best = out[q];
          const float* dp = dense + 3 * m0;
          for (long m = m0; m < m1; ++m, dp += 3) {
            const float dx = qx - dp[0];
            const float dy = qy - dp[1];
            const float dz = qz - dp[2];
            const float d2 = dx * dx + dy * dy + dz * dz;
            best = d2 < best ? d2 : best;
          }
          out[q] = best;
        }
      }
    }
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  for (long q = 0; q < nq; ++q) out[q] = std::sqrt(out[q]);
}

// Bidirectional NN (host-side chamfer for validation/report tooling).
void pn_nn_distance(const float* a, long na, const float* b, long nb,
                    float* dist_a, int* idx_a, int n_threads) {
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 4;
  }
  std::atomic<long> next(0);
  auto worker = [&]() {
    for (;;) {
      long i0 = next.fetch_add(256);
      if (i0 >= na) return;
      long i1 = std::min(i0 + 256, na);
      for (long i = i0; i < i1; ++i) {
        const float ax = a[3 * i], ay = a[3 * i + 1], az = a[3 * i + 2];
        float best = 3.4e38f;
        long bestj = 0;
        const float* bp = b;
        for (long j = 0; j < nb; ++j, bp += 3) {
          const float dx = ax - bp[0];
          const float dy = ay - bp[1];
          const float dz = az - bp[2];
          const float d2 = dx * dx + dy * dy + dz * dz;
          if (d2 < best) { best = d2; bestj = j; }
        }
        dist_a[i] = best;
        idx_a[i] = (int)bestj;
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"
