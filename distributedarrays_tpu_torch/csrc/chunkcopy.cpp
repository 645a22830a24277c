// Native host-side chunk assembly/disassembly for distributedarrays_tpu and
// its PyTorch port (the port keeps this copy of native/chunkcopy.cpp).
//
// The framework's host paths — DArray(init, ...) construction, from_chunks,
// checkpoint restore — stitch per-chunk buffers into one contiguous
// global array (or slice it back apart) before/after the device scatter.
// numpy does each chunk's strided copy in C already, but serially and with
// Python-loop dispatch per chunk; for many-chunk multi-GB grids this is the
// host bottleneck.  This translation unit provides the same operation as a
// thread-parallel strided copier with one call for the whole grid.
//
// Layout contract: dst is a row-major N-d buffer; each chunk i is a
// contiguous row-major buffer of extent shapes[i*ndim..] whose destination
// origin (in elements) is offsets[i*ndim..].  scatter=false copies
// chunk->dst (assemble); scatter=true copies dst->chunk (disassemble).
//
// Built with plain g++ -O3 -shared; bound from Python via ctypes
// (distributedarrays_tpu/utils/native.py; this copy is built and bound by
// distributedarrays_tpu_torch/utils/native.py).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Job {
  char* dst;                  // global buffer base
  const int64_t* dst_dims;    // global extents (elements), length ndim
  char* chunk;                // chunk buffer base
  const int64_t* shape;       // chunk extents (elements), length ndim
  const int64_t* offset;      // chunk origin in dst (elements), length ndim
  int ndim;
  int64_t itemsize;
  bool scatter;               // true: dst -> chunk
};

// Copy one chunk: iterate all but the innermost dimension, memcpy rows.
void copy_chunk(const Job& j) {
  const int nd = j.ndim;
  if (nd == 0) {
    if (j.scatter)
      std::memcpy(j.chunk, j.dst, j.itemsize);
    else
      std::memcpy(j.dst, j.chunk, j.itemsize);
    return;
  }
  // dst strides in bytes (row-major)
  std::vector<int64_t> dstride(nd);
  dstride[nd - 1] = j.itemsize;
  for (int d = nd - 2; d >= 0; --d)
    dstride[d] = dstride[d + 1] * j.dst_dims[d + 1];

  const int64_t row = j.shape[nd - 1] * j.itemsize;   // contiguous run
  int64_t nrows = 1;
  for (int d = 0; d < nd - 1; ++d) nrows *= j.shape[d];

  std::vector<int64_t> idx(nd > 1 ? nd - 1 : 1, 0);
  char* chunk_p = j.chunk;
  for (int64_t r = 0; r < nrows; ++r) {
    int64_t doff = j.offset[nd - 1] * dstride[nd - 1];
    for (int d = 0; d < nd - 1; ++d)
      doff += (j.offset[d] + idx[d]) * dstride[d];
    char* dst_p = j.dst + doff;
    if (j.scatter)
      std::memcpy(chunk_p, dst_p, row);
    else
      std::memcpy(dst_p, chunk_p, row);
    chunk_p += row;
    for (int d = nd - 2; d >= 0; --d) {   // odometer over outer dims
      if (++idx[d] < j.shape[d]) break;
      idx[d] = 0;
    }
  }
}

}  // namespace

extern "C" {

// chunks: array of n pointers; shapes/offsets: n*ndim int64 each.
// Returns 0 on success.
int chunk_copy(char* dst, const int64_t* dst_dims, int ndim,
               char** chunks, const int64_t* shapes, const int64_t* offsets,
               int64_t n_chunks, int64_t itemsize, int scatter,
               int n_threads) {
  if (ndim < 0 || n_chunks < 0 || itemsize <= 0) return 1;
  std::vector<Job> jobs;
  jobs.reserve(n_chunks);
  for (int64_t i = 0; i < n_chunks; ++i) {
    jobs.push_back(Job{dst, dst_dims, chunks[i], shapes + i * ndim,
                       offsets + i * ndim, ndim, itemsize,
                       scatter != 0});
  }
  if (n_threads <= 1 || n_chunks <= 1) {
    for (const auto& j : jobs) copy_chunk(j);
    return 0;
  }
  const int nt = static_cast<int>(
      std::min<int64_t>(n_threads, n_chunks));
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    pool.emplace_back([&, t]() {
      for (int64_t i = t; i < static_cast<int64_t>(jobs.size()); i += nt)
        copy_chunk(jobs[i]);
    });
  }
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"
