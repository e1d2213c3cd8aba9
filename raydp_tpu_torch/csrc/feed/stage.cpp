// Native host-feed staging: Arrow column buffers -> one [rows, n_cols]
// interleaved train-batch matrix, cast fused with the transpose.
//
// Role (SURVEY.md section 7 step 2, "Arrow IPC <-> pinned host buffer staging
// for fast device_put"): the streaming DeviceFeed's host cost is decoding N
// fixed-width Arrow columns into the contiguous [rows, features] array that
// jax.device_put ships to HBM. The numpy path pays one full pass per column
// for the dtype cast (astype) plus a second full strided pass for the
// interleave (np.stack); this kernel does cast+interleave in ONE pass per
// column straight from the Arrow validity-free data buffer into the
// destination, optionally fanning columns out over a small thread pool
// (useful on multi-core feed hosts; the 1-core CI host runs n_threads=1).
//
// No Arrow library dependency: Python hands raw data-buffer pointers
// (pyarrow exposes them zero-copy) plus dtype codes. Null-bearing or
// non-primitive columns never reach this code (the Python caller falls back
// to the numpy path).
//
// Reference parity note: the reference's equivalent hot path is the
// JVM-side block fetcher feeding torch tensors
// (ObjectStoreReader.java + torch dataset collate); this is its TPU-native
// replacement on the host side of the feed.

#include <atomic>
#include <cstdint>
#include <thread>
#include <type_traits>
#include <vector>

namespace {

// dtype codes shared with raydp_tpu_torch/native/stage.py (keep in sync)
enum DType : int {
  F32 = 0, F64 = 1, I8 = 2, I16 = 3, I32 = 4, I64 = 5,
  U8 = 6, U16 = 7, U32 = 8, U64 = 9,
};

template <typename S, typename D>
void cast_into(const void* src_v, void* dst_v, int64_t rows,
               int64_t dst_stride, int64_t dst_col) {
  const S* src = static_cast<const S*>(src_v);
  D* dst = static_cast<D*>(dst_v) + dst_col;
  for (int64_t r = 0; r < rows; ++r) {
    dst[r * dst_stride] = static_cast<D>(src[r]);
  }
}

template <typename D>
int dispatch_src(const void* src, int src_type, void* dst, int64_t rows,
                 int64_t dst_stride, int64_t dst_col) {
  // float -> integral is undefined behavior in C++ for NaN/out-of-range
  // values (and numpy's fallback has different, platform-defined behavior,
  // so the byte-parity contract cannot hold either way): decline the pair,
  // the Python caller falls back to numpy.
  if (std::is_integral<D>::value && (src_type == F32 || src_type == F64)) {
    return -1;
  }
  switch (src_type) {
    case F32: cast_into<float, D>(src, dst, rows, dst_stride, dst_col); return 0;
    case F64: cast_into<double, D>(src, dst, rows, dst_stride, dst_col); return 0;
    case I8:  cast_into<int8_t, D>(src, dst, rows, dst_stride, dst_col); return 0;
    case I16: cast_into<int16_t, D>(src, dst, rows, dst_stride, dst_col); return 0;
    case I32: cast_into<int32_t, D>(src, dst, rows, dst_stride, dst_col); return 0;
    case I64: cast_into<int64_t, D>(src, dst, rows, dst_stride, dst_col); return 0;
    case U8:  cast_into<uint8_t, D>(src, dst, rows, dst_stride, dst_col); return 0;
    case U16: cast_into<uint16_t, D>(src, dst, rows, dst_stride, dst_col); return 0;
    case U32: cast_into<uint32_t, D>(src, dst, rows, dst_stride, dst_col); return 0;
    case U64: cast_into<uint64_t, D>(src, dst, rows, dst_stride, dst_col); return 0;
    default: return -1;
  }
}

int stage_one(const void* src, int src_type, int64_t rows, void* dst,
              int dst_type, int64_t dst_stride, int64_t dst_col) {
  switch (dst_type) {
    case F32: return dispatch_src<float>(src, src_type, dst, rows, dst_stride, dst_col);
    case F64: return dispatch_src<double>(src, src_type, dst, rows, dst_stride, dst_col);
    case I32: return dispatch_src<int32_t>(src, src_type, dst, rows, dst_stride, dst_col);
    case I64: return dispatch_src<int64_t>(src, src_type, dst, rows, dst_stride, dst_col);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// One column (or one chunk of one column): cast `rows` values of `src_type`
// from `src` into dst[dst_row0 + r][dst_col] of a [*, dst_stride] dst_type
// matrix. Returns 0, or -1 for an unsupported dtype pair.
int rdt_stage_cast(const void* src, int src_type, int64_t rows, void* dst,
                   int dst_type, int64_t dst_stride, int64_t dst_col,
                   int64_t dst_row0) {
  if (rows < 0 || dst_stride <= 0 || dst_col < 0 || dst_col >= dst_stride) {
    return -1;
  }
  char* base = static_cast<char*>(dst);
  int64_t elem = (dst_type == F64 || dst_type == I64) ? 8 : 4;
  return stage_one(src, src_type, rows, base + dst_row0 * dst_stride * elem,
                   dst_type, dst_stride, dst_col);
}

// All columns of a single-chunk table in one call, columns fanned out over
// `n_threads` workers (<=1 = inline). All columns share `rows`.
int rdt_stage_columns(const void** srcs, const int* src_types, int64_t n_cols,
                      int64_t rows, void* dst, int dst_type, int n_threads) {
  if (n_cols <= 0) return -1;
  // validate dtypes up-front so threaded work cannot partially fail
  bool dst_integral = (dst_type == I32 || dst_type == I64);
  for (int64_t c = 0; c < n_cols; ++c) {
    if (src_types[c] < F32 || src_types[c] > U64) return -1;
    // float -> int: UB on NaN/out-of-range, declined (see dispatch_src)
    if (dst_integral && (src_types[c] == F32 || src_types[c] == F64)) {
      return -1;
    }
  }
  if (dst_type != F32 && dst_type != F64 && dst_type != I32 &&
      dst_type != I64) {
    return -1;
  }
  if (n_threads <= 1 || n_cols == 1) {
    for (int64_t c = 0; c < n_cols; ++c) {
      if (stage_one(srcs[c], src_types[c], rows, dst, dst_type, n_cols, c)) {
        return -1;
      }
    }
    return 0;
  }
  int workers = n_threads < n_cols ? n_threads : static_cast<int>(n_cols);
  // per-worker status accumulates into one atomic flag: the pre-checks above
  // should make a dispatch miss unreachable, but a future edit loosening
  // them (or a Python/C++ dtype-table drift) must fail loudly with -1, never
  // silently leave np.empty garbage in unwritten columns
  std::atomic<int> status{0};
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (int w = 0; w < workers; ++w) {
    pool.emplace_back([=, &status]() {
      for (int64_t c = w; c < n_cols; c += workers) {
        if (stage_one(srcs[c], src_types[c], rows, dst, dst_type, n_cols,
                      c)) {
          status.store(-1, std::memory_order_relaxed);
        }
      }
    });
  }
  for (auto& t : pool) t.join();
  return status.load(std::memory_order_relaxed);
}

}  // extern "C"
