// Row-sparse table update for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces no TPU kernel. The JAX package updates an embedding table with a
// dense gradient under optax, as XLA lowers it; on this card that is a 12 GB
// gradient filled with zeros, a scatter into it and a whole-table SGD pass,
// where a batch of DLRM touches about 100 k of the tables' 94 M rows. This
// kernel applies a row-sparse gradient instead:
//
//     W_t[id] += alpha_t * sum of the gradient rows looked up at id in table t
//
// for up to kMaxTables tables of one width at once (alpha_t = -lr, or +lr
// under SGD's maximize), each distinct row read and written once.
//
// Input: the lookups of all tables as one int64 key each, (t << id_bits) |
// id, already sorted stably by the caller (torch.sort), with perm[i] the
// flat position of sorted lookup i: table t's lookups occupy flat positions
// [offset_t, offset_t + nnz_t), row (pos - offset_t) of its values. The
// width is a multiple of 4 and every row starts 16-byte aligned (the caller
// checks), so a lane moves one float4.
//
// Bound: memory. Each lookup's gradient row is read once (B x tables x D x 4
// bytes: 436 MB at DLRM's shape), each distinct row of W read and written
// once, the keys and perm read once. A warp owns a fixed chunk of kChunk
// sorted lookups and one slab of 128 columns (a 512 B row of D = 128 is one
// coalesced load a warp), loads kAhead rows ahead of the sums, and walks the
// chunk in sorted order, which is the lookups' original order within a run
// (the sort is stable). A run of equal keys that lies inside a chunk is
// summed and applied by that warp. A run that crosses a chunk boundary (zipf
// ids give one table runs of thousands of lookups) leaves one partial sum
// per chunk in a scratch buffer; a second kernel sums each such run's
// partials in chunk order, loading kCombineAhead chunks ahead, and applies
// it. No warp sums more than kChunk gradient rows, no atomics are used, and
// the result is the same bits on every run.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kMaxTables = 64;
constexpr int kChunk = 64;
constexpr int kAhead = 8;          // rows a lane loads ahead of its sums
constexpr int kCombineAhead = 16;  // partials loaded ahead (a one-row table
                                   // makes one run of all B lookups)
constexpr int kSlab = 128;         // columns a warp holds: 32 lanes x float4
constexpr unsigned kAll = 0xffffffffu;
constexpr int kThreads = 256;

// Passed by value (kernel parameter space); the Python side fills the same
// layout (ops/row_sparse.py, _Tables).
struct Tables {
  float* weight[kMaxTables];        // [rows, dim], contiguous
  const float* values[kMaxTables];  // [nnz, dim] rows, unit column stride
  long long offset[kMaxTables];     // flat position of the table's first lookup
  long long stride[kMaxTables];     // values' row stride, in floats
  float alpha[kMaxTables];          // the step: -lr, or +lr under maximize
};

__device__ __forceinline__ void add(float4& acc, const float4& r) {
  acc.x += r.x;
  acc.y += r.y;
  acc.z += r.z;
  acc.w += r.w;
}

__device__ __forceinline__ float4 load(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// W[id] += alpha * sum, for the four columns this lane holds
__device__ __forceinline__ void apply_row(const Tables& tabs, long long key,
                                          int id_bits, int dim, int col,
                                          const float4& sum) {
  const int t = static_cast<int>(key >> id_bits);
  const long long id = key & ((1LL << id_bits) - 1);
  float4* w = reinterpret_cast<float4*>(tabs.weight[t] + id * dim + col);
  const float alpha = tabs.alpha[t];
  float4 r = *w;
  r.x = fmaf(alpha, sum.x, r.x);
  r.y = fmaf(alpha, sum.y, r.y);
  r.z = fmaf(alpha, sum.z, r.z);
  r.w = fmaf(alpha, sum.w, r.w);
  *w = r;
}

// One warp a (chunk, column slab): sum each run of the chunk in sorted
// order; apply the runs that lie inside it, and leave the piece of a run
// that began in an earlier chunk in partials[chunk][0], of one that goes on
// into the next chunk in partials[chunk][1].
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const __grid_constant__ Tables tabs,
                       const long long* __restrict__ keys,
                       const long long* __restrict__ perm, long long n,
                       int id_bits, int dim, int slabs,
                       float* __restrict__ partials) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long chunk = warp / slabs;
  const long long start = chunk * kChunk;
  if (start >= n) return;  // the whole warp
  const long long end = min(start + kChunk, n);
  const int count = static_cast<int>(end - start);
  const int col = static_cast<int>(warp % slabs) * kSlab + lane * 4;
  const bool active = col < dim;

  // the chunk's keys and flat positions, two a lane
  const long long k_lo = lane < count ? keys[start + lane] : -1;
  const long long k_hi = 32 + lane < count ? keys[start + 32 + lane] : -1;
  const long long p_lo = lane < count ? perm[start + lane] : 0;
  const long long p_hi = 32 + lane < count ? perm[start + 32 + lane] : 0;
  const bool head_open = start > 0 && keys[start - 1] == keys[start];
  const bool tail_open = end < n && keys[end] == keys[end - 1];

  auto flush = [&](long long key, int first, int last, const float4& sum) {
    if (!active) return;
    const bool head = first == 0 && head_open;
    const bool tail = last == count && tail_open;
    if (head || tail) {
      *reinterpret_cast<float4*>(
          partials + (chunk * 2 + (head ? 0 : 1)) * dim + col) = sum;
    } else {
      apply_row(tabs, key, id_bits, dim, col, sum);
    }
  };

  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  long long run_key = __shfl_sync(kAll, k_lo, 0);
  int run_first = 0;
  for (int base = 0; base < count; base += kAhead) {
    float4 rows[kAhead];
    long long ks[kAhead];
#pragma unroll
    for (int g = 0; g < kAhead; ++g) {
      const int i = base + g;
      ks[g] = __shfl_sync(kAll, i < 32 ? k_lo : k_hi, i & 31);
      const long long pos = __shfl_sync(kAll, i < 32 ? p_lo : p_hi, i & 31);
      rows[g] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < count && active) {
        const int t = static_cast<int>(ks[g] >> id_bits);
        rows[g] = load(tabs.values[t] +
                       (pos - tabs.offset[t]) * tabs.stride[t] + col);
      }
    }
#pragma unroll
    for (int g = 0; g < kAhead; ++g) {
      const int i = base + g;
      if (i < count) {
        if (ks[g] != run_key) {
          flush(run_key, run_first, i, acc);
          run_key = ks[g];
          run_first = i;
          acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        add(acc, rows[g]);
      }
    }
  }
  flush(run_key, run_first, count, acc);
}

// One warp a (chunk, column slab) whose last run begins in it and goes on
// into the next chunk: that run's partial sums, in chunk order, applied
// once.
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const __grid_constant__ Tables tabs,
                   const long long* __restrict__ keys, long long n,
                   int id_bits, int dim, int slabs,
                   const float* __restrict__ partials) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long chunk = warp / slabs;
  const long long start = chunk * kChunk;
  if (start >= n) return;
  const long long end = min(start + kChunk, n);
  const int col = static_cast<int>(warp % slabs) * kSlab + lane * 4;
  if (col >= dim || end >= n) return;
  const long long key = __ldg(keys + end - 1);
  if (__ldg(keys + end) != key) return;                   // ends in this chunk
  if (start > 0 && __ldg(keys + start - 1) == key) return;  // began earlier
  const long long chunks = (n + kChunk - 1) / kChunk;

  float4 acc = load(partials + (chunk * 2 + 1) * dim + col);
  bool open = true;
  for (long long c = chunk + 1; open; c += kCombineAhead) {
    float4 rows[kCombineAhead];
    bool more[kCombineAhead];
#pragma unroll
    for (int g = 0; g < kCombineAhead; ++g) {
      const long long cg = c + g;
      rows[g] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      more[g] = false;
      if (cg < chunks) {
        rows[g] = load(partials + (cg * 2) * dim + col);
        const long long e = min((cg + 1) * kChunk, n);
        more[g] = e < n && __ldg(keys + e) == key;
      }
    }
#pragma unroll
    for (int g = 0; g < kCombineAhead; ++g) {
      if (open) {
        add(acc, rows[g]);
        open = more[g];
      }
    }
  }
  apply_row(tabs, key, id_bits, dim, col, acc);
}

}  // namespace

// tables: a host Tables (copied into the launches); keys and perm (int64):
// n sorted keys and their flat positions, on the card; id_bits: the low
// bits of a key that hold the id; dim: the tables' width, a multiple of 4,
// every weight and values row 16-byte aligned; partials: scratch of
// ceil(n / 64) * 2 * dim floats. Returns the launches' cudaError_t.
extern "C" int raydp_row_sparse_apply(const void* tables, const void* keys,
                                      const void* perm, long long n,
                                      int id_bits, int dim, void* partials,
                                      void* stream) {
  if (n < 0 || dim < 4 || dim % 4 != 0 || id_bits < 1 || id_bits > 62)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Tables& tabs = *static_cast<const Tables*>(tables);
  const auto* k = static_cast<const long long*>(keys);
  const auto* p = static_cast<const long long*>(perm);
  auto* part = static_cast<float*>(partials);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slabs = (dim + kSlab - 1) / kSlab;
  const long long warps = (n + kChunk - 1) / kChunk * slabs;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  segment_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      tabs, k, p, n, id_bits, dim, slabs, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      tabs, k, n, id_bits, dim, slabs, part);
  return (int)cudaGetLastError();
}
