// Flash-attention backward for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the two Pallas TPU kernels launched by `_bwd_pallas`
// (raydp_tpu/ops/flash_attention.py): `_bwd_dkdv_kernel` and `_bwd_dq_kernel`.
// Same function: from q, k, v, do [BH, T, D] (bf16 or f32), the forward's
// lse [BH, T] and delta = rowsum(do * out) [BH, T] (both f32), recompute each
// score tile and form
//   p  = exp(s * scale - lse)             (s = q kᵀ, masked to -1e30)
//   ds = p * (do vᵀ - delta) * scale      (the reference's _recompute_p_ds)
// and accumulate dv += pᵀ do, dk += dsᵀ q (dkdv) and dq += ds k (dq), in f32,
// written once in the input type.
//
// Both dtypes keep the split into two kernels, so that each output tile has
// one owner and is written once, with no atomics and the same result on
// every run. On the TPU the walk is the innermost sequential grid axis and
// the sums live in VMEM scratch; here a thread block owns a tile of keys and
// loops over the q tiles itself (dkdv), or owns a tile of queries and loops
// over the k tiles (dq), with the sums in registers. Under the causal mask
// a k tile starting at k0 only meets the q tiles whose last row is >= k0, so
// the dkdv walk starts at the q tile holding k0, and a q tile in dq stops at
// the diagonal k tile (the TPU's causal block skip); blocks are launched
// longest walk first. Query rows and keys past T are zero-filled on load and
// masked (p = 0 and ds = 0: lse and delta are not defined there), so any T
// is taken.
//
// bf16 (the training path): tensor cores, `tc::dkdv_tc_kernel<D>` and
// `tc::dq_tc_kernel<D>`. A block is two warpgroups, each owning 64 keys
// (dkdv) or 64 queries (dq), so 128 a block; the resident tiles (k and v, or
// q and do) are loaded once, the walked tiles of 64 rows (q, do and their lse
// and delta rows, or k and v) come through a three-slot ring filled by
// cp.async with zero fill, two tiles ahead of the products. Tiles are bf16
// in shared memory in wgmma's swizzled layout (hopper_mma.cuh). dkdv
// computes the transposed scores sᵀ = k qᵀ and dpᵀ = v doᵀ with keys as the
// M rows (wgmma m64n64k16, both operands from shared memory), so pᵀ and dsᵀ
// come out in the accumulator registers; rounded to bf16, as the Pallas
// kernels round p and ds, they are the register A operand of dv += pᵀ do
// and dk += dsᵀ q (m64nDk16, do and q read MN-major), with no trip through
// shared memory; dv's product runs while dsᵀ is formed. dq computes
// s = q kᵀ and dp = do vᵀ with queries as M, then dq += ds k the same way.
// The causal mask is applied only on tiles that cross the diagonal or the
// end of the sequence. Per thread at D = 128: dk and dv 2 x 64 f32
// registers, sᵀ and dpᵀ 2 x 32, pᵀ and dsᵀ 2 x 16 as bf16 pairs; ptxas
// fits dkdv in 254 registers and dq in 170 with no spills, and a 64-row q
// walk is faster than a 32-row one that needs fewer registers (measured).
//
// f32: CUDA-core kernels, `dkdv_kernel<float, D>` and `dq_kernel<float, D>`
// (the first port's design, kept because f32 on the tensor cores would be
// TF32, which the f32 limits of 1e-5 do not admit): 256 threads own a
// 64-row tile, tiles sit in shared memory as f32 with a padded row stride,
// every product is FMA, and p and ds stay in f32.
//
// Bound. At the flagship shape (B=2, H=8, T=8192, D=128, bf16, causal) one
// product over the T(T+1)/2 kept pairs is 2*BH*D*T(T+1)/2 = 1.37e11 FLOP.
// dkdv does four (s, dp, dv, dk): 5.50e11 FLOP, 0.556 ms at the 989 TFLOP/s
// bf16 tensor-core peak, against ~0.06 ms for its ~0.2 GB of traffic;
// dq does three (s, dp, dq): 4.12e11 FLOP, 0.417 ms. Both are compute bound.
// What this design leaves: s and dp are computed twice (once per kernel);
// each warpgroup waits for its own products before the softmax step (no
// ping-pong between warpgroups, no producer warp, no TMA); the diagonal
// tiles of the causal walk are computed whole.

#include <math.h>

#include <cstdint>
#include <initializer_list>

#include "flash_attention_common.cuh"
#include "hopper_mma.cuh"

namespace {

using namespace raydp_fa;

constexpr int BLOCK_M = 64;               // query rows per q tile
constexpr int BLOCK_N = 64;               // keys per k tile
constexpr int THREADS = 256;              // 16 x 16 threads
constexpr int ROWS = BLOCK_M / 16;        // score rows (queries) per thread
constexpr int COLS = BLOCK_N / 16;        // score columns (keys) per thread
constexpr int KEYS = BLOCK_N / 16;        // dk/dv rows per thread
constexpr int S_STRIDE = BLOCK_N + 1;     // padded p / ds tiles

// Row stride of the q, do, k and v tiles: padded, so the 16 lanes of a half
// warp reading one column of 16 rows hit 16 banks.
template <int D>
__host__ __device__ constexpr int tile_stride() { return D + 1; }

// p and ds of one (q tile at q0, k tile at k0) for this thread's scores:
// query rows ty + 16 i, keys tx + 16 j. lse_r / delta_r are the rows' lse and
// delta; rows past t give p = ds = 0.
template <int D>
__device__ __forceinline__ void p_and_ds(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float (&lse_r)[ROWS], const float (&delta_r)[ROWS], int q0, int k0,
    int t, float scale, int causal, int tx, int ty, float (&p)[ROWS][COLS],
    float (&ds)[ROWS][COLS]) {
  constexpr int S = tile_stride<D>();
  float s[ROWS][COLS], dp[ROWS][COLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < COLS; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float qv[ROWS], dov[ROWS], kv[COLS], vv[COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      qv[i] = qs[(ty + 16 * i) * S + d];
      dov[i] = dos[(ty + 16 * i) * S + d];
    }
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      kv[j] = ks[(tx + 16 * j) * S + d];
      vv[j] = vs[(tx + 16 * j) * S + d];
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int q_pos = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      float x = s[i][j] * scale;
      if (masked(q_pos, k0 + tx + 16 * j, t, causal)) x = NEG_INF;
      const bool row_in = q_pos < t;
      p[i][j] = row_in ? expf(x - lse_r[i]) : 0.f;
      ds[i][j] = row_in ? p[i][j] * (dp[i][j] - delta_r[i]) * scale : 0.f;
    }
  }
}

// lse and delta of this thread's query rows ty + 16 i of the q tile at q0.
__device__ __forceinline__ void load_row_stats(
    const float* __restrict__ lse, const float* __restrict__ delta, int q0,
    int t, int ty, float (&lse_r)[ROWS], float (&delta_r)[ROWS]) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < t ? lse[r] : 0.f;
    delta_r[i] = r < t ? delta[r] : 0.f;
  }
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) *
         (2 * BLOCK_N * tile_stride<D>() + 2 * BLOCK_M * tile_stride<D>() +
          2 * BLOCK_M * S_STRIDE);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dk, T* __restrict__ dv, int t, float scale,
                int causal) {
  constexpr int DC = D / 16;              // dk/dv columns per thread
  constexpr int S = tile_stride<D>();
  extern __shared__ float smem[];
  float* ks = smem;                       // [BLOCK_N][S]
  float* vs = ks + BLOCK_N * S;           // [BLOCK_N][S]
  float* qs = vs + BLOCK_N * S;           // [BLOCK_M][S]
  float* dos = qs + BLOCK_M * S;          // [BLOCK_M][S]
  float* ps = dos + BLOCK_M * S;          // [BLOCK_M][S_STRIDE]
  float* dss = ps + BLOCK_M * S_STRIDE;   // [BLOCK_M][S_STRIDE]

  const int tx = threadIdx.x & 15;        // score key / dk-dv column group
  const int ty = threadIdx.x >> 4;        // score query / dk-dv key group
  // k tiles first-first: under the causal mask the first walk the most q tiles
  const int k0 = blockIdx.x * BLOCK_N;
  const size_t head = (size_t)blockIdx.y * t;
  q += head * D;
  k += head * D;
  v += head * D;
  dout += head * D;
  dk += head * D;
  dv += head * D;
  lse += head;
  delta += head;

  load_rows<BLOCK_N, D, THREADS>(ks, S, k, vs, S, v, k0, t);

  float dk_acc[KEYS][DC], dv_acc[KEYS][DC];
#pragma unroll
  for (int i = 0; i < KEYS; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // causal: q tiles whose last row lies before k0 contribute exactly zero
  const int q_begin = causal ? (k0 / BLOCK_M) * BLOCK_M : 0;
  for (int q0 = q_begin; q0 < t; q0 += BLOCK_M) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<BLOCK_M, D, THREADS>(qs, S, q, dos, S, dout, q0, t);
    __syncthreads();

    float lse_r[ROWS], delta_r[ROWS], p[ROWS][COLS], ds[ROWS][COLS];
    load_row_stats(lse, delta, q0, t, ty, lse_r, delta_r);
    p_and_ds<D>(qs, dos, ks, vs, lse_r, delta_r, q0, k0, t, scale, causal, tx,
                ty, p, ds);
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        ps[(ty + 16 * i) * S_STRIDE + tx + 16 * j] = p[i][j];
        dss[(ty + 16 * i) * S_STRIDE + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();

    // dv += pᵀ · do and dk += dsᵀ · q for keys ty + 16 i, columns tx + 16 c
#pragma unroll 4
    for (int m = 0; m < BLOCK_M; ++m) {
      float pv[KEYS], dsv[KEYS], dov[DC], qv[DC];
#pragma unroll
      for (int i = 0; i < KEYS; ++i) {
        pv[i] = ps[m * S_STRIDE + ty + 16 * i];
        dsv[i] = dss[m * S_STRIDE + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dov[c] = dos[m * S + tx + 16 * c];
        qv[c] = qs[m * S + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < KEYS; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv_acc[i][c] = fmaf(pv[i], dov[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dsv[i], qv[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < KEYS; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= t) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      store(dk + (size_t)key * D + tx + 16 * c, dk_acc[i][c]);
      store(dv + (size_t)key * D + tx + 16 * c, dv_acc[i][c]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) *
         (2 * BLOCK_M * tile_stride<D>() + 2 * BLOCK_N * tile_stride<D>() +
          BLOCK_M * S_STRIDE);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int t, float scale, int causal) {
  constexpr int DC = D / 16;              // dq columns per thread
  constexpr int S = tile_stride<D>();
  extern __shared__ float smem[];
  float* qs = smem;                       // [BLOCK_M][S]
  float* dos = qs + BLOCK_M * S;          // [BLOCK_M][S]
  float* ks = dos + BLOCK_M * S;          // [BLOCK_N][S]
  float* vs = ks + BLOCK_N * S;           // [BLOCK_N][S]
  float* dss = vs + BLOCK_N * S;          // [BLOCK_M][S_STRIDE]

  const int tx = threadIdx.x & 15;        // score key / dq column group
  const int ty = threadIdx.x >> 4;        // query row group
  // q tiles last-first: under the causal mask the last walk the most k tiles
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BLOCK_M;
  const size_t head = (size_t)blockIdx.y * t;
  q += head * D;
  k += head * D;
  v += head * D;
  dout += head * D;
  dq += head * D;
  lse += head;
  delta += head;

  load_rows<BLOCK_M, D, THREADS>(qs, S, q, dos, S, dout, q0, t);
  float lse_r[ROWS], delta_r[ROWS];
  load_row_stats(lse, delta, q0, t, ty, lse_r, delta_r);

  float acc[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  // causal: k tiles past this q tile's last row contribute exactly zero
  const int k_end = causal ? min(t, q0 + BLOCK_M) : t;
  for (int k0 = 0; k0 < k_end; k0 += BLOCK_N) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<BLOCK_N, D, THREADS>(ks, S, k, vs, S, v, k0, t);
    __syncthreads();

    float p[ROWS][COLS], ds[ROWS][COLS];
    p_and_ds<D>(qs, dos, ks, vs, lse_r, delta_r, q0, k0, t, scale, causal, tx,
                ty, p, ds);
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        dss[(ty + 16 * i) * S_STRIDE + tx + 16 * j] = ds[i][j];
    __syncthreads();

    // dq += ds · k for rows ty + 16 i, columns tx + 16 c
#pragma unroll 4
    for (int n = 0; n < BLOCK_N; ++n) {
      float dsv[ROWS], kv[DC];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) dsv[i] = dss[(ty + 16 * i) * S_STRIDE + n];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = ks[n * S + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int q_pos = q0 + ty + 16 * i;
    if (q_pos >= t) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store(dq + (size_t)q_pos * D + tx + 16 * c, acc[i][c]);
  }
}

template <typename T, int D>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int bh, int t, float scale,
                        int causal, cudaStream_t stream) {
  constexpr size_t smem = dkdv_smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + BLOCK_N - 1) / BLOCK_N, bh);
  dkdv_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), t, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int t, float scale, int causal,
                      cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + BLOCK_M - 1) / BLOCK_M, bh);
  dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), t, scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: warpgroup tensor-core kernels
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using raydp_sm90::TileLayout;
using raydp_sm90::Wgmma;

constexpr int WG = 128;               // threads of a warpgroup
constexpr int THREADS = 2 * WG;       // two consumer warpgroups a block
constexpr int ROWS = 64;              // M rows of one warpgroup's products
constexpr int OWNED = 2 * ROWS;       // keys (dkdv) or queries (dq) a block
constexpr int WALK_Q = 64;            // q rows a dkdv step walks
constexpr int WALK_K = 64;            // keys a dq step walks
constexpr int STAGES = 3;             // ring of walked tiles
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory: the two resident tiles of OWNED rows, then STAGES slots of
// two walked tiles of WALK rows, then STAGES x 2 rows of WALK floats (lse
// and delta; dkdv reads them, dq keeps its two rows in registers); 1024
// bytes of slack to align the start to a swizzle period.
template <int D>
__host__ __device__ constexpr int resident_bytes() {
  return 2 * TileLayout<D>::bytes(OWNED);
}
template <int D, int WALK>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * TileLayout<D>::bytes(WALK);
}
template <int D, int WALK>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + resident_bytes<D>() + STAGES * stage_bytes<D, WALK>() +
         STAGES * 2 * WALK * sizeof(float);
}

__device__ __forceinline__ uint32_t aligned_smem(uint8_t* raw,
                                                 uint8_t** generic) {
  const uint32_t a = raydp_sm90::smem_addr(raw);
  const uint32_t aligned = (a + 1023) & ~1023u;
  *generic = raw + (aligned - a);
  return aligned;
}

// Store an m64 x D f32 accumulator of a warpgroup as bf16 rows
// [row0, row0 + 64) of a [t, D] matrix, rows past t dropped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           const float (&acc)[D / 2],
                                           int row0, int t, int tid) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = row0 + raydp_sm90::acc_row(tid, i);
    if (row < t)
      *reinterpret_cast<__nv_bfloat162*>(
          dst + (size_t)row * D + raydp_sm90::acc_col(tid, i)) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

// dk and dv of OWNED keys per block: warpgroup w owns keys k0 + 64 w and
// walks the q tiles. Per q tile of WALK rows it forms the transposed scores
// sᵀ = k qᵀ and dpᵀ = v doᵀ (keys as M, q and do as K-major B), turns them
// into pᵀ and dsᵀ in the accumulator registers, rounds them to bf16 and
// feeds them as the register A operand of dv += pᵀ do and dk += dsᵀ q
// (do and q as MN-major B).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int t, float scale, int causal) {
  using namespace raydp_sm90;
  constexpr int KS = WALK_Q / 16;        // k16 steps over a q tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem;
  const uint32_t ks = aligned_smem(smem_raw, &smem);
  const uint32_t vs = ks + TileLayout<D>::bytes(OWNED);
  const uint32_t ring = ks + resident_bytes<D>();
  float* rows = reinterpret_cast<float*>(smem + resident_bytes<D>() +
                                         STAGES * stage_bytes<D, WALK_Q>());

  const int tid = threadIdx.x % WG;
  const int k0 = blockIdx.x * OWNED;     // first-first: longest walks first
  const int wk0 = k0 + ROWS * (threadIdx.x / WG);   // this warpgroup's keys
  const size_t head = (size_t)blockIdx.y * t;
  q += head * D;
  k += head * D;
  v += head * D;
  dout += head * D;
  dk += head * D;
  dv += head * D;
  lse += head;
  delta += head;

  // causal: q tiles whose last row lies before k0 contribute exactly zero
  const int q_begin = causal ? k0 : 0;
  const int steps = (t - q_begin + WALK_Q - 1) / WALK_Q;
  auto fetch = [&](int step) {           // q, do, lse, delta of one q tile
    if (step < steps) {
      const int slot = step % STAGES, q0 = q_begin + step * WALK_Q;
      const uint32_t qs = ring + slot * stage_bytes<D, WALK_Q>();
      load_tile_async<D, WALK_Q, THREADS>(qs, q, q0, t);
      load_tile_async<D, WALK_Q, THREADS>(qs + TileLayout<D>::bytes(WALK_Q),
                                          dout, q0, t);
      if (threadIdx.x < 2 * WALK_Q) {    // one lse or delta row each
        const int which = threadIdx.x / WALK_Q, r = threadIdx.x % WALK_Q;
        const bool in = q0 + r < t;
        cp_async4(smem_addr(rows + (2 * slot + which) * WALK_Q + r),
                  (which ? delta : lse) + (in ? q0 + r : 0), in);
      }
    }
    cp_async_commit();                   // an empty group keeps the count
  };
  load_tile_async<D, OWNED, THREADS>(ks, k, k0, t);
  load_tile_async<D, OWNED, THREADS>(vs, v, k0, t);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const float scale_log2 = scale * LOG2E;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();         // this step's tiles have landed
    fence_async_smem();
    __syncthreads();                     // ... for every thread; the slot of
    fetch(step + STAGES - 1);            // step - 1 is free to refill
    const int q0 = q_begin + step * WALK_Q;
    // all of this tile's queries before all of this warpgroup's keys, or no
    // key of the warpgroup below t: nothing to add
    if ((causal && q0 + WALK_Q - 1 < wk0) || wk0 >= t) continue;

    const int slot = step % STAGES;
    const uint32_t qs = ring + slot * stage_bytes<D, WALK_Q>();
    const uint32_t dos = qs + TileLayout<D>::bytes(WALK_Q);
    const float* lse_s = rows + 2 * slot * WALK_Q;
    const float* delta_s = lse_s + WALK_Q;
    const int krow = wk0 - k0;           // this warpgroup's rows of k and v

    float st[WALK_Q / 2], dpt[WALK_Q / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<WALK_Q>::ss(st, desc_k_major<D>(ks, OWNED, krow, kk),
                        desc_k_major<D>(qs, WALK_Q, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<WALK_Q>::ss(dpt, desc_k_major<D>(vs, OWNED, krow, kk),
                        desc_k_major<D>(dos, WALK_Q, 0, kk), kk);
    wgmma_commit();

    // pᵀ = exp(sᵀ scale - lse) on (key, query) with the query as column; a
    // key after its query (causal), a key past t or a query past t gives 0
    const bool edge = (causal && q0 < wk0 + ROWS - 1) || q0 + WALK_Q > t ||
                      wk0 + ROWS > t;
    wgmma_wait<1>();
    fence_regs(st);
#pragma unroll
    for (int i = 0; i < WALK_Q / 2; ++i) {
      const int col = acc_col(tid, i);
      float p = exp2f(st[i] * scale_log2 - lse_s[col] * LOG2E);
      if (edge) {
        const int key = wk0 + acc_row(tid, i), qp = q0 + col;
        if (key >= t || qp >= t || (causal && qp < key)) p = 0.f;
      }
      st[i] = p;
    }
    // pᵀ rounded to bf16 (as the Pallas kernels round p): dv += pᵀ do runs
    // while dsᵀ is formed
    uint32_t pf[KS][4], dsf[KS][4];
    acc_to_frags<KS>(st, pf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Wgmma<D>::rs(dv_acc, pf[kk], desc_mn_major<D>(dos, WALK_Q, kk), 1);
    wgmma_commit();

    wgmma_wait<1>();                     // dpᵀ has landed
    fence_regs(dpt);
#pragma unroll
    for (int i = 0; i < WALK_Q / 2; ++i)
      dpt[i] = st[i] * (dpt[i] - delta_s[acc_col(tid, i)]) * scale;
    acc_to_frags<KS>(dpt, dsf);          // dsᵀ rounded as the Pallas kernels
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Wgmma<D>::rs(dk_acc, dsf[kk], desc_mn_major<D>(qs, WALK_Q, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pf);
    fence_regs(dsf);
  }

  store_rows<D>(dk, dk_acc, wk0, t, tid);
  store_rows<D>(dv, dv_acc, wk0, t, tid);
}

// dq of OWNED queries per block: warpgroup w owns queries q0 + 64 w and
// walks the k tiles. Per k tile of WALK_K keys: s = q kᵀ and dp = do vᵀ
// (queries as M, k and v as K-major B), ds in the accumulator registers,
// rounded to bf16 and fed as the register A operand of dq += ds k (k as
// MN-major B).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 int t, float scale, int causal) {
  using namespace raydp_sm90;
  constexpr int KS = WALK_K / 16;        // k16 steps over a k tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem;
  const uint32_t qs = aligned_smem(smem_raw, &smem);
  const uint32_t dos = qs + TileLayout<D>::bytes(OWNED);
  const uint32_t ring = qs + resident_bytes<D>();

  const int tid = threadIdx.x % WG;
  // q tiles last-first: under the causal mask the last walk the most k tiles
  const int q0 = (gridDim.x - 1 - blockIdx.x) * OWNED;
  const int wq0 = q0 + ROWS * (threadIdx.x / WG);  // this warpgroup's queries
  const size_t head = (size_t)blockIdx.y * t;
  q += head * D;
  k += head * D;
  v += head * D;
  dout += head * D;
  dq += head * D;
  lse += head;
  delta += head;

  // causal: k tiles past this block's last query contribute exactly zero
  const int k_end = causal ? min(t, q0 + OWNED) : t;
  const int steps = (k_end + WALK_K - 1) / WALK_K;
  auto fetch = [&](int step) {           // k and v of one k tile
    if (step < steps) {
      const uint32_t kt = ring + (step % STAGES) * stage_bytes<D, WALK_K>();
      load_tile_async<D, WALK_K, THREADS>(kt, k, step * WALK_K, t);
      load_tile_async<D, WALK_K, THREADS>(kt + TileLayout<D>::bytes(WALK_K),
                                          v, step * WALK_K, t);
    }
    cp_async_commit();
  };
  load_tile_async<D, OWNED, THREADS>(qs, q, q0, t);
  load_tile_async<D, OWNED, THREADS>(dos, dout, q0, t);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);

  // lse (in log2 units) and delta of this thread's two query rows
  float lse2_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wq0 + acc_row(tid, 2 * h);
    lse2_r[h] = r < t ? lse[r] * LOG2E : 0.f;
    delta_r[h] = r < t ? delta[r] : 0.f;
  }
  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
  const float scale_log2 = scale * LOG2E;
  const int qrow = wq0 - q0;             // this warpgroup's rows of q and do

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();
    fence_async_smem();
    __syncthreads();
    fetch(step + STAGES - 1);
    const int k0 = step * WALK_K;
    // all of this tile's keys after all of this warpgroup's queries, or no
    // query of the warpgroup below t: nothing to add
    if ((causal && k0 > wq0 + ROWS - 1) || wq0 >= t) continue;

    const uint32_t kt = ring + (step % STAGES) * stage_bytes<D, WALK_K>();
    const uint32_t vt = kt + TileLayout<D>::bytes(WALK_K);

    float s[WALK_K / 2], dp[WALK_K / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<WALK_K>::ss(s, desc_k_major<D>(qs, OWNED, qrow, kk),
                        desc_k_major<D>(kt, WALK_K, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<WALK_K>::ss(dp, desc_k_major<D>(dos, OWNED, qrow, kk),
                        desc_k_major<D>(vt, WALK_K, 0, kk), kk);
    wgmma_commit();

    const bool edge = (causal && k0 + WALK_K - 1 > wq0) || k0 + WALK_K > t ||
                      wq0 + ROWS > t;
    wgmma_wait<1>();
    fence_regs(s);
#pragma unroll
    for (int i = 0; i < WALK_K / 2; ++i) {
      const int h = (i >> 1) & 1;
      float p = exp2f(s[i] * scale_log2 - lse2_r[h]);
      if (edge) {
        const int qp = wq0 + acc_row(tid, i), key = k0 + acc_col(tid, i);
        if (key >= t || qp >= t || (causal && qp < key)) p = 0.f;
      }
      s[i] = p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < WALK_K / 2; ++i)
      dp[i] = s[i] * (dp[i] - delta_r[(i >> 1) & 1]) * scale;

    uint32_t dsf[KS][4];                 // ds rounded to bf16
    acc_to_frags<KS>(dp, dsf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Wgmma<D>::rs(dq_acc, dsf[kk], desc_mn_major<D>(kt, WALK_K, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    fence_regs(dsf);
  }

  store_rows<D>(dq, dq_acc, wq0, t, tid);
}

template <int D>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int bh, int t, float scale,
                        int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, WALK_Q>();
  const cudaError_t err = cudaFuncSetAttribute(
      dkdv_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + OWNED - 1) / OWNED, bh);
  dkdv_tc_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), t, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int t, float scale, int causal,
                      cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, WALK_K>();
  const cudaError_t err = cudaFuncSetAttribute(
      dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + OWNED - 1) / OWNED, bh);
  dq_tc_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), t, scale, causal);
  return cudaGetLastError();
}

}  // namespace tc

// bf16 goes to the tensor-core kernels, f32 to the CUDA-core ones
template <typename T, int D>
cudaError_t dispatch_dkdv(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int bh,
                          int t, float scale, int causal,
                          cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return tc::launch_dkdv<D>(q, k, v, dout, lse, delta, dk, dv, bh, t,
                              scale, causal, stream);
  else
    return launch_dkdv<T, D>(q, k, v, dout, lse, delta, dk, dv, bh, t,
                             scale, causal, stream);
}

template <typename T, int D>
cudaError_t dispatch_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int bh, int t, float scale, int causal,
                        cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return tc::launch_dq<D>(q, k, v, dout, lse, delta, dq, bh, t, scale,
                            causal, stream);
  else
    return launch_dq<T, D>(q, k, v, dout, lse, delta, dq, bh, t, scale,
                           causal, stream);
}

// cp.async copies 16 bytes at a time: the bf16 kernels need every [bh, t, d]
// tensor to start on a 16-byte boundary (as PyTorch's allocations do)
bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

}  // namespace

// q, k, v, dout, dk, dv: [bh, t, d] contiguous, all bf16 (is_bf16 = 1) or all
// f32; lse, delta: [bh, t] f32. Launches on `stream` without synchronising;
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// head_dim it was not built for or a bad bh / t, cudaErrorMisalignedAddress
// for a bf16 tensor off a 16-byte boundary).
extern "C" int raydp_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bh, int t,
    int d, float scale, int causal, int is_bf16, void* stream) {
  if (bh < 1 || bh > 65535 || t < 1) return (int)cudaErrorInvalidValue;
  if (is_bf16 && !aligned16({q, k, v, dout, dk, dv}))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_dtype(is_bf16, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return with_head_dim(d, [&](auto dim) {
      return dispatch_dkdv<T, decltype(dim)::value>(
          q, k, v, dout, lse, delta, dk, dv, bh, t, scale, causal, s);
    });
  });
}

// The same inputs -> dq [bh, t, d] in the input type.
extern "C" int raydp_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int bh, int t, int d,
    float scale, int causal, int is_bf16, void* stream) {
  if (bh < 1 || bh > 65535 || t < 1) return (int)cudaErrorInvalidValue;
  if (is_bf16 && !aligned16({q, k, v, dout, dq}))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_dtype(is_bf16, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return with_head_dim(d, [&](auto dim) {
      return dispatch_dq<T, decltype(dim)::value>(q, k, v, dout, lse, delta,
                                                  dq, bh, t, scale, causal, s);
    });
  });
}
