// Flash-attention backward for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the two Pallas TPU kernels launched by `_bwd_pallas`
// (raydp_tpu/ops/flash_attention.py): `_bwd_dkdv_kernel` and `_bwd_dq_kernel`.
// Same function: from q, k, v, do [BH, T, D] (bf16 or f32), the forward's
// lse [BH, T] and delta = rowsum(do * out) [BH, T] (both f32), recompute each
// score tile and form
//   p  = exp(s * scale - lse)             (s = q kᵀ, masked to -1e30)
//   ds = p * (do vᵀ - delta) * scale      (the reference's _recompute_p_ds)
// and accumulate dv += pᵀ do, dk += dsᵀ q (dkdv_kernel) and dq += ds k
// (dq_kernel), in f32, written once in the input type.
//
// Design. The split into two kernels is kept, so that each output tile has
// one owner and is written once, with no atomics and the same result on
// every run. On the TPU the walk is the innermost sequential grid axis and
// the sums live in VMEM scratch; here one thread block owns one
// (bh, 64-row k tile) and loops over the q tiles itself (dkdv), or one
// (bh, 64-row q tile) and loops over the k tiles (dq), with the sums in
// registers: 256 threads, each 4 key rows x D/16 columns of dk and of dv
// (64 floats at D = 128), or 4 query rows x D/16 columns of dq. Every tile
// sits in shared memory as f32 with a padded row stride (dkdv 165 KB, dq
// 149 KB at D = 128, one block per SM). Both products and the score
// recompute are f32 FMA on the CUDA cores; p and ds stay in f32 for the
// dv, dk and dq products (the Pallas kernels round them to the input type
// first; the plain version, like the reference's `_bwd_blockwise`, does not).
// Under the causal mask a k tile starting at k0 only meets the q tiles whose
// last row is >= k0, so the dkdv walk starts at the q tile holding k0, and a
// q tile in dq stops at the diagonal k tile (the TPU's causal block skip).
// Query rows and keys past T are masked in the kernel (p = 0 and ds = 0:
// lse and delta are not defined there), so any T is taken.
//
// Bound. At the flagship shape (B=2, H=8, T=8192, D=128, bf16, causal) one
// product over the T(T+1)/2 kept pairs is 2*BH*D*T(T+1)/2 = 1.37e11 FLOP.
// dkdv does four (s, dp, dv, dk): 5.50e11 FLOP, 0.556 ms at the 989 TFLOP/s
// bf16 tensor-core peak, against ~0.06 ms for its ~0.2 GB of traffic;
// dq does three (s, dp, dq): 4.12e11 FLOP, 0.417 ms. Both are compute bound.
// This first version reaches at most the 67 TFLOP/s f32 CUDA-core peak and
// less in practice, bounded by shared-memory reads. What it leaves on the
// table: tensor cores (wgmma or mma.sync on bf16 tiles), TMA loads with a
// multi-stage mbarrier ring, bf16 tiles in shared memory, and one fused
// kernel that computes s and dp once for dq, dk and dv (dq through atomics or
// a second pass).

#include <math.h>

#include "flash_attention_common.cuh"

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

}  // namespace

// q, k, v, dout, dk, dv: [bh, t, d] contiguous, all bf16 (is_bf16 = 1) or all
// f32; lse, delta: [bh, t] f32. Launches on `stream` without synchronising;
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// head_dim it was not built for or a bad bh / t).
extern "C" int raydp_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bh, int t,
    int d, float scale, int causal, int is_bf16, void* stream) {
  if (bh < 1 || bh > 65535 || t < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_dtype(is_bf16, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return with_head_dim(d, [&](auto dim) {
      return launch_dkdv<T, decltype(dim)::value>(
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_dtype(is_bf16, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return with_head_dim(d, [&](auto dim) {
      return launch_dq<T, decltype(dim)::value>(q, k, v, dout, lse, delta, dq,
                                                bh, t, scale, causal, s);
    });
  });
}
