// Flash-attention forward for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (raydp_tpu/ops/flash_attention.py,
// launched by `_fwd_pallas`). Same function: q, k, v [BH, T, D] (bf16 or f32)
// -> out [BH, T, D] in the input type and lse [BH, T] in f32, by the online
// softmax (running max m, normaliser l, accumulator acc, all f32), with the
// causal mask q_pos >= k_pos, the -1e30 sentinel for masked scores,
// out = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)).
//
// Design. The TPU walks k blocks as the innermost *sequential* grid axis and
// carries m/l/acc in VMEM scratch across grid steps. Hopper's blocks run in
// parallel and in no order, so here one thread block owns one (bh, q tile)
// and walks the k tiles in a loop of its own; m, l and acc live in
// registers. The Q tile stays in shared memory; K and V tiles stream
// through it. A causal q tile stops at the diagonal k tile (the TPU's causal
// block skip). Rows and keys past T are masked inside the kernel, so any T is
// taken and no caller needs a fallback for ragged shapes. Tiles are 64 x 64
// (the TPU's 1024 x 1024 does not fit 227 KB of shared memory); q tiles are
// issued last-first so the long causal tiles start early.
//
// Bound. At the flagship shape (B=2, H=8, T=8192, D=128, bf16, causal) one call
// does 4*B*H*D*T(T+1)/2 ~ 2.75e11 FLOP against 134 MB of q/k/v/out: compute
// bound, ~0.28 ms at the 989 TFLOP/s bf16 tensor-core peak. This first
// version computes both products with f32 FMA on the CUDA cores (256 threads,
// each a 4 x 4 tile of scores and a 4 x D/16 tile of the output), so it can
// reach at most the 67 TFLOP/s f32 peak and in practice less, bounded by
// shared-memory reads. What it leaves on the table: tensor cores (wgmma on
// bf16 tiles, A from registers), TMA loads with a multi-stage mbarrier ring,
// warp specialisation and keeping tiles in bf16 to halve shared memory.

#include <math.h>

#include "flash_attention_common.cuh"

namespace {

using namespace raydp_fa;

constexpr int BLOCK_M = 64;               // query rows per thread block
constexpr int BLOCK_N = 64;               // keys per k tile
constexpr int THREADS = 256;              // 16 x 16 threads
constexpr int ROWS = BLOCK_M / 16;        // query rows per thread
constexpr int COLS = BLOCK_N / 16;        // score columns per thread
constexpr int P_STRIDE = BLOCK_N + 1;     // padded: no bank conflicts in P·V

// Max / sum over the 16 lanes that share a query row (lanes tx = 0..15 of
// one half warp): xor offsets below 16 never cross into the other half.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BLOCK_M * D + BLOCK_N * (D + 1) + BLOCK_N * D + BLOCK_M * P_STRIDE);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out,
               float* __restrict__ lse, int t, float scale, int causal) {
  constexpr int DC = D / 16;              // output columns per thread
  constexpr int K_STRIDE = D + 1;         // padded: no bank conflicts in Q·Kᵀ
  extern __shared__ float smem[];
  float* qs = smem;                       // [BLOCK_M][D]
  float* ks = qs + BLOCK_M * D;           // [BLOCK_N][K_STRIDE]
  float* vs = ks + BLOCK_N * K_STRIDE;    // [BLOCK_N][D]
  float* ps = vs + BLOCK_N * D;           // [BLOCK_M][P_STRIDE]

  const int tid = threadIdx.x;
  const int tx = tid & 15;                // score column / output column group
  const int ty = tid >> 4;                // query row group
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BLOCK_M;
  const size_t head = (size_t)blockIdx.y * t;
  q += head * D;
  k += head * D;
  v += head * D;
  out += head * D;
  lse += head;

  load_rows<BLOCK_M, D, THREADS>(qs, D, q, q0, t);

  float m[ROWS], l[ROWS], acc[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // causal: k tiles past this q tile's last row contribute exactly zero
  const int k_end = causal ? min(t, q0 + BLOCK_M) : t;
  const int num_k = (k_end + BLOCK_N - 1) / BLOCK_N;

  for (int kt = 0; kt < num_k; ++kt) {
    const int k0 = kt * BLOCK_N;
    __syncthreads();  // the previous tile's readers are done
    load_rows<BLOCK_N, D, THREADS>(ks, K_STRIDE, k, vs, D, v, k0, t);
    __syncthreads();

    // s = q · kᵀ for rows ty + 16 i, keys tx + 16 j
    float s[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[ROWS], kv[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = qs[(ty + 16 * i) * D + d];
#pragma unroll
      for (int j = 0; j < COLS; ++j) kv[j] = ks[(tx + 16 * j) * K_STRIDE + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax over this tile; p goes to shared memory for P · V
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int q_pos = q0 + ty + 16 * i;
      float tile_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (masked(q_pos, k_pos, t, causal)) x = NEG_INF;
        s[i][j] = x;
        tile_max = fmaxf(tile_max, x);
      }
      const float m_new = fmaxf(m[i], row_max(tile_max));
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * P_STRIDE + tx + 16 * j] = p;
        p_sum += p;
      }
      const float correction = expf(m[i] - m_new);
      l[i] = l[i] * correction + row_sum(p_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= correction;
    }
    __syncthreads();

    // acc += p · v for rows ty + 16 i, output columns tx + 16 c
#pragma unroll 4
    for (int n = 0; n < BLOCK_N; ++n) {
      float pv[ROWS], vv[DC];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = ps[(ty + 16 * i) * P_STRIDE + n];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vs[n * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int q_pos = q0 + ty + 16 * i;
    if (q_pos >= t) continue;
    const float l_fin = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store(out + (size_t)q_pos * D + tx + 16 * c, acc[i][c] / l_fin);
    if (tx == 0) lse[q_pos] = m[i] + logf(l_fin);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int bh, int t, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + BLOCK_M - 1) / BLOCK_M, bh);
  fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), t, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: [bh, t, d] contiguous, bf16 (is_bf16 = 1) or f32; lse: [bh, t]
// f32. Launches on `stream` without synchronising; returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a head_dim it was not built for).
extern "C" int raydp_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* out, void* lse,
                                         int bh, int t, int d, float scale,
                                         int causal, int is_bf16,
                                         void* stream) {
  if (bh < 1 || bh > 65535 || t < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_dtype(is_bf16, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return with_head_dim(d, [&](auto dim) {
      return launch<T, decltype(dim)::value>(q, k, v, out, lse, bh, t, scale,
                                             causal, s);
    });
  });
}
