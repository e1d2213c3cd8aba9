// Flash-attention forward for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (raydp_tpu/ops/flash_attention.py,
// launched by `_fwd_pallas`). Same function: q, k, v [BH, T, D] (bf16 or f32)
// -> out [BH, T, D] in the input type and lse [BH, T] in f32, by the online
// softmax (running max m, normaliser l, accumulator acc, all f32), with the
// causal mask q_pos >= k_pos, the -1e30 sentinel for masked scores,
// out = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)).
//
// The TPU walks k blocks as the innermost *sequential* grid axis and carries
// m/l/acc in VMEM scratch across grid steps. Hopper's blocks run in parallel
// and in no order, so here a thread block owns a tile of queries and walks
// the k tiles in a loop of its own, with m, l and acc in registers. A causal
// q tile stops at the diagonal k tile (the TPU's causal block skip); q tiles
// are issued last-first so the long causal walks start early. Rows and keys
// past T are zero-filled on load and masked inside the kernel, so any T is
// taken and no caller needs a fallback for ragged shapes.
//
// bf16 (the model's path): tensor cores, `tc::fwd_tc_kernel<D>`. A block is
// two warpgroups, each owning 64 queries, so 128 a block; the q tile is
// loaded once into shared memory, k and v tiles of WALK_K = 128 keys come
// through a two-slot ring filled by cp.async, one tile ahead of the
// products.
// Tiles are bf16 in wgmma's swizzled layout (hopper_mma.cuh). s = q kᵀ is a
// wgmma m64nWALK_Kk16 product (q and k K-major); the online softmax runs on
// the accumulator registers (a row's columns lie on four lanes: two xor
// shuffles give its max); p, rounded to bf16 as the Pallas kernel rounds it
// (`p.astype(v.dtype)`), is the register A operand of o += p v (m64nDk16, v
// read MN-major), with no trip through shared memory. l sums the unrounded
// f32 p, as the Pallas kernel does. The mask is applied only on tiles that
// cross the diagonal or the sequence end. Per thread at D = 128: o 64 f32
// registers, s 64, p 32 as bf16 pairs; ptxas fits it in 208 with no
// spills. Of the tiles tried (measured, PERF.md), 128 keys walked through
// two or three slots tie and beat 64 keys through three (~10 %) or two.
//
// f32: the CUDA-core kernel `fwd_kernel<float, D>` (the first port's design,
// kept because f32 on the tensor cores would be TF32, which the f32 limit of
// 1e-4 does not admit): 256 threads own a 64-row tile, tiles sit in shared
// memory as f32 with padded rows, both products are FMA and p stays f32.
//
// Bound. At the flagship shape (B=2, H=8, T=8192, D=128, bf16, causal) one
// call does 4*B*H*D*T(T+1)/2 ~ 2.75e11 FLOP against 134 MB of q/k/v/out:
// compute bound, ~0.28 ms at the 989 TFLOP/s bf16 tensor-core peak. What
// this design leaves: each warpgroup waits for its own s product before the
// softmax and for its p v product before the next tile (no ping-pong
// between warpgroups, no overlap of the softmax with the next s product),
// the consumers issue their own copies (no producer warp, no TMA), and the
// diagonal tiles are computed whole.

#include <math.h>

#include <cstdint>

#include "flash_attention_common.cuh"
#include "hopper_mma.cuh"

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

// ---------------------------------------------------------------------------
// bf16: warpgroup tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using raydp_sm90::TileLayout;
using raydp_sm90::Wgmma;

constexpr int WG = 128;               // threads of a warpgroup
constexpr int THREADS = 2 * WG;       // two consumer warpgroups a block
constexpr int ROWS = 64;              // queries of one warpgroup
constexpr int OWNED = 2 * ROWS;       // queries of a block
constexpr int WALK_K = 128;           // keys a step walks
constexpr int STAGES = 2;             // ring of k and v tiles
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory: the q tile of OWNED rows, then STAGES slots of a k and a v
// tile of WALK_K rows; 1024 bytes of slack to align the start to a swizzle
// period.
template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + TileLayout<D>::bytes(OWNED) +
         STAGES * 2 * TileLayout<D>::bytes(WALK_K);
}

// out and lse of OWNED queries per block: warpgroup w owns queries q0 + 64 w
// and walks the k tiles. Per k tile: s = q kᵀ (queries as M, k as K-major
// B), the online-softmax step on the accumulator, then o += p v with p
// rounded to bf16 as the register A operand (v as MN-major B).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out,
                  float* __restrict__ lse, int t, float scale, int causal) {
  using namespace raydp_sm90;
  constexpr int KS = WALK_K / 16;        // k16 steps of p v over a k tile
  constexpr int TILE = TileLayout<D>::bytes(WALK_K);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem;
  const uint32_t qs = aligned_smem(smem_raw, &smem);
  const uint32_t ring = qs + TileLayout<D>::bytes(OWNED);

  const int tid = threadIdx.x % WG;
  // q tiles last-first: under the causal mask the last walk the most k tiles
  const int q0 = (gridDim.x - 1 - blockIdx.x) * OWNED;
  const int wq0 = q0 + ROWS * (threadIdx.x / WG);  // this warpgroup's queries
  const size_t head = (size_t)blockIdx.y * t;
  q += head * D;
  k += head * D;
  v += head * D;
  out += head * D;
  lse += head;

  // causal: k tiles past this block's last query contribute exactly zero
  const int k_end = causal ? min(t, q0 + OWNED) : t;
  const int steps = (k_end + WALK_K - 1) / WALK_K;
  auto fetch = [&](int step) {           // k and v of one k tile
    if (step < steps) {
      const uint32_t kt = ring + (step % STAGES) * 2 * TILE;
      load_tile_async<D, WALK_K, THREADS>(kt, k, step * WALK_K, t);
      load_tile_async<D, WALK_K, THREADS>(kt + TILE, v, step * WALK_K, t);
    }
    cp_async_commit();                   // an empty group keeps the count
  };
  load_tile_async<D, OWNED, THREADS>(qs, q, q0, t);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);

  // Scores are kept in log2 units (scale log2(e) folded in, exp2): m is the
  // running max of this thread's two rows (acc_row, h = (i >> 1) & 1), the
  // same on the four lanes of a row; l is this lane's share of the row's
  // normaliser, summed over the four lanes once at the end.
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float scale_log2 = scale * LOG2E;
  const int qrow = wq0 - q0;             // this warpgroup's rows of q

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();         // this step's tiles have landed
    fence_async_smem();
    __syncthreads();                     // ... for every thread; the slot of
    fetch(step + STAGES - 1);            // step - 1 is free to refill
    const int k0 = step * WALK_K;
    // all of this tile's keys after all of this warpgroup's queries, or no
    // query of the warpgroup below t: nothing to add
    if ((causal && k0 > wq0 + ROWS - 1) || wq0 >= t) continue;

    const uint32_t kt = ring + (step % STAGES) * 2 * TILE;
    const uint32_t vt = kt + TILE;

    float s[WALK_K / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<WALK_K>::ss(s, desc_k_major<D>(qs, OWNED, qrow, kk),
                        desc_k_major<D>(kt, WALK_K, 0, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // a key past t or (causal) after its query gets the -1e30 sentinel
    // before the row max. Every row's first tile holds key 0, so no row is
    // wholly masked; query rows past t (q zero-filled) are never stored.
    const bool edge = (causal && k0 + WALK_K - 1 > wq0) || k0 + WALK_K > t;
    float m_new[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < WALK_K / 2; ++i) {
      float x = s[i] * scale_log2;
      if (edge) {
        const int qp = wq0 + acc_row(tid, i), key = k0 + acc_col(tid, i);
        if (key >= t || (causal && qp < key)) x = NEG_INF;
      }
      s[i] = x;
      m_new[(i >> 1) & 1] = fmaxf(m_new[(i >> 1) & 1], x);
    }
    float correction[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_new[h] = quad_max(m_new[h]);
      correction[h] = exp2f(m[h] - m_new[h]);
      m[h] = m_new[h];
      l[h] *= correction[h];
    }
#pragma unroll
    for (int i = 0; i < WALK_K / 2; ++i) {
      s[i] = exp2f(s[i] - m[(i >> 1) & 1]);   // p, f32
      l[(i >> 1) & 1] += s[i];
    }
    // The previous tile's o += p v was waited for (wgmma_wait<0>) and its
    // registers pinned (fence_regs) at the end of its step, so no product
    // in flight writes o while it is rescaled here; wgmma_fence then orders
    // these register writes before the next product reads o.
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= correction[(i >> 1) & 1];

    uint32_t pf[KS][4];                  // p rounded to bf16
    acc_to_frags<KS>(s, pf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Wgmma<D>::rs(o, pf[kk], desc_mn_major<D>(vt, WALK_K, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();                     // before the slot may be refilled
    fence_regs(o);
    fence_regs(pf);
  }

  float l_fin[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) l_fin[h] = fmaxf(quad_sum(l[h]), 1e-30f);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = o[i] / l_fin[(i >> 1) & 1];
  store_rows<D>(out, o, wq0, t, tid);
  if (tid % 4 == 0)                      // one lane of each row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wq0 + acc_row(tid, 2 * h);
      if (row < t) lse[row] = m[h] / LOG2E + logf(l_fin[h]);
    }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int bh, int t, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + OWNED - 1) / OWNED, bh);
  fwd_tc_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), t, scale, causal);
  return cudaGetLastError();
}

}  // namespace tc

// bf16 goes to the tensor-core kernel, f32 to the CUDA-core one
template <typename T, int D>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     void* lse, int bh, int t, float scale, int causal,
                     cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return tc::launch<D>(q, k, v, out, lse, bh, t, scale, causal, stream);
  else
    return launch<T, D>(q, k, v, out, lse, bh, t, scale, causal, stream);
}

}  // namespace

// q, k, v, out: [bh, t, d] contiguous, bf16 (is_bf16 = 1) or f32; lse: [bh, t]
// f32. Launches on `stream` without synchronising; returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a head_dim it was not built for
// or a bad bh / t, cudaErrorMisalignedAddress for a bf16 tensor off a 16-byte
// boundary).
extern "C" int raydp_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* out, void* lse,
                                         int bh, int t, int d, float scale,
                                         int causal, int is_bf16,
                                         void* stream) {
  if (bh < 1 || bh > 65535 || t < 1) return (int)cudaErrorInvalidValue;
  if (is_bf16 && !aligned16({q, k, v, out}))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_dtype(is_bf16, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return with_head_dim(d, [&](auto dim) {
      return dispatch<T, decltype(dim)::value>(q, k, v, out, lse, bh, t,
                                               scale, causal, s);
    });
  });
}
