// Pieces shared by the flash-attention kernels (flash_attention_fwd.cu and
// flash_attention_bwd.cu): the masking rule and its sentinel, the bf16/f32
// load and store helpers, the tile loader and the host-side dispatch over
// the compiled dtypes and head dims and the alignment check. Keeping one copy keeps the forward and
// the backward masking the same scores, as the reference's shared
// `_mask_causal` does (raydp_tpu/ops/flash_attention.py).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace raydp_fa {

constexpr float NEG_INF = -1e30f;  // the reference's _NEG_INF

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// A score (q_pos, k_pos) is dropped when its key lies past the sequence end
// or, under the causal mask, after its query.
__device__ __forceinline__ bool masked(int q_pos, int k_pos, int t,
                                       int causal) {
  return k_pos >= t || (causal && q_pos < k_pos);
}

// Rows [row0, row0 + ROWS) of a [t, D] matrix into shared memory as f32,
// row stride `stride`; rows past t read as zero. All NTHREADS threads call it.
template <int ROWS, int D, int NTHREADS, typename T>
__device__ __forceinline__ void load_rows(float* dst, int stride,
                                          const T* __restrict__ src, int row0,
                                          int t) {
  for (int i = threadIdx.x; i < ROWS * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    dst[r * stride + c] =
        row0 + r < t ? to_float(src[(size_t)(row0 + r) * D + c]) : 0.f;
  }
}

// The same rows of two matrices (k and v, or q and do) in one loop, so that
// each iteration has both global loads in flight: with one block of 8 warps
// per SM there is little else to hide their latency behind.
template <int ROWS, int D, int NTHREADS, typename T>
__device__ __forceinline__ void load_rows(float* dst_a, int stride_a,
                                          const T* __restrict__ a,
                                          float* dst_b, int stride_b,
                                          const T* __restrict__ b, int row0,
                                          int t) {
  for (int i = threadIdx.x; i < ROWS * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    const bool in = row0 + r < t;
    const size_t g = (size_t)(row0 + r) * D + c;
    dst_a[r * stride_a + c] = in ? to_float(a[g]) : 0.f;
    dst_b[r * stride_b + c] = in ? to_float(b[g]) : 0.f;
  }
}

// Host side: call f with a null T* for the kernel's element type ...
template <typename F>
cudaError_t with_dtype(int is_bf16, F&& f) {
  return is_bf16 ? f(static_cast<__nv_bfloat16*>(nullptr))
                 : f(static_cast<float*>(nullptr));
}

// ... and with std::integral_constant<int, D> for a compiled head_dim D
// (the Python wrappers' HEAD_DIMS); any other d is cudaErrorInvalidValue.
template <typename F>
cudaError_t with_head_dim(int d, F&& f) {
  switch (d) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

// cp.async copies 16 bytes at a time: the bf16 kernels need every [bh, t, d]
// tensor to start on a 16-byte boundary (as PyTorch's allocations do)
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

}  // namespace raydp_fa
