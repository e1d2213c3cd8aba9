// Host emulation of the CUDA subset the port's kernels use, for g++ -std=c++20:
// qualifiers, launch geometry, bf16 conversions, __syncthreads and the
// <<<grid, block, smem, stream>>> launch (rewritten to emu_launch by
// tests/test_torch_cuda_emulation.py). A block runs as blockDim.x
// std::threads (any number of whole warps); blocks run one after another,
// each on fresh shared memory filled with a garbage byte pattern.
// __shfl_xor_sync exchanges values among the 32 threads of a warp through
// slots and a per-warp barrier, so every lane of the warp must call it, as
// the full mask demands on the card.
#pragma once

#include <math.h>

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <thread>
#include <type_traits>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct emu_uint3 {
  unsigned x, y, z;
};
inline thread_local emu_uint3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;

using cudaError_t = int;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1,
              cudaErrorMisalignedAddress = 716;
using cudaStream_t = void*;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
using std::max;
using std::min;

struct __nv_bfloat16 {
  uint16_t x;
};
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};
inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = (uint32_t)h.x << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {  // round to nearest even
  uint32_t u;
  memcpy(&u, &f, 4);
  u += 0x7FFF + ((u >> 16) & 1);
  return __nv_bfloat16{(uint16_t)(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }

inline uint8_t* emu_smem;  // the running block's shared memory
inline size_t emu_smem_size;
inline std::barrier<>* emu_block_barrier;
inline std::barrier<>* emu_wg_barrier[8];  // one per warpgroup of 128
// 0: a cp.async lands at once, 1: when its group is waited for. The
// two runs catch a slot refilled while still read and a tile read before
// its copy was waited for.
inline int emu_copy_mode = 0;
extern "C" void emu_set_copy_mode(int mode) { emu_copy_mode = mode; }

inline std::barrier<>* emu_warp_barrier[32];  // one per warp of 32
inline float emu_shfl_slot[32][32];              // [warp][lane]

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }

inline float __shfl_xor_sync(unsigned mask, float x, int lane_mask) {
  if (mask != 0xffffffffu) {
    fprintf(stderr, "__shfl_xor_sync emulated for the full mask only\n");
    abort();
  }
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  emu_shfl_slot[w][lane] = x;
  emu_warp_barrier[w]->arrive_and_wait();    // every lane has written
  const float y = emu_shfl_slot[w][lane ^ lane_mask];
  emu_warp_barrier[w]->arrive_and_wait();    // every lane has read
  return y;
}

template <class K, class... A>
void emu_launch(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t,
                A... args) {
  if (threads % 32 || threads > 1024) {
    fprintf(stderr, "emulated block of %d threads: whole warps only\n",
            threads);
    abort();
  }
  gridDim = grid;
  blockDim = dim3(threads);
  std::vector<uint8_t> buf(smem + 2048);
  uint8_t* base =
      (uint8_t*)(((uintptr_t)buf.data() + 1023) & ~(uintptr_t)1023);
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      memset(base, 0xAB, smem);
      emu_smem = base;
      emu_smem_size = smem;
      std::barrier<> block(threads);
      emu_block_barrier = &block;
      std::vector<std::unique_ptr<std::barrier<>>> groups;
      for (int w = 0; w < (threads + 127) / 128; ++w) {
        groups.emplace_back(new std::barrier<>(std::min(128, threads)));
        emu_wg_barrier[w] = groups.back().get();
      }
      for (int w = 0; w < threads / 32; ++w) {
        groups.emplace_back(new std::barrier<>(32));
        emu_warp_barrier[w] = groups.back().get();
      }
      std::vector<std::thread> pool;
      for (int t = 0; t < threads; ++t)
        pool.emplace_back([&, t] {
          threadIdx = {(unsigned)t, 0, 0};
          blockIdx = {bx, by, 0};
          kernel(args...);
        });
      for (auto& t : pool) t.join();
    }
}
