// Building blocks for tensor-core kernels on Hopper (sm_90a): bf16 tiles in
// swizzled shared memory filled by cp.async, wgmma matrix descriptors over
// them, the warpgroup products themselves and the fragment layout of their
// accumulators. Used by the bf16 forward (flash_attention_fwd.cu) and
// backward (flash_attention_bwd.cu) kernels.
//
// Tile layout. A [rows, D] bf16 tile (D in 16, 32, 64, 128) is stored as
// D / PW column panels of PW = min(D, 64) columns; panel p holds columns
// [p PW, (p + 1) PW) of every row, RB = 2 PW bytes a row (32, 64 or 128).
// Inside a panel the 16-byte chunks of row r are XOR-swizzled with bits of
// the row, which is the canonical layout of wgmma's 32-, 64- or 128-byte
// swizzle mode (CUTLASS's Swizzle<log2(RB / 16), 4, 3>): chunk c of row r
// lies at chunk c ^ ((r RB / 128) mod (RB / 16)). The same tile serves as a
// K-major operand (the product runs over D) and as an MN-major one (the
// product runs over the rows, D is the output width). Tiles start on
// 1024-byte boundaries, the period of every swizzle mode.
//
// The index arithmetic (tile offsets, descriptors, accumulator and fragment
// maps) is in __host__ __device__ functions that a host build can check;
// the two sections marked PTX compile for the device only, and the host
// emulation (tests/test_torch_cuda_emulation.py) swaps exactly those two,
// found by their headings, for stand-ins.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace raydp_sm90 {

// --- layout, descriptors, fragments (host and device) ---------------------

template <int D>
struct TileLayout {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head dim");
  static constexpr int PW = D < 64 ? D : 64;   // panel width, elements
  static constexpr int RB = 2 * PW;            // bytes of a panel row
  static constexpr int CHUNKS = RB / 16;       // 16-byte chunks a panel row
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte
  static constexpr uint64_t SWIZZLE_MODE = RB == 128 ? 1 : RB == 64 ? 2 : 3;

  __host__ __device__ static constexpr int swizzle(int r) {
    return (r * RB / 128) & (CHUNKS - 1);
  }
  // byte offset of element (r, c) in a tile of `rows` rows
  __host__ __device__ static constexpr int offset(int rows, int r, int c) {
    return (c / PW) * rows * RB + r * RB +
           (((c % PW) / 8) ^ swizzle(r)) * 16 + (c % 8) * 2;
  }
  __host__ __device__ static constexpr int bytes(int rows) {
    return rows * D * 2;
  }
};

// A shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode in bits 62-63
__host__ __device__ constexpr uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                                 uint32_t sbo, uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (mode << 62);
}

// The tile at shared address `tile` (`rows` rows) as a K-major operand: 64
// rows from `row0` (a multiple of 8), columns [16 kk, 16 kk + 16) of D.
// Eight rows of a panel make one swizzle atom; the next lies 8 RB bytes on.
template <int D>
__host__ __device__ constexpr uint64_t desc_k_major(uint32_t tile, int rows,
                                                    int row0, int kk) {
  using L = TileLayout<D>;
  return make_desc(tile + (16 * kk / L::PW) * rows * L::RB + row0 * L::RB +
                       (16 * kk % L::PW) * 2,
                   16, 8 * L::RB, L::SWIZZLE_MODE);
}

// The tile as an MN-major operand of a product over its rows: rows
// [16 kk, 16 kk + 16) as K, all D columns as N. Along N the atoms are the
// panels (leading offset rows RB), along K groups of 8 rows (stride 8 RB).
template <int D>
__host__ __device__ constexpr uint64_t desc_mn_major(uint32_t tile, int rows,
                                                     int kk) {
  using L = TileLayout<D>;
  return make_desc(tile + 16 * kk * L::RB, rows * L::RB, 8 * L::RB,
                   L::SWIZZLE_MODE);
}

// The accumulator of an m64nN wgmma: thread `tid` (0..127 in its
// warpgroup) holds N / 2 floats; element i sits at (row, col) below. The
// same map is mma.sync's m16n8 C fragment, one warp per 16 rows.
__host__ __device__ constexpr int acc_row(int tid, int i) {
  return 16 * (tid / 32) + (tid % 32) / 4 + 8 * ((i >> 1) & 1);
}
__host__ __device__ constexpr int acc_col(int tid, int i) {
  return 8 * (i >> 2) + 2 * (tid % 4) + (i & 1);
}
// An m64k16 A fragment from registers: a[j] packs two bf16 at (row, col),
// (row, col + 1) of the 64 x 16 slice. Accumulator elements 8 kk + 2 j and
// 8 kk + 2 j + 1 sit exactly there in the kk-th 16-column slice, so a
// product's accumulator feeds the next product as A with no data movement
// (acc_to_frags).
__host__ __device__ constexpr int frag_row(int tid, int j) {
  return 16 * (tid / 32) + (tid % 32) / 4 + 8 * (j & 1);
}
__host__ __device__ constexpr int frag_col(int tid, int j) {
  return 8 * (j >> 1) + 2 * (tid % 4);
}

// --- PTX: copies, fences, waits (device only) -----------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without a register round trip; when !in, no
// bytes are read and the destination is filled with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// make this thread's completed shared-memory writes (cp.async, st.shared)
// visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// order this warpgroup's register writes before the wgmma that follow
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin registers that an asynchronous wgmma reads or writes: the compiler
// may neither read them early nor reuse them before the wait they follow
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// --- composed helpers (device) --------------------------------------------

// Rows [row0, row0 + ROWS) of a [t, D] bf16 matrix into a tile at `dst`
// (TileLayout<D>), 16 bytes per cp.async, neighbouring threads on
// neighbouring chunks of a row; rows past t are zero-filled. All NTHREADS
// threads call it; the caller commits.
template <int D, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile_async(
    uint32_t dst, const __nv_bfloat16* __restrict__ src, int row0, int t) {
  constexpr int PER_ROW = D / 8;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += NTHREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    const bool in = row0 + r < t;
    cp_async16(dst + TileLayout<D>::offset(ROWS, r, c),
               src + (size_t)(in ? row0 + r : 0) * D + c, in);
  }
}

// The 1024-byte aligned start of the dynamic shared memory at `raw`: its
// shared address, and its generic pointer in *generic
__device__ __forceinline__ uint32_t aligned_smem(uint8_t* raw,
                                                 uint8_t** generic) {
  const uint32_t a = smem_addr(raw);
  const uint32_t aligned = (a + 1023) & ~1023u;
  *generic = raw + (aligned - a);
  return aligned;
}

// Store an m64 x D f32 accumulator of a warpgroup as bf16 rows
// [row0, row0 + 64) of a [t, D] matrix, rows past t dropped.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ dst,
                                           const float (&acc)[D / 2],
                                           int row0, int t, int tid) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = row0 + acc_row(tid, i);
    if (row < t)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * D +
                                         acc_col(tid, i)) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

// Max and sum over one accumulator row: its columns lie on the four lanes
// with the same tid / 4 (acc_row, acc_col), two xor steps apart. Every lane
// of the warp calls them.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// accumulator elements (x, y) -> one register of two bf16, x in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  uint32_t bits;
  memcpy(&bits, &v, sizeof(bits));
  return bits;
}

// The m64 x n(16 KS) accumulator `acc` rounded to bf16 as KS m64k16 A
// fragments (see frag_row / frag_col)
template <int KS>
__device__ __forceinline__ void acc_to_frags(const float (&acc)[8 * KS],
                                             uint32_t (&frag)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      frag[kk][j] = pack_bf16(acc[8 * kk + 2 * j], acc[8 * kk + 2 * j + 1]);
}

// --- PTX: m64nNk16 warpgroup products, f32 += bf16 x bf16 (device only) ---

template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // d[8] (+)= A · B over one k16 step, A and B from shared memory, both
  // K-major (d is overwritten when accumulate == 0)
  __device__ __forceinline__ static void ss(float (&d)[8], uint64_t desc_a,
                                            uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16\n{"
        "%0, %1, %2, %3, %4, %5, %6, %7},\n"
        "%8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  }
  // the same with A from registers (the m64k16 fragment, a[4] per thread)
  // and B from shared memory, MN-major
  __device__ __forceinline__ static void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16\n{"
        "%0, %1, %2, %3, %4, %5, %6, %7},\n"
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<32> {
  // d[16] (+)= A · B over one k16 step, A and B from shared memory, both
  // K-major (d is overwritten when accumulate == 0)
  __device__ __forceinline__ static void ss(float (&d)[16], uint64_t desc_a,
                                            uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16\n{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        "%10, %11, %12, %13, %14, %15},\n"
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  }
  // the same with A from registers (the m64k16 fragment, a[4] per thread)
  // and B from shared memory, MN-major
  __device__ __forceinline__ static void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16\n{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        "%10, %11, %12, %13, %14, %15},\n"
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<64> {
  // d[32] (+)= A · B over one k16 step, A and B from shared memory, both
  // K-major (d is overwritten when accumulate == 0)
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t desc_a,
                                            uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        "%30, %31},\n"
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  }
  // the same with A from registers (the m64k16 fragment, a[4] per thread)
  // and B from shared memory, MN-major
  __device__ __forceinline__ static void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        "%30, %31},\n"
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<128> {
  // d[64] (+)= A · B over one k16 step, A and B from shared memory, both
  // K-major (d is overwritten when accumulate == 0)
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t desc_a,
                                            uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63},\n"
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  }
  // the same with A from registers (the m64k16 fragment, a[4] per thread)
  // and B from shared memory, MN-major
  __device__ __forceinline__ static void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63},\n"
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate));
  }
};

}  // namespace raydp_sm90
