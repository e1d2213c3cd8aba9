// Host stand-in for hopper_mma.cuh's "PTX: m64nNk16 warpgroup products"
// section: each operand is read from shared memory through its descriptor
// by the canonical layouts of wgmma's swizzle modes, independently of the
// TileLayout arithmetic that wrote the tiles (the swizzle XORs address bits
// [7, 7 + b) into bits [4, 4 + b), b = log2(row bytes / 16)).
struct EmuDesc {
  uint32_t start, lbo, sbo, row_bytes, bits;
};
inline EmuDesc emu_decode(uint64_t d) {
  const int mode = (int)(d >> 62);
  if (mode == 0 || ((d >> 49) & 7)) {
    fprintf(stderr, "descriptor with no swizzle mode or a base offset\n");
    abort();
  }
  return {(uint32_t)(d & 0x3FFF) << 4, (uint32_t)((d >> 16) & 0x3FFF) << 4,
          (uint32_t)((d >> 32) & 0x3FFF) << 4,
          mode == 1 ? 128u : mode == 2 ? 64u : 32u,
          mode == 1 ? 3u : mode == 2 ? 2u : 1u};
}
inline float emu_load(const EmuDesc& e, uint32_t addr) {
  addr ^= ((addr >> 7) & ((1u << e.bits) - 1)) << 4;
  if (addr + 2 > emu_smem_size) {
    fprintf(stderr, "wgmma operand read past shared memory\n");
    abort();
  }
  __nv_bfloat16 h;
  memcpy(&h, emu_smem + addr, 2);
  return __bfloat162float(h);
}
// K-major: groups of 8 rows (M or N) SBO apart, rows one swizzle row apart,
// the 16 k elements contiguous
inline float emu_k_major(uint64_t desc, int mn, int k) {
  const EmuDesc e = emu_decode(desc);
  return emu_load(e, e.start + (mn / 8) * e.sbo + (mn % 8) * e.row_bytes +
                         2 * k);
}
// MN-major: MN contiguous within a swizzle row, atoms along MN LBO apart; k
// rows one swizzle row apart, groups of 8 k rows SBO apart
inline float emu_mn_major(uint64_t desc, int mn, int k) {
  const EmuDesc e = emu_decode(desc);
  const int atom = e.row_bytes / 2;
  return emu_load(e, e.start + (mn / atom) * e.lbo + (mn % atom) * 2 +
                         (k / 8) * e.sbo + (k % 8) * e.row_bytes);
}
inline uint32_t emu_frags[8][128][4];  // register A operands of a warpgroup
inline float emu_half(uint32_t v, int hi) {
  return __bfloat162float(__nv_bfloat16{(uint16_t)(hi ? v >> 16 : v)});
}

template <int N>
struct Wgmma {
  static void ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                 int accumulate) {
    const int tid = threadIdx.x % 128;
    for (int i = 0; i < N / 2; ++i) {
      const int r = acc_row(tid, i), c = acc_col(tid, i);
      float s = 0.f;
      for (int k = 0; k < 16; ++k)
        s += emu_k_major(desc_a, r, k) * emu_k_major(desc_b, c, k);
      d[i] = (accumulate ? d[i] : 0.f) + s;
    }
  }
  static void rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b,
                 int accumulate) {
    const int tid = threadIdx.x % 128, wg = threadIdx.x / 128;
    for (int j = 0; j < 4; ++j) emu_frags[wg][tid][j] = a[j];
    emu_wg_barrier[wg]->arrive_and_wait();
    float A[64][16];
    for (int t = 0; t < 128; ++t)
      for (int j = 0; j < 4; ++j)
        for (int h = 0; h < 2; ++h)
          A[frag_row(t, j)][frag_col(t, j) + h] =
              emu_half(emu_frags[wg][t][j], h);
    emu_wg_barrier[wg]->arrive_and_wait();
    for (int i = 0; i < N / 2; ++i) {
      const int r = acc_row(tid, i), c = acc_col(tid, i);
      float s = 0.f;
      for (int k = 0; k < 16; ++k) s += A[r][k] * emu_mn_major(desc_b, c, k);
      d[i] = (accumulate ? d[i] : 0.f) + s;
    }
  }
};

