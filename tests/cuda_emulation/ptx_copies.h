// Host stand-ins for hopper_mma.cuh's "PTX: copies, fences, waits" section.
struct EmuCopy {
  uint32_t dst;
  const void* src;
  int bytes;
  bool in;
};
inline thread_local std::vector<EmuCopy> emu_open;               // uncommitted
inline thread_local std::deque<std::vector<EmuCopy>> emu_groups;  // committed

inline void emu_land(const EmuCopy& c) {
  if (c.dst % c.bytes || c.dst + c.bytes > emu_smem_size) {
    fprintf(stderr, "cp.async to shared offset %u out of place\n", c.dst);
    abort();
  }
  if (c.in)
    memcpy(emu_smem + c.dst, c.src, c.bytes);
  else
    memset(emu_smem + c.dst, 0, c.bytes);
}
inline void emu_copy(const EmuCopy& c) {
  if (emu_copy_mode == 0)
    emu_land(c);
  else
    emu_open.push_back(c);
}
inline uint32_t smem_addr(const void* p) {
  return (uint32_t)((const uint8_t*)p - emu_smem);
}
inline void cp_async16(uint32_t dst, const void* src, bool in) {
  emu_copy({dst, src, 16, in});
}
inline void cp_async4(uint32_t dst, const void* src, bool in) {
  emu_copy({dst, src, 4, in});
}
inline void cp_async_commit() {
  emu_groups.push_back(std::move(emu_open));
  emu_open.clear();
}
template <int N>
inline void cp_async_wait() {
  while ((int)emu_groups.size() > N) {
    for (const EmuCopy& c : emu_groups.front()) emu_land(c);
    emu_groups.pop_front();
  }
}
inline void fence_async_smem() {}
inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N>
inline void wgmma_wait() {}
template <int N>
inline void fence_regs(float (&)[N]) {}
template <int N>
inline void fence_regs(uint32_t (&)[N][4]) {}

