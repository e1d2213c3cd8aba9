// Shared-memory arena allocator: the C++ core of the object store.
//
// The reference's data plane is Ray's plasma store — a native (C++) shared-memory
// object store that Spark executors (JVM) and Python training workers map
// zero-copy (SURVEY.md §2.3 item 11; reference RayDPUtils.java:45-53 readBinary
// rehydrates an object from raw id + owner address). This file is the TPU build's
// native equivalent: one large POSIX shared-memory segment per session holding
// all object payloads, carved by a first-fit free-list allocator with block
// splitting and address-ordered coalescing. Python processes attach the segment
// once and read every object through zero-copy memoryview slices; writers
// allocate through rdt_alloc from any process (the free list is guarded by a
// process-shared robust mutex).
//
// Design constraints:
// - 64-byte block alignment: Arrow buffers want cache-line alignment, and it
//   keeps payloads aligned for the host-side staging copy into HBM transfers.
// - Robust mutex: if a writer process is SIGKILLed mid-allocation (actor crash,
//   fault-injection tests), the next locker gets EOWNERDEAD, marks the mutex
//   consistent, and continues; at worst a block leaks until session shutdown,
//   which unlinks the whole segment.
// - The metadata table (object id -> offset/size/kind/owner) deliberately lives
//   in the head process, not here: ownership/lineage policy changes often,
//   payload layout does not.

#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52445453544f5245ULL;  // "RDTSTORE"
constexpr uint32_t kBlockMagic = 0x424c4b21;        // "BLK!"
constexpr uint64_t kAlign = 64;

struct Header {
  uint64_t magic;
  uint64_t arena_size;
  uint64_t free_head;      // offset of first free block header; 0 = none
  uint64_t bytes_in_use;   // live payload bytes
  uint64_t num_allocs;     // live allocation count
  uint64_t peak_bytes;
  pthread_mutex_t lock;
  char pad_[kAlign];
};

struct BlockHdr {
  uint64_t size;  // payload capacity in bytes, multiple of kAlign
  uint64_t next;  // free-list link (offset of next free block) when free
  uint32_t free;
  uint32_t magic;
  char pad_[kAlign - 2 * sizeof(uint64_t) - 2 * sizeof(uint32_t)];
};
static_assert(sizeof(BlockHdr) == kAlign, "block header must be one cache line");

inline uint64_t align_up(uint64_t v, uint64_t a) { return (v + a - 1) & ~(a - 1); }

inline Header* hdr(void* base) { return reinterpret_cast<Header*>(base); }

inline BlockHdr* blk(void* base, uint64_t off) {
  return reinterpret_cast<BlockHdr*>(static_cast<char*>(base) + off);
}

inline uint64_t first_block_offset() { return align_up(sizeof(Header), kAlign); }

int lock_arena(Header* h) {
  int rc = pthread_mutex_lock(&h->lock);
  if (rc == EOWNERDEAD) {
    // A lock holder died mid-critical-section. Recover-and-continue policy:
    // the free list may have lost a block (leak), but links are written before
    // publication so traversal stays safe; the leak is bounded by session
    // lifetime (shutdown unlinks the segment).
    pthread_mutex_consistent(&h->lock);
    rc = 0;
  }
  return rc;
}

}  // namespace

extern "C" {

// Creates and maps a new arena segment. Returns the mapped base or null.
void* rdt_arena_create(const char* name, uint64_t size) {
  size = align_up(size, 4096);
  if (size < first_block_offset() + sizeof(BlockHdr) + kAlign) return nullptr;
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, static_cast<off_t>(size)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* base = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }

  Header* h = hdr(base);
  memset(h, 0, sizeof(Header));
  h->arena_size = size;

  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->lock, &attr);
  pthread_mutexattr_destroy(&attr);

  uint64_t first = first_block_offset();
  BlockHdr* b = blk(base, first);
  b->size = size - first - sizeof(BlockHdr);
  b->next = 0;
  b->free = 1;
  b->magic = kBlockMagic;
  h->free_head = first;
  h->magic = kMagic;  // published last: attachers check it
  return base;
}

// Attaches an existing arena. Returns the mapped base or null.
void* rdt_arena_attach(const char* name, uint64_t* size_out) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base =
      mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  if (hdr(base)->magic != kMagic) {
    munmap(base, st.st_size);
    return nullptr;
  }
  if (size_out) *size_out = static_cast<uint64_t>(st.st_size);
  return base;
}

// Allocates `size` payload bytes. Returns the payload offset, or -1 if the
// arena cannot satisfy the request (caller falls back to a dedicated segment).
int64_t rdt_alloc(void* base, uint64_t size) {
  Header* h = hdr(base);
  uint64_t need = align_up(size ? size : 1, kAlign);
  if (lock_arena(h) != 0) return -1;

  uint64_t prev = 0;
  uint64_t off = h->free_head;
  while (off != 0) {
    BlockHdr* b = blk(base, off);
    if (b->size >= need) {
      uint64_t remainder = b->size - need;
      if (remainder >= sizeof(BlockHdr) + kAlign) {
        // Split: tail of this block stays on the free list.
        uint64_t tail_off = off + sizeof(BlockHdr) + need;
        BlockHdr* tail = blk(base, tail_off);
        tail->size = remainder - sizeof(BlockHdr);
        tail->next = b->next;
        tail->free = 1;
        tail->magic = kBlockMagic;
        b->size = need;
        if (prev)
          blk(base, prev)->next = tail_off;
        else
          h->free_head = tail_off;
      } else {
        if (prev)
          blk(base, prev)->next = b->next;
        else
          h->free_head = b->next;
      }
      b->free = 0;
      b->next = 0;
      h->bytes_in_use += b->size;
      h->num_allocs += 1;
      if (h->bytes_in_use > h->peak_bytes) h->peak_bytes = h->bytes_in_use;
      pthread_mutex_unlock(&h->lock);
      return static_cast<int64_t>(off + sizeof(BlockHdr));
    }
    prev = off;
    off = b->next;
  }
  pthread_mutex_unlock(&h->lock);
  return -1;
}

// Frees the allocation whose payload starts at `payload_off`.
// Returns 0 on success, -1 on an invalid or double free.
int rdt_free(void* base, uint64_t payload_off) {
  Header* h = hdr(base);
  if (payload_off < first_block_offset() + sizeof(BlockHdr) ||
      payload_off >= h->arena_size)
    return -1;
  uint64_t off = payload_off - sizeof(BlockHdr);
  BlockHdr* b = blk(base, off);
  if (b->magic != kBlockMagic) return -1;
  if (lock_arena(h) != 0) return -1;
  if (b->free) {
    pthread_mutex_unlock(&h->lock);
    return -1;
  }
  h->bytes_in_use -= b->size;
  h->num_allocs -= 1;
  b->free = 1;

  // Address-ordered insert, then coalesce with both neighbours if adjacent.
  uint64_t prev = 0;
  uint64_t cur = h->free_head;
  while (cur != 0 && cur < off) {
    prev = cur;
    cur = blk(base, cur)->next;
  }
  b->next = cur;
  if (prev)
    blk(base, prev)->next = off;
  else
    h->free_head = off;

  if (cur != 0 && off + sizeof(BlockHdr) + b->size == cur) {
    BlockHdr* nb = blk(base, cur);
    b->size += sizeof(BlockHdr) + nb->size;
    b->next = nb->next;
    nb->magic = 0;
  }
  if (prev != 0) {
    BlockHdr* pb = blk(base, prev);
    if (prev + sizeof(BlockHdr) + pb->size == off) {
      pb->size += sizeof(BlockHdr) + b->size;
      pb->next = b->next;
      b->magic = 0;
    }
  }
  pthread_mutex_unlock(&h->lock);
  return 0;
}

// out[0..3] = arena_size, bytes_in_use, live allocation count, peak bytes.
void rdt_stats(void* base, uint64_t* out) {
  Header* h = hdr(base);
  if (lock_arena(h) != 0) {
    out[0] = out[1] = out[2] = out[3] = 0;
    return;
  }
  out[0] = h->arena_size;
  out[1] = h->bytes_in_use;
  out[2] = h->num_allocs;
  out[3] = h->peak_bytes;
  pthread_mutex_unlock(&h->lock);
}

int rdt_detach(void* base) {
  return munmap(base, hdr(base)->arena_size);
}

int rdt_unlink(const char* name) { return shm_unlink(name); }

}  // extern "C"
