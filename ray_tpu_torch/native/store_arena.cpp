// Shared-memory arena allocator for the per-node object store.
//
// reference parity: the native core of the plasma store —
// object_manager/plasma/plasma_allocator.h:41 (PlasmaAllocator over a
// dlmalloc arena inside one mmap'd shm region) + shared_memory.h mmap
// plumbing. Every process on the node maps ONE arena file; object
// payloads are (offset, size) slices handed out by this allocator, so
// client reads are zero-copy and creating an object costs an
// allocation, not a file create + per-object mmap.
//
// Design: boundary-tag first-fit allocator with coalescing.
//   [ArenaHeader | block | block | ... ]
//   block := BlockHeader{ size, prev_size, flags } payload
// All offsets are relative to the arena base so any process can attach
// at any address. A process-shared robust pthread mutex in the header
// serializes allocator metadata updates across processes.
//
// C ABI (ctypes): arena_init, arena_attach, arena_detach, arena_alloc,
// arena_free, arena_used, arena_capacity, arena_check.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52544153544f5245ULL;  // "RTASTORE"
constexpr uint64_t kAlign = 64;                     // cache-line payloads
constexpr uint32_t kFree = 1u;

struct ArenaHeader {
  uint64_t magic;
  uint64_t capacity;      // bytes of block space after the header
  uint64_t used;          // allocated payload+header bytes
  uint64_t header_size;   // offset of the first block
  pthread_mutex_t lock;   // process-shared, robust
};

struct BlockHeader {
  uint64_t size;       // payload size (aligned)
  uint64_t prev_size;  // payload size of the previous block (0 = first)
  uint32_t flags;      // kFree
  uint32_t pad;
  // pad the header to one cache line so PAYLOADS are 64-byte aligned —
  // numpy/jax zero-copy views want aligned bases
  uint8_t pad2[40];
};

static_assert(sizeof(BlockHeader) == 64, "payload alignment");
constexpr uint64_t kBH = sizeof(BlockHeader);

struct Arena {
  ArenaHeader* hdr;
  uint8_t* base;       // == (uint8_t*)hdr
  uint64_t mapped;
  int fd;
};

inline uint64_t align_up(uint64_t v, uint64_t a) {
  return (v + a - 1) & ~(a - 1);
}

inline BlockHeader* block_at(Arena* a, uint64_t off) {
  return reinterpret_cast<BlockHeader*>(a->base + off);
}

inline uint64_t first_block(Arena* a) { return a->hdr->header_size; }

inline uint64_t end_of_blocks(Arena* a) {
  return a->hdr->header_size + a->hdr->capacity;
}

inline uint64_t next_off(Arena* a, uint64_t off) {
  return off + kBH + block_at(a, off)->size;
}

void lock(Arena* a) {
  int rc = pthread_mutex_lock(&a->hdr->lock);
  if (rc == EOWNERDEAD) {
    // A holder died mid-critical-section; metadata is still consistent
    // for our single-writer server usage — make the mutex usable again.
    pthread_mutex_consistent(&a->hdr->lock);
  }
}

void unlock(Arena* a) { pthread_mutex_unlock(&a->hdr->lock); }

}  // namespace

extern "C" {

// Create + initialize an arena file of `capacity` payload bytes.
// Returns 0 on success.
int arena_init(const char* path, uint64_t capacity) {
  uint64_t header = align_up(sizeof(ArenaHeader), kAlign);
  capacity = align_up(capacity, kAlign);
  uint64_t total = header + capacity;
  int fd = open(path, O_RDWR | O_CREAT | O_TRUNC, 0600);
  if (fd < 0) return -1;
  if (ftruncate(fd, (off_t)total) != 0) {
    close(fd);
    return -2;
  }
  void* mem = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED,
                   fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    return -3;
  }
  auto* hdr = static_cast<ArenaHeader*>(mem);
  hdr->capacity = capacity;
  hdr->used = 0;
  hdr->header_size = header;

  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&hdr->lock, &attr);
  pthread_mutexattr_destroy(&attr);

  // one giant free block spanning the whole payload region
  auto* first = reinterpret_cast<BlockHeader*>(
      static_cast<uint8_t*>(mem) + header);
  first->size = capacity - kBH;
  first->prev_size = 0;
  first->flags = kFree;
  hdr->magic = kMagic;  // last: attachers spin on it
  munmap(mem, total);
  close(fd);
  return 0;
}

// Attach this process to an initialized arena. Returns a handle.
void* arena_attach(const char* path) {
  int fd = open(path, O_RDWR);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  auto* hdr = static_cast<ArenaHeader*>(mem);
  if (hdr->magic != kMagic) {
    munmap(mem, (size_t)st.st_size);
    close(fd);
    return nullptr;
  }
  auto* a = new Arena{hdr, static_cast<uint8_t*>(mem),
                      (uint64_t)st.st_size, fd};
  return a;
}

void arena_detach(void* handle) {
  auto* a = static_cast<Arena*>(handle);
  if (!a) return;
  munmap(a->base, a->mapped);
  close(a->fd);
  delete a;
}

// Allocate `size` payload bytes; returns the payload offset from the
// arena base, or 0 when no block fits (0 is never a valid payload
// offset — the header precedes all blocks).
uint64_t arena_alloc(void* handle, uint64_t size) {
  auto* a = static_cast<Arena*>(handle);
  size = align_up(size ? size : 1, kAlign);
  lock(a);
  uint64_t off = first_block(a);
  uint64_t end = end_of_blocks(a);
  while (off < end) {
    BlockHeader* b = block_at(a, off);
    if ((b->flags & kFree) && b->size >= size) {
      uint64_t remainder = b->size - size;
      if (remainder > kBH + kAlign) {
        // split: tail stays free
        b->size = size;
        uint64_t tail_off = off + kBH + size;
        BlockHeader* tail = block_at(a, tail_off);
        tail->size = remainder - kBH;
        tail->prev_size = size;
        tail->flags = kFree;
        uint64_t after = tail_off + kBH + tail->size;
        if (after < end) block_at(a, after)->prev_size = tail->size;
      }
      b->flags &= ~kFree;
      a->hdr->used += kBH + b->size;
      unlock(a);
      return off + kBH;
    }
    off = next_off(a, off);
  }
  unlock(a);
  return 0;
}

// Free a payload offset returned by arena_alloc; coalesces neighbours.
int arena_free(void* handle, uint64_t payload_off) {
  auto* a = static_cast<Arena*>(handle);
  uint64_t end = end_of_blocks(a);
  if (payload_off < first_block(a) + kBH || payload_off >= end) return -1;
  lock(a);
  uint64_t off = payload_off - kBH;
  BlockHeader* b = block_at(a, off);
  if (b->flags & kFree) {
    unlock(a);
    return -2;  // double free
  }
  b->flags |= kFree;
  a->hdr->used -= kBH + b->size;
  // coalesce forward
  uint64_t nxt = next_off(a, off);
  if (nxt < end) {
    BlockHeader* n = block_at(a, nxt);
    if (n->flags & kFree) {
      b->size += kBH + n->size;
      uint64_t after = next_off(a, off);
      if (after < end) block_at(a, after)->prev_size = b->size;
    }
  }
  // coalesce backward
  if (b->prev_size != 0) {
    uint64_t prev = off - kBH - b->prev_size;
    BlockHeader* p = block_at(a, prev);
    if (p->flags & kFree) {
      p->size += kBH + b->size;
      uint64_t after = next_off(a, prev);
      if (after < end) block_at(a, after)->prev_size = p->size;
    }
  }
  unlock(a);
  return 0;
}

uint64_t arena_used(void* handle) {
  return static_cast<Arena*>(handle)->hdr->used;
}

uint64_t arena_capacity(void* handle) {
  return static_cast<Arena*>(handle)->hdr->capacity;
}

// Walk the block list validating invariants; returns the block count or
// a negative error. Test/debug aid.
int64_t arena_check(void* handle) {
  auto* a = static_cast<Arena*>(handle);
  lock(a);
  uint64_t off = first_block(a);
  uint64_t end = end_of_blocks(a);
  uint64_t prev_size = 0;
  int64_t count = 0;
  while (off < end) {
    BlockHeader* b = block_at(a, off);
    if (b->size == 0 || off + kBH + b->size > end) {
      unlock(a);
      return -1;
    }
    if (b->prev_size != prev_size) {
      unlock(a);
      return -2;
    }
    prev_size = b->size;
    off = next_off(a, off);
    ++count;
  }
  unlock(a);
  return off == end ? count : -3;
}

}  // extern "C"
