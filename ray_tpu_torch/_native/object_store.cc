// Shared-memory object arena — the plasma-store equivalent for ray_tpu.
//
// Reference parity: src/ray/object_manager/plasma/{store.cc,eviction_policy.cc}
// (create/seal/get/release/delete, refcounts, LRU eviction). Re-designed for
// a single-host multi-process runtime: one POSIX shm segment holds a header,
// a fixed open-addressing object table, and a data region managed by a
// first-fit free list with offset-based links (all state is position-
// independent so every process can mmap at a different address). A
// process-shared *robust* pthread mutex serializes mutations — a worker
// dying mid-operation leaves the lock recoverable (EOWNERDEAD).
//
// Exposed as a flat C ABI for ctypes (no pybind11 in the image).
//
// Zero-copy contract with Python: create() returns an offset into the
// mapping; the caller packs serialized bytes directly into base+offset and
// then seal()s. get() pins (refcount++) and returns the offset; numpy
// arrays built over that memory alias shared pages until release().

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52545055414e4101ull;  // "RTPUANA\x01"
constexpr uint32_t kNumSlots = 1 << 16;
constexpr uint64_t kAlign = 64;
constexpr uint32_t kIdLen = 47;  // + NUL -> 48-byte field

// Object states.
enum : uint32_t { kFree = 0, kCreated = 1, kSealed = 2, kDeletePending = 3 };

constexpr uint32_t kNilIdx = 0xffffffffu;

struct Entry {
  char id[kIdLen + 1];
  uint64_t offset;      // into data region
  uint64_t size;        // object payload size (what readers see)
  uint64_t alloc_size;  // actual bytes taken from the allocator
  int64_t refcount;
  uint32_t state;
  uint32_t probe;    // nonzero if slot ever used (tombstone-aware probing)
  // Intrusive LRU list over *evictable* entries (sealed, refcount==0):
  // head = most recent. Pinning removes; sealing/unpinning pushes front.
  uint32_t in_lru;
  uint32_t lru_prev;
  uint32_t lru_next;
};

struct FreeBlock {   // lives at the start of each free data block
  uint64_t size;
  uint64_t next;     // data-region offset of next free block; ~0ull = none
};
constexpr uint64_t kNil = ~0ull;

struct Header {
  uint64_t magic;
  uint64_t total_bytes;    // whole mapping
  uint64_t data_off;       // start of data region (from base)
  uint64_t data_size;
  uint64_t used;           // allocated bytes in data region
  uint64_t free_head;      // data-region offset of first free block
  uint32_t lru_head;       // slot index of most-recently-used evictable
  uint32_t lru_tail;       // slot index of least-recently-used evictable
  uint32_t n_slots;
  uint32_t n_objects;
  pthread_mutex_t mutex;
};

struct Arena {
  uint8_t* base;
  uint64_t total;
  int is_owner;
  char name[128];
};

inline Header* header(Arena* a) { return reinterpret_cast<Header*>(a->base); }
inline Entry* table(Arena* a) {
  return reinterpret_cast<Entry*>(a->base + sizeof(Header));
}
inline uint8_t* data(Arena* a) { return a->base + header(a)->data_off; }

uint64_t align_up(uint64_t v, uint64_t a) { return (v + a - 1) & ~(a - 1); }

uint64_t fnv1a(const char* s) {
  uint64_t h = 1469598103934665603ull;
  for (; *s; ++s) {
    h ^= static_cast<uint8_t>(*s);
    h *= 1099511628211ull;
  }
  return h;
}

class Locker {  // RAII over the robust process-shared mutex
 public:
  explicit Locker(Header* h) : h_(h) {
    int rc = pthread_mutex_lock(&h_->mutex);
    if (rc == EOWNERDEAD) pthread_mutex_consistent(&h_->mutex);
  }
  ~Locker() { pthread_mutex_unlock(&h_->mutex); }

 private:
  Header* h_;
};

Entry* find(Arena* a, const char* id) {
  Header* h = header(a);
  Entry* t = table(a);
  uint64_t slot = fnv1a(id) % h->n_slots;
  for (uint32_t i = 0; i < h->n_slots; ++i) {
    Entry* e = &t[(slot + i) % h->n_slots];
    if (e->state == kFree && !e->probe) return nullptr;  // never-used slot
    if (e->state != kFree && strncmp(e->id, id, kIdLen) == 0) return e;
  }
  return nullptr;
}

Entry* find_empty(Arena* a, const char* id) {
  Header* h = header(a);
  Entry* t = table(a);
  uint64_t slot = fnv1a(id) % h->n_slots;
  for (uint32_t i = 0; i < h->n_slots; ++i) {
    Entry* e = &t[(slot + i) % h->n_slots];
    if (e->state == kFree) return e;
  }
  return nullptr;
}

// -- free-list allocator (offsets into the data region) ----------------------

// First-fit. Fills *actual with the bytes really taken (aligned request,
// plus any absorbed sliver) — the caller must pass the same value back to
// fl_free so accounting and coalescing stay exact.
uint64_t fl_alloc(Arena* a, uint64_t size, uint64_t* actual) {
  Header* h = header(a);
  size = align_up(size ? size : 1, kAlign);
  uint64_t prev = kNil, cur = h->free_head;
  while (cur != kNil) {
    FreeBlock* b = reinterpret_cast<FreeBlock*>(data(a) + cur);
    if (b->size >= size) {
      uint64_t remaining = b->size - size;
      uint64_t next = b->next;
      if (remaining >= sizeof(FreeBlock) + kAlign) {
        uint64_t tail = cur + size;
        FreeBlock* nb = reinterpret_cast<FreeBlock*>(data(a) + tail);
        nb->size = remaining;
        nb->next = next;
        next = tail;
      } else {
        size = b->size;  // absorb the sliver
      }
      if (prev == kNil) h->free_head = next;
      else reinterpret_cast<FreeBlock*>(data(a) + prev)->next = next;
      h->used += size;
      *actual = size;
      return cur;
    }
    prev = cur;
    cur = b->next;
  }
  return kNil;
}

void fl_free(Arena* a, uint64_t off, uint64_t size) {
  Header* h = header(a);
  size = align_up(size ? size : 1, kAlign);
  h->used -= size;
  // insert sorted by offset, coalescing with neighbors
  uint64_t prev = kNil, cur = h->free_head;
  while (cur != kNil && cur < off) {
    prev = cur;
    cur = reinterpret_cast<FreeBlock*>(data(a) + cur)->next;
  }
  FreeBlock* nb = reinterpret_cast<FreeBlock*>(data(a) + off);
  nb->size = size;
  nb->next = cur;
  if (cur != kNil && off + size == cur) {  // merge with next
    FreeBlock* cb = reinterpret_cast<FreeBlock*>(data(a) + cur);
    nb->size += cb->size;
    nb->next = cb->next;
  }
  if (prev != kNil) {
    FreeBlock* pb = reinterpret_cast<FreeBlock*>(data(a) + prev);
    if (prev + pb->size == off) {  // merge with prev
      pb->size += nb->size;
      pb->next = nb->next;
      return;
    }
    pb->next = off;
  } else {
    h->free_head = off;
  }
}

// -- LRU list over evictable entries (O(1) victim selection, the role of
// -- the plasma reference's eviction_policy.cc) ------------------------------

inline uint32_t slot_of(Arena* a, Entry* e) {
  return static_cast<uint32_t>(e - table(a));
}

void lru_remove(Arena* a, Entry* e) {
  if (!e->in_lru) return;
  Header* h = header(a);
  Entry* t = table(a);
  if (e->lru_prev != kNilIdx) t[e->lru_prev].lru_next = e->lru_next;
  else h->lru_head = e->lru_next;
  if (e->lru_next != kNilIdx) t[e->lru_next].lru_prev = e->lru_prev;
  else h->lru_tail = e->lru_prev;
  e->in_lru = 0;
  e->lru_prev = e->lru_next = kNilIdx;
}

void lru_push_front(Arena* a, Entry* e) {
  if (e->in_lru) return;
  Header* h = header(a);
  Entry* t = table(a);
  e->lru_prev = kNilIdx;
  e->lru_next = h->lru_head;
  if (h->lru_head != kNilIdx) t[h->lru_head].lru_prev = slot_of(a, e);
  h->lru_head = slot_of(a, e);
  if (h->lru_tail == kNilIdx) h->lru_tail = h->lru_head;
  e->in_lru = 1;
}

void free_entry(Arena* a, Entry* e) {
  Header* h = header(a);
  lru_remove(a, e);
  fl_free(a, e->offset, e->alloc_size);
  e->state = kFree;  // probe stays set: tombstone for open addressing
  e->id[0] = '\0';
  h->n_objects--;
}

// Allocate, evicting from the LRU tail (retrying after each eviction so
// coalescing gets a chance to defragment). Returns the allocated offset or
// kNil when eviction can't help; fills *actual for the eventual fl_free.
uint64_t alloc_with_eviction(Arena* a, uint64_t size, uint64_t* actual) {
  Header* h = header(a);
  uint64_t off = fl_alloc(a, size, actual);
  while (off == kNil) {
    if (h->lru_tail == kNilIdx) return kNil;
    free_entry(a, &table(a)[h->lru_tail]);
    off = fl_alloc(a, size, actual);
  }
  return off;
}

}  // namespace

extern "C" {

Arena* rtpu_arena_create(const char* name, uint64_t capacity, int is_owner) {
  uint64_t table_bytes = sizeof(Entry) * static_cast<uint64_t>(kNumSlots);
  uint64_t data_off = align_up(sizeof(Header) + table_bytes, 4096);
  uint64_t total = data_off + align_up(capacity, 4096);

  int fd;
  if (is_owner) {
    shm_unlink(name);  // stale segment from a crashed run
    fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
    if (fd < 0) return nullptr;
    if (ftruncate(fd, static_cast<off_t>(total)) != 0) {
      close(fd);
      shm_unlink(name);
      return nullptr;
    }
  } else {
    fd = shm_open(name, O_RDWR, 0600);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) {
      close(fd);
      return nullptr;
    }
    total = static_cast<uint64_t>(st.st_size);
  }

  void* mem = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;

  Arena* a = new Arena;
  a->base = static_cast<uint8_t*>(mem);
  a->total = total;
  a->is_owner = is_owner;
  snprintf(a->name, sizeof(a->name), "%s", name);

  if (is_owner) {
    Header* h = header(a);
    memset(h, 0, sizeof(Header));
    memset(table(a), 0, table_bytes);
    h->magic = kMagic;
    h->total_bytes = total;
    h->data_off = data_off;
    h->data_size = total - data_off;
    h->used = 0;
    h->lru_head = kNilIdx;
    h->lru_tail = kNilIdx;
    h->n_slots = kNumSlots;
    h->n_objects = 0;
    FreeBlock* fb = reinterpret_cast<FreeBlock*>(data(a));
    fb->size = h->data_size;
    fb->next = kNil;
    h->free_head = 0;

    pthread_mutexattr_t attr;
    pthread_mutexattr_init(&attr);
    pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&h->mutex, &attr);
    pthread_mutexattr_destroy(&attr);
  } else if (header(a)->magic != kMagic) {
    munmap(mem, total);
    delete a;
    return nullptr;
  }
  return a;
}

void rtpu_arena_close(Arena* a, int unlink_seg) {
  if (!a) return;
  munmap(a->base, a->total);
  if (unlink_seg) shm_unlink(a->name);
  delete a;
}

// Unlink the segment name without unmapping: live zero-copy readers keep
// their pages; the kernel reclaims memory when the last process unmaps
// (i.e. at exit).
void rtpu_arena_unlink(Arena* a) {
  if (a) shm_unlink(a->name);
}

uint8_t* rtpu_arena_base(Arena* a) { return a->base + header(a)->data_off; }

// Returns data-region offset of a writable (unsealed) object, or:
//   -1 out of memory (even after eviction), -2 id already exists,
//   -3 object table full.
int64_t rtpu_arena_create_object(Arena* a, const char* id, uint64_t size) {
  Header* h = header(a);
  Locker lock(h);
  if (find(a, id)) return -2;
  Entry* e = find_empty(a, id);
  if (!e) return -3;
  uint64_t actual = 0;
  uint64_t off = alloc_with_eviction(a, size, &actual);
  if (off == kNil) return -1;
  snprintf(e->id, sizeof(e->id), "%s", id);
  e->offset = off;
  e->size = size;
  e->alloc_size = actual;
  e->refcount = 1;  // creator's write pin
  e->state = kCreated;
  e->probe = 1;
  e->in_lru = 0;
  e->lru_prev = e->lru_next = kNilIdx;
  h->n_objects++;
  return static_cast<int64_t>(off);
}

int rtpu_arena_seal(Arena* a, const char* id) {
  Locker lock(header(a));
  Entry* e = find(a, id);
  if (!e || e->state != kCreated) return -1;
  e->state = kSealed;
  e->refcount = 0;  // creator's write pin drops; readers pin via get
  lru_push_front(a, e);
  return 0;
}

// Pins the object (refcount++). Returns offset, fills *size; -1 if absent
// or unsealed.
int64_t rtpu_arena_get(Arena* a, const char* id, uint64_t* size) {
  Header* h = header(a);
  Locker lock(h);
  Entry* e = find(a, id);
  if (!e || e->state != kSealed) return -1;
  e->refcount++;
  lru_remove(a, e);  // pinned objects are not evictable
  if (size) *size = e->size;
  return static_cast<int64_t>(e->offset);
}

int rtpu_arena_release(Arena* a, const char* id) {
  Locker lock(header(a));
  Entry* e = find(a, id);
  if (!e) return -1;
  if (e->refcount > 0) e->refcount--;
  if (e->refcount <= 0) {
    if (e->state == kDeletePending) free_entry(a, e);
    else if (e->state == kSealed) lru_push_front(a, e);
  }
  return 0;
}

// Frees now if unpinned, else defers to the last release.
int rtpu_arena_delete(Arena* a, const char* id) {
  Locker lock(header(a));
  Entry* e = find(a, id);
  if (!e) return -1;
  if (e->refcount <= 0) free_entry(a, e);
  else e->state = kDeletePending;
  return 0;
}

int rtpu_arena_contains(Arena* a, const char* id) {
  Locker lock(header(a));
  Entry* e = find(a, id);
  return e && e->state == kSealed;
}

uint64_t rtpu_arena_used(Arena* a) {
  Locker lock(header(a));
  return header(a)->used;
}

uint64_t rtpu_arena_capacity(Arena* a) { return header(a)->data_size; }

uint32_t rtpu_arena_count(Arena* a) {
  Locker lock(header(a));
  return header(a)->n_objects;
}

}  // extern "C"
