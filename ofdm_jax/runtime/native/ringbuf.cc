// Double-mapped single-producer/single-consumer ring buffer.
//
// Native-runtime equivalent of GNU Radio's vmcircbuf (SURVEY.md §2b
// "Circular stream buffers", gnuradio-runtime/lib/vmcircbuf_mmap_shm_open.cc,
// unverified path): the buffer's pages are mapped TWICE back-to-back in
// virtual memory, so any window of up to `capacity` bytes is contiguous even
// across the wrap point -- producers and consumers never split an operation.
// Where the reference pairs this with per-block scheduler threads and
// condvar back-pressure, here it feeds the host side of the jitted executor:
// a reader thread (reader.cc) fills the ring, Python slices zero-copy numpy
// views out of it, converts (convert.cc) and ships blocks to the device.
//
// SPSC: `wr` is written only by the producer, `rd` only by the consumer,
// both with release stores / acquire loads; no locks anywhere.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <sys/mman.h>
#include <unistd.h>
#include <fcntl.h>

namespace {

struct Ring {
  uint8_t* base = nullptr;   // 2*cap mapping
  size_t cap = 0;
  std::atomic<uint64_t> wr{0};
  std::atomic<uint64_t> rd{0};
};

size_t round_up_pages(size_t n) {
  size_t p = static_cast<size_t>(sysconf(_SC_PAGESIZE));
  return ((n + p - 1) / p) * p;
}

}  // namespace

extern "C" {

void* rb_create(size_t capacity) {
  size_t cap = round_up_pages(capacity);
  int fd = memfd_create("ofdm_jax_ring", 0);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, static_cast<off_t>(cap)) != 0) {
    close(fd);
    return nullptr;
  }
  // reserve 2*cap of address space, then map the same pages into both halves
  uint8_t* base = static_cast<uint8_t*>(
      mmap(nullptr, 2 * cap, PROT_NONE, MAP_PRIVATE | MAP_ANONYMOUS, -1, 0));
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  void* lo = mmap(base, cap, PROT_READ | PROT_WRITE,
                  MAP_SHARED | MAP_FIXED, fd, 0);
  void* hi = mmap(base + cap, cap, PROT_READ | PROT_WRITE,
                  MAP_SHARED | MAP_FIXED, fd, 0);
  close(fd);
  if (lo == MAP_FAILED || hi == MAP_FAILED) {
    munmap(base, 2 * cap);
    return nullptr;
  }
  Ring* r = new Ring();
  r->base = base;
  r->cap = cap;
  return r;
}

void rb_destroy(void* h) {
  Ring* r = static_cast<Ring*>(h);
  if (!r) return;
  munmap(r->base, 2 * r->cap);
  delete r;
}

size_t rb_capacity(void* h) { return static_cast<Ring*>(h)->cap; }

size_t rb_readable(void* h) {
  Ring* r = static_cast<Ring*>(h);
  return static_cast<size_t>(r->wr.load(std::memory_order_acquire) -
                             r->rd.load(std::memory_order_relaxed));
}

size_t rb_writable(void* h) {
  Ring* r = static_cast<Ring*>(h);
  return r->cap - static_cast<size_t>(
                      r->wr.load(std::memory_order_relaxed) -
                      r->rd.load(std::memory_order_acquire));
}

// Contiguous producer window (valid for rb_writable() bytes).
void* rb_write_ptr(void* h) {
  Ring* r = static_cast<Ring*>(h);
  return r->base + (r->wr.load(std::memory_order_relaxed) % r->cap);
}

void rb_commit(void* h, size_t n) {
  Ring* r = static_cast<Ring*>(h);
  r->wr.store(r->wr.load(std::memory_order_relaxed) + n,
              std::memory_order_release);
}

// Contiguous consumer window (valid for rb_readable() bytes).
const void* rb_read_ptr(void* h) {
  Ring* r = static_cast<Ring*>(h);
  return r->base + (r->rd.load(std::memory_order_relaxed) % r->cap);
}

void rb_consume(void* h, size_t n) {
  Ring* r = static_cast<Ring*>(h);
  r->rd.store(r->rd.load(std::memory_order_relaxed) + n,
              std::memory_order_release);
}

}  // extern "C"
