// Native record-store reader (the port's copy of the JAX package's
// data/native/record_reader.cc): mmap zero-copy item access and a threaded
// batch gather for the training input pipeline.
//
// The .data blob is mapped once, items are served as zero-copy pointers into
// the page cache, and multi-item gathers fan out across a small thread pool
// (overlapping page faults). g++ builds it at first use
// (conan_tpu_torch/data/_native.py).
//
// C ABI (called through ctypes):
//   rs_open(data_path, offsets, n_offsets) -> handle (null on failure)
//   rs_len(handle)                         -> number of items
//   rs_item(handle, i, &ptr, &len)         -> 0 on success (zero-copy)
//   rs_gather(handle, idxs, n, dest, dest_cap, item_lens, n_threads)
//                                          -> bytes written, -1 if dest is
//                                             too small, -2 on a bad index
//   rs_prefault(handle, idxs, n, n_threads) -> touch pages on pool threads
//   rs_close(handle)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Store {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  std::vector<int64_t> offsets;
};

void parallel_for(int64_t n, int n_threads, void (*fn)(int64_t, void*), void* ctx) {
  if (n <= 0) return;
  n_threads = std::max(1, std::min<int>(n_threads, (int)n));
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      fn(i, ctx);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < n_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

void* rs_open(const char* data_path, const int64_t* offsets, int64_t n_offsets) {
  int fd = ::open(data_path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
  void* base = nullptr;  // an empty store (a split with no items) maps nothing
  if (st.st_size > 0) {
    base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
    if (base == MAP_FAILED) { ::close(fd); return nullptr; }
    madvise(base, st.st_size, MADV_WILLNEED);
  }
  auto* s = new Store;
  s->fd = fd;
  s->base = static_cast<const uint8_t*>(base);
  s->size = (size_t)st.st_size;
  s->offsets.assign(offsets, offsets + n_offsets);
  return s;
}

int64_t rs_len(void* handle) {
  auto* s = static_cast<Store*>(handle);
  return (int64_t)s->offsets.size() - 1;
}

int rs_item(void* handle, int64_t i, const uint8_t** ptr, int64_t* len) {
  auto* s = static_cast<Store*>(handle);
  if (i < 0 || i + 1 >= (int64_t)s->offsets.size()) return -1;
  int64_t off = s->offsets[i];
  int64_t end = s->offsets[i + 1];
  if (off < 0 || end > (int64_t)s->size || end < off) return -2;
  *ptr = s->base + off;
  *len = end - off;
  return 0;
}

struct GatherCtx {
  Store* s;
  const int64_t* idxs;
  uint8_t* dest;
  const int64_t* dst_off;
};

static void gather_one(int64_t k, void* vctx) {
  auto* c = static_cast<GatherCtx*>(vctx);
  int64_t i = c->idxs[k];
  int64_t off = c->s->offsets[i];
  int64_t len = c->s->offsets[i + 1] - off;
  memcpy(c->dest + c->dst_off[k], c->s->base + off, (size_t)len);
}

// Copies items idxs[0..n) into dest back-to-back; writes each item's length
// into item_lens. Returns total bytes, or -1 if dest_cap is too small.
int64_t rs_gather(void* handle, const int64_t* idxs, int64_t n, uint8_t* dest,
                  int64_t dest_cap, int64_t* item_lens, int n_threads) {
  auto* s = static_cast<Store*>(handle);
  std::vector<int64_t> dst_off(n);
  int64_t total = 0;
  for (int64_t k = 0; k < n; ++k) {
    int64_t i = idxs[k];
    if (i < 0 || i + 1 >= (int64_t)s->offsets.size()) return -2;
    int64_t len = s->offsets[i + 1] - s->offsets[i];
    dst_off[k] = total;
    item_lens[k] = len;
    total += len;
  }
  if (total > dest_cap) return -1;
  GatherCtx ctx{s, idxs, dest, dst_off.data()};
  parallel_for(n, n_threads, gather_one, &ctx);
  return total;
}

static void prefault_one(int64_t k, void* vctx) {
  auto* c = static_cast<GatherCtx*>(vctx);
  int64_t i = c->idxs[k];
  int64_t off = c->s->offsets[i];
  int64_t len = c->s->offsets[i + 1] - off;
  volatile uint8_t acc = 0;
  const uint8_t* p = c->s->base + off;
  for (int64_t b = 0; b < len; b += 4096) acc ^= p[b];
  (void)acc;
}

void rs_prefault(void* handle, const int64_t* idxs, int64_t n, int n_threads) {
  auto* s = static_cast<Store*>(handle);
  GatherCtx ctx{s, idxs, nullptr, nullptr};
  parallel_for(n, n_threads, prefault_one, &ctx);
}

void rs_close(void* handle) {
  auto* s = static_cast<Store*>(handle);
  if (s->base) munmap(const_cast<uint8_t*>(s->base), s->size);
  if (s->fd >= 0) ::close(s->fd);
  delete s;
}

}  // extern "C"
