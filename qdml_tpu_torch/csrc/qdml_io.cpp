// qdml_io: the native host IO runtime of qdml_tpu_torch (a copy of the JAX
// package's native/qdml_io.cpp, built apart from it).
//
// Training from a materialised .npy cache, the host feeds the card through:
//
//   * zero-copy .npy access: header parse + mmap (the OS page cache is the
//     shared buffer; no read() copies),
//   * a multithreaded row gather: a shuffled batch assembled from row
//     indices into one contiguous buffer, split across worker threads,
//   * an async prefetch pipeline: a slot ring whose worker threads fill the
//     next batches while the card consumes the current one.
//
// A plain C ABI for ctypes; qdml_tpu_torch/runtime/native_io.py builds it
// with g++ at first use into build/qdml_tpu_torch/ and binds it.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread qdml_io.cpp -o libqdml_io.so

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// ---------------------------------------------------------------------------
// .npy file: header parse + mmap
// ---------------------------------------------------------------------------

struct NpyFile {
  int fd = -1;
  void* map = nullptr;
  size_t map_len = 0;
  const uint8_t* data = nullptr;  // first element, inside the mapping
  long shape[8] = {0};
  int ndim = 0;
  int itemsize = 0;
  char typechar = '?';  // 'f' float, 'c' complex, 'i' int, 'u' uint
};

// Parse "{'descr': '<f4', 'fortran_order': False, 'shape': (3, 4), }"
bool parse_header(const std::string& h, NpyFile* f) {
  auto find_val = [&](const char* key) -> std::string {
    size_t k = h.find(key);
    if (k == std::string::npos) return "";
    size_t colon = h.find(':', k);
    if (colon == std::string::npos) return "";
    size_t end = h.find(',', colon);
    // shape tuple contains commas; cut at ')' instead
    size_t open = h.find('(', colon);
    if (open != std::string::npos && open < end) end = h.find(')', open) + 1;
    if (end == std::string::npos) end = h.size();
    return h.substr(colon + 1, end - colon - 1);
  };

  std::string descr = find_val("'descr'");
  size_t q = descr.find('\'');
  if (q == std::string::npos) return false;
  std::string d = descr.substr(q + 1, descr.find('\'', q + 1) - q - 1);
  if (d.size() < 3 || (d[0] != '<' && d[0] != '|' && d[0] != '=')) return false;
  f->typechar = d[1];
  f->itemsize = std::atoi(d.c_str() + 2);
  if (f->itemsize <= 0 || f->itemsize > 64) return false;

  if (find_val("'fortran_order'").find("True") != std::string::npos) return false;

  std::string shape = find_val("'shape'");
  size_t open = shape.find('(');
  size_t close = shape.find(')');
  if (open == std::string::npos || close == std::string::npos) return false;
  std::string tup = shape.substr(open + 1, close - open - 1);
  f->ndim = 0;
  const char* p = tup.c_str();
  while (*p && f->ndim < 8) {
    while (*p == ' ' || *p == ',') ++p;
    if (!*p) break;
    char* endp = nullptr;
    long v = std::strtol(p, &endp, 10);
    if (endp == p) break;
    f->shape[f->ndim++] = v;
    p = endp;
  }
  if (f->ndim == 0) {  // 0-d scalar: treat as shape (1,)
    f->shape[0] = 1;
    f->ndim = 1;
  }
  return true;
}

}  // namespace

extern "C" {

void* qdml_npy_open(const char* path) {
  auto* f = new NpyFile();
  f->fd = ::open(path, O_RDONLY);
  if (f->fd < 0) {
    delete f;
    return nullptr;
  }
  struct stat st;
  if (fstat(f->fd, &st) != 0 || st.st_size < 12) {
    ::close(f->fd);
    delete f;
    return nullptr;
  }
  f->map_len = static_cast<size_t>(st.st_size);
  f->map = mmap(nullptr, f->map_len, PROT_READ, MAP_PRIVATE, f->fd, 0);
  if (f->map == MAP_FAILED) {
    ::close(f->fd);
    delete f;
    return nullptr;
  }
  const uint8_t* b = static_cast<const uint8_t*>(f->map);
  if (std::memcmp(b, "\x93NUMPY", 6) != 0) goto fail;
  {
    int major = b[6];
    size_t hlen, hoff;
    if (major == 1) {
      hlen = b[8] | (b[9] << 8);
      hoff = 10;
    } else {  // v2/v3: 4-byte header length
      hlen = static_cast<size_t>(b[8]) | (static_cast<size_t>(b[9]) << 8) |
             (static_cast<size_t>(b[10]) << 16) | (static_cast<size_t>(b[11]) << 24);
      hoff = 12;
    }
    if (hoff + hlen > f->map_len) goto fail;
    std::string header(reinterpret_cast<const char*>(b + hoff), hlen);
    if (!parse_header(header, f)) goto fail;
    f->data = b + hoff + hlen;
    long total = 1;
    for (int i = 0; i < f->ndim; ++i) total *= f->shape[i];
    if (f->data + static_cast<size_t>(total) * f->itemsize >
        b + f->map_len) goto fail;
  }
  return f;
fail:
  munmap(f->map, f->map_len);
  ::close(f->fd);
  delete f;
  return nullptr;
}

int qdml_npy_info(void* h, long* shape_out, int* ndim, int* itemsize, char* typechar) {
  if (!h) return -1;
  auto* f = static_cast<NpyFile*>(h);
  for (int i = 0; i < f->ndim; ++i) shape_out[i] = f->shape[i];
  *ndim = f->ndim;
  *itemsize = f->itemsize;
  *typechar = f->typechar;
  return 0;
}

const void* qdml_npy_data(void* h) {
  return h ? static_cast<NpyFile*>(h)->data : nullptr;
}

void qdml_npy_close(void* h) {
  if (!h) return;
  auto* f = static_cast<NpyFile*>(h);
  munmap(f->map, f->map_len);
  ::close(f->fd);
  delete f;
}

// ---------------------------------------------------------------------------
// Threaded row gather
// ---------------------------------------------------------------------------

void qdml_gather_rows(const void* src, long row_bytes, const long* idx, long n,
                      void* dst, int n_threads) {
  const uint8_t* s = static_cast<const uint8_t*>(src);
  uint8_t* d = static_cast<uint8_t*>(dst);
  if (n_threads <= 1 || n < 64) {
    for (long i = 0; i < n; ++i)
      std::memcpy(d + i * row_bytes, s + idx[i] * row_bytes, row_bytes);
    return;
  }
  std::vector<std::thread> ts;
  long chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    long lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=]() {
      for (long i = lo; i < hi; ++i)
        std::memcpy(d + i * row_bytes, s + idx[i] * row_bytes, row_bytes);
    });
  }
  for (auto& t : ts) t.join();
}

// ---------------------------------------------------------------------------
// Async prefetch pipeline: slot ring filled by a worker pool
// ---------------------------------------------------------------------------

namespace {

struct Job {
  int slot;
  std::vector<long> idx;
};

struct Prefetcher {
  const uint8_t* src;
  long row_bytes;
  long batch;
  int n_slots;
  std::vector<std::vector<uint8_t>> buffers;
  std::vector<std::atomic<int>> state;  // 0 free, 1 filling, 2 ready

  std::deque<Job> queue;
  std::mutex mu;
  std::condition_variable cv_job;
  std::condition_variable cv_done;
  std::vector<std::thread> workers;
  bool stop = false;

  Prefetcher(const void* s, long rb, int slots, long b, int n_threads)
      : src(static_cast<const uint8_t*>(s)),
        row_bytes(rb),
        batch(b),
        n_slots(slots),
        buffers(slots),
        state(slots) {
    for (int i = 0; i < slots; ++i) {
      buffers[i].resize(static_cast<size_t>(rb) * b);
      state[i].store(0);
    }
    for (int t = 0; t < n_threads; ++t)
      workers.emplace_back([this]() { this->run(); });
  }

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_job.wait(lk, [&] { return stop || !queue.empty(); });
        if (stop && queue.empty()) return;
        job = std::move(queue.front());
        queue.pop_front();
      }
      uint8_t* d = buffers[job.slot].data();
      for (size_t i = 0; i < job.idx.size(); ++i)
        std::memcpy(d + i * row_bytes, src + job.idx[i] * row_bytes, row_bytes);
      {
        // Publish under the lock: a waiter that just evaluated the predicate
        // false must not miss the notify (lost-wakeup race).
        std::lock_guard<std::mutex> lk(mu);
        state[job.slot].store(2);
      }
      cv_done.notify_all();
    }
  }

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_job.notify_all();
    for (auto& w : workers) w.join();
  }
};

}  // namespace

void* qdml_prefetch_create(const void* src, long row_bytes, int n_slots,
                           long batch, int n_threads) {
  if (!src || row_bytes <= 0 || n_slots <= 0 || batch <= 0) return nullptr;
  return new Prefetcher(src, row_bytes, n_slots, batch,
                        n_threads > 0 ? n_threads : 2);
}

// Submit a fill of `n` (<= batch) rows; returns the slot id, or -1 if no slot
// is free (caller must release slots after consuming them).
int qdml_prefetch_submit(void* p, const long* idx, long n) {
  auto* pf = static_cast<Prefetcher*>(p);
  if (!pf || n > pf->batch) return -1;
  int slot = -1;
  for (int i = 0; i < pf->n_slots; ++i) {
    int expected = 0;
    if (pf->state[i].compare_exchange_strong(expected, 1)) {
      slot = i;
      break;
    }
  }
  if (slot < 0) return -1;
  {
    std::lock_guard<std::mutex> lk(pf->mu);
    pf->queue.push_back(Job{slot, std::vector<long>(idx, idx + n)});
  }
  pf->cv_job.notify_one();
  return slot;
}

int qdml_prefetch_wait(void* p, int slot) {
  auto* pf = static_cast<Prefetcher*>(p);
  if (!pf || slot < 0 || slot >= pf->n_slots) return -1;
  std::unique_lock<std::mutex> lk(pf->mu);
  pf->cv_done.wait(lk, [&] { return pf->state[slot].load() == 2; });
  return 0;
}

const void* qdml_prefetch_buffer(void* p, int slot) {
  auto* pf = static_cast<Prefetcher*>(p);
  if (!pf || slot < 0 || slot >= pf->n_slots) return nullptr;
  return pf->buffers[slot].data();
}

void qdml_prefetch_release(void* p, int slot) {
  auto* pf = static_cast<Prefetcher*>(p);
  if (pf && slot >= 0 && slot < pf->n_slots) pf->state[slot].store(0);
}

void qdml_prefetch_destroy(void* p) { delete static_cast<Prefetcher*>(p); }

}  // extern "C"
