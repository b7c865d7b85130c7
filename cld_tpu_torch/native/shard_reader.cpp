// Native packed-shard reader: mmap + parallel batch gather.
//
// The offline converter (cld_tpu_torch/data/convert.py) writes each field
// of a scene batch as one contiguous binary file; this reader mmaps the
// file and gathers arbitrary sample indices into a caller-provided buffer
// with a thread pool: no Python objects, no GIL, no per-worker copies.
// Exposed to Python via ctypes (cld_tpu_torch/data/packed.py), which
// builds it at first use into cld_tpu_torch/_build/:
//
//   g++ -O3 -shared -fPIC -o libshard_reader.so shard_reader.cpp -lpthread
//
// Everything below this header is the JAX package's reader
// (cld_tpu/native/shard_reader.cpp) byte for byte, so shards and reads are
// the same in both packages.

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

struct Shard {
  const uint8_t* data = nullptr;
  size_t file_bytes = 0;
  int64_t sample_bytes = 0;
  int64_t num_samples = 0;
  int fd = -1;
};

}  // namespace

extern "C" {

// Open a field file; returns an opaque handle (nullptr on failure).
void* shard_open(const char* path, int64_t sample_bytes) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  madvise(mem, st.st_size, MADV_WILLNEED);
  auto* s = new Shard();
  s->data = static_cast<const uint8_t*>(mem);
  s->file_bytes = st.st_size;
  s->sample_bytes = sample_bytes;
  s->num_samples = sample_bytes > 0 ? st.st_size / sample_bytes : 0;
  s->fd = fd;
  return s;
}

int64_t shard_num_samples(void* handle) {
  return handle ? static_cast<Shard*>(handle)->num_samples : -1;
}

// Gather `n` samples by index into `out` (n * sample_bytes), using up to
// `num_threads` threads. Returns 0 on success, -1 on out-of-range index.
int shard_gather(void* handle, const int64_t* indices, int64_t n, uint8_t* out,
                 int num_threads) {
  if (!handle) return -1;
  const Shard& s = *static_cast<Shard*>(handle);
  std::atomic<int> bad{0};
  if (num_threads < 1) num_threads = 1;
  int64_t chunk = (n + num_threads - 1) / num_threads;
  std::vector<std::thread> workers;
  for (int t = 0; t < num_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back([&, lo, hi]() {
      for (int64_t i = lo; i < hi; ++i) {
        int64_t idx = indices[i];
        if (idx < 0 || idx >= s.num_samples) {
          bad.store(1);
          return;
        }
        std::memcpy(out + i * s.sample_bytes, s.data + idx * s.sample_bytes,
                    s.sample_bytes);
      }
    });
  }
  for (auto& w : workers) w.join();
  return bad.load() ? -1 : 0;
}

void shard_close(void* handle) {
  if (!handle) return;
  auto* s = static_cast<Shard*>(handle);
  munmap(const_cast<uint8_t*>(s->data), s->file_bytes);
  ::close(s->fd);
  delete s;
}

}  // extern "C"
