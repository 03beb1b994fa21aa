// Threaded safetensors byte-range reader.
//
// The Python side (loader.py) parses the header, allocates the destination
// tensors and hands this library a batch of (offset, size, destination)
// ranges; the ranges are spread over a pool of threads, each with its own
// file descriptor, reading with pread(2): no interpreter lock and no Python
// objects on the way.
//
// Build: g++ -O3 -shared -fPIC -pthread -o libst_reader.so st_reader.cpp

#include <atomic>
#include <cstdint>
#include <fcntl.h>
#include <thread>
#include <unistd.h>
#include <vector>

extern "C" {

// Copy n byte ranges of the file at `path` into caller-provided buffers.
// offsets/sizes/dsts are parallel arrays.  Returns 0 on success, -1 on any
// IO failure.  `num_threads` <= 0 selects the hardware concurrency.
int st_read_ranges(const char *path, const uint64_t *offsets,
                   const uint64_t *sizes, uint8_t **dsts, int64_t n,
                   int num_threads) {
  if (num_threads <= 0) {
    num_threads = (int)std::thread::hardware_concurrency();
    if (num_threads <= 0) num_threads = 4;
  }
  if (num_threads > n) num_threads = (int)(n > 0 ? n : 1);

  std::atomic<int64_t> next(0);
  std::atomic<int> failed(0);

  auto worker = [&]() {
    int fd = open(path, O_RDONLY);
    if (fd < 0) {
      failed.store(1);
      return;
    }
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n || failed.load()) break;
      uint64_t off = offsets[i], remaining = sizes[i];
      uint8_t *dst = dsts[i];
      while (remaining > 0) {
        ssize_t got = pread(fd, dst, remaining, (off_t)off);
        if (got <= 0) {
          failed.store(1);
          break;
        }
        dst += got;
        off += (uint64_t)got;
        remaining -= (uint64_t)got;
      }
    }
    close(fd);
  };

  std::vector<std::thread> threads;
  threads.reserve((size_t)num_threads);
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto &th : threads) th.join();
  return failed.load() ? -1 : 0;
}

}  // extern "C"
