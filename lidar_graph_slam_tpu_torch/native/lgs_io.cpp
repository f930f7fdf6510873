// Native host-side data path: scan decoding + threaded read-ahead prefetcher.
//
// The PyTorch port's own copy of the reference's `lgs_io.cpp` (the code below the header
// is the same). The device computes in PyTorch/CUDA, but the host data path — decoding
// KITTI velodyne .bin blobs and staging fixed-capacity padded buffers for upload — stays
// native: Python-level byte shuffling would serialize against the device. The prefetcher
// overlaps the decode of scan t+1 with the registration of scan t: a worker thread and a
// bounded queue feeding the Python loop.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr float kPadValue = 1.0e6f;

// Decode a KITTI velodyne .bin (x,y,z,intensity float32 records) into a fixed-capacity
// xyz buffer padded with kPadValue. Returns the number of valid points, or -1 on error.
int64_t read_bin_into(const char* path, float* out, int64_t capacity) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  const long bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  const int64_t n_records = bytes / (4 * sizeof(float));
  const int64_t n = n_records < capacity ? n_records : capacity;
  std::vector<float> raw(static_cast<size_t>(n) * 4);
  const size_t got = std::fread(raw.data(), sizeof(float), static_cast<size_t>(n) * 4, f);
  std::fclose(f);
  const int64_t n_ok = static_cast<int64_t>(got / 4);
  for (int64_t i = 0; i < n_ok; ++i) {
    out[i * 3 + 0] = raw[i * 4 + 0];
    out[i * 3 + 1] = raw[i * 4 + 1];
    out[i * 3 + 2] = raw[i * 4 + 2];
  }
  for (int64_t i = n_ok; i < capacity; ++i) {
    out[i * 3 + 0] = kPadValue;
    out[i * 3 + 1] = kPadValue;
    out[i * 3 + 2] = kPadValue;
  }
  return n_ok;
}

struct Slot {
  std::vector<float> data;
  int64_t n = 0;
  int64_t index = -1;
};

// Bounded-queue read-ahead prefetcher over a list of scan files.
struct Prefetcher {
  std::vector<std::string> paths;
  int64_t capacity;
  size_t depth;
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::queue<Slot> ready;
  std::atomic<bool> stop{false};

  Prefetcher(std::vector<std::string> p, int64_t cap, size_t d)
      : paths(std::move(p)), capacity(cap), depth(d) {
    worker = std::thread([this] { run(); });
  }

  void run() {
    for (size_t i = 0; i < paths.size() && !stop.load(); ++i) {
      Slot slot;
      slot.data.resize(static_cast<size_t>(capacity) * 3);
      slot.n = read_bin_into(paths[i].c_str(), slot.data.data(), capacity);
      slot.index = static_cast<int64_t>(i);
      std::unique_lock<std::mutex> lk(mu);
      cv_push.wait(lk, [this] { return ready.size() < depth || stop.load(); });
      if (stop.load()) return;
      ready.push(std::move(slot));
      cv_pop.notify_one();
    }
    // Sentinel marks end-of-stream.
    Slot done;
    done.index = -2;
    std::unique_lock<std::mutex> lk(mu);
    ready.push(std::move(done));
    cv_pop.notify_one();
  }

  // Returns scan index (>=0), -2 at end of stream. Fills `out` (capacity*3 floats).
  int64_t next(float* out, int64_t* n_points) {
    std::unique_lock<std::mutex> lk(mu);
    cv_pop.wait(lk, [this] { return !ready.empty(); });
    Slot slot = std::move(ready.front());
    if (slot.index == -2) {
      ready.pop();
      ready.push(std::move(slot));  // keep sentinel for repeated calls
      return -2;
    }
    ready.pop();
    cv_push.notify_one();
    lk.unlock();
    std::memcpy(out, slot.data.data(), slot.data.size() * sizeof(float));
    *n_points = slot.n;
    return slot.index;
  }

  ~Prefetcher() {
    stop.store(true);
    cv_push.notify_all();
    if (worker.joinable()) worker.join();
  }
};

}  // namespace

extern "C" {

int64_t lgs_read_bin(const char* path, float* out, int64_t capacity) {
  return read_bin_into(path, out, capacity);
}

// Voxel-grid centroid downsample oracle (exact PCL semantics) for host-side map export
// of clouds too large for a single device buffer. Returns number of voxels written.
int64_t lgs_voxel_downsample(const float* pts, int64_t n, float leaf, float* out,
                             int64_t out_capacity) {
  if (n == 0) return 0;
  float mn[3] = {pts[0], pts[1], pts[2]};
  for (int64_t i = 1; i < n; ++i)
    for (int d = 0; d < 3; ++d)
      if (pts[i * 3 + d] < mn[d]) mn[d] = pts[i * 3 + d];
  struct Acc { double s[3]; int64_t c; };
  // Open-addressing hash over packed 21-bit coords.
  const size_t table_size = 1ull << 22;
  std::vector<uint64_t> keys(table_size, ~0ull);
  std::vector<Acc> accs(table_size);
  const double inv = 1.0 / leaf;
  int64_t n_vox = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t cx = static_cast<uint64_t>((pts[i * 3 + 0] - mn[0]) * inv);
    const uint64_t cy = static_cast<uint64_t>((pts[i * 3 + 1] - mn[1]) * inv);
    const uint64_t cz = static_cast<uint64_t>((pts[i * 3 + 2] - mn[2]) * inv);
    const uint64_t key = (cx << 42) | (cy << 21) | cz;
    size_t h = (key * 0x9E3779B97F4A7C15ull) & (table_size - 1);
    while (true) {
      if (keys[h] == ~0ull) {
        keys[h] = key;
        accs[h] = {{0, 0, 0}, 0};
        ++n_vox;
        break;
      }
      if (keys[h] == key) break;
      h = (h + 1) & (table_size - 1);
    }
    for (int d = 0; d < 3; ++d) accs[h].s[d] += pts[i * 3 + d];
    accs[h].c += 1;
  }
  int64_t w = 0;
  for (size_t h = 0; h < table_size && w < out_capacity; ++h) {
    if (keys[h] != ~0ull) {
      for (int d = 0; d < 3; ++d)
        out[w * 3 + d] = static_cast<float>(accs[h].s[d] / accs[h].c);
      ++w;
    }
  }
  return w;
}

void* lgs_prefetcher_create(const char** paths, int64_t n_paths, int64_t capacity,
                            int64_t depth) {
  std::vector<std::string> p;
  p.reserve(static_cast<size_t>(n_paths));
  for (int64_t i = 0; i < n_paths; ++i) p.emplace_back(paths[i]);
  return new Prefetcher(std::move(p), capacity, static_cast<size_t>(depth));
}

int64_t lgs_prefetcher_next(void* handle, float* out, int64_t* n_points) {
  return static_cast<Prefetcher*>(handle)->next(out, n_points);
}

void lgs_prefetcher_destroy(void* handle) { delete static_cast<Prefetcher*>(handle); }

}  // extern "C"
