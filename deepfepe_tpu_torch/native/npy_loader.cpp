// Native data-loading runtime: .npy parsing + a threaded prefetch pool.
//
// A C++ thread pool that parses and loads the dump-format .npy files
// (per-pair match tensors, per-scene calibration and poses) into
// caller-owned buffers, so disk reads overlap the host-to-device feed.
// Exposed to Python via ctypes (deepfepe_tpu_torch/data/native_loader.py,
// which builds it with g++ at first use). A copy of the JAX package's
// deepfepe_tpu/native/npy_loader.cpp: the two packages share no files.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread npy_loader.cpp -o libnpy_loader.so

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fstream>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct NpyInfo {
  std::vector<int64_t> shape;
  char dtype_kind = 'f';   // 'f' float, 'i' int, 'u' uint
  int itemsize = 4;
  bool fortran = false;
  size_t data_offset = 0;
  size_t nbytes = 0;
  bool ok = false;
};

NpyInfo parse_header(std::ifstream& f) {
  NpyInfo info;
  char magic[6];
  f.read(magic, 6);
  if (f.gcount() != 6 || std::memcmp(magic, "\x93NUMPY", 6) != 0) return info;
  unsigned char ver[2];
  f.read(reinterpret_cast<char*>(ver), 2);
  uint32_t hlen = 0;
  if (ver[0] == 1) {
    uint16_t h16;
    f.read(reinterpret_cast<char*>(&h16), 2);
    hlen = h16;
    info.data_offset = 10 + hlen;
  } else {
    f.read(reinterpret_cast<char*>(&hlen), 4);
    info.data_offset = 12 + hlen;
  }
  std::string header(hlen, '\0');
  f.read(&header[0], hlen);

  // descr
  auto dp = header.find("'descr'");
  if (dp == std::string::npos) return info;
  auto q1 = header.find('\'', dp + 7);
  auto q2 = header.find('\'', q1 + 1);
  std::string descr = header.substr(q1 + 1, q2 - q1 - 1);
  if (descr.size() >= 3) {
    info.dtype_kind = descr[1];
    info.itemsize = std::stoi(descr.substr(2));
  }
  // fortran_order
  info.fortran = header.find("'fortran_order': True") != std::string::npos;
  // shape
  auto sp = header.find("'shape'");
  auto p1 = header.find('(', sp);
  auto p2 = header.find(')', p1);
  std::string shape_s = header.substr(p1 + 1, p2 - p1 - 1);
  size_t pos = 0;
  int64_t total = 1;
  while (pos < shape_s.size()) {
    while (pos < shape_s.size() && !isdigit(shape_s[pos])) pos++;
    if (pos >= shape_s.size()) break;
    size_t end = pos;
    while (end < shape_s.size() && isdigit(shape_s[end])) end++;
    int64_t d = std::stoll(shape_s.substr(pos, end - pos));
    info.shape.push_back(d);
    total *= d;
    pos = end;
  }
  if (info.shape.empty()) total = 1;  // scalar
  info.nbytes = static_cast<size_t>(total) * info.itemsize;
  info.ok = true;
  return info;
}

struct LoadResult {
  NpyInfo info;
  std::vector<char> data;
  int status = -1;  // 0 ok, <0 error
};

LoadResult load_file(const std::string& path) {
  LoadResult r;
  std::ifstream f(path, std::ios::binary);
  if (!f.is_open()) {
    r.status = -2;
    return r;
  }
  r.info = parse_header(f);
  if (!r.info.ok) {
    r.status = -3;
    return r;
  }
  r.data.resize(r.info.nbytes);
  f.seekg(r.info.data_offset);
  f.read(r.data.data(), r.info.nbytes);
  if (static_cast<size_t>(f.gcount()) != r.info.nbytes) {
    r.status = -4;
    return r;
  }
  r.status = 0;
  return r;
}

// ---------------------------------------------------------------------------
// Thread pool with batch futures.
// ---------------------------------------------------------------------------

struct Batch {
  std::vector<std::string> paths;
  std::vector<LoadResult> results;
  std::atomic<int> remaining{0};
  std::mutex m;
  std::condition_variable cv;
};

class Pool {
 public:
  explicit Pool(int n_threads) : stop_(false) {
    for (int i = 0; i < n_threads; ++i) {
      workers_.emplace_back([this] { worker(); });
    }
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(m_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  int64_t submit(const char** paths, int n) {
    auto b = std::make_shared<Batch>();
    b->paths.assign(paths, paths + n);
    b->results.resize(n);
    b->remaining = n;
    int64_t handle = next_handle_++;
    {
      std::lock_guard<std::mutex> lk(m_);
      batches_[handle] = b;
      for (int i = 0; i < n; ++i) queue_.push_back({b, i});
    }
    cv_.notify_all();
    return handle;
  }

  std::shared_ptr<Batch> wait(int64_t handle) {
    std::shared_ptr<Batch> b;
    {
      std::lock_guard<std::mutex> lk(m_);
      auto it = batches_.find(handle);
      if (it == batches_.end()) return nullptr;
      b = it->second;
    }
    std::unique_lock<std::mutex> lk(b->m);
    b->cv.wait(lk, [&] { return b->remaining.load() == 0; });
    return b;
  }

  void free_batch(int64_t handle) {
    std::lock_guard<std::mutex> lk(m_);
    batches_.erase(handle);
  }

 private:
  void worker() {
    for (;;) {
      std::pair<std::shared_ptr<Batch>, int> task;
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_.wait(lk, [&] { return stop_ || !queue_.empty(); });
        if (stop_ && queue_.empty()) return;
        task = queue_.front();
        queue_.pop_front();
      }
      auto& b = *task.first;
      b.results[task.second] = load_file(b.paths[task.second]);
      if (b.remaining.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lk(b.m);
        b.cv.notify_all();
      }
    }
  }

  std::vector<std::thread> workers_;
  std::deque<std::pair<std::shared_ptr<Batch>, int>> queue_;
  std::unordered_map<int64_t, std::shared_ptr<Batch>> batches_;
  std::mutex m_;
  std::condition_variable cv_;
  bool stop_;
  std::atomic<int64_t> next_handle_{1};
};

Pool* g_pool = nullptr;
std::mutex g_pool_mutex;

}  // namespace

extern "C" {

// Initialize (or resize) the worker pool.
void nl_init(int n_threads) {
  std::lock_guard<std::mutex> lk(g_pool_mutex);
  delete g_pool;
  g_pool = new Pool(n_threads > 0 ? n_threads : 4);
}

// Synchronous single-file load. Returns 0 on success.
// shape_out must hold >= 8 entries; *ndim_out receives the rank.
int nl_load(const char* path, void* out, int64_t capacity,
            int64_t* shape_out, int* ndim_out, int* itemsize_out,
            char* kind_out) {
  LoadResult r = load_file(path);
  if (r.status != 0) return r.status;
  if (static_cast<int64_t>(r.info.nbytes) > capacity) {
    return -5;
  }
  std::memcpy(out, r.data.data(), r.info.nbytes);
  *ndim_out = static_cast<int>(r.info.shape.size());
  for (size_t i = 0; i < r.info.shape.size() && i < 8; ++i) {
    shape_out[i] = r.info.shape[i];
  }
  *itemsize_out = r.info.itemsize;
  *kind_out = r.info.dtype_kind;
  return 0;
}

// Probe file metadata without loading (returns nbytes or <0).
int64_t nl_probe(const char* path) {
  std::ifstream f(path, std::ios::binary);
  if (!f.is_open()) return -2;
  NpyInfo info = parse_header(f);
  if (!info.ok) return -3;
  return static_cast<int64_t>(info.nbytes);
}

// Async batch: submit n paths, returns a handle (>0) or <0.
int64_t nl_batch_submit(const char** paths, int n) {
  std::lock_guard<std::mutex> lk(g_pool_mutex);
  if (!g_pool) g_pool = new Pool(4);
  return g_pool->submit(paths, n);
}

// Wait for a batch; copy result i into out (capacity bytes). Returns status.
int nl_batch_get(int64_t handle, int idx, void* out, int64_t capacity,
                 int64_t* shape_out, int* ndim_out, int* itemsize_out,
                 char* kind_out) {
  Pool* pool;
  {
    std::lock_guard<std::mutex> lk(g_pool_mutex);
    pool = g_pool;
  }
  if (!pool) return -1;
  auto b = pool->wait(handle);
  if (!b || idx < 0 || idx >= static_cast<int>(b->results.size())) return -1;
  auto& r = b->results[idx];
  if (r.status != 0) return r.status;
  if (static_cast<int64_t>(r.info.nbytes) > capacity) return -5;
  std::memcpy(out, r.data.data(), r.info.nbytes);
  *ndim_out = static_cast<int>(r.info.shape.size());
  for (size_t i = 0; i < r.info.shape.size() && i < 8; ++i) {
    shape_out[i] = r.info.shape[i];
  }
  *itemsize_out = r.info.itemsize;
  *kind_out = r.info.dtype_kind;
  return 0;
}

int64_t nl_batch_nbytes(int64_t handle, int idx) {
  Pool* pool;
  {
    std::lock_guard<std::mutex> lk(g_pool_mutex);
    pool = g_pool;
  }
  if (!pool) return -1;
  auto b = pool->wait(handle);
  if (!b || idx < 0 || idx >= static_cast<int>(b->results.size())) return -1;
  if (b->results[idx].status != 0) return b->results[idx].status;
  return static_cast<int64_t>(b->results[idx].info.nbytes);
}

void nl_batch_free(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_pool_mutex);
  if (g_pool) g_pool->free_batch(handle);
}

}  // extern "C"
