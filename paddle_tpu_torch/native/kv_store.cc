// Host-resident KV embedding store: the TPU-native analog of the
// reference's parameter-server sparse world. Where fluid serves massive
// embedding tables from pserver processes (FleetWrapper::PullSparseVarsSync
// fleet_wrapper.h:76, PushDenseVarsAsync :96; listen_and_serv_op.cc:110;
// communicator.h:166 send-queue merge), the TPU design keeps beyond-HBM
// tables in HOST memory on each worker: the device step only ever sees the
// gathered rows for the current batch, pulled ahead of time so the host
// lookup overlaps the previous TPU step (the "prefetch RPC" becomes a
// host->HBM copy of a few MB).
//
// Design (re-designed, not translated):
//   - sharded open hash (per-shard mutex) id -> row; rows hold the
//     embedding values plus optimizer slot state inline (pslib-style
//     "value fields": [w..., slot...]).
//   - lazy row init on first pull (deterministic per-id splitmix64 RNG so
//     a re-created store reproduces the same table).
//   - batched pull/push over a thread pool; async tickets for prefetch
//     (pull) and hogwild-style delayed application (push).
//   - sparse optimizers applied host-side at push: SGD / Adagrad.
//   - save/load a flat binary snapshot (checkpoint integration).
//
// C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// uniform in [-scale, scale) from a 64-bit hash
inline float hash_uniform(uint64_t h, float scale) {
  // take 24 mantissa-ish bits -> [0,1)
  float u = static_cast<float>((h >> 40) & 0xFFFFFF) / 16777216.0f;
  return (2.0f * u - 1.0f) * scale;
}

enum OptType { OPT_SGD = 0, OPT_ADAGRAD = 1 };

class ThreadPool {
 public:
  explicit ThreadPool(int n) {
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { Loop(); });
  }
  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> g(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }
  void Submit(std::function<void()> f) {
    {
      std::lock_guard<std::mutex> g(mu_);
      tasks_.push_back(std::move(f));
    }
    cv_.notify_one();
  }

 private:
  void Loop() {
    for (;;) {
      std::function<void()> task;
      {
        std::unique_lock<std::mutex> g(mu_);
        cv_.wait(g, [this] { return stop_ || !tasks_.empty(); });
        if (stop_ && tasks_.empty()) return;
        task = std::move(tasks_.front());
        tasks_.pop_front();
      }
      task();
    }
  }
  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<std::function<void()>> tasks_;
  std::vector<std::thread> workers_;
  bool stop_ = false;
};

// Completion tracker for an async ticket.
struct Job {
  std::mutex mu;
  std::condition_variable cv;
  int remaining = 0;
  void Done() {
    std::lock_guard<std::mutex> g(mu);
    if (--remaining == 0) cv.notify_all();
  }
  void Wait() {
    std::unique_lock<std::mutex> g(mu);
    cv.wait(g, [this] { return remaining == 0; });
  }
};

struct Shard {
  std::mutex mu;
  std::unordered_map<int64_t, uint64_t> index;  // id -> row offset
  std::vector<float> data;                      // row_width floats per row
};

class KVStore {
 public:
  KVStore(int dim, int opt_type, float init_scale, uint64_t seed,
          int num_shards, int num_threads)
      : dim_(dim),
        opt_(opt_type),
        init_scale_(init_scale),
        seed_(seed),
        shards_(num_shards),
        pool_(num_threads) {
    slot_dim_ = (opt_ == OPT_ADAGRAD) ? dim_ : 0;
    row_width_ = dim_ + slot_dim_;
  }

  int dim() const { return dim_; }

  // ---- row access helpers (caller holds shard lock) ----
  float* RowOrInit(Shard& sh, int64_t id) {
    auto it = sh.index.find(id);
    if (it == sh.index.end()) {
      uint64_t off = sh.data.size();
      sh.data.resize(off + row_width_);
      float* row = sh.data.data() + off;
      uint64_t h = splitmix64(seed_ ^ static_cast<uint64_t>(id));
      for (int j = 0; j < dim_; ++j) {
        h = splitmix64(h);
        row[j] = hash_uniform(h, init_scale_);
      }
      for (int j = dim_; j < row_width_; ++j) row[j] = 0.0f;
      sh.index.emplace(id, off);
      return row;
    }
    return sh.data.data() + it->second;
  }

  Shard& ShardFor(int64_t id) {
    uint64_t h = splitmix64(static_cast<uint64_t>(id));
    return shards_[h % shards_.size()];
  }

  void PullChunk(const int64_t* ids, int64_t lo, int64_t hi, float* out) {
    for (int64_t i = lo; i < hi; ++i) {
      Shard& sh = ShardFor(ids[i]);
      std::lock_guard<std::mutex> g(sh.mu);
      const float* row = RowOrInit(sh, ids[i]);
      std::memcpy(out + i * dim_, row, sizeof(float) * dim_);
    }
  }

  void PushChunk(const int64_t* ids, int64_t lo, int64_t hi,
                 const float* grads, float lr) {
    for (int64_t i = lo; i < hi; ++i) {
      Shard& sh = ShardFor(ids[i]);
      std::lock_guard<std::mutex> g(sh.mu);
      float* row = RowOrInit(sh, ids[i]);
      const float* grad = grads + i * dim_;
      if (opt_ == OPT_ADAGRAD) {
        float* acc = row + dim_;
        for (int j = 0; j < dim_; ++j) {
          acc[j] += grad[j] * grad[j];
          row[j] -= lr * grad[j] / (std::sqrt(acc[j]) + 1e-8f);
        }
      } else {  // SGD
        for (int j = 0; j < dim_; ++j) row[j] -= lr * grad[j];
      }
    }
  }

  void SetChunk(const int64_t* ids, int64_t lo, int64_t hi,
                const float* vals) {
    for (int64_t i = lo; i < hi; ++i) {
      Shard& sh = ShardFor(ids[i]);
      std::lock_guard<std::mutex> g(sh.mu);
      float* row = RowOrInit(sh, ids[i]);
      std::memcpy(row, vals + i * dim_, sizeof(float) * dim_);
    }
  }

  // ---- batched parallel ops ----
  static constexpr int64_t kChunk = 2048;

  // Runs op over [0,n) in parallel chunks and waits.
  template <typename F>
  void ParallelFor(int64_t n, F op) {
    int64_t nchunks = (n + kChunk - 1) / kChunk;
    Job sync;
    sync.remaining = static_cast<int>(nchunks);
    for (int64_t c = 0; c < nchunks; ++c) {
      int64_t lo = c * kChunk, hi = std::min(n, lo + kChunk);
      pool_.Submit([&, lo, hi] {
        op(lo, hi);
        sync.Done();
      });
    }
    sync.Wait();
  }

  // Async variant: the Job's remaining count is set BEFORE the ticket is
  // published (a concurrent kv_wait/kv_flush must never observe a
  // zero-remaining job whose chunks are still being submitted) and the
  // chunks are submitted only after. op buffers must outlive kv_wait.
  template <typename F>
  int64_t ParallelForAsync(int64_t n, F op) {
    int64_t nchunks = (n + kChunk - 1) / kChunk;
    auto owned = std::make_unique<Job>();
    Job* job = owned.get();
    job->remaining = static_cast<int>(nchunks) + 1;  // +1 submission guard
    int64_t ticket;
    {
      std::lock_guard<std::mutex> g(jobs_mu_);
      ticket = next_ticket_++;
      jobs_[ticket] = std::move(owned);
    }
    for (int64_t c = 0; c < nchunks; ++c) {
      int64_t lo = c * kChunk, hi = std::min(n, lo + kChunk);
      pool_.Submit([job, op, lo, hi] {
        op(lo, hi);
        job->Done();
      });
    }
    job->Done();  // release the submission guard
    return ticket;
  }

  void WaitTicket(int64_t t) {
    std::unique_ptr<Job> job;
    {
      std::lock_guard<std::mutex> g(jobs_mu_);
      auto it = jobs_.find(t);
      if (it == jobs_.end()) return;
      job = std::move(it->second);
      jobs_.erase(it);
    }
    job->Wait();
  }

  void Flush() {
    std::vector<int64_t> pending;
    {
      std::lock_guard<std::mutex> g(jobs_mu_);
      for (auto& kv : jobs_) pending.push_back(kv.first);
    }
    for (int64_t t : pending) WaitTicket(t);
  }

  int64_t Size() {
    int64_t n = 0;
    for (auto& sh : shards_) {
      std::lock_guard<std::mutex> g(sh.mu);
      n += static_cast<int64_t>(sh.index.size());
    }
    return n;
  }

  // snapshot format: magic,u32 | dim,u32 | opt,u32 | count,u64 |
  //                  count * (id,i64 + row_width floats)
  bool Save(const char* path) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return false;
    uint32_t magic = 0x4B565354, d = dim_, o = opt_;
    uint64_t count = static_cast<uint64_t>(Size());
    bool ok = std::fwrite(&magic, 4, 1, f) == 1 &&
              std::fwrite(&d, 4, 1, f) == 1 &&
              std::fwrite(&o, 4, 1, f) == 1 &&
              std::fwrite(&count, 8, 1, f) == 1;
    for (auto& sh : shards_) {
      std::lock_guard<std::mutex> g(sh.mu);
      for (auto& kv : sh.index) {
        if (!ok) break;
        ok = std::fwrite(&kv.first, 8, 1, f) == 1 &&
             std::fwrite(sh.data.data() + kv.second, sizeof(float),
                         row_width_, f) == static_cast<size_t>(row_width_);
      }
    }
    ok = (std::fclose(f) == 0) && ok;
    return ok;
  }

  // Restore is all-or-nothing: the snapshot is staged and validated in
  // full, then the table is REPLACED (rows not in the snapshot are
  // dropped — a true rollback, matching checkpoint-resume semantics).
  bool Load(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    uint32_t magic = 0, d = 0, o = 0;
    uint64_t count = 0;
    bool ok = std::fread(&magic, 4, 1, f) == 1 &&
              std::fread(&d, 4, 1, f) == 1 && std::fread(&o, 4, 1, f) == 1 &&
              std::fread(&count, 8, 1, f) == 1 && magic == 0x4B565354 &&
              static_cast<int>(d) == dim_ && static_cast<int>(o) == opt_;
    std::vector<int64_t> ids;
    std::vector<float> rows;
    if (ok) {
      ids.reserve(count);
      rows.reserve(count * row_width_);
    }
    std::vector<float> buf(row_width_);
    for (uint64_t i = 0; ok && i < count; ++i) {
      int64_t id;
      ok = std::fread(&id, 8, 1, f) == 1 &&
           std::fread(buf.data(), sizeof(float), row_width_, f) ==
               static_cast<size_t>(row_width_);
      if (ok) {
        ids.push_back(id);
        rows.insert(rows.end(), buf.begin(), buf.end());
      }
    }
    std::fclose(f);
    if (!ok) return false;  // staging only — table untouched
    for (auto& sh : shards_) {
      std::lock_guard<std::mutex> g(sh.mu);
      sh.index.clear();
      sh.data.clear();
    }
    for (size_t i = 0; i < ids.size(); ++i) {
      Shard& sh = ShardFor(ids[i]);
      std::lock_guard<std::mutex> g(sh.mu);
      float* row = RowOrInit(sh, ids[i]);
      std::memcpy(row, rows.data() + i * row_width_,
                  sizeof(float) * row_width_);
    }
    return true;
  }

  int dim_, slot_dim_, row_width_;
  int opt_;
  float init_scale_;
  uint64_t seed_;
  std::vector<Shard> shards_;
  ThreadPool pool_;

  std::mutex jobs_mu_;
  std::unordered_map<int64_t, std::unique_ptr<Job>> jobs_;
  int64_t next_ticket_ = 1;
};

// owned copies for async push (buffers may be reused by the caller)
struct PushTask {
  std::vector<int64_t> ids;
  std::vector<float> grads;
};

}  // namespace

extern "C" {

void* kv_create(int dim, int opt_type, float init_scale, uint64_t seed,
                int num_shards, int num_threads) {
  if (dim <= 0 || num_shards <= 0 || num_threads <= 0) return nullptr;
  return new KVStore(dim, opt_type, init_scale, seed, num_shards,
                     num_threads);
}

void kv_destroy(void* h) { delete static_cast<KVStore*>(h); }

void kv_pull(void* h, const int64_t* ids, int64_t n, float* out) {
  auto* s = static_cast<KVStore*>(h);
  s->ParallelFor(
      n, [=](int64_t lo, int64_t hi) { s->PullChunk(ids, lo, hi, out); });
}

// async pull: ids/out must stay valid until kv_wait(ticket)
int64_t kv_pull_async(void* h, const int64_t* ids, int64_t n, float* out) {
  auto* s = static_cast<KVStore*>(h);
  return s->ParallelForAsync(
      n, [=](int64_t lo, int64_t hi) { s->PullChunk(ids, lo, hi, out); });
}

void kv_push(void* h, const int64_t* ids, int64_t n, const float* grads,
             float lr) {
  auto* s = static_cast<KVStore*>(h);
  s->ParallelFor(n, [=](int64_t lo, int64_t hi) {
    s->PushChunk(ids, lo, hi, grads, lr);
  });
}

// async push: copies inputs, applies in background (hogwild-delayed like
// the reference's AsyncCommunicator send queue). kv_flush waits for all.
int64_t kv_push_async(void* h, const int64_t* ids, int64_t n,
                      const float* grads, float lr) {
  auto* s = static_cast<KVStore*>(h);
  auto task = std::make_shared<PushTask>();
  task->ids.assign(ids, ids + n);
  task->grads.assign(grads, grads + n * s->dim());
  return s->ParallelForAsync(n, [=](int64_t lo, int64_t hi) {
    s->PushChunk(task->ids.data(), lo, hi, task->grads.data(), lr);
  });
}

void kv_wait(void* h, int64_t ticket) {
  static_cast<KVStore*>(h)->WaitTicket(ticket);
}

void kv_flush(void* h) { static_cast<KVStore*>(h)->Flush(); }

void kv_set_rows(void* h, const int64_t* ids, int64_t n, const float* vals) {
  auto* s = static_cast<KVStore*>(h);
  s->ParallelFor(n, [=](int64_t lo, int64_t hi) {
    s->SetChunk(ids, lo, hi, vals);
  });
}

int64_t kv_size(void* h) { return static_cast<KVStore*>(h)->Size(); }

int kv_save(void* h, const char* path) {
  return static_cast<KVStore*>(h)->Save(path) ? 0 : -1;
}

int kv_load(void* h, const char* path) {
  return static_cast<KVStore*>(h)->Load(path) ? 0 : -1;
}

}  // extern "C"
