// Native multi-threaded data feed: the TPU-native equivalent of the
// reference's C++ DataFeed/Dataset stack (data_feed.h:61 MultiSlotDataFeed,
// data_set.h:41 DatasetImpl::LoadIntoMemory spawning one parser thread per
// file, channel.h bounded MPMC queue). Re-designed, not translated: instead
// of feeding per-op scopes, it assembles contiguous batch buffers that the
// Python side wraps zero-copy as numpy arrays and ships to the TPU as one
// jax.Array per slot.
//
// Input format: MultiSlot text (one instance per line):
//   <n0> v v ... <n1> v v ... ...        (one count+values group per slot)
// Slots are declared int64 or float32. Variable-length slots are padded to
// the batch max (ragged → static shapes for XLA; SURVEY.md §5.7).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <mutex>
#include <random>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

struct SlotDesc {
  std::string name;
  bool is_float = false;
};

// One parsed instance: per slot, a (values) vector.
struct Instance {
  std::vector<std::vector<int64_t>> int_slots;
  std::vector<std::vector<float>> float_slots;
};

struct Feed {
  std::vector<SlotDesc> slots;
  std::vector<std::string> files;
  std::vector<Instance> memory;     // in-memory dataset
  std::mutex mu;
  std::atomic<size_t> cursor{0};
  std::string error;

  // batch staging buffers (per slot), exposed to python between
  // next_batch() and the next call
  std::vector<std::vector<int64_t>> batch_int;
  std::vector<std::vector<float>> batch_float;
  std::vector<std::vector<int64_t>> batch_lod;  // per-slot lengths
  std::vector<int64_t> batch_maxlen;
};

bool parse_line(const std::string& line, const std::vector<SlotDesc>& slots,
                Instance* out) {
  const char* p = line.c_str();
  char* end = nullptr;
  out->int_slots.assign(slots.size(), {});
  out->float_slots.assign(slots.size(), {});
  for (size_t s = 0; s < slots.size(); ++s) {
    long n = std::strtol(p, &end, 10);
    if (end == p || n < 0) return false;
    p = end;
    if (slots[s].is_float) {
      auto& vec = out->float_slots[s];
      vec.reserve(n);
      for (long i = 0; i < n; ++i) {
        float v = std::strtof(p, &end);
        if (end == p) return false;
        p = end;
        vec.push_back(v);
      }
    } else {
      auto& vec = out->int_slots[s];
      vec.reserve(n);
      for (long i = 0; i < n; ++i) {
        long long v = std::strtoll(p, &end, 10);
        if (end == p) return false;
        p = end;
        vec.push_back(v);
      }
    }
  }
  return true;
}

void load_file(Feed* feed, const std::string& path,
               std::vector<Instance>* out, std::string* err) {
  std::ifstream in(path);
  if (!in) {
    *err = "cannot open " + path;
    return;
  }
  std::string line;
  while (std::getline(in, line)) {
    if (line.empty()) continue;
    Instance inst;
    if (!parse_line(line, feed->slots, &inst)) {
      *err = "parse error in " + path + ": " + line.substr(0, 80);
      return;
    }
    out->push_back(std::move(inst));
  }
}

}  // namespace

extern "C" {

// slots_spec: comma-separated "name:i" (int64) / "name:f" (float32)
void* df_create(const char* slots_spec) {
  auto* feed = new Feed();
  std::stringstream ss(slots_spec);
  std::string item;
  while (std::getline(ss, item, ',')) {
    auto pos = item.rfind(':');
    SlotDesc d;
    d.name = item.substr(0, pos);
    d.is_float = pos != std::string::npos && item[pos + 1] == 'f';
    feed->slots.push_back(d);
  }
  size_t ns = feed->slots.size();
  feed->batch_int.resize(ns);
  feed->batch_float.resize(ns);
  feed->batch_lod.resize(ns);
  feed->batch_maxlen.resize(ns);
  return feed;
}

void df_destroy(void* h) { delete static_cast<Feed*>(h); }

void df_add_file(void* h, const char* path) {
  static_cast<Feed*>(h)->files.push_back(path);
}

// Parallel load: one parser thread per file (DatasetImpl::LoadIntoMemory,
// data_set.cc:184-193). Returns number of instances, -1 on error.
int64_t df_load_into_memory(void* h, int num_threads) {
  auto* feed = static_cast<Feed*>(h);
  size_t nf = feed->files.size();
  std::vector<std::vector<Instance>> parts(nf);
  std::vector<std::string> errs(nf);
  size_t pool = std::max(1, num_threads);
  std::atomic<size_t> next{0};
  std::vector<std::thread> threads;
  for (size_t t = 0; t < std::min(pool, nf); ++t) {
    threads.emplace_back([&] {
      size_t i;
      while ((i = next.fetch_add(1)) < nf) {
        load_file(feed, feed->files[i], &parts[i], &errs[i]);
      }
    });
  }
  for (auto& th : threads) th.join();
  for (size_t i = 0; i < nf; ++i) {
    if (!errs[i].empty()) {
      feed->error = errs[i];
      return -1;
    }
  }
  feed->memory.clear();
  for (auto& p : parts) {
    for (auto& inst : p) feed->memory.push_back(std::move(inst));
  }
  feed->cursor = 0;
  return static_cast<int64_t>(feed->memory.size());
}

const char* df_last_error(void* h) {
  return static_cast<Feed*>(h)->error.c_str();
}

// Global shuffle of the in-memory dataset (Dataset::GlobalShuffle analog —
// single-host here; multi-host sharding happens via file assignment).
void df_shuffle(void* h, uint64_t seed) {
  auto* feed = static_cast<Feed*>(h);
  std::mt19937_64 rng(seed);
  std::shuffle(feed->memory.begin(), feed->memory.end(), rng);
  feed->cursor = 0;
}

void df_reset(void* h) { static_cast<Feed*>(h)->cursor = 0; }

// Assemble the next batch into staging buffers. Returns actual batch size
// (0 = epoch end). Variable-length slots are padded with pad_value; lengths
// (the LoD analog) are recorded per instance.
int64_t df_next_batch(void* h, int64_t batch_size, int64_t pad_value,
                      int drop_last) {
  auto* feed = static_cast<Feed*>(h);
  size_t start = feed->cursor.fetch_add(batch_size);
  size_t end = std::min(start + batch_size, feed->memory.size());
  if (start >= feed->memory.size()) return 0;
  int64_t bs = static_cast<int64_t>(end - start);
  if (drop_last && bs < batch_size) return 0;
  size_t ns = feed->slots.size();
  for (size_t s = 0; s < ns; ++s) {
    int64_t maxlen = 1;
    for (size_t i = start; i < end; ++i) {
      const auto& inst = feed->memory[i];
      int64_t len = feed->slots[s].is_float
                        ? inst.float_slots[s].size()
                        : inst.int_slots[s].size();
      maxlen = std::max(maxlen, len);
    }
    feed->batch_maxlen[s] = maxlen;
    auto& lod = feed->batch_lod[s];
    lod.assign(bs, 0);
    if (feed->slots[s].is_float) {
      auto& buf = feed->batch_float[s];
      buf.assign(bs * maxlen, static_cast<float>(pad_value));
      for (int64_t i = 0; i < bs; ++i) {
        const auto& v = feed->memory[start + i].float_slots[s];
        lod[i] = v.size();
        std::memcpy(&buf[i * maxlen], v.data(), v.size() * sizeof(float));
      }
    } else {
      auto& buf = feed->batch_int[s];
      buf.assign(bs * maxlen, pad_value);
      for (int64_t i = 0; i < bs; ++i) {
        const auto& v = feed->memory[start + i].int_slots[s];
        lod[i] = v.size();
        std::memcpy(&buf[i * maxlen], v.data(),
                    v.size() * sizeof(int64_t));
      }
    }
  }
  return bs;
}

int64_t df_slot_maxlen(void* h, int slot) {
  return static_cast<Feed*>(h)->batch_maxlen[slot];
}

const int64_t* df_slot_int_data(void* h, int slot) {
  return static_cast<Feed*>(h)->batch_int[slot].data();
}

const float* df_slot_float_data(void* h, int slot) {
  return static_cast<Feed*>(h)->batch_float[slot].data();
}

const int64_t* df_slot_lengths(void* h, int slot) {
  return static_cast<Feed*>(h)->batch_lod[slot].data();
}

int64_t df_size(void* h) {
  return static_cast<int64_t>(static_cast<Feed*>(h)->memory.size());
}

}  // extern "C"
