// TCP parameter-server shell around the host KV store: the
// listen_and_serv / send-recv substrate, TPU-native.
//
// Reference mapping: fluid's PS world runs pserver PROCESSES
// (listen_and_serv_op.cc:110 blocking gRPC loop; send_op/recv_op move
// selected-rows over the wire; 5.7k LoC distributed/ RPC substrate). The
// TPU design keeps most sparse state host-local (kv_store.cc), but tables
// shared ACROSS trainer hosts still need a server: this file serves a
// KVStore over a length-prefixed binary TCP protocol — thread per
// connection, batched pull/push per request (one round trip per training
// step, like PullSparseVarsSync).
//
// Protocol (all little-endian, one request per message):
//   request:  u8 opcode | u64 n | payload
//   OP_PULL(1):  ids i64[n]                      -> f32[n*dim]
//   OP_PUSH(2):  f32 lr | ids i64[n] | g f32[n*dim] -> u8 ok
//   OP_SET(3):   ids i64[n] | vals f32[n*dim]    -> u8 ok
//   OP_SIZE(4):                                   -> u64
//   OP_DIM(5):                                    -> u32
//   OP_SAVE(6):  path bytes[n]                    -> u8 ok
//   OP_LOAD(7):  path bytes[n]                    -> u8 ok
//
// Built together with kv_store.cc (uses its C ABI).

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {
void* kv_create(int dim, int opt_type, float init_scale, uint64_t seed,
                int num_shards, int num_threads);
void kv_destroy(void* h);
void kv_pull(void* h, const int64_t* ids, int64_t n, float* out);
void kv_push(void* h, const int64_t* ids, int64_t n, const float* grads,
             float lr);
void kv_set_rows(void* h, const int64_t* ids, int64_t n, const float* vals);
int64_t kv_size(void* h);
int kv_save(void* h, const char* path);
int kv_load(void* h, const char* path);
}

namespace {

enum Op : uint8_t {
  OP_PULL = 1,
  OP_PUSH = 2,
  OP_SET = 3,
  OP_SIZE = 4,
  OP_DIM = 5,
  OP_SAVE = 6,
  OP_LOAD = 7,
};

bool read_full(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

struct Server {
  void* store = nullptr;
  int dim = 0;
  int listen_fd = -1;
  int port = 0;
  std::atomic<bool> stopping{false};
  std::thread accept_thread;
  std::vector<std::thread> conns;
  std::vector<int> client_fds;
  std::mutex conns_mu;

  ~Server() { Stop(); }

  // requests larger than this are malformed (a training batch is a few
  // hundred thousand ids at most); oversized n from stray bytes on the
  // port must drop the CONNECTION, not feed resize() and terminate the
  // hosting process
  static constexpr uint64_t kMaxN = 1u << 24;

  void Serve(int fd) {
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    std::vector<int64_t> ids;
    std::vector<float> vals;
    for (;;) {
      uint8_t op;
      uint64_t n;
      if (!read_full(fd, &op, 1) || !read_full(fd, &n, 8)) break;
      if (n > kMaxN) break;
      bool ok = true;
      switch (op) {
        case OP_PULL: {
          ids.resize(n);
          vals.resize(n * dim);
          ok = read_full(fd, ids.data(), n * 8);
          if (!ok) break;
          kv_pull(store, ids.data(), static_cast<int64_t>(n), vals.data());
          ok = write_full(fd, vals.data(), vals.size() * 4);
          break;
        }
        case OP_PUSH: {
          float lr;
          ids.resize(n);
          vals.resize(n * dim);
          ok = read_full(fd, &lr, 4) && read_full(fd, ids.data(), n * 8) &&
               read_full(fd, vals.data(), vals.size() * 4);
          if (!ok) break;
          kv_push(store, ids.data(), static_cast<int64_t>(n), vals.data(),
                  lr);
          uint8_t r = 1;
          ok = write_full(fd, &r, 1);
          break;
        }
        case OP_SET: {
          ids.resize(n);
          vals.resize(n * dim);
          ok = read_full(fd, ids.data(), n * 8) &&
               read_full(fd, vals.data(), vals.size() * 4);
          if (!ok) break;
          kv_set_rows(store, ids.data(), static_cast<int64_t>(n),
                      vals.data());
          uint8_t r = 1;
          ok = write_full(fd, &r, 1);
          break;
        }
        case OP_SIZE: {
          uint64_t s = static_cast<uint64_t>(kv_size(store));
          ok = write_full(fd, &s, 8);
          break;
        }
        case OP_DIM: {
          uint32_t d = static_cast<uint32_t>(dim);
          ok = write_full(fd, &d, 4);
          break;
        }
        case OP_SAVE:
        case OP_LOAD: {
          std::string path(n, '\0');
          ok = read_full(fd, path.data(), n);
          if (!ok) break;
          int rc = (op == OP_SAVE) ? kv_save(store, path.c_str())
                                   : kv_load(store, path.c_str());
          uint8_t r = rc == 0 ? 1 : 0;
          ok = write_full(fd, &r, 1);
          break;
        }
        default:
          ok = false;
      }
      if (!ok) break;
    }
    ::close(fd);
    std::lock_guard<std::mutex> g(conns_mu);
    client_fds.erase(
        std::find(client_fds.begin(), client_fds.end(), fd));
  }

  bool Start(int want_port) {
    listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd < 0) return false;
    int one = 1;
    ::setsockopt(listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr;
    std::memset(&addr, 0, sizeof(addr));
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = htons(static_cast<uint16_t>(want_port));
    if (::bind(listen_fd, reinterpret_cast<sockaddr*>(&addr),
               sizeof(addr)) != 0 ||
        ::listen(listen_fd, 64) != 0) {
      ::close(listen_fd);
      listen_fd = -1;
      return false;
    }
    socklen_t len = sizeof(addr);
    ::getsockname(listen_fd, reinterpret_cast<sockaddr*>(&addr), &len);
    port = ntohs(addr.sin_port);
    accept_thread = std::thread([this] {
      for (;;) {
        int fd = ::accept(listen_fd, nullptr, nullptr);
        if (fd < 0) {
          if (stopping.load()) return;
          continue;
        }
        // register the fd BEFORE the serve thread exists: Stop() must
        // always see (and shutdown) every accepted connection, even one
        // whose thread the OS has not scheduled yet
        std::lock_guard<std::mutex> g(conns_mu);
        client_fds.push_back(fd);
        conns.emplace_back([this, fd] { Serve(fd); });
      }
    });
    return true;
  }

  void Stop() {
    if (listen_fd >= 0) {
      stopping.store(true);
      ::shutdown(listen_fd, SHUT_RDWR);
      ::close(listen_fd);
      if (accept_thread.joinable()) accept_thread.join();
      {
        // unblock serve threads parked in recv() on live clients —
        // without this, Stop() hangs until every trainer disconnects
        std::lock_guard<std::mutex> g(conns_mu);
        for (int fd : client_fds) ::shutdown(fd, SHUT_RDWR);
      }
      // join WITHOUT holding conns_mu: exiting Serve threads take it to
      // deregister their fd (holding it here would deadlock the join)
      std::vector<std::thread> to_join;
      {
        std::lock_guard<std::mutex> g(conns_mu);
        to_join.swap(conns);
      }
      for (auto& t : to_join)
        if (t.joinable()) t.join();
      {
        std::lock_guard<std::mutex> g(conns_mu);
        client_fds.clear();
      }
      listen_fd = -1;
    }
    if (store) {
      kv_destroy(store);
      store = nullptr;
    }
  }
};

}  // namespace

extern "C" {

// Creates a KV store and serves it on localhost:port (0 = ephemeral).
// Returns a handle or nullptr.
void* kvs_start(int dim, int opt_type, float init_scale, uint64_t seed,
                int num_shards, int num_threads, int port) {
  Server* s = new Server();
  s->store = kv_create(dim, opt_type, init_scale, seed, num_shards,
                       num_threads);
  s->dim = dim;
  if (!s->store || !s->Start(port)) {
    delete s;
    return nullptr;
  }
  return s;
}

int kvs_port(void* h) { return static_cast<Server*>(h)->port; }

void kvs_stop(void* h) { delete static_cast<Server*>(h); }

}  // extern "C"
