// Native serving runner over AOTInductor (the role of the reference's
// paddle_tpu/native/pjrt_runner.cc): a C ABI over
// torch::inductor::AOTIModelPackageLoader that serves a frozen package
// written by save_inference_model(freeze_native=True), and a main that
// serves requests over two pipes with no Python in the process.
//
// A model directory holds __model__frozen__.pt2 (the AOTInductor package:
// the compiled program with its weights) and meta.json (input names, the
// inputs' and outputs' shapes and dtypes, the device). Inputs and outputs
// cross the ABI as raw host bytes in those shapes and dtypes.
//
// The program's flash attention is the op ptt::flash_fwd, which ptt_ops.cc
// registers in this process; on the card it launches K5 from the library
// named by --flash-lib and counts the launch.
//
//   aoti_runner serve MODEL_DIR IN_FD OUT_FD SHM_FD [--flash-lib PATH]
//     reads request frames from IN_FD and writes reply frames to OUT_FD
//     (frame: int32 code, int64 length, payload; native byte order).
//     First reply: code 0, "<n_inputs> <n_outputs> <device>", or code 1
//     and the error. Requests: code 1 run (payload: the inputs' bytes, in
//     order), code 0 quit. A run copies its outputs from the device
//     straight into SHM_FD, a shared memory file the caller sized to the
//     outputs' bytes (in order), and replies code 0 with int64 K5
//     launches, int64 device microseconds (inputs on the device to
//     outputs ready) and int64 copy-out microseconds; or code 1 and the
//     error. An error never ends the loop.
//   aoti_runner flash_fwd DIR DEVICE [REPS] [--flash-lib PATH]
//     runs ptt::flash_fwd once on the tensors DIR/args.txt describes
//     (lines "name dtype rank dims..." for q, k, v and an optional bias,
//     each in DIR/<name>.bin; "causal 0|1"; "scale none|<value>") on
//     DEVICE, writes DIR/out.bin and DIR/lse.bin and prints the launches;
//     with REPS, then times REPS calls back to back (host clock from the
//     first call to the device's end of the last) and prints the mean ms.
//   aoti_runner schema
//     prints the schema of ptt::flash_fwd as the dispatcher holds it.

#include <ATen/ATen.h>
#include <ATen/core/dispatch/Dispatcher.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <sys/mman.h>
#include <unistd.h>

#include <algorithm>
#include <cctype>
#include <cerrno>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <memory>
#include <optional>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

#include "ptt_ops.h"

namespace {

// -- meta.json: just enough JSON for objects, arrays, strings, numbers --

struct Json {
  enum Kind { kNull, kBool, kNum, kStr, kArr, kObj } kind = kNull;
  double num = 0;
  bool b = false;
  std::string str;
  std::vector<Json> arr;
  std::vector<std::pair<std::string, Json>> obj;

  const Json& at(const std::string& key) const {
    for (const auto& kv : obj)
      if (kv.first == key) return kv.second;
    throw std::runtime_error("meta.json: no key \"" + key + "\"");
  }
};

struct JsonParser {
  const std::string& s;
  size_t i = 0;

  void ws() {
    while (i < s.size() && std::isspace(static_cast<unsigned char>(s[i])))
      ++i;
  }
  [[noreturn]] void fail(const char* what) {
    throw std::runtime_error(std::string("meta.json: ") + what +
                             " at byte " + std::to_string(i));
  }
  char peek() {
    ws();
    if (i >= s.size()) fail("unexpected end");
    return s[i];
  }
  void expect(char c) {
    if (peek() != c) fail("unexpected character");
    ++i;
  }
  std::string string() {
    expect('"');
    std::string out;
    while (i < s.size() && s[i] != '"') {
      if (s[i] == '\\') {
        ++i;
        if (i >= s.size()) fail("bad escape");
        const char c = s[i];
        out += c == 'n' ? '\n' : c == 't' ? '\t' : c;
      } else {
        out += s[i];
      }
      ++i;
    }
    expect('"');
    return out;
  }
  Json value() {
    Json v;
    const char c = peek();
    if (c == '{') {
      v.kind = Json::kObj;
      ++i;
      if (peek() == '}') return ++i, v;
      for (;;) {
        std::string key = string();
        expect(':');
        v.obj.emplace_back(std::move(key), value());
        if (peek() == ',') { ++i; continue; }
        expect('}');
        return v;
      }
    }
    if (c == '[') {
      v.kind = Json::kArr;
      ++i;
      if (peek() == ']') return ++i, v;
      for (;;) {
        v.arr.push_back(value());
        if (peek() == ',') { ++i; continue; }
        expect(']');
        return v;
      }
    }
    if (c == '"') {
      v.kind = Json::kStr;
      v.str = string();
      return v;
    }
    for (const char* word : {"null", "true", "false"}) {
      if (s.compare(i, std::strlen(word), word) == 0) {
        i += std::strlen(word);
        v.kind = word[0] == 'n' ? Json::kNull : Json::kBool;
        v.b = word[0] == 't';
        return v;
      }
    }
    size_t used = 0;
    try {
      v.num = std::stod(s.substr(i, 32), &used);
    } catch (const std::exception&) {
      fail("bad value");
    }
    i += used;
    v.kind = Json::kNum;
    return v;
  }
};

std::string read_file(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("cannot open " + path);
  std::ostringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

at::ScalarType dtype_of(const std::string& name) {
  static const std::pair<const char*, at::ScalarType> kNames[] = {
      {"float32", at::kFloat},  {"float64", at::kDouble},
      {"bfloat16", at::kBFloat16}, {"float16", at::kHalf},
      {"int64", at::kLong},     {"int32", at::kInt},
      {"int16", at::kShort},    {"int8", at::kChar},
      {"uint8", at::kByte},     {"bool", at::kBool}};
  for (const auto& kv : kNames)
    if (name == kv.first) return kv.second;
  throw std::runtime_error("unsupported dtype " + name);
}

struct Spec {
  std::vector<int64_t> shape;
  at::ScalarType dtype;
  int64_t nbytes = 0;
};

Spec spec_of(const Json& j) {
  Spec s;
  s.dtype = dtype_of(j.at("dtype").str);
  s.nbytes = static_cast<int64_t>(c10::elementSize(s.dtype));
  for (const auto& d : j.at("shape").arr) {
    s.shape.push_back(static_cast<int64_t>(d.num));
    s.nbytes *= s.shape.back();
  }
  return s;
}

struct Runner {
  std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader;
  std::vector<Spec> ins, outs;
  c10::Device device = c10::Device(c10::kCPU);
};

void set_error(char* err, int errlen, const std::string& msg) {
  if (err == nullptr || errlen <= 0) return;
  std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
}

// c10::Error's what() carries a C++ backtrace; its message alone is the
// error
std::string message_of(const std::exception& e) {
  if (auto* ce = dynamic_cast<const c10::Error*>(&e)) return ce->msg();
  return e.what();
}

void synchronize(const c10::Device& device) {
  if (device.is_cuda()) {
    const auto* impl = c10::impl::getDeviceGuardImpl(device.type());
    impl->synchronizeStream(impl->getStream(device));
  }
}

int64_t micros_since(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now() - t0)
      .count();
}

}  // namespace

extern "C" {

// Load MODEL_DIR's frozen package for the device meta.json names.
// Returns a handle, or null with the error in err.
void* aor_create(const char* model_dir, char* err, int errlen) {
  try {
    const std::string dir(model_dir);
    const auto meta = JsonParser{read_file(dir + "/meta.json")}.value();
    auto r = std::make_unique<Runner>();
    for (const auto& j : meta.at("inputs").arr) r->ins.push_back(spec_of(j));
    for (const auto& j : meta.at("outputs").arr) r->outs.push_back(spec_of(j));
    r->device = c10::Device(meta.at("device").str);
    const c10::DeviceIndex index = r->device.is_cuda()
        ? (r->device.has_index() ? r->device.index() : 0)
        : static_cast<c10::DeviceIndex>(-1);
    if (r->device.is_cuda() && !r->device.has_index())
      r->device = c10::Device(c10::kCUDA, 0);
    r->loader = std::make_unique<torch::inductor::AOTIModelPackageLoader>(
        dir + "/__model__frozen__.pt2", "model", false, 1, index);
    return r.release();
  } catch (const std::exception& e) {
    set_error(err, errlen, message_of(e));
    return nullptr;
  }
}

int aor_num_inputs(void* h) {
  return static_cast<int>(static_cast<Runner*>(h)->ins.size());
}

int aor_num_outputs(void* h) {
  return static_cast<int>(static_cast<Runner*>(h)->outs.size());
}

long long aor_input_bytes(void* h, int i) {
  return static_cast<Runner*>(h)->ins.at(i).nbytes;
}

long long aor_output_bytes(void* h, int i) {
  return static_cast<Runner*>(h)->outs.at(i).nbytes;
}

// Run once: in_bufs hold the inputs' bytes, out_bufs receive the outputs'
// (sizes from aor_input_bytes / aor_output_bytes). micros gets the device
// time (inputs on the device to outputs ready) and the copy-out time.
// Returns 0, or 1 with the error in err.
int aor_run(void* h, const void* const* in_bufs, void* const* out_bufs,
            long long* micros, char* err, int errlen) {
  auto* r = static_cast<Runner*>(h);
  try {
    std::vector<at::Tensor> inputs;
    for (size_t i = 0; i < r->ins.size(); ++i) {
      const auto& s = r->ins[i];
      inputs.push_back(
          at::from_blob(const_cast<void*>(in_bufs[i]), s.shape,
                        at::TensorOptions().dtype(s.dtype))
              .to(r->device, /*non_blocking=*/false, /*copy=*/true));
    }
    synchronize(r->device);
    const auto t0 = std::chrono::steady_clock::now();
    auto outputs = r->loader->run(inputs);
    synchronize(r->device);
    const int64_t run_us = micros_since(t0);
    if (outputs.size() != r->outs.size()) {
      throw std::runtime_error(
          "the package returned " + std::to_string(outputs.size()) +
          " outputs, meta.json lists " + std::to_string(r->outs.size()));
    }
    const auto t1 = std::chrono::steady_clock::now();
    for (size_t i = 0; i < outputs.size(); ++i) {
      const auto& s = r->outs[i];
      const auto& out = outputs[i];
      if (out.scalar_type() != s.dtype || out.sizes() != s.shape) {
        std::ostringstream msg;
        msg << "output " << i << " is " << out.scalar_type() << " "
            << out.sizes() << ", meta.json says " << s.dtype << " "
            << at::IntArrayRef(s.shape);
        throw std::runtime_error(msg.str());
      }
      // device to host straight into the caller's buffer
      at::from_blob(out_bufs[i], s.shape, at::TensorOptions().dtype(s.dtype))
          .copy_(out);
    }
    if (micros != nullptr) {
      micros[0] = run_us;
      micros[1] = micros_since(t1);
    }
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, message_of(e));
    return 1;
  }
}

void aor_destroy(void* h) { delete static_cast<Runner*>(h); }

// dlopen the K5 library for ptt::flash_fwd on CUDA. 0, or 1 and the error.
int aor_load_flash_library(const char* path, char* err, int errlen) {
  try {
    ptt::set_flash_library(path);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, message_of(e));
    return 1;
  }
}

long long aor_flash_fwd_launches() { return ptt::flash_fwd_launches(); }

}  // extern "C"

namespace {

constexpr int kErrLen = 8192;

void read_exact(int fd, void* buf, size_t n) {
  auto* p = static_cast<char*>(buf);
  while (n > 0) {
    const ssize_t got = ::read(fd, p, n);
    if (got <= 0) throw std::runtime_error("request pipe closed");
    p += got;
    n -= static_cast<size_t>(got);
  }
}

void write_exact(int fd, const void* buf, size_t n) {
  const auto* p = static_cast<const char*>(buf);
  while (n > 0) {
    const ssize_t put = ::write(fd, p, n);
    if (put <= 0) throw std::runtime_error("reply pipe closed");
    p += put;
    n -= static_cast<size_t>(put);
  }
}

void reply_header(int fd, int32_t code, int64_t length) {
  write_exact(fd, &code, sizeof code);
  write_exact(fd, &length, sizeof length);
}

void reply_text(int fd, int32_t code, const std::string& text) {
  reply_header(fd, code, static_cast<int64_t>(text.size()));
  write_exact(fd, text.data(), text.size());
}

int serve(const std::string& dir, int in_fd, int out_fd, int shm_fd) {
  std::vector<char> err(kErrLen, 0);
  void* h = aor_create(dir.c_str(), err.data(), kErrLen);
  if (h == nullptr) {
    reply_text(out_fd, 1, err.data());
    return 1;
  }
  const int n_in = aor_num_inputs(h), n_out = aor_num_outputs(h);
  reply_text(out_fd, 0,
             std::to_string(n_in) + " " + std::to_string(n_out) + " " +
                 static_cast<Runner*>(h)->device.str());
  int64_t in_total = 0, out_total = 0;
  for (int i = 0; i < n_in; ++i) in_total += aor_input_bytes(h, i);
  for (int i = 0; i < n_out; ++i) out_total += aor_output_bytes(h, i);
  std::vector<char> in_bytes(static_cast<size_t>(in_total));
  char* shm = nullptr;
  if (out_total > 0) {
    void* mapped = ::mmap(nullptr, static_cast<size_t>(out_total),
                          PROT_READ | PROT_WRITE, MAP_SHARED, shm_fd, 0);
    if (mapped == MAP_FAILED) {
      reply_text(out_fd, 1, "mmap of the output buffer failed: " +
                                std::string(std::strerror(errno)));
      aor_destroy(h);
      return 1;
    }
    shm = static_cast<char*>(mapped);
  }
  std::vector<const void*> in_bufs;
  std::vector<void*> out_bufs;
  int64_t off = 0;
  for (int i = 0; i < n_in; ++i) {
    in_bufs.push_back(in_bytes.data() + off);
    off += aor_input_bytes(h, i);
  }
  off = 0;
  for (int i = 0; i < n_out; ++i) {
    out_bufs.push_back(shm + off);
    off += aor_output_bytes(h, i);
  }
  for (;;) {
    int32_t code = 0;
    int64_t length = 0;
    read_exact(in_fd, &code, sizeof code);
    read_exact(in_fd, &length, sizeof length);
    if (code == 0) break;
    if (code != 1 || length != in_total) {
      std::vector<char> skip(static_cast<size_t>(std::max<int64_t>(length, 0)));
      read_exact(in_fd, skip.data(), skip.size());
      reply_text(out_fd, 1,
                 "bad request: code " + std::to_string(code) + " with " +
                     std::to_string(length) + " bytes (a run takes " +
                     std::to_string(in_total) + ")");
      continue;
    }
    read_exact(in_fd, in_bytes.data(), in_bytes.size());
    long long micros[2] = {0, 0};
    if (aor_run(h, in_bufs.data(), out_bufs.data(), micros, err.data(),
                kErrLen) != 0) {
      reply_text(out_fd, 1, err.data());
      continue;
    }
    const int64_t head[3] = {aor_flash_fwd_launches(), micros[0], micros[1]};
    reply_header(out_fd, 0, static_cast<int64_t>(sizeof head));
    write_exact(out_fd, head, sizeof head);
  }
  if (shm != nullptr) ::munmap(shm, static_cast<size_t>(out_total));
  aor_destroy(h);
  return 0;
}

at::Tensor read_tensor(const std::string& dir, std::istringstream& line,
                       const std::string& name, const c10::Device& device) {
  std::string dtype;
  int rank = 0;
  line >> dtype >> rank;
  std::vector<int64_t> shape(static_cast<size_t>(rank));
  for (auto& d : shape) line >> d;
  auto t = at::empty(shape, at::TensorOptions().dtype(dtype_of(dtype)));
  const std::string bytes = read_file(dir + "/" + name + ".bin");
  if (static_cast<int64_t>(bytes.size()) != static_cast<int64_t>(t.nbytes()))
    throw std::runtime_error(name + ".bin holds " +
                             std::to_string(bytes.size()) + " bytes, " +
                             std::to_string(t.nbytes()) + " expected");
  std::memcpy(t.data_ptr(), bytes.data(), bytes.size());
  return t.to(device);
}

void write_tensor(const std::string& path, const at::Tensor& t) {
  auto host = t.to(at::kCPU).contiguous();
  std::ofstream f(path, std::ios::binary);
  f.write(static_cast<const char*>(host.data_ptr()),
          static_cast<std::streamsize>(host.nbytes()));
  if (!f) throw std::runtime_error("cannot write " + path);
}

int flash_fwd_files(const std::string& dir, const std::string& dev,
                    int reps) {
  const c10::Device device(dev);
  std::istringstream args(read_file(dir + "/args.txt"));
  at::Tensor q, k, v;
  std::optional<at::Tensor> bias;
  bool causal = false;
  std::optional<double> scale;
  for (std::string text; std::getline(args, text);) {
    std::istringstream line(text);
    std::string name;
    if (!(line >> name)) continue;
    if (name == "causal") {
      int c = 0;
      line >> c;
      causal = c != 0;
    } else if (name == "scale") {
      std::string value;
      line >> value;
      if (value != "none") scale = std::stod(value);
    } else {
      auto t = read_tensor(dir, line, name, device);
      if (name == "q") q = t;
      else if (name == "k") k = t;
      else if (name == "v") v = t;
      else if (name == "bias") bias = t;
      else throw std::runtime_error("args.txt: unknown name " + name);
    }
  }
  const auto op = c10::Dispatcher::singleton()
                      .findSchemaOrThrow("ptt::flash_fwd", "")
                      .typed<std::tuple<at::Tensor, at::Tensor>(
                          const at::Tensor&, const at::Tensor&,
                          const at::Tensor&, const std::optional<at::Tensor>&,
                          bool, std::optional<double>)>();
  auto [out, lse] = op.call(q, k, v, bias, causal, scale);
  write_tensor(dir + "/out.bin", out);
  write_tensor(dir + "/lse.bin", lse);
  if (reps > 0) {
    synchronize(device);
    const auto t0 = std::chrono::steady_clock::now();
    for (int i = 0; i < reps; ++i) op.call(q, k, v, bias, causal, scale);
    synchronize(device);
    std::printf("ms %.6f\n", micros_since(t0) / 1e3 / reps);
  }
  std::printf("launches %lld\n", aor_flash_fwd_launches());
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  std::vector<std::string> args(argv + 1, argv + argc);
  std::string flash_lib;
  for (size_t i = 0; i + 1 < args.size(); ++i) {
    if (args[i] == "--flash-lib") {
      flash_lib = args[i + 1];
      args.erase(args.begin() + static_cast<long>(i),
                 args.begin() + static_cast<long>(i) + 2);
      break;
    }
  }
  std::vector<char> err(kErrLen, 0);
  if (!flash_lib.empty() &&
      aor_load_flash_library(flash_lib.c_str(), err.data(), kErrLen) != 0) {
    std::fprintf(stderr, "aoti_runner: %s\n", err.data());
    return 1;
  }
  try {
    if (args.size() == 5 && args[0] == "serve")
      return serve(args[1], std::stoi(args[2]), std::stoi(args[3]),
                   std::stoi(args[4]));
    if ((args.size() == 3 || args.size() == 4) && args[0] == "flash_fwd")
      return flash_fwd_files(args[1], args[2],
                             args.size() == 4 ? std::stoi(args[3]) : 0);
    if (args.size() == 1 && args[0] == "schema") {
      const auto& op = c10::Dispatcher::singleton().findSchemaOrThrow(
          "ptt::flash_fwd", "");
      std::printf("%s\n", c10::toString(op.schema()).c_str());
      return 0;
    }
  } catch (const std::exception& e) {
    std::fprintf(stderr, "aoti_runner: %s\n", message_of(e).c_str());
    return 1;
  }
  std::fprintf(stderr,
               "usage: aoti_runner serve MODEL_DIR IN_FD OUT_FD SHM_FD | "
               "flash_fwd DIR DEVICE [REPS] | schema  [--flash-lib PATH]\n");
  return 2;
}
