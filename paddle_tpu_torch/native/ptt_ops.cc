// K5 (flash attention forward) as the registered op ptt::flash_fwd, for
// processes that run a frozen program with no Python in them: the native
// runner (aoti_runner.cc). An AOTInductor package calls the op through its
// proxy executor, which finds it by name and schema in the dispatcher.
//
// Python registers the same op (torch.library.custom_op in
// paddle_tpu_torch/ops/attention.py), and a process may hold only one
// definition of ptt::flash_fwd: this file is linked into the runner
// executable alone, which never imports that module. The schema below is
// the one custom_op gives; tests compare the two strings.
//
// CUDA: the checks of attention.py's _check and flash_fwd_cuda, then the
// C entry ptt_flash_fwd of csrc/flash_attention.cu on the current stream.
// That entry lives in the library kernels/build.py builds with nvcc; it is
// opened with dlopen (ptt::set_flash_library), so the runner launches the
// very kernel the Python op launches and no second copy is compiled.
// Every launch is counted (ptt::flash_fwd_launches). A missing library or a
// refused launch raises; nothing falls back to the plain version.
//
// CPU: flash_fwd_plain in ATen, op for op: fp32 scores, the additive bias,
// the bottom-right causal mask, softmax, lse; a fully masked row gives 0
// and lse ~ NEG_INF.

#include "ptt_ops.h"

#include <ATen/ATen.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <dlfcn.h>
#include <torch/library.h>

#include <atomic>
#include <cmath>
#include <mutex>
#include <optional>
#include <string>
#include <tuple>

namespace ptt {

const char* const kFlashFwdSchema =
    "flash_fwd(Tensor q, Tensor k, Tensor v, Tensor? bias, bool causal, "
    "float? scale) -> (Tensor, Tensor)";

namespace {

// ptt_flash_fwd in csrc/flash_attention.cu: q, k, v, bias, out, lse |
// B, H, Sq, Sk, D, dtype, scale, causal, bias strides (4), stream
using FlashFwdFn = int (*)(const void*, const void*, const void*,
                           const void*, void*, void*, int, int, int, int,
                           int, int, float, int, long long, long long,
                           long long, long long, void*);

constexpr double kNegInf = -1e30;  // attention.py NEG_INF

std::mutex g_lib_mu;
FlashFwdFn g_fwd = nullptr;
std::atomic<long long> g_launches{0};

double softmax_scale(const at::Tensor& q, std::optional<double> scale) {
  return scale ? *scale : 1.0 / std::sqrt(static_cast<double>(q.size(-1)));
}

// broadcastable ranks, as attention.py _bias4
at::Tensor bias4(const at::Tensor& bias) {
  if (bias.dim() >= 4) return bias;
  std::vector<int64_t> shape(4 - bias.dim(), 1);
  for (auto s : bias.sizes()) shape.push_back(s);
  return bias.reshape(shape);
}

// key col visible from query row: col <= row + (Sk - Sq)
at::Tensor causal_mask(int64_t sq, int64_t sk, const at::Device& dev) {
  auto opts = at::TensorOptions().dtype(at::kLong).device(dev);
  auto row = at::arange(sq, opts).unsqueeze(1);
  auto col = at::arange(sk, opts).unsqueeze(0);
  return col <= row + (sk - sq);
}

std::tuple<at::Tensor, at::Tensor> flash_fwd_cpu(
    const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
    const std::optional<at::Tensor>& bias, bool causal,
    std::optional<double> scale) {
  const double sc = softmax_scale(q, scale);
  auto s = at::einsum("bhqd,bhkd->bhqk", {q.to(at::kFloat), k.to(at::kFloat)})
           * sc;
  if (bias) s = s + bias4(*bias).to(at::kFloat);
  if (causal) {
    s = at::where(causal_mask(s.size(-2), s.size(-1), s.device()), s,
                  at::full_like(s, kNegInf));
  }
  auto m = s.amax({-1});
  auto p = at::exp(s - m.unsqueeze(-1));
  auto l = p.sum({-1});
  auto denom = at::where(l == 0.0, at::ones_like(l), l);
  auto alive = m > kNegInf / 2;
  auto out = at::einsum("bhqk,bhkd->bhqd", {p, v.to(at::kFloat)});
  out = at::where(alive.unsqueeze(-1), out / denom.unsqueeze(-1),
                  at::zeros_like(out))
            .to(q.scalar_type());
  return {out, m + at::log(denom)};
}

FlashFwdFn flash_fn() {
  std::lock_guard<std::mutex> lock(g_lib_mu);
  TORCH_CHECK(g_fwd != nullptr,
              "ptt::flash_fwd on CUDA: no K5 library is loaded (the runner "
              "takes the path of the flash_attention library that "
              "paddle_tpu_torch.kernels.build builds with --flash-lib)");
  return g_fwd;
}

void check_like(const char* name, const at::Tensor& t, const at::Tensor& q,
                at::IntArrayRef shape) {
  TORCH_CHECK(t.device() == q.device() && t.scalar_type() == q.scalar_type(),
              name, " must be ", q.scalar_type(), " on ", q.device(),
              ", got ", t.scalar_type(), " on ", t.device());
  TORCH_CHECK(t.sizes() == shape, name, " must be ", shape, ", got ",
              t.sizes());
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0, name,
              " must be 16-byte aligned");
}

std::tuple<at::Tensor, at::Tensor> flash_fwd_cuda(
    const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
    const std::optional<at::Tensor>& bias, bool causal,
    std::optional<double> scale) {
  // attention.py _check
  TORCH_CHECK(q.is_cuda(), "the CUDA kernel needs CUDA tensors, got q on ",
              q.device());
  int dtype = -1;
  if (q.scalar_type() == at::kFloat) dtype = 0;
  if (q.scalar_type() == at::kBFloat16) dtype = 1;
  TORCH_CHECK(dtype >= 0, "q dtype ", q.scalar_type(),
              " not supported (float32 or bfloat16)");
  TORCH_CHECK(q.dim() == 4, "q must be (B, H, Sq, D), got ", q.sizes());
  const int64_t b = q.size(0), h = q.size(1), sq = q.size(2), d = q.size(3);
  const int64_t sk = k.dim() == 4 ? k.size(2) : 0;
  TORCH_CHECK(d == 32 || d == 64 || d == 128,
              "kernel takes head dim in (32, 64, 128), got ", d);
  TORCH_CHECK(std::min(sq, sk) >= 1, "kernel takes Sq, Sk >= 1, got q ",
              q.sizes(), " and k ", k.sizes());
  check_like("q", q, q, q.sizes());
  check_like("k", k, q, {b, h, sk, d});
  check_like("v", v, q, {b, h, sk, d});
  at::Tensor view;
  int64_t st[4] = {0, 0, 0, 0};
  if (bias) {
    const auto b4 = bias4(*bias);
    TORCH_CHECK(b4.device() == q.device(), "bias must be on ", q.device(),
                ", got ", b4.device());
    const std::vector<int64_t> full = {b, h, sq, sk};
    TORCH_CHECK(at::infer_size(b4.sizes(), full) == full, "bias ",
                b4.sizes(), " does not broadcast to ", at::IntArrayRef(full));
    view = b4.to(at::kFloat).expand(full);
    for (int i = 0; i < 4; ++i) st[i] = view.stride(i);
  }
  const float sc = static_cast<float>(softmax_scale(q, scale));
  const FlashFwdFn fwd = flash_fn();
  c10::DeviceGuard guard(q.device());
  void* stream =
      c10::impl::getDeviceGuardImpl(c10::DeviceType::CUDA)
          ->getStream(q.device())
          .native_handle();
  auto out = at::empty_like(q);
  auto lse = at::empty({b, h, sq}, q.options().dtype(at::kFloat));
  const int rc = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     view.defined() ? view.data_ptr() : nullptr,
                     out.data_ptr(), lse.data_ptr(), static_cast<int>(b),
                     static_cast<int>(h), static_cast<int>(sq),
                     static_cast<int>(sk), static_cast<int>(d), dtype, sc,
                     causal ? 1 : 0, st[0], st[1], st[2], st[3], stream);
  TORCH_CHECK(rc == 0, "ptt_flash_fwd kernel launch failed: cudaError_t ",
              rc);
  g_launches.fetch_add(1);
  return {out, lse};
}

}  // namespace

void set_flash_library(const std::string& path) {
  std::lock_guard<std::mutex> lock(g_lib_mu);
  void* lib = dlopen(path.c_str(), RTLD_NOW | RTLD_LOCAL);
  TORCH_CHECK(lib != nullptr, "dlopen(", path, ") failed: ", dlerror());
  void* sym = dlsym(lib, "ptt_flash_fwd");
  TORCH_CHECK(sym != nullptr, "dlsym(ptt_flash_fwd) in ", path,
              " failed: ", dlerror());
  g_fwd = reinterpret_cast<FlashFwdFn>(sym);
}

long long flash_fwd_launches() { return g_launches.load(); }

}  // namespace ptt

TORCH_LIBRARY(ptt, m) { m.def(ptt::kFlashFwdSchema); }

TORCH_LIBRARY_IMPL(ptt, CPU, m) { m.impl("flash_fwd", ptt::flash_fwd_cpu); }

TORCH_LIBRARY_IMPL(ptt, CUDA, m) { m.impl("flash_fwd", ptt::flash_fwd_cuda); }
