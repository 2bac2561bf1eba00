// Ragged paged attention for Hopper (sm_90a), behind a plain C interface
// (loaded with ctypes; no PyTorch headers, so the build takes seconds).
//
// Replaces the TPU kernels of paddle_tpu/serving/decode_attention.py:
//   ptt_paged_decode        <- _paged_decode_pallas  (body _paged_decode_kernel)
//   ptt_paged_prefill       <- _paged_prefill_pallas (body _paged_prefill_kernel)
//   ptt_paged_decode_int8   <- _paged_decode_int8_pallas  (same body, quantized)
//   ptt_paged_prefill_int8  <- _paged_prefill_int8_pallas (same body, quantized)
// All compute what the TPU kernels compute: every query row attends over
// only its slot's live tokens, read page by page through the block table,
// with an online softmax (the reference's _online_softmax_page_fold), fp32
// accumulation, scores scaled in fp32 after the dot (as the reference's
// lax fallback does), and exact zeros for dead rows.
//
// As in the reference, the int8 variants are not second kernels: the page
// fold and both kernels are templates over the page element type and a
// compile-time kQuant flag, so the grid, the ragged skip and the finish
// cannot drift apart. With kQuant the pages are int8 and each token's fp32
// scales (k_scales, v_scales, (P, ps), read through the same clamped page
// id as the page) are fused into the fold: score = (q.k * scale) * k_scale
// before the softmax, and p * v_scale before PV, after l has taken the
// unscaled p. No dequantized page is ever written.
//
// What bounds them on an H100: bytes. Decode reads each live K/V element
// once and does 4 flops on it (QK and PV): about 2 flops per byte in bf16,
// against the ~295 flops per byte at which the tensor cores, not HBM,
// would be the limit. A prefill chunk reuses each K/V row for up to C query
// rows, which raises its arithmetic intensity, but at the serving shapes
// (C = 64, Dh = 64) it still sits under that line.
//
// Design (simple and correct first). One warp folds one query row over a
// run of pages: each lane keeps ceil(Dh/32) elements of q and of the
// accumulator in registers, each token's score is a warp reduction, and a
// page's scores (in chunks of 32 tokens) update the running (m, l, acc)
// once, as the TPU kernel's page fold does.
//   - decode: one block per (slot, head) with 4 warps; warp w folds the
//     pages w, w+4, ... of the slot and the four partial states merge in
//     shared memory. The page loop stops at ceil(lengths[s] / ps): dead
//     pages are never read (the ragged skip).
//   - prefill: one block per (slot, head, tile of 4 query rows), one warp
//     per row; row r < n_valid[s] is a decode with horizon
//     chunk_starts[s] + r + 1; rows at or past n_valid write zeros.
// What the simple design leaves on the table: each warp of a prefill tile
// re-reads the same K/V rows from L2 (no shared-memory staging, no wgmma);
// loads are 2-4 bytes per lane instead of 16; the next page is not
// prefetched (cp.async/TMA) behind this page's math; a long decode
// sequence is split over 4 warps of one block only (no split-KV across
// blocks); and a score costs a 5-step shuffle reduction per token. The
// int8 variants add 1-byte loads per lane (no char4 or 16-byte vectors),
// no dp4a for the int8 dot, and no staging of pages or scale rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadDim = 256;
constexpr int kMaxPageSize = 256;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_f(const int8_t* p) {
  return static_cast<float>(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Running online-softmax state of one query row, held by one warp:
// lane l owns head-dim elements l, l + 32, ... of the accumulator.
template <int DPL>
struct RowState {
  float m;
  float l;
  float acc[DPL];
};

template <int DPL>
__device__ __forceinline__ void init_state(RowState<DPL>& st) {
  st.m = kNegInf;
  st.l = 0.f;
#pragma unroll
  for (int i = 0; i < DPL; ++i) st.acc[i] = 0.f;
}

template <typename T, int DPL>
__device__ __forceinline__ void load_row(const T* src, int Dh, float (&dst)[DPL]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    dst[i] = d < Dh ? load_f(src + d) : 0.f;
  }
}

// The page fold shared by both kernels: fold tokens [0, n_tok) of the
// pages at block-table columns col0, col0 + col_step, ... into `st`.
// Column indices stay below ceil(n_tok / ps), which the callers clamp to
// the block table's width w, so no column past w - 1 is ever read. Page
// ids are clamped into [0, P) as the reference's XLA gather clamps them,
// so a bad id cannot read outside the pool; with kQuant the scale rows are
// read through the same clamped id. KV is the page element type (T for the
// fp kernels, int8_t with kQuant).
template <typename KV, bool kQuant, int DPL>
__device__ void fold_pages(const float (&q)[DPL], const KV* __restrict__ k_pages,
                           const KV* __restrict__ v_pages,
                           const float* __restrict__ k_scales,
                           const float* __restrict__ v_scales,
                           const int32_t* __restrict__ bt_row, int n_tok,
                           int col0, int col_step, int ps, int H, int Dh,
                           int P, int head, float scale, RowState<DPL>& st) {
  const int lane = threadIdx.x & 31;
  const int64_t tok_stride = (int64_t)H * Dh;
  const int n_cols = (n_tok + ps - 1) / ps;
  for (int col = col0; col < n_cols; col += col_step) {
    const int64_t page = min(max(bt_row[col], 0), P - 1);
    const int64_t base = (page * ps * H + head) * (int64_t)Dh;
    const KV* kp = k_pages + base;
    const KV* vp = v_pages + base;
    const float* ks = kQuant ? k_scales + page * ps : nullptr;
    const float* vs = kQuant ? v_scales + page * ps : nullptr;
    const int live = min(ps, n_tok - col * ps);
    for (int t0 = 0; t0 < live; t0 += 32) {
      const int nt = min(32, live - t0);
      // scores of this chunk: lane j ends up holding token t0 + j's score
      float s_mine = kNegInf;
#pragma unroll 4
      for (int j = 0; j < nt; ++j) {
        const KV* kr = kp + (t0 + j) * tok_stride;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < Dh) part += q[i] * load_f(kr + d);
        }
        const float s = warp_sum(part) * scale;
        if (lane == j) s_mine = s;
      }
      if constexpr (kQuant) {
        if (lane < nt) s_mine *= ks[t0 + lane];  // (q.k * scale) * k_scale
      }
      const float m_next = fmaxf(st.m, warp_max(s_mine));
      const float alpha = expf(st.m - m_next);
      float p_mine = lane < nt ? expf(s_mine - m_next) : 0.f;
      st.l = st.l * alpha + warp_sum(p_mine);
      st.m = m_next;
      if constexpr (kQuant) {
        if (lane < nt) p_mine *= vs[t0 + lane];  // after l: l never sees it
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) st.acc[i] *= alpha;
#pragma unroll 4
      for (int j = 0; j < nt; ++j) {
        const float p = __shfl_sync(kFull, p_mine, j);
        const KV* vr = vp + (t0 + j) * tok_stride;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < Dh) st.acc[i] += p * load_f(vr + d);
        }
      }
    }
  }
}

// q (S, H, Dh); pages (P, ps, H, Dh); scales (P, ps) with kQuant, else
// null; block_tables (S, w); lengths (S,); out (S, H, Dh).
// Grid (S, H), kThreads threads.
template <typename T, typename KV, bool kQuant, int DPL>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k_pages,
                        const KV* __restrict__ v_pages,
                        const float* __restrict__ k_scales,
                        const float* __restrict__ v_scales,
                        const int32_t* __restrict__ block_tables,
                        const int32_t* __restrict__ lengths, T* __restrict__ out,
                        int H, int Dh, int ps, int w, int P, float scale) {
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][kMaxHeadDim];
  const int slot = blockIdx.x;
  const int head = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = ((int64_t)slot * H + head) * Dh;
  const int n_tok = min(max(lengths[slot], 0), w * ps);
  if (n_tok == 0) {  // inactive slot: exact zeros (block-uniform branch)
    for (int d = threadIdx.x; d < Dh; d += kThreads) store_f(out + row + d, 0.f);
    return;
  }
  float qr[DPL];
  load_row<T, DPL>(q + row, Dh, qr);
  RowState<DPL> st;
  init_state(st);
  fold_pages<KV, kQuant, DPL>(qr, k_pages, v_pages, k_scales, v_scales,
                              block_tables + (int64_t)slot * w, n_tok, warp,
                              kWarps, ps, H, Dh, P, head, scale, st);
  if (lane == 0) {
    sm_m[warp] = st.m;
    sm_l[warp] = st.l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < Dh) sm_acc[warp][d] = st.acc[i];
  }
  __syncthreads();
  // merge the warps' partial states; a warp that folded no page holds
  // m = NEG_INF, l = 0 and weighs exactly 0
  float m = kNegInf;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) m = fmaxf(m, sm_m[k]);
  float wt[kWarps];
  float l = 0.f;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    wt[k] = expf(sm_m[k] - m);
    l += sm_l[k] * wt[k];
  }
  for (int d = threadIdx.x; d < Dh; d += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) a += sm_acc[k][d] * wt[k];
    store_f(out + row + d, a / l);
  }
}

// q (S, C, H, Dh); pages (P, ps, H, Dh); scales (P, ps) with kQuant, else
// null; block_tables (S, w); chunk_starts, n_valid (S,); out (S, C, H, Dh).
// Grid (S, H, ceil(C / kWarps)), kThreads threads, one warp per row.
template <typename T, typename KV, bool kQuant, int DPL>
__global__ void __launch_bounds__(kThreads)
    paged_prefill_kernel(const T* __restrict__ q, const KV* __restrict__ k_pages,
                         const KV* __restrict__ v_pages,
                         const float* __restrict__ k_scales,
                         const float* __restrict__ v_scales,
                         const int32_t* __restrict__ block_tables,
                         const int32_t* __restrict__ chunk_starts,
                         const int32_t* __restrict__ n_valid,
                         T* __restrict__ out, int C, int H, int Dh, int ps,
                         int w, int P, float scale) {
  const int slot = blockIdx.x;
  const int head = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.z * kWarps + warp;
  if (r >= C) return;  // warp-uniform: no block barrier below
  const int64_t row = (((int64_t)slot * C + r) * H + head) * Dh;
  const int n_tok = min(chunk_starts[slot] + r + 1, w * ps);  // causal horizon
  if (r >= n_valid[slot] || n_tok <= 0) {  // padding lane / inactive slot
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < Dh) store_f(out + row + d, 0.f);
    }
    return;
  }
  float qr[DPL];
  load_row<T, DPL>(q + row, Dh, qr);
  RowState<DPL> st;
  init_state(st);
  fold_pages<KV, kQuant, DPL>(qr, k_pages, v_pages, k_scales, v_scales,
                              block_tables + (int64_t)slot * w, n_tok, 0, 1,
                              ps, H, Dh, P, head, scale, st);
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < Dh) store_f(out + row + d, st.acc[i] / st.l);
  }
}

template <typename T, typename KV, bool kQuant, int DPL>
cudaError_t run_decode(const void* q, const void* kp, const void* vp,
                       const float* ks, const float* vs, const void* bt,
                       const void* len, void* out, int S, int H, int Dh, int ps,
                       int w, int P, float scale, cudaStream_t stream) {
  paged_decode_kernel<T, KV, kQuant, DPL><<<dim3(S, H), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), ks, vs, static_cast<const int32_t*>(bt),
      static_cast<const int32_t*>(len), static_cast<T*>(out), H, Dh, ps, w, P,
      scale);
  return cudaGetLastError();
}

template <typename T, typename KV, bool kQuant, int DPL>
cudaError_t run_prefill(const void* q, const void* kp, const void* vp,
                        const float* ks, const float* vs, const void* bt,
                        const void* st, const void* nv, void* out, int S, int C,
                        int H, int Dh, int ps, int w, int P, float scale,
                        cudaStream_t stream) {
  const dim3 grid(S, H, (C + kWarps - 1) / kWarps);
  paged_prefill_kernel<T, KV, kQuant, DPL><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), ks, vs, static_cast<const int32_t*>(bt),
      static_cast<const int32_t*>(st), static_cast<const int32_t*>(nv),
      static_cast<T*>(out), C, H, Dh, ps, w, P, scale);
  return cudaGetLastError();
}

// DPL (head-dim elements per lane) is a template parameter so that q and
// the accumulator stay in registers; Dh <= 256 gives DPL <= 8. Expanded
// inside decode_t / prefill_t, whose template parameters T, KV and kQuant
// it forwards.
#define PTT_DPL_CASES(FN, ...)                              \
  switch ((Dh + 31) / 32) {                                 \
    case 1: return FN<T, KV, kQuant, 1>(__VA_ARGS__);       \
    case 2: return FN<T, KV, kQuant, 2>(__VA_ARGS__);       \
    case 3: return FN<T, KV, kQuant, 3>(__VA_ARGS__);       \
    case 4: return FN<T, KV, kQuant, 4>(__VA_ARGS__);       \
    case 5: return FN<T, KV, kQuant, 5>(__VA_ARGS__);       \
    case 6: return FN<T, KV, kQuant, 6>(__VA_ARGS__);       \
    case 7: return FN<T, KV, kQuant, 7>(__VA_ARGS__);       \
    case 8: return FN<T, KV, kQuant, 8>(__VA_ARGS__);       \
    default: return cudaErrorInvalidValue;                  \
  }

template <typename T, typename KV, bool kQuant>
cudaError_t decode_t(const void* q, const void* kp, const void* vp,
                     const void* ks, const void* vs, const void* bt,
                     const void* len, void* out, int S, int H, int Dh, int ps,
                     int w, int P, float scale, cudaStream_t stream) {
  PTT_DPL_CASES(run_decode, q, kp, vp, static_cast<const float*>(ks),
                static_cast<const float*>(vs), bt, len, out, S, H, Dh, ps, w,
                P, scale, stream)
}

template <typename T, typename KV, bool kQuant>
cudaError_t prefill_t(const void* q, const void* kp, const void* vp,
                      const void* ks, const void* vs, const void* bt,
                      const void* st, const void* nv, void* out, int S, int C,
                      int H, int Dh, int ps, int w, int P, float scale,
                      cudaStream_t stream) {
  PTT_DPL_CASES(run_prefill, q, kp, vp, static_cast<const float*>(ks),
                static_cast<const float*>(vs), bt, st, nv, out, S, C, H, Dh,
                ps, w, P, scale, stream)
}

bool bad_geometry(int H, int Dh, int ps, int w, int P) {
  return H < 1 || H > 65535 || Dh < 1 || Dh > kMaxHeadDim || ps < 1 ||
         ps > kMaxPageSize || w < 1 || P < 1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of q and out; the fp kernels' pages
// share it, the int8 kernels' pages are int8 with float32 scales (P, ps)).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int ptt_paged_decode(const void* q, const void* k_pages,
                                const void* v_pages, const void* block_tables,
                                const void* lengths, void* out, int S, int H,
                                int Dh, int ps, int w, int P, int dtype,
                                float scale, void* stream) {
  if (S == 0) return cudaSuccess;
  if (S < 0 || bad_geometry(H, Dh, ps, w, P)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return decode_t<float, float, false>(q, k_pages, v_pages, nullptr,
                                         nullptr, block_tables, lengths, out,
                                         S, H, Dh, ps, w, P, scale, s);
  if (dtype == 1)
    return decode_t<__nv_bfloat16, __nv_bfloat16, false>(
        q, k_pages, v_pages, nullptr, nullptr, block_tables, lengths, out, S,
        H, Dh, ps, w, P, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" int ptt_paged_prefill(const void* q, const void* k_pages,
                                 const void* v_pages, const void* block_tables,
                                 const void* chunk_starts, const void* n_valid,
                                 void* out, int S, int C, int H, int Dh, int ps,
                                 int w, int P, int dtype, float scale,
                                 void* stream) {
  if (S == 0 || C == 0) return cudaSuccess;
  if (S < 0 || C < 0 || (C + kWarps - 1) / kWarps > 65535 ||
      bad_geometry(H, Dh, ps, w, P))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return prefill_t<float, float, false>(q, k_pages, v_pages, nullptr,
                                          nullptr, block_tables, chunk_starts,
                                          n_valid, out, S, C, H, Dh, ps, w, P,
                                          scale, s);
  if (dtype == 1)
    return prefill_t<__nv_bfloat16, __nv_bfloat16, false>(
        q, k_pages, v_pages, nullptr, nullptr, block_tables, chunk_starts,
        n_valid, out, S, C, H, Dh, ps, w, P, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" int ptt_paged_decode_int8(const void* q, const void* k_pages,
                                     const void* v_pages, const void* k_scales,
                                     const void* v_scales,
                                     const void* block_tables,
                                     const void* lengths, void* out, int S,
                                     int H, int Dh, int ps, int w, int P,
                                     int dtype, float scale, void* stream) {
  if (S == 0) return cudaSuccess;
  if (S < 0 || bad_geometry(H, Dh, ps, w, P)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return decode_t<float, int8_t, true>(q, k_pages, v_pages, k_scales,
                                         v_scales, block_tables, lengths, out,
                                         S, H, Dh, ps, w, P, scale, s);
  if (dtype == 1)
    return decode_t<__nv_bfloat16, int8_t, true>(
        q, k_pages, v_pages, k_scales, v_scales, block_tables, lengths, out, S,
        H, Dh, ps, w, P, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" int ptt_paged_prefill_int8(const void* q, const void* k_pages,
                                      const void* v_pages, const void* k_scales,
                                      const void* v_scales,
                                      const void* block_tables,
                                      const void* chunk_starts,
                                      const void* n_valid, void* out, int S,
                                      int C, int H, int Dh, int ps, int w,
                                      int P, int dtype, float scale,
                                      void* stream) {
  if (S == 0 || C == 0) return cudaSuccess;
  if (S < 0 || C < 0 || (C + kWarps - 1) / kWarps > 65535 ||
      bad_geometry(H, Dh, ps, w, P))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return prefill_t<float, int8_t, true>(q, k_pages, v_pages, k_scales,
                                          v_scales, block_tables, chunk_starts,
                                          n_valid, out, S, C, H, Dh, ps, w, P,
                                          scale, s);
  if (dtype == 1)
    return prefill_t<__nv_bfloat16, int8_t, true>(
        q, k_pages, v_pages, k_scales, v_scales, block_tables, chunk_starts,
        n_valid, out, S, C, H, Dh, ps, w, P, scale, s);
  return cudaErrorInvalidValue;
}
