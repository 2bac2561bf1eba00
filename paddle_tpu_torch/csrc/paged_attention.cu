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
// Designs.
//   - decode over fp pages (K1): paged_decode_fp_kernel, built for HBM
//     bandwidth (16-byte loads, a unit of page rows requested before any
//     is used and the next unit's behind this one's math, eight warps
//     per (slot, head)); see its section.
//   - decode over int8 pages (K2, the next to move to that design) and
//     prefill (K3, K4), simple and correct first: one warp folds one query
//     row over a run of pages (fold_pages): each lane keeps ceil(Dh/32)
//     elements of q and of the accumulator in registers, each token's
//     score is a warp reduction, and a page's scores (in chunks of 32
//     tokens) update the running (m, l, acc) once, as the TPU kernel's
//     page fold does. int8 decode: one block per (slot, head) with 4 warps;
//     warp w folds the pages w, w+4, ... of the slot and the four partial
//     states merge in shared memory. Prefill: one block per (slot, head,
//     tile of 4 query rows), one warp per row; row r < n_valid[s] is a
//     decode with horizon chunk_starts[s] + r + 1; rows at or past n_valid
//     write zeros. The page loop stops at ceil(lengths[s] / ps): dead pages
//     are never read (the ragged skip).
// What the simple design leaves on the table: each warp of a prefill tile
// re-reads the same K/V rows from L2 (no shared-memory staging, no wgmma);
// loads are 1-4 bytes per lane instead of 16; the next page is not
// requested behind this page's math; and a score costs a 5-step shuffle
// reduction per token. The int8 variants also lack dp4a for the int8 dot
// and staging of pages or scale rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ---------------------------------------------------------------------------
// K1, fp pages: ragged paged decode for HBM bandwidth. Replaces
// _paged_decode_pallas (paddle_tpu/serving/decode_attention.py:265, body
// _paged_decode_kernel, fold _online_softmax_page_fold :125). Decode does
// ~2 flops per byte, so the only lever is bytes in flight: every lane
// loads 16 bytes at a time, a warp holds several tokens' rows at once, a
// unit's K rows and V rows are all requested before any is used, and the
// next unit's rows are requested before this unit's math (two register
// buffers).
//
// Warp layout: lane = grp * G + gl. The G lanes of a group hold one
// token's row of Dh elements as vectors of V elements (16 bytes, or one
// element where Dh * sizeof(KV) is not a multiple of 16 or a pool is not
// 16-byte aligned); lane gl holds vectors gl, gl + G, ... (NV of them).
// The 32 / G groups of a warp hold 32 / G consecutive tokens, so a
// token's score is a log2(G)-step shuffle within its group (3 steps for
// bf16 at Dh = 64). A unit is STEPS such rows of one page (a whole page
// of 16 tokens at the serving shape); the online softmax (m, l, acc)
// updates once per unit, as the reference's fold does once per page.
//
// Parallelism: one block of kDecWarps warps per (slot, head), one launch
// per call. Warp w folds the units w, w + kDecWarps, ... of the slot's
// live pages, and the warps' states merge in shared memory in warp
// order: a partition and merge order that depend only on the shapes and
// lengths, so repeat launches are bitwise identical. At the serving
// shape (16 slots x 16 heads) the grid fills the card. A few long slots
// would leave most SMs idle, but no configuration the port serves has
// them: its GPT holds 512 positions and the engine decodes every slot.
//
// Kept from the reference: pages at or past ceil(lengths[s] / ps) are
// never read, tokens past the length are never loaded, page ids clamp
// into [0, P), lengths == 0 gives exact zeros, and a state that folded
// nothing (m = NEG_INF, l = 0) weighs exactly 0. The int8 pool (K2) keeps
// paged_decode_kernel above; its kQuant instance of this design would
// multiply a score by the token's k_scale and p by its v_scale after l,
// as fold_pages does, with 16-element int8 vectors.
// ---------------------------------------------------------------------------
constexpr int kDecWarps = 8;
constexpr int kDecThreads = kDecWarps * 32;

// V consecutive page elements as loaded: one 16-byte vector, or one
// element.
template <typename KV, int V>
using Raw = typename std::conditional<V == 1, KV, uint4>::type;

template <typename KV, int V>
__device__ __forceinline__ Raw<KV, V> load_raw(const KV* p) {
  if constexpr (V == 1) {
    return *p;
  } else {
    return *reinterpret_cast<const uint4*>(p);
  }
}

// element e (a constant after unrolling) of a loaded vector as fp32, read
// from its 32-bit words (a bf16 is the top half of an fp32)
template <typename KV, int V>
__device__ __forceinline__ float raw_at(const Raw<KV, V>& r, int e) {
  if constexpr (V == 1) {
    return load_f(&r);
  } else {
    static_assert(sizeof(KV) == 4 || sizeof(KV) == 2, "fp pages only");
    const int word = e * (int)sizeof(KV) / 4;
    const uint32_t x = word == 0 ? r.x : word == 1 ? r.y : word == 2 ? r.z : r.w;
    if constexpr (sizeof(KV) == 4) {
      return __uint_as_float(x);
    } else {
      return __uint_as_float(e % 2 ? x & 0xffff0000u : x << 16);
    }
  }
}

template <typename KV, int V, int NV, int STEPS>
struct UnitRows {
  Raw<KV, V> k[STEPS][NV];
  Raw<KV, V> v[STEPS][NV];
  int live;  // tokens of the unit below the slot's length (may be <= 0)
};

template <typename T, typename KV, int V, int G, int NV>
__global__ void __launch_bounds__(kDecThreads)
    paged_decode_fp_kernel(const T* __restrict__ q,
                           const KV* __restrict__ k_pages,
                           const KV* __restrict__ v_pages,
                           const int32_t* __restrict__ block_tables,
                           const int32_t* __restrict__ lengths,
                           T* __restrict__ out, int H, int Dh, int ps,
                           int w, int P, float scale) {
  constexpr int TPW = 32 / G;                   // tokens a warp holds at once
  constexpr int REGS = NV * (V == 1 ? 1 : 4);   // registers per row per lane
  constexpr int STEPS = REGS >= 16 ? 1 : 16 / REGS;
  constexpr int CH = STEPS * TPW;               // tokens per unit
  __shared__ float sm_m[kDecWarps];
  __shared__ float sm_l[kDecWarps];
  __shared__ float sm_acc[kDecWarps][kMaxHeadDim];
  const int slot = blockIdx.x, head = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / G, gl = lane % G;
  const int64_t row = ((int64_t)slot * H + head) * Dh;
  const int n_tok = min(max(lengths[slot], 0), w * ps);
  if (n_tok == 0) {               // inactive slot: exact zeros
    for (int d = threadIdx.x; d < Dh; d += kDecThreads)
      store_f(out + row + d, 0.f);
    return;
  }
  const int n_cols = (n_tok + ps - 1) / ps;     // live pages
  const int cpp = (ps + CH - 1) / CH;           // units per page
  const int32_t* bt_row = block_tables + (int64_t)slot * w;
  const int64_t tok_stride = (int64_t)H * Dh;

  float qf[NV][V], acc[NV][V];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int d = (gl + G * v) * V + e;
      qf[v][e] = d < Dh ? load_f(q + row + d) : 0.f;
      acc[v][e] = 0.f;
    }
  float st_m = kNegInf, st_l = 0.f;

  auto page_of = [&](int u) { return min(max(bt_row[u / cpp], 0), P - 1); };
  // request unit u's K and V rows (page id `page`) into `b`
  auto request = [&](UnitRows<KV, V, NV, STEPS>& b, int u, int page) {
    const int col = u / cpp, t0 = (u % cpp) * CH;
    b.live = min(CH, min(ps, n_tok - col * ps) - t0);
    const int64_t base = ((int64_t)page * ps + t0) * tok_stride + head * Dh;
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const int t = j * TPW + grp;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int d = (gl + G * v) * V;
        const bool ok = t < b.live && d < Dh;
        const int64_t off = base + t * tok_stride + d;
        b.k[j][v] = ok ? load_raw<KV, V>(k_pages + off) : Raw<KV, V>{};
      }
    }
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const int t = j * TPW + grp;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int d = (gl + G * v) * V;
        const bool ok = t < b.live && d < Dh;
        const int64_t off = base + t * tok_stride + d;
        b.v[j][v] = ok ? load_raw<KV, V>(v_pages + off) : Raw<KV, V>{};
      }
    }
  };
  // one online-softmax update over the unit in `b`
  auto fold = [&](const UnitRows<KV, V, NV, STEPS>& b) {
    float s[STEPS];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < V; ++e)
          dot = fmaf(qf[v][e], raw_at<KV, V>(b.k[j][v], e), dot);
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(kFull, dot, o);
      s[j] = j * TPW + grp < b.live ? dot * scale : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
#pragma unroll
    for (int o = G; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    const float m_next = fmaxf(st_m, mx);
    const float alpha = expf(st_m - m_next);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      // masked tokens weigh exactly 0 (even while m is still NEG_INF)
      s[j] = j * TPW + grp < b.live ? expf(s[j] - m_next) : 0.f;
      psum += s[j];
    }
#pragma unroll
    for (int o = G; o < 32; o <<= 1) psum += __shfl_xor_sync(kFull, psum, o);
    st_l = st_l * alpha + psum;
    st_m = m_next;
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float a = acc[v][e] * alpha;
#pragma unroll
        for (int j = 0; j < STEPS; ++j)
          a = fmaf(s[j], raw_at<KV, V>(b.v[j][v], e), a);
        acc[v][e] = a;
      }
  };

  // this warp's units: u0, u0 + kDecWarps, ... below n_cols * cpp, folded
  // in that order through two buffers
  const int u0 = warp, u_end = n_cols * cpp;
  const int n_units = u0 < u_end ? (u_end - u0 + kDecWarps - 1) / kDecWarps : 0;
  UnitRows<KV, V, NV, STEPS> a, b;
  int id_b = 0;
  if (n_units > 0) request(a, u0, page_of(u0));
  if (n_units > 1) id_b = page_of(u0 + kDecWarps);
  for (int k = 0; k < n_units; k += 2) {
    int id_a = 0;
    if (k + 1 < n_units) request(b, u0 + (k + 1) * kDecWarps, id_b);
    if (k + 2 < n_units) id_a = page_of(u0 + (k + 2) * kDecWarps);
    fold(a);
    if (k + 2 < n_units) request(a, u0 + (k + 2) * kDecWarps, id_a);
    if (k + 3 < n_units) id_b = page_of(u0 + (k + 3) * kDecWarps);
    if (k + 1 < n_units) fold(b);
  }

  // the groups hold disjoint tokens: sum their accumulators
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int e = 0; e < V; ++e)
#pragma unroll
      for (int o = G; o < 32; o <<= 1)
        acc[v][e] += __shfl_xor_sync(kFull, acc[v][e], o);
  if (lane == 0) {
    sm_m[warp] = st_m;
    sm_l[warp] = st_l;
  }
  if (grp == 0) {
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int d = (gl + G * v) * V + e;
        if (d < Dh) sm_acc[warp][d] = acc[v][e];
      }
  }
  __syncthreads();
  // merge the warps' states in warp order; a warp that folded no token
  // holds m = NEG_INF, l = 0 and weighs exactly 0
  float m = kNegInf;
#pragma unroll
  for (int k = 0; k < kDecWarps; ++k) m = fmaxf(m, sm_m[k]);
  float wt[kDecWarps];
  float l = 0.f;
#pragma unroll
  for (int k = 0; k < kDecWarps; ++k) {
    wt[k] = expf(sm_m[k] - m);
    l += sm_l[k] * wt[k];
  }
  for (int d = threadIdx.x; d < Dh; d += kDecThreads) {
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < kDecWarps; ++k) a += sm_acc[k][d] * wt[k];
    store_f(out + row + d, a / l);
  }
}

template <typename T, int V, int G, int NV>
cudaError_t run_decode_fp(const void* q, const void* kp, const void* vp,
                          const void* bt, const void* len, void* out, int S,
                          int H, int Dh, int ps, int w, int P, float scale,
                          cudaStream_t stream) {
  paged_decode_fp_kernel<T, T, V, G, NV><<<dim3(S, H), kDecThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int32_t*>(bt),
      static_cast<const int32_t*>(len), static_cast<T*>(out), H, Dh, ps, w, P,
      scale);
  return cudaGetLastError();
}

// 16-byte vectors where every row of both pools is 16-byte aligned, G the
// smallest power of two lanes that covers a row (two vectors per lane for
// fp32 rows past 128 elements); otherwise one element per lane and vector.
template <typename T>
cudaError_t decode_fp(const void* q, const void* kp, const void* vp,
                      const void* bt, const void* len, void* out, int S,
                      int H, int Dh, int ps, int w, int P, float scale,
                      cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = Dh % V == 0 && reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vp) % 16 == 0;
#define PTT_DECODE_FP(V_, G_, NV_)                                          \
  return run_decode_fp<T, V_, G_, NV_>(q, kp, vp, bt, len, out, S, H, Dh, \
                                       ps, w, P, scale, stream)
  if (vec) {
    const int nvec = Dh / V;
    if (nvec <= 1) PTT_DECODE_FP(V, 1, 1);
    if (nvec <= 2) PTT_DECODE_FP(V, 2, 1);
    if (nvec <= 4) PTT_DECODE_FP(V, 4, 1);
    if (nvec <= 8) PTT_DECODE_FP(V, 8, 1);
    if (nvec <= 16) PTT_DECODE_FP(V, 16, 1);
    if (nvec <= 32) PTT_DECODE_FP(V, 32, 1);
    PTT_DECODE_FP(V, 32, 2);
  }
  switch ((Dh + 31) / 32) {
    case 1: PTT_DECODE_FP(1, 32, 1);
    case 2: PTT_DECODE_FP(1, 32, 2);
    case 3: PTT_DECODE_FP(1, 32, 3);
    case 4: PTT_DECODE_FP(1, 32, 4);
    case 5: PTT_DECODE_FP(1, 32, 5);
    case 6: PTT_DECODE_FP(1, 32, 6);
    case 7: PTT_DECODE_FP(1, 32, 7);
    case 8: PTT_DECODE_FP(1, 32, 8);
  }
#undef PTT_DECODE_FP
  return cudaErrorInvalidValue;
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
    return decode_fp<float>(q, k_pages, v_pages, block_tables, lengths, out,
                            S, H, Dh, ps, w, P, scale, s);
  if (dtype == 1)
    return decode_fp<__nv_bfloat16>(q, k_pages, v_pages, block_tables,
                                    lengths, out, S, H, Dh, ps, w, P, scale,
                                    s);
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
