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
// As in the reference, the int8 variants are not second kernels: each
// design is a template over the page element type and a compile-time
// kQuant flag, so the grid, the ragged skip and the finish cannot drift
// apart. With kQuant the pages are int8 and each token's fp32 scales
// (k_scales, v_scales, (P, ps), read through the same clamped page id as
// the page) are fused into the fold: score = (q.k * scale) * k_scale
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
//   - decode (K1 over fp pages, K2 over int8 pages): paged_decode_vec_kernel,
//     built for HBM bandwidth (16-byte loads, a unit of page rows
//     requested before any is used and the next unit's behind this one's
//     math, eight warps per (slot, head)); see its section.
//   - prefill with bf16 q and Dh <= 128, over bf16 pages (K3) or int8
//     pages (K4, also the speculative verify step): paged_prefill_tc_kernel,
//     which stages each live key tile once for a tile of up to 64 query
//     rows and runs QK^T and PV on the tensor cores; its bf16-page
//     instance feeds the mma straight from the staged tile, its int8
//     instance converts the tile to bf16 first; see its section.
//   - prefill with fp32 q (K3 and K4; their fp32 contracts of 2e-5 and
//     5e-5 do not survive bf16 operands), with Dh > 128, or with a block
//     table wider than kMaxIdCols: the simple scalar template, one warp per
//     query row (fold_pages): each lane keeps ceil(Dh/32) elements of q and
//     of the accumulator in registers, each token's score is a warp
//     reduction, and a page's scores (in chunks of 32 tokens) update the
//     running (m, l, acc) once, as the TPU kernel's page fold does. One
//     block per (slot, head, tile of 4 query rows); row r < n_valid[s] is a
//     decode with horizon chunk_starts[s] + r + 1; rows at or past n_valid
//     write zeros. The page loop stops at ceil(lengths[s] / ps): dead pages
//     are never read (the ragged skip). Each warp re-reads the same K/V
//     rows from L2 with 1-4 byte loads and pays a 5-step shuffle per
//     token's score: it is the contract-exact path, not a fast one.

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
// K1 (fp pages) and K2 (int8 pages): ragged paged decode for HBM
// bandwidth. Replaces _paged_decode_pallas (K1) and
// _paged_decode_int8_pallas (K2) (paddle_tpu/serving/decode_attention.py
// :265 and :356, body _paged_decode_kernel :185, fold
// _online_softmax_page_fold :125). Decode does ~2 flops per byte, so the
// only lever is bytes in flight: every lane loads 16 bytes at a time (8
// bf16, 4 fp32 or 16 int8 elements), a warp holds several tokens' rows at
// once, a unit's K rows and V rows (and, for int8, their scales) are all
// requested before any is used, and the next unit's rows are requested
// before this unit's math (two register buffers). The int8 pool moves half
// the bf16 pool's bytes per token plus 8 bytes of scales.
//
// Warp layout: lane = grp * G + gl. The G lanes of a group hold one
// token's row of Dh elements as vectors of V elements (16 bytes, or one
// element where Dh * sizeof(KV) is not a multiple of 16 or a pool is not
// 16-byte aligned); lane gl holds vectors gl, gl + G, ... (NV of them).
// The 32 / G groups of a warp hold 32 / G consecutive tokens, so a
// token's score is a log2(G)-step shuffle within its group (3 steps for
// bf16 at Dh = 64, 2 for int8). A unit is STEPS such rows of one page (a
// whole page of 16 tokens at the serving shape, for both pools); the
// online softmax (m, l, acc) updates once per unit, as the reference's
// fold does once per page.
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
// never read, tokens past the length are never loaded (nor their scales),
// page ids clamp into [0, P), lengths == 0 gives exact zeros, and a state
// that folded nothing (m = NEG_INF, l = 0) weighs exactly 0. Masked tokens
// weigh an explicit 0, selected rather than multiplied, so a NaN scale row
// of an unreferenced page can never reach the output.
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

// byte b (0..3) of x as a signed int8 value
__device__ __forceinline__ float i8_at(uint32_t x, int b) {
  return static_cast<float>(static_cast<int>(x << (24 - 8 * b)) >> 24);
}

// element e (a constant after unrolling) of a loaded vector as fp32, read
// from its 32-bit words (a bf16 is the top half of an fp32)
template <typename KV, int V>
__device__ __forceinline__ float raw_at(const Raw<KV, V>& r, int e) {
  if constexpr (V == 1) {
    return load_f(&r);
  } else {
    const int word = e * (int)sizeof(KV) / 4;
    const uint32_t x = word == 0 ? r.x : word == 1 ? r.y : word == 2 ? r.z : r.w;
    if constexpr (sizeof(KV) == 4) {
      return __uint_as_float(x);
    } else if constexpr (sizeof(KV) == 2) {
      return __uint_as_float(e % 2 ? x & 0xffff0000u : x << 16);
    } else {
      static_assert(std::is_same<KV, int8_t>::value, "fp32, bf16 or int8 pages");
      return i8_at(x, e % 4);
    }
  }
}

template <typename KV, bool kQuant, int V, int NV, int STEPS>
struct UnitRows {
  Raw<KV, V> k[STEPS][NV];
  Raw<KV, V> v[STEPS][NV];
  float ks[kQuant ? STEPS : 1];  // the tokens' k_scale / v_scale (kQuant)
  float vs[kQuant ? STEPS : 1];
  int live;  // tokens of the unit below the slot's length (may be <= 0)
};

template <typename T, typename KV, bool kQuant, int V, int G, int NV>
__global__ void __launch_bounds__(kDecThreads)
    paged_decode_vec_kernel(const T* __restrict__ q,
                            const KV* __restrict__ k_pages,
                            const KV* __restrict__ v_pages,
                            const float* __restrict__ k_scales,
                            const float* __restrict__ v_scales,
                            const int32_t* __restrict__ block_tables,
                            const int32_t* __restrict__ lengths,
                            T* __restrict__ out, int H, int Dh, int ps,
                            int w, int P, float scale) {
  constexpr int TPW = 32 / G;                   // tokens a warp holds at once
  constexpr int REGS = NV * (V == 1 ? 1 : 4);   // registers per row per lane
  constexpr int STEPS_REGS = REGS >= 16 ? 1 : 16 / REGS;
  // int8 rows take a quarter of an fp32 row's registers: cap the unit at
  // 16 tokens (a page at the serving shape), so a unit is not mostly
  // masked rows
  constexpr int STEPS = kQuant && STEPS_REGS * TPW > 16
                            ? (TPW >= 16 ? 1 : 16 / TPW)
                            : STEPS_REGS;
  constexpr int CH = STEPS * TPW;               // tokens per unit
  using Unit = UnitRows<KV, kQuant, V, NV, STEPS>;
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
  // request unit u's K and V rows (page id `page`) and scales into `b`
  auto request = [&](Unit& b, int u, int page) {
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
    if constexpr (kQuant) {
      const int64_t srow = (int64_t)page * ps + t0;
#pragma unroll
      for (int j = 0; j < STEPS; ++j) {
        const int t = j * TPW + grp;
        b.ks[j] = t < b.live ? k_scales[srow + t] : 0.f;
        b.vs[j] = t < b.live ? v_scales[srow + t] : 0.f;
      }
    }
  };
  // one online-softmax update over the unit in `b`
  auto fold = [&](const Unit& b) {
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
      float sc = dot * scale;
      if constexpr (kQuant) sc *= b.ks[j];      // (q.k * scale) * k_scale
      s[j] = j * TPW + grp < b.live ? sc : kNegInf;
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
    if constexpr (kQuant) {
#pragma unroll
      for (int j = 0; j < STEPS; ++j) s[j] *= b.vs[j];  // after l: l never sees it
    }
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
  Unit a, b;
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

template <typename T, typename KV, bool kQuant, int V, int G, int NV>
cudaError_t run_decode_vec(const void* q, const void* kp, const void* vp,
                           const void* ks, const void* vs, const void* bt,
                           const void* len, void* out, int S, int H, int Dh,
                           int ps, int w, int P, float scale,
                           cudaStream_t stream) {
  paged_decode_vec_kernel<T, KV, kQuant, V, G, NV>
      <<<dim3(S, H), kDecThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const KV*>(kp),
          static_cast<const KV*>(vp), static_cast<const float*>(ks),
          static_cast<const float*>(vs), static_cast<const int32_t*>(bt),
          static_cast<const int32_t*>(len), static_cast<T*>(out), H, Dh, ps,
          w, P, scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// 16-byte vectors where every row of both pools is 16-byte aligned, G the
// smallest power of two lanes that covers a row (two vectors per lane for
// fp32 rows past 128 elements); otherwise one element per lane and vector.
template <typename T, typename KV, bool kQuant>
cudaError_t decode_vec(const void* q, const void* kp, const void* vp,
                       const void* ks, const void* vs, const void* bt,
                       const void* len, void* out, int S, int H, int Dh,
                       int ps, int w, int P, float scale,
                       cudaStream_t stream) {
  constexpr int V = 16 / sizeof(KV);
  constexpr int kMaxVecs = kMaxHeadDim / V;     // 64, 32 or 16 vectors a row
  const bool vec = Dh % V == 0 && aligned16(kp) && aligned16(vp);
#define PTT_DECODE(V_, G_, NV_)                                           \
  return run_decode_vec<T, KV, kQuant, V_, G_, NV_>(                      \
      q, kp, vp, ks, vs, bt, len, out, S, H, Dh, ps, w, P, scale, stream)
  if (vec) {
    const int nvec = Dh / V;
    if (nvec <= 1) PTT_DECODE(V, 1, 1);
    if (nvec <= 2) PTT_DECODE(V, 2, 1);
    if (nvec <= 4) PTT_DECODE(V, 4, 1);
    if (nvec <= 8) PTT_DECODE(V, 8, 1);
    if (nvec <= 16) PTT_DECODE(V, 16, 1);
    if constexpr (kMaxVecs > 16) {
      if (nvec <= 32) PTT_DECODE(V, 32, 1);
    }
    if constexpr (kMaxVecs > 32) PTT_DECODE(V, 32, 2);
    return cudaErrorInvalidValue;
  }
  switch ((Dh + 31) / 32) {
    case 1: PTT_DECODE(1, 32, 1);
    case 2: PTT_DECODE(1, 32, 2);
    case 3: PTT_DECODE(1, 32, 3);
    case 4: PTT_DECODE(1, 32, 4);
    case 5: PTT_DECODE(1, 32, 5);
    case 6: PTT_DECODE(1, 32, 6);
    case 7: PTT_DECODE(1, 32, 7);
    case 8: PTT_DECODE(1, 32, 8);
  }
#undef PTT_DECODE
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K3 (bf16 pages) and K4 (int8 pages), bf16 q and Dh <= 128: ragged paged
// prefill, and the speculative verify step, on the tensor cores. Replaces
// _paged_prefill_pallas (K3) and _paged_prefill_int8_pallas (K4)
// (paddle_tpu/serving/decode_attention.py:443 and :533, body
// _paged_prefill_kernel :396).
//
// What bounds it: bytes still (a chunk of C rows does 4 * C flops per K/V
// element, under the card's ~295 flops a byte at C <= 64), so the design
// is about reading every live page once per block, not once per query
// row as the scalar template does, and about keeping that read in flight.
// At the serving shapes the block's serial walk over its key tiles is
// what the kernel waits on, so each tile's work is kept short.
//
// One block of NW warps per (slot, head, tile of up to kRowTile query
// rows). The block walks the slot's tokens up to its last live row's
// causal horizon in key tiles of kKeyTile tokens. The block's page ids
// (clamped into [0, P)) are read into shared memory once, at the start,
// so no tile's copies wait behind a load of the block table. Each key
// tile's K and V rows (and, for int8, their scale rows) come into shared
// memory once for all of the block's rows, by 16-byte cp.async
// (zero-filled past the horizon; element by element where a row is not a
// 16-byte multiple or a pool is not 16-byte aligned), into a ring of
// kStages stages: the next tile is in flight while this one is used, and
// one barrier per tile both publishes the landed tile and frees the stage
// the next copy overwrites. Raw rows are DP * sizeof(KV) + 16 bytes apart
// (DP = 16 * NK, the head dim padded to the mma depth).
//
// Products: mma.sync m16n8k16 bf16 with fp32 accumulation. A warp owns 16
// query rows (its q fragments stay in registers for the whole walk): S =
// Q K^T for its token slice, then in fp32 s = acc * scale (times
// k_scale[t] for int8), tokens past each row's horizon selected to
// NEG_INF before the max and to p = 0 after it, l takes p, then p (times
// v_scale[t] for int8) is rounded to bf16 and the S accumulator registers
// become the A fragments of P V. wgmma would need 64-row tiles, 94%
// padding for a 4-row verify call; at these shapes the tensor cores are
// not what bounds the kernel.
//
// The B fragments, by page type:
//   - bf16 pages (K3): the staged rows already are the mma's operand type,
//     so the warps read fragments straight out of the ring: ldmatrix.x4 on
//     the row-major K tile (token rows, head-dim columns: each 8x8 matrix
//     gives a lane K[token g][d 2tg, 2tg+1], the B fragment of Q K^T) and
//     ldmatrix.x4.trans on the row-major V tile (the transpose gives a lane
//     V[tokens 2tg, 2tg+1][d g], the B fragment of P V). No conversion pass
//     and no second barrier per tile; shared memory is the ring and the
//     page ids alone (37 KB at Dh = 64). Bank conflicts: each ldmatrix
//     phase reads one 8x8 matrix, 8 rows of 16 bytes at a stride of RS =
//     32 * NK + 16 bytes, an odd number (2 * NK + 1) of 16-byte units, so
//     the 8 rows fall in 8 distinct 16-byte bank groups of the 128-byte
//     bank cycle: conflict-free.
//   - int8 pages (K4): int8 has no ldmatrix transpose and mma wants token
//     pairs of V in one register, so after each tile lands the block
//     converts it once (int8 to bf16, exact since |x| <= 127) to a
//     row-major bf16 K tile and a transposed bf16 V tile, rows padded by 16
//     bytes, and the warps read fragments from those as 32-bit words.
//
// Small chunks: when the live rows fill fewer 16-row tiles than the block
// has warps (a 4-row verify call, a prefill tail), the warps of one row
// tile split each key tile's tokens between them (up to 4 warps x 16
// tokens), so every warp has work; their (m, l, acc) states merge in
// shared memory in warp order at the end, so repeat launches give the
// same bits. Key tiles past the row tile's last horizon are skipped by
// its warps. Rows at or past n_valid, and inactive slots, write exact
// zeros.
//
// Warps per block: K4 keeps 4 (its instance gives the same bits as before
// the bf16-page instance existed); K3 takes 8, measured against 4 at the
// serving shape (S=16, H=16, Dh=64, page 16, width 32): 0.0435 against
// 0.0569 ms at chunk 64, where pairs of warps halve each key tile's work,
// and 0.0262 against 0.0324 ms at chunk 4, where the same 4 warps compute
// but 8 share the tile's copies (NVIDIA H100 80GB HBM3, 700 W; chip_ab.py
// --phases kernels, two turns each).
// ---------------------------------------------------------------------------
constexpr int kInt8PreWarps = 4;
constexpr int kFpPreWarps = 8;
constexpr int kRowTile = 64;   // query rows per block
constexpr int kKeyTile = 64;   // tokens per staged key tile
constexpr int kStages = 2;     // key tiles in the ring
// the widest block table whose page ids a block keeps in shared memory
constexpr int kMaxIdCols = 8192;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8, register i gets this lane's part of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, each matrix transposed on the way
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// two fp32 values as a bf16 pair, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a b: one m16n8k16 bf16 product with fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the 16 int8 page elements of a 16-byte chunk as bf16 pairs
__device__ __forceinline__ void int8_chunk_to_bf16(const uint4& raw,
                                                   uint32_t (&out)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = pack_bf16(i8_at(w[i], 0), i8_at(w[i], 1));
    out[2 * i + 1] = pack_bf16(i8_at(w[i], 2), i8_at(w[i], 3));
  }
}

// Shared memory of one block, in bytes: the raw stages (K rows, V rows
// and, for int8, k scales and v scales); for int8 then the bf16 K tile,
// the transposed bf16 V tile and the tile's scales; then (from BYTES on)
// the block's page ids, 4 bytes a block-table column. The final merge
// reuses the area before BYTES from the start.
template <typename KV, int NK, int NW>
struct PrefillSmem {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int DP = 16 * NK;                      // padded head dim
  static constexpr int RS = DP * (int)sizeof(KV) + 16;    // raw row bytes
  static constexpr int CPR = DP * (int)sizeof(KV) / 16;   // 16-byte chunks
  static constexpr int E = 16 / (int)sizeof(KV);          // elements a chunk
  static constexpr int KS = DP + 8;                       // bf16 K row stride
  static constexpr int VS = kKeyTile + 8;                 // bf16 V^T row stride
  static constexpr int SCALES = kQuant ? 2 * kKeyTile * 4 : 0;
  static constexpr int STAGE = 2 * kKeyTile * RS + SCALES;
  static constexpr int KB = kStages * STAGE;
  static constexpr int VT = KB + (kQuant ? kKeyTile * KS * 2 : 0);
  static constexpr int SC = VT + (kQuant ? DP * VS * 2 : 0);
  static constexpr int BYTES = SC + SCALES;
  static constexpr int MERGE = NW * 16 * (DP + 2) * 4;
  static_assert(MERGE <= BYTES, "the merge scratch fits in the staging area");
  static_assert(RS % 16 == 0 && (kQuant || (RS / 16) % 2 == 1),
                "raw rows 16-byte aligned and, where ldmatrix reads them, an "
                "odd number of 16-byte units apart (conflict-free)");
};

// q, out (S, C, H, Dh) bf16; pages (P, ps, H, Dh) of KV (bf16, or int8
// with kQuant); scales (P, ps) with kQuant; block_tables (S, w);
// chunk_starts, n_valid (S,). Grid (S, H, ceil(C / kRowTile)), NW * 32
// threads, PrefillSmem<KV, NK, NW>::BYTES + 4 * w bytes (rounded up to
// 16) of dynamic shared memory, w <= kMaxIdCols. `vec`: 16-byte staging
// (Dh == 16 * NK and both pools 16-byte aligned).
template <typename KV, bool kQuant, int NK, int NW>
__global__ void __launch_bounds__(NW * 32)
    paged_prefill_tc_kernel(const __nv_bfloat16* __restrict__ q,
                            const KV* __restrict__ k_pages,
                            const KV* __restrict__ v_pages,
                            const float* __restrict__ k_scales,
                            const float* __restrict__ v_scales,
                            const int32_t* __restrict__ block_tables,
                            const int32_t* __restrict__ chunk_starts,
                            const int32_t* __restrict__ n_valid,
                            __nv_bfloat16* __restrict__ out, int C, int H,
                            int Dh, int ps, int w, int P, float scale,
                            int vec) {
  using L = PrefillSmem<KV, NK, NW>;
  static_assert(L::kQuant == kQuant, "int8 pages are the quantized ones");
  constexpr int NT = NW * 32;
  constexpr int DP = L::DP, RS = L::RS, CPR = L::CPR, E = L::E;
  constexpr int KS = L::KS, VS = L::VS;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* kb = reinterpret_cast<__nv_bfloat16*>(smem + L::KB);
  __nv_bfloat16* vt = reinterpret_cast<__nv_bfloat16*>(smem + L::VT);
  float* ksc = reinterpret_cast<float*>(smem + L::SC);
  float* vsc = ksc + kKeyTile;
  int32_t* ids = reinterpret_cast<int32_t*>(smem + L::BYTES);

  const int slot = blockIdx.x, head = blockIdx.y;
  const int r0 = blockIdx.z * kRowTile;          // the block's first row
  const int rows = min(kRowTile, C - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;        // mma group, thread in group
  const int start = chunk_starts[slot];
  const int cap = w * ps;
  const int nl = min(max(n_valid[slot] - r0, 0), rows);   // live rows
  // causal horizon of block row r (exclusive); 0 for a dead row
  auto row_lim = [&](int r) {
    return r < nl ? min(start + r0 + r + 1, cap) : 0;
  };
  const int n_hi = nl > 0 ? row_lim(nl - 1) : 0;  // the block's horizon
  auto out_at = [&](int r, int d) {
    return out + (((int64_t)slot * C + r0 + r) * H + head) * Dh + d;
  };
  if (n_hi <= 0) {  // inactive slot, or no live row: exact zeros
    for (int i = threadIdx.x; i < rows * Dh; i += NT)
      *out_at(i / Dh, i % Dh) = __float2bfloat16(0.f);
    return;
  }
  {
    const int32_t* bt_row = block_tables + (int64_t)slot * w;
    for (int c = threadIdx.x; c < (n_hi + ps - 1) / ps; c += NT)
      ids[c] = min(max(bt_row[c], 0), P - 1);
  }
  const int64_t tok_stride = (int64_t)H * Dh;

  // row tiles of 16 and the split of each key tile's tokens over the
  // warps of a row tile: as many warps as the block has per row tile,
  // up to 4 (16 tokens each, the depth of one P V step)
  const int nrt = (nl + 15) / 16;
  int spl = 1;
  while (spl < 4 && 2 * spl * nrt <= NW) spl *= 2;
  const int rt = warp / spl, ph = warp % spl;
  const bool active = rt < nrt;
  const int slice = kKeyTile / spl;              // tokens a warp takes
  const int ra = rt * 16 + g, rb = ra + 8;       // this lane's two rows
  const int lim_a = row_lim(ra), lim_b = row_lim(rb);
  const int lim_tile = active ? row_lim(min(rt * 16 + 15, nl - 1)) : 0;

  // q fragments (A of S = Q K^T), rows ra / rb, zero past Dh and dead rows
  uint32_t qa[NK][4];
  {
    auto qv = [&](int r, int d) {
      return active && r < nl && d < Dh
                 ? __bfloat162float(
                       q[(((int64_t)slot * C + r0 + r) * H + head) * Dh + d])
                 : 0.f;
    };
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const int d = 16 * kk + 2 * tg;
      qa[kk][0] = pack_bf16(qv(ra, d), qv(ra, d + 1));
      qa[kk][1] = pack_bf16(qv(rb, d), qv(rb, d + 1));
      qa[kk][2] = pack_bf16(qv(ra, d + 8), qv(ra, d + 9));
      qa[kk][3] = pack_bf16(qv(rb, d + 8), qv(rb, d + 9));
    }
  }
  float o[DP / 8][4];
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd)
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  // running max and sum of the lane's two rows (l: this lane's part)
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  __syncthreads();   // the page ids are in

  auto page_row = [&](int t) {   // token t's row in the pool
    return (int64_t)ids[t / ps] * ps + t % ps;
  };
  // request key tile j into its stage
  auto issue = [&](int j) {
    unsigned char* sb = smem + (j % kStages) * L::STAGE;
    const int t0 = j * kKeyTile;
    // consecutive threads take the chunks of one row
    for (int i = threadIdx.x; i < 2 * kKeyTile * CPR; i += NT) {
      const int c = i % CPR, tt = (i / CPR) % kKeyTile;
      const int kv = i / (CPR * kKeyTile);
      const bool ok = t0 + tt < n_hi;
      const KV* src = kv ? v_pages : k_pages;
      if (ok) src += page_row(t0 + tt) * tok_stride + (int64_t)head * Dh;
      unsigned char* dst = sb + (kv * kKeyTile + tt) * RS + 16 * c;
      if (vec) {
        cp_async16(dst, src + c * E, ok);
      } else {
        union {
          uint4 u;
          KV e[E];
        } chunk;
        chunk.u = make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int x = 0; x < E; ++x)
          if (ok && c * E + x < Dh) chunk.e[x] = src[c * E + x];
        *reinterpret_cast<uint4*>(dst) = chunk.u;
      }
    }
    if constexpr (kQuant) {
      float* sdst = reinterpret_cast<float*>(sb + 2 * kKeyTile * RS);
      for (int i = threadIdx.x; i < 2 * kKeyTile; i += NT) {
        const int tt = i % kKeyTile;
        const bool ok = t0 + tt < n_hi;
        const float* src = i < kKeyTile ? k_scales : v_scales;
        if (ok) src += page_row(t0 + tt);
        cp_async4(sdst + i, src, ok);
      }
    }
  };
  // int8: key tile j's stage to the bf16 tiles (K row-major, V transposed)
  auto convert = [&](int j) {
    const unsigned char* sb = smem + (j % kStages) * L::STAGE;
    // consecutive threads take consecutive tokens: conflict-free stores
    for (int i = threadIdx.x; i < 2 * kKeyTile * CPR; i += NT) {
      const int tt = i % kKeyTile, c = (i / kKeyTile) % CPR;
      const int kv = i / (kKeyTile * CPR);
      const uint4 raw = *reinterpret_cast<const uint4*>(
          sb + (kv * kKeyTile + tt) * RS + 16 * c);
      uint32_t pr[8];
      int8_chunk_to_bf16(raw, pr);
      if (kv == 0) {
        uint4* dst = reinterpret_cast<uint4*>(kb + tt * KS + c * E);
        dst[0] = make_uint4(pr[0], pr[1], pr[2], pr[3]);
        dst[1] = make_uint4(pr[4], pr[5], pr[6], pr[7]);
      } else {
        unsigned short* col =
            reinterpret_cast<unsigned short*>(vt) + (c * E) * VS + tt;
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          col[(2 * x) * VS] = static_cast<unsigned short>(pr[x] & 0xffffu);
          col[(2 * x + 1) * VS] = static_cast<unsigned short>(pr[x] >> 16);
        }
      }
    }
    const float* ssrc = reinterpret_cast<const float*>(sb + 2 * kKeyTile * RS);
    for (int i = threadIdx.x; i < 2 * kKeyTile; i += NT)
      ksc[i] = ssrc[i];          // ksc and vsc are adjacent
  };
  // this warp's slice of key tile j: one online-softmax update
  auto compute = [&](int j) {
    const int s0 = ph * slice;                   // slice's first tile token
    const int t0 = j * kKeyTile + s0;
    if (!active || t0 >= lim_tile) return;       // nothing visible here
    const int ngl = min(slice / 16, (lim_tile - t0 + 15) / 16);
    // bf16 pages: this lane's ldmatrix row addresses in the staged tile
    // (K: tokens + lane % 8 and + 8 for lanes 16-31, d + 8 for lanes 8-15
    // and 24-31; V: tokens + lane % 8 and + 8 for lanes 8-15 and 24-31,
    // d + 8 for lanes 16-31)
    const unsigned sk = static_cast<unsigned>(__cvta_generic_to_shared(
        smem + (j % kStages) * L::STAGE));
    const unsigned k_addr =
        sk + (s0 + (lane & 7) + ((lane >> 4) << 3)) * RS +
        ((lane >> 3) & 1) * 16;
    const unsigned v_addr =
        sk + (kKeyTile + s0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * RS +
        (lane >> 4) * 16;
    float s[4][2][4];
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int gi = 0; gi < 4; ++gi) {
      if (gi >= ngl) continue;
      float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      if constexpr (kQuant) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const __nv_bfloat16* krow =
              kb + (s0 + 16 * gi + 8 * nt + g) * KS + 2 * tg;
#pragma unroll
          for (int kk = 0; kk < NK; ++kk)
            mma_bf16(c[nt], qa[kk],
                     *reinterpret_cast<const uint32_t*>(krow + 16 * kk),
                     *reinterpret_cast<const uint32_t*>(krow + 16 * kk + 8));
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          uint32_t b[4];   // tokens 0-7 (d lo, hi), tokens 8-15 (d lo, hi)
          ldsm_x4(b, k_addr + 16 * gi * RS + 32 * kk);
          mma_bf16(c[0], qa[kk], b[0], b[1]);
          mma_bf16(c[1], qa[kk], b[2], b[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tt = s0 + 16 * gi + 8 * nt + 2 * tg + (e & 1);
          float v = c[nt][e] * scale;
          if constexpr (kQuant) v *= ksc[tt];    // (q.k * scale) * k_scale
          v = j * kKeyTile + tt < (e < 2 ? lim_a : lim_b) ? v : kNegInf;
          s[gi][nt][e] = v;
          if (e < 2) mx_a = fmaxf(mx_a, v);
          else mx_b = fmaxf(mx_b, v);
        }
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, x));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, x));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    l_a *= al_a;
    l_b *= al_b;
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) {
      o[nd][0] *= al_a;
      o[nd][1] *= al_a;
      o[nd][2] *= al_b;
      o[nd][3] *= al_b;
    }
#pragma unroll
    for (int gi = 0; gi < 4; ++gi) {
      if (gi >= ngl) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tt = s0 + 16 * gi + 8 * nt + 2 * tg + (e & 1);
          const bool ok = j * kKeyTile + tt < (e < 2 ? lim_a : lim_b);
          // masked tokens weigh exactly 0 (even while m is still NEG_INF)
          float p = ok ? expf(s[gi][nt][e] - (e < 2 ? mn_a : mn_b)) : 0.f;
          if (e < 2) l_a += p;
          else l_b += p;
          if constexpr (kQuant) p *= vsc[tt];    // after l: l never sees it
          s[gi][nt][e] = p;
        }
      // P's A fragment from the S accumulator layout, rounded to bf16
      const uint32_t pa[4] = {pack_bf16(s[gi][0][0], s[gi][0][1]),
                              pack_bf16(s[gi][0][2], s[gi][0][3]),
                              pack_bf16(s[gi][1][0], s[gi][1][1]),
                              pack_bf16(s[gi][1][2], s[gi][1][3])};
      if constexpr (kQuant) {
        const __nv_bfloat16* vcol = vt + g * VS + s0 + 16 * gi + 2 * tg;
#pragma unroll
        for (int nd = 0; nd < DP / 8; ++nd)
          mma_bf16(o[nd], pa,
                   *reinterpret_cast<const uint32_t*>(vcol + 8 * nd * VS),
                   *reinterpret_cast<const uint32_t*>(vcol + 8 * nd * VS + 8));
      } else {
#pragma unroll
        for (int nd = 0; nd < DP / 8; nd += 2) {
          uint32_t b[4];   // d block nd (tokens lo, hi), d block nd + 1
          ldsm_x4_trans(b, v_addr + 16 * gi * RS + 16 * nd);
          mma_bf16(o[nd], pa, b[0], b[1]);
          mma_bf16(o[nd + 1], pa, b[2], b[3]);
        }
      }
    }
  };

  const int n_tiles = (n_hi + kKeyTile - 1) / kKeyTile;
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) issue(j);
    cp_async_commit();
  }
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile j has landed; every warp is done with j - 1
    if (j + kStages - 1 < n_tiles) issue(j + kStages - 1);
    cp_async_commit();
    if constexpr (kQuant) {
      convert(j);
      __syncthreads();
    }
    compute(j);
  }
  __syncthreads();     // the merge below reuses the staging area

  // the quad's four parts of l, summed in one fixed order
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l_a += __shfl_xor_sync(kFull, l_a, x);
    l_b += __shfl_xor_sync(kFull, l_b, x);
  }
  float* mo = reinterpret_cast<float*>(smem);    // [warp][16][DP]
  float* mm = mo + NW * 16 * DP;                 // [warp][16]
  float* ml = mm + NW * 16;
  if (active) {
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) {
      const int d = 8 * nd + 2 * tg;
      mo[(warp * 16 + g) * DP + d] = o[nd][0];
      mo[(warp * 16 + g) * DP + d + 1] = o[nd][1];
      mo[(warp * 16 + g + 8) * DP + d] = o[nd][2];
      mo[(warp * 16 + g + 8) * DP + d + 1] = o[nd][3];
    }
    if (tg == 0) {
      mm[warp * 16 + g] = m_a;
      mm[warp * 16 + g + 8] = m_b;
      ml[warp * 16 + g] = l_a;
      ml[warp * 16 + g + 8] = l_b;
    }
  }
  __syncthreads();
  // merge each row tile's warps in warp order; a warp whose slices held
  // no visible token has m = NEG_INF, l = 0 and weighs exactly 0
  for (int i = threadIdx.x; i < rows * Dh; i += NT) {
    const int r = i / Dh, d = i % Dh;
    float val = 0.f;
    if (row_lim(r) > 0) {
      const int w0 = (r / 16) * spl, rr = r % 16;
      float m = kNegInf;
      for (int p = 0; p < spl; ++p) m = fmaxf(m, mm[(w0 + p) * 16 + rr]);
      float l = 0.f, acc = 0.f;
      for (int p = 0; p < spl; ++p) {
        const float wt = expf(mm[(w0 + p) * 16 + rr] - m);
        l += ml[(w0 + p) * 16 + rr] * wt;
        acc += mo[((w0 + p) * 16 + rr) * DP + d] * wt;
      }
      val = acc / l;
    }
    *out_at(r, d) = __float2bfloat16(val);
  }
}

template <typename KV, bool kQuant, int NK, int NW>
cudaError_t run_prefill_tc(const void* q, const void* kp, const void* vp,
                           const void* ks, const void* vs, const void* bt,
                           const void* st, const void* nv, void* out, int S,
                           int C, int H, int Dh, int ps, int w, int P,
                           float scale, cudaStream_t stream) {
  const int bytes = PrefillSmem<KV, NK, NW>::BYTES + (4 * w + 15) / 16 * 16;
  auto kernel = paged_prefill_tc_kernel<KV, kQuant, NK, NW>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  const int vec = Dh == 16 * NK && aligned16(kp) && aligned16(vp);
  const dim3 grid(S, H, (C + kRowTile - 1) / kRowTile);
  kernel<<<grid, NW * 32, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int32_t*>(bt),
      static_cast<const int32_t*>(st), static_cast<const int32_t*>(nv),
      static_cast<__nv_bfloat16*>(out), C, H, Dh, ps, w, P, scale, vec);
  return cudaGetLastError();
}

// NK = ceil(Dh / 16) k-steps of 16 (Dh <= 128)
template <typename KV, bool kQuant, int NW>
cudaError_t prefill_tc(const void* q, const void* kp, const void* vp,
                       const void* ks, const void* vs, const void* bt,
                       const void* st, const void* nv, void* out, int S, int C,
                       int H, int Dh, int ps, int w, int P, float scale,
                       cudaStream_t stream) {
#define PTT_PREFILL_TC(NK_)                                            \
  return run_prefill_tc<KV, kQuant, NK_, NW>(q, kp, vp, ks, vs, bt, st, \
                                             nv, out, S, C, H, Dh, ps,  \
                                             w, P, scale, stream)
  switch ((Dh + 15) / 16) {
    case 1: PTT_PREFILL_TC(1);
    case 2: PTT_PREFILL_TC(2);
    case 3: PTT_PREFILL_TC(3);
    case 4: PTT_PREFILL_TC(4);
    case 5: PTT_PREFILL_TC(5);
    case 6: PTT_PREFILL_TC(6);
    case 7: PTT_PREFILL_TC(7);
    case 8: PTT_PREFILL_TC(8);
  }
#undef PTT_PREFILL_TC
  return cudaErrorInvalidValue;
}

// the tensor-core prefill takes bf16 q with Dh <= 128 and a block table
// whose page ids fit its shared memory; everything else the scalar one
bool tc_prefill(int dtype, int Dh, int w) {
  return dtype == 1 && Dh <= 128 && w <= kMaxIdCols;
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

// The scalar prefill template. DPL (head-dim elements per lane) is a
// template parameter so that q and the accumulator stay in registers;
// Dh <= 256 gives DPL <= 8.
template <typename T, typename KV, bool kQuant>
cudaError_t prefill_t(const void* q, const void* kp, const void* vp,
                      const void* ks, const void* vs, const void* bt,
                      const void* st, const void* nv, void* out, int S, int C,
                      int H, int Dh, int ps, int w, int P, float scale,
                      cudaStream_t stream) {
#define PTT_PREFILL(DPL_)                                                   \
  return run_prefill<T, KV, kQuant, DPL_>(                                  \
      q, kp, vp, static_cast<const float*>(ks), static_cast<const float*>(vs), \
      bt, st, nv, out, S, C, H, Dh, ps, w, P, scale, stream)
  switch ((Dh + 31) / 32) {
    case 1: PTT_PREFILL(1);
    case 2: PTT_PREFILL(2);
    case 3: PTT_PREFILL(3);
    case 4: PTT_PREFILL(4);
    case 5: PTT_PREFILL(5);
    case 6: PTT_PREFILL(6);
    case 7: PTT_PREFILL(7);
    case 8: PTT_PREFILL(8);
  }
#undef PTT_PREFILL
  return cudaErrorInvalidValue;
}

bool bad_geometry(int H, int Dh, int ps, int w, int P) {
  return H < 1 || H > 65535 || Dh < 1 || Dh > kMaxHeadDim || ps < 1 ||
         ps > kMaxPageSize || w < 1 || P < 1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of q and out; the fp kernels' pages
// share it, the int8 kernels' pages are int8 with float32 scales (P, ps)).
// Returns the cudaError_t of the launch (0 = success). The prefill entry
// points take the tensor-core kernel where tc_prefill says so (bf16 q,
// Dh <= 128) and the scalar template otherwise: fp32 q keeps it because
// the contracts of 2e-5 and 5e-5 do not survive bf16 operands.
extern "C" int ptt_paged_decode(const void* q, const void* k_pages,
                                const void* v_pages, const void* block_tables,
                                const void* lengths, void* out, int S, int H,
                                int Dh, int ps, int w, int P, int dtype,
                                float scale, void* stream) {
  if (S == 0) return cudaSuccess;
  if (S < 0 || bad_geometry(H, Dh, ps, w, P)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return decode_vec<float, float, false>(q, k_pages, v_pages, nullptr,
                                           nullptr, block_tables, lengths, out,
                                           S, H, Dh, ps, w, P, scale, s);
  if (dtype == 1)
    return decode_vec<__nv_bfloat16, __nv_bfloat16, false>(
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
  if (tc_prefill(dtype, Dh, w))
    return prefill_tc<__nv_bfloat16, false, kFpPreWarps>(
        q, k_pages, v_pages, nullptr, nullptr, block_tables, chunk_starts,
        n_valid, out, S, C, H, Dh, ps, w, P, scale, s);
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
    return decode_vec<float, int8_t, true>(q, k_pages, v_pages, k_scales,
                                           v_scales, block_tables, lengths,
                                           out, S, H, Dh, ps, w, P, scale, s);
  if (dtype == 1)
    return decode_vec<__nv_bfloat16, int8_t, true>(
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
  if (tc_prefill(dtype, Dh, w))
    return prefill_tc<int8_t, true, kInt8PreWarps>(
        q, k_pages, v_pages, k_scales, v_scales, block_tables, chunk_starts,
        n_valid, out, S, C, H, Dh, ps, w, P, scale, s);
  if (dtype == 1)
    return prefill_t<__nv_bfloat16, int8_t, true>(
        q, k_pages, v_pages, k_scales, v_scales, block_tables, chunk_starts,
        n_valid, out, S, C, H, Dh, ps, w, P, scale, s);
  return cudaErrorInvalidValue;
}
