// Flash attention, forward and backward, for Hopper (sm_90a), behind a
// plain C interface (loaded with ctypes; no PyTorch headers).
//
// Replaces the TPU kernels of paddle_tpu/ops/attention.py:
//   ptt_flash_fwd      <- _flash_fwd            (body _flash_fwd_kernel)
//   ptt_flash_bwd_dkv  <- _flash_bwd, dk/dv call (body _flash_bwd_dkv_kernel)
//   ptt_flash_bwd_dq   <- _flash_bwd, dq call    (body _flash_bwd_dq_kernel)
// They compute what the TPU kernels compute: scores q.k in fp32, scaled in
// fp32 after the dot (the reference's lax path), plus an optional additive
// fp32 bias read through four strides (a key-padding bias has a zero query
// stride, a full bias does not), a bottom-right aligned causal mask
// (col <= row + Sk - Sq), an online softmax with fp32 accumulation, exact
// zeros for rows whose every key is masked (with lse ~ NEG_INF), and a
// FlashAttention-2 backward that recomputes p = exp(s - lse) with the
// forward's masks. delta = rowsum(do * o) is computed by the caller, as the
// reference leaves it to XLA.
//
// What bounds them on an H100: at BERT-base shapes (S = 512, Dh = 64, bf16)
// the forward is at the byte/operation balance (4 S Dh flops per 4 Dh
// elements moved; bound 0.045 ms at (48, 12, 512, 64)), the two backward
// kernels are operation-bound (8 and 6 S^2 Dh flops; 0.078 and 0.059 ms).
//
// Two designs, chosen by element type inside PTT_FLASH_CASES:
// - bf16 K5, K6a and K6b run on the tensor cores (section "Tensor-core
//   instances" below): wgmma m64nNk16 with fp32 accumulators, SS for the
//   products over D and RS (P, P^T, dS^T or dS as the register A operand)
//   for the products over keys or queries, tiles in shared memory as bf16
//   written by TMA into rings tracked by mbarriers. P, P^T, dS^T and dS
//   are rounded to bf16 as operands; every sum stays fp32.
// - fp32 (all three kernels) keeps the scalar design (simple and right
//   first): the TPU kernels' sequential grid axis, which carries
//   (m, l, acc) or (dk, dv) or dq in VMEM scratch, is a loop inside one
//   block, so no state crosses blocks and no atomics are needed. A block
//   of 256 threads (16 x 16) owns a 64-row tile (the forward and dq one
//   query tile looping over key tiles, dk/dv one key tile looping over
//   query tiles) staged in shared memory as fp32; each thread computes a
//   4 x 4 micro-tile of the 64 x 64 score block with scalar fp32 FMA, row
//   reductions are 16-lane shuffles, and the score block goes through
//   shared memory into the second product. K/V tiles have an odd row
//   stride and Q/dO tiles a stride of D + 4 (no bank conflicts). fp32
//   stays fp32 throughout (no TF32: the tensor cores have no full-fp32
//   mode), so the fp32 path meets the reference contract's 2e-5.
// Both skip causal tiles wholly above the diagonal, write every output
// once (bitwise reproducible), and read rows past the end as zeros.
// Left for later: a producer warp with setmaxnreg, two consumer
// warpgroups in ping-pong, a persistent grid.

#include <cuda.h>   // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;        // query rows and key rows per tile
constexpr int kThreads = 256;    // 16 x 16; thread (ty, tx)
constexpr int kMicro = 4;        // micro-tile edge
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16-byte vector of T: 4 floats or 8 bf16
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* g, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(g);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* g, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(g);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// Stage rows [row0, row0 + kTile) of a (rows, D) matrix into shared memory
// as fp32 with row stride `stride`; rows at or past n_rows become zeros.
template <typename T, int D>
__device__ void load_tile(const T* __restrict__ g, int row0, int n_rows,
                          float* s, int stride) {
  constexpr int V = Vec<T>::N;
  constexpr int kPerRow = D / V;
  for (int idx = threadIdx.x; idx < kTile * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * V;
    float x[V];
    if (row0 + r < n_rows) {
      Vec<T>::load(g + (int64_t)(row0 + r) * D + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) s[r * stride + c + e] = x[e];
  }
}

__device__ __forceinline__ void load_vec(const float* __restrict__ g, int row0,
                                         int n_rows, float* s) {
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    s[r] = row0 + r < n_rows ? g[row0 + r] : 0.f;
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Geometry {
  int H, Sq, Sk;
  float scale;
  int causal;
  const float* bias;  // nullptr: no bias
  int64_t sb, sh, sq, sk;  // bias strides in elements (sq = 0: key bias)
};

// Masked, scaled, biased score of (row, col): the reference's
// _masked_scores / the Pallas kernel's masking, in the same order.
__device__ __forceinline__ float masked_score(float dot, int row, int col,
                                              int b, int h,
                                              const Geometry& g) {
  if (col >= g.Sk) return kNegInf;
  float s = dot * g.scale;
  if (g.bias != nullptr && row < g.Sq)
    s += g.bias[b * g.sb + h * g.sh + row * g.sq + col * g.sk];
  if (g.causal && col > row + (g.Sk - g.Sq)) s = kNegInf;
  return s;
}

// acc[a][b] (+)= sum_d A[ty*4 + a][d] * B[tx + 16 b][d]
template <int D>
__device__ __forceinline__ void score_tile(const float* sA, int strideA,
                                           const float* sB, int strideB,
                                           float (&acc)[kMicro][kMicro]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < kMicro; ++a)
#pragma unroll
    for (int b = 0; b < kMicro; ++b) acc[a][b] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float x[kMicro], y[kMicro];
#pragma unroll
    for (int a = 0; a < kMicro; ++a) x[a] = sA[(ty * kMicro + a) * strideA + d];
#pragma unroll
    for (int b = 0; b < kMicro; ++b) y[b] = sB[(tx + 16 * b) * strideB + d];
#pragma unroll
    for (int a = 0; a < kMicro; ++a)
#pragma unroll
      for (int b = 0; b < kMicro; ++b) acc[a][b] = fmaf(x[a], y[b], acc[a][b]);
  }
}

// out[a][e] += sum_j W[j][ty*4 + a] * M[j][tx + 16 e]   (transposed: W^T M)
// or            sum_j W[ty*4 + a][j] * M[j][tx + 16 e]   (plain: W M)
template <int D, bool kTransposeW>
__device__ __forceinline__ void accumulate(const float* sW, int strideW,
                                           const float* sM, int strideM,
                                           float (&out)[kMicro][D / 16]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int j = 0; j < kTile; ++j) {
    float w[kMicro], m[D / 16];
#pragma unroll
    for (int a = 0; a < kMicro; ++a)
      w[a] = kTransposeW ? sW[j * strideW + ty * kMicro + a]
                         : sW[(ty * kMicro + a) * strideW + j];
#pragma unroll
    for (int e = 0; e < D / 16; ++e) m[e] = sM[j * strideM + tx + 16 * e];
#pragma unroll
    for (int a = 0; a < kMicro; ++a)
#pragma unroll
      for (int e = 0; e < D / 16; ++e) out[a][e] = fmaf(w[a], m[e], out[a][e]);
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ g, int row0,
                                           int n_rows,
                                           const float (&v)[kMicro][D / 16]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
    const int r = row0 + ty * kMicro + a;
    if (r >= n_rows) continue;
#pragma unroll
    for (int e = 0; e < D / 16; ++e)
      store_f(g + (int64_t)r * D + tx + 16 * e, v[a][e]);
  }
}

// Number of key tiles of `keys` keys a 64-row query tile starting at q0
// must visit: all of them, or with `causal` those not wholly above the
// diagonal of its last row.
__device__ __forceinline__ int key_tiles(int q0, const Geometry& g,
                                         int keys = kTile) {
  const int n = (g.Sk + keys - 1) / keys;
  if (!g.causal) return n;
  const int last = min(q0 + kTile - 1, g.Sq - 1) + (g.Sk - g.Sq);
  if (last < 0) return 0;
  return min(n, last / keys + 1);
}

__host__ __device__ constexpr int q_stride(int D) { return D + 4; }
__host__ __device__ constexpr int kv_stride(int D) { return D + 1; }
__host__ __device__ constexpr int p_stride() { return kTile + 1; }

// ---------------------------------------------------------------------------
// K5: forward. Replaces _flash_fwd / _flash_fwd_kernel (Pallas grid
// (BH, nq, nk), the key axis "arbitrary"). Bound on an H100 at
// (48, 12, 512, 64) bf16 with a key bias: 0.045 ms, by bytes (q, k, v, out
// once each; 3.9e10 flops take 0.039 ms on the tensor cores). The design
// keeps the key axis as the loop inside the block, so q is read once per
// query tile and k/v once per (query tile, key tile): with 64-row tiles
// k and v come from L2 S/64 times. Scalar FMA keeps it far from that
// bound (operations at the fp32 CUDA-core rate).
// Grid (B*H, ceil(Sq/64)). q, out (B*H, Sq, D); k, v (B*H, Sk, D); lse
// (B*H, Sq) fp32.
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (kTile * q_stride(D) + 2 * kTile * kv_stride(D) +
                          kTile * p_stride());
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, Geometry g) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * q_stride(D);
  float* sV = sK + kTile * kv_stride(D);
  float* sP = sV + kTile * kv_stride(D);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x, b = bh / g.H, h = bh % g.H;
  const int q0 = blockIdx.y * kTile;
  const T* qb = q + (int64_t)bh * g.Sq * D;
  const T* kb = k + (int64_t)bh * g.Sk * D;
  const T* vb = v + (int64_t)bh * g.Sk * D;

  load_tile<T, D>(qb, q0, g.Sq, sQ, q_stride(D));
  float m[kMicro], l[kMicro], acc[kMicro][D / 16];
#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc[a][e] = 0.f;
  }
  const int n_kt = key_tiles(q0, g);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // previous tile's sK/sV/sP reads are done
    load_tile<T, D>(kb, k0, g.Sk, sK, kv_stride(D));
    load_tile<T, D>(vb, k0, g.Sk, sV, kv_stride(D));
    __syncthreads();
    float s[kMicro][kMicro];
    score_tile<D>(sQ, q_stride(D), sK, kv_stride(D), s);
#pragma unroll
    for (int a = 0; a < kMicro; ++a) {
      const int row = q0 + ty * kMicro + a;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kMicro; ++c) {
        s[a][c] = masked_score(s[a][c], row, k0 + tx + 16 * c, b, h, g);
        mx = fmaxf(mx, s[a][c]);
      }
      const float m_next = fmaxf(m[a], row_max16(mx));
      const float alpha = expf(m[a] - m_next);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < kMicro; ++c) {
        const float p = expf(s[a][c] - m_next);
        rs += p;
        sP[(ty * kMicro + a) * p_stride() + tx + 16 * c] = p;
      }
      l[a] = l[a] * alpha + row_sum16(rs);
      m[a] = m_next;
#pragma unroll
      for (int e = 0; e < D / 16; ++e) acc[a][e] *= alpha;
    }
    __syncthreads();
    accumulate<D, false>(sP, p_stride(), sV, kv_stride(D), acc);
  }
  // finish: rows whose every key is masked keep m ~ NEG_INF; they emit 0
  // (not a uniform mean of v) and lse = m + log(l) ~ NEG_INF
#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
    const float denom = l[a] == 0.f ? 1.f : l[a];
    const bool alive = m[a] > kNegInf / 2;
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc[a][e] = alive ? acc[a][e] / denom : 0.f;
    const int row = q0 + ty * kMicro + a;
    if (tx == 0 && row < g.Sq)
      lse[(int64_t)bh * g.Sq + row] = m[a] + logf(denom);
  }
  store_rows<T, D>(out + (int64_t)bh * g.Sq * D, q0, g.Sq, acc);
}

// ---------------------------------------------------------------------------
// Backward: both kernels recompute p and ds for one (query tile, key tile)
// pair into shared memory, then accumulate their products.
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t bwd_smem() {
  return sizeof(float) * (2 * kTile * q_stride(D) + 2 * kTile * kv_stride(D) +
                          2 * kTile * p_stride() + 2 * kTile);
}

struct BwdTiles {
  float *sQ, *sDO, *sK, *sV, *sP, *sDS, *sLse, *sDelta;
};

template <int D>
__device__ __forceinline__ BwdTiles carve(float* smem) {
  BwdTiles t;
  t.sQ = smem;
  t.sDO = t.sQ + kTile * q_stride(D);
  t.sK = t.sDO + kTile * q_stride(D);
  t.sV = t.sK + kTile * kv_stride(D);
  t.sP = t.sV + kTile * kv_stride(D);
  t.sDS = t.sP + kTile * p_stride();
  t.sLse = t.sDS + kTile * p_stride();
  t.sDelta = t.sLse + kTile;
  return t;
}

// p = exp(s - lse) with the forward's masks, zeroed on padded query rows
// and on fully-masked rows (lse <= NEG_INF / 2; _recompute_p), and
// ds = p (do.v - delta) scale; written to t.sP (if want_p) and t.sDS.
template <int D>
__device__ __forceinline__ void recompute_p_ds(const BwdTiles& t, int q0,
                                               int k0, int b, int h,
                                               const Geometry& g,
                                               bool want_p) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[kMicro][kMicro], dp[kMicro][kMicro];
  score_tile<D>(t.sQ, q_stride(D), t.sK, kv_stride(D), s);
  score_tile<D>(t.sDO, q_stride(D), t.sV, kv_stride(D), dp);
#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
    const int i = ty * kMicro + a;
    const int row = q0 + i;
    const float lse = t.sLse[i];
    const bool live = row < g.Sq && lse > kNegInf / 2;
    const float delta = t.sDelta[i];
#pragma unroll
    for (int c = 0; c < kMicro; ++c) {
      const int j = tx + 16 * c;
      const float x = masked_score(s[a][c], row, k0 + j, b, h, g);
      const float p = live ? expf(x - lse) : 0.f;
      if (want_p) t.sP[i * p_stride() + j] = p;
      t.sDS[i * p_stride() + j] = p * (dp[a][c] - delta) * g.scale;
    }
  }
}

// K6a: dk, dv. Replaces the dk/dv pallas_call of _flash_bwd
// (_flash_bwd_dkv_kernel, grid (BH, nk, nq), the query axis "arbitrary").
// Bound on an H100 at (48, 12, 512, 64) bf16: 0.078 ms, by operations
// (four S^2 D products). Each block owns a key tile and accumulates dk and
// dv for it in registers over all query tiles, so each output is written
// once and no two blocks touch the same row (no atomics).
// Grid (B*H, ceil(Sk/64)); loops over query tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, Geometry g) {
  extern __shared__ float smem[];
  const BwdTiles t = carve<D>(smem);
  const int bh = blockIdx.x, b = bh / g.H, h = bh % g.H;
  const int k0 = blockIdx.y * kTile;
  const int64_t qo = (int64_t)bh * g.Sq, ko = (int64_t)bh * g.Sk;
  load_tile<T, D>(k + ko * D, k0, g.Sk, t.sK, kv_stride(D));
  load_tile<T, D>(v + ko * D, k0, g.Sk, t.sV, kv_stride(D));
  float acc_k[kMicro][D / 16], acc_v[kMicro][D / 16];
#pragma unroll
  for (int a = 0; a < kMicro; ++a)
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc_k[a][e] = acc_v[a][e] = 0.f;
  const int n_qt = (g.Sq + kTile - 1) / kTile;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    // skip query tiles whose every row sits above this key tile's diagonal
    if (g.causal && min(q0 + kTile - 1, g.Sq - 1) + (g.Sk - g.Sq) < k0)
      continue;  // block-uniform
    __syncthreads();
    load_tile<T, D>(q + qo * D, q0, g.Sq, t.sQ, q_stride(D));
    load_tile<T, D>(dout + qo * D, q0, g.Sq, t.sDO, q_stride(D));
    load_vec(lse + qo, q0, g.Sq, t.sLse);
    load_vec(delta + qo, q0, g.Sq, t.sDelta);
    __syncthreads();
    recompute_p_ds<D>(t, q0, k0, b, h, g, true);
    __syncthreads();
    accumulate<D, true>(t.sP, p_stride(), t.sDO, q_stride(D), acc_v);
    accumulate<D, true>(t.sDS, p_stride(), t.sQ, q_stride(D), acc_k);
  }
  store_rows<T, D>(dk + ko * D, k0, g.Sk, acc_k);
  store_rows<T, D>(dv + ko * D, k0, g.Sk, acc_v);
}

// K6b: dq. Replaces the dq pallas_call of _flash_bwd
// (_flash_bwd_dq_kernel, grid (BH, nq, nk)). Bound on an H100 at
// (48, 12, 512, 64) bf16: 0.059 ms, by operations (three S^2 D products).
// It recomputes p and ds rather than sharing them with K6a through memory
// (the reference's split), trading one more q.k and do.v product for no
// S^2 scratch and no atomics.
// Grid (B*H, ceil(Sq/64)); loops over key tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        Geometry g) {
  extern __shared__ float smem[];
  const BwdTiles t = carve<D>(smem);
  const int bh = blockIdx.x, b = bh / g.H, h = bh % g.H;
  const int q0 = blockIdx.y * kTile;
  const int64_t qo = (int64_t)bh * g.Sq, ko = (int64_t)bh * g.Sk;
  load_tile<T, D>(q + qo * D, q0, g.Sq, t.sQ, q_stride(D));
  load_tile<T, D>(dout + qo * D, q0, g.Sq, t.sDO, q_stride(D));
  load_vec(lse + qo, q0, g.Sq, t.sLse);
  load_vec(delta + qo, q0, g.Sq, t.sDelta);
  float acc[kMicro][D / 16];
#pragma unroll
  for (int a = 0; a < kMicro; ++a)
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc[a][e] = 0.f;
  const int n_kt = key_tiles(q0, g);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(k + ko * D, k0, g.Sk, t.sK, kv_stride(D));
    load_tile<T, D>(v + ko * D, k0, g.Sk, t.sV, kv_stride(D));
    __syncthreads();
    recompute_p_ds<D>(t, q0, k0, b, h, g, false);
    __syncthreads();
    accumulate<D, false>(t.sDS, p_stride(), t.sK, kv_stride(D), acc);
  }
  store_rows<T, D>(dq + qo * D, q0, g.Sq, acc);
}

// ===========================================================================
// Tensor-core instances for bf16 (K5, K6a, K6b): wgmma fed by TMA
// ===========================================================================
// One consumer warpgroup (128 threads) per block owns 64 rows: query rows
// in the forward and the dq backward, key rows in the dk/dv backward.
// Tiles live in shared memory as bf16, written by TMA (cp.async.bulk.tensor,
// one elected thread, completion on an mbarrier per stage) in 2- or
// 3-stage rings, so tile j+1 lands while tile j computes. A tile of R rows
// is stored as TMA
// writes it with the swizzle of its row: D = 32 rows of 64 B (64B
// swizzle), D = 64 rows of 128 B (128B swizzle), D = 128 two 64-column
// halves of R rows of 128 B each (128B swizzle). The wgmma descriptors
// below describe exactly that layout, K-major (D contiguous) when the
// tile is the reduction-over-D operand and MN-major when it is the
// reduction-over-rows operand (bf16 wgmma transposes B through the
// descriptor). The tensor maps are 3-D (D, S, B*H), so rows past S in a
// head read as zeros and never as the next head's rows.

constexpr int kWgThreads = 128;     // one warpgroup
constexpr int kWgRows = 64;         // wgmma M
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Rows [row, row + box rows) x columns [col, col + box columns) of head
// `bh` of a (B*H, S, D) tensor into shared memory at dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(bh)
      : "memory");
}

// Shared-memory bytes of one stored row, and its descriptor layout type
// (1 = 128B swizzle, 2 = 64B swizzle).
template <int D>
__host__ __device__ constexpr uint32_t row_bytes() {
  return D == 32 ? 64 : 128;
}
template <int D>
__host__ __device__ constexpr uint64_t layout_type() {
  return D == 32 ? 2 : 1;
}

// A tile of `rows` rows: one TMA box per 64 columns.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int bh,
                                         int rows) {
#pragma unroll
  for (int half = 0; half < (D + 63) / 64; ++half)
    tma_load(dst + half * rows * 128, map, bar, half * 64, row, bh);
}

__device__ __forceinline__ uint64_t desc_field(uint32_t bytes) {
  return (uint64_t)((bytes & 0x3FFFF) >> 4);
}

// wgmma descriptor of k-slice kk (16 columns of D) of a tile of `rows`
// rows, K-major: 32 bytes along a swizzled row, the second 64-column half
// at rows * 128 bytes; 8-row groups SBO = 8 rows apart; LBO unused (1).
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows,
                                                int kk) {
  const uint32_t addr = tile + (kk / 4) * rows * 128 + (kk % 4) * 32;
  return desc_field(addr) | (desc_field(16) << 16) |
         (desc_field(8 * row_bytes<D>()) << 32) | (layout_type<D>() << 62);
}

// wgmma descriptor of rows [16 kk, 16 kk + 16) of a tile of `rows` rows,
// MN-major (the rows are the reduction axis, D the output columns): 8-row
// groups SBO = 8 rows apart, 64-column halves LBO = rows * 128 apart.
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int rows,
                                                 int kk) {
  const uint32_t addr = tile + kk * 16 * row_bytes<D>();
  return desc_field(addr) | (desc_field(rows * 128) << 16) |
         (desc_field(8 * row_bytes<D>()) << 32) | (layout_type<D>() << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin accumulator registers in place around an asynchronous wgmma, so
// that the compiler moves none of them between issue and wait.
template <int K>
__device__ __forceinline__ void fence_regs(float (&d)[K]) {
#pragma unroll
  for (int e = 0; e < K; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// d (+)= A B^T, m64nNk16, bf16 operands in shared memory, both K-major;
// scale_d = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d);
// d += A B, m64nNk16, A a register fragment of packed bf16x2, B in
// shared memory MN-major.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);

// The accumulator operands d[i .. i + 7] of an inline wgmma.
#define PTT_ACC8(i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : PTT_ACC8(0), PTT_ACC8(8)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : PTT_ACC8(0), PTT_ACC8(8), PTT_ACC8(16), PTT_ACC8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : PTT_ACC8(0), PTT_ACC8(8), PTT_ACC8(16), PTT_ACC8(24),
        PTT_ACC8(32), PTT_ACC8(40), PTT_ACC8(48), PTT_ACC8(56)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : PTT_ACC8(0), PTT_ACC8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : PTT_ACC8(0), PTT_ACC8(8), PTT_ACC8(16), PTT_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : PTT_ACC8(0), PTT_ACC8(8), PTT_ACC8(16), PTT_ACC8(24),
        PTT_ACC8(32), PTT_ACC8(40), PTT_ACC8(48), PTT_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef PTT_ACC8

// An m64nNk16 fp32 accumulator holds, in thread t of the warpgroup
// (warp w, lane l), d[4 j + 2 i + c] = element (16 w + l / 4 + 8 i,
// 8 j + 2 (l % 4) + c). For k-slice kk of a product whose reduction axis
// is that accumulator's columns, the bf16 A fragment is the same
// elements: a[r] = (d[8 kk + 2 r], d[8 kk + 2 r + 1]) packed.
template <int N>
__device__ __forceinline__ void to_a_fragments(const float (&d)[N / 2],
                                               uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const __nv_bfloat162 h =
          __floats2bfloat162_rn(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
      a[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
    }
}

// 2^x on the special-function unit, denormal results flushed to zero
// (exp2f adds a denormal fix-up around the same instruction); 2^0 = 1.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The part of a score that depends only on the key: NEG_INF past Sk, else
// a key-padding bias (query stride 0) or 0. A full bias is added per
// element by the caller. Adding NEG_INF to a finite score gives NEG_INF in
// fp32, as the reference's mask does.
__device__ __forceinline__ float key_term(int key, int b, int h,
                                          const Geometry& g) {
  if (key >= g.Sk) return kNegInf;
  if (g.bias != nullptr && g.sq == 0)
    return g.bias[b * g.sb + h * g.sh + key * g.sk];
  return 0.f;
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Write a 64 x D fp32 fragment (rows 16 w + l / 4 + 8 i) as bf16 into a
// shared staging tile of row stride D + 8 (conflict-free for the quads).
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* s,
                                           const float (&v)[D / 2]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * w + (lane >> 2) + 8 * i;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(s + r * (D + 8) + 8 * j +
                                         2 * (lane & 3)) =
          __floats2bfloat162_rn(v[4 * j + 2 * i], v[4 * j + 2 * i + 1]);
  }
}

// 16-byte stores of the staged rows [row0, row0 + 64) that are < n_rows.
template <int D>
__device__ __forceinline__ void store_staged(__nv_bfloat16* __restrict__ g,
                                             int row0, int n_rows,
                                             const __nv_bfloat16* s) {
  for (int idx = threadIdx.x; idx < kWgRows * D / 8; idx += kWgThreads) {
    const int r = idx / (D / 8), c = idx % (D / 8);
    if (row0 + r < n_rows)
      *reinterpret_cast<uint4*>(g + (int64_t)(row0 + r) * D + 8 * c) =
          *reinterpret_cast<const uint4*>(s + r * (D + 8) + 8 * c);
  }
}

// ---------------------------------------------------------------------------
// K5, bf16: forward on the tensor cores. Replaces _flash_fwd /
// _flash_fwd_kernel (paddle_tpu/ops/attention.py:239). Bound at
// (48, 12, 512, 64) with a key bias: 0.045 ms, by bytes.
// Per 64-row query tile: Q once by TMA; K and V tiles of N = 128 keys (64
// for D = 128) by TMA into 2-stage rings with a barrier each; S = Q K^T
// with wgmma SS (both K-major) into fp32 registers; scale, bias and masks
// on the accumulator fragment; the online max with 4-lane shuffles (row
// sums stay per thread until the end, the rescale factor being the
// row's); P rounded to bf16 is the register A operand of O += P V (wgmma
// RS, V MN-major). S of tile j and P V of tile j - 1 are issued together
// (FlashAttention-3's intra-warpgroup overlap): the softmax of tile j
// waits only for S and runs while P V is on the tensor cores, and O is
// rescaled once P V lands. K of tile j + 1 and V of tile j load during
// iteration j (V of tile j - 1 is still being read then). The
// key-padding bias of the next tile is staged in shared memory beside its
// load; a full bias is read per element through its strides, and it and
// the causal mask are checked only in the kChecks instance, which a call
// gets when it has either (the checks cost the main path much of its
// speed even when they never fire).
// Out goes through shared memory to 16-byte stores; lse = m + log(l) in
// fp32. Left for later: a producer warp with setmaxnreg, two consumer
// warpgroups in ping-pong, a persistent grid.
// ---------------------------------------------------------------------------
template <int D>
__host__ __device__ constexpr int fwd_keys() {
  return D <= 64 ? 128 : 64;
}

template <int D>
constexpr size_t fwd_tc_smem() {
  return 1024 + kWgRows * D * 2 + 4 * fwd_keys<D>() * D * 2 +
         2 * fwd_keys<D>() * sizeof(float) + 5 * sizeof(uint64_t);
}

__device__ __forceinline__ void wgmma_wait_1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int e = 0; e < K; ++e)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[e][r])::"memory");
}

// Softmax state of the two rows a thread holds, and one key tile's update
// of it: s holds the raw scores q.k of the tile on entry and p on exit;
// returns through alpha the factor that rescales the rows' O.
template <int N, bool kChecks>
__device__ __forceinline__ void online_softmax(float (&s)[N / 2],
                                               const float* col_term, int k0,
                                               const int (&row)[2],
                                               const float* const* brow,
                                               const Geometry& g,
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2]) {
  const int lane = threadIdx.x & 31;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    const float2 ct = *reinterpret_cast<const float2*>(col_term + c);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // the reference's masked_score order: scale, bias, masks
        float x = s[4 * j + 2 * i + e] * g.scale + (e ? ct.y : ct.x);
        if (kChecks) {
          const int col = k0 + c + e;
          if (brow[i] != nullptr && col < g.Sk) x += brow[i][col * g.sk];
          if (g.causal && col > row[i] + (g.Sk - g.Sq)) x = kNegInf;
        }
        s[4 * j + 2 * i + e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_next = fmaxf(m[i], quad_max(mx[i]));
    // a row with every key masked so far keeps m = NEG_INF: s - m = 0
    // gives p = 1, and the row is zeroed at the end (alive = false)
    alpha[i] = ex2((m[i] - m_next) * kLog2e);
    m[i] = m_next;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ex2((s[4 * j + 2 * i + e] - m[i]) * kLog2e);
        l[i] += p;
        s[4 * j + 2 * i + e] = p;
      }
}

template <int D>
__device__ __forceinline__ void rescale_rows(float (&o)[D / 2],
                                             const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      o[4 * j + 2 * i] *= alpha[i];
      o[4 * j + 2 * i + 1] *= alpha[i];
    }
}

template <int D, bool kChecks>
__global__ void __launch_bounds__(kWgThreads)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ lse, Geometry g, int n_qt) {
  constexpr int N = fwd_keys<D>();
  constexpr uint32_t QB = kWgRows * D * 2, KB = N * D * 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t sQ = smem_u32(smem), sK = sQ + QB, sV = sK + 2 * KB;
  float* sCol = reinterpret_cast<float*>(smem + QB + 4 * KB);     // [2][N]
  // barriers: K full [2], V full [2], Q
  const uint32_t bar_k = smem_u32(sCol + 2 * N), bar_v = bar_k + 16,
                 bar_q = bar_k + 32;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int bh = blockIdx.x / n_qt, b = bh / g.H, h = bh % g.H;
  // a head's last query tiles first: under a causal mask they visit the
  // most key tiles, so the longest blocks start in the first wave
  const int q0 = (n_qt - 1 - blockIdx.x % n_qt) * kWgRows;
  const int n_kt = key_tiles(q0, g, N);
  auto load_k = [&](int kt) {
    const uint32_t full = bar_k + 8 * (kt & 1);
    mbar_expect_tx(full, KB);
    tma_tile<D>(sK + (kt & 1) * KB, &map_k, full, kt * N, bh, N);
  };
  auto load_v = [&](int kt) {
    const uint32_t full = bar_v + 8 * (kt & 1);
    mbar_expect_tx(full, KB);
    tma_tile<D>(sV + (kt & 1) * KB, &map_v, full, kt * N, bh, N);
  };
  auto stage_cols = [&](int kt) {
    if (tid < N) sCol[(kt & 1) * N + tid] = key_term(kt * N + tid, b, h, g);
  };

  if (tid == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(bar_k + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, QB);
    tma_tile<D>(sQ, &map_q, bar_q, q0, bh, kWgRows);
    if (n_kt > 0) {
      load_k(0);
      load_v(0);
    }
    if (n_kt > 1) load_k(1);
  }
  if (n_kt > 0) stage_cols(0);
  if (n_kt > 1) stage_cols(1);

  int row[2];
  const float* brow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + 16 * w + (lane >> 2) + 8 * i;
    brow[i] = kChecks && g.bias != nullptr && g.sq != 0 && row[i] < g.Sq
                  ? g.bias + b * g.sb + h * g.sh + row[i] * g.sq
                  : nullptr;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  float o[D / 2], s[N / 2];
  uint32_t pa[N / 16][4];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
#pragma unroll
  for (int e = 0; e < N / 2; ++e) s[e] = 0.f;
  mbar_wait(bar_q, 0);
  __syncthreads();   // the column terms of tiles 0 and 1 are staged

  if (n_kt > 0) {
    mbar_wait(bar_k, 0);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<N>(s, kmajor_desc<D>(sQ, kWgRows, kk),
                  kmajor_desc<D>(sK, N, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    online_softmax<N, kChecks>(s, sCol, 0, row, brow, g, m, l, alpha);
    to_a_fragments<N>(s, pa);
  }
  for (int kt = 1; kt < n_kt; ++kt) {
    const int st = kt & 1;
    // every warp is done with S of tile kt - 1 (K stage st ^ 1, column
    // terms buffer st ^ 1) and P V of tile kt - 2 (V stage st)
    __syncthreads();
    if (tid == 0) {
      if (kt + 1 < n_kt) load_k(kt + 1);
      load_v(kt);
    }
    if (kt + 1 < n_kt) stage_cols(kt + 1);
    mbar_wait(bar_k + 8 * st, (kt >> 1) & 1);
    mbar_wait(bar_v + 8 * (st ^ 1), ((kt - 1) >> 1) & 1);
    fence_regs(s);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<N>(s, kmajor_desc<D>(sQ, kWgRows, kk),
                  kmajor_desc<D>(sK + st * KB, N, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_rs<D>(o, pa[kk], mnmajor_desc<D>(sV + (st ^ 1) * KB, N, kk));
    wgmma_commit();
    wgmma_wait_1();    // S of tile kt has landed; P V of kt - 1 runs on
    fence_regs(s);
    online_softmax<N, kChecks>(s, sCol + st * N, kt * N, row, brow, g, m, l,
                               alpha);
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pa);
    rescale_rows<D>(o, alpha);
    to_a_fragments<N>(s, pa);
  }
  if (n_kt > 0) {
    const int last = n_kt - 1;
    mbar_wait(bar_v + 8 * (last & 1), (last >> 1) & 1);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_rs<D>(o, pa[kk], mnmajor_desc<D>(sV + (last & 1) * KB, N, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pa);
  }

  // finish: rows whose every key is masked keep m ~ NEG_INF; they emit 0
  // (not a uniform mean of v) and lse = m + log(l) ~ NEG_INF
  __syncthreads();   // every wgmma read is done: the ring becomes staging
  __nv_bfloat16* staged = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = quad_sum(l[i]);
    const float denom = li == 0.f ? 1.f : li;
    const bool alive = m[i] > kNegInf / 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        o[4 * j + 2 * i + e] = alive ? o[4 * j + 2 * i + e] / denom : 0.f;
    if ((lane & 3) == 0 && row[i] < g.Sq)
      lse[(int64_t)bh * g.Sq + row[i]] = m[i] + logf(denom);
  }
  stage_rows<D>(staged, o);
  __syncthreads();
  store_staged<D>(out + (int64_t)bh * g.Sq * D, q0, g.Sq, staged);
}

// ---------------------------------------------------------------------------
// K6a, bf16: dk, dv on the tensor cores (the FlashAttention-3 form).
// Replaces the dk/dv pallas_call of _flash_bwd (paddle_tpu/ops/
// attention.py:478, call at :525). Bound at (48, 12, 512, 64): 0.078 ms,
// by operations. A block owns 64 key rows (K and V loaded once by TMA)
// and loops over query tiles (64 rows; 32 for D = 128, to keep the
// accumulators in registers), Q and dO by TMA in a 2-stage ring, lse and
// delta of the next tile staged in shared memory beside it. The products
// are computed transposed, so that P^T and dS^T come out in the register
// A-fragment layout of the second products:
//   S^T = K Q^T, dP^T = V dO^T          wgmma SS, all K-major
//   P^T = exp(S^T scale + bias - lse), dS^T = P^T (dP^T - delta) scale
//   dV += P^T dO, dK += dS^T Q          wgmma RS, dO and Q MN-major
// dK and dV stay in fp32 registers over all query tiles and are written
// once per key tile through shared memory: no atomics, so results are
// bitwise reproducible. As in K5, the element loop checks a full bias and
// the causal mask only in the kChecks instance. Left for later: a
// producer warp, two consumer warpgroups, and overlapping the two product
// pairs across tiles.
// ---------------------------------------------------------------------------
template <int D>
__host__ __device__ constexpr int bwd_queries() {
  return D <= 64 ? 64 : 32;
}

template <int D>
constexpr size_t dkv_tc_smem() {
  return 1024 + 2 * kWgRows * D * 2 + 4 * bwd_queries<D>() * D * 2 +
         4 * bwd_queries<D>() * sizeof(float) + 3 * sizeof(uint64_t);
}

template <int D, bool kChecks>
__global__ void __launch_bounds__(kWgThreads)
    flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_do,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, Geometry g,
                            int n_kt) {
  constexpr int NQ = bwd_queries<D>();
  constexpr uint32_t KB = kWgRows * D * 2, QB = NQ * D * 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t sK = smem_u32(smem), sV = sK + KB;
  const uint32_t sQ = sV + KB, sDO = sQ + 2 * QB;   // stage s at + s * QB
  float* sLse = reinterpret_cast<float*>(smem + 2 * KB + 4 * QB);  // [2][NQ]
  float* sDelta = sLse + 2 * NQ;                                   // [2][NQ]
  const uint32_t bar = smem_u32(sDelta + 2 * NQ);  // full[0], full[1], kv
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int bh = blockIdx.x / n_kt, b = bh / g.H, h = bh % g.H;
  const int k0 = (blockIdx.x % n_kt) * kWgRows;
  const int64_t qo = (int64_t)bh * g.Sq;
  const int n_qt = (g.Sq + NQ - 1) / NQ;
  // skip query tiles whose every row sits above this key tile's diagonal
  int qt0 = 0;
  if (g.causal)
    while (qt0 < n_qt && min(qt0 * NQ + NQ - 1, g.Sq - 1) + (g.Sk - g.Sq) < k0)
      ++qt0;
  const bool full_bias = kChecks && g.bias != nullptr && g.sq != 0;

  // lse and delta of query tile qt into buffer `buf`; padded query rows
  // get lse = NEG_INF, so their p is 0 as in the reference
  auto stage_rows_fp32 = [&](int qt, int buf) {
    const int r = tid & (NQ - 1), q = qt * NQ + r;
    if (tid < NQ)
      sLse[buf * NQ + r] = q < g.Sq ? lse[qo + q] : kNegInf;
    else if (tid < 2 * NQ)
      sDelta[buf * NQ + r] = q < g.Sq ? delta[qo + q] : 0.f;
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar + 16, 2 * KB);
    tma_tile<D>(sK, &map_k, bar + 16, k0, bh, kWgRows);
    tma_tile<D>(sV, &map_v, bar + 16, k0, bh, kWgRows);
    if (qt0 < n_qt) {
      mbar_expect_tx(bar, 2 * QB);
      tma_tile<D>(sQ, &map_q, bar, qt0 * NQ, bh, NQ);
      tma_tile<D>(sDO, &map_do, bar, qt0 * NQ, bh, NQ);
    }
  }
  if (qt0 < n_qt) stage_rows_fp32(qt0, 0);

  int key[2];
  float kterm[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + 16 * w + (lane >> 2) + 8 * i;
    kterm[i] = key_term(key[i], b, h, g);
  }
  float acc_k[D / 2], acc_v[D / 2], sT[NQ / 2], dpt[NQ / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc_k[e] = acc_v[e] = 0.f;
#pragma unroll
  for (int e = 0; e < NQ / 2; ++e) sT[e] = dpt[e] = 0.f;
  mbar_wait(bar + 16, 0);

  for (int qt = qt0, it = 0; qt < n_qt; ++qt, ++it) {
    const int stg = it & 1, q0 = qt * NQ;
    __syncthreads();   // stage stg ^ 1 (the previous tile) is no longer read
    if (qt + 1 < n_qt) {
      if (tid == 0) {
        const uint32_t full = bar + 8 * (stg ^ 1);
        mbar_expect_tx(full, 2 * QB);
        tma_tile<D>(sQ + (stg ^ 1) * QB, &map_q, full, q0 + NQ, bh, NQ);
        tma_tile<D>(sDO + (stg ^ 1) * QB, &map_do, full, q0 + NQ, bh, NQ);
      }
      stage_rows_fp32(qt + 1, stg ^ 1);
    }
    mbar_wait(bar + 8 * stg, (it >> 1) & 1);

    const uint32_t q_tile = sQ + stg * QB, do_tile = sDO + stg * QB;
    fence_regs(sT);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<NQ>(sT, kmajor_desc<D>(sK, kWgRows, kk),
                   kmajor_desc<D>(q_tile, NQ, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<NQ>(dpt, kmajor_desc<D>(sV, kWgRows, kk),
                   kmajor_desc<D>(do_tile, NQ, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sT);
    fence_regs(dpt);

    // p and ds, transposed: rows are keys, columns queries
    const float* lse_t = sLse + stg * NQ;
    const float* delta_t = sDelta + stg * NQ;
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
      const float2 d2 = *reinterpret_cast<const float2*>(delta_t + c);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * i + e, q = q0 + c + e;
          const float lse_q = e ? l2.y : l2.x;
          float x = sT[idx] * g.scale + kterm[i];
          if (kChecks) {
            if (full_bias && q < g.Sq && key[i] < g.Sk)
              x += g.bias[b * g.sb + h * g.sh + q * g.sq + key[i] * g.sk];
            if (g.causal && key[i] > q + (g.Sk - g.Sq)) x = kNegInf;
          }
          // fully masked query rows (lse ~ NEG_INF) and padded ones: 0
          const float p =
              lse_q > kNegInf / 2 ? ex2((x - lse_q) * kLog2e) : 0.f;
          sT[idx] = p;
          dpt[idx] = p * (dpt[idx] - (e ? d2.y : d2.x)) * g.scale;
        }
    }
    uint32_t pa[NQ / 16][4], da[NQ / 16][4];
    to_a_fragments<NQ>(sT, pa);
    to_a_fragments<NQ>(dpt, da);
    fence_regs(acc_k);
    fence_regs(acc_v);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NQ / 16; ++kk)
      wgmma_rs<D>(acc_v, pa[kk], mnmajor_desc<D>(do_tile, NQ, kk));
#pragma unroll
    for (int kk = 0; kk < NQ / 16; ++kk)
      wgmma_rs<D>(acc_k, da[kk], mnmajor_desc<D>(q_tile, NQ, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_k);
    fence_regs(acc_v);
  }

  __syncthreads();   // every wgmma read is done: the tiles become staging
  __nv_bfloat16* staged_k = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* staged_v = staged_k + kWgRows * (D + 8);
  stage_rows<D>(staged_k, acc_k);
  stage_rows<D>(staged_v, acc_v);
  __syncthreads();
  const int64_t ko = (int64_t)bh * g.Sk * D;
  store_staged<D>(dk + ko, k0, g.Sk, staged_k);
  store_staged<D>(dv + ko, k0, g.Sk, staged_v);
}

// ---------------------------------------------------------------------------
// K6b, bf16: dq on the tensor cores. Replaces the dq pallas_call of
// _flash_bwd (paddle_tpu/ops/attention.py:478, call at :556, body
// _flash_bwd_dq_kernel :430). Bound at (48, 12, 512, 64): 0.059 ms, by
// operations. A block owns 64 query rows (Q and dO loaded once by TMA; lse
// and delta of a thread's two rows in registers) and loops over key tiles
// of 64, K by TMA into a 3-stage ring and V into a 2-stage one, the key
// terms of the next tile staged in shared memory beside them:
//   S = Q K^T, dP = dO V^T          wgmma SS, all K-major
//   P = exp(S scale + bias - lse), zero on padded and fully masked rows
//   (lse <= NEG_INF / 2, _recompute_p); dS = P (dP - delta) scale
//   dQ += dS K                      wgmma RS: dS packed to bf16 is the
//                                   register A operand (as P is in K5), K
//                                   the MN-major B operand (as V is in K5)
// S and dP of tile j are issued together with dQ += dS K of tile j - 1,
// and the element loop waits only for S and dP, so it runs while the
// previous tile's dQ product is on the tensor cores. K of tile j - 1 is
// still being read then, hence K's third stage: K and V of tile j + 1 load
// during iteration j. dQ stays in fp32 registers over all key tiles and is
// written once through shared memory: no atomics, so results are bitwise
// reproducible. As in K5 and K6a, a full bias and the causal mask are
// checked only in the kChecks instance.
// ---------------------------------------------------------------------------
constexpr int kDqKeys = 64;   // keys per tile

template <int D>
constexpr size_t dq_tc_smem() {
  return 1024 + 2 * kWgRows * D * 2 + 5 * kDqKeys * D * 2 +
         2 * kDqKeys * sizeof(float) + 6 * sizeof(uint64_t);
}

template <int D, bool kChecks>
__global__ void __launch_bounds__(kWgThreads)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dq, Geometry g,
                           int n_qt) {
  constexpr int N = kDqKeys;
  constexpr uint32_t QB = kWgRows * D * 2, KB = N * D * 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t sQ = smem_u32(smem), sDO = sQ + QB, sK = sDO + QB,
                 sV = sK + 3 * KB;
  float* sCol = reinterpret_cast<float*>(smem + 2 * QB + 5 * KB);  // [2][N]
  // barriers: K full [3], V full [2], Q and dO
  const uint32_t bar_k = smem_u32(sCol + 2 * N), bar_v = bar_k + 24,
                 bar_q = bar_k + 40;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int bh = blockIdx.x / n_qt, b = bh / g.H, h = bh % g.H;
  // a head's last query tiles first, as in K5
  const int q0 = (n_qt - 1 - blockIdx.x % n_qt) * kWgRows;
  const int n_kt = key_tiles(q0, g, N);
  auto load_kv = [&](int kt) {
    const uint32_t full_k = bar_k + 8 * (kt % 3), full_v = bar_v + 8 * (kt & 1);
    mbar_expect_tx(full_k, KB);
    tma_tile<D>(sK + (kt % 3) * KB, &map_k, full_k, kt * N, bh, N);
    mbar_expect_tx(full_v, KB);
    tma_tile<D>(sV + (kt & 1) * KB, &map_v, full_v, kt * N, bh, N);
  };
  auto stage_cols = [&](int kt) {
    if (tid < N) sCol[(kt & 1) * N + tid] = key_term(kt * N + tid, b, h, g);
  };

  if (tid == 0) {
    for (int i = 0; i < 6; ++i) mbar_init(bar_k + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * QB);
    tma_tile<D>(sQ, &map_q, bar_q, q0, bh, kWgRows);
    tma_tile<D>(sDO, &map_do, bar_q, q0, bh, kWgRows);
    for (int kt = 0; kt < min(n_kt, 2); ++kt) load_kv(kt);
  }
  for (int kt = 0; kt < min(n_kt, 2); ++kt) stage_cols(kt);

  int row[2];
  const float* brow[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + 16 * w + (lane >> 2) + 8 * i;
    const bool in = row[i] < g.Sq;
    brow[i] = kChecks && g.bias != nullptr && g.sq != 0 && in
                  ? g.bias + b * g.sb + h * g.sh + row[i] * g.sq
                  : nullptr;
    // a padded row gets lse = NEG_INF, so its p is 0 as in the reference
    lse_r[i] = in ? lse[(int64_t)bh * g.Sq + row[i]] : kNegInf;
    delta_r[i] = in ? delta[(int64_t)bh * g.Sq + row[i]] : 0.f;
  }
  float acc[D / 2], s[N / 2], dp[N / 2];
  uint32_t da[N / 16][4];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < N / 2; ++e) s[e] = dp[e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) da[kk][r] = 0u;
  mbar_wait(bar_q, 0);
  __syncthreads();   // the key terms of tiles 0 and 1 are staged

  for (int kt = 0; kt < n_kt; ++kt) {
    const int sk = kt % 3, sv = kt & 1;
    if (kt > 0) {
      // every warp is done with S and dP of tile kt - 1 (V stage and key
      // terms buffer (kt + 1) & 1) and dQ of tile kt - 2 (K stage
      // (kt + 1) % 3)
      __syncthreads();
      if (kt + 1 < n_kt) {
        if (tid == 0) load_kv(kt + 1);
        stage_cols(kt + 1);
      }
    }
    mbar_wait(bar_k + 8 * sk, (kt / 3) & 1);
    mbar_wait(bar_v + 8 * sv, (kt >> 1) & 1);
    fence_regs(s);
    fence_regs(dp);
    fence_regs(acc);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<N>(s, kmajor_desc<D>(sQ, kWgRows, kk),
                  kmajor_desc<D>(sK + sk * KB, N, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<N>(dp, kmajor_desc<D>(sDO, kWgRows, kk),
                  kmajor_desc<D>(sV + sv * KB, N, kk), kk > 0);
    wgmma_commit();
    if (kt > 0) {
      const uint32_t k_prev = sK + ((kt + 2) % 3) * KB;   // K of tile kt - 1
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        wgmma_rs<D>(acc, da[kk], mnmajor_desc<D>(k_prev, N, kk));
      wgmma_commit();
      wgmma_wait_1();  // S and dP of tile kt have landed; dS K of kt - 1 runs
    } else {
      wgmma_wait_all();
    }
    fence_regs(s);
    fence_regs(dp);

    // p and ds: rows are queries, columns keys
    const float* col_term = sCol + (kt & 1) * N;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const float2 ct = *reinterpret_cast<const float2*>(col_term + c);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * i + e;
          // the reference's masked_score order: scale, bias, masks
          float x = s[idx] * g.scale + (e ? ct.y : ct.x);
          if (kChecks) {
            const int col = kt * N + c + e;
            if (brow[i] != nullptr && col < g.Sk) x += brow[i][col * g.sk];
            if (g.causal && col > row[i] + (g.Sk - g.Sq)) x = kNegInf;
          }
          const float p =
              lse_r[i] > kNegInf / 2 ? ex2((x - lse_r[i]) * kLog2e) : 0.f;
          dp[idx] = p * (dp[idx] - delta_r[i]) * g.scale;
        }
    }
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(da);
    to_a_fragments<N>(dp, da);
  }
  if (n_kt > 0) {
    const uint32_t k_last = sK + ((n_kt - 1) % 3) * KB;
    fence_regs(acc);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_rs<D>(acc, da[kk], mnmajor_desc<D>(k_last, N, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }

  __syncthreads();   // every wgmma read is done: Q and dO become staging
  __nv_bfloat16* staged = reinterpret_cast<__nv_bfloat16*>(smem);
  stage_rows<D>(staged, acc);
  __syncthreads();
  store_staged<D>(dq + (int64_t)bh * g.Sq * D, q0, g.Sq, staged);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}


// cuTensorMapEncodeTiled is a driver API function; the library links only
// the runtime, so it is looked up once through the runtime's versioned
// entry-point query.
static_assert(CUDART_VERSION >= 12050,
              "cudaGetDriverEntryPointByVersion needs CUDA 12.5 or newer");
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A (B*H, S, D) bf16 tensor as a 3-D tensor map (D, S, B*H) with boxes of
// `rows` rows by min(D, 64) columns and the swizzle of the tile layout;
// rows past S read as zeros.
cudaError_t tensor_map(CUtensorMap* map, const void* base, int BH, int S,
                       int D, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)(D < 64 ? D : 64), (cuuint32_t)rows,
                             1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One block per (head, 64-row tile), the tiles of a head adjacent in the
// launch order so that they share its K/V (or Q/dO) through L2.
inline bool grid_fits(int BH, int tiles) {
  return (int64_t)BH * tiles <= 0x7fffffff;
}

template <int D>
cudaError_t run_fwd_tc(const void* q, const void* k, const void* v,
                       void* out, float* lse, int BH, const Geometry& g,
                       cudaStream_t st) {
  const int n_qt = (g.Sq + kWgRows - 1) / kWgRows;
  if (!grid_fits(BH, n_qt)) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  cudaError_t e;
  if ((e = tensor_map(&mq, q, BH, g.Sq, D, kWgRows)) != cudaSuccess ||
      (e = tensor_map(&mk, k, BH, g.Sk, D, fwd_keys<D>())) != cudaSuccess ||
      (e = tensor_map(&mv, v, BH, g.Sk, D, fwd_keys<D>())) != cudaSuccess)
    return e;
  // the element loop checks a full bias and the causal mask only when the
  // call has either
  auto kern = g.causal || (g.bias != nullptr && g.sq != 0)
                  ? flash_fwd_tc_kernel<D, true>
                  : flash_fwd_tc_kernel<D, false>;
  constexpr size_t smem = fwd_tc_smem<D>();
  if ((e = allow_smem(kern, smem)) != cudaSuccess) return e;
  kern<<<BH * n_qt, kWgThreads, smem, st>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), lse, g, n_qt);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_dkv_tc(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int BH, const Geometry& g,
                       cudaStream_t st) {
  const int n_kt = (g.Sk + kWgRows - 1) / kWgRows;
  if (!grid_fits(BH, n_kt)) return cudaErrorInvalidValue;
  constexpr int NQ = bwd_queries<D>();
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e;
  if ((e = tensor_map(&mq, q, BH, g.Sq, D, NQ)) != cudaSuccess ||
      (e = tensor_map(&mk, k, BH, g.Sk, D, kWgRows)) != cudaSuccess ||
      (e = tensor_map(&mv, v, BH, g.Sk, D, kWgRows)) != cudaSuccess ||
      (e = tensor_map(&mdo, dout, BH, g.Sq, D, NQ)) != cudaSuccess)
    return e;
  auto kern = g.causal || (g.bias != nullptr && g.sq != 0)
                  ? flash_bwd_dkv_tc_kernel<D, true>
                  : flash_bwd_dkv_tc_kernel<D, false>;
  if ((e = allow_smem(kern, dkv_tc_smem<D>())) != cudaSuccess) return e;
  kern<<<BH * n_kt, kWgThreads, dkv_tc_smem<D>(), st>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), g, n_kt);
  return cudaGetLastError();
}

// bf16 runs on the tensor cores; fp32 keeps the scalar kernels (the
// tensor cores have no full-fp32 mode, and TF32 would break the fp32
// contract of 2e-5).
template <typename T, int D>
cudaError_t run_fwd(const void* q, const void* k, const void* v, void* out,
                    float* lse, int BH, const Geometry& g, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return run_fwd_tc<D>(q, k, v, out, lse, BH, g, st);
  } else {
    auto kern = flash_fwd_kernel<T, D>;
    cudaError_t e = allow_smem(kern, fwd_smem<D>());
    if (e != cudaSuccess) return e;
    const dim3 grid(BH, (g.Sq + kTile - 1) / kTile);
    kern<<<grid, kThreads, fwd_smem<D>(), st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), lse, g);
    return cudaGetLastError();
  }
}

template <typename T, int D>
cudaError_t run_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int BH, const Geometry& g,
                    cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return run_dkv_tc<D>(q, k, v, dout, lse, delta, dk, dv, BH, g, st);
  } else {
    auto kern = flash_bwd_dkv_kernel<T, D>;
    cudaError_t e = allow_smem(kern, bwd_smem<D>());
    if (e != cudaSuccess) return e;
    const dim3 grid(BH, (g.Sk + kTile - 1) / kTile);
    kern<<<grid, kThreads, bwd_smem<D>(), st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), g);
    return cudaGetLastError();
  }
}

template <int D>
cudaError_t run_dq_tc(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int BH, const Geometry& g, cudaStream_t st) {
  const int n_qt = (g.Sq + kWgRows - 1) / kWgRows;
  if (!grid_fits(BH, n_qt)) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e;
  if ((e = tensor_map(&mq, q, BH, g.Sq, D, kWgRows)) != cudaSuccess ||
      (e = tensor_map(&mk, k, BH, g.Sk, D, kDqKeys)) != cudaSuccess ||
      (e = tensor_map(&mv, v, BH, g.Sk, D, kDqKeys)) != cudaSuccess ||
      (e = tensor_map(&mdo, dout, BH, g.Sq, D, kWgRows)) != cudaSuccess)
    return e;
  auto kern = g.causal || (g.bias != nullptr && g.sq != 0)
                  ? flash_bwd_dq_tc_kernel<D, true>
                  : flash_bwd_dq_tc_kernel<D, false>;
  if ((e = allow_smem(kern, dq_tc_smem<D>())) != cudaSuccess) return e;
  kern<<<BH * n_qt, kWgThreads, dq_tc_smem<D>(), st>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<__nv_bfloat16*>(dq), g, n_qt);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run_dq(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int BH, const Geometry& g, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return run_dq_tc<D>(q, k, v, dout, lse, delta, dq, BH, g, st);
  } else {
    auto kern = flash_bwd_dq_kernel<T, D>;
    cudaError_t e = allow_smem(kern, bwd_smem<D>());
    if (e != cudaSuccess) return e;
    const dim3 grid(BH, (g.Sq + kTile - 1) / kTile);
    kern<<<grid, kThreads, bwd_smem<D>(), st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dq), g);
    return cudaGetLastError();
  }
}

// D (head dim) and T (element type) are template parameters so that the
// micro-tiles and accumulators stay in registers.
#define PTT_FLASH_CASES(FN, ...)                                        \
  switch (dtype * 1000 + D) {                                           \
    case 32: return FN<float, 32>(__VA_ARGS__);                         \
    case 64: return FN<float, 64>(__VA_ARGS__);                         \
    case 128: return FN<float, 128>(__VA_ARGS__);                       \
    case 1032: return FN<__nv_bfloat16, 32>(__VA_ARGS__);               \
    case 1064: return FN<__nv_bfloat16, 64>(__VA_ARGS__);               \
    case 1128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);              \
    default: return cudaErrorInvalidValue;                              \
  }

bool bad_geometry(int B, int H, int Sq, int Sk, int D) {
  return B < 1 || H < 1 || Sq < 1 || Sk < 1 ||
         (D != 32 && D != 64 && D != 128) ||
         (Sq + kTile - 1) / kTile > 65535 || (Sk + kTile - 1) / kTile > 65535 ||
         (int64_t)B * H > 0x7fffffff;
}

Geometry make_geometry(int H, int Sq, int Sk, float scale, int causal,
                       const void* bias, long long sb, long long sh,
                       long long sq, long long sk) {
  Geometry g;
  g.H = H;
  g.Sq = Sq;
  g.Sk = Sk;
  g.scale = scale;
  g.causal = causal;
  g.bias = static_cast<const float*>(bias);
  g.sb = sb;
  g.sh = sh;
  g.sq = sq;
  g.sk = sk;
  return g;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, do and the gradients
// share it); bias (nullable), lse and delta are float32. bias strides are
// in elements over the (B, H, Sq, Sk) broadcast. Returns the cudaError_t
// of the launch (0 = success).
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             const void* bias, void* out, void* lse, int B,
                             int H, int Sq, int Sk, int D, int dtype,
                             float scale, int causal, long long sb,
                             long long sh, long long sq, long long sk,
                             void* stream) {
  if (bad_geometry(B, H, Sq, Sk, D)) return cudaErrorInvalidValue;
  const Geometry g = make_geometry(H, Sq, Sk, scale, causal, bias, sb, sh, sq, sk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  PTT_FLASH_CASES(run_fwd, q, k, v, out, l, B * H, g, s)
}

extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* bias, const void* dout,
                                 const void* lse, const void* delta, void* dk,
                                 void* dv, int B, int H, int Sq, int Sk, int D,
                                 int dtype, float scale, int causal,
                                 long long sb, long long sh, long long sq,
                                 long long sk, void* stream) {
  if (bad_geometry(B, H, Sq, Sk, D)) return cudaErrorInvalidValue;
  const Geometry g = make_geometry(H, Sq, Sk, scale, causal, bias, sb, sh, sq, sk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  PTT_FLASH_CASES(run_dkv, q, k, v, dout, l, dl, dk, dv, B * H, g, s)
}

extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* bias, const void* dout,
                                const void* lse, const void* delta, void* dq,
                                int B, int H, int Sq, int Sk, int D, int dtype,
                                float scale, int causal, long long sb,
                                long long sh, long long sq, long long sk,
                                void* stream) {
  if (bad_geometry(B, H, Sq, Sk, D)) return cudaErrorInvalidValue;
  const Geometry g = make_geometry(H, Sq, Sk, scale, causal, bias, sb, sh, sq, sk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  PTT_FLASH_CASES(run_dq, q, k, v, dout, l, dl, dq, B * H, g, s)
}
