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
// elements moved), the two backward kernels are operation-bound (8 and 6
// S^2 Dh flops). On the tensor cores that is tens of microseconds per call.
//
// Design (simple and right first; no tensor cores). The TPU kernels run a
// sequential grid axis that carries (m, l, acc) or (dk, dv) or dq in VMEM
// scratch; here that axis is a loop inside one block, so no state crosses
// blocks and no atomics are needed (gradients are bitwise reproducible).
// A block of 256 threads (16 x 16) owns a 64-row tile: the forward and dq
// one query tile (looping over key tiles), dk/dv one key tile (looping
// over query tiles). Tiles are staged in shared memory as fp32 (16-byte
// global loads; rows past the end read as zeros and are never loaded),
// each thread computes a 4 x 4 micro-tile of the 64 x 64 score block with
// scalar fp32 FMA, row reductions are 16-lane shuffles, and the score
// block goes through shared memory into the second product. Causal tiles
// wholly above the diagonal are skipped. K/V tiles have an odd row stride
// and Q/dO tiles a stride of D + 4, so the score loop reads shared memory
// without bank conflicts. fp32 stays fp32 throughout (no TF32), so the
// fp32 path meets the reference contract's 2e-5.
// What the simple design leaves on the table: the tensor cores (wgmma or
// mma.sync for bf16), TMA/cp.async prefetch of the next tile behind this
// tile's math, bf16 staging (it would double occupancy), and the
// exp2-with-folded-scale trick.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Number of key tiles a query tile starting at q0 must visit: all of them,
// or with `causal` those not wholly above the diagonal of its last row.
__device__ __forceinline__ int key_tiles(int q0, const Geometry& g) {
  const int n = (g.Sk + kTile - 1) / kTile;
  if (!g.causal) return n;
  const int last = min(q0 + kTile - 1, g.Sq - 1) + (g.Sk - g.Sq);
  if (last < 0) return 0;
  return min(n, last / kTile + 1);
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

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
cudaError_t run_fwd(const void* q, const void* k, const void* v, void* out,
                    float* lse, int BH, const Geometry& g, cudaStream_t st) {
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t e = allow_smem(kern, fwd_smem<D>());
  if (e != cudaSuccess) return e;
  const dim3 grid(BH, (g.Sq + kTile - 1) / kTile);
  kern<<<grid, kThreads, fwd_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, g);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int BH, const Geometry& g,
                    cudaStream_t st) {
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

template <typename T, int D>
cudaError_t run_dq(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int BH, const Geometry& g, cudaStream_t st) {
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
