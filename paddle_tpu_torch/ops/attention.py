"""Attention ops (``paddle_tpu/ops/attention.py``): the composed path and
flash attention, forward and backward.

Layout (batch, heads, seq, head_dim) — "BHSD" — as in the reference.

- :func:`scaled_dot_product_attention` is the composed path (the
  reference's XLA path): fp32 scores, bottom-right aligned causal mask,
  fully-masked rows emitting 0, optional attention-probability dropout.
- :func:`flash_attention` is a ``torch.autograd.Function`` (the
  reference's ``custom_vjp``): the forward returns ``out`` and keeps the
  logsumexp; the backward recomputes ``p`` from it (FlashAttention-2).
  On CUDA tensors it launches the hand-written Hopper kernels of
  ``csrc/flash_attention.cu`` (K5 forward, K6a dk/dv, K6b dq) or raises;
  on CPU tensors it runs their plain PyTorch versions
  (:func:`flash_fwd_plain`, :func:`flash_bwd_plain`, the ports of
  ``_lax_flash_fwd`` and ``_lax_flash_block_bwd``). A key-only bias
  ``(B, 1, 1, Sk)`` is a constant (zero cotangent). A full ``(.., Sq,
  Sk)`` bias that needs no gradient (a packed batch's segment bias) is a
  constant too and takes the kernels both ways; one that needs its
  gradient (a trainable relative-position bias) takes the composed
  recompute path in the backward, as the reference's full biases do.
- The three kernels are registered ops (``torch.library.custom_op``):
  ``ptt::flash_fwd``, ``ptt::flash_bwd_dkv`` and ``ptt::flash_bwd_dq``,
  each with a fake implementation that gives its outputs' shapes and
  dtypes. :func:`flash_attention` reaches the kernels through them, so
  ``torch.export`` of a module on the card records a ``ptt.flash_fwd``
  node and the exported program launches K5 itself (a process that loads
  it imports this module to register the ops).
- :func:`dot_product_attention` is the entry point the layers call. Its
  "auto" never raises on a shape or dtype: a head dim up to 128 outside
  :data:`HEAD_DIMS` is zero-padded to the kernels' next head dim
  (:func:`padded_flash_attention`), and a larger head dim or another
  dtype takes the composed path, as the reference's "auto" does off the
  TPU.

Scale: scores are scaled in fp32 after the dot everywhere (the
reference's lax path; its Pallas wrapper scaled ``q`` in ``q.dtype``).

Tiles: the reference tunes ``block_q``/``block_k``; here the wgmma
design fixes them by dtype and head dim, so each entry's contract
declares one-candidate sets (``_fwd_tiles``, ``_dkv_tiles``,
``_dq_tiles``), which the autotuner resolves and the registry lint
checks like any other.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.kernels import build, registry

#: large-negative instead of -inf: keeps softmax NaN-free for rows whose
#: every key is masked
NEG_INF = -1e30

_SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _bias4(bias):
    """Accept broadcastable ranks, as the reference does."""
    if bias is not None and bias.ndim < 4:
        bias = bias.reshape((1,) * (4 - bias.ndim) + tuple(bias.shape))
    return bias


def _causal_mask(sq, sk, device):
    """True where key ``col`` is visible from query ``row``: bottom-right
    aligned, ``col <= row + (Sk - Sq)``."""
    row = torch.arange(sq, device=device)[:, None]
    col = torch.arange(sk, device=device)[None, :]
    return col <= row + (sk - sq)


# ---------------------------------------------------------------------------
# composed path
# ---------------------------------------------------------------------------

def scaled_dot_product_attention(q, k, v, *, bias=None, causal=False,
                                 scale: Optional[float] = None,
                                 dropout_rate: float = 0.0,
                                 generator: Optional[torch.Generator] = None):
    """q, k, v: (B, H, S, D). ``bias`` is additive, broadcastable to
    (B, H, Sq, Sk); ``causal`` masks key ``col > row + (Sk - Sq)``.
    ``dropout_rate > 0`` drops attention probabilities (upscale in train)
    with draws from ``generator``."""
    scale = _scale(q, scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        s = s.masked_fill(~_causal_mask(s.shape[-2], s.shape[-1], s.device),
                          NEG_INF)
    p = torch.softmax(s, dim=-1)
    # fully-masked rows (every key at NEG_INF): 0, not the uniform mean of v
    alive = s.amax(dim=-1, keepdim=True) > NEG_INF / 2
    p = torch.where(alive, p, torch.zeros_like(p))
    if dropout_rate > 0.0:
        keep = torch.rand(p.shape, generator=generator,
                          device=p.device) < 1.0 - dropout_rate
        p = torch.where(keep, p / (1.0 - dropout_rate), torch.zeros_like(p))
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def make_padding_bias(pad_mask, dtype=torch.float32):
    """(B, Sk) bool valid-mask -> additive bias (B, 1, 1, Sk): 0 where
    valid, ``NEG_INF`` where masked."""
    bias = torch.where(pad_mask.bool(), 0.0, NEG_INF).to(dtype)
    return bias[:, None, None, :]


# ---------------------------------------------------------------------------
# plain PyTorch versions (ports of _lax_flash_fwd / _lax_flash_block_bwd)
# ---------------------------------------------------------------------------

def _masked_scores(q, k, bias, *, scale, causal):
    """fp32 scores with the same masking the kernels apply."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        s = torch.where(_causal_mask(s.shape[-2], s.shape[-1], s.device), s,
                        torch.full_like(s, NEG_INF))
    return s


def flash_fwd_plain(q, k, v, bias=None, *, causal=False,
                    scale: Optional[float] = None):
    """Returns ``(out, lse)``: ``out`` in ``q.dtype``, ``lse`` fp32
    (B, H, Sq). Fully-masked rows give 0 and ``lse ~ NEG_INF``."""
    scale = _scale(q, scale)
    s = _masked_scores(q, k, _bias4(bias), scale=scale, causal=causal)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    alive = m > NEG_INF / 2
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    out = torch.where(alive[..., None], out / denom[..., None],
                      torch.zeros_like(out)).to(q.dtype)
    return out, m + torch.log(denom)


def _flash_bwd_parts(q, k, v, bias, do, lse, delta, *, causal=False,
                     scale: Optional[float] = None):
    """(dq, dk, dv) against a given lse and delta = rowsum(do * out)."""
    scale = _scale(q, scale)
    s = _masked_scores(q, k, _bias4(bias), scale=scale, causal=causal)
    p = torch.exp(s - lse[..., None])
    # fully-masked rows: lse ~ NEG_INF would turn exp into garbage ones
    p = torch.where(lse[..., None] <= NEG_INF / 2, torch.zeros_like(p), p)
    g32 = do.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", g32, v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_delta(do, out):
    """delta = rowsum(do * out) in fp32, (B, H, Sq): elementwise work the
    reference leaves to XLA outside its kernels."""
    return (do.float() * out.float()).sum(dim=-1)


def flash_bwd_plain(q, k, v, bias, out, lse, do, *, causal=False,
                    scale: Optional[float] = None):
    """Returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    return _flash_bwd_parts(q, k, v, bias, do, lse, flash_delta(do, out),
                            causal=causal, scale=scale)


def _dkv_plain(q, k, v, bias, do, lse, delta, *, causal=False, scale=None):
    return _flash_bwd_parts(q, k, v, bias, do, lse, delta, causal=causal,
                            scale=scale)[1:]


def _dq_plain(q, k, v, bias, do, lse, delta, *, causal=False, scale=None):
    return _flash_bwd_parts(q, k, v, bias, do, lse, delta, causal=causal,
                            scale=scale)[0]


# ---------------------------------------------------------------------------
# dense references: the composed path and its autograd
# ---------------------------------------------------------------------------

def _fwd_reference(q, k, v, bias=None, *, causal=False, scale=None):
    scale = _scale(q, scale)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = scaled_dot_product_attention(qf, kf, vf, bias=bias, causal=causal,
                                       scale=scale)
    s = _masked_scores(qf, kf, _bias4(bias), scale=scale, causal=causal)
    return out, torch.logsumexp(s, dim=-1)


def _bwd_reference(q, k, v, bias, do, *, causal, scale):
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
        out = scaled_dot_product_attention(qf, kf, vf, bias=bias,
                                           causal=causal, scale=scale)
        return torch.autograd.grad(out, (qf, kf, vf), do.float())


def _dkv_reference(q, k, v, bias, do, lse, delta, *, causal=False,
                   scale=None):
    return _bwd_reference(q, k, v, bias, do, causal=causal, scale=scale)[1:]


def _dq_reference(q, k, v, bias, do, lse, delta, *, causal=False,
                  scale=None):
    return _bwd_reference(q, k, v, bias, do, causal=causal, scale=scale)[0]


# ---------------------------------------------------------------------------
# CUDA wrappers (csrc/flash_attention.cu through ctypes)
# ---------------------------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_GEOM = [_I] * 6 + [ctypes.c_float, _I] + [_L] * 4 + [_P]
_SIGNATURES = {
    # q, k, v, bias, out, lse | B, H, Sq, Sk, D, dtype, scale, causal,
    # bias strides (4), stream
    "ptt_flash_fwd": [_P] * 6 + _GEOM,
    # q, k, v, bias, do, lse, delta, dk, dv | geometry as above
    "ptt_flash_bwd_dkv": [_P] * 9 + _GEOM,
    # q, k, v, bias, do, lse, delta, dq | geometry as above
    "ptt_flash_bwd_dq": [_P] * 8 + _GEOM,
}


def _check(q, k, v, bias, extra=(), fp32_extra=()):
    """Raise on anything the kernels do not take; returns the bias as an
    fp32 (B, H, Sq, Sk) broadcast view and its four element strides."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got q on {dev}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q dtype {q.dtype} not supported (float32 or "
                        "bfloat16)")
    if q.ndim != 4:
        raise ValueError(f"q must be (B, H, Sq, D), got {tuple(q.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2] if k.ndim == 4 else 0
    if d not in HEAD_DIMS:
        raise ValueError(f"kernel takes head dim in {HEAD_DIMS}, got {d}")
    if min(sq, sk) < 1:
        raise ValueError(f"kernel takes Sq, Sk >= 1, got q {tuple(q.shape)} "
                         f"and k {tuple(k.shape)}")
    kv = (b, h, sk, d)
    named = [("q", q, q.shape), ("k", k, kv), ("v", v, kv)]
    named += [(n, t, q.shape) for n, t in extra]      # do: like q
    for name, t, shape in named:
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
    for name, t, shape in fp32_extra:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        named.append((name, t, shape))
    for name, t, _ in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if bias is None:
        return None, (0, 0, 0, 0)
    bias = _bias4(bias)
    if bias.device != dev:
        raise ValueError(f"bias must be on {dev}, got {bias.device}")
    try:
        view = bias.float().expand(b, h, sq, sk)
    except RuntimeError as err:
        raise ValueError(f"bias {tuple(bias.shape)} does not broadcast to "
                         f"{(b, h, sq, sk)}") from err
    return view, tuple(view.stride())


def _geometry(q, k, bias_strides, causal, scale):
    b, h, sq, d = q.shape
    return (b, h, sq, k.shape[2], d, _DTYPE_CODES[q.dtype], _scale(q, scale),
            int(bool(causal)), *bias_strides)


def _launch(name, *ptrs_and_geometry, device):
    """Launch ``name`` (bound once) on ``device``'s current stream; raise
    on a refused launch."""
    fn = build.bind("flash_attention", name, _SIGNATURES[name])
    rc = build.launch(fn, device, *ptrs_and_geometry)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_fwd_cuda(q, k, v, bias=None, *, causal=False,
                   scale: Optional[float] = None, blocks=None):
    """K5: returns ``(out, lse)`` like :func:`flash_fwd_plain`. ``blocks``
    may only name the design's tiles (one candidate each)."""
    bias_v, strides = _check(q, k, v, bias)
    if blocks is not None:                # the design fixes the tiles
        FWD.blocks_for((q, k, v, bias), blocks)
    b, h, sq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch("ptt_flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(bias_v), out.data_ptr(), lse.data_ptr(),
            *_geometry(q, k, strides, causal, scale), device=q.device)
    FWD.note_launch()
    return out, lse


def _check_bwd(q, k, v, bias, do, lse, delta):
    rows = tuple(q.shape[:3])
    return _check(q, k, v, bias, extra=(("do", do),),
                  fp32_extra=(("lse", lse, rows), ("delta", delta, rows)))


def flash_bwd_dkv_cuda(q, k, v, bias, do, lse, delta, *, causal=False,
                       scale: Optional[float] = None, blocks=None):
    """K6a: returns ``(dk, dv)`` against the forward's lse and
    delta = rowsum(do * out)."""
    bias_v, strides = _check_bwd(q, k, v, bias, do, lse, delta)
    if blocks is not None:                # the design fixes the tiles
        BWD_DKV.blocks_for((q, k, v, bias, do, lse, delta), blocks)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("ptt_flash_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(bias_v), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            *_geometry(q, k, strides, causal, scale), device=q.device)
    BWD_DKV.note_launch()
    return dk, dv


def flash_bwd_dq_cuda(q, k, v, bias, do, lse, delta, *, causal=False,
                      scale: Optional[float] = None, blocks=None):
    """K6b: returns ``dq``."""
    bias_v, strides = _check_bwd(q, k, v, bias, do, lse, delta)
    if blocks is not None:                # the design fixes the tiles
        BWD_DQ.blocks_for((q, k, v, bias, do, lse, delta), blocks)
    dq = torch.empty_like(q)
    _launch("ptt_flash_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(bias_v), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), *_geometry(q, k, strides, causal, scale),
            device=q.device)
    BWD_DQ.note_launch()
    return dq


# ---------------------------------------------------------------------------
# work of one call on its inputs (the roofline bound's numerator)
# ---------------------------------------------------------------------------

def _live_pairs(sq, sk, causal):
    """(query, key) pairs the kernels must compute: all, or with
    ``causal`` those on or below the bottom-right aligned diagonal."""
    if not causal:
        return sq * sk
    rows = np.arange(sq, dtype=np.int64)
    return int(np.clip(rows + (sk - sq) + 1, 0, sk).sum())


def _work(q, k, bias, causal, *, q_like, kv_like, fp32_rows, flops_per_pair):
    """``q_like`` (B, H, Sq, D) and ``kv_like`` (B, H, Sk, D) tensors moved
    once in the inputs' dtype, ``fp32_rows`` (B, H, Sq) fp32 vectors, the
    bias as stored (a key bias is B x Sk values)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    nbytes = ((q_like * sq + kv_like * sk) * b * h * d * q.element_size()
              + 4 * fp32_rows * b * h * sq
              + (4 * bias.numel() if bias is not None else 0))
    return nbytes, flops_per_pair * b * h * d * _live_pairs(sq, sk, causal)


def fwd_work(q, k, v, bias=None, *, causal=False, **_kw):
    """(bytes, flops): q, k, v read and out written once, the bias read
    once, lse written; 4 flops per live (query, key, d)."""
    return _work(q, k, bias, causal, q_like=2, kv_like=2, fp32_rows=1,
                 flops_per_pair=4)


def dkv_work(q, k, v, bias, do, lse, delta, *, causal=False, **_kw):
    """(bytes, flops): q, do, k, v, lse, delta and the bias read once, dk
    and dv written; 8 flops per live (query, key, d): q.k, do.v, p^T do,
    ds^T q."""
    return _work(q, k, bias, causal, q_like=2, kv_like=4, fp32_rows=2,
                 flops_per_pair=8)


def dq_work(q, k, v, bias, do, lse, delta, *, causal=False, **_kw):
    """(bytes, flops): q, do, k, v, lse, delta and the bias read once, dq
    written; 6 flops per live (query, key, d): q.k, do.v, ds k."""
    return _work(q, k, bias, causal, q_like=3, kv_like=2, fp32_rows=2,
                 flops_per_pair=6)


# ---------------------------------------------------------------------------
# contracts: samples, tuning keys, the design's tiles and shared memory
# ---------------------------------------------------------------------------

def _fwd_sample(seed):
    """The reference's ``_flash_sample_inputs`` shapes (its values come
    from ``jax.random``; these from numpy under the same seed), causal,
    float32 on the CPU."""
    b, h, s, d = ((1, 2, 64, 32), (2, 2, 128, 64), (1, 4, 320, 64))[seed % 3]
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(
        np.float32)) for _ in range(3))
    return (q, k, v, None), {"causal": True}


def _bwd_sample(seed):
    """:func:`_fwd_sample` plus a seeded output cotangent, with the plain
    forward's lse and delta = rowsum(do * out)."""
    (q, k, v, bias), kw = _fwd_sample(seed)
    rng = np.random.default_rng(seed + 1000)
    do = torch.from_numpy(rng.standard_normal(tuple(q.shape)).astype(
        np.float32))
    out, lse = flash_fwd_plain(q, k, v, bias, **kw)
    return (q, k, v, bias, do, lse, flash_delta(do, out)), kw


def _flash_tune_signature(args):
    """The reference's ``_flash_tune_signature``: B*H, Sq, Sk, D."""
    q, k = args[0], args[1]
    b, h, sq, d = q.shape
    return (("bh", b * h), ("q", sq), ("k", k.shape[2]), ("d", d))


#: the csrc/flash_attention.cu tiles: kTile (fp32 path), kWgRows (wgmma M)
_TILE, _WG_ROWS = 64, 64


def _fwd_keys(d):
    return 128 if d <= 64 else 64


def _bwd_queries(d):
    return 64 if d <= 64 else 32


def _fwd_tiles(args):
    q = args[0]
    if q.dtype != torch.bfloat16:
        return {"block_q": (_TILE,), "block_k": (_TILE,)}
    return {"block_q": (_WG_ROWS,), "block_k": (_fwd_keys(q.shape[-1]),)}


def _dkv_tiles(args):
    q = args[0]
    if q.dtype != torch.bfloat16:
        return {"block_q": (_TILE,), "block_k": (_TILE,)}
    return {"block_q": (_bwd_queries(q.shape[-1]),), "block_k": (_WG_ROWS,)}


def _dq_tiles(args):
    if args[0].dtype != torch.bfloat16:
        return {"block_q": (_TILE,), "block_k": (_TILE,)}
    return {"block_q": (_WG_ROWS,), "block_k": (64,)}


def _fp32_smem(d, backward):
    """``fwd_smem<D>`` / ``bwd_smem<D>`` of the fp32 kernels."""
    q_rows, kv_rows, p_rows = (d + 4) * _TILE, (d + 1) * _TILE, (_TILE + 1) * _TILE
    if backward:
        return 4 * (2 * q_rows + 2 * kv_rows + 2 * p_rows + 2 * _TILE)
    return 4 * (q_rows + 2 * kv_rows + p_rows)


def _fwd_smem(args, blocks):
    q = args[0]
    d = q.shape[-1]
    if q.dtype != torch.bfloat16:
        return _fp32_smem(d, False)
    keys = blocks["block_k"]
    return 1024 + _WG_ROWS * d * 2 + 4 * keys * d * 2 + 2 * keys * 4 + 5 * 8


def _dkv_smem(args, blocks):
    q = args[0]
    d = q.shape[-1]
    if q.dtype != torch.bfloat16:
        return _fp32_smem(d, True)
    nq = blocks["block_q"]
    return 1024 + 2 * _WG_ROWS * d * 2 + 4 * nq * d * 2 + 4 * nq * 4 + 3 * 8


def _dq_smem(args, blocks):
    q = args[0]
    d = q.shape[-1]
    if q.dtype != torch.bfloat16:
        return _fp32_smem(d, True)
    keys = blocks["block_k"]
    return (1024 + 2 * _WG_ROWS * d * 2 + 5 * keys * d * 2 + 2 * keys * 4
            + 6 * 8)


def _flash_contract(symbol, layout, out_layout, tiles):
    def prior(args):
        return {k: v[0] for k, v in tiles(args).items()}
    return registry.KernelContract(
        version=1, arg_layouts=layout, out_layout=out_layout,
        symbols={symbol: _SIGNATURES[symbol]}, candidates=tiles,
        prior=prior)


_FWD_LAYOUT = {"q": "(B,H,Sq,D)", "k": "(B,H,Sk,D)", "v": "(B,H,Sk,D)",
               "bias": "additive, broadcast to (B,H,Sq,Sk), optional"}
_BWD_LAYOUT = {**_FWD_LAYOUT, "do": "(B,H,Sq,D)", "lse": "(B,H,Sq) f32",
               "delta": "(B,H,Sq) f32"}

# fp32: the reference kernel contract's tolerance (ops/attention.py:761);
# bf16: the output rounds to bf16, compared against the plain version run
# in fp32 on the same bf16 inputs
_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-2, 1e-2)}
# gradients sum over up to Sq (or Sk) terms of fp32 products in another
# order than the plain version's einsum
_GRAD_TOL = {torch.float32: (5e-5, 5e-5), torch.bfloat16: (2e-2, 2e-2)}

FWD = registry.register(registry.KernelEntry(
    name="flash_attention_fwd",
    route="cuda",
    source=_SOURCE,
    replaces="paddle_tpu/ops/attention.py:239",
    cuda_fn=flash_fwd_cuda,
    plain_fn=flash_fwd_plain,
    reference_fn=_fwd_reference,
    tolerance=_TOL,
    work=fwd_work,
    contract=_flash_contract("ptt_flash_fwd", _FWD_LAYOUT,
                             "(B,H,Sq,D), lse (B,H,Sq) f32", _fwd_tiles),
    sample_inputs=_fwd_sample,
    tune_signature=_flash_tune_signature,
    smem=_fwd_smem))

BWD_DKV = registry.register(registry.KernelEntry(
    name="flash_attention_bwd_dkv",
    route="cuda",
    source=_SOURCE,
    replaces="paddle_tpu/ops/attention.py:525",
    cuda_fn=flash_bwd_dkv_cuda,
    plain_fn=_dkv_plain,
    reference_fn=_dkv_reference,
    tolerance=_GRAD_TOL,
    work=dkv_work,
    contract=_flash_contract("ptt_flash_bwd_dkv", _BWD_LAYOUT,
                             "dk, dv (B,H,Sk,D)", _dkv_tiles),
    sample_inputs=_bwd_sample,
    tune_signature=_flash_tune_signature,
    smem=_dkv_smem))

BWD_DQ = registry.register(registry.KernelEntry(
    name="flash_attention_bwd_dq",
    route="cuda",
    source=_SOURCE,
    replaces="paddle_tpu/ops/attention.py:556",
    cuda_fn=flash_bwd_dq_cuda,
    plain_fn=_dq_plain,
    reference_fn=_dq_reference,
    tolerance=_GRAD_TOL,
    work=dq_work,
    contract=_flash_contract("ptt_flash_bwd_dq", _BWD_LAYOUT,
                             "dq (B,H,Sq,D)", _dq_tiles),
    sample_inputs=_bwd_sample,
    tune_signature=_flash_tune_signature,
    smem=_dq_smem))


# ---------------------------------------------------------------------------
# the kernels as registered ops
# ---------------------------------------------------------------------------

def _use_kernels(q, plain: bool) -> bool:
    if plain or q.device.type == "cpu":
        return False
    if q.device.type == "cuda":
        return True
    raise ValueError(f"flash_attention: unsupported device {q.device}")


@torch.library.custom_op("ptt::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias: Optional[torch.Tensor], causal: bool,
                 scale: Optional[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 as ``torch.ops.ptt.flash_fwd``: :func:`flash_fwd_cuda` on CUDA
    tensors, :func:`flash_fwd_plain` on CPU ones. Returns ``(out, lse)``."""
    if _use_kernels(q, False):
        return flash_fwd_cuda(q, k, v, bias, causal=causal, scale=scale)
    return flash_fwd_plain(q, k, v, bias, causal=causal, scale=scale)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, bias, causal, scale):
    b, h, sq, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((b, h, sq), dtype=torch.float32))


@torch.library.custom_op("ptt::flash_bwd_dkv", mutates_args=())
def flash_bwd_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: Optional[torch.Tensor], do: torch.Tensor,
                     lse: torch.Tensor, delta: torch.Tensor, causal: bool,
                     scale: Optional[float]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6a as ``torch.ops.ptt.flash_bwd_dkv``: ``(dk, dv)``."""
    args = (q, k, v, bias, do, lse, delta)
    if _use_kernels(q, False):
        return flash_bwd_dkv_cuda(*args, causal=causal, scale=scale)
    return _dkv_plain(*args, causal=causal, scale=scale)


@flash_bwd_dkv_op.register_fake
def _flash_bwd_dkv_fake(q, k, v, bias, do, lse, delta, causal, scale):
    return torch.empty_like(k), torch.empty_like(v)


@torch.library.custom_op("ptt::flash_bwd_dq", mutates_args=())
def flash_bwd_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor], do: torch.Tensor,
                    lse: torch.Tensor, delta: torch.Tensor, causal: bool,
                    scale: Optional[float]) -> torch.Tensor:
    """K6b as ``torch.ops.ptt.flash_bwd_dq``: ``dq``."""
    args = (q, k, v, bias, do, lse, delta)
    if _use_kernels(q, False):
        return flash_bwd_dq_cuda(*args, causal=causal, scale=scale)
    return _dq_plain(*args, causal=causal, scale=scale)


@flash_bwd_dq_op.register_fake
def _flash_bwd_dq_fake(q, k, v, bias, do, lse, delta, causal, scale):
    return torch.empty_like(q)


# ---------------------------------------------------------------------------
# flash_attention: forward and backward as one autograd Function
# ---------------------------------------------------------------------------

def _full_bias(bias) -> bool:
    return bias is not None and bias.ndim >= 2 and bias.shape[-2] != 1


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale, plain):
        q, k, v = (t.contiguous() for t in (q, k, v))
        if plain:
            out, lse = flash_fwd_plain(q, k, v, bias, causal=causal,
                                       scale=scale)
        else:
            out, lse = torch.ops.ptt.flash_fwd(q, k, v, bias, causal, scale)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.causal, ctx.scale, ctx.plain = causal, scale, plain
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        causal, scale = ctx.causal, ctx.scale
        if _full_bias(bias) and ctx.needs_input_grad[3]:
            # a trainable full (.., Sq, Sk) bias: recompute through the
            # composed path, which yields its grad in its own shape
            with torch.enable_grad():
                ins = [t.detach().requires_grad_() for t in (q, k, v)]
                bd = bias.detach().requires_grad_(ctx.needs_input_grad[3])
                o = scaled_dot_product_attention(*ins, bias=bd, causal=causal,
                                                 scale=scale)
                wrt = ins + ([bd] if bd.requires_grad else [])
                grads = torch.autograd.grad(o, wrt, g)
            dbias = grads[3] if bd.requires_grad else None
            return (*grads[:3], dbias, None, None, None)
        g = g.contiguous()
        delta = flash_delta(g, out)
        args = (q, k, v, bias, g, lse, delta)
        if _use_kernels(q, ctx.plain):
            dk, dv = torch.ops.ptt.flash_bwd_dkv(*args, causal, scale)
            dq = torch.ops.ptt.flash_bwd_dq(*args, causal, scale)
        else:
            dq, dk, dv = _flash_bwd_parts(*args, causal=causal, scale=scale)
        # a key-padding bias (or a full one that needs no gradient) is a
        # constant: zero cotangent
        dbias = (torch.zeros_like(bias)
                 if bias is not None and ctx.needs_input_grad[3] else None)
        return dq, dk, dv, dbias, None, None, None


def flash_attention(q, k, v, bias=None, causal=False,
                    scale: Optional[float] = None, *, plain: bool = False):
    """Flash attention with its FlashAttention-2 backward. q, k, v:
    (B, H, S, D); ``bias`` additive, broadcastable to (B, H, Sq, Sk).
    CUDA tensors launch the Hopper kernels (or raise); CPU tensors, or
    ``plain=True`` on any device, run the plain PyTorch versions."""
    return _FlashAttention.apply(q, k, v, bias, bool(causal), scale,
                                 bool(plain))


def kernel_head_dim(d: int) -> Optional[int]:
    """The kernels' head dim that holds ``d``: the least of
    :data:`HEAD_DIMS` at or above it, or None past the largest."""
    return next((k for k in HEAD_DIMS if k >= d), None)


def padded_flash_attention(q, k, v, bias=None, causal=False,
                           scale: Optional[float] = None):
    """:func:`flash_attention` at :func:`kernel_head_dim` of D: q, k and v
    zero-padded along D, the softmax scale of the true D, the output
    sliced back to D. Exact both ways: zero columns add nothing to q.k,
    and the padded columns of the output get a zero cotangent, so dq, dk
    and dv are zero there."""
    d = q.shape[-1]
    pad = (0, kernel_head_dim(d) - d)
    out = flash_attention(*(F.pad(t, pad) for t in (q, k, v)), bias, causal,
                          _scale(q, scale))
    return out[..., :d]


def dot_product_attention(q, k, v, *, bias=None, causal=False, scale=None,
                          dropout_rate: float = 0.0,
                          generator: Optional[torch.Generator] = None,
                          impl: str = "auto"):
    """Attention entry point used by the layers.

    impl: "auto" (flash when ``dropout_rate == 0`` and the kernels take
    the dtype (fp32, bf16) and head dim (up to 128: a head dim outside
    :data:`HEAD_DIMS` is zero-padded to the next one), else the composed
    path, decided from shape and dtype alone), "flash" (the kernels on
    CUDA, their plain versions on the CPU; a head dim outside
    :data:`HEAD_DIMS` raises on CUDA), "plain" (the plain versions on any
    device; tests and parity legs), "xla" (the composed path, the
    reference's name for it)."""
    if impl not in ("auto", "flash", "plain", "xla"):
        raise ValueError(f"unknown attention impl {impl!r}")
    kernel_d = kernel_head_dim(q.shape[-1])
    if impl == "xla" or dropout_rate > 0.0 or impl == "auto" and (
            kernel_d is None or q.dtype not in _DTYPE_CODES):
        return scaled_dot_product_attention(
            q, k, v, bias=bias, causal=causal, scale=scale,
            dropout_rate=dropout_rate, generator=generator)
    if impl == "auto" and kernel_d != q.shape[-1]:
        return padded_flash_attention(q, k, v, bias, causal, scale)
    return flash_attention(q, k, v, bias, causal, scale,
                           plain=impl == "plain")
