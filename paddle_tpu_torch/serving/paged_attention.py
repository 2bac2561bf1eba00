"""Ragged paged attention: the serving engine's hot path
(``paddle_tpu/serving/decode_attention.py``).

One fixed-shape call attends every slot's query token(s) over only that
slot's live KV pages:

``ragged_paged_decode_attention`` — one query token per slot:
  q            (S, H, Dh)        one query token per decode slot
  k/v pages    (P, ps, H, Dh)    fixed-size pages, token-major
  block_tables (S, w) int32      page ids per slot (page 0 = null page)
  lengths      (S,) int32        live tokens per slot (0 = inactive)

``ragged_paged_prefill_attention`` — a chunk of C query tokens per slot
at absolute positions ``chunk_starts[s] + c``, causal over everything the
slot has cached (including the chunk's own prefix, which the caller has
already written). Lanes at or past ``n_valid[s]`` emit exact zeros.

``ragged_paged_{decode,prefill}_int8_attention`` — the same over an int8
page pool with fp32 per-token-row scales ``k_scales``/``v_scales``
(P, ps) (``paged_cache.quantize_kv``'s layout): dequantization is fused,
``score *= k_scale`` after the scaled dot and ``p *= v_scale`` before PV
(the softmax denominator sees ``p`` before ``v_scale``), so no fp page is
ever materialized. The int8 prefill is also the speculative verify
step's attention.

Each has three implementations in this module: the hand-written Hopper
kernel (``csrc/paged_attention.cu``, launched for CUDA tensors), the
plain PyTorch version (the port of the reference's lax fallback, taken
for CPU tensors and used as the kernel's yardstick on the card), and a
dense per-row numpy reference. The public functions dispatch on the
tensors' device: a CUDA tensor launches the kernel or raises, a CPU
tensor runs the plain version; there is no fallback between the two.

Scale: scores are scaled in fp32 after the dot, in the plain version
and in the kernel alike (the reference's lax fallback; its Pallas
wrapper scaled ``q`` in ``q.dtype`` instead).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from paddle_tpu_torch.kernels import build, registry
from paddle_tpu_torch.ops.attention import NEG_INF

_SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_PAGE_SIZE = 256


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


# ---------------------------------------------------------------------------
# plain PyTorch versions (ports of _paged_decode_lax / _paged_prefill_lax)
# ---------------------------------------------------------------------------

def paged_decode_plain(q, k_pages, v_pages, block_tables, lengths, *,
                       scale: Optional[float] = None):
    scale = _scale(q, scale)
    s_slots, h, _dh = q.shape
    mp = block_tables.shape[1]
    ps = k_pages.shape[1]
    bt = block_tables.long()
    kg = k_pages[bt]                                   # (S, mp, ps, H, Dh)
    vg = v_pages[bt]
    scores = torch.einsum("shd,smthd->shmt", q.float(), kg.float()) * scale
    scores = scores.reshape(s_slots, h, mp * ps)
    tok = torch.arange(mp * ps, device=q.device)
    valid = tok[None, None, :] < lengths.long()[:, None, None]
    scores = scores.masked_fill(~valid, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    # length-0 slots: every key masked -> emit 0, not a uniform mean of v
    alive = scores.amax(dim=-1, keepdim=True) > NEG_INF / 2
    p = torch.where(alive, p, torch.zeros_like(p)).reshape(s_slots, h, mp, ps)
    out = torch.einsum("shmt,smthd->shd", p, vg.float())
    return out.to(q.dtype)


def paged_prefill_plain(q, k_pages, v_pages, block_tables, chunk_starts,
                        n_valid, *, scale: Optional[float] = None):
    scale = _scale(q, scale)
    s_slots, c, h, _dh = q.shape
    mp = block_tables.shape[1]
    ps = k_pages.shape[1]
    bt = block_tables.long()
    kg = k_pages[bt]                                   # (S, mp, ps, H, Dh)
    vg = v_pages[bt]
    scores = torch.einsum("schd,smthd->shcmt", q.float(), kg.float()) * scale
    scores = scores.reshape(s_slots, h, c, mp * ps)
    tok = torch.arange(mp * ps, device=q.device)
    lane = torch.arange(c, device=q.device)
    pos = chunk_starts.long()[:, None] + lane                    # (S, C)
    causal = tok[None, None, None, :] <= pos[:, None, :, None]
    row_ok = (lane[None, :] < n_valid.long()[:, None])[:, None, :, None]
    scores = scores.masked_fill(~(causal & row_ok), NEG_INF)
    p = torch.softmax(scores, dim=-1)
    # masked rows (padding lanes / inactive slots) emit exact zeros
    alive = scores.amax(dim=-1, keepdim=True) > NEG_INF / 2
    p = torch.where(alive, p, torch.zeros_like(p)).reshape(
        s_slots, h, c, mp, ps)
    out = torch.einsum("shcmt,smthd->schd", p, vg.float())
    return out.to(q.dtype)


# ports of _paged_decode_int8_lax / _paged_prefill_int8_lax: the same order
# of operations, (q.k) * scale, then * k_scale per token, then mask,
# softmax and the alive zeroing, then p * v_scale before PV

def paged_decode_int8_plain(q, k_pages, v_pages, k_scales, v_scales,
                            block_tables, lengths, *,
                            scale: Optional[float] = None):
    scale = _scale(q, scale)
    s_slots, h, _dh = q.shape
    mp = block_tables.shape[1]
    ps = k_pages.shape[1]
    bt = block_tables.long()
    kg = k_pages[bt]                                   # (S, mp, ps, H, Dh) i8
    vg = v_pages[bt]
    ksg = k_scales[bt]                                 # (S, mp, ps) f32
    vsg = v_scales[bt]
    scores = torch.einsum("shd,smthd->shmt", q.float(), kg.float()) * scale
    scores = scores * ksg[:, None]                     # dequant fused post-dot
    scores = scores.reshape(s_slots, h, mp * ps)
    tok = torch.arange(mp * ps, device=q.device)
    valid = tok[None, None, :] < lengths.long()[:, None, None]
    scores = scores.masked_fill(~valid, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    alive = scores.amax(dim=-1, keepdim=True) > NEG_INF / 2
    p = torch.where(alive, p, torch.zeros_like(p)).reshape(s_slots, h, mp, ps)
    p = p * vsg[:, None]                               # dequant fused pre-PV
    out = torch.einsum("shmt,smthd->shd", p, vg.float())
    return out.to(q.dtype)


def paged_prefill_int8_plain(q, k_pages, v_pages, k_scales, v_scales,
                             block_tables, chunk_starts, n_valid, *,
                             scale: Optional[float] = None):
    scale = _scale(q, scale)
    s_slots, c, h, _dh = q.shape
    mp = block_tables.shape[1]
    ps = k_pages.shape[1]
    bt = block_tables.long()
    kg = k_pages[bt]                                   # (S, mp, ps, H, Dh) i8
    vg = v_pages[bt]
    ksg = k_scales[bt]                                 # (S, mp, ps) f32
    vsg = v_scales[bt]
    scores = torch.einsum("schd,smthd->shcmt", q.float(), kg.float()) * scale
    scores = scores * ksg[:, None, None]               # dequant fused post-dot
    scores = scores.reshape(s_slots, h, c, mp * ps)
    tok = torch.arange(mp * ps, device=q.device)
    lane = torch.arange(c, device=q.device)
    pos = chunk_starts.long()[:, None] + lane                    # (S, C)
    causal = tok[None, None, None, :] <= pos[:, None, :, None]
    row_ok = (lane[None, :] < n_valid.long()[:, None])[:, None, :, None]
    scores = scores.masked_fill(~(causal & row_ok), NEG_INF)
    p = torch.softmax(scores, dim=-1)
    alive = scores.amax(dim=-1, keepdim=True) > NEG_INF / 2
    p = torch.where(alive, p, torch.zeros_like(p)).reshape(
        s_slots, h, c, mp, ps)
    p = p * vsg[:, None, None]                         # dequant fused pre-PV
    out = torch.einsum("shcmt,smthd->schd", p, vg.float())
    return out.to(q.dtype)


def paged_prefill_attention(q, k_pages, v_pages, block_table_row, positions,
                            *, scale: Optional[float] = None):
    """Chunked-prefill attention for ONE slot (plain PyTorch; the
    reference composes it in XLA, no TPU kernel). ``q`` (C, H, Dh) at
    absolute ``positions`` (C,); keys/values come from the slot's pages
    via ``block_table_row`` (max_pages,). Each query attends causally to
    every cache position ``<= positions[c]``; padded queries give rows
    the caller discards."""
    scale = _scale(q, scale)
    mp = block_table_row.shape[0]
    ps = k_pages.shape[1]
    h, dh = q.shape[1], q.shape[2]
    bt = block_table_row.long()
    k = k_pages[bt].reshape(mp * ps, h, dh)
    v = v_pages[bt].reshape(mp * ps, h, dh)
    scores = torch.einsum("chd,thd->hct", q.float(), k.float()) * scale
    tok = torch.arange(mp * ps, device=q.device)
    causal = tok[None, None, :] <= positions.long()[None, :, None]
    scores = scores.masked_fill(~causal, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    alive = scores.amax(dim=-1, keepdim=True) > NEG_INF / 2
    p = torch.where(alive, p, torch.zeros_like(p))
    out = torch.einsum("hct,thd->chd", p, v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# dense references: numpy, per slot and per row, independent of both
# ---------------------------------------------------------------------------

def _np(t):
    return t.detach().float().cpu().numpy()


def paged_decode_reference(q, k_pages, v_pages, block_tables, lengths, *,
                           scale: Optional[float] = None):
    scale = _scale(q, scale)
    s_slots, h, dh = q.shape
    mp, ps = block_tables.shape[1], k_pages.shape[1]
    qn, kp, vp = _np(q), _np(k_pages), _np(v_pages)
    bt = block_tables.cpu().numpy()
    ln = lengths.cpu().numpy()
    outs = np.zeros((s_slots, h, dh), np.float32)
    for sl in range(s_slots):
        n = int(ln[sl])
        if n == 0:
            continue
        k = kp[bt[sl]].reshape(mp * ps, h, dh)[:n]
        v = vp[bt[sl]].reshape(mp * ps, h, dh)[:n]
        s = np.einsum("hd,thd->ht", qn[sl], k) * scale
        s = s - s.max(-1, keepdims=True)
        p = np.exp(s)
        p = p / p.sum(-1, keepdims=True)
        outs[sl] = np.einsum("ht,thd->hd", p, v)
    return torch.from_numpy(outs).to(device=q.device, dtype=q.dtype)


def paged_prefill_reference(q, k_pages, v_pages, block_tables, chunk_starts,
                            n_valid, *, scale: Optional[float] = None):
    scale = _scale(q, scale)
    s_slots, c, h, dh = q.shape
    mp, ps = block_tables.shape[1], k_pages.shape[1]
    qn, kp, vp = _np(q), _np(k_pages), _np(v_pages)
    bt = block_tables.cpu().numpy()
    st = chunk_starts.cpu().numpy()
    nv = n_valid.cpu().numpy()
    outs = np.zeros((s_slots, c, h, dh), np.float32)
    for sl in range(s_slots):
        k = kp[bt[sl]].reshape(mp * ps, h, dh)
        v = vp[bt[sl]].reshape(mp * ps, h, dh)
        for r in range(int(nv[sl])):
            limit = int(st[sl]) + r + 1          # causal horizon
            s = np.einsum("hd,thd->ht", qn[sl, r], k[:limit]) * scale
            s = s - s.max(-1, keepdims=True)
            p = np.exp(s)
            p = p / p.sum(-1, keepdims=True)
            outs[sl, r] = np.einsum("ht,thd->hd", p, v[:limit])
    return torch.from_numpy(outs).to(device=q.device, dtype=q.dtype)


def _dequant_pages(k_pages, v_pages, k_scales, v_scales):
    """Host-side dequantization for the dense references, independent of
    the fused in-kernel path (port of ``_dequant_pages_np``)."""
    kf = _np(k_pages) * _np(k_scales)[:, :, None, None]
    vf = _np(v_pages) * _np(v_scales)[:, :, None, None]
    return torch.from_numpy(kf), torch.from_numpy(vf)


def paged_decode_int8_reference(q, k_pages, v_pages, k_scales, v_scales,
                                block_tables, lengths, *,
                                scale: Optional[float] = None):
    kf, vf = _dequant_pages(k_pages, v_pages, k_scales, v_scales)
    return paged_decode_reference(q, kf, vf, block_tables, lengths,
                                  scale=scale)


def paged_prefill_int8_reference(q, k_pages, v_pages, k_scales, v_scales,
                                 block_tables, chunk_starts, n_valid, *,
                                 scale: Optional[float] = None):
    kf, vf = _dequant_pages(k_pages, v_pages, k_scales, v_scales)
    return paged_prefill_reference(q, kf, vf, block_tables, chunk_starts,
                                   n_valid, scale=scale)


# ---------------------------------------------------------------------------
# CUDA wrappers (csrc/paged_attention.cu through ctypes)
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # q, k_pages, v_pages, block_tables, lengths, out,
    # S, H, Dh, ps, w, P, dtype, scale, stream
    "ptt_paged_decode": [_P] * 6 + [_I] * 7 + [ctypes.c_float, _P],
    # q, k_pages, v_pages, block_tables, chunk_starts, n_valid, out,
    # S, C, H, Dh, ps, w, P, dtype, scale, stream
    "ptt_paged_prefill": [_P] * 7 + [_I] * 8 + [ctypes.c_float, _P],
    # q, k_pages, v_pages, k_scales, v_scales, block_tables, lengths, out,
    # S, H, Dh, ps, w, P, dtype, scale, stream
    "ptt_paged_decode_int8": [_P] * 8 + [_I] * 7 + [ctypes.c_float, _P],
    # q, k_pages, v_pages, k_scales, v_scales, block_tables, chunk_starts,
    # n_valid, out, S, C, H, Dh, ps, w, P, dtype, scale, stream
    "ptt_paged_prefill_int8": [_P] * 9 + [_I] * 8 + [ctypes.c_float, _P],
}


def _launch(name: str, device, *args):
    """Launch ``name`` (bound once) on ``device``'s current stream; raise
    on a refused launch."""
    fn = build.bind("paged_attention", name, _SIGNATURES[name])
    rc = build.launch(fn, device, *args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")


def _check_args(q, k_pages, v_pages, ints, q_ndim, scales=None):
    """Raise on anything the kernels do not take. ``scales`` (the int8
    kernels): ``(k_scales, v_scales)``; the pages must then be int8."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got q on {dev}")
    if q.ndim != q_ndim:
        raise ValueError(f"q must be {q_ndim}-D, got shape {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    h, dh = q.shape[-2], q.shape[-1]
    page_dtype = q.dtype if scales is None else torch.int8
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.device != dev or t.dtype != page_dtype:
            raise ValueError(f"{name} must be {page_dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if t.ndim != 4 or t.shape[2] != h or t.shape[3] != dh:
            raise ValueError(f"{name} must be (P, ps, {h}, {dh}), got "
                             f"{tuple(t.shape)}")
    if k_pages.shape != v_pages.shape:
        raise ValueError("k_pages and v_pages differ in shape")
    if not 1 <= dh <= MAX_HEAD_DIM or not 1 <= k_pages.shape[1] <= MAX_PAGE_SIZE:
        raise ValueError(f"kernel takes Dh <= {MAX_HEAD_DIM} and page_size "
                         f"<= {MAX_PAGE_SIZE}, got {dh} and {k_pages.shape[1]}")
    tensors = [("q", q), ("k_pages", k_pages), ("v_pages", v_pages)]
    if scales is not None:
        want = tuple(k_pages.shape[:2])
        for name, t in zip(("k_scales", "v_scales"), scales):
            if t.device != dev or t.dtype != torch.float32:
                raise ValueError(f"{name} must be torch.float32 on {dev}, "
                                 f"got {t.dtype} on {t.device}")
            if tuple(t.shape) != want:
                raise ValueError(f"{name} must be (P, ps) = {want}, got "
                                 f"{tuple(t.shape)}")
            tensors.append((name, t))
    s = q.shape[0]
    for name, t, ndim in ints:
        if t.device != dev or t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if t.ndim != ndim or t.shape[0] != s or t.shape[-1] < 1:
            raise ValueError(f"{name} must be {ndim}-D with {s} rows, got "
                             f"{tuple(t.shape)}")
    for name, t in (*tensors, *((n, t) for n, t, _ in ints)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def paged_decode_cuda(q, k_pages, v_pages, block_tables, lengths, *,
                      scale: Optional[float] = None):
    _check_args(q, k_pages, v_pages,
                (("block_tables", block_tables, 2), ("lengths", lengths, 1)), 3)
    s_slots, h, dh = q.shape
    out = torch.empty_like(q)
    _launch("ptt_paged_decode", q.device, q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), s_slots, h, dh, k_pages.shape[1],
            block_tables.shape[1], k_pages.shape[0], _DTYPE_CODES[q.dtype],
            _scale(q, scale))
    DECODE.launches += 1
    return out


def paged_prefill_cuda(q, k_pages, v_pages, block_tables, chunk_starts,
                       n_valid, *, scale: Optional[float] = None):
    _check_args(q, k_pages, v_pages,
                (("block_tables", block_tables, 2),
                 ("chunk_starts", chunk_starts, 1),
                 ("n_valid", n_valid, 1)), 4)
    s_slots, c, h, dh = q.shape
    out = torch.empty_like(q)
    _launch("ptt_paged_prefill", q.device, q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_tables.data_ptr(),
            chunk_starts.data_ptr(), n_valid.data_ptr(), out.data_ptr(),
            s_slots, c, h, dh, k_pages.shape[1], block_tables.shape[1],
            k_pages.shape[0], _DTYPE_CODES[q.dtype], _scale(q, scale))
    PREFILL.launches += 1
    return out


def paged_decode_int8_cuda(q, k_pages, v_pages, k_scales, v_scales,
                           block_tables, lengths, *,
                           scale: Optional[float] = None):
    _check_args(q, k_pages, v_pages,
                (("block_tables", block_tables, 2), ("lengths", lengths, 1)), 3,
                scales=(k_scales, v_scales))
    s_slots, h, dh = q.shape
    out = torch.empty_like(q)
    _launch("ptt_paged_decode_int8", q.device, q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), k_scales.data_ptr(),
            v_scales.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), s_slots, h, dh, k_pages.shape[1],
            block_tables.shape[1], k_pages.shape[0], _DTYPE_CODES[q.dtype],
            _scale(q, scale))
    DECODE_INT8.launches += 1
    return out


def paged_prefill_int8_cuda(q, k_pages, v_pages, k_scales, v_scales,
                            block_tables, chunk_starts, n_valid, *,
                            scale: Optional[float] = None):
    _check_args(q, k_pages, v_pages,
                (("block_tables", block_tables, 2),
                 ("chunk_starts", chunk_starts, 1),
                 ("n_valid", n_valid, 1)), 4, scales=(k_scales, v_scales))
    s_slots, c, h, dh = q.shape
    out = torch.empty_like(q)
    _launch("ptt_paged_prefill_int8", q.device, q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), k_scales.data_ptr(),
            v_scales.data_ptr(), block_tables.data_ptr(),
            chunk_starts.data_ptr(), n_valid.data_ptr(), out.data_ptr(),
            s_slots, c, h, dh, k_pages.shape[1], block_tables.shape[1],
            k_pages.shape[0], _DTYPE_CODES[q.dtype], _scale(q, scale))
    PREFILL_INT8.launches += 1
    return out


# ---------------------------------------------------------------------------
# work of one call on its inputs (the roofline bound's numerator)
# ---------------------------------------------------------------------------

def _ids_bytes(n_pages_read: int, n_slots: int, n_scalars: int) -> int:
    return 4 * n_pages_read + 4 * n_slots * n_scalars


def _token_bytes(k_pages, scales) -> int:
    """Bytes one cached token costs per K (or V) read: its H x Dh page
    elements, plus its 4-byte scale in an int8 pool."""
    h, dh = k_pages.shape[2], k_pages.shape[3]
    return h * dh * k_pages.element_size() + (4 if scales else 0)


def _decode_work(q, k_pages, block_tables, lengths, scales):
    s_slots, h, dh = q.shape
    ps, w = k_pages.shape[1], block_tables.shape[1]
    n = np.clip(lengths.cpu().numpy().astype(np.int64), 0, w * ps)
    tok = int(n.sum())
    live_rows = int((n > 0).sum())
    nbytes = (live_rows * h * dh * q.element_size()
              + 2 * tok * _token_bytes(k_pages, scales)
              + _ids_bytes(int((-(-n // ps)).sum()), s_slots, 1)
              + q.numel() * q.element_size())
    return nbytes, 4 * tok * h * dh


def _prefill_work(q, k_pages, block_tables, chunk_starts, n_valid, scales):
    s_slots, c, h, dh = q.shape
    ps, w = k_pages.shape[1], block_tables.shape[1]
    st = chunk_starts.cpu().numpy().astype(np.int64)
    nv = np.clip(n_valid.cpu().numpy().astype(np.int64), 0, c)
    rows = int(nv.sum())
    horizon = np.where(nv > 0, np.minimum(st + nv, w * ps), 0)
    attended = 0
    for s0, n0 in zip(st, nv):
        r = np.arange(n0)
        attended += int(np.minimum(s0 + r + 1, w * ps).sum())
    nbytes = (rows * h * dh * q.element_size()
              + 2 * int(horizon.sum()) * _token_bytes(k_pages, scales)
              + _ids_bytes(int((-(-horizon // ps)).sum()), s_slots, 2)
              + q.numel() * q.element_size())
    return nbytes, 4 * attended * h * dh


def decode_work(q, k_pages, v_pages, block_tables, lengths, **_kw):
    """(bytes, flops) on these inputs: each live K/V element and live q
    row read once, the live block-table ids and lengths read once, the
    whole output written once; 4 flops per live (token, head, d)."""
    return _decode_work(q, k_pages, block_tables, lengths, False)


def prefill_work(q, k_pages, v_pages, block_tables, chunk_starts, n_valid,
                 **_kw):
    """(bytes, flops) on these inputs: K/V read once up to each slot's
    furthest horizon, live q rows read once, ids read once, the whole
    output written once; 4 flops per (live row, attended token, head,
    d)."""
    return _prefill_work(q, k_pages, block_tables, chunk_starts, n_valid,
                         False)


def decode_int8_work(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                     lengths, **_kw):
    """As :func:`decode_work`, with 1-byte K/V elements plus each live
    token's K and V scale (8 bytes a token)."""
    return _decode_work(q, k_pages, block_tables, lengths, True)


def prefill_int8_work(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                      chunk_starts, n_valid, **_kw):
    """As :func:`prefill_work`, with 1-byte K/V elements plus each read
    token's K and V scale."""
    return _prefill_work(q, k_pages, block_tables, chunk_starts, n_valid,
                         True)


DECODE = registry.register(registry.KernelEntry(
    name="ragged_paged_decode",
    route="cuda",
    source=_SOURCE,
    replaces="paddle_tpu/serving/decode_attention.py:265",
    cuda_fn=paged_decode_cuda,
    plain_fn=paged_decode_plain,
    reference_fn=paged_decode_reference,
    # fp32: the reference kernel contract's tolerance; bf16: the output
    # rounds to bf16, compared against the plain version run in fp32 on
    # the same bf16 inputs
    tolerance={torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-2, 1e-2)},
    work=decode_work))

PREFILL = registry.register(registry.KernelEntry(
    name="ragged_paged_prefill",
    route="cuda",
    source=_SOURCE,
    replaces="paddle_tpu/serving/decode_attention.py:443",
    cuda_fn=paged_prefill_cuda,
    plain_fn=paged_prefill_plain,
    reference_fn=paged_prefill_reference,
    tolerance={torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-2, 1e-2)},
    work=prefill_work))

# fp32: the reference's int8 kernel contract (decode_attention.py:1121 and
# :1156); bf16 q as for the fp kernels
_INT8_TOL = {torch.float32: (5e-5, 5e-5), torch.bfloat16: (1e-2, 1e-2)}

DECODE_INT8 = registry.register(registry.KernelEntry(
    name="ragged_paged_decode_int8",
    route="cuda",
    source=_SOURCE,
    replaces="paddle_tpu/serving/decode_attention.py:356",
    cuda_fn=paged_decode_int8_cuda,
    plain_fn=paged_decode_int8_plain,
    reference_fn=paged_decode_int8_reference,
    tolerance=_INT8_TOL,
    work=decode_int8_work))

PREFILL_INT8 = registry.register(registry.KernelEntry(
    name="ragged_paged_prefill_int8",
    route="cuda",
    source=_SOURCE,
    replaces="paddle_tpu/serving/decode_attention.py:533",
    cuda_fn=paged_prefill_int8_cuda,
    plain_fn=paged_prefill_int8_plain,
    reference_fn=paged_prefill_int8_reference,
    tolerance=_INT8_TOL,
    work=prefill_int8_work))


# ---------------------------------------------------------------------------
# public entry points: dispatch on the tensors' device
# ---------------------------------------------------------------------------

def _dispatch(entry: registry.KernelEntry, q, *args, scale):
    if q.device.type == "cuda":
        return entry.cuda_fn(q, *args, scale=scale)
    if q.device.type == "cpu":
        return entry.plain_fn(q, *args, scale=scale)
    raise ValueError(f"{entry.name}: unsupported device {q.device}")


def ragged_paged_decode_attention(q, k_pages, v_pages, block_tables,
                                  lengths, *, scale: Optional[float] = None):
    """One decode step of attention for every slot at once; returns
    (S, H, Dh) in ``q.dtype``. CUDA tensors launch the Hopper kernel;
    CPU tensors run the plain PyTorch version."""
    return _dispatch(DECODE, q, k_pages, v_pages, block_tables, lengths,
                     scale=scale)


def ragged_paged_prefill_attention(q, k_pages, v_pages, block_tables,
                                   chunk_starts, n_valid, *,
                                   scale: Optional[float] = None):
    """One batched chunked-prefill step of attention for every slot;
    returns (S, C, H, Dh) in ``q.dtype``. CUDA tensors launch the Hopper
    kernel; CPU tensors run the plain PyTorch version."""
    return _dispatch(PREFILL, q, k_pages, v_pages, block_tables,
                     chunk_starts, n_valid, scale=scale)


def ragged_paged_decode_int8_attention(q, k_pages, v_pages, k_scales,
                                       v_scales, block_tables, lengths, *,
                                       scale: Optional[float] = None):
    """Dequant-attend decode over an int8 page pool with fp32
    per-token-row scales (P, ps); returns (S, H, Dh) in ``q.dtype``. CUDA
    tensors launch the Hopper kernel; CPU tensors run the plain
    version."""
    return _dispatch(DECODE_INT8, q, k_pages, v_pages, k_scales, v_scales,
                     block_tables, lengths, scale=scale)


def ragged_paged_prefill_int8_attention(q, k_pages, v_pages, k_scales,
                                        v_scales, block_tables, chunk_starts,
                                        n_valid, *,
                                        scale: Optional[float] = None):
    """Dequant-attend batched chunked prefill over an int8 page pool
    (also the speculative verify step's attention); returns (S, C, H,
    Dh) in ``q.dtype``. CUDA tensors launch the Hopper kernel; CPU
    tensors run the plain version."""
    return _dispatch(PREFILL_INT8, q, k_pages, v_pages, k_scales, v_scales,
                     block_tables, chunk_starts, n_valid, scale=scale)
