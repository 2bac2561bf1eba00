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
dense per-row numpy reference. The public functions reach them through
registered ops (``torch.ops.ptt.paged_decode``, ``paged_prefill``,
``paged_decode_int8``, ``paged_prefill_int8``), which dispatch on the
tensors' device: a CUDA tensor launches the kernel or raises, a CPU
tensor runs the plain version; there is no fallback between the two.
On fake tensors (the analysis tiers' traces) each call is one node.

``ragged_paged_*_tp_attention`` — the tensor-parallel entry points
(registered as :class:`~paddle_tpu_torch.kernels.registry.CompositeEntry`, no
kernel of their own): the same four on one rank's ``H/tp`` heads of q and
of the pool, under a mesh. Heads are independent, so a rank's output is
the tp=1 kernel's on those heads.

Scale: scores are scaled in fp32 after the dot, in the plain version
and in the kernel alike (the reference's lax fallback; its Pallas
wrapper scaled ``q`` in ``q.dtype`` instead).

Launch configuration (each entry's :class:`~paddle_tpu_torch.kernels.
registry.KernelContract`; the reference tunes ``pages_per_block``, which
has no counterpart in these designs): one candidate each, the warps a
block that ``csrc/paged_attention.cu`` fixes at compile time (decode 8,
``kDecWarps``; the tensor-core prefills 8 for K3, ``kFpPreWarps``, and 4
for K4, ``kInt8PreWarps``). The contracts declare them so that the
tuner and the registry lint have them to check; a wrapper's ``blocks=``
may only name that one configuration, and no call looks the tuner up.
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
                      scale: Optional[float] = None, blocks=None):
    _check_args(q, k_pages, v_pages,
                (("block_tables", block_tables, 2), ("lengths", lengths, 1)), 3)
    if blocks is not None:        # the kernel fixes its warps
        DECODE.blocks_for((q, k_pages, v_pages, block_tables, lengths), blocks)
    s_slots, h, dh = q.shape
    out = torch.empty_like(q)
    _launch("ptt_paged_decode", q.device, q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), s_slots, h, dh, k_pages.shape[1],
            block_tables.shape[1], k_pages.shape[0], _DTYPE_CODES[q.dtype],
            _scale(q, scale))
    DECODE.note_launch()
    return out


def paged_prefill_cuda(q, k_pages, v_pages, block_tables, chunk_starts,
                       n_valid, *, scale: Optional[float] = None,
                       blocks=None):
    _check_args(q, k_pages, v_pages,
                (("block_tables", block_tables, 2),
                 ("chunk_starts", chunk_starts, 1),
                 ("n_valid", n_valid, 1)), 4)
    if blocks is not None:        # the kernel fixes its warps
        PREFILL.blocks_for((q, k_pages, v_pages, block_tables, chunk_starts,
                            n_valid), blocks)
    s_slots, c, h, dh = q.shape
    out = torch.empty_like(q)
    _launch("ptt_paged_prefill", q.device, q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_tables.data_ptr(),
            chunk_starts.data_ptr(), n_valid.data_ptr(), out.data_ptr(),
            s_slots, c, h, dh, k_pages.shape[1], block_tables.shape[1],
            k_pages.shape[0], _DTYPE_CODES[q.dtype], _scale(q, scale))
    PREFILL.note_launch()
    return out


def paged_decode_int8_cuda(q, k_pages, v_pages, k_scales, v_scales,
                           block_tables, lengths, *,
                           scale: Optional[float] = None, blocks=None):
    _check_args(q, k_pages, v_pages,
                (("block_tables", block_tables, 2), ("lengths", lengths, 1)), 3,
                scales=(k_scales, v_scales))
    if blocks is not None:        # the kernel fixes its warps
        DECODE_INT8.blocks_for((q, k_pages, v_pages, k_scales, v_scales,
                                block_tables, lengths), blocks)
    s_slots, h, dh = q.shape
    out = torch.empty_like(q)
    _launch("ptt_paged_decode_int8", q.device, q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), k_scales.data_ptr(),
            v_scales.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), s_slots, h, dh, k_pages.shape[1],
            block_tables.shape[1], k_pages.shape[0], _DTYPE_CODES[q.dtype],
            _scale(q, scale))
    DECODE_INT8.note_launch()
    return out


def paged_prefill_int8_cuda(q, k_pages, v_pages, k_scales, v_scales,
                            block_tables, chunk_starts, n_valid, *,
                            scale: Optional[float] = None, blocks=None):
    _check_args(q, k_pages, v_pages,
                (("block_tables", block_tables, 2),
                 ("chunk_starts", chunk_starts, 1),
                 ("n_valid", n_valid, 1)), 4, scales=(k_scales, v_scales))
    if blocks is not None:        # the kernel fixes its warps
        PREFILL_INT8.blocks_for((q, k_pages, v_pages, k_scales, v_scales,
                                 block_tables, chunk_starts, n_valid), blocks)
    s_slots, c, h, dh = q.shape
    out = torch.empty_like(q)
    _launch("ptt_paged_prefill_int8", q.device, q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), k_scales.data_ptr(),
            v_scales.data_ptr(), block_tables.data_ptr(),
            chunk_starts.data_ptr(), n_valid.data_ptr(), out.data_ptr(),
            s_slots, c, h, dh, k_pages.shape[1], block_tables.shape[1],
            k_pages.shape[0], _DTYPE_CODES[q.dtype], _scale(q, scale))
    PREFILL_INT8.note_launch()
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
    w = block_tables.shape[1]
    return _decode_work_of(q, k_pages, w, lengths.cpu().numpy(), scales)


def _decode_work_of(q, k_pages, w, lengths, scales):
    s_slots, h, dh = q.shape
    ps = k_pages.shape[1]
    n = np.clip(np.asarray(lengths, np.int64), 0, w * ps)
    tok = int(n.sum())
    live_rows = int((n > 0).sum())
    nbytes = (live_rows * h * dh * q.element_size()
              + 2 * tok * _token_bytes(k_pages, scales)
              + _ids_bytes(int((-(-n // ps)).sum()), s_slots, 1)
              + q.numel() * q.element_size())
    return nbytes, 4 * tok * h * dh


def _prefill_work(q, k_pages, block_tables, chunk_starts, n_valid, scales):
    w = block_tables.shape[1]
    return _prefill_work_of(q, k_pages, w, chunk_starts.cpu().numpy(),
                            n_valid.cpu().numpy(), scales)


def _prefill_work_of(q, k_pages, w, chunk_starts, n_valid, scales):
    s_slots, c, h, dh = q.shape
    ps = k_pages.shape[1]
    st = np.asarray(chunk_starts, np.int64)
    nv = np.clip(np.asarray(n_valid, np.int64), 0, c)
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


def _full_decode(q, k_pages, block_tables, scales):
    s_slots, w = block_tables.shape
    return _decode_work_of(q, k_pages, w,
                           np.full(s_slots, w * k_pages.shape[1]), scales)


def _full_prefill(q, k_pages, block_tables, scales):
    s_slots, c = q.shape[:2]
    w = block_tables.shape[1]
    start = max(w * k_pages.shape[1] - c, 0)
    return _prefill_work_of(q, k_pages, w, np.full(s_slots, start),
                            np.full(s_slots, c), scales)


def decode_static_work(q, k_pages, v_pages, block_tables, lengths, **_kw):
    """(bytes, flops) from shapes alone (fake tensors too): every slot
    live over every block-table column, ``w * page_size`` tokens. The
    cost tier's count; :func:`decode_work` reads the live lengths."""
    return _full_decode(q, k_pages, block_tables, False)


def prefill_static_work(q, k_pages, v_pages, block_tables, chunk_starts,
                        n_valid, **_kw):
    """(bytes, flops) from shapes alone: every lane of every slot valid,
    the chunk ending at the last block-table column."""
    return _full_prefill(q, k_pages, block_tables, False)


def decode_int8_static_work(q, k_pages, v_pages, k_scales, v_scales,
                            block_tables, lengths, **_kw):
    """As :func:`decode_static_work` over an int8 pool."""
    return _full_decode(q, k_pages, block_tables, True)


def prefill_int8_static_work(q, k_pages, v_pages, k_scales, v_scales,
                             block_tables, chunk_starts, n_valid, **_kw):
    """As :func:`prefill_static_work` over an int8 pool."""
    return _full_prefill(q, k_pages, block_tables, True)


# ---------------------------------------------------------------------------
# contracts: samples, tuning keys, tunables and shared memory
# ---------------------------------------------------------------------------

def _make_sample(seed, *, chunked):
    """The reference's ``_make_paged_sample`` (the same numpy draws, so
    the same inputs for the same seed), as float32 CPU tensors."""
    s_slots, h, dh, ps, mp = (
        (4, 2, 16, 8, 3), (6, 4, 32, 16, 4), (8, 4, 64, 16, 6))[seed % 3]
    c = ps  # prefill chunk = one page of queries
    num_pages = s_slots * mp + 1
    rng = np.random.default_rng(seed)
    k_pages = rng.standard_normal((num_pages, ps, h, dh)).astype(np.float32)
    v_pages = rng.standard_normal((num_pages, ps, h, dh)).astype(np.float32)
    perm = rng.permutation(num_pages - 1)[:s_slots * mp] + 1
    block_tables = perm.reshape(s_slots, mp).astype(np.int32)
    if not chunked:
        q = rng.standard_normal((s_slots, h, dh)).astype(np.float32)
        lengths = rng.integers(0, mp * ps + 1, s_slots).astype(np.int32)
        arrays = (q, k_pages, v_pages, block_tables, lengths)
    else:
        q = rng.standard_normal((s_slots, c, h, dh)).astype(np.float32)
        starts = rng.integers(0, (mp - 1) * ps, s_slots).astype(np.int32)
        n_valid = rng.integers(0, c + 1, s_slots).astype(np.int32)
        arrays = (q, k_pages, v_pages, block_tables, starts, n_valid)
    return tuple(torch.from_numpy(a) for a in arrays), {}


def _make_int8_sample(seed, *, chunked):
    """The fp sample's pages quantized per token row through
    :func:`~paddle_tpu_torch.serving.paged_cache.quantize_kv`, as the
    reference's ``_make_paged_int8_sample`` does."""
    from paddle_tpu_torch.serving.paged_cache import quantize_kv
    args, kwargs = _make_sample(seed, chunked=chunked)
    q, k_pages, v_pages = args[:3]
    kq, ks = quantize_kv(k_pages, (2, 3))            # scales (P, ps)
    vq, vs = quantize_kv(v_pages, (2, 3))
    return (q, kq, vq, ks, vs) + args[3:], kwargs


def _tune_signature(args, bt_index):
    """The reference's ``_paged_tune_signature``: slots, (chunk), heads,
    head dim, page size, block-table width."""
    q, k_pages, bt = args[0], args[1], args[bt_index]
    sig = [("s", q.shape[0]), ("h", k_pages.shape[2]),
           ("d", q.shape[-1]), ("ps", k_pages.shape[1]),
           ("mp", bt.shape[1])]
    if q.ndim == 4:                      # prefill: chunk width matters
        sig.insert(1, ("c", q.shape[1]))
    return tuple(sig)


#: the csrc/paged_attention.cu constants the estimates below mirror
_MAX_HEAD_DIM, _KEY_TILE, _STAGES = 256, 64, 2


def _decode_smem(args, blocks):
    """Static shared memory of one decode block: each warp's m, l and
    accumulator row."""
    return blocks["warps"] * (8 + 4 * _MAX_HEAD_DIM)


def _prefill_smem(args, blocks):
    """Dynamic shared memory of one tensor-core prefill block
    (``PrefillSmem<KV, NK, NW>::BYTES`` plus the page ids); the scalar
    template (fp32 q, Dh > 128, tables past 8192 columns) takes none."""
    q, k_pages = args[0], args[1]
    dh, w = q.shape[-1], args[-3].shape[1]
    if q.dtype != torch.bfloat16 or dh > 128 or w > 8192:
        return 0
    quant = k_pages.dtype == torch.int8
    dp = 16 * -(-dh // 16)
    rs = dp * k_pages.element_size() + 16
    scales = 2 * _KEY_TILE * 4 if quant else 0
    stage = 2 * _KEY_TILE * rs + scales
    nbytes = _STAGES * stage
    if quant:
        nbytes += _KEY_TILE * (dp + 8) * 2 + dp * (_KEY_TILE + 8) * 2 + scales
    return nbytes + (4 * w + 15) // 16 * 16


#: warps a block, fixed in csrc/paged_attention.cu: decode (kDecWarps),
#: K3's and K4's tensor-core prefill (kFpPreWarps, kInt8PreWarps)
DECODE_TUNABLES = {"warps": (8,)}
PREFILL_TUNABLES = {"warps": (8,)}
PREFILL_INT8_TUNABLES = {"warps": (4,)}

_DECODE_LAYOUT = {"q": "(S,H,Dh)", "k_pages": "(P,ps,H,Dh)",
                  "v_pages": "(P,ps,H,Dh)", "block_tables": "(S,mp) i32",
                  "lengths": "(S,) i32"}
_PREFILL_LAYOUT = {"q": "(S,C,H,Dh)", "k_pages": "(P,ps,H,Dh)",
                   "v_pages": "(P,ps,H,Dh)", "block_tables": "(S,mp) i32",
                   "chunk_starts": "(S,) i32", "n_valid": "(S,) i32"}
_SCALES_LAYOUT = {"k_scales": "(P,ps) f32", "v_scales": "(P,ps) f32"}


def _int8_layout(layout):
    out = {"q": layout["q"], "k_pages": "(P,ps,H,Dh) i8",
           "v_pages": "(P,ps,H,Dh) i8", **_SCALES_LAYOUT}
    out.update((k, v) for k, v in layout.items() if k not in out)
    return out


def _contract(symbol, layout, out_layout, tunables, prior):
    return registry.KernelContract(
        version=1, arg_layouts=layout, out_layout=out_layout,
        symbols={symbol: _SIGNATURES[symbol]},
        candidates=lambda args: tunables, prior=lambda args: dict(prior))


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
    work=decode_work,
    static_work=decode_static_work,
    contract=_contract("ptt_paged_decode", _DECODE_LAYOUT, "(S,H,Dh)",
                       DECODE_TUNABLES, {"warps": 8}),
    sample_inputs=lambda seed: _make_sample(seed, chunked=False),
    tune_signature=lambda args: _tune_signature(args, 3),
    smem=_decode_smem))

PREFILL = registry.register(registry.KernelEntry(
    name="ragged_paged_prefill",
    route="cuda",
    source=_SOURCE,
    replaces="paddle_tpu/serving/decode_attention.py:443",
    cuda_fn=paged_prefill_cuda,
    plain_fn=paged_prefill_plain,
    reference_fn=paged_prefill_reference,
    tolerance={torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-2, 1e-2)},
    work=prefill_work,
    static_work=prefill_static_work,
    contract=_contract("ptt_paged_prefill", _PREFILL_LAYOUT, "(S,C,H,Dh)",
                       PREFILL_TUNABLES, {"warps": 8}),
    sample_inputs=lambda seed: _make_sample(seed, chunked=True),
    tune_signature=lambda args: _tune_signature(args, 3),
    smem=_prefill_smem))

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
    work=decode_int8_work,
    static_work=decode_int8_static_work,
    contract=_contract("ptt_paged_decode_int8", _int8_layout(_DECODE_LAYOUT),
                       "(S,H,Dh)", DECODE_TUNABLES, {"warps": 8}),
    sample_inputs=lambda seed: _make_int8_sample(seed, chunked=False),
    tune_signature=lambda args: _tune_signature(args, 5),
    smem=_decode_smem))

PREFILL_INT8 = registry.register(registry.KernelEntry(
    name="ragged_paged_prefill_int8",
    route="cuda",
    source=_SOURCE,
    replaces="paddle_tpu/serving/decode_attention.py:533",
    cuda_fn=paged_prefill_int8_cuda,
    plain_fn=paged_prefill_int8_plain,
    reference_fn=paged_prefill_int8_reference,
    tolerance=_INT8_TOL,
    work=prefill_int8_work,
    static_work=prefill_int8_static_work,
    contract=_contract("ptt_paged_prefill_int8",
                       _int8_layout(_PREFILL_LAYOUT), "(S,C,H,Dh)",
                       PREFILL_INT8_TUNABLES, {"warps": 4}),
    sample_inputs=lambda seed: _make_int8_sample(seed, chunked=True),
    tune_signature=lambda args: _tune_signature(args, 5),
    smem=_prefill_smem))


# ---------------------------------------------------------------------------
# the kernels as registered ops: dispatch on the tensors' device
# ---------------------------------------------------------------------------

def _dispatch(entry: registry.KernelEntry, q, *args, scale):
    if q.device.type == "cuda":
        return entry.cuda_fn(q, *args, scale=scale)
    if q.device.type == "cpu":
        return entry.plain_fn(q, *args, scale=scale)
    raise ValueError(f"{entry.name}: unsupported device {q.device}")


# K1-K4 as ``torch.ops.ptt.paged_*``: a trace on fake tensors (the
# analysis tiers) records each call as one node, its fake giving the
# output's shape; a real call dispatches as above. Defined through
# ``torch.library.Library`` rather than ``custom_op``, whose kernels
# import ``torch._dynamo`` on their first call (seconds of a serving
# engine's warmup, measured by ``chip_ab.py``).

_LIB = torch.library.Library("ptt", "FRAGMENT")
_OP_SCHEMAS = (
    (DECODE, "paged_decode(Tensor q, Tensor k_pages, Tensor v_pages, "
            "Tensor block_tables, Tensor lengths, float? scale) -> Tensor"),
    (PREFILL, "paged_prefill(Tensor q, Tensor k_pages, Tensor v_pages, "
             "Tensor block_tables, Tensor chunk_starts, Tensor n_valid, "
             "float? scale) -> Tensor"),
    (DECODE_INT8, "paged_decode_int8(Tensor q, Tensor k_pages, "
                 "Tensor v_pages, Tensor k_scales, Tensor v_scales, "
                 "Tensor block_tables, Tensor lengths, float? scale) "
                 "-> Tensor"),
    (PREFILL_INT8, "paged_prefill_int8(Tensor q, Tensor k_pages, "
                  "Tensor v_pages, Tensor k_scales, Tensor v_scales, "
                  "Tensor block_tables, Tensor chunk_starts, "
                  "Tensor n_valid, float? scale) -> Tensor"),
)


def _kernel(entry: registry.KernelEntry):
    def run(q, *args):
        *args, scale = args
        return _dispatch(entry, q, *args, scale=scale)
    return run


def _fake_out(q, *_args):
    return torch.empty_like(q)


for _entry, _schema in _OP_SCHEMAS:
    _name = _schema.split("(", 1)[0]
    _LIB.define(_schema)
    for _key in ("CPU", "CUDA"):
        _LIB.impl(_name, _kernel(_entry), _key)
    torch.library.register_fake(f"ptt::{_name}", _fake_out, lib=_LIB)


def _op_call(entry: registry.KernelEntry, op, q, *args):
    """``op(q, *args)``, refusing a device the kernels do not serve before
    the dispatcher would take a meta tensor to the fake."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{entry.name}: unsupported device {q.device}")
    return op(q, *args)


#: registry entry name -> the node name its op gets in a trace
OPS = {DECODE.name: "ptt.paged_decode", PREFILL.name: "ptt.paged_prefill",
       DECODE_INT8.name: "ptt.paged_decode_int8",
       PREFILL_INT8.name: "ptt.paged_prefill_int8"}


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def ragged_paged_decode_attention(q, k_pages, v_pages, block_tables,
                                  lengths, *, scale: Optional[float] = None):
    """One decode step of attention for every slot at once; returns
    (S, H, Dh) in ``q.dtype``. CUDA tensors launch the Hopper kernel;
    CPU tensors run the plain PyTorch version."""
    return _op_call(DECODE, torch.ops.ptt.paged_decode, q, k_pages, v_pages,
                    block_tables, lengths, scale)


def ragged_paged_prefill_attention(q, k_pages, v_pages, block_tables,
                                   chunk_starts, n_valid, *,
                                   scale: Optional[float] = None):
    """One batched chunked-prefill step of attention for every slot;
    returns (S, C, H, Dh) in ``q.dtype``. CUDA tensors launch the Hopper
    kernel; CPU tensors run the plain PyTorch version."""
    return _op_call(PREFILL, torch.ops.ptt.paged_prefill, q, k_pages, v_pages,
                    block_tables, chunk_starts, n_valid, scale)


def ragged_paged_decode_int8_attention(q, k_pages, v_pages, k_scales,
                                       v_scales, block_tables, lengths, *,
                                       scale: Optional[float] = None):
    """Dequant-attend decode over an int8 page pool with fp32
    per-token-row scales (P, ps); returns (S, H, Dh) in ``q.dtype``. CUDA
    tensors launch the Hopper kernel; CPU tensors run the plain
    version."""
    return _op_call(DECODE_INT8, torch.ops.ptt.paged_decode_int8, q, k_pages,
                    v_pages, k_scales, v_scales, block_tables, lengths, scale)


def ragged_paged_prefill_int8_attention(q, k_pages, v_pages, k_scales,
                                        v_scales, block_tables, chunk_starts,
                                        n_valid, *,
                                        scale: Optional[float] = None):
    """Dequant-attend batched chunked prefill over an int8 page pool
    (also the speculative verify step's attention); returns (S, C, H,
    Dh) in ``q.dtype``. CUDA tensors launch the Hopper kernel; CPU
    tensors run the plain version."""
    return _op_call(PREFILL_INT8, torch.ops.ptt.paged_prefill_int8, q, k_pages,
                    v_pages, k_scales, v_scales, block_tables, chunk_starts,
                    n_valid, scale)


# ---------------------------------------------------------------------------
# tensor-parallel entry points: K1-K4 on this rank's head slice
# ---------------------------------------------------------------------------

def _tp_entry(name, inner_fn):
    """The ``name`` entry point: ``inner_fn`` on this rank's ``H/tp``
    heads of ``q`` and of the page pool (block tables, lengths and chunk
    geometry whole, int8 scale rows whole), under a mesh."""
    def fn(q, k_pages, v_pages, *rest, scale: Optional[float] = None,
           mesh=None):
        from paddle_tpu_torch.core import mesh as mesh_lib
        if (mesh or mesh_lib.current_mesh()) is None:
            raise ValueError(f"{name} requires a mesh (pass mesh= or "
                             "enter mesh_context)")
        if q.shape[-2] != k_pages.shape[2]:
            raise ValueError(
                f"{name}: q holds {q.shape[-2]} heads, the local pool "
                f"{k_pages.shape[2]}: pass this rank's head slice of both")
        return inner_fn(q, k_pages, v_pages, *rest, scale=scale)
    fn.__name__ = name
    fn.__qualname__ = name
    return fn


def _tp_layout(layout):
    """An inner layout annotated per argument as the reference's tp
    contracts write it: the head axis split (``H/tp``), scale rows
    replicated."""
    out = {}
    for k, v in layout.items():
        if ",H," in v:
            out[k] = v + " H/tp"
        elif k.endswith("_scales"):
            out[k] = v + " replicated"
        else:
            out[k] = v
    return out


def _register_tp(name, inner: registry.KernelEntry, public):
    return registry.register_composite(registry.CompositeEntry(
        name=name, inner=(inner.name,),
        arg_layouts=_tp_layout(inner.contract.arg_layouts),
        out_layout=inner.contract.out_layout + " H/tp",
        fn=_tp_entry(name, public),
        plain_fn=_tp_entry(name + "_plain", inner.plain_fn),
        sample_inputs=inner.sample_inputs))


ragged_paged_decode_tp_attention = _register_tp(
    "ragged_paged_decode_tp", DECODE, ragged_paged_decode_attention).fn
ragged_paged_prefill_tp_attention = _register_tp(
    "ragged_paged_prefill_tp", PREFILL, ragged_paged_prefill_attention).fn
ragged_paged_decode_int8_tp_attention = _register_tp(
    "ragged_paged_decode_int8_tp", DECODE_INT8,
    ragged_paged_decode_int8_attention).fn
ragged_paged_prefill_int8_tp_attention = _register_tp(
    "ragged_paged_prefill_int8_tp", PREFILL_INT8,
    ragged_paged_prefill_int8_attention).fn
