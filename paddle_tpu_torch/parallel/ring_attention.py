"""Ring attention over the "sp" mesh axis
(``paddle_tpu/parallel/ring_attention.py``).

Each rank holds one block of the sequence: its ``(B, H, S/sp, D)``
queries, keys and values, block ``i`` on sp rank ``i``. The keys and
values travel the ring (``collective.ppermute`` to the next rank), and
each rank folds every visiting block into its queries' attention. The
reference puts a ``shard_map`` around the same body; here each rank
calls :func:`ring_attention` with its own blocks.

Two bodies, as in the reference:

- the composed path (``impl="xla"``): fp32 score blocks merged with the
  online-softmax recurrence (:func:`_block_update`), differentiated by
  autograd through the rotations (:class:`_Rotate`, whose transpose is
  the reverse rotation);
- the flash ring (``impl="flash"``): one ``torch.autograd.Function`` per
  rank (:class:`_RingFlash`). Its forward runs K5 (``flash_fwd_cuda``) on
  each visiting block, which returns the block's normalised output and
  its logsumexp, and merges blocks with the logaddexp recurrence. Its
  backward sends k/v round the ring again together with their fp32
  dk/dv accumulators, and runs K6a/K6b (``flash_bwd_dkv_cuda``,
  ``flash_bwd_dq_cuda``) on each block against the *global* lse and
  ``delta = rowsum(do * out)`` of the merged output, so the recomputed
  probabilities are the merged forward's. With ``causal`` a block is one
  of three cases (:func:`_ring_flash_case`): the diagonal block runs the
  kernels with their own causal mask (Sq == Sk, so its bottom-right mask
  is the global one there), a block of earlier keys runs them unmasked,
  and a block of later keys launches nothing.

On CPU tensors the flash ring runs the kernels' plain versions
(``flash_fwd_plain``, ``_flash_bwd_parts``); on CUDA tensors it launches
the kernels or raises. ``impl="auto"`` follows ``dot_product_attention``
(fault F1): a head dim up to 128 outside the kernels' head dims is
zero-padded to the next one, a larger head dim or another dtype than
fp32/bf16 takes the composed path. A key-padding bias ``(B, 1, 1,
S/sp)`` rotates with k and is a constant on every impl (its gradient is
not taken), as in the reference.

On a gloo mesh of one card the rotations need the mesh's explicit
``stage_cuda_through_host`` switch (``core/mesh.py``); the kernels run on
the card either way. The ``ring_attention`` entry of the kernel registry
(:data:`RING`) has no kernel of its own and reuses K5/K6.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import mesh as mesh_lib
from paddle_tpu_torch.kernels import registry
from paddle_tpu_torch.ops import attention as A
from paddle_tpu_torch.ops.attention import NEG_INF
from paddle_tpu_torch.parallel import collective

IMPLS = ("auto", "flash", "xla", "plain")

#: the causal cases of a visiting block (the reference's switch indices)
DIAGONAL, VISIBLE, SKIPPED = 0, 1, 2
CASE_NAMES = ("diagonal", "visible", "skipped")

_cases: "collections.Counter[tuple]" = collections.Counter()


def ring_stats() -> Dict[str, Dict[str, int]]:
    """Visiting blocks by case since the last reset, per direction:
    ``{"fwd": {"diagonal": n, "visible": n, "skipped": n}, "bwd": ...}``
    (a non-causal block counts as visible)."""
    return {d: {c: _cases[(d, c)] for c in CASE_NAMES}
            for d in ("fwd", "bwd")}


def reset_ring_stats():
    _cases.clear()


def _ring_flash_case(idx: int, src: int) -> int:
    """0 = diagonal block (causal mask inside), 1 = fully visible, 2 =
    fully masked (skip)."""
    return DIAGONAL if src == idx else (VISIBLE if src < idx else SKIPPED)


def _perm(n: int, reverse: bool = False):
    return [((i + 1) % n, i) if reverse else (i, (i + 1) % n)
            for i in range(n)]


def _rot(x, mesh, axis, reverse=False):
    if x is None:
        return None
    n = mesh_lib.axis_size(mesh, axis)
    return collective.ppermute(x, axis, _perm(n, reverse), mesh=mesh)


class _Rotate(torch.autograd.Function):
    """One hop of the ring for several tensors; the transpose is the hop
    the other way."""

    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        ctx.mesh, ctx.axis = mesh, axis
        return tuple(_rot(x, mesh, axis) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + tuple(
            _rot(g.contiguous(), ctx.mesh, ctx.axis, reverse=True)
            for g in gs)


# ---------------------------------------------------------------------------
# composed path
# ---------------------------------------------------------------------------

def _block_update(carry, kv, *, scale, causal, q_offset, k_offset):
    """One online-softmax step: fold the (k, v[, bias]) block into
    (m, l, acc). ``q_offset``/``k_offset`` are the global start positions
    of the local q block and the visiting k block (causal masking)."""
    m_prev, l_prev, acc = carry
    q, k, v, bias = kv
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        row = q_offset + torch.arange(sq, device=q.device)[:, None]
        col = k_offset + torch.arange(sk, device=q.device)[None, :]
        s = torch.where(col <= row, s, torch.full_like(s, NEG_INF))
    m_cur = s.amax(dim=-1, keepdim=True)
    m_next = torch.maximum(m_prev, m_cur)
    alpha = torch.exp(m_prev - m_next)
    p = torch.exp(s - m_next)
    l_next = l_prev * alpha + p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return m_next, l_next, acc * alpha + pv


def _ring_attention_local(q, k, v, bias, *, mesh, axis, scale, causal):
    """The composed body on this rank's blocks (B, H, Sl, D)."""
    n = mesh_lib.axis_size(mesh, axis)
    idx = mesh_lib.axis_index(mesh, axis)
    b, h, sl, d = q.shape
    q32 = q.float()
    m = torch.full((b, h, sl, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sl, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sl, d), dtype=torch.float32, device=q.device)
    for i in range(n):
        src = (idx - i) % n          # the held block came from here
        m, l, acc = _block_update((m, l, acc), (q32, k, v, bias),
                                  scale=scale, causal=causal,
                                  q_offset=idx * sl, k_offset=src * sl)
        if i < n - 1:                # the last hop would be dead
            k, v = _Rotate.apply(mesh, axis, k.contiguous(), v.contiguous())
            bias = _rot(bias, mesh, axis)
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / denom).to(q.dtype)


# ---------------------------------------------------------------------------
# the flash ring: K5 per visiting block, K6a/K6b against the global lse
# ---------------------------------------------------------------------------

def _fwd_block(q, k, v, bias, case, scale, kernels):
    fn = A.flash_fwd_cuda if kernels else A.flash_fwd_plain
    return fn(q, k, v, bias, causal=case == DIAGONAL, scale=scale)


def _bwd_block(q, k, v, bias, g, lse, delta, case, scale, kernels):
    causal = case == DIAGONAL
    if kernels:
        args = (q, k, v, bias, g, lse, delta)
        dk, dv = A.flash_bwd_dkv_cuda(*args, causal=causal, scale=scale)
        return A.flash_bwd_dq_cuda(*args, causal=causal, scale=scale), dk, dv
    return A._flash_bwd_parts(q, k, v, bias, g, lse, delta, causal=causal,
                              scale=scale)


class _RingFlash(torch.autograd.Function):
    """The per-rank flash ring (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mesh, axis, scale, causal, kernels):
        q, k, v = (t.contiguous() for t in (q, k, v))
        n = mesh_lib.axis_size(mesh, axis)
        idx = mesh_lib.axis_index(mesh, axis)
        b, h, sl, d = q.shape
        out = torch.zeros((b, h, sl, d), dtype=torch.float32,
                          device=q.device)
        lse = torch.full((b, h, sl), NEG_INF, dtype=torch.float32,
                         device=q.device)
        kc, vc, bc = k, v, bias
        for i in range(n):
            case = _ring_flash_case(idx, (idx - i) % n) if causal \
                else VISIBLE
            _cases[("fwd", CASE_NAMES[case])] += 1
            if case != SKIPPED:      # a skipped block leaves (out, lse)
                o_blk, lse_blk = _fwd_block(q, kc, vc, bc, case, scale,
                                            kernels)
                lse_new = torch.logaddexp(lse, lse_blk)
                # rows still fully masked: both weights would be garbage
                alive = lse_new > NEG_INF / 2
                w_old = torch.where(alive, torch.exp(lse - lse_new), 0.0)
                w_blk = torch.where(alive, torch.exp(lse_blk - lse_new), 0.0)
                out = out * w_old[..., None] \
                    + o_blk.float() * w_blk[..., None]
                lse = lse_new
            if i < n - 1:
                kc, vc, bc = (_rot(t, mesh, axis) for t in (kc, vc, bc))
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.mesh, ctx.axis, ctx.scale = mesh, axis, scale
        ctx.causal, ctx.kernels = causal, kernels
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        mesh, axis, scale = ctx.mesh, ctx.axis, ctx.scale
        n = mesh_lib.axis_size(mesh, axis)
        idx = mesh_lib.axis_index(mesh, axis)
        g = g.contiguous()
        # the merged output's delta, never a block's own
        delta = A.flash_delta(g, out)
        # fp32 accumulators: rounding each ring step's partial to the
        # input dtype would degrade the gradients as sp grows
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        kc, vc, bc = k, v, bias
        for i in range(n):
            case = _ring_flash_case(idx, (idx - i) % n) if ctx.causal \
                else VISIBLE
            _cases[("bwd", CASE_NAMES[case])] += 1
            if case != SKIPPED:
                dq_b, dk_b, dv_b = _bwd_block(q, kc, vc, bc, g, lse, delta,
                                              case, scale, ctx.kernels)
                dq += dq_b.float()
                dk += dk_b.float()
                dv += dv_b.float()
            # the accumulators travel with their block: after n hops they
            # are home; k/v need no last hop
            if i < n - 1:
                kc, vc, bc = (_rot(t, mesh, axis) for t in (kc, vc, bc))
            dk, dv = _rot(dk, mesh, axis), _rot(dv, mesh, axis)
        dbias = (torch.zeros_like(bias)
                 if bias is not None and ctx.needs_input_grad[3] else None)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias,
                None, None, None, None, None)


def _flash_ring(q, k, v, bias, *, mesh, axis, scale, causal, kernels):
    return _RingFlash.apply(q, k, v, bias, mesh, axis, scale, causal,
                            kernels)


def _use_kernels(q, impl: str) -> bool:
    if impl == "plain" or q.device.type == "cpu":
        return False
    if q.device.type == "cuda":
        return True
    raise ValueError(f"ring_attention: unsupported device {q.device}")


def ring_attention(q, k, v, *, bias=None, causal: bool = False,
                   scale: Optional[float] = None, axis: str = mesh_lib.SP,
                   mesh=None, impl: str = "auto"):
    """Sequence-parallel attention on this rank's blocks: q, k, v
    ``(B, H, S/sp, D)``, block ``i`` of the sequence on rank ``i`` of
    ``axis``; ``bias`` an optional key-padding bias ``(B, 1, 1, S/sp)``
    of the same block. Returns this rank's ``(B, H, S/sp, D)`` output.

    ``impl``: "flash" (K5/K6 per visiting block on CUDA tensors, their
    plain versions on CPU tensors), "plain" (the plain block functions on
    any device), "xla" (the composed online-softmax path), "auto" (the
    flash ring, with F1's head-dim padding; the composed path for a head
    dim over 128 or a dtype the kernels do not take). Needs ``mesh`` (or
    the ambient ``mesh_context``). ``bias`` is a constant on every impl."""
    mesh = mesh if mesh is not None else mesh_lib.current_mesh()
    if mesh is None:
        raise ValueError("ring_attention requires a mesh "
                         "(use mesh_context or pass mesh=)")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} "
                         f"(expected {'|'.join(IMPLS)})")
    RING.note_call()
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    if bias is not None:
        bias = A._bias4(bias).detach()
    kw = dict(mesh=mesh, axis=axis, scale=scale, causal=bool(causal))
    kernel_d = A.kernel_head_dim(d)
    if impl == "xla" or impl == "auto" and (
            kernel_d is None or q.dtype not in A._DTYPE_CODES):
        return _ring_attention_local(q, k, v, bias, **kw)
    kernels = _use_kernels(q, impl)
    if impl == "auto" and kernel_d != d:
        pad = (0, kernel_d - d)
        out = _flash_ring(*(F.pad(t, pad) for t in (q, k, v)), bias,
                          kernels=kernels, **kw)
        return out[..., :d]
    return _flash_ring(q, k, v, bias, kernels=kernels, **kw)


# ---------------------------------------------------------------------------
# the registry entry: no kernel of its own, K5/K6 per visiting block
# ---------------------------------------------------------------------------

def _plain_entry(q, k, v, bias=None, **kw):
    kw["impl"] = "plain"
    return ring_attention(q, k, v, bias=bias, **kw)


def _entry(q, k, v, bias=None, **kw):
    kw.setdefault("impl", "auto")
    return ring_attention(q, k, v, bias=bias, **kw)


def sample_inputs(seed: int):
    """The reference's ``_ring_sample_inputs`` shapes (values from numpy
    under the same seed): global ``(B, H, S, D)`` q, k, v in float32,
    causal."""
    b, h, s, d = ((2, 2, 32, 8), (2, 4, 64, 16), (2, 4, 128, 32))[seed % 3]
    rng = np.random.default_rng(seed)
    return (tuple(torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(
        np.float32)) for _ in range(3)), {"causal": True})


def block_of(x, mesh, axis: str = mesh_lib.SP, dim: int = 2):
    """This rank's block of a global tensor split over ``axis`` on
    ``dim``."""
    n = mesh_lib.axis_size(mesh, axis)
    return x.chunk(n, dim=dim)[mesh_lib.axis_index(mesh, axis)].contiguous()


def parity(seed: int = 0, *, device=None, mesh=None,
           axis: str = mesh_lib.SP) -> Dict[str, float]:
    """The entry's battery, on every rank of a group (the reference's
    ``_ring_parity_fn``): the sample's blocks through the composed path
    ("xla"), the plain block functions ("plain") and "auto" (K5 per block
    on a CUDA ``device``), each rank's output gathered over ``axis`` and
    held to the dense composed attention on the whole sequence within the
    contract's tolerance. Returns ``{impl: max_abs_err}``."""
    mesh = mesh if mesh is not None else mesh_lib.current_mesh()
    if mesh is None:
        raise ValueError("the ring_attention battery requires a mesh")
    from paddle_tpu_torch.kernels.harness import max_error
    device = torch.device(device or "cpu")
    (q, k, v), kw = sample_inputs(seed)
    ref = A.scaled_dot_product_attention(q, k, v, **kw)
    local = [block_of(t.to(device), mesh, axis) for t in (q, k, v)]
    errs = {}
    for impl in ("xla", "plain", "auto"):
        out = ring_attention(*local, mesh=mesh, axis=axis, impl=impl, **kw)
        got = collective.all_gather(out, axis, concat_axis=2, mesh=mesh)
        errs[impl] = max_error(got, ref, (RING.atol, RING.rtol),
                               f"ring_attention[{impl}]")
    return errs


RING = registry.register_composite(registry.CompositeEntry(
    name="ring_attention",
    version=1,
    replaces="paddle_tpu/parallel/ring_attention.py:401",
    source="paddle_tpu_torch/parallel/ring_attention.py",
    arg_layouts={"q": "(B,H,S,D) S split over sp",
                 "k": "(B,H,S,D) S split over sp",
                 "v": "(B,H,S,D) S split over sp",
                 "bias": "(B,1,1,S) key padding, optional"},
    out_layout="(B,H,S,D) split like q",
    inner=("flash_attention_fwd", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq"),
    fn=_entry,
    plain_fn=_plain_entry,
    sample_inputs=sample_inputs,
    parity_fn=parity,
    atol=2e-5, rtol=2e-5,
    collectives=("ppermute",)))
