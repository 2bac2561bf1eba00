"""Transformer building blocks (``paddle_tpu/nn/transformer.py``):
attention (self-attention with one fused ``qkv_proj`` ``(D, 3D)``,
cross-attention with separate ``q_proj`` ``(D, D)`` and ``kv_proj``
``(D, 2D)``), the position-wise MLP, and the encoder and decoder layers.
Heads are laid out ``(B, H, S, Dh)`` as in the reference. Dropout follows
each module's training mode and draws from the ``generator`` passed down
the forward."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch.nn.layers import COLUMN, ROW, Dropout, LayerNorm, Linear
from paddle_tpu_torch.ops import activation as ops_act
from paddle_tpu_torch.ops.attention import dot_product_attention

#: ``attn_impl="ring"``'s layout of q, k, v (the reference's
#: ``RING_HEADS_SPEC``, the sequence split over "sp"): each rank already
#: holds its own sequence block, so the heads are the local
#: ``(B, H, S/sp, Dh)`` block and nothing is constrained
RING_HEADS_SPEC = "the local (B, H, S/sp, Dh) block"


class MultiHeadAttention(nn.Module):
    """Multi-head attention: fused-qkv self-attention, or with
    ``self_attention=False`` cross-attention with separate q and kv
    projections (the decoder's). :meth:`forward` goes through
    :func:`~paddle_tpu_torch.ops.attention.dot_product_attention` with
    ``attn_impl`` (flash attention unless attention dropout is active),
    and with ``cache=`` it is one KV-cached decode step (the dense
    ``GPT.generate`` path); the serving engine owns the attention itself
    (ragged paged kernels) and uses only :meth:`qkv_heads` and
    :meth:`proj_out`. ``attn_impl="ring"`` runs
    :func:`~paddle_tpu_torch.parallel.ring_attention.ring_attention` over
    the ambient mesh's "sp" axis on this rank's sequence block (no
    attention-probability dropout). Under a Megatron placement
    ``local_heads`` is ``(first, count)``: the heads this rank's
    row-split output projection holds."""

    #: set by a sharded placement: this rank's heads (first, count)
    local_heads = None

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = True, causal: bool = False,
                 attn_impl: str = "auto", *, self_attention: bool = True,
                 device=None, dtype=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("num_heads must divide embed_dim")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout_rate = dropout
        self.causal = causal
        self.attn_impl = attn_impl
        if attn_impl == "ring" and dropout > 0.0:
            raise ValueError(
                "ring attention does not support attention-prob dropout; "
                "set attn_dropout=0 (residual dropout still applies)")
        self.self_attention = self_attention
        if self_attention:
            self.qkv_proj = Linear(embed_dim, 3 * embed_dim, bias=bias,
                                   sharding=COLUMN, device=device,
                                   dtype=dtype)
        else:
            self.q_proj = Linear(embed_dim, embed_dim, bias=bias,
                                 sharding=COLUMN, device=device, dtype=dtype)
            self.kv_proj = Linear(embed_dim, 2 * embed_dim, bias=bias,
                                  sharding=COLUMN, device=device,
                                  dtype=dtype)
        self.out_proj = Linear(embed_dim, embed_dim, bias=bias,
                               sharding=ROW, device=device, dtype=dtype)

    def _split_heads(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_heads, self.head_dim).transpose(1, 2)

    def _merge_heads(self, x):
        b, h, s, d = x.shape
        return x.transpose(1, 2).reshape(b, s, h * d)

    def _local(self, heads):
        if self.local_heads is not None:
            first, count = self.local_heads
            heads = tuple(t[:, first:first + count] for t in heads)
        return heads

    def qkv_heads(self, x, key_value=None):
        """(B, S, D) -> (q, k, v), each (B, H, S, Dh) (this rank's heads
        under a Megatron placement). Cross-attention projects k and v
        from ``key_value`` (``x`` when None)."""
        if self.self_attention:
            q, k, v = torch.chunk(self.qkv_proj(x), 3, dim=-1)
        else:
            q = self.q_proj(x)
            k, v = torch.chunk(self.kv_proj(
                x if key_value is None else key_value), 2, dim=-1)
        return self._local(tuple(self._split_heads(t) for t in (q, k, v)))

    def cross_kv(self, memory):
        """Cross-attention (k, v) heads of the encoder ``memory``: made
        once per sequence, then passed to each decode step as
        ``static_kv``."""
        k, v = torch.chunk(self.kv_proj(memory), 2, dim=-1)
        return self._local((self._split_heads(k), self._split_heads(v)))

    def proj_out(self, heads):
        """(B, H, S, Dh) attention output -> (B, S, D)."""
        return self.out_proj(self._merge_heads(heads))

    def forward(self, x, key_value=None, *, bias=None,
                generator: Optional[torch.Generator] = None,
                cache=None, cache_pos=None, return_kv: bool = False,
                static_kv=None):
        """x: (B, Sq, D); ``key_value``: (B, Sk, D) for cross-attention;
        ``bias`` additive, broadcastable to (B, H, Sq, Sk) (a key-padding
        bias is (B, 1, 1, Sk), a packed batch's segment bias (B, 1, Sq,
        Sk)). ``static_kv``: precomputed (k, v) heads (:meth:`cross_kv`),
        which skip the kv projection (cross-attention decode; the
        composed path).

        Incremental decoding: ``cache=(k_cache, v_cache)``, each
        (B, H, Smax, Dh), and ``cache_pos`` the write position (a 0-dim
        integer tensor on the cache's device, so a captured graph can
        replay it) make this one decode step of a single token: its k/v
        are written into the caches in place at ``cache_pos`` and the
        query attends over the whole cache through the composed path,
        positions past ``cache_pos`` masked by a ``-1e30`` bias; returns
        ``(out, (k_cache, v_cache))``. ``return_kv=True`` also returns
        this call's (k, v) heads: the prefill that seeds the cache."""
        if static_kv is not None:
            q, = self._local((self._split_heads(self.q_proj(x)),))
            k, v = static_kv
            out = dot_product_attention(q, k, v, bias=bias, causal=False,
                                        impl="xla")
            return self.proj_out(out.to(q.dtype))
        q, k, v = self.qkv_heads(x, key_value)
        if cache is not None:
            ck, cv = cache
            at = cache_pos.reshape(1)
            ck.index_copy_(2, at, k.to(ck.dtype))
            cv.index_copy_(2, at, v.to(cv.dtype))
            smax = ck.shape[2]
            mask = torch.arange(smax, device=ck.device) <= cache_pos
            step_bias = torch.where(mask, 0.0, -1e30).to(q.dtype)
            if bias is not None:
                step_bias = step_bias + bias
            out = dot_product_attention(q, ck, cv, bias=step_bias,
                                        causal=False, impl="xla")
            return self.proj_out(out.to(q.dtype)), (ck, cv)
        rate = self.dropout_rate if self.training else 0.0
        if self.attn_impl == "ring":
            # sequence parallel: k/v ride the ring of the mesh's "sp" axis
            from paddle_tpu_torch.parallel.ring_attention import \
                ring_attention
            out = ring_attention(q, k, v, bias=bias, causal=self.causal)
            if return_kv:
                return self.proj_out(out), (k, v)
            return self.proj_out(out)
        out = dot_product_attention(q, k, v, bias=bias, causal=self.causal,
                                    dropout_rate=rate, generator=generator,
                                    impl=self.attn_impl)
        if return_kv:
            return self.proj_out(out), (k, v)
        return self.proj_out(out)


class FeedForward(nn.Module):
    """``fc2(drop(act(fc1(x))))``, GELU (tanh approximation) by default."""

    def __init__(self, embed_dim: int, ffn_dim: int, activation: str = "gelu",
                 dropout: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        self.fc1 = Linear(embed_dim, ffn_dim, sharding=COLUMN, device=device,
                          dtype=dtype)
        self.fc2 = Linear(ffn_dim, embed_dim, sharding=ROW, device=device,
                          dtype=dtype)
        self.act = getattr(ops_act, activation)
        self.drop = Dropout(dropout)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return self.fc2(self.drop(self.act(self.fc1(x)), generator))


class TransformerEncoderLayer(nn.Module):
    """Post-LN (BERT, the default) or pre-LN encoder block; parameters
    ``attn``, ``ffn``, ``ln1``, ``ln2`` as in the reference tree."""

    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.1, attn_dropout: Optional[float] = None,
                 activation: str = "gelu", pre_ln: bool = False,
                 attn_impl: str = "auto", *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attn = MultiHeadAttention(
            embed_dim, num_heads,
            dropout=attn_dropout if attn_dropout is not None else dropout,
            attn_impl=attn_impl, **kw)
        self.ffn = FeedForward(embed_dim, ffn_dim, activation, dropout, **kw)
        self.ln1 = LayerNorm(embed_dim, **kw)
        self.ln2 = LayerNorm(embed_dim, **kw)
        self.drop = Dropout(dropout)
        self.pre_ln = pre_ln

    def forward(self, x, *, bias=None,
                generator: Optional[torch.Generator] = None):
        g = generator
        if self.pre_ln:
            h = self.attn(self.ln1(x), bias=bias, generator=g)
            x = x + self.drop(h, g)
            return x + self.drop(self.ffn(self.ln2(x), g), g)
        h = self.attn(x, bias=bias, generator=g)
        x = self.ln1(x + self.drop(h, g))
        return self.ln2(x + self.drop(self.ffn(x, g), g))


class TransformerDecoderLayer(nn.Module):
    """Decoder block: causal self-attention (``self_bias``, a packed
    batch's segment bias), cross-attention over the encoder memory
    (``cross_bias``), the MLP; pre- or post-LN. Parameters
    ``self_attn``, ``cross_attn``, ``ffn``, ``ln1``..``ln3`` as in the
    reference tree."""

    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.1, attn_dropout: Optional[float] = None,
                 activation: str = "relu", pre_ln: bool = False,
                 attn_impl: str = "auto", *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        if attn_dropout is None:
            attn_dropout = dropout
        self.self_attn = MultiHeadAttention(
            embed_dim, num_heads, dropout=attn_dropout, causal=True,
            attn_impl=attn_impl, **kw)
        self.cross_attn = MultiHeadAttention(
            embed_dim, num_heads, dropout=attn_dropout, attn_impl=attn_impl,
            self_attention=False, **kw)
        self.ffn = FeedForward(embed_dim, ffn_dim, activation, dropout, **kw)
        self.ln1 = LayerNorm(embed_dim, **kw)
        self.ln2 = LayerNorm(embed_dim, **kw)
        self.ln3 = LayerNorm(embed_dim, **kw)
        self.drop = Dropout(dropout)
        self.pre_ln = pre_ln

    def _sub(self, x, ln, fn, generator=None):
        if self.pre_ln:
            return x + self.drop(fn(ln(x)), generator)
        return ln(x + self.drop(fn(x), generator))

    def forward(self, x, memory, *, self_bias=None, cross_bias=None,
                generator: Optional[torch.Generator] = None):
        g = generator
        x = self._sub(x, self.ln1, lambda h: self.self_attn(
            h, bias=self_bias, generator=g), g)
        x = self._sub(x, self.ln2, lambda h: self.cross_attn(
            h, memory, bias=cross_bias, generator=g), g)
        return self._sub(x, self.ln3, lambda h: self.ffn(h, g), g)

    def decode_step(self, x, pos, self_cache, cross_kv, *, cross_bias=None):
        """One cached decode step of x (B, 1, D) at position ``pos`` (a
        0-d integer tensor): self-attention through the KV cache (written
        in place), cross-attention over the precomputed memory heads.
        Inference only (no dropout). Returns (x, self_cache)."""
        box = {}

        def self_fn(h):
            out, box["cache"] = self.self_attn(h, cache=self_cache,
                                               cache_pos=pos)
            return out

        def sub(x, ln, fn):
            return x + fn(ln(x)) if self.pre_ln else ln(x + fn(x))

        x = sub(x, self.ln1, self_fn)
        x = sub(x, self.ln2, lambda h: self.cross_attn(
            h, bias=cross_bias, static_kv=cross_kv))
        x = sub(x, self.ln3, self.ffn)
        return x, box["cache"]
