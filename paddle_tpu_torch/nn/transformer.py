"""Transformer building blocks (``paddle_tpu/nn/transformer.py``):
self-attention with one fused ``qkv_proj`` ``(D, 3D)`` and the
position-wise MLP. Heads are laid out ``(B, H, S, Dh)`` as in the
reference."""

from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.nn.layers import Dropout, Linear
from paddle_tpu_torch.ops import activation as ops_act
from paddle_tpu_torch.ops.attention import scaled_dot_product_attention


class MultiHeadAttention(nn.Module):
    """Fused-qkv self-attention. The serving engine owns the attention
    itself (ragged paged kernels) and uses only :meth:`qkv_heads` and
    :meth:`proj_out`; :meth:`forward` is the dense composed path."""

    def __init__(self, embed_dim: int, num_heads: int, bias: bool = True,
                 causal: bool = False, *, device=None, dtype=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("num_heads must divide embed_dim")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.causal = causal
        self.qkv_proj = Linear(embed_dim, 3 * embed_dim, bias=bias,
                               device=device, dtype=dtype)
        self.out_proj = Linear(embed_dim, embed_dim, bias=bias,
                               device=device, dtype=dtype)

    def _split_heads(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_heads, self.head_dim).transpose(1, 2)

    def _merge_heads(self, x):
        b, h, s, d = x.shape
        return x.transpose(1, 2).reshape(b, s, h * d)

    def qkv_heads(self, x):
        """(B, S, D) -> (q, k, v), each (B, H, S, Dh)."""
        q, k, v = torch.chunk(self.qkv_proj(x), 3, dim=-1)
        return tuple(self._split_heads(t) for t in (q, k, v))

    def proj_out(self, heads):
        """(B, H, S, Dh) attention output -> (B, S, D)."""
        return self.out_proj(self._merge_heads(heads))

    def forward(self, x):
        q, k, v = self.qkv_heads(x)
        out = scaled_dot_product_attention(q, k, v, causal=self.causal)
        return self.proj_out(out)


class FeedForward(nn.Module):
    """``fc2(act(fc1(x)))``, GELU (tanh approximation) by default."""

    def __init__(self, embed_dim: int, ffn_dim: int, activation: str = "gelu",
                 dropout: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        self.fc1 = Linear(embed_dim, ffn_dim, device=device, dtype=dtype)
        self.fc2 = Linear(ffn_dim, embed_dim, device=device, dtype=dtype)
        self.act = getattr(ops_act, activation)
        self.drop = Dropout(dropout)

    def forward(self, x):
        return self.fc2(self.drop(self.act(self.fc1(x))))
