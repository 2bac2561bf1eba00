"""Composed attention for the dense GPT forward.

The counterpart of the reference's XLA-composed path
(``scaled_dot_product_attention``): fp32 scores, bottom-right aligned
causal mask, and fully-masked rows emitting 0 rather than the uniform
mean of ``v``. The flash-attention kernels (forward and backward) are a
later slice of the port.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

#: large-negative instead of -inf: keeps softmax NaN-free for rows whose
#: every key is masked
NEG_INF = -1e30


def scaled_dot_product_attention(q, k, v, *, bias=None, causal=False,
                                 scale: Optional[float] = None):
    """q, k, v: (B, H, S, D). ``bias`` is additive, broadcastable to
    (B, H, Sq, Sk); ``causal`` masks key ``col > row + (Sk - Sq)``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        row = torch.arange(sq, device=s.device)[:, None]
        col = torch.arange(sk, device=s.device)[None, :]
        s = s.masked_fill(col > row + (sk - sq), NEG_INF)
    p = torch.softmax(s, dim=-1)
    alive = s.amax(dim=-1, keepdim=True) > NEG_INF / 2
    p = torch.where(alive, p, torch.zeros_like(p))
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
