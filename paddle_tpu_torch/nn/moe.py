"""Mixture-of-experts feed-forward (``paddle_tpu/nn/moe.py``): top-k
token-choice routing with a capacity per expert, as capacity-bucketed
einsums.

- capacity ``max(1, int(capacity_factor * N * k / E))`` for N tokens;
- a token's place in its expert's queue is the running count of that
  expert over the tokens before it (a cumulative sum per choice), and the
  counts carry from one choice to the next, so second choices queue
  behind every first choice;
- tokens over capacity are dropped (their output is zero: the residual
  around the layer carries them);
- ``aux_loss`` is Switch's load-balancing ``E * sum(frac_tokens *
  frac_probs)`` over the dispatched tokens, ``expert_counts`` the routed
  (not kept) count of each expert;
- router noise is drawn only from a ``generator``, and only in training.

The expert weights carry a leading E axis with the reference's hints:
``w1`` ``("ep", None, "tp")``, ``b1`` ``("ep", "tp")``, ``w2`` ``("ep",
"tp", None)``, ``b2`` ``("ep", None)``, the router replicated, in the
``param_sharding`` form ``parallel/plan.py`` reads.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.ops.activation import gelu
from paddle_tpu_torch.ops.tensor import top_k

__all__ = ["MoEFeedForward"]


class MoEFeedForward(nn.Module):
    """Top-k routed expert FFN: ``forward(x, *, generator=None) -> (y,
    {"aux_loss", "expert_counts"})`` over x (B, S, D)."""

    def __init__(self, embed_dim: int, ffn_dim: int, num_experts: int, *,
                 top_k: int = 1, capacity_factor: float = 1.25,
                 activation=gelu, router_noise: float = 0.0, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.e = num_experts
        self.embed_dim, self.ffn_dim = embed_dim, ffn_dim
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.act = activation
        self.router_noise = router_noise
        self.router = nn.Parameter(torch.empty(embed_dim, num_experts, **kw))
        self.w1 = nn.Parameter(torch.empty(num_experts, embed_dim, ffn_dim,
                                           **kw))
        self.b1 = nn.Parameter(torch.empty(num_experts, ffn_dim, **kw))
        self.w2 = nn.Parameter(torch.empty(num_experts, ffn_dim, embed_dim,
                                           **kw))
        self.b2 = nn.Parameter(torch.empty(num_experts, embed_dim, **kw))
        self.param_sharding = {"router": None, "w1": ("ep", None, "tp"),
                               "b1": ("ep", "tp"), "w2": ("ep", "tp", None),
                               "b2": ("ep", None)}

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The reference's schemes: router normal(0, D^-1/2), experts
        Xavier-uniform over (D, F) and (F, D), zero biases."""
        d, f = self.embed_dim, self.ffn_dim
        I.normal(0.0, d ** -0.5)(self.router, generator)
        I.xavier_uniform(fan_in=d, fan_out=f)(self.w1, generator)
        I.xavier_uniform(fan_in=f, fan_out=d)(self.w2, generator)
        I.zeros(self.b1)
        I.zeros(self.b2)

    def capacity(self, n_tok: int) -> int:
        return max(1, int(self.capacity_factor * n_tok * self.top_k / self.e))

    def forward(self, x, *, generator: Optional[torch.Generator] = None):
        b, s, d = x.shape
        n_tok = b * s
        cap = self.capacity(n_tok)
        flat = x.reshape(n_tok, d)
        logits = flat @ self.router
        if self.training and self.router_noise > 0 and generator is not None:
            logits = logits + self.router_noise * torch.randn(
                logits.shape, generator=generator, device=logits.device,
                dtype=logits.dtype)
        probs = torch.softmax(logits.float(), -1)
        gate_vals, expert_idx = top_k(probs, self.top_k)      # (N, k)
        dispatch = x.new_zeros((n_tok, self.e, cap))
        combine = torch.zeros((n_tok, self.e, cap), dtype=torch.float32,
                              device=x.device)
        counts = torch.zeros(self.e, dtype=torch.int64, device=x.device)
        for j in range(self.top_k):
            e_j = expert_idx[:, j]
            onehot = F.one_hot(e_j, self.e)
            pos_in_e = torch.cumsum(onehot, dim=0) - 1
            pos = torch.gather(pos_in_e, 1, e_j[:, None])[:, 0] + counts[e_j]
            slot = torch.where(pos < cap, pos, torch.full_like(pos, cap))
            disp_j = (onehot.to(x.dtype)[:, :, None]
                      * F.one_hot(slot, cap + 1).to(x.dtype)[:, None, :cap])
            dispatch = dispatch + disp_j
            combine = combine + disp_j.float() * gate_vals[:, j, None, None]
            counts = counts + onehot.sum(0)
        xe = torch.einsum("nec,nd->ecd", dispatch, flat)
        h = self.act(torch.einsum("ecd,edf->ecf", xe, self.w1)
                     + self.b1[:, None, :])
        ye = torch.einsum("ecf,efd->ecd", h, self.w2) + self.b2[:, None, :]
        y = torch.einsum("nec,ecd->nd", combine.to(x.dtype), ye)
        frac_tokens = dispatch.sum((0, 2)) / torch.clamp(dispatch.sum(),
                                                          min=1.0)
        aux_loss = self.e * (frac_tokens * probs.mean(0)).sum()
        return y.reshape(b, s, d), {"aux_loss": aux_loss,
                                    "expert_counts": counts}
