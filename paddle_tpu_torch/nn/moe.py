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

Expert parallelism. ``parallel.api.shard_train_step`` and
``shard_eval_step`` give a layer on a mesh its ``placement``
(:class:`~paddle_tpu_torch.parallel.api.ExpertPlacement`), and the layer
then computes what the reference's one global ``jax.jit`` computes:

- routing is global over the data axes ("dp", "fsdp", which split the
  batch in mesh order): the capacity comes from the global token count,
  a token's queue place counts the tokens of the data shards before its
  own (each choice's routed counts gathered over those axes), and
  ``aux_loss`` and ``expert_counts`` are sums over the global batch;
- the layout of tokens over "ep" is the reference's default batch spec:
  every "ep" rank of a data shard holds that shard's tokens whole, builds
  their dispatch over all E experts, runs only its own ``E/ep`` experts
  (its block of ``w1``, ``b1``, ``w2``, ``b2``) and sums the combined
  output over "ep"; the Megatron pair carries the gradients (the tokens
  and the gate values enter the experts through ``copy_to``, the output
  leaves through ``reduce_from``), so the router and everything outside
  the layer get whole gradients on every "ep" rank. Tokens split over
  "ep" (GShard's all-to-all layout) are refused;
- experts split over "tp" as well (the hints' ``("ep", None, "tp")``)
  run Megatron inside each expert: ``w1``/``b1`` by columns, ``w2`` by
  rows, the partial outputs summed over "tp" before ``b2``;
- router noise is drawn on each rank and then broadcast over "ep" and
  "tp", so every rank of a data shard routes alike.

On one process (``placement`` None) none of this runs.
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

    #: the layer's place on a mesh, set by a sharded placement (module
    #: docstring)
    placement = None

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
        place = self.placement
        cap = self.capacity(n_tok * (place.n_data if place else 1))
        flat = x.reshape(n_tok, d)
        logits = flat @ self.router
        if self.training and self.router_noise > 0 and generator is not None:
            noise = torch.randn(logits.shape, generator=generator,
                                device=logits.device, dtype=logits.dtype)
            if place:
                noise = place.same_on_model_axes(noise)
            logits = logits + self.router_noise * noise
        probs = torch.softmax(logits.float(), -1)
        gate_vals, expert_idx = top_k(probs, self.top_k)      # (N, k)
        onehots = F.one_hot(expert_idx, self.e)               # (N, k, E)
        # each choice's routed count of every expert; placed, also the
        # counts of the data shards before this one (they queue first)
        routed = onehots.sum(0)
        before = torch.zeros_like(routed)
        lo, hi = 0, self.e
        if place:
            before, routed = place.queue_offsets(routed)
            lo, hi = place.experts(self.e)
            gate_vals = place.into_experts(gate_vals)
        dispatch = x.new_zeros((n_tok, hi - lo, cap))
        combine = torch.zeros((n_tok, hi - lo, cap), dtype=torch.float32,
                              device=x.device)
        counts = torch.zeros(self.e, dtype=torch.int64, device=x.device)
        kept = torch.zeros_like(counts)
        for j in range(self.top_k):
            e_j = expert_idx[:, j]
            onehot = onehots[:, j]
            pos_in_e = torch.cumsum(onehot, dim=0) - 1
            pos = torch.gather(pos_in_e, 1, e_j[:, None])[:, 0] \
                + (counts + before[j])[e_j]
            slot = torch.where(pos < cap, pos, torch.full_like(pos, cap))
            disp_j = (onehot[:, lo:hi].to(x.dtype)[:, :, None]
                      * F.one_hot(slot, cap + 1).to(x.dtype)[:, None, :cap])
            dispatch = dispatch + disp_j
            combine = combine + disp_j.float() * gate_vals[:, j, None, None]
            kept = kept + (onehot * (pos < cap)[:, None]).sum(0)
            counts = counts + routed[j]
        xin = place.into_experts(flat) if place else flat
        xe = torch.einsum("nec,nd->ecd", dispatch, xin)
        if place:
            xe = place.into_expert_columns(xe)
        h = self.act(torch.einsum("ecd,edf->ecf", xe, self.w1)
                     + self.b1[:, None, :])
        ye = torch.einsum("ecf,efd->ecd", h, self.w2)
        if place:
            ye = place.out_of_expert_rows(ye)
        ye = ye + self.b2[:, None, :]
        y = torch.einsum("nec,ecd->nd", combine.to(x.dtype), ye)
        if place:
            y = place.out_of_experts(y)
            kept = place.data_sum(kept)
            frac_probs = place.global_mean(probs.sum(0), n_tok)
        else:
            frac_probs = probs.mean(0)
        # the dispatched share of each expert, in x's dtype as the
        # reference sums its dispatch tensor
        frac_tokens = kept.to(x.dtype) / torch.clamp(kept.sum().to(x.dtype),
                                                     min=1.0)
        aux_loss = self.e * (frac_tokens * frac_probs).sum()
        return y.reshape(b, s, d), {"aux_loss": aux_loss,
                                    "expert_counts": counts}
