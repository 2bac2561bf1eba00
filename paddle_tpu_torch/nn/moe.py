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
then computes what the reference's one global ``jax.jit`` computes, under
every token layout the batch spec gives (``api.token_layout``: dim 0 over
"dp", "fsdp" and "ep" in the spec's order, dim 1 over "sp"):

- routing is global over the token axes: the capacity C comes from the
  global token count, and a token's queue place follows the reference's
  flattened (b, s) order. Each rank's routed counts by row and choice,
  (B_local, k, E), are gathered over "sp" and their totals over the
  batch axes, so a token counts every earlier row on all "sp" shards,
  then its row's earlier "sp" shards, then its own shard's tokens
  before it. ``aux_loss`` and ``expert_counts`` are global;
- "ep" as a model axis (the batch spec does not name it): every "ep"
  rank of a token shard holds its tokens whole, builds their dispatch
  over its own ``E/ep`` experts, runs them and sums the combined output
  over "ep"; ``copy_to`` on the tokens and the gate values and
  ``reduce_from`` on the output make the router's and every replicated
  gradient whole on every "ep" rank;
- tokens over "ep" (GShard's all-to-all): the rank builds its tokens'
  dispatch over all E experts into ``C_send = min(C, n_local)`` packed
  slots (a token takes at most one slot of an expert, its k choices
  differ; an expert keeps at most C in all), sends each "ep" rank its
  block of experts by ``parallel.functional.all_to_all``, runs its
  ``E/ep`` experts over the ``ep x C_send`` slots that arrive from its
  group, returns their outputs by the inverse all-to-all and combines
  locally. Each exchange moves ``E x C_send x D x itemsize`` bytes a
  rank (its own block included): 4 a layer a step (dispatch and
  combine, forward and backward), 3 where the layer's input needs no
  gradient (a feed), 2 in an eval step. The expert blocks' gradients
  come back whole over the group through the exchange's transpose;
- experts split over "tp" as well (the hints' ``("ep", None, "tp")``)
  run Megatron inside each expert under either layout: ``w1``/``b1`` by
  columns, ``w2`` by rows, the partial outputs summed over "tp" before
  ``b2``;
- an expert tensor the plan keeps whole beside split ones is read as
  this rank's block (its gradient summed back to the whole tensor);
- a router the plan splits over "ep" or "tp" is gathered whole before
  routing, as GSPMD gathers it; its gradient goes back to the rank's
  block (summed over "ep" where "ep" splits the tokens);
- router noise is drawn on each rank and broadcast over the axes whose
  ranks hold the same tokens ("tp", "pp", and "ep" as a model axis), so
  ranks with the same tokens route alike and the others draw their own.

Shapes are static (no size depends on the routing), so the step traces
on fake tensors (the analysis tiers).

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
        cap = self.capacity(n_tok * (place.n_tokens if place else 1))
        flat = x.reshape(n_tok, d)
        logits = flat @ (place.router(self) if place else self.router)
        if self.training and self.router_noise > 0 and generator is not None:
            noise = torch.randn(logits.shape, generator=generator,
                                device=logits.device, dtype=logits.dtype)
            if place:
                noise = place.same_where_tokens_are(noise)
            logits = logits + self.router_noise * noise
        probs = torch.softmax(logits.float(), -1)
        gate_vals, expert_idx = top_k(probs, self.top_k)      # (N, k)
        onehots = F.one_hot(expert_idx, self.e)               # (N, k, E)
        # by row and choice, the routed count of every expert, and the
        # tokens queued ahead of each row (placed: those of the other
        # shards too, in the reference's (b, s) order)
        rows = onehots.reshape(b, s, self.top_k, self.e)
        if place:
            before, routed = place.queue_offsets(rows.sum(1))
        else:
            routed = rows.sum((0, 1))
            before = torch.cumsum(rows.sum(1), 0) - rows.sum(1)
        w1, b1, w2, b2 = place.params(self) if place else (
            self.w1, self.b1, self.w2, self.b2)
        lo, hi = place.experts(self.e) if place else (0, self.e)
        exchange = bool(place and place.exchange)
        if exchange:
            # every expert's slots for this rank's tokens, packed: a
            # token takes at most one slot of an expert (its k choices
            # differ), and the expert keeps at most ``cap`` in all
            lo, hi, slots = 0, self.e, min(cap, n_tok)
            packed = torch.zeros_like(routed[0])
        else:
            slots = cap
        if place:
            gate_vals = place.into_experts(gate_vals)
        dispatch = x.new_zeros((n_tok, hi - lo, slots))
        combine = torch.zeros((n_tok, hi - lo, slots), dtype=torch.float32,
                              device=x.device)
        counts = torch.zeros(self.e, dtype=torch.int64, device=x.device)
        kept = torch.zeros_like(counts)
        for j in range(self.top_k):
            e_j = expert_idx[:, j]
            onehot = onehots[:, j]
            ahead = (torch.cumsum(rows[:, :, j], 1) - rows[:, :, j]
                     + before[:, None, j]).reshape(n_tok, self.e)
            pos = torch.gather(ahead, 1, e_j[:, None])[:, 0] + counts[e_j]
            keep = pos < cap
            if exchange:
                mine = onehot * keep[:, None]
                pos = torch.gather(torch.cumsum(mine, 0) - mine + packed, 1,
                                   e_j[:, None])[:, 0]
                packed = packed + mine.sum(0)
            slot = torch.where(keep, pos, torch.full_like(pos, slots))
            disp_j = (onehot[:, lo:hi].to(x.dtype)[:, :, None]
                      * F.one_hot(slot, slots + 1).to(x.dtype)[:, None,
                                                                 :slots])
            dispatch = dispatch + disp_j
            combine = combine + disp_j.float() * gate_vals[:, j, None, None]
            kept = kept + (onehot * keep[:, None]).sum(0)
            counts = counts + routed[j]
        xin = place.into_experts(flat) if place else flat
        xe = torch.einsum("nec,nd->ecd", dispatch, xin)
        if exchange:
            xe = place.to_experts(xe)
        if place:
            xe = place.into_expert_columns(xe)
        h = self.act(torch.einsum("ecd,edf->ecf", xe, w1) + b1[:, None, :])
        ye = torch.einsum("ecf,efd->ecd", h, w2)
        if place:
            ye = place.out_of_expert_rows(ye)
        ye = ye + b2[:, None, :]
        if exchange:
            ye = place.from_experts(ye)
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
