"""Beam-search ops (``paddle_tpu/ops/beam_search.py``: fluid's
``beam_search_op`` and ``beam_search_decode_op``).

Beams live on the reference's dense ``(B, K)`` lattice: the batch
dimension groups each source sentence's beams, finished beams are masked
rather than pruned, and every step has the same shapes. Backtracking in
:func:`beam_search_decode` walks the parent pointers right to left in a
loop over steps, on the tensors' device.

Selection ranks ``B x (K * V)`` candidates with a stable descending sort
(:func:`paddle_tpu_torch.ops.tensor.top_k`): among equal scores the lower
candidate index wins, as ``lax.top_k``'s does, so the port picks the
reference's beams even on ties.
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.tensor import top_k

NEG_INF = -1e9

__all__ = ["beam_search_step", "beam_search_decode", "beam_init",
           "gather_beams", "NEG_INF"]


def beam_init(batch: int, beam_size: int, dtype=torch.float32,
              device="cuda"):
    """Initial ``(scores, done)`` lattice: beam 0 live at score 0, beams
    1..K-1 at ``NEG_INF`` so the first step fans out from a single
    hypothesis. On the card unless ``device`` says otherwise."""
    device = resolve_device(device)
    scores = torch.full((batch, beam_size), NEG_INF, dtype=dtype,
                        device=device)
    scores[:, 0] = 0.0
    done = torch.zeros((batch, beam_size), dtype=torch.bool, device=device)
    return scores, done


@register_op("beam_search", has_grad=False)
def beam_search_step(logp, scores, done, *, eos_id: int, pad_id: int = 0,
                     beam_size: Optional[int] = None):
    """One beam expansion (fluid ``beam_search_op``).

    Args:
      logp: (B, K, V) next-token log-probabilities per live beam.
      scores: (B, K) cumulative log-probs (``pre_scores``).
      done: (B, K) bool: beams that already emitted EOS.
      eos_id / pad_id: termination token / filler for finished beams.
      beam_size: output beams per group; defaults to K (shrinking is
        allowed, growing is not).

    Returns ``(tokens, new_scores, new_done, parent_idx)``, each (B, K'):
    the chosen continuation tokens (int32), their cumulative scores,
    finished flags, and the index of the beam each selection extends.
    Finished beams only ever continue with ``pad_id`` at unchanged score.
    """
    b, k, v = logp.shape
    k_out = k if beam_size is None else beam_size
    if k_out < 1:
        raise ValueError(f"beam_size must be >= 1, got {k_out}")
    if k_out > k:
        raise ValueError(f"cannot grow beams: {k_out} > {k}")
    logp = logp.to(torch.float32)
    # a finished beam contributes exactly one candidate: PAD, score += 0
    pad_only = torch.full((v,), NEG_INF, dtype=logp.dtype, device=logp.device)
    pad_only[pad_id] = 0.0
    logp = torch.where(done[..., None], pad_only, logp)
    cand = scores[..., None] + logp                       # (B, K, V)
    new_scores, idx = top_k(cand.reshape(b, k * v), k_out)
    parent = torch.div(idx, v, rounding_mode="floor")
    tok = (idx % v).to(torch.int32)
    new_done = torch.gather(done, 1, parent) | (tok == eos_id)
    return tok, new_scores, new_done, parent


def gather_beams(tree, parent_idx):
    """Reorder per-beam state along the chosen parents: every tensor of
    ``tree`` (a tensor, or lists, tuples and dicts of them) has leading
    dims ``(B, K, ...)`` or flat ``(B*K, ...)`` and its rows follow
    ``parent_idx`` (B, K). Carries RNN state or KV caches with their
    beams."""
    b, k = parent_idx.shape

    def g(leaf):
        flat = leaf.shape[0] == b * k
        shaped = leaf.reshape((b, k) + tuple(leaf.shape[1:])) if flat else leaf
        ix = parent_idx.reshape((b, k) + (1,) * (shaped.ndim - 2)).expand(
            (b, k) + tuple(shaped.shape[2:]))
        shaped = torch.gather(shaped, 1, ix.to(shaped.device))
        return shaped.reshape(leaf.shape) if flat else shaped

    def walk(node):
        if isinstance(node, torch.Tensor):
            return g(node)
        if isinstance(node, dict):
            return {key: walk(val) for key, val in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(val) for val in node)
        return node

    return walk(tree)


@register_op("beam_search_decode", has_grad=False)
def beam_search_decode(step_tokens, step_parents, scores, *,
                       eos_id: int, pad_id: int = 0,
                       bos_id: Optional[int] = None,
                       length_penalty: float = 0.0):
    """Backtrack stacked step selections into full sequences (fluid
    ``beam_search_decode_op``).

    Args:
      step_tokens: (B, T, K) tokens chosen at each step.
      step_parents: (B, T, K) matching ``parent_idx`` stack.
      scores: (B, K) final cumulative scores.
      bos_id: when given, sequences are prefixed with it (length T+1).
      length_penalty: GNMT alpha; 0 ranks by raw cumulative score like the
        reference op, >0 divides by ((5+len)/6)^alpha.

    Returns ``(sequences, norm_scores)``: (B, K, T[+1]) int32 sequences,
    post-EOS filled with ``pad_id``, and the (possibly length-normalized)
    scores, both sorted best-first.
    """
    b, t, k = step_tokens.shape
    pars = step_parents.long()
    # walk parents right-to-left: the beam that holds slot j at the end
    # occupied pars[:, s, j] at step s-1
    ptr = torch.arange(k, device=step_tokens.device).expand(b, k)
    cols = [None] * t
    for s in range(t - 1, -1, -1):
        cols[s] = torch.gather(step_tokens[:, s], 1, ptr)
        ptr = torch.gather(pars[:, s], 1, ptr)
    seqs = torch.stack(cols, dim=-1).to(torch.int32)       # (B, K, T)

    # mask everything after the first EOS to pad (keep the EOS itself)
    is_eos = seqs == eos_id
    after = torch.cumsum(torch.cumsum(is_eos.int(), dim=-1), dim=-1) > 1
    seqs = torch.where(after, torch.full_like(seqs, pad_id), seqs)

    scores = scores.to(torch.float32)
    if length_penalty > 0.0:
        # length = first-EOS position + 1, not a count of non-pad tokens:
        # a mid-sequence emission of the pad-valued token counts
        any_eos = is_eos.any(dim=-1)
        first_eos = torch.argmax(is_eos.int(), dim=-1)
        lengths = torch.where(any_eos, first_eos + 1,
                              torch.full_like(first_eos, t)).float()
        if bos_id is not None:
            lengths = lengths + 1.0
        scores = scores / (((5.0 + lengths) / 6.0) ** length_penalty)

    order = torch.sort(-scores, dim=-1, stable=True).indices
    scores = torch.gather(scores, 1, order)
    seqs = torch.gather(seqs, 1, order[..., None].expand(b, k, t))
    if bos_id is not None:
        bos = torch.full((b, k, 1), bos_id, dtype=torch.int32,
                         device=seqs.device)
        seqs = torch.cat([bos, seqs], dim=-1)
    return seqs, scores
