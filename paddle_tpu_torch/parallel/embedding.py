"""Sharded embedding (``paddle_tpu/parallel/embedding.py``): a table's rows
split over a mesh axis, looked up Megatron's way.

Each rank holds a block of rows (the placement of the table's hint
``(axis, None)``, :func:`paddle_tpu_torch.parallel.plan.local_shard`),
masks the ids to its own range, gathers locally, and an all-reduce over
the axis merges the partial lookups: one collective where the reference's
pserver world made a prefetch round trip. The all-reduce is
:func:`~paddle_tpu_torch.parallel.functional.reduce_from` (identity
backward: every rank of "tp" computes the same loss once, so each gets
the whole gradient of the lookup and keeps its own rows' part, a
scatter-add in the fixed order of :func:`paddle_tpu_torch.nn.layers.
embedding`).

Tables beyond the card's memory live in the host KV world
(:mod:`paddle_tpu_torch.parallel.host_kv`, placement policy
:func:`~paddle_tpu_torch.parallel.host_kv.fits_hbm`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch.core import mesh as mesh_lib
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layers import embedding
from paddle_tpu_torch.parallel.functional import reduce_from


def vocab_parallel_lookup(ids: torch.Tensor, table: torch.Tensor, *,
                          axis: str = mesh_lib.TP, mesh=None):
    """Rows of ``table`` at ``ids`` (any shape): ``ids.shape + (D,)``,
    replicated over ``axis``. Under a mesh (``mesh``, else the ambient
    one) whose ``axis`` has more than one rank, ``table`` is this rank's
    block of ``V / n`` rows; otherwise it is the whole table."""
    mesh = mesh if mesh is not None else mesh_lib.current_mesh()
    if mesh is None or mesh_lib.axis_size(mesh, axis) == 1:
        return embedding(ids, table)
    shard_rows = table.shape[0]
    local = ids - mesh_lib.axis_index(mesh, axis) * shard_rows
    in_range = (local >= 0) & (local < shard_rows)
    out = embedding(local.clamp(0, shard_rows - 1), table)
    out = torch.where(in_range[..., None], out, out.new_zeros(()))
    return reduce_from(out, axis, mesh)


class ShardedEmbedding(nn.Module):
    """Embedding whose rows split over a mesh axis; looks up through
    :func:`vocab_parallel_lookup`.

    ``combiner``: None returns ``(..., num_ids, D)``; ``"sum"``/``"mean"``
    reduce over the ids axis (fluid's ``embedding`` + ``sequence_pool``,
    the MultiSlot CTR pattern). ``padding_idx`` ids look up zeros, and a
    ``"mean"`` then averages over the valid ids only. The weight (named
    ``weight``, hint ``(axis, None)``) is drawn from ``weight_init``
    (default normal(0, 0.01)) by :meth:`reset_parameters`."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 axis: str = mesh_lib.TP, combiner: Optional[str] = None,
                 weight_init=None, padding_idx: Optional[int] = None,
                 device=None, dtype=None):
        super().__init__()
        self.axis = axis
        self.combiner = combiner
        self.padding_idx = padding_idx
        self.num_embeddings = num_embeddings
        self.weight_init = weight_init or I.normal(0.0, 0.01)
        self.param_sharding = {"weight": (axis, None)}
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.weight_init(self.weight, generator)

    def forward(self, ids):
        out = vocab_parallel_lookup(ids, self.weight, axis=self.axis)
        if self.padding_idx is not None:
            valid = ids != self.padding_idx
            out = torch.where(valid[..., None], out, out.new_zeros(()))
        if self.combiner == "sum":
            out = out.sum(dim=-2)
        elif self.combiner == "mean":
            if self.padding_idx is not None:
                denom = valid.sum(dim=-1, keepdim=True).clamp(min=1)
                out = out.sum(dim=-2) / denom.to(out.dtype)
            else:
                out = out.mean(dim=-2)
        return out
