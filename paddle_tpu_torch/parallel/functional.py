"""Collectives with their transposes: the communication a sharded forward
needs, as ``torch.autograd.Function``s (GSPMD inserts the same ops in the
reference's programs).

Two conventions, one per kind of axis:

- Data axes (``"dp"``, ``"fsdp"``, ``"sp"``: each rank holds other data).
  Every rank seeds its backward with its own loss, and the sharded train
  step averages the gradients over these axes
  (:mod:`paddle_tpu_torch.parallel.api`). A value made global by a
  collective over a data axis takes the collective's true transpose:
  :func:`global_mean`'s sum all-reduces its gradient too,
  :func:`broadcast_from` sums the gradients into the root.
- The tensor-parallel axis (``"tp"``: every rank holds the same data and
  computes the same loss once). The Megatron pair: :func:`copy_to`
  (identity forward, all-reduce backward) where a replicated activation
  enters a split layer, :func:`reduce_from` (all-reduce forward, identity
  backward) where a row-split layer's partial sums leave it;
  :func:`gather_from` (all-gather forward, this rank's slice backward)
  where a column-split output feeds a replicated layer.

Each op runs over the mesh's process group of its axis (``collective``),
so the mesh's ``stage_cuda_through_host`` switch applies to the ops
gloo cannot run on CUDA tensors.
"""

from __future__ import annotations

from typing import Sequence

import torch

from paddle_tpu_torch.core import mesh as mesh_lib
from paddle_tpu_torch.parallel import collective

#: axes over which ranks hold different data
DATA_AXES = (mesh_lib.DP, mesh_lib.FSDP, mesh_lib.SP)


def live_axes(mesh, axes: Sequence[str]) -> tuple:
    """The axes of ``axes`` that ``mesh`` has with more than one rank."""
    if mesh is None:
        return ()
    return tuple(a for a in axes if mesh_lib.axis_size(mesh, a) > 1)


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return collective.all_reduce(x, axes, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return collective.all_reduce(g, ctx.axes, mesh=ctx.mesh), None, None


def global_mean(total, count, axes: Sequence[str], mesh=None):
    """``sum(total) / max(sum(count), 1)`` over the data ``axes`` of the
    ambient mesh: a mean over the whole batch whatever share of it each
    rank holds (ragged valid lengths give ranks different counts, so a
    mean of the ranks' means would be another loss). Outside a mesh, or
    over axes of size 1, ``total / max(count, 1)``."""
    mesh = mesh if mesh is not None else mesh_lib.current_mesh()
    axes = live_axes(mesh, axes)
    if axes:
        total = _GlobalSum.apply(total, mesh, axes)
        count = collective.all_reduce(count.detach(), axes, mesh=mesh)
    return total / torch.clamp(count, min=1.0)


class _BroadcastFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, root):
        ctx.mesh, ctx.axis, ctx.root = mesh, axis, root
        return collective.broadcast(x.contiguous(), axis, root=root,
                                    mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        total = collective.all_reduce(g.contiguous(), ctx.axis,
                                      mesh=ctx.mesh)
        if mesh_lib.axis_index(ctx.mesh, ctx.axis) != ctx.root:
            total = torch.zeros_like(total)
        return total, None, None, None


def broadcast_from(x, axis: str, root: int = 0, mesh=None):
    """Every rank of ``axis`` gets the value of rank ``root``; the
    gradients of all ranks are summed into the root (the transpose)."""
    mesh = mesh if mesh is not None else mesh_lib.current_mesh()
    if not live_axes(mesh, (axis,)):
        return x
    return _BroadcastFrom.apply(x, mesh, axis, root)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (collective.all_reduce(g.contiguous(), ctx.axis,
                                      mesh=ctx.mesh), None, None)


def copy_to(x, axis: str, mesh):
    """Megatron's ``f``: identity forward, all-reduce of the gradient."""
    return _CopyTo.apply(x, mesh, axis)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return collective.all_reduce(x, axis, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def reduce_from(x, axis: str, mesh):
    """Megatron's ``g``: all-reduce forward, identity backward."""
    return _ReduceFrom.apply(x, mesh, axis)


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, disjoint):
        ctx.mesh, ctx.axis, ctx.dim, ctx.disjoint = mesh, axis, dim, disjoint
        return collective.all_gather(x.contiguous(), axis, concat_axis=dim,
                                     mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        if ctx.disjoint:
            g = collective.reduce_scatter(g.contiguous(), ctx.axis,
                                          scatter_axis=ctx.dim,
                                          mesh=ctx.mesh)
        else:
            n = mesh_lib.axis_size(ctx.mesh, ctx.axis)
            i = mesh_lib.axis_index(ctx.mesh, ctx.axis)
            g = g.chunk(n, dim=ctx.dim)[i].contiguous()
        return g, None, None, None, None


def gather_from(x, axis: str, mesh, dim: int = -1, disjoint: bool = False):
    """Every rank's split of ``x`` concatenated along ``dim`` (forward).
    Backward: this rank's slice of the gradient, where every rank uses
    the whole gathered value alike; with ``disjoint``, where each rank
    uses its own part of it (the attention's local heads), the sum of
    the ranks' gradients and then this rank's slice (a reduce-scatter)."""
    return _GatherFrom.apply(x, mesh, axis, dim % x.ndim, disjoint)
