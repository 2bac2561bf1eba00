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

:func:`all_to_all` (GShard's expert exchange) is its own transpose with
the split and concat dims swapped; it counts its calls and bytes
(:func:`all_to_all_stats`). :func:`token_layout` names, while a sharded
step runs, the axes that split its tokens, for the losses' global means
(:func:`current_token_layout`).

Each op runs over the mesh's process group of its axis (``collective``),
so the mesh's ``stage_cuda_through_host`` switch applies to the ops
gloo cannot run on CUDA tensors.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Sequence, Tuple

import torch

from paddle_tpu_torch.core import mesh as mesh_lib
from paddle_tpu_torch.parallel import collective

#: axes over which ranks hold different data
DATA_AXES = (mesh_lib.DP, mesh_lib.FSDP, mesh_lib.SP)

_layout = threading.local()


@contextlib.contextmanager
def token_layout(batch_axes: Sequence[str], seq_axes: Sequence[str]):
    """While a sharded step runs: the axes that split its batch dim (in
    the spec's order, major first) and its sequence dim."""
    prev = getattr(_layout, "axes", None)
    _layout.axes = (tuple(batch_axes), tuple(seq_axes))
    try:
        yield
    finally:
        _layout.axes = prev


def current_token_layout() -> Tuple[tuple, tuple]:
    """``(batch_axes, seq_axes)`` of the running sharded step; outside one,
    the default batch spec's: ``(("dp", "fsdp"), ("sp",))``."""
    return getattr(_layout, "axes", None) or (mesh_lib.BATCH_AXES,
                                              (mesh_lib.SP,))


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


_a2a_lock = threading.Lock()
_a2a = {"calls": 0, "bytes": 0}


def all_to_all_stats() -> dict:
    """:func:`all_to_all` since the last reset, forward and backward:
    ``{"calls": n, "bytes": n}``, the bytes of the buffers each call
    sent (its input, this rank's own chunk included)."""
    with _a2a_lock:
        return dict(_a2a)


def reset_all_to_all_stats():
    with _a2a_lock:
        _a2a.update(calls=0, bytes=0)


def _exchange(x, mesh, axis, split_dim, concat_dim):
    with _a2a_lock:
        _a2a["calls"] += 1
        _a2a["bytes"] += x.numel() * x.element_size()
    return collective.all_to_all(x.contiguous(), axis, split_axis=split_dim,
                                 concat_axis=concat_dim, mesh=mesh)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.mesh, ctx.axis, ctx.dims = mesh, axis, (split_dim, concat_dim)
        return _exchange(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_exchange(g, ctx.mesh, ctx.axis, concat_dim, split_dim),
                None, None, None, None)


def all_to_all(x, axis: str, mesh, split_dim: int, concat_dim: int):
    """``x`` cut into axis-size chunks along ``split_dim``, chunk ``i`` to
    member ``i``, the chunks received concatenated along ``concat_dim``
    in member order; the backward is the inverse exchange of the
    gradient (the dims swapped)."""
    return _AllToAll.apply(x, mesh, axis, split_dim % x.ndim,
                           concat_dim % x.ndim)
