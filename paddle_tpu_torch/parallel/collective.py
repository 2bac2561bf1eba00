"""Explicit collectives over named mesh axes
(``paddle_tpu/parallel/collective.py``) on ``torch.distributed``.

The reference wraps ``lax.p*`` in ``shard_map`` over a mesh axis; here
each rank calls the op with its own local value and the op runs on the
process group of the mesh's axis (``DeviceMesh.get_group``). Values are
returned, the input is left as it was, as the reference's functional ops
do. An op over a tuple of axes runs over each axis in turn.

A gloo group takes CUDA tensors for ``all_reduce``, ``broadcast`` and
``barrier`` only (:data:`GLOO_CUDA_OPS`); every other op on a CUDA
tensor over a gloo group raises, naming the op and the backend, unless
the mesh was made with ``make_mesh(..., stage_cuda_through_host=True)``:
then the op copies the tensor to a pinned host buffer, runs over gloo and
copies the result back to the card, and counts the call and its bytes
(:func:`staged_stats`). That switch is the only way a CUDA tensor goes
through the host here; it exists so that multi-rank code runs on a
machine with one card, and an NCCL group never stages.

On fake tensors (the analysis tiers' traces, where nothing runs) each op
records itself instead of communicating: one ``torch.ops.ptt.collective``
node per call, naming its kind, its group's size and name, with the
output's shape (:func:`traced`); gloo's in-place calls do not trace.
"""

from __future__ import annotations

import collections
import datetime
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.device_mesh import DeviceMesh

from paddle_tpu_torch.core import mesh as mesh_lib

AxisArg = Union[str, Sequence[str]]

#: the ops a gloo group runs on CUDA tensors
GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast", "barrier"})

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT}


@torch.library.custom_op("ptt::collective", mutates_args=())
def traced(x: torch.Tensor, kind: str, out_shape: Sequence[int],
           group_size: int, group: str) -> torch.Tensor:
    """A collective as a trace records it: ``kind`` (all_reduce,
    all_gather, reduce_scatter, broadcast, all_to_all,
    collective_permute) over ``group_size`` ranks of ``group``, giving a
    tensor of ``out_shape``. Only its fake runs (in a trace on fake
    tensors); called on real tensors it raises."""
    raise RuntimeError("ptt::collective stands for a collective in a "
                       "trace on fake tensors; it does not communicate")


@traced.register_fake
def _traced_fake(x, kind, out_shape, group_size, group):
    return x.new_empty(tuple(out_shape))


def _record(kind: str, x: torch.Tensor, group, out_shape=None,
            n: Optional[int] = None) -> torch.Tensor:
    """The traced stand-in of ``kind`` on fake ``x`` over ``group``."""
    n = dist.get_world_size(group) if n is None else n
    return torch.ops.ptt.collective(
        x, kind, list(x.shape if out_shape is None else out_shape), n,
        str(getattr(group, "group_name", "")))


_stats_lock = threading.Lock()
_staged_calls: "collections.Counter[str]" = collections.Counter()
_staged_bytes: "collections.Counter[str]" = collections.Counter()


def staged_stats() -> Dict[str, Dict[str, int]]:
    """Ops staged through the host since the last reset, by op name:
    ``{"calls": {op: n}, "bytes": {op: n}}``, bytes counted once each
    way (the input copied to the host, the output copied back)."""
    with _stats_lock:
        return {"calls": dict(_staged_calls), "bytes": dict(_staged_bytes)}


def reset_staged_stats():
    with _stats_lock:
        _staged_calls.clear()
        _staged_bytes.clear()


def _note_staged(op: str, nbytes: int):
    with _stats_lock:
        _staged_calls[op] += 1
        _staged_bytes[op] += int(nbytes)


def _to_host(x: torch.Tensor) -> torch.Tensor:
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


def _axes(axis: AxisArg) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _mesh(mesh: Optional[DeviceMesh]) -> DeviceMesh:
    m = mesh or mesh_lib.current_mesh()
    if m is None:
        raise ValueError("no mesh: pass mesh= or enter mesh_context()")
    return m


def axis_group(axis: str, mesh: Optional[DeviceMesh] = None):
    """The process group of ``mesh``'s ``axis``."""
    return _mesh(mesh).get_group(axis)


def check_backend(op: str, device_type: str, backend: str):
    """Raise when ``backend`` cannot run ``op`` on tensors of
    ``device_type`` (gloo takes CUDA tensors only for
    :data:`GLOO_CUDA_OPS`)."""
    if backend == "gloo" and device_type == "cuda" \
            and op not in GLOO_CUDA_OPS:
        raise NotImplementedError(
            f"{op} on CUDA tensors is not supported by the gloo backend "
            f"(gloo runs {', '.join(sorted(GLOO_CUDA_OPS))} on CUDA); use "
            "an nccl group, one card per rank")


def _check(op: str, x: Optional[torch.Tensor], group):
    device_type = x.device.type if x is not None else "cpu"
    check_backend(op, device_type, dist.get_backend(group))


def _stage(op: str, x: torch.Tensor, group,
           mesh: Optional[DeviceMesh]) -> Optional[torch.device]:
    """Before ``op`` on ``x`` over ``group``: None when the op runs on
    ``x`` where it lies, else the CUDA device ``x`` lies on, whose tensor
    the op must take through the host (the mesh's staging switch is on
    and the group is gloo). Raises where the backend cannot run the op
    and the switch is off."""
    if x.device.type == "cuda" and op not in GLOO_CUDA_OPS \
            and dist.get_backend(group) == "gloo" \
            and mesh_lib.stages_cuda(_mesh(mesh)):
        return x.device
    _check(op, x, group)
    return None


def group_timeout(group=None) -> Optional[datetime.timedelta]:
    """The timeout ``group`` (default: the world) was made with, or None
    when its backend does not say."""
    pg = group if group is not None else dist.group.WORLD
    for dev in ("cpu", "cuda"):
        try:
            return pg._get_backend(torch.device(dev)).options._timeout
        except (AttributeError, RuntimeError):
            continue
    return None


def all_reduce(x: torch.Tensor, axis: AxisArg = mesh_lib.DP, *,
               op: str = "sum",
               mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """c_allreduce_{sum,max,min,prod}: the reduction of every member's
    ``x`` across ``axis``, on every member."""
    out = x.clone()
    for a in _axes(axis):
        group_all_reduce(out, axis_group(a, mesh), op=op)
    return out


def group_all_reduce(x: torch.Tensor, group, *,
                     op: str = "sum") -> torch.Tensor:
    """:func:`all_reduce` in place on a process group the caller holds
    (a serving engine's tp group): every member's ``x`` becomes the
    reduction. Returns ``x``."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"op must be one of {sorted(_REDUCE_OPS)}, "
                         f"got {op!r}")
    if is_fake(x):
        return x.copy_(_record("all_reduce", x, group))
    _check("all_reduce", x, group)
    dist.all_reduce(x, op=_REDUCE_OPS[op], group=group)
    return x


def all_gather(x: torch.Tensor, axis: AxisArg = mesh_lib.DP, *,
               concat_axis: int = 0, tiled: bool = True,
               mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """c_allgather: every member's ``x`` concatenated along
    ``concat_axis`` in axis order. ``tiled`` is accepted and concatenates
    either way, as the reference's ``all_gather`` does."""
    out = x
    for a in _axes(axis):
        g = axis_group(a, mesh)
        if is_fake(out):
            n = dist.get_world_size(g)
            parts = _record("all_gather", out.contiguous(), g,
                            (n,) + tuple(out.shape), n)
            out = torch.cat(list(parts.unbind(0)), dim=concat_axis)
            continue
        dev = _stage("all_gather", out, g, mesh)
        src = out.contiguous() if dev is None else _to_host(out)
        parts = [torch.empty_like(src) for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, src, group=g)
        out = torch.cat(parts, dim=concat_axis)
        if dev is not None:
            _note_staged("all_gather", src.nbytes + out.nbytes)
            out = out.to(dev)
    return out


def reduce_scatter(x: torch.Tensor, axis: str = mesh_lib.DP, *,
                   scatter_axis: int = 0,
                   mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """c_reducescatter: the sum over ``axis``, of which member ``i`` keeps
    the ``i``-th of equal chunks along ``scatter_axis`` (whose size the
    axis size must divide)."""
    g = axis_group(axis, mesh)
    n = dist.get_world_size(g)
    if x.shape[scatter_axis] % n:
        raise ValueError(f"dim {scatter_axis} ({x.shape[scatter_axis]}) "
                         f"does not divide over {axis} ({n})")
    if is_fake(x):
        shape = list(x.shape)
        shape[scatter_axis] //= n
        return _record("reduce_scatter", x.contiguous(), g, shape, n)
    dev = _stage("reduce_scatter", x, g, mesh)
    src = x if dev is None else _to_host(x)
    chunks = [c.contiguous() for c in src.chunk(n, dim=scatter_axis)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=g)
    if dev is not None:
        _note_staged("reduce_scatter", src.nbytes + out.nbytes)
        out = out.to(dev)
    return out


def broadcast(x: torch.Tensor, axis: AxisArg = mesh_lib.DP, *,
              root: int = 0,
              mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """c_broadcast: every member gets the value of the member at position
    ``root`` along each axis."""
    out = x.clone()
    for a in _axes(axis):
        g = axis_group(a, mesh)
        if is_fake(out):
            out = _record("broadcast", out, g)
            continue
        _check("broadcast", out, g)
        dist.broadcast(out, src=dist.get_global_rank(g, root), group=g)
    return out


def all_to_all(x: torch.Tensor, axis: str = mesh_lib.EP, *,
               split_axis: int = 0, concat_axis: int = 0,
               mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Dense all-to-all: ``x`` cut into axis-size chunks along
    ``split_axis``, chunk ``i`` to member ``i``, the received chunks
    concatenated along ``concat_axis`` in member order."""
    g = axis_group(axis, mesh)
    n = dist.get_world_size(g)
    if x.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} ({x.shape[split_axis]}) "
                         f"does not divide over {axis} ({n})")
    if is_fake(x):
        parts = _record("all_to_all", torch.stack(x.chunk(n, split_axis)),
                        g, None, n)
        return torch.cat(list(parts.unbind(0)), dim=concat_axis)
    dev = _stage("all_to_all", x, g, mesh)
    src = x if dev is None else _to_host(x)
    # the single-buffer form (chunks along dim 0): gloo runs it, where
    # some releases refuse the list form
    send = src.movedim(split_axis, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=g)
    out = torch.cat([c.movedim(0, split_axis) for c in recv.chunk(n, 0)],
                    dim=concat_axis)
    if dev is not None:
        _note_staged("all_to_all", src.nbytes + out.nbytes)
        out = out.to(dev)
    return out


def ppermute(x: torch.Tensor, axis: str, perm, *,
             mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Point-to-point shift: for each ``(src, dst)`` of ``perm`` (axis
    positions), member ``dst`` receives member ``src``'s ``x``; a member
    that receives nothing gets zeros (``lax.ppermute``). One
    ``batch_isend_irecv`` per member. Staged through the host, a member
    copies ``x`` out only when it sends and a buffer in only when it
    receives, and counts those bytes alone."""
    m = _mesh(mesh)
    g = m.get_group(axis)
    if is_fake(x):
        return _record("collective_permute", x, g)
    dev = _stage("ppermute", x, g, m)
    me = m.get_local_rank(axis)
    sending = any(src == me for src, _ in perm)
    receiving = any(dst == me for _, dst in perm)
    if not receiving and dev is not None:
        out = torch.zeros_like(x)
    elif dev is None:
        out = torch.zeros_like(x, memory_format=torch.contiguous_format)
    else:
        out = torch.zeros(x.shape, dtype=x.dtype, pin_memory=True)
    send = None
    if sending:
        send = x.contiguous() if dev is None else _to_host(x)
    ops = []
    for src, dst in perm:
        if src == me:
            ops.append(dist.P2POp(dist.isend, send,
                                  dist.get_global_rank(g, dst), g))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(g, src), g))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if dev is not None:
        _note_staged("ppermute", (send.nbytes if sending else 0)
                     + (out.nbytes if receiving else 0))
        if receiving:
            out = out.to(dev)
    return out


def hierarchical_all_reduce(x: torch.Tensor, *,
                            ici_axis: str = mesh_lib.DP,
                            dcn_axis: str = "dcn", scatter_axis: int = 0,
                            mesh: Optional[DeviceMesh] = None
                            ) -> torch.Tensor:
    """Two-level all-reduce (the reference's hierarchical allreduce):
    reduce-scatter over the fast ``ici_axis``, all-reduce the shard over
    the slow ``dcn_axis``, all-gather over ``ici_axis``, so the slow leg
    moves 1/|ici| of the bytes. Equal to one sum over both axes up to
    the order of the additions."""
    shard = reduce_scatter(x, ici_axis, scatter_axis=scatter_axis,
                           mesh=mesh)
    shard = all_reduce(shard, dcn_axis, mesh=mesh)
    return all_gather(shard, ici_axis, concat_axis=scatter_axis, mesh=mesh)


def barrier(axis: AxisArg = mesh_lib.DP, *,
            mesh: Optional[DeviceMesh] = None):
    """send_barrier/fetch_barrier: every member of each axis waits for
    the others."""
    for a in _axes(axis):
        dist.barrier(group=axis_group(a, mesh))
