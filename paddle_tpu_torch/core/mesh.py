"""Device meshes (``paddle_tpu/core/mesh.py``) over
``torch.distributed.device_mesh.DeviceMesh``.

The reference names the axes of a ``jax.sharding.Mesh`` and lets XLA
place shards; here a mesh is a ``DeviceMesh`` over the ranks of an
initialized ``torch.distributed`` process group, one process group per
axis (``mesh.get_group(axis)``), and each rank holds its own shard. The
caller starts the group (``init_process_group`` with its address, world
size, rank and a timeout); :func:`make_mesh` never does.

``make_mesh(..., stage_cuda_through_host=True)`` is the one switch that
lets a gloo mesh hold multi-rank code on one card: under it the
collectives gloo cannot run on CUDA tensors (``ppermute``,
``all_gather``, ``reduce_scatter``, ``all_to_all``) copy the tensor to a
pinned host buffer, run over gloo and copy the result back, and count
their calls and bytes (:func:`paddle_tpu_torch.parallel.collective.
staged_stats`). It is transport only (every kernel still runs on the
card), off by default, and without it those ops raise on CUDA tensors as
they always did. An NCCL mesh never stages.

Canonical axis names (every sharding rule in
:mod:`paddle_tpu_torch.parallel` uses them):
  "dp"   data parallel             (batch dim)
  "fsdp" fully-sharded data parallel (params sharded over this too)
  "tp"   tensor/model parallel     (hidden dims, attention heads)
  "sp"   sequence/context parallel (sequence dim; ring attention)
  "pp"   pipeline parallel         (layer stages)
  "ep"   expert parallel           (MoE experts)
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DP = "dp"
FSDP = "fsdp"
TP = "tp"
SP = "sp"
PP = "pp"
EP = "ep"

ALL_AXES = (DP, FSDP, TP, SP, PP, EP)

#: axes over which a batch is split
BATCH_AXES = (DP, FSDP)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Typed mesh shape: one size per canonical axis."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1

    def axis_sizes(self) -> dict:
        return {a: getattr(self, a) for a in ALL_AXES}

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes().values())


def make_mesh(config: Optional[MeshConfig] = None, *,
              device_type: str = "cuda",
              axis_names: Optional[Sequence[str]] = None,
              shape: Optional[Sequence[int]] = None,
              stage_cuda_through_host: bool = False) -> DeviceMesh:
    """A named mesh over every rank of the initialized process group.

    With no config and no shape, a pure data-parallel mesh. A
    ``MeshConfig`` names every canonical axis, size-1 axes kept (as the
    reference keeps them), so rules can always name any axis; its size
    must equal the world size. ``shape`` with ``axis_names`` builds any
    other mesh. ``device_type`` is where the ranks' tensors live
    (``"cuda"`` unless the caller asks for the CPU).
    ``stage_cuda_through_host`` turns on the staged transport of the
    module docstring (:func:`stages_cuda`)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized torch.distributed process "
            "group: call init_process_group(backend, init_method=..., "
            "rank=..., world_size=..., timeout=...) on every rank first")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device_type='cpu' for a mesh of CPU ranks")
    n = dist.get_world_size()
    if config is None and shape is None:
        config = MeshConfig(dp=n)
    if config is not None:
        sizes = config.axis_sizes()
        if config.size != n:
            raise ValueError(
                f"mesh config {sizes} needs {config.size} ranks, have {n}")
        axis_names = ALL_AXES
        shape = tuple(sizes[a] for a in axis_names)
    if axis_names is None:
        raise ValueError("make_mesh(shape=...) requires axis_names")
    if len(axis_names) != len(shape):
        raise ValueError(f"axis_names {tuple(axis_names)} vs shape "
                         f"{tuple(shape)} length mismatch")
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {tuple(shape)} needs "
                         f"{math.prod(shape)} ranks, have {n}")
    ranks = torch.arange(n).reshape(tuple(shape))
    mesh = DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))
    mesh.stage_cuda_through_host = bool(stage_cuda_through_host)
    return mesh


def single_device_mesh(device_type: str = "cuda") -> DeviceMesh:
    """A trivial one-device mesh (every canonical axis of size 1) over an
    initialized one-rank process group, which the caller starts as for
    :func:`make_mesh` (for one process alone: ``init_process_group(
    "gloo", store=torch.distributed.HashStore(), rank=0,
    world_size=1)``)."""
    if dist.is_initialized() and dist.get_world_size() != 1:
        raise ValueError(
            f"single_device_mesh needs a one-rank process group, have "
            f"{dist.get_world_size()} ranks: use make_mesh")
    return make_mesh(MeshConfig(), device_type=device_type)


def local_device_count() -> int:
    """Cards this process sees (one CPU device without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def device_count() -> int:
    """Devices of the job: one a rank of the initialized process group
    (a rank holds one card), else :func:`local_device_count`."""
    if dist.is_initialized():
        return dist.get_world_size()
    return local_device_count()


def stages_cuda(mesh: Optional[DeviceMesh]) -> bool:
    """Whether ``mesh`` was made with ``stage_cuda_through_host=True``."""
    return bool(getattr(mesh, "stage_cuda_through_host", False))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Size of the mesh's ``axis`` (1 for an axis the mesh lacks)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's position along ``axis`` (the reference's
    ``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


_CURRENT_MESH: List[DeviceMesh] = []


@contextlib.contextmanager
def mesh_context(mesh: DeviceMesh):
    """Push ``mesh`` as the ambient default for the block."""
    _CURRENT_MESH.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT_MESH.pop()


def current_mesh() -> Optional[DeviceMesh]:
    """The innermost :func:`mesh_context` mesh, or None."""
    return _CURRENT_MESH[-1] if _CURRENT_MESH else None
