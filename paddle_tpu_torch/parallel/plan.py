"""Sharding plans (``paddle_tpu/parallel/plan.py``): parameter placement
over a named mesh, as data.

A spec is a tuple with one entry per dimension: an axis name, a tuple of
axis names, or None (not split); ``()`` is replicated. It is the port's
``PartitionSpec`` (``tuple(P(...))`` of the reference gives the same
tuple). A :class:`ShardingPlan` maps parameter paths to specs.
Precedence for a parameter's spec:

  1. the first matching plan rule (regex over the "/"-joined path)
  2. the hint the layer declares for it (``hints=``)
  3. replicated (``()``)

With ``fsdp_largest_dim`` the largest dim of a big parameter no rule or
hint splits over "fsdp" goes over "fsdp" as well. Axes of size 1 are
harmless in any spec. Where the reference hands the specs to
``named_shardings`` and ``jax.device_put``, a rank here takes its own
slice with :func:`local_shard`.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional, Sequence, Tuple

import torch

from paddle_tpu_torch.core import mesh as mesh_lib

#: a spec: one entry per dim, an axis name, a tuple of names, or None
Spec = Tuple[Any, ...]


def P(*entries) -> Spec:
    """A spec, written as the reference writes ``PartitionSpec``."""
    return tuple(entries)


@dataclasses.dataclass
class Rule:
    pattern: str           # regex matched against "/".join(path)
    spec: Optional[Spec]   # None = replicated

    def __post_init__(self):
        self._re = re.compile(self.pattern)

    def matches(self, path_str: str) -> bool:
        return self._re.search(path_str) is not None


class ShardingPlan:
    """Ordered rules mapping parameter paths to specs (module docstring
    for the precedence)."""

    def __init__(self, rules: Sequence[Tuple[str, Optional[Spec]]] = (),
                 *, fsdp_largest_dim: bool = False,
                 fsdp_min_size: int = 2 ** 16):
        self.rules = [Rule(p, s) for p, s in rules]
        self.fsdp_largest_dim = fsdp_largest_dim
        self.fsdp_min_size = fsdp_min_size

    def spec_for(self, path: Tuple[str, ...], hint: Optional[Spec],
                 shape: Tuple[int, ...] = ()) -> Spec:
        path_str = "/".join(path)
        for rule in self.rules:
            if rule.matches(path_str):
                return tuple(rule.spec) if rule.spec is not None else ()
        spec = tuple(hint) if hint is not None else ()
        if self.fsdp_largest_dim and shape and not _names_axis(spec, "fsdp"):
            size = 1
            for d in shape:
                size *= d
            if size >= self.fsdp_min_size:
                spec = _add_fsdp(spec, shape)
        return spec

    def params_specs(self, params, hints=None) -> Any:
        """Tree of specs matching ``params`` (a nested dict of tensors or
        arrays, the reference's tree: ``models.convert.params_tree``).
        ``hints`` is an optional matching tree of spec-or-None."""
        def walk(tree, hint_tree, path):
            if isinstance(tree, dict):
                return {
                    k: walk(v,
                            hint_tree.get(k) if isinstance(hint_tree, dict)
                            else None,
                            path + (k,))
                    for k, v in tree.items()
                }
            hint = hint_tree if isinstance(hint_tree, (tuple, type(None))) \
                else None
            shape = getattr(tree, "shape", ())
            return self.spec_for(path, hint, tuple(shape))

        return walk(params, hints or {}, ())

    def state_specs(self, state, hints=None) -> Any:
        """Specs of a whole train state, as the reference's tree
        ``{"params", "opt", "step"[, "loss_scale"]}``: a port train state
        (``{"model", "opt", "step"}``, read through
        ``trainer.state_tree``) or such a tree. Optimizer slots take their
        parameter's spec (under FSDP a slot is split like its parameter);
        the step counts and everything else are replicated. ``hints`` as
        for :meth:`params_specs`."""
        if "model" in state:
            from paddle_tpu_torch.trainer import state_tree
            state = state_tree(state)
        pspecs = self.params_specs(state["params"], hints)
        out = {}
        for key, val in state.items():
            if key == "params":
                out[key] = pspecs
            elif key == "opt":
                out[key] = _opt_specs(val, pspecs)
            else:
                out[key] = _replicated(val)
        return out


def _replicated(tree):
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    return ()


def _opt_specs(opt_state, pspecs):
    if isinstance(opt_state, dict):
        return {k: ({name: pspecs for name in v}
                    if k == "slots" and isinstance(v, dict)
                    else _replicated(v))
                for k, v in opt_state.items()}
    return _replicated(opt_state)


def _names_axis(spec: Spec, axis: str) -> bool:
    for entry in spec:
        if entry == axis:
            return True
        if isinstance(entry, tuple) and axis in entry:
            return True
    return False


def _add_fsdp(spec: Spec, shape: Tuple[int, ...]) -> Spec:
    """Split the largest dim not yet split over "fsdp"."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if entries[i] is None:
            entries[i] = "fsdp"
            break
        if isinstance(entries[i], str):
            entries[i] = (entries[i], "fsdp")
            break
    return tuple(entries)


def block_index(shape, spec: Spec, coords) -> Tuple[Tuple[int, int], ...]:
    """``((start, stop), ...)`` per dim of the block of a tensor of
    ``shape`` under ``spec`` at mesh coordinates ``coords`` (axis name ->
    ``(index, size)``; an axis left out counts as size 1). A dim split
    over several axes is cut major axis first, in the order the entry
    names them, as ``NamedSharding`` cuts it; every split dim must divide
    by the product of its axes' sizes."""
    out = [(0, d) for d in shape]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n, idx = 1, 0
        for a in axes:
            i, size = coords.get(a, (0, 1))
            idx, n = idx * size + i, n * size
        if shape[dim] % n:
            raise ValueError(f"dim {dim} ({shape[dim]}) does not "
                             f"divide over {axes} ({n})")
        step = shape[dim] // n
        out[dim] = (idx * step, (idx + 1) * step)
    return tuple(out)


def shard_slice(tensor: torch.Tensor, spec: Spec, coords) -> torch.Tensor:
    """The slice of ``tensor`` under ``spec`` at mesh coordinates
    ``coords`` (:func:`block_index`), a view."""
    out = tensor
    for dim, (lo, hi) in enumerate(block_index(tuple(tensor.shape), spec,
                                               coords)):
        if (lo, hi) != (0, tensor.shape[dim]):
            out = out.narrow(dim, lo, hi - lo)
    return out


def mesh_coords(mesh) -> dict:
    """This rank's ``{axis: (index, size)}`` on ``mesh``."""
    return {a: (mesh_lib.axis_index(mesh, a), mesh_lib.axis_size(mesh, a))
            for a in mesh.mesh_dim_names or ()}


def local_shard(tensor: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's slice of ``tensor`` under ``spec`` on ``mesh``: what
    ``jax.device_put(tensor, NamedSharding(mesh, spec))`` leaves on this
    rank's device (a view)."""
    return shard_slice(tensor, spec, mesh_coords(mesh))


# Canned plans --------------------------------------------------------------

def replicated_plan() -> ShardingPlan:
    """Pure data parallel: every parameter replicated."""
    return ShardingPlan()


def fsdp_plan(min_size: int = 2 ** 16) -> ShardingPlan:
    """ZeRO-3 style: big parameters split over "fsdp"."""
    return ShardingPlan(fsdp_largest_dim=True, fsdp_min_size=min_size)


def megatron_plan() -> ShardingPlan:
    """The layers' tensor-parallel hints; everything else replicated."""
    return ShardingPlan()


#: the serving engine's head-major attention split (qkv viewed (D, 3, H,
#: Dh) split on H, the output projection viewed (H, Dh, D) split on H)
_SERVING_ATTN_RULES = (
    (r"attn/qkv_tp/weight$", P(None, None, "tp", None)),
    (r"attn/qkv_tp/bias$", P(None, "tp", None)),
    (r"attn/out_tp/weight$", P("tp", None, None)),
)


def serving_tp_plan() -> ShardingPlan:
    """Specs of the serving engine's head-major tensor-parallel layout
    (``ServingEngine(mesh=...)``): the fused qkv weight viewed ``(D, 3,
    H, Dh)`` split over "tp" on the head axis, the output projection
    viewed ``(H, Dh, D)`` split on its heads (a raw ``(D, 3D)`` column
    split would straddle the q/k/v boundaries). Everything else is
    replicated, which holds the step to one all-reduce per layer, at the
    attention output."""
    return ShardingPlan(rules=list(_SERVING_ATTN_RULES) + [(r"^", P())])


def serving_prefill_tp_plan() -> ShardingPlan:
    """:func:`serving_tp_plan` plus the Megatron MLP split of a prefill
    tier: ``fc1`` split over "tp" on its output dim, ``fc2`` on its
    input dim, its bias replicated and added once after the second
    all-reduce of the layer."""
    return ShardingPlan(rules=list(_SERVING_ATTN_RULES) + [
        (r"mlp/fc1/weight$", P(None, "tp")),
        (r"mlp/fc1/bias$", P("tp")),
        (r"mlp/fc2/weight$", P("tp", None)),
        (r"^", P()),
    ])


def paged_pool_specs(pages) -> list:
    """Specs of a paged KV pool under tp, mirroring its per-layer tuples:
    K/V pages ``(P, ps, H, Dh)`` split over "tp" on the head axis, int8
    scale rows replicated (a token's scale covers all heads:
    ``quantize_kv``'s ``group``)."""
    kv = P(None, None, "tp", None)
    return [tuple([kv, kv] + [P() for _ in ent[2:]]) for ent in pages]
