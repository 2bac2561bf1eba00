"""Sharded train and eval steps (``paddle_tpu/parallel/api.py``) on
``torch.distributed``.

The reference hands one jitted step to GSPMD with input and output
shardings, and XLA inserts the collectives. Here every rank runs the
step on its own shard of the state and the batch, and the collectives
are explicit:

- placement: :func:`shard_train_step` cuts each parameter and its
  optimizer slots to this rank's block under the plan's spec
  (``plan.state_specs``; ``placed`` is that state, changed in place);
- data axes ("dp", "fsdp", "sp"): each rank's batch is its block under
  the batch spec (:func:`batch_specs`); losses that are means over the
  batch divide global sums by global counts
  (``parallel.functional.global_mean``), and after the backward the
  gradients are averaged over the data axes, one bucketed all-reduce per
  dtype (``replicated``);
- FSDP: a parameter whose spec names "fsdp" is stored as its block; the
  forward reads it through an all-gather whose transpose is a
  reduce-scatter of its gradient (:class:`_FsdpGather`), so the update
  runs on the local block and its sharded slots; what the graph saves of
  a gathered parameter for the backward is its block, gathered again
  when the backward needs it (``StepSharding.saving``);
- Megatron, from the layers' hints ("tp"): a column-split ``Linear``
  keeps its output split into the row-split ``Linear`` that follows it
  (the MLP's ``fc1``/``fc2``; the attention's ``qkv_proj`` gathers its
  output and keeps this rank's heads for the row-split ``out_proj``),
  which all-reduces; a column-split layer with no row-split partner
  all-gathers its output (a row-split layer with no column-split one
  before it is refused); a vocab-split ``Embedding`` masks the ids
  outside its rows and all-reduces, and its tied projection all-gathers
  the logits. Each communication is a ``torch.autograd.Function`` with
  its transpose in the backward (``parallel.functional``);
- pipelines ("pp", from a ``StackedLayers``' hints): a stacked
  parameter whose spec names "pp" is stored as this stage's rows, which
  the model's pipeline (:mod:`~paddle_tpu_torch.parallel.pipeline`) runs;
  every rank of a pp group holds the same batch, so the gradients are
  still averaged over the data axes only, and draws the same dropout
  masks: each step runs on a default generator seeded from stage 0's
  (:func:`step_rng`);
- experts ("ep", from a ``MoEFeedForward``'s hints): its expert
  tensors are stored as this rank's ``E/ep`` experts, and the layer
  (:class:`ExpertPlacement`, ``nn/moe.py``) routes globally over the
  axes that split the tokens (:func:`token_layout`: the batch spec's dim
  0 axes in its order, "sp" on dim 1). Where the batch spec does not
  name "ep", "ep" is a model axis like "tp": the ranks of a token shard
  hold the same tokens, each runs its experts, the output is summed over
  "ep", and the Megatron pair makes every replicated gradient (the
  router's among them) whole inside the backward. Where it does (GShard's
  layout, ``P(("dp", "ep"))``), "ep" is a data axis of the step: the
  tokens reach their experts by an all-to-all, the metrics and the
  losses' global means run over it (``parallel.functional.token_layout``
  names it to the loss), and the gradient hook sums over it every
  gradient but the expert blocks', which the all-to-all's transpose
  already made whole over the "ep" group (as an FSDP block's
  reduce-scatter does over "fsdp"). A live "pp" with the MoE outside any
  stack holds the same tokens on its ranks; a MoE inside a pipelined
  stack, and a router split over "ep" or "tp", are refused by name;
- norms: the optimizer's clip by norm and its trust ratios take each
  split parameter's squared sums over the axes it is split over
  (``Optimizer.norm_reduce``), so they are the whole tensors' norms and
  equal on every rank.

A step with collectives runs eagerly (a gloo collective cannot be
captured in a CUDA graph; ``TrainStepGraphs.check_capturable``). On a
gloo mesh of one card the gathers and scatters need the mesh's
``stage_cuda_through_host`` switch (``core/mesh.py``).
"""

from __future__ import annotations

import contextlib
import math
import weakref
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import is_fake

from paddle_tpu_torch.core import mesh as mesh_lib
from paddle_tpu_torch.parallel import collective
from paddle_tpu_torch.parallel import functional as pf
from paddle_tpu_torch.parallel import plan as plan_lib
from paddle_tpu_torch.parallel.plan import P

#: the batch's spec unless told otherwise: dim 0 over the batch axes
BATCH_SPEC = P(mesh_lib.BATCH_AXES)
#: axes a parameter's spec may name here
PARAM_AXES = (mesh_lib.FSDP, mesh_lib.TP, mesh_lib.PP, mesh_lib.EP)


def batch_specs(batch: Mapping[str, Any], *, seq_dim: Optional[int] = None
                ) -> Dict[str, tuple]:
    """Per-feed specs: dim 0 over ("dp", "fsdp"); with ``seq_dim``, that
    dim of a feed of rank > ``seq_dim`` over "sp" (sequence
    parallelism). 0-d feeds are replicated."""
    def spec(x):
        ndim = getattr(x, "ndim", 0)
        if ndim == 0:
            return P()
        entries = [mesh_lib.BATCH_AXES] + [None] * (ndim - 1)
        if seq_dim is not None and ndim > seq_dim:
            entries[seq_dim] = mesh_lib.SP
        return P(*entries)

    return {k: spec(v) for k, v in batch.items()}


def local_batch(batch: Mapping[str, Any], mesh, spec=BATCH_SPEC):
    """This rank's block of every feed of the global ``batch`` under
    ``spec`` (one spec for every feed, or a dict of them)."""
    out = {}
    for k, v in batch.items():
        s = spec[k] if isinstance(spec, Mapping) else spec
        if isinstance(v, torch.Tensor) and v.ndim:
            v = plan_lib.local_shard(v, s, mesh).contiguous()
        out[k] = v
    return out


def _names(spec) -> set:
    out = set()
    for entry in spec:
        if entry is not None:
            out.update((entry,) if isinstance(entry, str) else entry)
    return out


def _dim_naming(spec, axis: str) -> Optional[int]:
    for dim, entry in enumerate(spec):
        if entry is not None and axis in ((entry,) if isinstance(entry, str)
                                          else entry):
            return dim
    return None


class _FsdpGather(torch.autograd.Function):
    """A parameter's block gathered over "fsdp" along ``dim``; the
    transpose reduce-scatters the gradient back to the block."""

    @staticmethod
    def forward(ctx, p, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return collective.all_gather(p.contiguous(), mesh_lib.FSDP,
                                     concat_axis=dim, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return (collective.reduce_scatter(g.contiguous(), mesh_lib.FSDP,
                                          scatter_axis=ctx.dim,
                                          mesh=ctx.mesh), None, None)


# ---------------------------------------------------------------------------
# Megatron roles (the layers call them when one is set)
# ---------------------------------------------------------------------------

class TpLinear:
    """A split ``Linear``'s role. ``column``: the input is replicated
    (:func:`~paddle_tpu_torch.parallel.functional.copy_to`), the output
    is this rank's columns, gathered unless ``keep_split`` (``disjoint``
    when the gathered value's parts feed only their own rank). ``row``:
    the input is the split its column-split partner kept, the partial
    products all-reduced, the bias added once."""

    def __init__(self, mesh, kind: str, *, keep_split=False, disjoint=False):
        self.mesh, self.kind = mesh, kind
        self.keep_split, self.disjoint = keep_split, disjoint

    def linear(self, layer, x):
        tp, mesh = mesh_lib.TP, self.mesh
        if self.kind == "column":
            out = torch.matmul(pf.copy_to(x, tp, mesh), layer.weight)
            if layer.bias is not None:
                out = out + layer.bias
            if self.keep_split:
                return out
            return pf.gather_from(out, tp, mesh, -1, disjoint=self.disjoint)
        out = pf.reduce_from(torch.matmul(x, layer.weight), tp, mesh)
        return out if layer.bias is None else out + layer.bias


class TpEmbedding:
    """A vocab-split ``Embedding``'s role: a lookup of the ids in this
    rank's rows (the others masked to zero), all-reduced; the tied
    projection's logits over this rank's rows (its bias split alike),
    all-gathered."""

    def __init__(self, mesh):
        self.mesh = mesh

    def lookup(self, layer, ids):
        from paddle_tpu_torch.nn.layers import embedding
        rows = layer.weight.shape[0]
        lo = mesh_lib.axis_index(self.mesh, mesh_lib.TP) * rows
        mine = (ids >= lo) & (ids < lo + rows)
        local = torch.where(mine, ids - lo, torch.zeros_like(ids))
        out = embedding(local, layer.weight) * mine[..., None].to(
            layer.weight.dtype)
        return pf.reduce_from(out, mesh_lib.TP, self.mesh)

    def attend(self, layer, x, bias=None):
        x = pf.copy_to(x, mesh_lib.TP, self.mesh)
        out = torch.einsum("bsd,vd->bsv", x, layer.weight)
        if bias is not None:
            out = out + bias
        return pf.gather_from(out, mesh_lib.TP, self.mesh, -1)


class TokenLayout(NamedTuple):
    """The axes that split a step's tokens, read from its batch spec
    (:func:`token_layout`): ``batch``, the live axes of dim 0 in the
    spec's order (major first: ``("dp", "ep")`` is dp-major), and
    ``seq``, ``("sp",)`` where dim 1 names it (the reference's
    ``batch_specs(seq_dim=1)``). GSPMD keeps the logical (B, S) array, so
    the rank holding rows [b0, b1) is fixed by that order."""

    batch: tuple
    seq: tuple

    @property
    def axes(self) -> tuple:
        return self.batch + self.seq


def token_layout(batch_spec, mesh) -> TokenLayout:
    """The :class:`TokenLayout` of ``batch_spec`` (one spec, or a dict of
    them by feed) on ``mesh``. Feeds whose dim 0 is split over other axes,
    or in another order, raise ``ValueError`` naming them."""
    specs = (dict(batch_spec) if isinstance(batch_spec, Mapping)
             else {"batch": batch_spec})
    layouts, seq = {}, ()
    for feed, spec in specs.items():
        spec = tuple(spec or ())
        if spec and spec[0] is not None:
            entry = (spec[0],) if isinstance(spec[0], str) else spec[0]
            layouts[feed] = pf.live_axes(mesh, entry)
        if len(spec) > 1 and spec[1] is not None and mesh_lib.SP in (
                (spec[1],) if isinstance(spec[1], str) else spec[1]):
            seq = pf.live_axes(mesh, (mesh_lib.SP,))
    if len(set(layouts.values())) > 1:
        raise ValueError(f"the feeds split their tokens over different "
                         f"axes (dim 0 by feed: {layouts}); a step takes "
                         "one token layout")
    return TokenLayout(next(iter(layouts.values()), ()), seq)


def _major_first(mesh, axes):
    """This rank's index over ``axes`` (major first) and their size."""
    idx, n = 0, 1
    for a in axes:
        size = mesh_lib.axis_size(mesh, a)
        idx, n = idx * size + mesh_lib.axis_index(mesh, a), n * size
    return idx, n


class _WholeBlock(torch.autograd.Function):
    """This rank's block of a tensor every rank holds whole (``cuts``:
    ``(dim, lo, hi)``); the backward puts the gradient in a zero tensor
    of the whole shape and sums it over ``axes``."""

    @staticmethod
    def forward(ctx, t, cuts, axes, mesh):
        ctx.cuts, ctx.axes, ctx.mesh, ctx.shape = cuts, axes, mesh, t.shape
        for dim, lo, hi in cuts:
            t = t.narrow(dim, lo, hi - lo)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        whole = g.new_zeros(ctx.shape)
        view = whole
        for dim, lo, hi in ctx.cuts:
            view = view.narrow(dim, lo, hi - lo)
        view.copy_(g)
        if ctx.axes:
            whole = collective.all_reduce(whole, ctx.axes, mesh=ctx.mesh)
        return whole, None, None, None


class ExpertPlacement:
    """A ``MoEFeedForward``'s role on a mesh (``nn/moe.py`` says what the
    layer computes with it): the token axes its routing is global over
    (``layout``), the block of experts this rank runs ("ep"), how the
    tokens reach them (an all-to-all over "ep" where "ep" splits the
    tokens, else the Megatron pair over "ep"), and the Megatron pair over
    "tp" inside each expert (``tp_split``). ``whole``: the expert tensors
    every rank holds whole, by name, with the ``(axis, dim)`` pairs their
    block is read over."""

    def __init__(self, mesh, layout: TokenLayout, *, ep_split: bool,
                 tp_split: bool, whole: Optional[Dict[str, tuple]] = None,
                 router_split: tuple = ()):
        self.mesh, self.layout = mesh, layout
        #: this rank's row block (batch axes, major first) and their count
        self.shard, n_rows = _major_first(mesh, layout.batch)
        self.seq_index, n_seq = _major_first(mesh, layout.seq)
        #: ranks holding other tokens: the global count is n_tokens x local
        self.n_tokens = n_rows * n_seq
        self.ep = mesh_lib.axis_size(mesh, mesh_lib.EP) if ep_split else 1
        self.tp = mesh_lib.axis_size(mesh, mesh_lib.TP) if tp_split else 1
        #: the experts' tokens arrive by all-to-all: "ep" splits them
        self.exchange = self.ep > 1 and mesh_lib.EP in layout.batch
        #: live axes whose ranks hold the same tokens
        self.shared_axes = tuple(a for a in pf.live_axes(mesh,
                                                         mesh_lib.ALL_AXES)
                                 if a not in layout.axes)
        self.whole = dict(whole or {})
        #: ``(axis, dim)`` pairs the router is split on ("ep"/"tp")
        self.router_split = tuple(router_split)

    def experts(self, e: int):
        """``(lo, hi)``: the experts this rank runs."""
        n = e // self.ep
        lo = mesh_lib.axis_index(self.mesh, mesh_lib.EP) * n \
            if self.ep > 1 else 0
        return lo, lo + n

    def params(self, layer):
        """``(w1, b1, w2, b2)`` as this rank runs them: a tensor held whole
        read as its block (its gradient summed over the axes its block
        was cut on that hold the same tokens; over a token axis the step's
        gradient sum does it)."""
        out = []
        for name in ("w1", "b1", "w2", "b2"):
            t = getattr(layer, name)
            cuts = []
            for axis, dim in self.whole.get(name, ()):
                n = t.shape[dim] // mesh_lib.axis_size(self.mesh, axis)
                lo = mesh_lib.axis_index(self.mesh, axis) * n
                cuts.append((dim, lo, lo + n))
            if cuts:
                t = _WholeBlock.apply(
                    t, tuple(cuts),
                    tuple(a for a, _ in self.whole[name]
                          if a not in self.layout.axes), self.mesh)
            out.append(t)
        return out

    def router(self, layer):
        """The router whole: its blocks gathered over the axes it is
        split on, as GSPMD gathers it. The gradient goes back to this
        rank's block: a slice where the axis's ranks hold the same tokens
        (each has the whole gradient), a reduce-scatter where the axis
        splits the tokens (the step's hook then skips that axis, as for
        an expert block)."""
        r = layer.router
        for axis, dim in self.router_split:
            r = pf.gather_from(r, axis, self.mesh, dim,
                               disjoint=axis in self.layout.axes)
        return r

    def same_where_tokens_are(self, t):
        """``t`` of the first rank among those holding this rank's tokens
        (router noise: ranks with other tokens keep their own draws)."""
        for a in self.shared_axes:
            t = collective.broadcast(t, a, root=0, mesh=self.mesh)
        return t

    def queue_offsets(self, rows):
        """``rows`` (B_local, k, E): this rank's routed count of each
        expert by row and choice. Returns ``(before, total)``: by row and
        choice, the tokens in each expert's queue ahead of the row's
        first local token in the reference's flattened (b, s) order
        (every earlier row whole, then this row's earlier "sp" shards),
        and each choice's global count."""
        if self.layout.seq:
            every = collective.all_gather(rows[None].contiguous(),
                                          self.layout.seq, concat_axis=0,
                                          mesh=self.mesh)
            whole = every.sum(0)
            earlier = every[:self.seq_index].sum(0)
        else:
            whole, earlier = rows, torch.zeros_like(rows)
        before = torch.cumsum(whole, 0) - whole + earlier
        shard = whole.sum(0)
        if not self.layout.batch:
            return before, shard
        every = collective.all_gather(shard[None].contiguous(),
                                      tuple(reversed(self.layout.batch)),
                                      concat_axis=0, mesh=self.mesh)
        return before + every[:self.shard].sum(0), every.sum(0)

    def data_sum(self, t):
        if not self.layout.axes:
            return t
        return collective.all_reduce(t, self.layout.axes, mesh=self.mesh)

    def global_mean(self, total, count: int):
        """``total`` summed over the token axes over the global count (the
        gradient's transpose included)."""
        # new_full, not torch.tensor: a literal is a constant on fake
        # tensors, and a trace would run the collective on it
        return pf.global_mean(total, total.new_full((), float(count)),
                              self.layout.axes, self.mesh)

    def into_experts(self, t):
        """A replicated value entering this rank's experts (ranks of "ep"
        holding the same tokens)."""
        if self.ep > 1 and not self.exchange:
            return pf.copy_to(t, mesh_lib.EP, self.mesh)
        return t

    def out_of_experts(self, t):
        if self.ep > 1 and not self.exchange:
            return pf.reduce_from(t, mesh_lib.EP, self.mesh)
        return t

    def to_experts(self, xe):
        """(E, C_send, D), this rank's tokens by expert: each "ep" rank's
        block of experts sent to it, what arrives from the group
        concatenated by slot: (E/ep, ep x C_send, D)."""
        return pf.all_to_all(xe, mesh_lib.EP, self.mesh, 0, 1)

    def from_experts(self, ye):
        """The inverse: (E/ep, ep x C_send, D) back to (E, C_send, D)."""
        return pf.all_to_all(ye, mesh_lib.EP, self.mesh, 1, 0)

    def into_expert_columns(self, t):
        return pf.copy_to(t, mesh_lib.TP, self.mesh) if self.tp > 1 else t

    def out_of_expert_rows(self, t):
        return pf.reduce_from(t, mesh_lib.TP, self.mesh) if self.tp > 1 \
            else t


#: the dims of a MoE layer's expert tensors that the hints split: (over
#: "ep", over "tp") per tensor; each tensor is split so on an axis, or
#: held whole
_EXPERT_DIMS = {"w1": (0, 2), "b1": (0, 1), "w2": (0, 1), "b2": (0, None)}


def _install_experts(model, specs: Dict[str, tuple], mesh,
                     layout: TokenLayout) -> int:
    """Give every ``MoEFeedForward`` of ``model`` its
    :class:`ExpertPlacement` on ``mesh`` (where the mesh has a live axis);
    returns how many it placed. A layout the placement does not run
    raises ``NotImplementedError`` naming it: a MoE inside a stack on a
    pipeline, a router split over "ep" or "tp" on a dim shared with
    another axis, an expert tensor split on another dim than the
    hints'. A router split over "ep" or "tp" is gathered before routing
    (:meth:`ExpertPlacement.router`)."""
    from paddle_tpu_torch.nn.module import layer_modules
    from paddle_tpu_torch.nn.moe import MoEFeedForward
    live = pf.live_axes(mesh, mesh_lib.ALL_AXES)
    placed = 0
    for name, mod, stacked in layer_modules(model):
        if not isinstance(mod, MoEFeedForward) or not live:
            continue
        if stacked and mesh_lib.PP in live:
            raise NotImplementedError(
                f"{name}: a MoEFeedForward inside a pipelined stack is not "
                "supported (the reference's pipeline body routes each "
                "microbatch on its own and returns no aux_loss)")

        def spec(p):
            got = specs.get(f"{name}.{p}".lstrip("."), ())
            return got[1:] if stacked else got

        split = {f"{name}.{p}".lstrip("."): spec(p)
                 for p in ("router", *_EXPERT_DIMS)}
        router_split = []
        for dim, entry in enumerate(spec("router") or ()):
            axes = _names((entry,)) & {mesh_lib.EP, mesh_lib.TP}
            if not axes:
                continue
            if isinstance(entry, tuple) and len(entry) > 1:
                raise NotImplementedError(
                    f"MoE router split as {spec('router')} is not "
                    f"supported: over 'ep' or 'tp' a router dim is split "
                    f"by that one axis ({split})")
            axis = entry if isinstance(entry, str) else entry[0]
            if axis in live:
                router_split.append((axis, dim))
        split_on, whole = {}, {}
        for i, axis in enumerate((mesh_lib.EP, mesh_lib.TP)):
            dims = {p: _dim_naming(spec(p), axis) for p in _EXPERT_DIMS}
            if any(d is not None and d != _EXPERT_DIMS[p][i]
                   for p, d in dims.items()):
                raise NotImplementedError(
                    f"MoE experts split as {split} are not supported: "
                    f"over {axis!r} each of w1, b1, w2, b2 is split on the "
                    "dim its hint names (ep: dim 0; tp: w1/b1 columns, w2 "
                    "rows, b2 whole) or held whole")
            split_on[axis] = axis in live and any(
                d is not None for d in dims.values())
            for p, d in dims.items():
                if split_on[axis] and d is None \
                        and _EXPERT_DIMS[p][i] is not None:
                    whole[p] = whole.get(p, ()) + ((axis,
                                                    _EXPERT_DIMS[p][i]),)
        mod.placement = ExpertPlacement(
            mesh, layout, ep_split=split_on[mesh_lib.EP],
            tp_split=split_on[mesh_lib.TP], whole=whole,
            router_split=tuple(router_split))
        placed += 1
    return placed


def _install_tp(model, specs: Dict[str, tuple], mesh):
    """Set the Megatron roles of ``model``'s layers from their specs (a
    ``StackedLayers``' template from its stacked parameters' specs,
    the stage axis in front dropped: the spec of one layer's rows)."""
    from paddle_tpu_torch.nn.layers import Embedding, Linear
    from paddle_tpu_torch.nn.module import layer_modules
    from paddle_tpu_torch.nn.transformer import (FeedForward,
                                                 MultiHeadAttention)
    tp = mesh_lib.axis_size(mesh, mesh_lib.TP)
    listed = list(layer_modules(model))
    modules = [m for _, m, _ in listed]
    names = {id(m): n for n, m, _ in listed}
    stacked = {id(m) for _, m, st in listed if st}

    def kind(layer):
        spec = specs.get(f"{names[id(layer)]}.weight".lstrip("."), ())
        if id(layer) in stacked:
            spec = spec[1:]
        dim = _dim_naming(spec, mesh_lib.TP)
        if dim is None:
            return None
        if isinstance(layer, Embedding):
            if dim != 0:
                raise NotImplementedError(
                    "an Embedding splits over tp on its rows only")
            return "vocab"
        return "column" if dim == 1 else "row"

    roles = {}
    for mod in modules:
        if isinstance(mod, FeedForward) and kind(mod.fc1) == "column" \
                and kind(mod.fc2) == "row":
            roles[id(mod.fc1)] = TpLinear(mesh, "column", keep_split=True)
            roles[id(mod.fc2)] = TpLinear(mesh, "row")
        elif isinstance(mod, MultiHeadAttention):
            qkv, out = kind(mod.qkv_proj), kind(mod.out_proj)
            if out == "row":
                if qkv != "column" or mod.num_heads % tp:
                    raise NotImplementedError(
                        "a row-split attention output projection needs a "
                        "column-split qkv_proj and heads divisible by tp")
                n = mod.num_heads // tp
                mod.local_heads = (mesh_lib.axis_index(mesh, mesh_lib.TP)
                                   * n, n)
                roles[id(mod.qkv_proj)] = TpLinear(mesh, "column",
                                                   disjoint=True)
                roles[id(mod.out_proj)] = TpLinear(mesh, "row")
    for mod in modules:
        if not isinstance(mod, (Linear, Embedding)):
            continue
        k = kind(mod)
        if k is None:
            continue
        if k == "vocab":
            mod.tp = TpEmbedding(mesh)
        elif id(mod) in roles:
            mod.tp = roles[id(mod)]
        elif k == "column":
            mod.tp = TpLinear(mesh, k)
        else:
            raise NotImplementedError(
                "a row-split Linear needs the column-split layer before it "
                "(the MLP's fc1/fc2, the attention's qkv/out projections)")


# ---------------------------------------------------------------------------
# the step's sharding: what build_train_step(sharding=...) calls
# ---------------------------------------------------------------------------

def _flat_specs(tree, prefix="") -> Dict[str, tuple]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat_specs(v, name))
        else:
            out[name] = tuple(v) if v is not None else ()
    return out


class StepSharding:
    """A train step's placement on ``mesh``: the forward's parameter
    views (FSDP's gathers), the gradient hook (the data axes' average)
    and the metrics' average. ``specs`` maps parameter names to specs.

    ``regather`` (FSDP): while the forward runs (:meth:`saving`), a
    tensor autograd saves for the backward that is a gathered parameter,
    or a view of one, is saved as its block and gathered again when the
    backward unpacks it (``torch.autograd.graph.saved_tensors_hooks``),
    so the graph holds the blocks alone. The values are the same bits.
    (Under a compute-dtype policy the forward reads a cast of the
    gathered parameter, a tensor of its own, which the graph keeps.)
    ``saved`` counts, for the last forward, the bytes of gathered
    parameters the graph holds (``"gathered"``) and of the blocks it
    holds in their place (``"blocks"``)."""

    def __init__(self, mesh, specs: Dict[str, tuple], *,
                 regather: bool = True,
                 layout: Optional[TokenLayout] = None):
        self.mesh = mesh
        #: the axes that split the tokens (the batch spec's)
        self.layout = layout or token_layout(BATCH_SPEC, mesh)
        self.specs = specs
        self.regather = regather
        #: data_ptr of a gathered parameter's storage -> (a weak reference
        #: to it, its block, the gathered dim), for the forward in flight
        self._gathered: Dict[int, tuple] = {}
        self.saved = {"gathered": 0, "blocks": 0}
        # "ep" splitting the tokens (GShard's layout) is a data axis too
        self.data_axes = pf.live_axes(mesh, pf.DATA_AXES) + tuple(
            a for a in (mesh_lib.EP,) if a in self.layout.axes)
        self.n_data = math.prod(mesh_lib.axis_size(mesh, a)
                                for a in self.data_axes)
        fsdp = pf.live_axes(mesh, (mesh_lib.FSDP,))
        self.fsdp_dims = {n: _dim_naming(s, mesh_lib.FSDP)
                          for n, s in specs.items()
                          if fsdp and _dim_naming(s, mesh_lib.FSDP)
                          is not None}
        #: parameters split over "ep": their gradients arrive whole over
        #: it (through the all-to-all's transpose)
        self.ep_split = {n for n, s in specs.items()
                         if mesh_lib.EP in _names(s)}
        live = pf.live_axes(mesh, mesh_lib.ALL_AXES)
        #: the backend of the step's collectives (None: it holds none)
        self.backend = (dist.get_backend(mesh.get_group(live[0]))
                        if live else None)
        #: id of a parameter -> the live axes its block is split over
        self.split_axes: Dict[int, tuple] = {}

    def attach(self, model, opt):
        """Bind ``opt``'s norms to this placement: each split parameter's
        squared sums are summed over the axes it is split over
        (:meth:`reduce_sq`), so a clip by norm and the trust ratios of
        LarsMomentum and Lamb see whole tensors."""
        live = set(pf.live_axes(self.mesh, PARAM_AXES))
        for name, p in model.named_parameters():
            axes = tuple(a for a in PARAM_AXES
                         if a in live and a in _names(self.specs.get(name,
                                                                     ())))
            if axes:
                self.split_axes[id(p)] = axes
        while getattr(opt, "inner", None) is not None:
            opt = opt.inner
        if opt is not None and self.split_axes:
            opt.norm_reduce = self.reduce_sq

    def reduce_sq(self, params, sq):
        """``sq[i]``, the squared sum of a tensor shaped like
        ``params[i]``, summed over the ranks that hold the other blocks
        of that parameter: one all-reduce per set of axes (the same sets,
        in the same order, on every rank)."""
        groups: Dict[tuple, list] = {}
        for i, p in enumerate(params):
            axes = self.split_axes.get(id(p))
            if axes:
                groups.setdefault(axes, []).append(i)
        if not groups:
            return sq
        sq = sq.clone()
        for axes in sorted(groups):
            idx = torch.tensor(groups[axes], device=sq.device)
            sq[idx] = collective.all_reduce(sq[idx], axes, mesh=self.mesh)
        return sq

    def views(self, name: str, p):
        dim = self.fsdp_dims.get(name)
        if dim is None:
            return p
        out = _FsdpGather.apply(p, self.mesh, dim)
        if not is_fake(out):
            self._gathered[out.untyped_storage().data_ptr()] = (
                weakref.ref(out), p, dim)
        return out

    def _pack(self, t):
        ent = None
        if self._gathered and not is_fake(t):
            ent = self._gathered.get(t.untyped_storage().data_ptr())
        whole = ent[0]() if ent is not None else None
        if whole is None or whole.dtype != t.dtype:
            return t
        if not self.regather:
            self.saved["gathered"] += t.untyped_storage().nbytes()
            return t
        block, dim = ent[1], ent[2]
        self.saved["blocks"] += block.untyped_storage().nbytes()
        return (_Regathered, block, dim, tuple(t.shape), t.stride(),
                t.storage_offset())

    def _unpack(self, obj):
        if not (isinstance(obj, tuple) and obj and obj[0] is _Regathered):
            return obj
        _, block, dim, shape, stride, offset = obj
        whole = collective.all_gather(block.detach().contiguous(),
                                      mesh_lib.FSDP, concat_axis=dim,
                                      mesh=self.mesh)
        return whole.as_strided(shape, stride, offset)

    @contextlib.contextmanager
    def saving(self):
        """Around a forward: what its graph saves of the gathered
        parameters (the class docstring)."""
        if not self.fsdp_dims:
            yield
            return
        self._gathered.clear()
        self.saved = {"gathered": 0, "blocks": 0}
        try:
            with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                          self._unpack):
                yield
        finally:
            self._gathered.clear()

    def sync_grads(self, model):
        """Average every gradient over the data axes: a sum over the
        axes it was not yet summed over (an FSDP block's reduce-scatter
        summed it over "fsdp", an expert block's all-to-all over a
        token-splitting "ep"), one all-reduce per bucket, then a division
        by the data axes' ranks."""
        if not self.data_axes:
            return
        buckets: Dict[tuple, list] = {}
        for name, p in model.named_parameters():
            if p.grad is None:
                continue
            axes = tuple(a for a in self.data_axes
                         if not (a == mesh_lib.FSDP
                                 and name in self.fsdp_dims)
                         and not (a == mesh_lib.EP
                                  and name in self.ep_split))
            buckets.setdefault((axes, p.grad.dtype, p.grad.device),
                               []).append(p.grad)
        for (axes, _, _), grads in buckets.items():
            if axes:
                flat = torch.cat([g.reshape(-1) for g in grads])
                flat = collective.all_reduce(flat, axes, mesh=self.mesh)
                off = 0
                for g in grads:
                    g.copy_(flat[off:off + g.numel()].view_as(g))
                    off += g.numel()
            for g in grads:
                g.div_(self.n_data)

    def metrics(self, metrics: Dict[str, torch.Tensor]):
        """Each metric's mean over the data axes (one all-reduce)."""
        if not self.data_axes or not metrics:
            return metrics
        keys = sorted(metrics)
        vec = torch.stack([metrics[k].float().reshape(()) for k in keys])
        vec = collective.all_reduce(vec, self.data_axes,
                                    mesh=self.mesh) / self.n_data
        return {k: vec[i] for i, k in enumerate(keys)}


class _Regathered:
    """Marks a saved tensor that the backward gathers again."""


def _place(model, opt, specs: Dict[str, tuple], mesh):
    """Cut every parameter, and its optimizer slots, to this rank's block
    under its spec (in place: ``p.data`` and the slot entries; a
    ``LookaheadOptimizer``'s inner slots and slow weights alike)."""
    named = dict(model.named_parameters())
    slow = {}
    while getattr(opt, "inner", None) is not None:
        for i, p in enumerate(opt.params()):
            slow.setdefault(p, []).append((opt.slow, i))
        opt = opt.inner
    for name, spec in specs.items():
        bad = _names(spec) - set(PARAM_AXES)
        if bad:
            raise NotImplementedError(
                f"{name}: a parameter split over {sorted(bad)} is not "
                f"supported (parameters split over {list(PARAM_AXES)})")
        entry = spec[_dim_naming(spec, mesh_lib.FSDP)] \
            if _dim_naming(spec, mesh_lib.FSDP) is not None else None
        if isinstance(entry, tuple) and entry[-1] != mesh_lib.FSDP:
            raise NotImplementedError(
                f"{name}: 'fsdp' must be the minor axis of a dim it "
                f"shares ({spec})")
        p = named[name]
        full = tuple(p.shape)
        with torch.no_grad():
            p.data = plan_lib.local_shard(p.data, spec, mesh).contiguous() \
                .clone()
        for held, i in slow.get(p, ()):
            held[i] = plan_lib.local_shard(held[i], spec, mesh) \
                .contiguous().clone()
        if opt is None:
            continue
        slots = opt.state.get(p, {})
        for s, t in list(slots.items()):
            if isinstance(t, torch.Tensor) and tuple(t.shape) == full:
                slots[s] = plan_lib.local_shard(t, spec, mesh).contiguous() \
                    .clone()


def _param_specs(model, plan, hints, state=None):
    tree = (plan.state_specs(state, hints)["params"] if state is not None
            else plan.params_specs(_params_tree(model), hints))
    return _flat_specs(tree)


def _params_tree(model):
    from paddle_tpu_torch.models.convert import params_tree
    return params_tree(model)


@contextlib.contextmanager
def step_rng(mesh, device, layout: Optional[TokenLayout] = None):
    """One step's random draws on ``device`` (dropout): its default
    generator, for the step, seeded from one draw of the CPU's default
    generator on the first rank of this rank's pp x tp x ep group
    (broadcast over those axes, less any that splits the tokens under
    ``layout``; ``mesh`` None or none of them live: this rank's draw). So
    every stage of a pipeline, and every Megatron or expert rank holding
    the same tokens, draws the same masks, the embeddings' too, whatever
    the ranks' own generators hold (the reference keeps one dropout key
    in the replicated train state), and pp=1 draws what pp=n does from
    the same generator. The ranks' own generators move on by that one
    draw alone; the data shards keep their own streams. In a trace on
    fake tensors (the analysis tiers) nothing is drawn."""
    if detect_fake_mode() is not None:
        yield
        return
    seed = torch.randint(0, 2 ** 62, (1,), dtype=torch.int64)
    split = layout.axes if layout is not None else ()
    for axis in pf.live_axes(mesh, (mesh_lib.PP, mesh_lib.TP, mesh_lib.EP)):
        if axis not in split:
            seed = collective.broadcast(seed, axis, root=0, mesh=mesh)
    device = torch.device(device)
    cuda = device.type == "cuda"
    index = (device.index if device.index is not None
             else torch.cuda.current_device()) if cuda else None
    with torch.random.fork_rng(devices=[index] if cuda else []):
        gen = (torch.cuda.default_generators[index] if cuda
               else torch.default_generator)
        gen.manual_seed(int(seed[0]))
        yield


def _install(model, specs, mesh, batch_spec) -> TokenLayout:
    """The Megatron roles and the MoE placements of ``model``; returns the
    batch spec's token layout."""
    layout = token_layout(batch_spec, mesh)
    if mesh_lib.axis_size(mesh, mesh_lib.TP) > 1:
        _install_tp(model, specs, mesh)
    if _install_experts(model, specs, mesh, layout):
        for spec in (batch_spec.values() if isinstance(batch_spec, Mapping)
                     else [batch_spec]):
            bad = {a for dim, entry in enumerate(spec or ())
                   for a in _names((entry,))
                   if a in pf.live_axes(mesh, (mesh_lib.TP, mesh_lib.PP))
                   or (a == mesh_lib.SP and dim != 1)}
            if bad:
                raise NotImplementedError(
                    f"a batch split as {tuple(spec)} beside a placed "
                    "MoEFeedForward is not supported: its tokens split "
                    "over dp, fsdp and ep on dim 0 and over sp on dim 1")
    return layout


def shard_train_step(step, mesh, state: Dict[str, Any], *,
                     plan: Optional[plan_lib.ShardingPlan] = None,
                     hints: Any = None, batch_spec=BATCH_SPEC,
                     regather: bool = True):
    """Put ``step`` (from ``train.build_train_step``) on ``mesh``.

    Returns ``(run, placed)``: ``placed`` is ``state`` with every
    parameter and optimizer slot cut to this rank's block under
    ``plan.state_specs(state, hints)`` (in place); ``run(state, **batch)``
    takes the *global* batch, runs the step on this rank's block of it
    (``batch_spec``: one spec for every feed, or a dict such as
    :func:`batch_specs` gives) and returns ``(state, metrics)``, the
    metrics averaged over the data axes. ``run.local(state, **batch)``
    takes this rank's block as it is. The step runs eagerly, on the
    generator :func:`step_rng` seeds (one per step). The
    optimizer's norms (a clip by norm, the trust ratios of LarsMomentum
    and Lamb) are those of the whole tensors
    (:meth:`StepSharding.attach`). A ``MoEFeedForward`` runs its experts
    split over "ep" with the reference's global routing over the axes
    the batch spec splits the tokens over (``nn/moe.py``; tokens over
    "ep" reach their experts by an all-to-all).

    A ``LookaheadOptimizer`` runs too: its inner optimizer's slots and
    its slow weights are cut like their parameters, so the pull toward
    the slow weights stays local. The reference's plan replicates both
    (``state_specs`` says so, as it does there); the values are the same.
    An ``ExponentialMovingAverage`` or ``ModelAverage`` made after this
    call over the placed parameters holds their blocks alike
    (:func:`gathered_params` with ``values=`` gives them whole).

    ``regather`` (FSDP): the backward gathers a split parameter again
    instead of keeping the forward's gathered copy (:class:`StepSharding`);
    False keeps it, the same bits for more memory."""
    if getattr(step, "rebuild", None) is None:
        raise TypeError("shard_train_step needs a step made by "
                        "train.build_train_step")
    plan = plan or plan_lib.replicated_plan()
    model, opt = state["model"], state["opt"]
    specs = _param_specs(model, plan, hints, state)
    _place(model, opt, specs, mesh)
    layout = _install(model, specs, mesh, batch_spec)
    sharding = StepSharding(mesh, specs, regather=regather, layout=layout)
    sharding.attach(model, opt)
    sharded = step.rebuild(sharding=sharding, cuda_graphs=False)

    device = next(model.parameters()).device

    def run_local(state, **batch):
        with step_rng(mesh, device, layout), \
                pf.token_layout(layout.batch, layout.seq):
            return sharded(state, **batch)

    def run(state, **batch):
        return run_local(state, **local_batch(batch, mesh, batch_spec))

    run.local = run_local
    run.specs = specs
    run.sharding = sharding
    return run, state


def shard_eval_step(fn: Callable, mesh, model, *,
                    plan: Optional[plan_lib.ShardingPlan] = None,
                    hints: Any = None, batch_spec=BATCH_SPEC):
    """``fn(model, **batch) -> out`` on ``mesh``: returns ``(run,
    placed)`` with ``placed`` the model cut to this rank's blocks (in
    place); ``run(model, **batch)`` takes the global batch, runs ``fn``
    on this rank's block without gradients and returns ``out``
    replicated: tensors gathered along dim 0 over the axes the batch
    spec splits it over (in its order), 0-d values averaged over the data
    axes."""
    from paddle_tpu_torch.train import _policy_call
    plan = plan or plan_lib.replicated_plan()
    specs = _param_specs(model, plan, hints)
    _place(model, None, specs, mesh)
    layout = _install(model, specs, mesh, batch_spec)
    sharding = StepSharding(mesh, specs, layout=layout)
    batch_axes = layout.batch

    def replicate(out):
        if isinstance(out, dict):
            return {k: replicate(v) for k, v in out.items()}
        if isinstance(out, (tuple, list)):
            return type(out)(replicate(v) for v in out)
        if not isinstance(out, torch.Tensor):
            return out
        if out.ndim == 0:
            return sharding.metrics({"v": out})["v"]
        if batch_axes:
            return collective.all_gather(out, tuple(reversed(batch_axes)),
                                         concat_axis=0, mesh=mesh)
        return out

    def run(model, **batch):
        with torch.no_grad(), mesh_lib.mesh_context(mesh), \
                pf.token_layout(layout.batch, layout.seq):
            out = _policy_call(fn, model, None,
                               local_batch(batch, mesh, batch_spec),
                               sharding.views)
            return replicate(out)

    return run, model


def gather_block(x, spec, mesh):
    """The whole value of which ``x`` is this rank's block under
    ``spec``."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        # the block is cut major axis first: gather the minor first
        for a in reversed(axes):
            if mesh_lib.axis_size(mesh, a) > 1:
                x = collective.all_gather(x.contiguous(), a, concat_axis=dim,
                                          mesh=mesh)
    return x


def gathered_params(model, specs: Dict[str, tuple], mesh,
                    values: Optional[Mapping[str, torch.Tensor]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Every parameter of a placed ``model`` whole again (``specs`` as
    ``run.specs`` gives them), on every rank: what the unsharded model
    would hold. ``values``, by parameter name, are tensors held like
    their parameter's block (an average's or the slow weights'), to
    gather instead."""
    with torch.no_grad():
        return {n: gather_block((p if values is None else values[n])
                                .detach(), specs.get(n, ()), mesh)
                for n, p in model.named_parameters()
                if values is None or n in values}


class _Constrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return plan_lib.local_shard(x, spec, mesh).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_block(g, ctx.spec, ctx.mesh), None, None


def with_sharding_constraint(x, spec, mesh=None):
    """A replicated activation ``x`` cut to this rank's block under
    ``spec`` (the reference's GSPMD constraint, made explicit); the
    transpose gathers the gradient back."""
    mesh = mesh if mesh is not None else mesh_lib.current_mesh()
    if mesh is None:
        return x
    return _Constrain.apply(x, tuple(spec), mesh)
