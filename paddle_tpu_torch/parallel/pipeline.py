"""Pipeline parallelism (``paddle_tpu/parallel/pipeline.py``): the GPipe
and the circular schedule over the "pp" axis of a ``torch.distributed``
mesh.

The reference traces the schedule: one ``fori_loop`` of ``M + n - 1``
ticks (circular: ``v*M + n - 1``) inside a ``shard_map`` over "pp" in
which every stage computes on every tick, bubble ticks included; autodiff
of the loop gives the reverse schedule, and a ``psum`` replicates the
last stage's outputs. Here each rank runs the timetable explicitly inside
one ``torch.autograd.Function`` (:class:`_Pipeline`):

- forward (without gradients): stage ``s`` computes item (circuit ``c``,
  microbatch ``m``) at tick ``t = c*M + m + s``; GPipe is the circular
  schedule with ``v = 1``. Activations hop one stage on with
  ``collective.ppermute`` between the pairs that are active on that tick
  alone; an item leaving the last stage before its last circuit hops to
  stage 0, which banks it until its next circuit. Each item's stage input
  is kept and nothing else: GPipe's memory, what the reference's
  ``remat=True`` (its default) gives.
- backward: the same timetable in reverse, in the same order on every
  rank. Each item's stage is recomputed under ``enable_grad`` and
  differentiated with ``torch.autograd.grad`` with respect to its input
  and the stage's parameter rows; the input's gradient hops one stage
  back.
- bubble ticks launch nothing.

The conventions over "pp" (every rank of a pp group holds the same data
and computes the same loss, as over "tp" in ``parallel/functional.py``):
the outputs are the last stage's, broadcast over "pp" in the forward; in
the backward only the last stage consumes their gradient (summing the
ranks' identical cotangents would multiply it by ``n``); stage 0's input
gradient is broadcast over "pp", so layers before and after the pipeline
(replicated over "pp") get the same gradient on every rank. A stacked
parameter split over "pp" (leading dim ``L/n``, ``stage_rows=True``)
gets its own rows' gradients; a stacked tensor every rank holds whole
gets every row's gradient on every rank (its rows' gradients are summed
over "pp"), as the reference's in-graph reshard transposes to.

Without a mesh, or on a mesh whose "pp" axis has one rank, the same
timetable runs in this process with no communication: the pp=1
reference of a pipelined model.

Dropout under the recompute: :func:`gpipe_layer_stack` gives each
(layer, microbatch, data shard) a ``torch.Generator`` of its own, seeded
from the step's seed (the reference's ``fold_in(layer_key, mb_idx)`` and
``fold_in(., axis_index(("dp", "fsdp")))``), so the recompute draws the
forward's masks, and the masks do not depend on the layout (stacked or
layer list, pp=1 or pp=2). The seed is stage 0's, broadcast over "pp";
the layers outside the pipeline (the embeddings' dropout) draw alike on
every stage because ``parallel.api.shard_train_step`` runs each step on
a default generator seeded from stage 0 (``api.step_rng``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from paddle_tpu_torch.core import mesh as mesh_lib
from paddle_tpu_torch.nn.module import active_tape, use_tape
from paddle_tpu_torch.parallel import collective
from paddle_tpu_torch.parallel import functional as pf

#: the per-layer seed leaf :func:`gpipe_layer_stack` adds to the rows
SEED = "__seed__"


# -- layouts ------------------------------------------------------------------

def _stack(leaves):
    if isinstance(leaves[0], torch.Tensor):
        return torch.stack(list(leaves))
    return np.stack([np.asarray(a) for a in leaves])


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def stack_layer_params(params_list):
    """``[{layer params}, ...]`` -> one tree with stacked ``(L, ...)``
    leaves (the pipeline's weight layout). Leaves are tensors or numpy
    arrays; empty sub-trees stay empty."""
    params_list = list(params_list)
    return _tree_map(lambda *xs: _stack(xs), *params_list)


def _get_at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _set_at(tree, path, value):
    if not path:
        return value
    return {**tree, path[0]: _set_at(tree[path[0]], path[1:], value)}


def stack_params_at(params, path, num_layers: int):
    """The layer-list subtree at ``path`` (per-layer trees keyed
    ``"0"..."L-1"``) as stacked ``(L, ...)`` leaves: a checkpoint moved
    into the ``StackedLayers`` layout (BERT: ``("bert", "encoder")``,
    GPT: ``("blocks",)``)."""
    node = _get_at(params, path)
    stacked = stack_layer_params([node[str(i)] for i in range(num_layers)])
    return _set_at(params, tuple(path), stacked)


def unstack_params_at(params, path, num_layers: int):
    """Inverse of :func:`stack_params_at`."""
    node = _get_at(params, path)
    per = {str(i): _tree_map(lambda a, i=i: a[i], node)
           for i in range(num_layers)}
    return _set_at(params, tuple(path), per)


def _arrange(a, shape3, n_rows):
    if isinstance(a, torch.Tensor):
        return a.reshape(shape3 + tuple(a.shape[1:])).transpose(0, 1) \
            .reshape((n_rows,) + tuple(a.shape[1:]))
    a = np.asarray(a)
    return a.reshape(shape3 + a.shape[1:]).swapaxes(0, 1).reshape(
        (n_rows,) + a.shape[1:])


def interleave_stack(stacked_params, n_stages: int, num_circuits: int):
    """Stacked ``(L, ...)`` leaves from the contiguous stage order into
    the circular schedule's interleaved order, so that a contiguous split
    over "pp" hands rank ``s`` chunks ``s, s+n, ..., s+(v-1)n`` (the
    Megatron interleaved placement). Apply once when the weights are laid
    out (init, checkpoint load) and run with ``pre_interleaved=True``;
    arranging inside the step reshuffles every weight (and its gradient)
    across the ranks each step."""
    n, v = n_stages, num_circuits

    def arrange(a):
        k = a.shape[0] // (n * v)
        return _arrange(a, (v, n, k), a.shape[0])

    return _tree_map(arrange, stacked_params)


def uninterleave_stack(stacked_params, n_stages: int, num_circuits: int):
    """Inverse of :func:`interleave_stack` (checkpoint export)."""
    n, v = n_stages, num_circuits

    def arrange(a):
        k = a.shape[0] // (n * v)
        return _arrange(a, (n, v, k), a.shape[0])

    return _tree_map(arrange, stacked_params)


def pipeline_bubble_fraction(n_stages: int, num_microbatches: int,
                             num_circuits: int = 1) -> float:
    """The share of stage-ticks that are bubble: GPipe runs ``M + n - 1``
    ticks for ``M`` useful ones per stage, ``(n-1)/(M+n-1)``; the
    circular schedule runs ``v*M + n - 1`` ticks of chunks a ``v``-th the
    size, ``(n-1)/(v*M+n-1)``. (Here a bubble tick launches nothing: the
    share is of the schedule's length, where a stage waits.)"""
    n, M, v = n_stages, num_microbatches, num_circuits
    return (n - 1) / (v * M + n - 1)


def microbatch(batch, num_microbatches: int):
    """``(B, ...) -> (M, B/M, ...)`` over every leaf (a tensor, or a dict
    or tuple of them)."""
    return pytree.tree_map(
        lambda x: x.reshape((num_microbatches, -1) + tuple(x.shape[1:])),
        batch)


def microbatch_extras(tree, num_microbatches: int):
    """Per-example side inputs microbatched for the schedules, with their
    specs: ``(B, ...) -> (M, B/M, ...)``, the microbatch's batch dim over
    ("dp", "fsdp") and nothing over "pp" (stages index the extras
    locally by microbatch)."""
    out = microbatch(tree, num_microbatches)
    specs = pytree.tree_map(
        lambda a: (None, mesh_lib.BATCH_AXES) + (None,) * (a.ndim - 2), out)
    return out, specs


def unmicrobatch(batch):
    """``(M, mb, ...) -> (M*mb, ...)`` over every leaf."""
    return pytree.tree_map(
        lambda x: x.reshape((-1,) + tuple(x.shape[2:])), batch)


def _names_axis(spec, axis) -> bool:
    if isinstance(spec, str):
        return spec == axis
    if isinstance(spec, dict):
        return any(_names_axis(v, axis) for v in spec.values())
    if isinstance(spec, (tuple, list)):
        return any(_names_axis(v, axis) for v in spec)
    return False


def _check_pp_replicated(spec_tree, axis, what):
    """Activations and extras are indexed locally by microbatch, which
    needs every leaf whole over the pipeline axis: a spec (or a tree of
    them) that names ``axis`` is refused."""
    if spec_tree is not None and _names_axis(spec_tree, axis):
        raise ValueError(
            f"{what} {spec_tree} shards over the pipeline axis {axis!r}; "
            f"{what} must be pp-replicated (see microbatch_extras) "
            "because stages index the (M, ...) arrays locally by "
            "microbatch index")


# -- the schedule -----------------------------------------------------------

class _Timetable:
    """Rank ``s`` of ``n`` holds item (circuit ``c``, microbatch ``m``) at
    tick ``t = c*M + m + s``; ``v*M + n - 1`` ticks."""

    def __init__(self, n: int, M: int, v: int):
        self.n, self.M, self.v = n, M, v
        self.ticks = v * M + n - 1

    def item(self, rank: int, t: int):
        j = t - rank
        return divmod(j, self.M) if 0 <= j < self.v * self.M else None

    def forward_pairs(self, t: int):
        """(src, dst) hops after tick ``t``: each active stage to the
        next, the last stage to stage 0 before an item's last circuit."""
        n, out = self.n, []
        for r in range(n):
            it = self.item(r, t)
            if it is not None and not (r == n - 1 and it[0] == self.v - 1):
                out.append((r, (r + 1) % n))
        return out

    def backward_pairs(self, t: int):
        """(src, dst) gradient hops after reverse tick ``t``: each active
        stage but the first to the one before; stage 0 to the last stage
        for an item past its first circuit (the last stage banks it until
        the reverse walk reaches the item's previous circuit)."""
        out = []
        for r in range(self.n):
            it = self.item(r, t)
            if it is not None and (r > 0 or it[0] > 0):
                out.append((r, (r - 1) % self.n))
        return out


class _Stage:
    """What the Function carries: the block, the rows' names, the extras'
    structure and the mesh."""

    def __init__(self, block_fn, names, extras_spec, mesh, axis, timetable,
                 remat):
        self.block_fn, self.names = block_fn, names
        self.extras_spec = extras_spec
        self.mesh, self.axis, self.tt, self.remat = (mesh, axis, timetable,
                                                     remat)
        self.n = timetable.n
        self.rank = (mesh_lib.axis_index(mesh, axis)
                     if self.n > 1 else 0)

    def unflatten(self, leaves):
        if self.extras_spec is None:
            return None
        return pytree.tree_unflatten(list(leaves), self.extras_spec)

    def extra(self, extras, m):
        return self.unflatten([e[m] for e in extras])

    def run_chunk(self, rows, c, h, extra, m):
        """Chunk ``c``'s layers (rows ``c*k .. (c+1)*k - 1`` of each
        leaf, ``rows`` a list of per-layer dicts) on ``h``."""
        k = len(rows) // self.tt.v
        for i in range(c * k, (c + 1) * k):
            h = self.block_fn(dict(rows[i]), h, extra, m)
        return h

    def hop(self, value, pairs, like):
        """Send ``value`` along this rank's pair of ``pairs``; return what
        this rank receives, or None."""
        me = self.rank
        mine = [p for p in pairs if me in p]
        if not mine:
            return None
        if (me, me) in mine:
            return value
        got = collective.ppermute(value if value is not None else like,
                                  self.axis, mine, mesh=self.mesh)
        return got if any(dst == me for _, dst in mine) else None


def _extra_leaves(extras, m, want):
    """Microbatch ``m``'s extras, each detached and requiring grad where
    its gradient is wanted."""
    return [e[m].detach().requires_grad_() if w else e[m]
            for e, w in zip(extras, want)]


def _layer_rows(stage, tensors, leaves=False):
    """Per-layer dicts of the stage's rows; with ``leaves``, each
    floating row detached and requiring grad (the backward's leaves)."""
    n_rows = tensors[0].shape[0] if tensors else 0
    rows = []
    for i in range(n_rows):
        row = {}
        for name, t in zip(stage.names, tensors):
            r = t[i]
            if leaves and r.is_floating_point():
                r = r.detach().requires_grad_()
            row[name] = r
        rows.append(row)
    return rows


class _Pipeline(torch.autograd.Function):
    """The per-rank pipeline (module docstring). Inputs: the
    microbatched activation, the extras' leaves, then the stage's row
    tensors (in stage order: chunk ``c`` is rows ``c*k .. (c+1)*k-1``)."""

    @staticmethod
    def forward(ctx, stage, n_extras, x, *tensors):
        extras, params = tensors[:n_extras], tensors[n_extras:]
        tt, s, n = stage.tt, stage.rank, stage.n
        need = any(ctx.needs_input_grad)
        want_e = [ctx.needs_input_grad[3 + i] for i in range(n_extras)]
        rows = _layer_rows(stage, params)
        outputs: List[Optional[torch.Tensor]] = [None] * tt.M
        saved, bank, recv = {}, {}, None
        like = x[0]
        graphs = {}
        for t in range(tt.ticks):
            it = tt.item(s, t)
            h = None
            if it is not None:
                c, m = it
                if s == 0:
                    inp = x[m] if c == 0 else bank.pop(m)
                else:
                    inp = recv
                if need and not stage.remat:
                    with torch.enable_grad():
                        inp_l = inp.detach().requires_grad_()
                        leaves = _layer_rows(stage, params, leaves=True)
                        extra_l = _extra_leaves(extras, m, want_e)
                        h_g = stage.run_chunk(
                            leaves, c, inp_l, stage.unflatten(extra_l), m)
                    graphs[(c, m)] = (inp_l, leaves, extra_l, h_g)
                    h = h_g.detach()
                else:
                    if need:
                        saved[(c, m)] = inp
                    h = stage.run_chunk(rows, c, inp,
                                        stage.extra(extras, m), m)
                if s == n - 1 and c == tt.v - 1:
                    outputs[m] = h
            got = stage.hop(h, tt.forward_pairs(t), like)
            if got is not None:
                if s == 0:        # an item between circuits
                    bank[tt.item(n - 1, t)[1]] = got
                else:
                    recv = got
        if s == n - 1:
            out = torch.stack(outputs)
        else:
            out = torch.empty_like(x)
        if n > 1:
            out = collective.broadcast(out, stage.axis, root=n - 1,
                                       mesh=stage.mesh)
        ctx.stage, ctx.n_extras = stage, n_extras
        ctx.saved, ctx.graphs = saved, graphs
        ctx.tape = active_tape()      # the recompute reports to it
        ctx.save_for_backward(x, *tensors)
        return out

    @staticmethod
    def backward(ctx, g_out):
        # autograd may run this on a thread of its own: the recompute
        # reports running state to the forward's tape
        with use_tape(ctx.tape):
            return _Pipeline._backward(ctx, g_out)

    @staticmethod
    def _backward(ctx, g_out):
        stage, n_extras = ctx.stage, ctx.n_extras
        x, *tensors = ctx.saved_tensors
        extras, params = tensors[:n_extras], tensors[n_extras:]
        tt, s, n = stage.tt, stage.rank, stage.n
        want_x = ctx.needs_input_grad[2]
        want_e = [ctx.needs_input_grad[3 + i] for i in range(n_extras)]
        want_p = [ctx.needs_input_grad[3 + n_extras + i]
                  for i in range(len(params))]
        # fp32 accumulators for the rows' and extras' gradients
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               if w else None for p, w in zip(params, want_p)]
        acc_e = [torch.zeros(e.shape, dtype=torch.float32, device=e.device)
                 if w else None for e, w in zip(extras, want_e)]
        g_x = torch.zeros_like(x) if want_x and s == 0 else None
        like = x[0]
        g_recv, g_bank = None, {}
        for t in reversed(range(tt.ticks)):
            it = tt.item(s, t)
            g_in = None
            if it is not None:
                c, m = it
                if s == n - 1:
                    gh = g_out[m] if c == tt.v - 1 else g_bank.pop(m)
                else:
                    gh = g_recv
                if stage.remat:
                    with torch.enable_grad():
                        inp = ctx.saved.pop((c, m)).detach() \
                            .requires_grad_()
                        leaves = _layer_rows(stage, params, leaves=True)
                        extra_l = _extra_leaves(extras, m, want_e)
                        h = stage.run_chunk(leaves, c, inp,
                                            stage.unflatten(extra_l), m)
                else:
                    inp, leaves, extra_l, h = ctx.graphs.pop((c, m))
                k = len(leaves) // tt.v
                wrt, where = [inp], []
                for i in range(c * k, (c + 1) * k):
                    for j, name in enumerate(stage.names):
                        if want_p[j] and leaves[i][name].requires_grad:
                            wrt.append(leaves[i][name])
                            where.append(("p", j, i))
                for j, w in enumerate(want_e):
                    if w:
                        wrt.append(extra_l[j])
                        where.append(("e", j, m))
                grads = torch.autograd.grad(h, wrt, gh, allow_unused=True)
                g_in = grads[0]
                if g_in is None:
                    g_in = torch.zeros_like(inp)
                for (kind, j, i), g in zip(where, grads[1:]):
                    if g is not None:
                        (acc if kind == "p" else acc_e)[j][i] += g.float()
                if s == 0 and c == 0:
                    if g_x is not None:
                        g_x[m] = g_in
                    g_in = None
            got = stage.hop(g_in, tt.backward_pairs(t), like)
            if got is not None:
                if s == n - 1:    # from stage 0: an earlier circuit's
                    g_bank[tt.item(0, t)[1]] = got
                else:
                    g_recv = got
        if want_x and n > 1:
            g_x = collective.broadcast(
                g_x if s == 0 else torch.zeros_like(x), stage.axis, root=0,
                mesh=stage.mesh)
        g_e = []
        for e, a in zip(extras, acc_e):
            if a is not None and n > 1:
                a = collective.all_reduce(a, stage.axis, mesh=stage.mesh)
            g_e.append(None if a is None else a.to(e.dtype))
        g_p = [None if a is None else a.to(p.dtype)
               for p, a in zip(params, acc)]
        return (None, None, g_x, *g_e, *g_p)


def _pp(mesh, axis):
    """``(mesh, n)``: the mesh the schedule runs on (None without one)
    and its stage count."""
    mesh = mesh if mesh is not None else mesh_lib.current_mesh()
    n = mesh_lib.axis_size(mesh, axis) if mesh is not None else 1
    return (mesh if n > 1 else None), n


def stage_index(num_layers: int, n: int, s: int, v: int = 1,
                pre_interleaved: bool = False) -> List[int]:
    """The rows of a whole ``(L, ...)`` stack that stage ``s`` applies,
    in its order (chunk ``c`` of the stage is canonical chunk
    ``c*n + s``). ``pre_interleaved``: the stack is stored in the
    interleaved order (:func:`interleave_stack`), whose contiguous
    ``s``-th block is the stage's."""
    per = num_layers // n
    if pre_interleaved:
        return list(range(s * per, (s + 1) * per))
    k = num_layers // (n * v)
    return [(c * n + s) * k + i for c in range(v) for i in range(k)]


def _run(block_fn, stacked_params, x_microbatches, *, v, extras, mesh, axis,
         remat, x_spec, extras_spec, stage_rows, pre_interleaved):
    _check_pp_replicated(x_spec, axis, "x_spec")
    _check_pp_replicated(extras_spec, axis, "extras_spec")
    mesh, n = _pp(mesh, axis)
    s = mesh_lib.axis_index(mesh, axis) if mesh is not None else 0
    M = x_microbatches.shape[0]
    names = list(stacked_params)
    tensors = [stacked_params[k] for k in names]
    rows = tensors[0].shape[0]
    L = rows * n if stage_rows else rows
    if L % (n * v):
        raise ValueError(f"layers {L} not divisible by pp*circuits "
                         f"{n}*{v}")
    if n > 1 and not stage_rows:
        # every rank holds the whole stack: take the stage's rows; the
        # rows' gradients sum over "pp" (every row's gradient everywhere)
        idx = torch.tensor(stage_index(L, n, s, v, pre_interleaved))
        tensors = [_take(t, idx, mesh, axis) for t in tensors]
    elif n > 1 and v > 1 and not pre_interleaved:
        # a contiguous split of the canonical order holds the wrong
        # chunks for the circular schedule: gather the whole stack and
        # take the stage's (the per-step reshuffle of the reference)
        idx = torch.tensor(stage_index(L, n, s, v))
        tensors = [_take(pf.gather_from(t, axis, mesh, 0)
                         if t.is_floating_point() else
                         collective.all_gather(t, axis, mesh=mesh), idx,
                         mesh, axis) for t in tensors]
    flat, spec = ([], None) if extras is None else pytree.tree_flatten(
        extras)
    stage = _Stage(block_fn, names, spec, mesh, axis, _Timetable(n, M, v),
                   remat)
    return _Pipeline.apply(stage, len(flat), x_microbatches, *flat,
                           *tensors)


def _take(t, idx, mesh, axis):
    if t.is_floating_point() and t.requires_grad:
        t = pf.copy_to(t, axis, mesh)
    return t.index_select(0, idx.to(t.device))


def gpipe(block_fn: Callable, stacked_params: Dict[str, torch.Tensor],
          x_microbatches: torch.Tensor, *, extras: Any = None, mesh=None,
          axis: str = mesh_lib.PP, remat: bool = True, x_spec=None,
          extras_spec=None, stage_rows: bool = False):
    """Microbatches through a pipelined stack of identical blocks.

    ``block_fn(layer_params, h, extra, mb_idx) -> h`` (``layer_params``
    a dict of one layer's rows, ``mb_idx`` the microbatch's index, an
    int); ``stacked_params`` a dict of ``(L, ...)`` tensors, L divisible
    by the "pp" axis size, every rank holding them whole; with
    ``stage_rows``, each rank holds its own stage's ``L/n`` rows (a stack
    split over "pp"). ``x_microbatches``: ``(M, mb, ...)``; ``extras``:
    a tensor or a tuple/dict of ``(M, ...)`` tensors, each microbatch's
    side input (an attention bias), replicated over "pp"; an
    ``x_spec``/``extras_spec`` naming the pp axis is refused. The ranks'
    other axes hold their own blocks of the batch already (the port's
    sharded step cuts the batch before the forward), so the specs are
    only checked. Returns ``(M, mb, ...)``, the same on every rank of
    the pp group. ``remat=False`` keeps each item's graph from the
    forward instead of recomputing it (more memory, no recompute)."""
    return _run(block_fn, stacked_params, x_microbatches, v=1,
                extras=extras, mesh=mesh, axis=axis, remat=remat,
                x_spec=x_spec, extras_spec=extras_spec,
                stage_rows=stage_rows, pre_interleaved=False)


def circular_pipeline(block_fn: Callable,
                      stacked_params: Dict[str, torch.Tensor],
                      x_microbatches: torch.Tensor, *, num_circuits: int,
                      extras: Any = None, mesh=None,
                      axis: str = mesh_lib.PP, remat: bool = True,
                      x_spec=None, extras_spec=None,
                      pre_interleaved: bool = False,
                      stage_rows: bool = False):
    """The interleaved (circular) schedule: each rank owns ``num_circuits``
    (v) non-adjacent chunks of the stack, chunks ``s, s+n, ...,
    s+(v-1)n``, and every microbatch rides the "pp" ring v times. Rank
    ``s`` computes (circuit ``c``, microbatch ``m``) at tick ``c*M + m +
    s``; an item leaving the last stage re-enters stage 0, which banks it
    until its next circuit, so the stream needs ``M >= n``. ``v*M + n -
    1`` ticks of chunks a ``v``-th of a GPipe stage
    (:func:`pipeline_bubble_fraction`). ``L`` must divide by ``n * v``.

    ``pre_interleaved``: the stack is stored in the interleaved order
    (:func:`interleave_stack`), so a contiguous split over "pp" is each
    stage's chunks and nothing moves between ranks; else a whole stack
    gives each stage its rows by index, and a stack split over "pp"
    (``stage_rows``) is gathered whole first, each step. Otherwise as
    :func:`gpipe`."""
    mesh_, n = _pp(mesh, axis)
    M = x_microbatches.shape[0]
    if M < n:
        raise ValueError(
            f"circular schedule needs microbatches >= pp stages "
            f"(got M={M} < n={n}); use gpipe for short streams")
    return _run(block_fn, stacked_params, x_microbatches, v=num_circuits,
                extras=extras, mesh=mesh, axis=axis, remat=remat,
                x_spec=x_spec, extras_spec=extras_spec,
                stage_rows=stage_rows, pre_interleaved=pre_interleaved)


# -- the model-facing wrapper ----------------------------------------------

_MASK64 = (1 << 64) - 1


def mix_seed(*values: int) -> int:
    """A 63-bit seed from integers (splitmix64 steps): the per-layer,
    per-microbatch and per-shard seeds of the dropout generators."""
    h = 0x9E3779B97F4A7C15
    for v in values:
        h = (h ^ (int(v) & _MASK64)) & _MASK64
        h = (h * 0xBF58476D1CE4E5B9) & _MASK64
        h ^= h >> 31
        h = (h * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 29
    return h >> 1


def step_seed(generator: Optional[torch.Generator],
              device: torch.device) -> int:
    """One draw of ``generator`` (the default generator of ``device`` when
    None): the seed the pipeline derives its dropout generators from."""
    return int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=device))


def data_shard(mesh) -> int:
    """This rank's index over ("dp", "fsdp"), dp major (the reference's
    ``axis_index(("dp", "fsdp"))``); 0 without a mesh."""
    if mesh is None:
        return 0
    idx = 0
    for a in mesh_lib.BATCH_AXES:
        idx = idx * mesh_lib.axis_size(mesh, a) + (
            mesh_lib.axis_index(mesh, a)
            if mesh_lib.axis_size(mesh, a) > 1 else 0)
    return idx


def layer_generator(seed: int, mb_idx: int, shard: int,
                    device: torch.device) -> torch.Generator:
    """The generator of one (layer seed, microbatch, data shard)."""
    g = torch.Generator(device=device)
    g.manual_seed(mix_seed(seed, mb_idx, shard))
    return g


def gpipe_layer_stack(apply_layer: Callable, params, x: torch.Tensor, *,
                      num_microbatches: int,
                      num_layers: Optional[int] = None,
                      seed: Optional[int] = None, extras: Any = None,
                      extras_spec=None, x_spec=None, mesh=None,
                      schedule: str = "gpipe", num_circuits: int = 1,
                      pre_interleaved: bool = False):
    """A stack of identical layers through a schedule (``"gpipe"``, or
    ``"circular"`` with ``num_circuits`` chunks per rank): microbatches
    ``x`` (``(B, ...)``, B divisible by ``num_microbatches``), runs it,
    and gives back ``(B, ...)``.

    ``apply_layer(layer_params, h, extra, generator) -> h``;
    ``generator`` is None without ``seed``, else layer ``l``'s generator
    for this microbatch and data shard (module docstring); stage 0's
    ``seed`` is broadcast over "pp", so the stages draw one step's masks
    whatever their own generators hold. ``params``:
    a list of per-layer dicts (the layer-list layout, stacked here: every
    rank holds them whole), or a dict of stacked tensors, whole
    (``num_layers`` rows) or this stage's rows of a stack split over "pp"
    (``num_layers / n`` rows). Per-layer seeds are made in the canonical
    layer order, so a layer's masks do not depend on the layout.
    ``extras``: ``(M, ...)`` side inputs (microbatch them first)."""
    M = num_microbatches
    b = x.shape[0]
    if b % M:
        raise ValueError(f"batch {b} not divisible by "
                         f"pp_microbatches={M}")
    if pre_interleaved and schedule != "circular":
        raise ValueError(
            "pre_interleaved params hold the circular schedule's layer "
            f"order; running them through schedule={schedule!r} would "
            "apply layers in the wrong order — convert back with "
            "uninterleave_stack first")
    if isinstance(params, (list, tuple)):
        stacked = stack_layer_params(list(params))
        num_layers = len(params)
    else:
        stacked = dict(params)
    mesh_, n = _pp(mesh, mesh_lib.PP)
    rows = next(iter(stacked.values())).shape[0]
    L = num_layers if num_layers is not None else rows
    if rows not in (L, L // n) or L % n:
        raise ValueError(f"stacked rows {rows}: want {L} (whole) or "
                         f"{L // n} (split over pp={n})")
    stage_rows = n > 1 and rows != L
    v = num_circuits if schedule == "circular" else 1
    if seed is not None:
        if n > 1:    # stage 0's: every stage draws one step's masks
            seed = int(collective.broadcast(
                torch.tensor([seed], dtype=torch.int64), mesh_lib.PP,
                root=0, mesh=mesh_)[0])
        # made in the canonical layer order, then laid out as the
        # parameters are stored (interleaved, split over "pp"), so each
        # layer keeps its seed whatever the layout
        seeds = torch.tensor([mix_seed(seed, l) for l in range(L)],
                             dtype=torch.int64)
        if pre_interleaved:
            seeds = interleave_stack(seeds, n, v)
        if stage_rows:
            s = mesh_lib.axis_index(mesh_, mesh_lib.PP)
            seeds = seeds[s * rows:(s + 1) * rows]
        stacked[SEED] = seeds
    shard = data_shard(mesh if mesh is not None
                       else mesh_lib.current_mesh())
    device = x.device

    def block(lp, h, extra, mb_idx):
        lseed = lp.pop(SEED, None)
        gen = (None if lseed is None else
               layer_generator(int(lseed), mb_idx, shard, device))
        return apply_layer(lp, h, extra, gen)

    x_mb = x.reshape((M, b // M) + tuple(x.shape[1:]))
    if schedule == "circular":
        out = circular_pipeline(block, stacked, x_mb,
                                num_circuits=num_circuits, extras=extras,
                                x_spec=x_spec, extras_spec=extras_spec,
                                mesh=mesh, pre_interleaved=pre_interleaved,
                                stage_rows=stage_rows)
    elif schedule == "gpipe":
        out = gpipe(block, stacked, x_mb, extras=extras, x_spec=x_spec,
                    extras_spec=extras_spec, mesh=mesh,
                    stage_rows=stage_rows)
    else:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    return out.reshape(x.shape)


__all__ = [
    "SEED", "circular_pipeline", "data_shard", "gpipe", "gpipe_layer_stack",
    "interleave_stack", "layer_generator", "microbatch", "microbatch_extras",
    "mix_seed", "pipeline_bubble_fraction", "stack_layer_params",
    "stack_params_at", "stage_index", "step_seed", "uninterleave_stack",
    "unmicrobatch", "unstack_params_at",
]
