"""Static cost model: walk a traced graph into a CostReport
(``paddle_tpu/analysis/cost_model.py``).

The reference lowers to StableHLO and walks the module; the port walks
the aten graph of a trace on fake tensors (:func:`~paddle_tpu_torch.
analysis.api.trace`), the same graph the lint rules read.
``estimate_cost`` traces a function, ``estimate_lowered`` costs a trace
and ``analyze_module`` a traced graph module, into a :class:`CostReport`:

- **per-op flops and bytes** -- matmuls (``mm``/``addmm``/``bmm``/
  ``baddbmm``) count 2·B·M·N·K (the bias add of ``addmm``/``baddbmm``
  one per output element, as the reference's separate ``add``),
  convolutions 2·out·(C_in/groups)·k_spatial as the reference's
  ``_conv_flops``, their backward the two convolutions the reference's
  backward lowers to; the registered kernels (``ptt.flash_*``,
  ``ptt.paged_*``) take their flops and bytes from their registry
  entry's work function (K1-K4's shape-only static work: every
  block-table column live); reductions count their input elements,
  elementwise ops their results, copies and gathers bytes only, views
  nothing;
- **peak memory** -- a liveness scan over each graph: inputs (the
  placeholders and the constants a step closes over) live for the whole
  call, as non-donated arguments do in the reference; a view or an
  in-place write aliases its input and allocates nothing (state written
  in place lowers the peak, the static face of the port's in-place
  update); every other value lives from its node to the last use of any
  alias of it; a node that calls a subgraph adds the subgraph's own
  peak at its call point;
- **collectives** -- every ``ptt.collective`` node (the port's
  collectives record themselves on fake tensors,
  ``parallel/collective.py``) with its payload bytes and group size,
  attributed to a mesh axis when ``mesh_axes`` disambiguates;
- **resharding churn** -- the port's counterpart of the reference's
  ``@Sharding`` chains: a value all-gathered to full size that reaches a
  reduce-scatter or all-to-all through data movement alone (no
  arithmetic between): it crossed the wire twice to end where it began.

Numbers are static: every node counts once (loops were unrolled by the
trace), and the peak models the unfused eager graph, so it upper-bounds
what the caching allocator holds at once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch.fx as fx

from paddle_tpu_torch.analysis import fx_lint
from paddle_tpu_torch.analysis.fx_lint import (_flat_nodes, bound_args,
                                               node_bytes, tensors)

#: op -> flops class (matmul, conv, attention kernels)
MATMUL_OPS = {"mm", "addmm", "bmm", "baddbmm", "dot", "mv", "addmv",
              "_scaled_mm"}
CONV_OPS = {"convolution", "convolution_backward"}

#: nodes that move or re-view data without arithmetic
DATA_MOVEMENT = {
    "view", "_unsafe_view", "reshape", "t", "transpose", "permute",
    "expand", "squeeze", "unsqueeze", "slice", "select", "as_strided",
    "alias", "detach", "unbind", "split", "split_with_sizes", "chunk",
    "cat", "stack", "clone", "_to_copy", "copy_", "copy", "contiguous",
    "index", "index_select", "gather", "scatter", "index_put_",
    "index_put", "index_copy_", "index_copy", "embedding", "empty",
    "empty_like", "empty_strided", "zeros", "zeros_like", "ones",
    "ones_like", "full", "full_like", "new_empty", "new_zeros",
    "new_ones", "new_full", "arange", "fill_", "zero_", "lift_fresh_copy",
    "constant_pad_nd", "flip", "roll", "repeat", "getitem", "scalar_tensor",
    "_unsafe_index", "narrow", "diagonal", "unfold", "fill",
    "tensor_split", "movedim", "pad", "ptt.collective",
}

_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "var", "std",
               "var_mean", "prod", "norm", "linalg_vector_norm", "argmax",
               "argmin", "logsumexp", "_log_softmax", "_softmax", "cumsum",
               "sort", "topk", "any", "all", "_foreach_norm"}

#: ops an all-gathered value may pass through and stay "unchanged"
_PASSTHROUGH = {"view", "_unsafe_view", "reshape", "t", "transpose",
                "permute", "expand", "squeeze", "unsqueeze", "slice",
                "select", "clone", "contiguous", "_to_copy", "cat",
                "unbind", "getitem", "split", "chunk", "alias", "detach",
                "stack", "copy_"}


@dataclasses.dataclass
class OpCost:
    """Aggregate cost of every instance of one op kind."""
    count: int = 0
    flops: int = 0
    bytes: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Collective:
    """One collective instance: payload + group shape."""
    kind: str                 # all_reduce | all_gather | ...
    bytes: int
    groups: int = 1           # number of groups (one a rank sees)
    group_size: int = 1       # ranks per group
    axis: str = ""            # mesh axis attribution (best effort)
    location: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ReshardSite:
    """A value gathered to full size and scattered again with nothing
    computed on it in between."""
    bytes: int
    src: str                  # the gathering collective
    dst: str                  # the scattering one
    location: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class CostReport:
    """Static cost of one traced function (see module docstring)."""

    def __init__(self, name: str = "fn"):
        self.name = name
        self.per_op: Dict[str, OpCost] = {}
        #: flops by class: matmul, conv, flash, paged, other
        self.flops_by_class: Dict[str, int] = {}
        self.collectives: List[Collective] = []
        self.resharding: List[ReshardSite] = []
        self.peak_hbm_bytes: int = 0
        self.arg_bytes: int = 0
        self.out_bytes: int = 0
        self.donated_bytes: int = 0

    # -- aggregates ---------------------------------------------------------
    @property
    def total_flops(self) -> int:
        return sum(c.flops for c in self.per_op.values())

    @property
    def traffic_bytes(self) -> int:
        """Sum of operand+result bytes over every op that moves data: the
        memory-traffic face of the cost (an upper bound)."""
        return sum(c.bytes for c in self.per_op.values())

    @property
    def collective_bytes(self) -> int:
        return sum(c.bytes for c in self.collectives)

    @property
    def n_ops(self) -> int:
        return sum(c.count for c in self.per_op.values())

    def collective_kinds(self) -> Dict[str, int]:
        """kind -> total bytes, for allowlist checks."""
        out: Dict[str, int] = {}
        for c in self.collectives:
            out[c.kind] = out.get(c.kind, 0) + c.bytes
        return out

    def summary(self) -> Dict[str, int]:
        """The budget-gate metrics (what ``analysis/cost_budgets.json``
        commits and ``--cost-diff`` compares)."""
        return {
            "flops": int(self.total_flops),
            "peak_hbm_bytes": int(self.peak_hbm_bytes),
            "traffic_bytes": int(self.traffic_bytes),
            "collective_bytes": int(self.collective_bytes),
        }

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            **self.summary(),
            "arg_bytes": self.arg_bytes,
            "out_bytes": self.out_bytes,
            "donated_bytes": self.donated_bytes,
            "n_ops": self.n_ops,
            "flops_by_class": dict(sorted(self.flops_by_class.items())),
            "per_op": {k: v.as_dict()
                       for k, v in sorted(self.per_op.items())},
            "collectives": [c.as_dict() for c in self.collectives],
            "resharding": [r.as_dict() for r in self.resharding],
        }

    def render_text(self) -> str:
        def mb(n):
            return f"{n / (1 << 20):.2f}MiB"
        lines = [f"cost: {self.name} — {self.total_flops:,} flops, "
                 f"traffic {mb(self.traffic_bytes)}, peak "
                 f"{mb(self.peak_hbm_bytes)} (args {mb(self.arg_bytes)}, "
                 f"out {mb(self.out_bytes)}, written in place "
                 f"{mb(self.donated_bytes)}), "
                 f"{len(self.collectives)} collective(s)"]
        top = sorted(self.per_op.items(), key=lambda kv: -kv[1].flops)[:6]
        for op, c in top:
            if c.flops:
                lines.append(f"  {op:24s} x{c.count:<4d} "
                             f"{c.flops:,} flops  {mb(c.bytes)}")
        for c in self.collectives:
            ax = f" axis={c.axis}" if c.axis else ""
            lines.append(f"  collective {c.kind} {mb(c.bytes)} "
                         f"({c.groups}x{c.group_size}{ax})")
        for r in self.resharding:
            lines.append(f"  reshard {mb(r.bytes)} {r.src} -> {r.dst}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# flops models
# ---------------------------------------------------------------------------

def _shape(x) -> List[int]:
    ts = tensors(x) if isinstance(x, fx.Node) else []
    return [int(d) for d in ts[0].shape] if ts else []


def _numel(x) -> int:
    return sum(int(t.numel()) for t in tensors(x)) \
        if isinstance(x, fx.Node) else 0


def _matmul_flops(node: fx.Node, name: str):
    """(matmul flops, elementwise flops) of a matmul node."""
    a = node.args
    if name == "mm":
        (m, k), (_k, n) = _shape(a[0]), _shape(a[1])
        return 2 * m * n * k, 0
    if name == "addmm":
        (m, k), (_k, n) = _shape(a[1]), _shape(a[2])
        return 2 * m * n * k, m * n
    if name in ("bmm", "baddbmm"):
        lhs, rhs = (a[0], a[1]) if name == "bmm" else (a[1], a[2])
        (b, m, k), (_b, _k, n) = _shape(lhs), _shape(rhs)
        return 2 * b * m * n * k, (b * m * n if name == "baddbmm" else 0)
    if name == "dot":
        return 2 * _shape(a[0])[0], 0
    if name in ("mv", "addmv"):
        mat = a[0] if name == "mv" else a[1]
        m, k = _shape(mat)
        return 2 * m * k, (m if name == "addmv" else 0)
    return 2 * _numel(node), 0


def _conv_flops(node: fx.Node, name: str) -> int:
    """The reference's ``_conv_flops``: 2 x output elements x the kernel's
    input features x its spatial size; the backward as the two
    convolutions (input gradient, weight gradient) it lowers to."""
    args = dict((a.name, v) for a, v in bound_args(node))
    groups = int(args.get("groups", 1))
    w = _shape(args["weight"])
    transposed = bool(args.get("transposed", False))
    c_in = (w[0] // groups) if transposed else w[1]
    k_sp = math.prod(w[2:]) if len(w) > 2 else 1
    if name == "convolution":
        return 2 * _numel(node) * c_in * k_sp
    grad_out, inp = _shape(args["grad_output"]), _shape(args["input"])
    mask = list(args.get("output_mask", [True, True, True]))
    c_out = (w[1] * groups) if transposed else w[0]
    flops = 0
    if mask[0]:      # input gradient: over the input, C_out/groups deep
        flops += 2 * math.prod(inp) * (c_out // groups) * k_sp
    if mask[1]:      # weight gradient: over the weight, N x out spatial
        flops += 2 * math.prod(w) * grad_out[0] * math.prod(grad_out[2:])
    return flops


def _kernel_work(node: fx.Node, name: str):
    """(bytes, flops) of a registered-kernel node from its registry
    entry's (static) work, or None for another ``ptt`` op."""
    from paddle_tpu_torch.kernels import registry
    entry = _KERNEL_OPS.get(name)
    if entry is None:
        return None
    e = registry.get(entry)
    work = e.static_work or e.work
    args, kw = [], {}
    for a, v in bound_args(node):
        val = tensors(v)[0] if isinstance(v, fx.Node) and tensors(v) \
            else (None if isinstance(v, fx.Node) else v)
        if a.kwarg_only or a.name in ("causal", "scale"):
            kw[a.name] = val
        else:
            args.append(val)
    return work(*args, **kw)


#: registered op -> registry entry
_KERNEL_OPS = {
    "ptt.flash_fwd": "flash_attention_fwd",
    "ptt.flash_bwd_dkv": "flash_attention_bwd_dkv",
    "ptt.flash_bwd_dq": "flash_attention_bwd_dq",
    "ptt.paged_decode": "ragged_paged_decode",
    "ptt.paged_prefill": "ragged_paged_prefill",
    "ptt.paged_decode_int8": "ragged_paged_decode_int8",
    "ptt.paged_prefill_int8": "ragged_paged_prefill_int8",
}


def _is_view(node: fx.Node) -> bool:
    aliased, written = fx_lint.aliasing(node)
    return bool(aliased) and not written


def _classify(node: fx.Node, name: str):
    """({class: flops}, bytes) of one op node."""
    ins = [a for a in _flat_nodes((node.args, node.kwargs))]
    io_bytes = sum(node_bytes(a) for a in ins) + node_bytes(node)
    work = _kernel_work(node, name) if name.startswith("ptt.") else None
    if work is not None:
        nb, fl = work
        return {("paged" if "paged" in name else "flash"): int(fl)}, int(nb)
    if name in MATMUL_OPS:
        mm, ew = _matmul_flops(node, name)
        return {"matmul": mm, "other": ew}, io_bytes
    if name in CONV_OPS:
        return {"conv": _conv_flops(node, name)}, io_bytes
    if name.startswith("_scaled_dot_product"):
        (b, h, sq, d), k = _shape(node.args[0]), _shape(node.args[1])
        return {"flash": 4 * b * h * sq * k[2] * d}, io_bytes
    if name == "getitem" or _is_view(node):
        return {}, 0
    if name in DATA_MOVEMENT:
        return {}, io_bytes
    if name in _REDUCTIONS:
        return {"other": sum(_numel(a) for a in ins)}, io_bytes
    if name.startswith("_foreach_"):
        return {"other": sum(_numel(a) for a in ins if tensors(a))
                // _n_lists(node)}, io_bytes
    return {"other": sum(int(t.numel()) for t in tensors(node))}, io_bytes


def _n_lists(node: fx.Node) -> int:
    """How many tensor lists a foreach op reads (its flops count one
    element op per element of one list)."""
    return max(1, sum(1 for a in node.args
                      if isinstance(a, (list, tuple)) and a
                      and isinstance(a[0], fx.Node)))


# ---------------------------------------------------------------------------
# the walker
# ---------------------------------------------------------------------------

class _Walker:
    def __init__(self, mesh_axes=None, resharding_min_bytes: int = 1 << 16):
        self.mesh_axes = mesh_axes
        self.resharding_min_bytes = resharding_min_bytes

    def run(self, gm: fx.GraphModule, report: CostReport,
            state_nodes: Optional[set] = None):
        g = gm.graph
        al = fx_lint.Aliases(g)
        inputs = [n for n in g.nodes if n.op in ("placeholder", "get_attr")
                  and tensors(n) and al.of(n) is n]
        report.arg_bytes = sum(node_bytes(n) for n in inputs)
        report.donated_bytes = sum(node_bytes(n) for n in inputs
                                   if n in al.written)
        out = next(n for n in g.nodes if n.op == "output")
        report.out_bytes = sum(node_bytes(n) for n in _flat_nodes(out.args))
        report.peak_hbm_bytes = self._walk(gm, report, top=True)
        self._resharding(gm, report)

    def _walk(self, gm: fx.GraphModule, report: CostReport,
              top: bool = False) -> int:
        nodes = list(gm.graph.nodes)
        al = fx_lint.Aliases(gm.graph)
        last = {}
        for i, n in enumerate(nodes):
            for a in _flat_nodes((n.args, n.kwargs)):
                r = al.of(a)
                last[r] = max(last.get(r, 0), i)
        end = len(nodes)
        delta = [0] * (end + 1)
        extra = [0] * end
        for i, n in enumerate(nodes):
            if n.op in ("placeholder", "get_attr"):
                # inputs live for the whole call (a subgraph's
                # placeholders are its caller's values, live there)
                if al.of(n) is n and (top or n.op == "get_attr"):
                    delta[0] += node_bytes(n)
                continue
            if n.op != "call_function":
                continue
            name = fx_lint.op_name(n)
            for _attr, sub in fx_lint.subgraphs(gm, n):
                extra[i] = max(extra[i], self._walk(sub, report))
            if name in fx_lint.SKIP_TARGETS:
                continue
            parts, nb = _classify(n, name)
            oc = report.per_op.setdefault(name, OpCost())
            oc.count += 1
            oc.flops += sum(parts.values())
            oc.bytes += nb
            for cls, flops in parts.items():
                report.flops_by_class[cls] = \
                    report.flops_by_class.get(cls, 0) + flops
            if name == "ptt.collective":
                self._collective(n, report)
            if al.of(n) is n and not fx_lint.subgraphs(gm, n):
                size = node_bytes(n)
                delta[i] += size
                # outputs live to the end; the rest die after their
                # last use through any alias
                dies = last.get(n, i)
                if nodes[dies].op != "output":
                    delta[dies + 1] -= size
        peak = running = 0
        for i in range(end):
            running += delta[i]
            peak = max(peak, running + extra[i])
        return peak

    def _collective(self, n: fx.Node, report: CostReport):
        args = dict((a.name, v) for a, v in bound_args(n))
        nb = max(node_bytes(args["x"]), node_bytes(n))
        size = int(args.get("group_size", 1))
        ax = ""
        if self.mesh_axes and size > 1:
            ax = "|".join(a for a, s in self.mesh_axes.items()
                          if int(s) == size)
        report.collectives.append(Collective(
            str(args["kind"]), nb, 1, size, ax, n.name))

    def _resharding(self, gm: fx.GraphModule, report: CostReport):
        """Gathers that reach a scatter through data movement alone."""
        for n in gm.graph.nodes:
            if fx_lint.op_name(n) != "ptt.collective" or \
                    _kind(n) != "all_gather":
                continue
            nb = node_bytes(n)
            if nb < self.resharding_min_bytes:
                continue
            frontier, seen = [n], set()
            while frontier:
                nxt = []
                for v in frontier:
                    for user in v.users:
                        if user in seen:
                            continue
                        seen.add(user)
                        name = fx_lint.op_name(user)
                        if name == "ptt.collective" and _kind(user) in (
                                "reduce_scatter", "all_to_all"):
                            report.resharding.append(ReshardSite(
                                nb, "all_gather", _kind(user),
                                f"{n.name} -> {user.name}"))
                        elif name in _PASSTHROUGH:
                            nxt.append(user)
                frontier = nxt


def _kind(n: fx.Node) -> str:
    args = dict((a.name, v) for a, v in bound_args(n))
    return str(args.get("kind", ""))


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def analyze_module(gm: fx.GraphModule, *, name: str = "fn",
                   mesh_axes: Optional[Dict[str, int]] = None,
                   resharding_min_bytes: int = 1 << 16) -> CostReport:
    """Walk a traced graph module into a :class:`CostReport`."""
    report = CostReport(name)
    _Walker(mesh_axes, resharding_min_bytes).run(gm, report)
    return report


def estimate_lowered(tr, *, name: Optional[str] = None,
                     mesh_axes: Optional[Dict[str, int]] = None,
                     resharding_min_bytes: int = 1 << 16) -> CostReport:
    """Cost-analyze a :class:`~paddle_tpu_torch.analysis.api.Trace` (the
    reference's ``Lowered``)."""
    return analyze_module(tr.gm, name=name or tr.name, mesh_axes=mesh_axes,
                          resharding_min_bytes=resharding_min_bytes)


def estimate_cost(fn, *args, name: Optional[str] = None,
                  mesh_axes: Optional[Dict[str, int]] = None,
                  resharding_min_bytes: int = 1 << 16,
                  **kwargs) -> CostReport:
    """Trace ``fn(*args, **kwargs)`` on fake tensors and cost-analyze the
    graph. Args may be real tensors, fakes, modules or optimizers --
    nothing executes."""
    from paddle_tpu_torch.analysis import api
    tr = api.trace(fn, args, kwargs, name=name)
    if tr.failure is not None:
        raise tr.failure
    return estimate_lowered(tr, mesh_axes=mesh_axes,
                            resharding_min_bytes=resharding_min_bytes)
