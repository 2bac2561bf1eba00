"""Graph analyzer: static hazard detection over a traced step function,
the port's counterpart of ``paddle_tpu/analysis/jaxpr_lint.py``.

Walks the aten graph a trace recorded (:func:`~paddle_tpu_torch.analysis.
api.trace`: ``make_fx`` on fake tensors) and every graph module a
higher-order node calls (``torch.cond``, wrapped subgraphs; the
reference's recursion through pjit/scan/remat). ``torch.utils.checkpoint``
and the pipeline's recompute are traced inline, their recompute included,
so a rule sees inside them as anywhere else. The rules, each the
counterpart of the reference's rule of the same id:

- **host-callback** -- nodes that return to the host mid-step:
  ``aten._local_scalar_dense`` (``.item()``, ``float()`` on a tensor),
  device-to-CPU copies, and ops whose output shape depends on the data
  (``nonzero``, boolean-mask indexing: an unbacked size), which sync and
  cannot be captured in a CUDA graph.
- **debug-callback** (warning) -- ``aten._assert_async`` /
  ``_assert_scalar`` and ``aten._print``.
- **f64-promotion** -- a float64/complex128 value anywhere in the graph.
- **undonated-buffer** -- a state input above ``donation_min_bytes``
  that is not written in place while a new tensor of its shape and dtype
  is returned (the port updates its state in place, ``train.py``; a
  functional update holds both copies at the peak).
- **prng-key-reuse** -- a random op drawing from a generator the step
  creates, or re-seeds with a host value, inside its body (every step
  draws the same bits: the reference's key closed over ``scan``); for a
  captured step also a non-default CUDA generator, which the port's
  graphs do not register (every replay repeats the capture's draws).
- **replicated-large** -- the ``ShardingPlan`` half: large state leaves
  whose spec under the plan is fully replicated (:func:`plan_findings`).

Pure analysis of the recorded graph: nothing here runs a kernel.
"""

from __future__ import annotations

import operator
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.fx as fx

from paddle_tpu_torch.analysis.findings import RULES, Finding

aten = torch.ops.aten

HOST_READ_OPS = {aten._local_scalar_dense.default}
DEBUG_OPS = {aten._assert_async.default, aten._assert_async.msg,
             aten._assert_scalar.default, aten._print.default}
_SLOW_DTYPES = (torch.float64, torch.complex128)
#: graph bookkeeping that is not work
SKIP_TARGETS = {"profiler._record_function_enter_new",
                "profiler._record_function_exit"}


# ---------------------------------------------------------------------------
# graph helpers (shared with the cost tier)
# ---------------------------------------------------------------------------

def op_name(node: fx.Node) -> str:
    """``mm``, ``ptt.flash_fwd``, ``getitem``: the node's op without its
    overload (aten ops without the namespace)."""
    t = node.target
    if isinstance(t, torch._ops.OpOverload):
        ns = t.namespace
        base = t._schema.name.split("::", 1)[-1]
        return base if ns == "aten" else f"{ns}.{base}"
    if isinstance(t, torch._ops.HigherOrderOperator):
        return f"higher_order.{t.name()}"
    if t is operator.getitem:
        return "getitem"
    return getattr(t, "__name__", str(t))


def vals(node) -> List[Any]:
    """The fake value(s) a node produced, flattened."""
    v = node.meta.get("val") if isinstance(node, fx.Node) else None
    if isinstance(v, (list, tuple)):
        return [x for x in v if x is not None]
    return [] if v is None else [v]


def tensors(node) -> List[torch.Tensor]:
    return [v for v in vals(node) if isinstance(v, torch.Tensor)]


def nbytes(t: torch.Tensor) -> int:
    try:
        return int(t.numel()) * t.element_size()
    except (TypeError, RuntimeError):   # an unbacked size
        return 0


def node_bytes(node) -> int:
    return sum(nbytes(t) for t in tensors(node))


def _flat_nodes(x) -> List[fx.Node]:
    if isinstance(x, fx.Node):
        return [x]
    if isinstance(x, (list, tuple)):
        return [n for v in x for n in _flat_nodes(v)]
    if isinstance(x, dict):
        return [n for v in x.values() for n in _flat_nodes(v)]
    return []


def bound_args(node: fx.Node) -> List[Tuple[Any, Any]]:
    """``(schema argument, value)`` pairs of an op node (empty for nodes
    without a schema)."""
    schema = getattr(node.target, "_schema", None)
    if schema is None:
        return []
    out = []
    for i, a in enumerate(schema.arguments):
        if i < len(node.args):
            out.append((a, node.args[i]))
        elif a.name in node.kwargs:
            out.append((a, node.kwargs[a.name]))
    return out


def aliasing(node: fx.Node) -> Tuple[List[fx.Node], List[fx.Node]]:
    """``(aliased, written)``: the input nodes the node's output aliases
    (a view, or the result of an in-place op), and those it writes into,
    from the op's schema; ``getitem`` aliases its tuple."""
    if node.target is operator.getitem:
        return _flat_nodes(node.args[0]), []
    schema = getattr(node.target, "_schema", None)
    if schema is None:
        return [], []
    ret_sets = set()
    for r in schema.returns:
        if r.alias_info is not None:
            ret_sets |= set(r.alias_info.before_set)
    aliased, written = [], []
    for a, v in bound_args(node):
        ai = a.alias_info
        if ai is None:
            continue
        nodes = _flat_nodes(v)
        if ai.is_write:
            written += nodes
        if set(ai.before_set) & ret_sets:
            aliased += nodes
    return aliased, written


class Aliases:
    """Alias roots of one graph: each node maps to the node whose storage
    it uses (a placeholder, a constant, or the op that allocated it), and
    the roots some op wrote into."""

    def __init__(self, graph: fx.Graph):
        self.root: Dict[fx.Node, fx.Node] = {}
        self.written: set = set()
        consts: Dict[str, fx.Node] = {}
        for n in graph.nodes:
            if n.op == "get_attr":     # one root per constant
                self.root[n] = consts.setdefault(n.target, n)
                continue
            aliased, written = aliasing(n) if n.op == "call_function" \
                else ([], [])
            self.root[n] = self.root.get(aliased[0], aliased[0]) \
                if aliased else n
            for w in written:
                self.written.add(self.root.get(w, w))

    def of(self, node: fx.Node) -> fx.Node:
        return self.root.get(node, node)


def get_attr(gm: fx.GraphModule, target: str):
    obj = gm
    for part in target.split("."):
        obj = getattr(obj, part)
    return obj


def subgraphs(gm: fx.GraphModule, node: fx.Node
              ) -> List[Tuple[str, fx.GraphModule]]:
    """Graph modules a node calls (a higher-order op's branches or
    body), with their attribute names."""
    out = []
    for a in _flat_nodes((node.args, node.kwargs)):
        if a.op == "get_attr":
            sub = get_attr(gm, a.target)
            if isinstance(sub, fx.GraphModule):
                out.append((a.target, sub))
    return out


def walk_graphs(gm: fx.GraphModule, prefix: str = ""
                ) -> Iterator[Tuple[str, fx.GraphModule]]:
    """``(prefix, graph module)`` for ``gm`` and every subgraph reached
    from its nodes, depth first."""
    yield prefix, gm
    for n in gm.graph.nodes:
        if n.op == "call_function":
            for name, sub in subgraphs(gm, n):
                yield from walk_graphs(sub, f"{prefix}{n.name}:{name}/")


def _where(prefix: str, i: int, node: fx.Node) -> str:
    loc = f"{prefix}node[{i}] {op_name(node)}"
    st = node.meta.get("stack_trace")
    if st:
        last = [ln.strip() for ln in st.strip().splitlines()
                if ln.strip().startswith("File ")]
        if last:
            loc += f" ({last[-1][5:][:120]})"
    return loc


def _is_random(node: fx.Node) -> bool:
    t = node.target
    return isinstance(t, torch._ops.OpOverload) and \
        torch.Tag.nondeterministic_seeded in t.tags


def _generator_of(gm: fx.GraphModule, node: fx.Node):
    for a, v in bound_args(node):
        if a.name == "generator" and isinstance(v, fx.Node) \
                and v.op == "get_attr":
            g = get_attr(gm, v.target)
            if isinstance(g, torch.Generator):
                return g
    return None


def _default_generator(device: torch.device) -> Optional[torch.Generator]:
    if device.type == "cpu":
        return torch.default_generator
    if device.type == "cuda" and torch.cuda.is_available() \
            and torch.cuda.is_initialized():
        return torch.cuda.default_generators[
            device.index if device.index is not None
            else torch.cuda.current_device()]
    return None


def _symbolic(t: torch.Tensor) -> bool:
    return any(isinstance(d, torch.SymInt) for d in t.shape)


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def analyze_graph(tr, *, donation_min_bytes: int = 1 << 16
                  ) -> List[Finding]:
    """Run every graph rule over a :class:`~paddle_tpu_torch.analysis.api.
    Trace`; returns findings (replicated-large's plan half runs in
    :func:`plan_findings`)."""
    findings: List[Finding] = []
    f64_sites: List[str] = []
    f64_seen = 0
    gens = tr.generators
    prng: Dict[str, List[str]] = {}

    def add(rule, msg, loc, fix):
        findings.append(Finding(rule, RULES[rule][0], msg, location=loc,
                                fix=fix, engine="fx"))

    for prefix, gm in walk_graphs(tr.gm):
        for i, n in enumerate(gm.graph.nodes):
            if n.op != "call_function":
                if n.op == "placeholder" and any(
                        t.dtype in _SLOW_DTYPES for t in tensors(n)):
                    f64_seen += 1
                    if len(f64_sites) < 3:
                        f64_sites.append(f"{prefix}input {n.name}")
                continue
            name = op_name(n)
            where = _where(prefix, i, n)
            # ---- host syncs ----
            if n.target in HOST_READ_OPS:
                add("host-callback",
                    "a device value read on the host mid-step "
                    "(`.item()` / `float()` / `int()` on a tensor)",
                    where, "return the tensor in the metrics and read it "
                    "after the step (or keep the arithmetic on the device)")
            elif n.target in DEBUG_OPS:
                add("debug-callback",
                    f"`{name}` in the traced step: a device-side check "
                    "or print the host must service", where,
                    "strip debug asserts/prints from production steps or "
                    "gate them behind a flag")
            elif _d2h_copy(n):
                add("host-callback",
                    f"`{name}` copies a device tensor to the CPU mid-step",
                    where, "keep the value on the device; copy it out "
                    "after the step returns")
            else:
                outs = tensors(n)
                ins = [t for a in _flat_nodes((n.args, n.kwargs))
                       for t in tensors(a)]
                if any(_symbolic(t) for t in outs) and not any(
                        _symbolic(t) for t in ins):
                    add("host-callback",
                        f"`{name}` gives a data-dependent shape: the host "
                        "waits for the device to size the result, and a "
                        "CUDA graph cannot capture it", where,
                        "use a fixed-shape form (torch.where, a mask "
                        "multiply, nonzero_static with a bound)")
            # ---- f64 ----
            if any(t.dtype in _SLOW_DTYPES for t in tensors(n)):
                f64_seen += 1
                if len(f64_sites) < 3:
                    f64_sites.append(where)
            # ---- generators ----
            if _is_random(n):
                why = _prng_hazard(gm, n, gens)
                if why:
                    prng.setdefault(why, []).append(where)

    for why, sites in prng.items():
        add("prng-key-reuse",
            f"{len(sites)} random op(s) draw from {why}",
            "; ".join(sites[:4]),
            "draw from a torch.Generator the state holds (seeded once, "
            "outside the step) or the device's default generator")
    if f64_seen:
        add("f64-promotion",
            f"{f64_seen} node(s) carry float64/complex128 values (the "
            "card runs fp64 at a fraction of its fp32 rate, and the "
            "kernels take fp32/bf16 only)",
            "; ".join(f64_sites),
            "cast to float32 explicitly; build numpy constants as "
            "float32 (torch.as_tensor(np.float64) keeps float64)")
    findings.extend(_donation_findings(tr, donation_min_bytes))
    return findings


def _d2h_copy(n: fx.Node) -> bool:
    """A copy from a non-CPU tensor to a CPU one."""
    outs = tensors(n)
    if n.target is aten._to_copy.default:
        src = tensors(n.args[0]) if isinstance(n.args[0], fx.Node) else []
        return bool(outs and src) and outs[0].device.type == "cpu" \
            and src[0].device.type != "cpu"
    if n.target is aten.copy_.default:
        dst, src = (tensors(a) if isinstance(a, fx.Node) else []
                    for a in n.args[:2])
        return bool(dst and src) and dst[0].device.type == "cpu" \
            and src[0].device.type != "cpu"
    return False


def _prng_hazard(gm, n, gens) -> str:
    from paddle_tpu_torch.analysis.api import generator_print
    g = _generator_of(gm, n)
    outs = tensors(n)
    device = outs[0].device if outs else torch.device("cpu")
    if g is None:
        dg = _default_generator(device)
        if any(dg is d for d in gens["reseeded_defaults"]):
            return (f"the {device.type} default generator, which the step "
                    "re-seeds with a host value inside its body: every "
                    "step draws the same bits")
        return ""
    fp = generator_print(g)
    if fp in gens["reseeded"]:
        return ("a generator the step re-seeds with a host value inside "
                "its body: every step draws the same bits")
    if fp not in gens["held"]:
        return ("a generator the step creates inside its body (its seed "
                "is the same every call): every step draws the same bits")
    default = _default_generator(g.device)
    if gens["captured"] and g.device.type == "cuda" and (
            default is None or fp != generator_print(default)):
        return ("a CUDA generator the step's graph does not register: "
                "every replay repeats the capture's draws")
    return ""


def _donation_findings(tr, min_bytes: int) -> List[Finding]:
    """State inputs not written in place while a new same-shape,
    same-dtype tensor is returned: a multiset walk, as the reference's."""
    gm = tr.gm
    al = Aliases(gm.graph)
    state = tr.state_placeholders()
    labels = tr.placeholder_labels()
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    inputs = set(placeholders) | {n for n in gm.graph.nodes
                                  if n.op == "get_attr"}
    out_node = next(n for n in gm.graph.nodes if n.op == "output")
    pool: Dict[Tuple, int] = {}
    for o in _flat_nodes(out_node.args):
        if al.of(o) in inputs:
            continue                   # an input (or a view of one) back
        for t in tensors(o):
            k = (tuple(t.shape), t.dtype)
            pool[k] = pool.get(k, 0) + 1
    missed, examples = 0, []
    for p in placeholders:
        if p.name not in state or p in al.written:
            continue
        for t in tensors(p):
            if nbytes(t) < min_bytes:
                continue
            k = (tuple(t.shape), t.dtype)
            if pool.get(k, 0) > 0:
                pool[k] -= 1
                missed += nbytes(t)
                if len(examples) < 3:
                    examples.append(labels.get(p.name, p.name))
    if not missed:
        return []
    return [Finding(
        "undonated-buffer", RULES["undonated-buffer"][0],
        f"{missed} bytes of state inputs have same-shape outputs that are "
        f"new tensors (e.g. {', '.join(examples)}): peak memory holds the "
        "old AND new copy of each",
        location=tr.name,
        fix="write the update into the state tensor in place (copy_, "
            "add_, the optimizers' multi-tensor rule) as the port's train "
            "steps do", engine="fx")]


def plan_findings(plan, state, min_bytes: int = 1 << 20) -> List[Finding]:
    """Large state leaves whose spec under ``plan`` (a
    ``parallel.plan.ShardingPlan``) is fully replicated. ``state``: a
    port train state (``{"model", "opt", "step"}``) or the reference's
    tree of tensors."""
    if isinstance(state, dict) and "model" in state:
        from paddle_tpu_torch.trainer import state_tree
        tree = state_tree(state)
    else:
        tree = state
    try:
        specs = plan.state_specs(state)
    except Exception:
        specs = plan.params_specs(tree)
        tree = {"params": tree}
        specs = {"params": specs}
    findings = []

    def walk(t, s, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, s.get(k, ()) if isinstance(s, dict) else (),
                     path + (str(k),))
            return
        if not isinstance(t, torch.Tensor) or nbytes(t) < min_bytes:
            return
        if all(e is None for e in (s or ())):
            where = "/".join(path)
            findings.append(Finding(
                "replicated-large", RULES["replicated-large"][0],
                f"state leaf {where} ({nbytes(t)} bytes) is fully "
                "replicated under the given sharding plan: its memory "
                "multiplies by the mesh size", location=where,
                fix="add a plan rule or a sharding hint for it (or use "
                    "fsdp_plan() to split large parameters)",
                engine="plan"))

    walk(tree, specs, ())
    return findings


def graph_summary(gm: fx.GraphModule) -> Dict[str, int]:
    """Op name -> node count over ``gm`` and its subgraphs (the smoke and
    the tests read ``ptt.*`` nodes from it)."""
    out: Dict[str, int] = {}
    for _prefix, g in walk_graphs(gm):
        for n in g.graph.nodes:
            if n.op == "call_function":
                k = op_name(n)
                out[k] = out.get(k, 0) + 1
    return out


__all__ = ["Aliases", "analyze_graph", "graph_summary", "op_name",
           "plan_findings", "walk_graphs"]
