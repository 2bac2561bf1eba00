"""Entry points: lint a step function ahead of time
(``paddle_tpu/analysis/api.py``).

``lint_fn(fn, *args, **kwargs)`` traces ``fn`` on fake tensors (nothing
executes: no kernel launches, no device memory is allocated for state)
and runs the graph analyzer (:mod:`~paddle_tpu_torch.analysis.fx_lint`)
and the AST linter; ``lint_train_step`` wraps the port's
``step(state, **batch)`` convention (used by ``Trainer.fit(lint=...)``
and the Executor's first-dispatch hook); ``enforce`` turns a report into
warnings or a :class:`LintError` per the requested mode.

The trace is ``make_fx`` over fake tensors (``torch.fx.experimental.
proxy_tensor``, real tracing mode under one ``FakeTensorMode`` with a
``ShapeEnv``), not ``torch.export``: a train step calls
``loss.backward()`` and an optimizer that writes its tensors in place,
which ``make_fx`` records as the aten ops autograd and the optimizer
dispatch (the backward through ``ptt::flash_*``, clipping, the
multi-tensor update), where ``torch.export`` wants a functional forward.
The ``ShapeEnv`` turns a host read (``.item()``) or a data-dependent
shape (``nonzero``) into a node with an unbacked size instead of an
error, so the graph tier can report it. Fake tensors keep the device
their real tensors claim: on the card the registered kernels (K1-K6b)
trace as single ``ptt.*`` nodes through their fake implementations, on
the CPU their plain versions' aten ops where the op dispatches there.
"""

from __future__ import annotations

import contextlib
import copy
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                           DynamicOutputShapeException,
                                           FakeTensorMode, is_fake)
from torch.fx.experimental.proxy_tensor import make_fx
from torch.fx.experimental.symbolic_shapes import (
    GuardOnDataDependentSymNode, ShapeEnv)
from torch.overrides import TorchFunctionMode

from paddle_tpu_torch.analysis import ast_lint, fx_lint
from paddle_tpu_torch.analysis.findings import (RULES, Finding, Report,
                                                Suppressions)

LINT_MODES = ("off", "warn", "error")


class LintError(RuntimeError):
    """Raised by ``enforce`` when a lint report fails in 'error' mode."""

    def __init__(self, report: Report):
        self.report = report
        super().__init__("static analysis failed:\n" + report.render_text())


# ---------------------------------------------------------------------------
# abstractify: real tensors -> fake tensors on their own device
# ---------------------------------------------------------------------------

def new_fake_mode() -> FakeTensorMode:
    """The fake mode of one lint: a ``ShapeEnv`` for host reads and
    data-dependent shapes, and real tensors a step closes over (a model's
    weights, a serving engine's pages) taken as fake constants."""
    return FakeTensorMode(shape_env=ShapeEnv(), allow_non_fake_inputs=True)


def fake_mode_of(tree: Any) -> Optional[FakeTensorMode]:
    """The fake mode of the first fake tensor in ``tree``, or None."""
    for _label, t in tensor_leaves(tree):
        if is_fake(t):
            return t.fake_mode
    return None


class _FakeCopies(TorchFunctionMode):
    """While a state is deep-copied: every real tensor the copy meets
    becomes a fake of it (a parameter stays a parameter), so no device
    memory is allocated and the real tensor is only read for its
    metadata."""

    def __init__(self, mode: FakeTensorMode):
        super().__init__()
        self.mode = mode

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.__deepcopy__ or (
                func is torch.Tensor.clone and not is_fake(args[0])):
            return self.mode.from_tensor(args[0], static_shapes=True)
        return func(*args, **(kwargs or {}))


def _optimizer_deepcopy(self, memo):
    # torch.optim.Optimizer pickles three keys only; a port optimizer's
    # step count, schedule and wrappers live in its __dict__
    new = object.__new__(type(self))
    memo[id(self)] = new
    for k, v in self.__dict__.items():
        new.__dict__[k] = copy.deepcopy(v, memo)
    return new


_copy_lock = threading.Lock()


@contextlib.contextmanager
def _fake_copying(mode: FakeTensorMode):
    """Deep copies that fake tensors, keep generators by identity (a
    fake draw consumes nothing, and the graph tier reads which generator
    a random op names) and keep an optimizer's whole state."""
    with _copy_lock:
        dispatch = copy._deepcopy_dispatch
        had = getattr(torch.optim.Optimizer, "__deepcopy__", None)
        dispatch[torch.Generator] = lambda g, memo: g
        torch.optim.Optimizer.__deepcopy__ = _optimizer_deepcopy
        try:
            with _FakeCopies(mode):
                yield
        finally:
            dispatch.pop(torch.Generator, None)
            if had is None:
                del torch.optim.Optimizer.__deepcopy__
            else:
                torch.optim.Optimizer.__deepcopy__ = had


def abstractify(tree: Any, mode: Optional[FakeTensorMode] = None) -> Any:
    """Tensors -> fake tensors on their own device, shapes and dtypes kept
    (already fake ones pass through). Modules and optimizers (and any
    object holding tensors) are deep-copied with their parameters,
    buffers and slots faked: the real ones are never touched, and a
    trace over the copy moves nothing of the real state. ``mode``: the
    fake mode to make them in (default: the tree's own, else a new
    one); every input of one trace must share one."""
    mode = mode or fake_mode_of(tree) or new_fake_mode()
    if isinstance(tree, torch.Tensor):
        return tree if is_fake(tree) else mode.from_tensor(
            tree, static_shapes=True)
    with _fake_copying(mode):
        return copy.deepcopy(tree)


def tensor_leaves(tree: Any, label: str = "",
                  seen: Optional[set] = None) -> List[Tuple[str,
                                                            torch.Tensor]]:
    """``(label, tensor)`` for every tensor of ``tree``: nested dicts,
    lists and tuples, a module's parameters and buffers, an optimizer's
    parameters and state tensors (each tensor once, in a fixed order;
    ``seen``, ids already listed by an earlier call, is updated)."""
    seen = set() if seen is None else seen

    def walk(x, lab):
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                yield lab, x
        elif isinstance(x, dict):
            for k, v in x.items():
                yield from walk(v, f"{lab}[{k!r}]")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                yield from walk(v, f"{lab}[{i}]")
        elif isinstance(x, nn.Module):
            for n, t in list(x.named_parameters()) + list(x.named_buffers()):
                yield from walk(t, f"{lab}.{n}")
        elif isinstance(x, torch.optim.Optimizer):
            params = [p for g in x.param_groups for p in g["params"]]
            for i, p in enumerate(params):
                yield from walk(p, f"{lab}.param[{i}]")
            extra = x.state_tensors() if hasattr(x, "state_tensors") else [
                t for st in x.state.values() for t in st.values()
                if isinstance(t, torch.Tensor)]
            for i, t in enumerate(extra):
                yield from walk(t, f"{lab}.state[{i}]")

    return list(walk(tree, label))


def _generators(tree: Any) -> List[torch.Generator]:
    """Generators a state holds: in containers, module and optimizer
    attributes (one level into their ``__dict__``)."""
    out: Dict[int, torch.Generator] = {}

    def walk(x, depth):
        if isinstance(x, torch.Generator):
            out[id(x)] = x
        elif depth > 4:
            return
        elif isinstance(x, dict):
            for v in x.values():
                walk(v, depth + 1)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v, depth + 1)
        elif isinstance(x, nn.Module):
            for m in x.modules():
                for v in vars(m).values():
                    if isinstance(v, torch.Generator):
                        out[id(v)] = v
        elif isinstance(x, torch.optim.Optimizer):
            for v in vars(x).values():
                walk(v, depth + 1)

    walk(tree, 0)
    return list(out.values())


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

#: a trace that stops at a Python decision on a device value
_DATA_DEPENDENT = (GuardOnDataDependentSymNode, DataDependentOutputException,
                   DynamicOutputShapeException)


class Trace:
    """One function traced on fake tensors: the graph module ``gm``, the
    label of each placeholder (``inputs``, in order), the tensors that
    belong to the state argument (``state``, by id), and what the trace
    saw of random generators (``generators``: ``held``, the prints
    (:func:`generator_print`) of the generators the inputs hold and of
    the default generators; ``reseeded``, those the traced body seeded,
    as they were before and after its seeding, and
    ``reseeded_defaults``, the default generators among them;
    ``captured``, whether the step is replayed from a CUDA graph).
    ``failure`` holds the exception of a trace that stopped at a
    data-dependent Python decision (``gm`` is then None)."""

    def __init__(self, name: str):
        self.name = name
        self.gm = None
        self.inputs: List[Tuple[str, torch.Tensor]] = []
        self.state: set = set()
        self.generators: Dict[str, Any] = {
            "held": set(), "reseeded": set(), "reseeded_defaults": [],
            "captured": False}
        self.failure: Optional[BaseException] = None

    def placeholder_labels(self) -> Dict[str, str]:
        """Placeholder node name -> label."""
        names = [n.name for n in self.gm.graph.nodes
                 if n.op == "placeholder"]
        return {n: lab for n, (lab, _t) in zip(names, self.inputs)}

    def state_placeholders(self) -> set:
        names = [n.name for n in self.gm.graph.nodes
                 if n.op == "placeholder"]
        return {n for n, (_lab, t) in zip(names, self.inputs)
                if id(t) in self.state}


def generator_print(g: torch.Generator) -> tuple:
    """What identifies a generator in a trace: the tracer keeps its own
    copy of a generator a random op names, so the graph tier matches
    generators by device, seed and state rather than by identity."""
    return (str(g.device), g.initial_seed(), bytes(g.get_state().numpy()))


def _default_generators() -> List[torch.Generator]:
    gens = [torch.default_generator]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        gens += list(torch.cuda.default_generators)
    return gens


def trace(fn, args: Sequence[Any] = (), kwargs: Optional[Dict] = None, *,
          name: Optional[str] = None, state_argnum: Optional[int] = 0,
          captured: bool = False) -> Trace:
    """Trace ``fn(*args, **kwargs)`` on fake tensors into a
    :class:`Trace`. ``args``/``kwargs`` may hold real tensors, modules
    and optimizers (abstractified here) or fakes of one mode. The
    tensors of the inputs become the graph's placeholders (a module's
    parameters included, so their in-place updates show as writes into
    inputs); tensors ``fn`` closes over become constants. Generators
    the body re-seeds are put back as they were."""
    kwargs = dict(kwargs or {})
    mode = fake_mode_of((args, kwargs)) or new_fake_mode()
    args = tuple(abstractify(a, mode) for a in args)
    kwargs = {k: abstractify(v, mode) for k, v in kwargs.items()}
    name = name or getattr(fn, "__name__", None) or type(fn).__name__
    tr = Trace(name)
    seen: set = set()
    for i, a in enumerate(args):
        tr.inputs += tensor_leaves(a, f"args[{i}]", seen)
    for k, v in kwargs.items():
        tr.inputs += tensor_leaves(v, k, seen)
    if state_argnum is not None and state_argnum < len(args):
        tr.state = {id(t) for _lab, t in tensor_leaves(args[state_argnum])}
    held = _generators((args, kwargs))
    defaults = _default_generators()
    watched = {id(g): g for g in held + defaults}
    seeds = {k: g.initial_seed() for k, g in watched.items()}
    states = {k: g.get_state() for k, g in watched.items()}
    prints = {k: generator_print(g) for k, g in watched.items()}
    tr.generators["held"] = set(prints.values())
    tr.generators["captured"] = captured

    def flat_fn(*_tensors):
        return [t for _lab, t in tensor_leaves(fn(*args, **kwargs))]

    try:
        with mode:
            tr.gm = make_fx(flat_fn, tracing_mode="real")(
                *[t for _lab, t in tr.inputs])
    except _DATA_DEPENDENT as e:
        tr.failure = e
    finally:
        for k, g in watched.items():
            if g.initial_seed() != seeds[k] or not torch.equal(
                    g.get_state(), states[k]):
                # the tracer's copy may show it before or after
                tr.generators["reseeded"] |= {prints[k], generator_print(g)}
                if any(g is d for d in defaults):
                    tr.generators["reseeded_defaults"].append(g)
                g.set_state(states[k])
    return tr


def _stopped_finding(tr: Trace) -> Finding:
    msg = str(tr.failure).strip().splitlines()[0][:200]
    return Finding(
        "host-callback", RULES["host-callback"][0],
        "the trace stopped at a Python decision on a device value (a "
        f"host sync, and a branch a CUDA graph would freeze): {msg}",
        location=tr.name,
        fix="keep the decision on the device (torch.where / masked "
            "arithmetic) or hoist it out of the step", engine="fx")


# ---------------------------------------------------------------------------
# lint_fn / lint_train_step / enforce
# ---------------------------------------------------------------------------

def lint_fn(fn, *args,
            state_argnum: Optional[int] = 0,
            name: Optional[str] = None,
            ast: bool = True,
            ast_fn=None,
            suppressions: Optional[Suppressions] = None,
            donation_min_bytes: int = 1 << 16,
            plan=None,
            replicated_min_bytes: int = 1 << 20,
            registry: bool = True,
            captured: bool = False,
            cost: bool = False,
            hbm_budget_bytes: Optional[int] = None,
            flops_budget: Optional[int] = None,
            collective_allowlist=None,
            mesh_axes=None,
            **kwargs) -> Report:
    """Statically lint ``fn(*args, **kwargs)``; returns a :class:`Report`.

    ``args``/``kwargs`` are example inputs (real or fake tensors,
    modules, optimizers): everything is abstractified before tracing,
    so nothing executes. ``state_argnum`` names the argument holding the
    state the function updates (the undonated-buffer rule reads its
    tensors; None skips it). ``plan`` (a
    ``parallel.plan.ShardingPlan``) enables the replicated-large check
    against that argument. ``captured``: the function is replayed from
    a CUDA graph (the generator-registration half of prng-key-reuse).
    ``ast=False`` skips the source linter; ``ast_fn`` lints other
    functions' source than the traced one (one or a sequence: a train
    step and its loss function). Findings are counted into the
    observability registry unless ``registry=False``.

    ``cost=True`` (implied by any of the cost options) attaches the
    static :class:`~paddle_tpu_torch.analysis.cost_model.CostReport` of
    the same trace as ``report.cost`` and runs the cost-tier rules:
    ``collective_allowlist`` (a sequence, possibly empty) gates
    ``unexpected-collective``, ``hbm_budget_bytes``/``flops_budget``
    gate the budget rules, resharding round trips always report, and
    ``mesh_axes`` (``{axis: size}``) attributes collective bytes to
    mesh axes."""
    if hbm_budget_bytes is not None or flops_budget is not None \
            or collective_allowlist is not None or mesh_axes is not None:
        cost = True
    name = name or getattr(fn, "__name__", None) or type(fn).__name__
    tr = trace(fn, args, kwargs, name=name, state_argnum=state_argnum,
               captured=captured)
    report = Report(name, suppressions=suppressions)
    if tr.failure is not None:
        report.add(_stopped_finding(tr))
    else:
        report.extend(fx_lint.analyze_graph(
            tr, donation_min_bytes=donation_min_bytes))
    if plan is not None and state_argnum is not None \
            and state_argnum < len(args):
        report.extend(fx_lint.plan_findings(plan, args[state_argnum],
                                            replicated_min_bytes))
    if ast:
        fns = ast_fn if isinstance(ast_fn, (list, tuple)) else [ast_fn or fn]
        for f in fns:
            if f is not None:
                report.extend(ast_lint.lint_callable(f))
    if cost and tr.failure is None:
        from paddle_tpu_torch.analysis import cost_model, hlo_lint
        report.cost = cost_model.estimate_lowered(tr, mesh_axes=mesh_axes)
        report.extend(hlo_lint.lint_cost_report(
            report.cost, collective_allowlist=collective_allowlist,
            hbm_budget_bytes=hbm_budget_bytes, flops_budget=flops_budget))
    if registry:
        report.count_into_registry()
    return report


def lint_train_step(step, state, batch, *, plan=None, **kw) -> Report:
    """Lint a ``step(state, **batch) -> (state, metrics)`` function with
    the port's train-step convention (the state's tensors are updated in
    place; the batch feeds as keyword tensors). A step from
    ``train.build_train_step`` (a ``TrainStepGraphs``) is traced
    uncaptured, through its eager body: forward, backward, clipping,
    the optimizer; it counts as captured when its graphs are on and the
    state lies on the card. Batch keys pass through an adapter closure,
    so they can never collide with lint options; the AST pass reads the
    real step's source and, for a built step, its loss function's."""
    from paddle_tpu_torch.train import TrainStepGraphs
    if isinstance(step, TrainStepGraphs):
        body, ast_fns = step.step, [step.step, step.loss_fn]
        device = state["step"].device if isinstance(
            state.get("step"), torch.Tensor) else torch.device("cpu")
        captured = step.enabled and device.type == "cuda"

        def _kw_step(state, batch):
            return body(state, dict(batch))
    else:
        ast_fns, captured = [step], False

        def _kw_step(state, batch):
            return step(state, **batch)

    kw.setdefault("ast_fn", ast_fns)
    kw.setdefault("captured", captured)
    kw.setdefault("state_argnum", 0)
    return lint_fn(_kw_step, state, dict(batch), plan=plan,
                   name=kw.pop("name", None) or getattr(
                       step, "__name__", "train_step"), **kw)


def enforce(report: Report, mode: str, *, log_fn=None):
    """Apply a lint mode: 'off' ignores, 'warn' logs every finding,
    'error' additionally raises :class:`LintError` when any
    error-severity finding survives suppression. Returns the report."""
    if mode not in LINT_MODES:
        raise ValueError(f"lint mode must be one of {LINT_MODES}, "
                         f"got {mode!r}")
    if mode == "off" or not len(report):
        return report
    text = report.render_text()
    if log_fn is not None:
        log_fn(text)
    else:
        import warnings
        warnings.warn(text, stacklevel=3)
    if mode == "error" and not report.ok("error"):
        raise LintError(report)
    return report
