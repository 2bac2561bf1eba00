"""AST linter for step functions (``paddle_tpu/analysis/ast_lint.py``).

The graph tier (:mod:`~paddle_tpu_torch.analysis.fx_lint`) sees what a
trace recorded; this pass reads the Python *source* of a step function
and flags host-sync idioms, which either stall the device every step or
cannot be captured in a CUDA graph:

- ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
  ``.block_until_ready()`` and ``float()/int()/bool()`` on tensor
  values, and ``.to("cpu")`` (a device-to-host copy per call);
- ``np.asarray`` / ``np.array`` / ``np.copy`` materialization;
- ``torch.cuda.synchronize()`` (the host waits for the device);
- ``time.time()`` / ``time.perf_counter()`` (in a captured step, the
  capture's one timestamp; eagerly, a host read that times nothing the
  device did);
- bare stdlib ``random.*`` (a host draw, frozen into a captured step);
- Python ``if``/``while`` on tensor-valued names (a host sync per call,
  and in a CUDA-graphed step the branch taken at capture is replayed
  forever).

Tensor inference is the reference's shallow heuristic: the function's
parameters seed the set (minus parameters whose defaults are plain
Python flags -- ``training=False``, ``mode="train"``, ``generator=None``
-- which are configuration by convention), and assignments propagate.
``x is None``-style comparisons are static and never flagged. The lint
is per function -- callees are not followed; run it on the step itself.
"""

from __future__ import annotations

import ast
import inspect
import textwrap
from typing import List, Set

from paddle_tpu_torch.analysis.findings import RULES, Finding

_NUMPY_MODULES = {"np", "numpy"}
_TIME_CALLS = {"time", "perf_counter", "monotonic", "process_time"}
_SYNC_METHODS = {"item", "tolist", "block_until_ready", "cpu", "numpy"}
_CAST_BUILTINS = {"float", "int", "bool", "complex"}


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _is_none_compare(test: ast.AST) -> bool:
    """`x is None` / `x is not None` / `x == None`: static, never a sync."""
    if not isinstance(test, ast.Compare):
        return False
    return any(isinstance(c, ast.Constant) and c.value is None
               for c in test.comparators)


def _static_default(default: ast.AST) -> bool:
    """Defaults that mark a parameter as configuration, not a tensor."""
    return isinstance(default, ast.Constant) and isinstance(
        default.value, (bool, str, int, float, type(None)))


def _dotted(node: ast.AST) -> str:
    """``torch.cuda.synchronize`` for that attribute chain, else ''."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    return ".".join([node.id] + parts[::-1])


def _names_cpu(node: ast.AST) -> bool:
    """``"cpu"``, ``torch.device("cpu")`` or ``device="cpu"``."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.split(":")[0] \
            == "cpu"
    if isinstance(node, ast.Call) and _dotted(node.func) == "torch.device":
        return bool(node.args) and _names_cpu(node.args[0])
    return False


class _FnLinter(ast.NodeVisitor):
    def __init__(self, fn_node: ast.FunctionDef, filename: str,
                 line_offset: int):
        self.filename = filename
        self.off = line_offset
        self.findings: List[Finding] = []
        self.tracers: Set[str] = set()
        args = fn_node.args
        pos = list(args.posonlyargs) + list(args.args)
        n_def = len(args.defaults)
        defaults = [None] * (len(pos) - n_def) + list(args.defaults)
        for a, d in zip(pos, defaults):
            if a.arg != "self" and (d is None or not _static_default(d)):
                self.tracers.add(a.arg)
        for a, d in zip(args.kwonlyargs, args.kw_defaults):
            if d is None or not _static_default(d):
                self.tracers.add(a.arg)
        if args.vararg:
            self.tracers.add(args.vararg.arg)
        if args.kwarg:
            self.tracers.add(args.kwarg.arg)

    # -- helpers ------------------------------------------------------------
    def _loc(self, node) -> str:
        return f"{self.filename}:{node.lineno + self.off}"

    def _tracer_expr(self, node: ast.AST) -> bool:
        return bool(_names_in(node) & self.tracers)

    def _add(self, rule: str, node: ast.AST, message: str, fix: str):
        self.findings.append(Finding(
            rule, RULES[rule][0], message, location=self._loc(node),
            fix=fix, engine="ast"))

    # -- dataflow -----------------------------------------------------------
    def visit_Assign(self, node: ast.Assign):
        if self._tracer_expr(node.value):
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        self.tracers.add(n.id)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        if self._tracer_expr(node.value) and isinstance(node.target,
                                                        ast.Name):
            self.tracers.add(node.target.id)
        self.generic_visit(node)

    def visit_For(self, node: ast.For):
        if self._tracer_expr(node.iter):
            for n in ast.walk(node.target):
                if isinstance(n, ast.Name):
                    self.tracers.add(n.id)
        self.generic_visit(node)

    # -- rules --------------------------------------------------------------
    def visit_Call(self, node: ast.Call):
        fn = node.func
        dotted = _dotted(fn)
        # x.item() / x.tolist() / x.cpu() / x.numpy() / x.block_until_ready()
        if isinstance(fn, ast.Attribute) and fn.attr in _SYNC_METHODS \
                and self._tracer_expr(fn.value):
            self._add("ast-host-sync", node,
                      f"`.{fn.attr}()` on a tensor value: device->host "
                      "sync inside the step",
                      "return the tensor in the metrics dict and read it "
                      "on the host after the step")
        # x.to("cpu") / x.to(device="cpu") / x.to(torch.device("cpu"))
        elif isinstance(fn, ast.Attribute) and fn.attr == "to" \
                and self._tracer_expr(fn.value) and (
                    any(_names_cpu(a) for a in node.args)
                    or any(k.arg == "device" and _names_cpu(k.value)
                           for k in node.keywords)):
            self._add("ast-host-sync", node,
                      "`.to(\"cpu\")` on a tensor value: a device-to-host "
                      "copy inside the step",
                      "keep the value on the device; copy it out after "
                      "the step returns")
        # torch.cuda.synchronize()
        elif dotted in ("torch.cuda.synchronize", "cuda.synchronize"):
            self._add("ast-host-sync", node,
                      "`torch.cuda.synchronize()` inside the step: the "
                      "host waits for the device every call (and a "
                      "CUDA graph capture refuses it)",
                      "synchronize outside the step, where a measurement "
                      "needs it")
        # np.asarray / np.array / np.copy
        elif isinstance(fn, ast.Attribute) and \
                isinstance(fn.value, ast.Name) and \
                fn.value.id in _NUMPY_MODULES and \
                fn.attr in ("asarray", "array", "copy"):
            self._add("ast-host-sync", node,
                      f"`{fn.value.id}.{fn.attr}(...)` materializes a "
                      "host numpy array inside the step",
                      "use torch.as_tensor on the device or hoist the "
                      "conversion out of the step")
        # time.time() family
        elif isinstance(fn, ast.Attribute) and \
                isinstance(fn.value, ast.Name) and \
                fn.value.id == "time" and fn.attr in _TIME_CALLS:
            self._add("ast-host-sync", node,
                      f"`time.{fn.attr}()` in the step: a CUDA graph "
                      "replays the capture's ONE timestamp forever, and "
                      "eagerly it times the host's enqueue, not the device",
                      "time on the host around the step call "
                      "(Trainer/StepTelemetry already does)")
        # bare stdlib random.*
        elif isinstance(fn, ast.Attribute) and \
                isinstance(fn.value, ast.Name) and fn.value.id == "random":
            self._add("ast-host-sync", node,
                      f"stdlib `random.{fn.attr}(...)` in the step: a host "
                      "draw, frozen into a captured step",
                      "draw on the device from a torch.Generator the "
                      "step's state holds")
        # float(x) / int(x) / bool(x) on a tensor
        elif isinstance(fn, ast.Name) and fn.id in _CAST_BUILTINS and \
                node.args and self._tracer_expr(node.args[0]):
            self._add("ast-host-sync", node,
                      f"`{fn.id}(...)` on a tensor value forces a "
                      "device->host sync (and fails a graph capture)",
                      "keep it as a 0-d tensor; convert after the step "
                      "returns")
        self.generic_visit(node)

    def _check_branch(self, node, kind: str):
        if _is_none_compare(node.test):
            return
        if self._tracer_expr(node.test):
            names = sorted(_names_in(node.test) & self.tracers)
            self._add("ast-tracer-branch", node,
                      f"Python `{kind}` on tensor value(s) "
                      f"{', '.join(names)}: a host sync every call, and in "
                      "a CUDA-graphed step the branch taken at capture is "
                      "frozen into every replay",
                      "use torch.where / masked arithmetic, or hoist the "
                      "decision out of the step")

    def visit_If(self, node: ast.If):
        self._check_branch(node, "if")
        self.generic_visit(node)

    def visit_While(self, node: ast.While):
        self._check_branch(node, "while")
        self.generic_visit(node)


def lint_source(src: str, *, filename: str = "<src>",
                line_offset: int = 0) -> List[Finding]:
    """Lint already-extracted function source (first def found)."""
    tree = ast.parse(textwrap.dedent(src))
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            linter = _FnLinter(node, filename, line_offset)
            linter.visit(node)
            return linter.findings
    return []


def lint_callable(fn) -> List[Finding]:
    """Lint a function's source; returns [] when source is unavailable
    (builtins, C functions, REPL lambdas)."""
    inner = inspect.unwrap(getattr(fn, "__wrapped__", fn))
    try:
        src = inspect.getsource(inner)
        filename = inspect.getsourcefile(inner) or "<src>"
        _, first_line = inspect.getsourcelines(inner)
    except (OSError, TypeError):
        return []
    try:
        return lint_source(src, filename=filename,
                           line_offset=max(0, first_line - 1))
    except SyntaxError:
        return []
