"""Numeric debugging and program inspection (``paddle_tpu/debug.py``;
fluid's ``FLAGS_check_nan_inf``, ``debugger.py``, ``op_frequence.py`` and
``memory_usage_calc.py``).

- :func:`nan_checks` / :func:`enable_nan_checks`: every operator's
  floating outputs are checked for NaN as it runs (a
  ``TorchDispatchMode``, the port's ``jax_debug_nans``): the first NaN
  raises ``FloatingPointError`` naming the operator. It reads each output
  back to the host, so it is for debugging, not for captured steps.
- :func:`check_numerics` raises on a non-finite leaf at once; inside
  :func:`checked` it records a device-side flag instead (no host read)
  and the wrapped call returns ``(err, out)``, ``err.throw()`` raising
  (the reference's checkify).
- :func:`print_program`, :func:`program_to_dot`, :func:`op_frequency`
  and :func:`estimate_memory` read the program a function traces to:
  its ATen graph from ``make_fx`` (stage "fx", the jaxpr's role), or the
  ``torch.export`` program (stage "export", the lowered text's role).
  :func:`estimate_memory` walks that graph's tensor sizes: the inputs,
  the outputs, and the peak of the intermediates live at once.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils import _pytree as pytree


class _NanCheck(TorchDispatchMode):
    """Raise on the first operator output holding NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {func}")
        return out


_GLOBAL_CHECK: List[_NanCheck] = []


def enable_nan_checks(enable: bool = True):
    """The NaN trap on (or off) for this process from now on
    (``FLAGS_check_nan_inf``); prefer the scoped :func:`nan_checks`."""
    if enable and not _GLOBAL_CHECK:
        mode = _NanCheck()
        mode.__enter__()
        _GLOBAL_CHECK.append(mode)
    elif not enable and _GLOBAL_CHECK:
        _GLOBAL_CHECK.pop().__exit__(None, None, None)


@contextlib.contextmanager
def nan_checks(enable: bool = True):
    """The NaN trap inside the block (``enable=False``: a block that
    runs without it even under :func:`enable_nan_checks`)."""
    if not enable:
        with torch.utils._python_dispatch._disable_current_modes():
            yield
        return
    with _NanCheck():
        yield


class CheckError:
    """The failed checks of a :func:`checked` call: ``get()`` gives the
    first failure's message (None when every check held), ``throw()``
    raises it as ``FloatingPointError``."""

    def __init__(self, checks):
        self._checks = checks

    def get(self) -> Optional[str]:
        for ok, msg in self._checks:
            if not bool(ok):
                return msg
        return None

    def throw(self):
        msg = self.get()
        if msg is not None:
            raise FloatingPointError(msg)


class _Checks(threading.local):
    def __init__(self):
        self.active: Optional[list] = None


_CHECKS = _Checks()


def _named_leaves(tree, label):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{label}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{label}[{i}]")
    else:
        yield label, tree


def check_numerics(tree: Any, label: str = "tensor") -> Any:
    """Check that every floating leaf of ``tree`` is finite; returns
    ``tree`` unchanged, so it can sit mid-computation. Outside
    :func:`checked` a failure raises ``FloatingPointError`` at once."""
    for name, leaf in _named_leaves(tree, label):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            ok = torch.isfinite(leaf).all()
            msg = f"non-finite values in {name}"
            if _CHECKS.active is not None:
                _CHECKS.active.append((ok, msg))
            elif not bool(ok):
                raise FloatingPointError(msg)
    return tree


def checked(fn: Callable) -> Callable:
    """``fn`` with its :func:`check_numerics` calls deferred: the wrapper
    returns ``(err, out)`` (:class:`CheckError`), reading nothing back
    from the device until ``err.get()`` or ``err.throw()``."""

    def wrapper(*args, **kwargs):
        prev = _CHECKS.active
        _CHECKS.active = []
        try:
            out = fn(*args, **kwargs)
            return CheckError(_CHECKS.active), out
        finally:
            _CHECKS.active = prev

    return wrapper


def finite_or_zero(x):
    """``x`` with its non-finite values set to 0."""
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


# -- the traced program -------------------------------------------------------

def _fx(fn, args, kwargs):
    from torch.fx.experimental.proxy_tensor import make_fx
    return make_fx(lambda *a: fn(*a, **kwargs))(*args)


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


def print_program(fn, *example_args, stage: str = "fx", **example_kwargs):
    """The program ``fn`` traces to on the example inputs, printed and
    returned: ``stage="fx"``, the ATen graph (``make_fx``);
    ``stage="export"``, the ``torch.export`` program."""
    if stage == "fx":
        text = str(_fx(fn, example_args, example_kwargs).graph)
    elif stage == "export":
        text = str(torch.export.export(_Fn(fn), example_args,
                                       example_kwargs))
    else:
        raise ValueError(f"stage must be 'fx' or 'export', got {stage!r}")
    print(text)
    return text


def _ops(graph):
    return [n for n in graph.nodes if n.op == "call_function"]


def _op_name(target) -> str:
    """An ATen overload's operator name: ``aten.add.Tensor`` -> ``add``."""
    name = getattr(target, "__name__", str(target))
    return name.split(".")[0]


def program_to_dot(fn, *example_args, max_nodes: int = 200,
                   **example_kwargs) -> str:
    """Graphviz dot of the traced program (``net_drawer.py``): one node
    per operator, edges from producer to consumer."""
    ops = _ops(_fx(fn, example_args, example_kwargs).graph)
    index = {n: i for i, n in enumerate(ops[:max_nodes])}
    lines = ["digraph program {", "  rankdir=TB;",
             "  node [shape=box, fontsize=10];"]
    for n, i in index.items():
        lines.append(f'  op{i} [label="{_op_name(n.target)}"];')
    for n, i in index.items():
        for src in n.all_input_nodes:
            if src in index and index[src] != i:
                lines.append(f"  op{index[src]} -> op{i};")
    if len(ops) > max_nodes:
        lines.append(f'  trunc [label="... {len(ops) - max_nodes} '
                     f'more ops", style=dashed];')
    lines.append("}")
    return "\n".join(lines)


def op_frequency(fn, *example_args, **example_kwargs) -> Dict[str, int]:
    """``{operator name: count}`` of the traced program, by descending
    count (``contrib/op_frequence.py``)."""
    counts = collections.Counter(
        _op_name(n.target)
        for n in _ops(_fx(fn, example_args, example_kwargs).graph))
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def _nbytes(val) -> int:
    return sum(t.numel() * t.element_size()
               for t in pytree.tree_leaves(val)
               if isinstance(t, torch.Tensor))


def estimate_memory(fn, *example_args, **example_kwargs) -> Dict[str, int]:
    """Bytes of the traced program (``contrib/memory_usage_calc.py``):
    ``argument_bytes`` (the inputs), ``output_bytes``, ``temp_bytes``
    (the most intermediate bytes live at once, each freed after its last
    use, in the graph's order), ``generated_code_bytes`` (0: nothing is
    compiled) and ``total_bytes`` (the three sums)."""
    graph = _fx(fn, example_args, example_kwargs).graph
    nodes = list(graph.nodes)
    last_use = {}
    for i, n in enumerate(nodes):
        for src in n.all_input_nodes:
            last_use[src] = i
    out_node = next(n for n in nodes if n.op == "output")
    outputs = set(out_node.all_input_nodes)
    args = out = live = peak = 0
    for i, n in enumerate(nodes):
        size = _nbytes(n.meta.get("val"))
        if n.op == "placeholder":
            args += size
        elif n.op == "call_function":
            if n in outputs:
                out += size
            else:
                live += size
                peak = max(peak, live)
        for src in n.all_input_nodes:
            if last_use.get(src) == i and src.op == "call_function" \
                    and src not in outputs:
                live -= _nbytes(src.meta.get("val"))
    return {"argument_bytes": args, "output_bytes": out,
            "temp_bytes": peak, "generated_code_bytes": 0,
            "total_bytes": args + out + peak}


__all__ = ["CheckError", "check_numerics", "checked", "enable_nan_checks",
           "estimate_memory", "finite_or_zero", "nan_checks", "op_frequency",
           "print_program", "program_to_dot"]
