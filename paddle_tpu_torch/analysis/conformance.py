"""Self-conformance lints: interface drift and the reject vocabulary
(``paddle_tpu/analysis/conformance.py``, pure AST and ``inspect``).

Two small rules that turn recurring review findings into gates, reported
on the same findings spine as the other lints, over the port's serving
plane:

- **interface-drift**: every :class:`ReplicaHandle` implementation
  (``LocalReplica``, ``NetReplica``, the duck-typed ``ChaosReplica``)
  must carry every handle method with a matching signature, and the
  wire protocol's server-side dispatch table (``replica_server.py
  _dispatch``) must name an op for every handle method — a new method
  added to the handle but missing from the dispatch would otherwise
  surface as a runtime ``RemoteError`` on the first fleet that crosses
  a socket.
- **reject-vocab-drift**: the ``Reject.reason`` vocabulary has one
  source of truth (``scheduler.REJECT_REASONS``); every literal reason
  constructed anywhere in the serving plane must be registered, and
  every registered reason must be constructed somewhere (dead vocab is
  drift in the other direction).
"""

from __future__ import annotations

import ast
import inspect
import os
from typing import Dict, List, Optional, Set, Tuple

from paddle_tpu_torch.analysis.findings import Finding

__all__ = ["lint_interfaces", "lint_reject_vocab"]

#: server-only wire ops with no ReplicaHandle counterpart (session
#: setup, drain control, process teardown)
_SERVER_ONLY_OPS = frozenset({"hello", "set_draining", "shutdown"})

#: handle methods that deliberately have no wire op: ``close()`` is the
#: client-side transport teardown (the server side is the ``shutdown``
#: op), and ``start``/``stop``/``running`` are LocalReplica's thread
#: controls, not part of the protocol
_NO_WIRE_OP = frozenset({"close"})


def _handle_methods(base: type) -> Dict[str, inspect.Signature]:
    out = {}
    for name, fn in vars(base).items():
        if name.startswith("_") or not callable(fn):
            continue
        out[name] = inspect.signature(fn)
    return out


def _sig_shape(sig: inspect.Signature) -> List[Tuple[str, str, bool]]:
    """Comparable shape: (name, kind, has_default) per parameter —
    annotations and default *values* may legitimately differ between
    the protocol and a transport."""
    return [(p.name, p.kind.name, p.default is not inspect.Parameter.empty)
            for p in sig.parameters.values()]


def _dispatch_ops(server_source: str, filename: str
                  ) -> Tuple[Set[str], Set[str]]:
    """``(ops, hello_keys)``: the op strings ``ReplicaServer._dispatch``
    compares against (``if op == "submit": ...``) plus the literal keys
    of the hello-handshake reply dict (immutable per-replica config like
    ``page_size`` rides the handshake instead of its own op). Read
    statically so the lint needs no socket, no engine, and no spawned
    process."""
    ops: Set[str] = set()
    hello_keys: Set[str] = set()
    tree = ast.parse(server_source, filename=filename)
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        for meth in cls.body:
            if not isinstance(meth, ast.FunctionDef) \
                    or meth.name != "_dispatch":
                continue
            for node in ast.walk(meth):
                if not isinstance(node, ast.If) \
                        or not isinstance(node.test, ast.Compare) \
                        or len(node.test.comparators) != 1:
                    continue
                left = node.test.left
                right = node.test.comparators[0]
                op = None
                for a, b in ((left, right), (right, left)):
                    if (isinstance(a, ast.Name) and a.id == "op"
                            and isinstance(b, ast.Constant)
                            and isinstance(b.value, str)):
                        op = b.value
                if op is None:
                    continue
                ops.add(op)
                if op == "hello":
                    for sub in ast.walk(node):
                        if isinstance(sub, ast.Dict):
                            hello_keys.update(
                                k.value for k in sub.keys
                                if isinstance(k, ast.Constant)
                                and isinstance(k.value, str))
    return ops, hello_keys


def lint_interfaces() -> List[Finding]:
    """ReplicaHandle conformance: implementations + wire dispatch."""
    from paddle_tpu_torch.serving.fleet import faults, replica
    from paddle_tpu_torch.serving.fleet.net import replica_server
    from paddle_tpu_torch.serving.fleet.net import replica as net_replica

    base = replica.ReplicaHandle
    impls = (replica.LocalReplica, net_replica.NetReplica,
             faults.ChaosReplica)
    methods = _handle_methods(base)
    out: List[Finding] = []
    for impl in impls:
        for name, base_sig in sorted(methods.items()):
            fn = getattr(impl, name, None)
            if fn is None:
                out.append(Finding(
                    "interface-drift", "error",
                    f"{impl.__name__} is missing ReplicaHandle method "
                    f"{name}()",
                    location=inspect.getsourcefile(impl) or "",
                    fix=f"implement {name}{base_sig} (or inherit it)",
                    engine="concurrency"))
                continue
            # inherited-from-base default implementations conform by
            # construction; only compare overrides
            if getattr(impl, name) is getattr(base, name, None):
                continue
            impl_sig = inspect.signature(fn)
            if _sig_shape(impl_sig) != _sig_shape(base_sig):
                out.append(Finding(
                    "interface-drift", "error",
                    f"{impl.__name__}.{name}{impl_sig} drifted from "
                    f"ReplicaHandle.{name}{base_sig}",
                    location=inspect.getsourcefile(impl) or "",
                    fix="match the protocol's parameter names/kinds "
                        "(annotations and default values are free)",
                    engine="concurrency"))
    server_file = inspect.getsourcefile(replica_server)
    with open(server_file) as f:
        ops, hello_keys = _dispatch_ops(f.read(), server_file)
    base_name = os.path.basename(server_file)
    for name in sorted(set(methods) - _NO_WIRE_OP):
        if name not in ops and name not in hello_keys:
            out.append(Finding(
                "interface-drift", "error",
                f"ReplicaHandle.{name}() has no op in the wire "
                f"dispatch table ({base_name} _dispatch): a NetReplica "
                "call would die as a runtime RemoteError",
                location=base_name,
                fix=f'add `if op == "{name}":` to '
                    f"ReplicaServer._dispatch (and NetReplica)",
                engine="concurrency"))
    for op in sorted(ops - set(methods) - _SERVER_ONLY_OPS):
        out.append(Finding(
            "interface-drift", "error",
            f"wire dispatch op {op!r} maps to no ReplicaHandle method "
            "and is not a declared server-only op",
            location=base_name,
            fix="remove the dead op or add the handle method",
            engine="concurrency"))
    return out


#: call shapes whose literal reason argument feeds a Reject: the
#: constructor itself (positional 0 / reason=), and the router's
#: `_shed_redrive(frid, rec, reason, src)` funnel
_REASON_ARG = {"Reject": 0, "_shed_redrive": 2}


def _literal_reasons(source: str) -> List[Tuple[str, int]]:
    """(reason, lineno) for every literal reason fed to a Reject
    construction (directly or via the router's shed funnel)."""
    out: List[Tuple[str, int]] = []
    tree = ast.parse(source)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else None)
        if name not in _REASON_ARG:
            continue
        pos = _REASON_ARG[name]
        arg: Optional[ast.expr] = None
        if len(node.args) > pos:
            arg = node.args[pos]
        for kw in node.keywords:
            if kw.arg == "reason":
                arg = kw.value
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            out.append((arg.value, node.lineno))
    return out


def lint_reject_vocab(root: Optional[str] = None) -> List[Finding]:
    """Every literal ``Reject`` reason in the serving plane must be in
    ``scheduler.REJECT_REASONS``, and every registered reason must be
    constructed somewhere (no dead vocabulary)."""
    from paddle_tpu_torch.serving.scheduler import REJECT_REASONS

    if root is None:
        root = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "serving")
    out: List[Finding] = []
    seen: Dict[str, str] = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path) as f:
                source = f.read()
            for reason, lineno in _literal_reasons(source):
                seen.setdefault(reason, f"{fn}:{lineno}")
                if reason not in REJECT_REASONS:
                    out.append(Finding(
                        "reject-vocab-drift", "error",
                        f"Reject reason {reason!r} is not registered "
                        "in scheduler.REJECT_REASONS",
                        location=f"{fn}:{lineno}",
                        fix="add it to REJECT_REASONS (one source of "
                            "truth: wire round-trip validation and the "
                            "parametrized wire tests read it)",
                        engine="concurrency"))
    for reason in sorted(set(REJECT_REASONS) - set(seen)):
        out.append(Finding(
            "reject-vocab-drift", "error",
            f"registered Reject reason {reason!r} is constructed "
            "nowhere in the serving plane (dead vocabulary)",
            location="scheduler.py",
            fix="remove it from REJECT_REASONS or wire up the "
                "construction site",
            engine="concurrency"))
    return out
