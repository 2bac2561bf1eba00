"""Concurrency analysis: lock-discipline lint, lock-order graph, and a
test-time lock sanitizer for the threaded serving plane
(``paddle_tpu/analysis/concurrency.py``, in full).

It proves properties of the host threads around the captured steps: the
replicas' step loops, the router, the snapshot writer, the front door's
selector loop. Three instruments, one reporting spine:

- **Lock-discipline lint** (:func:`lint_locks`): classes declare which
  lock guards which fields via the :func:`guarded_by` decorator; an AST
  dataflow pass flags any read/write of a guarded attribute outside a
  ``with self._lock:`` scope, with one level of intra-class call
  propagation (a private helper's unguarded access is accepted only
  when every intra-class call site holds the right lock).
- **Lock-order graph** (:func:`extract_lock_graph`): every
  ``threading.Lock/RLock/Condition`` attribute in the package plus the
  nested ``with``-acquisition edges between them, including one level
  of call propagation (intra-class, and cross-class through attributes
  whose type is statically resolvable). Cycles are potential deadlocks;
  double-acquire of a non-reentrant lock is a guaranteed one. The
  blessed acyclic order is committed as the port's own
  ``paddle_tpu_torch/analysis/lock_order.json`` (:data:`LOCK_ORDER_PATH`)
  and drift-gated.
- **Runtime lock sanitizer** (:func:`sanitize`): a context manager that
  instruments locks *created inside it*, records actual acquisition
  orders and hold-while-blocking events during threaded tests, refuses
  (raises) instead of deadlocking on a same-thread double-acquire, and
  cross-checks ``observed ⊆ committed graph`` so the static model is
  proven against real executions. Counts surface as ``concurrency_*``
  metrics in the observability registry.

Run it with ``python -m paddle_tpu_torch.analysis.concurrency`` (the
lint against the committed manifest; exit 1 on an error) or
``... --update-lock-order`` (rewrite the manifest after reviewing a new
lock or nested acquisition).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import sys
import threading
from typing import (Any, Callable, Dict, List, Mapping, Optional,
                    Sequence, Set, Tuple)

from paddle_tpu_torch.analysis.findings import Finding, Report, Suppressions

__all__ = [
    "DoubleAcquireError", "LOCK_ORDER_PATH", "LockGraph", "LockMonitor",
    "extract_lock_graph", "guarded_by", "lint_concurrency", "lint_locks",
    "load_lock_order", "lock_order_diff", "lock_order_manifest",
    "package_sources", "sanitize",
]

#: the port's committed lock-order manifest
LOCK_ORDER_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "lock_order.json")

# real constructors, captured before any sanitize() patching
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition

#: lock-like threading constructors -> graph kind (reentrancy class)
_LOCK_KINDS = {"Lock": "lock", "RLock": "rlock", "Condition": "condition"}

#: methods a lint pass never flags: no other thread can observe the
#: object while its constructor/finalizer runs
_EXEMPT_METHODS = ("__init__", "__post_init__", "__del__")


# ---------------------------------------------------------------------------
# the annotation convention


def guarded_by(lock: str, *fields: str) -> Callable[[type], type]:
    """Class decorator declaring that ``lock`` (an attribute name, e.g.
    ``"_lock"``) guards ``fields`` (attribute names). Stackable for
    classes with more than one lock::

        @guarded_by("_cv", "_pending", "_error")
        @guarded_by("_vlock", "_versions", "_dirty")
        class StreamingUpdateChannel: ...

    At runtime this only records ``cls.__guarded_by__`` (a merged
    ``{field: lock}`` dict, inherited copies included) — the contract is
    enforced statically by :func:`lint_locks` and dynamically (order
    only) by :func:`sanitize`.
    """
    def deco(cls: type) -> type:
        merged = dict(getattr(cls, "__guarded_by__", {}))
        for f in fields:
            merged[f] = lock
        cls.__guarded_by__ = merged
        return cls
    return deco


# ---------------------------------------------------------------------------
# shared AST helpers


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.X`` -> ``"X"``, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _threading_ctor(node: ast.AST) -> Optional[str]:
    """``threading.Lock()`` / ``Lock()`` -> graph kind, else None."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    name = None
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
            and fn.value.id == "threading":
        name = fn.attr
    elif isinstance(fn, ast.Name):
        name = fn.id
    return _LOCK_KINDS.get(name or "")


def _decorator_guards(cls: ast.ClassDef) -> Dict[str, str]:
    """Merged ``{field: lock}`` from stacked ``@guarded_by`` decorators
    (literal string arguments only — anything computed is ignored, the
    same way the runtime decorator would be unanalyzable)."""
    guards: Dict[str, str] = {}
    for dec in cls.decorator_list:
        if not isinstance(dec, ast.Call):
            continue
        fn = dec.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else None)
        if name != "guarded_by" or not dec.args:
            continue
        vals = [a.value for a in dec.args
                if isinstance(a, ast.Constant) and isinstance(a.value, str)]
        if len(vals) == len(dec.args) and len(vals) >= 2:
            for field in vals[1:]:
                guards[field] = vals[0]
    return guards


def _with_locks(node: ast.With, own_locks: Set[str],
                module_locks: Set[str]) -> List[str]:
    """Lock names acquired by one ``with`` statement: ``with
    self._lock:`` (own attribute) or ``with _LOCK:`` (module-level)."""
    out = []
    for item in node.items:
        attr = _self_attr(item.context_expr)
        if attr is not None and attr in own_locks:
            out.append(attr)
        elif (isinstance(item.context_expr, ast.Name)
                and item.context_expr.id in module_locks):
            out.append(item.context_expr.id)
    return out


# ---------------------------------------------------------------------------
# (a) lock-discipline lint


@dataclasses.dataclass
class _Access:
    field: str
    lock: str
    lineno: int
    write: bool


@dataclasses.dataclass
class _CallSite:
    caller: str
    held: frozenset
    lineno: int


class _MethodScan:
    """One method's unguarded accesses + intra-class call sites, from a
    single held-lock-aware walk."""

    def __init__(self, guards: Dict[str, str], own_locks: Set[str]):
        self.guards = guards
        self.own_locks = own_locks
        self.accesses: List[_Access] = []
        self.calls: List[Tuple[str, frozenset, int]] = []  # (name, held, ln)

    def walk(self, body: Sequence[ast.stmt], held: frozenset):
        for stmt in body:
            self._stmt(stmt, held)

    def _stmt(self, node: ast.AST, held: frozenset):
        if isinstance(node, ast.With):
            for item in node.items:
                self._expr(item.context_expr, held)
            acquired = _with_locks(node, self.own_locks, set())
            self.walk(node.body, held | frozenset(acquired))
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def runs later, possibly from another thread with
            # no lock held — walk it with an empty held set
            self.walk(node.body, frozenset())
            return
        # ExceptHandler / match_case are AST nodes but not ast.stmt;
        # their bodies hold statements and must stay on the held-aware
        # path (an _expr blind walk would drop `with` scopes)
        stmt_like = (ast.stmt, ast.ExceptHandler, ast.match_case)
        for field, expr in ast.iter_fields(node):
            if isinstance(expr, ast.AST):
                (self._stmt if isinstance(expr, stmt_like)
                 else self._expr)(expr, held)
            elif isinstance(expr, list):
                for item in expr:
                    if isinstance(item, stmt_like):
                        self._stmt(item, held)
                    elif isinstance(item, ast.AST):
                        self._expr(item, held)

    def _expr(self, node: ast.AST, held: frozenset):
        for sub in ast.walk(node):
            attr = _self_attr(sub)
            if attr is not None and attr in self.guards:
                lock = self.guards[attr]
                if lock not in held:
                    self.accesses.append(_Access(
                        attr, lock, sub.lineno,
                        isinstance(sub.ctx, (ast.Store, ast.Del))))
            if isinstance(sub, ast.Call):
                callee = _self_attr(sub.func)
                if callee is not None:
                    self.calls.append((callee, held, sub.lineno))


def lint_locks(source: str, *, filename: str = "<string>"
               ) -> List[Finding]:
    """The lock-discipline pass over one module's source: flag every
    read/write of a ``@guarded_by`` field outside a ``with self.<lock>:``
    scope. One level of intra-class call propagation: a private helper's
    unguarded access is accepted iff the helper has at least one
    intra-class call site and *every* such call site holds the required
    lock (public methods are always flagged — external callers cannot be
    assumed to hold an internal lock)."""
    try:
        tree = ast.parse(source, filename=filename)
    except SyntaxError as e:
        return [Finding("unguarded-access", "error",
                        f"could not parse {filename}: {e}",
                        location=filename, engine="concurrency")]
    findings: List[Finding] = []
    base = os.path.basename(filename)
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        guards = _decorator_guards(cls)
        if not guards:
            continue
        own_locks = set(guards.values())
        scans: Dict[str, _MethodScan] = {}
        for meth in cls.body:
            if not isinstance(meth, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if meth.name in _EXEMPT_METHODS:
                continue
            scan = _MethodScan(guards, own_locks)
            scan.walk(meth.body, frozenset())
            scans[meth.name] = scan
        # call-site index: helper name -> held sets at intra-class sites
        sites: Dict[str, List[_CallSite]] = {}
        for caller, scan in scans.items():
            for callee, held, ln in scan.calls:
                sites.setdefault(callee, []).append(
                    _CallSite(caller, held, ln))
        for name, scan in scans.items():
            private = name.startswith("_")
            for acc in scan.accesses:
                callers = sites.get(name, [])
                if private and callers and all(
                        acc.lock in s.held for s in callers):
                    continue        # every caller holds the lock
                verb = "writes" if acc.write else "reads"
                via = ""
                if private and callers:
                    bad = [s for s in callers if acc.lock not in s.held]
                    via = (f" (reached from unlocked call site "
                           f"{cls.name}.{bad[0].caller})" if bad else "")
                findings.append(Finding(
                    "unguarded-access", "error",
                    f"{cls.name}.{name} {verb} self.{acc.field} without "
                    f"holding self.{acc.lock}{via}",
                    location=f"{base}:{acc.lineno}",
                    fix=f"wrap the access in `with self.{acc.lock}:` or "
                        f"move it under an already-locked caller",
                    engine="concurrency"))
    return findings


# ---------------------------------------------------------------------------
# (b) lock-order graph


@dataclasses.dataclass
class LockGraph:
    """The package's static lock universe and acquisition-order edges.

    ``locks`` maps a qualified lock id (``"LocalReplica._lock"`` or
    ``"native._LOCK"`` for module-level) to its reentrancy kind;
    ``edges`` maps ``(held, acquired)`` pairs to one representative
    source location; ``double_acquires`` lists non-reentrant locks
    re-acquired while already held on the same path.
    """

    locks: Dict[str, str] = dataclasses.field(default_factory=dict)
    edges: Dict[Tuple[str, str], str] = dataclasses.field(
        default_factory=dict)
    double_acquires: List[Tuple[str, str]] = dataclasses.field(
        default_factory=list)

    def add_edge(self, src: str, dst: str, location: str):
        if src != dst:
            self.edges.setdefault((src, dst), location)

    def cycles(self) -> List[List[str]]:
        """Simple cycles in the edge digraph (DFS, deduplicated by the
        cycle's node set — enough to name each deadlock once)."""
        adj: Dict[str, List[str]] = {}
        for (src, dst) in self.edges:
            adj.setdefault(src, []).append(dst)
        seen_sets: List[frozenset] = []
        cycles: List[List[str]] = []

        def dfs(node: str, path: List[str], on_path: Set[str]):
            for nxt in adj.get(node, ()):
                if nxt in on_path:
                    cyc = path[path.index(nxt):] + [nxt]
                    key = frozenset(cyc)
                    if key not in seen_sets:
                        seen_sets.append(key)
                        cycles.append(cyc)
                    continue
                dfs(nxt, path + [nxt], on_path | {nxt})

        for start in sorted(adj):
            dfs(start, [start], {start})
        return cycles

    def acyclic(self) -> bool:
        return not self.cycles()

    def findings(self) -> List[Finding]:
        """Cycle + double-acquire findings over the extracted graph."""
        out = []
        for cyc in self.cycles():
            loc = self.edges.get((cyc[0], cyc[1]), "")
            out.append(Finding(
                "lock-order-cycle", "error",
                "potential deadlock: lock acquisition cycle "
                + " -> ".join(cyc),
                location=loc,
                fix="pick one global order for these locks and release "
                    "before acquiring against it",
                engine="concurrency"))
        for lock, loc in self.double_acquires:
            out.append(Finding(
                "double-acquire", "error",
                f"non-reentrant {lock} acquired while already held on "
                "the same path: guaranteed self-deadlock",
                location=loc,
                fix=f"make {lock} an RLock only if re-entry is by "
                    "design; otherwise split the inner acquisition out",
                engine="concurrency"))
        return out


class _ClassInfo:
    def __init__(self, name: str, filename: str):
        self.name = name
        self.filename = filename
        self.locks: Dict[str, str] = {}           # attr -> kind
        self.attr_types: Dict[str, str] = {}      # attr -> class name
        self.acquires: Dict[str, Set[str]] = {}   # method -> own lock attrs
        self.self_calls: Dict[str, Set[str]] = {}  # method -> callee names
        #: (method, held lock-ids, target attr|"self", callee, lineno)
        self.locked_calls: List[Tuple[str, frozenset, str, str, int]] = []

    def qual(self, attr: str) -> str:
        return f"{self.name}.{attr}"


def _scan_class(cls: ast.ClassDef, filename: str,
                module_locks: Dict[str, str],
                graph: LockGraph) -> _ClassInfo:
    info = _ClassInfo(cls.name, filename)
    base = os.path.basename(filename)
    # pass 1: lock attributes + attribute types (from direct
    # constructions and from annotated __init__ params)
    param_types: Dict[str, str] = {}
    for meth in cls.body:
        if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if meth.name == "__init__":
            for arg in meth.args.args + meth.args.kwonlyargs:
                ann = arg.annotation
                if isinstance(ann, ast.Name):
                    param_types[arg.arg] = ann.id
                elif isinstance(ann, ast.Constant) and \
                        isinstance(ann.value, str):
                    param_types[arg.arg] = ann.value
        for node in ast.walk(meth):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            attr = _self_attr(node.targets[0])
            if attr is None:
                continue
            kind = _threading_ctor(node.value)
            if kind is not None:
                info.locks[attr] = kind
                continue
            if isinstance(node.value, ast.Call) and \
                    isinstance(node.value.func, ast.Name):
                info.attr_types.setdefault(attr, node.value.func.id)
            elif isinstance(node.value, ast.Name) and \
                    node.value.id in param_types:
                info.attr_types.setdefault(
                    attr, param_types[node.value.id])
    # pass 2: per-method held-stack walk for direct edges + call sites
    own = set(info.locks)
    mod = set(module_locks)

    def walk(method: str, body: Sequence[ast.AST], held: Tuple[str, ...]):
        for node in body:
            if isinstance(node, ast.With):
                acquired = []
                for lock in _with_locks(node, own, mod):
                    lid = (info.qual(lock) if lock in own
                           else f"{_modbase(filename)}.{lock}")
                    kind = info.locks.get(lock, module_locks.get(lock))
                    if lid in held and kind == "lock":
                        graph.double_acquires.append(
                            (lid, f"{base}:{node.lineno}"))
                    for h in held:
                        graph.add_edge(h, lid, f"{base}:{node.lineno}")
                    info.acquires.setdefault(method, set()).update(
                        {lock} if lock in own else set())
                    acquired.append(lid)
                walk(method, node.body, held + tuple(acquired))
                continue
            if isinstance(node, ast.Call):
                callee = _self_attr(node.func)
                if callee is not None:
                    info.self_calls.setdefault(method, set()).add(callee)
                    if held:
                        info.locked_calls.append(
                            (method, frozenset(held), "self", callee,
                             node.lineno))
                elif (isinstance(node.func, ast.Attribute)
                        and held
                        and _self_attr(node.func.value) is not None):
                    info.locked_calls.append(
                        (method, frozenset(held),
                         _self_attr(node.func.value), node.func.attr,
                         node.lineno))
            for field, expr in ast.iter_fields(node):
                if isinstance(expr, ast.AST):
                    walk(method, [expr], held)
                elif isinstance(expr, list):
                    walk(method, [e for e in expr
                                  if isinstance(e, ast.AST)], held)

    for meth in cls.body:
        if isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info.acquires.setdefault(meth.name, set())
            info.self_calls.setdefault(meth.name, set())
            walk(meth.name, meth.body, ())
    return info


def _modbase(filename: str) -> str:
    name = os.path.basename(filename)
    if name == "__init__.py":
        name = os.path.basename(os.path.dirname(filename)) or name
    return name[:-3] if name.endswith(".py") else name


def _scan_module_functions(tree: ast.Module, filename: str,
                           module_locks: Dict[str, str],
                           graph: LockGraph):
    """Edges from module-level functions' nested ``with`` acquisitions
    of module-level locks."""
    base = os.path.basename(filename)
    mod = set(module_locks)

    def walk(body, held):
        for node in body:
            if isinstance(node, ast.With):
                acquired = []
                for lock in _with_locks(node, set(), mod):
                    lid = f"{_modbase(filename)}.{lock}"
                    if lid in held and module_locks[lock] == "lock":
                        graph.double_acquires.append(
                            (lid, f"{base}:{node.lineno}"))
                    for h in held:
                        graph.add_edge(h, lid, f"{base}:{node.lineno}")
                    acquired.append(lid)
                walk(node.body, held + tuple(acquired))
                continue
            for field, expr in ast.iter_fields(node):
                if isinstance(expr, ast.AST):
                    walk([expr], held)
                elif isinstance(expr, list):
                    walk([e for e in expr if isinstance(e, ast.AST)],
                         held)

    for fn in tree.body:
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            walk(fn.body, ())


def _transitive_acquires(info: _ClassInfo) -> Dict[str, Set[str]]:
    """Per-method fixpoint of own-lock acquisitions through intra-class
    calls (``step -> _refresh_health -> _health_lock``)."""
    closure = {m: set(s) for m, s in info.acquires.items()}
    changed = True
    while changed:
        changed = False
        for m, callees in info.self_calls.items():
            for c in callees:
                extra = closure.get(c, set()) - closure.setdefault(m, set())
                if extra:
                    closure[m] |= extra
                    changed = True
    return closure


def extract_lock_graph(sources: Mapping[str, str]) -> LockGraph:
    """Extract the package-wide :class:`LockGraph` from ``{filename:
    source}``. Direct nested ``with`` edges, plus one level of call
    propagation: inside a locked region, a call to ``self.m()`` adds
    edges to every lock ``m`` (transitively, intra-class) acquires, and
    a call to ``self.attr.m()`` does the same when ``attr``'s class is
    statically resolvable (a direct construction in ``__init__`` or an
    annotated constructor parameter)."""
    graph = LockGraph()
    classes: Dict[str, _ClassInfo] = {}
    trees: Dict[str, ast.Module] = {}
    for filename, source in sources.items():
        try:
            trees[filename] = ast.parse(source, filename=filename)
        except SyntaxError:
            continue
    for filename, tree in trees.items():
        module_locks: Dict[str, str] = {}
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                kind = _threading_ctor(node.value)
                if kind is not None:
                    module_locks[node.targets[0].id] = kind
        for name, kind in module_locks.items():
            graph.locks[f"{_modbase(filename)}.{name}"] = kind
        for cls in [n for n in ast.walk(tree)
                    if isinstance(n, ast.ClassDef)]:
            info = _scan_class(cls, filename, module_locks, graph)
            if info.locks or info.locked_calls:
                classes.setdefault(info.name, info)
            for attr, kind in info.locks.items():
                graph.locks[info.qual(attr)] = kind
        _scan_module_functions(tree, filename, module_locks, graph)
    closures = {name: _transitive_acquires(info)
                for name, info in classes.items()}
    for info in classes.values():
        base = os.path.basename(info.filename)
        for method, held, target, callee, lineno in info.locked_calls:
            if target == "self":
                tgt = info
            else:
                tname = info.attr_types.get(target)
                tgt = classes.get(tname) if tname else None
            if tgt is None:
                continue
            for lock in closures[tgt.name].get(callee, ()):
                lid = tgt.qual(lock)
                loc = f"{base}:{lineno}"
                if lid in held and tgt.locks.get(lock) == "lock":
                    graph.double_acquires.append((lid, loc))
                for h in held:
                    graph.add_edge(h, lid, loc)
    return graph


def package_sources(root: Optional[str] = None) -> Dict[str, str]:
    """``{filename: source}`` for every ``.py`` under the package root
    (defaults to the ``paddle_tpu_torch`` package directory)."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out: Dict[str, str] = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                with open(path) as f:
                    out[path] = f.read()
    return out


# ---------------------------------------------------------------------------
# lock_order.json: the committed blessed order + drift gating


def lock_order_manifest(graph: LockGraph) -> dict:
    """The committed-manifest shape of :data:`LOCK_ORDER_PATH`."""
    return {
        "_comment": [
            "Blessed static lock-acquisition order of paddle_tpu_torch "
            "(python -m paddle_tpu_torch.analysis.concurrency).",
            "Regenerate with: python -m paddle_tpu_torch.analysis."
            "concurrency --update-lock-order",
            "and commit alongside any PR that legitimately adds or "
            "removes a lock or a nested acquisition.",
            "'edges' are [held, acquired, location] triples; the graph "
            "must stay acyclic.",
        ],
        "locks": dict(sorted(graph.locks.items())),
        "edges": [[src, dst, loc] for (src, dst), loc
                  in sorted(graph.edges.items())],
    }


def load_lock_order(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def lock_order_diff(graph: LockGraph, manifest: Optional[dict],
                    *, path: str = LOCK_ORDER_PATH) -> List[Finding]:
    """Drift gate: the extracted lock universe and edge set must exactly
    match the committed manifest. A new lock or edge missing from it
    fails (review the order, then regenerate), and an orphaned or stale
    entry fails (dead entries would silently re-bless a future
    regression)."""
    fix = (f"run `python -m paddle_tpu_torch.analysis.concurrency "
           f"--update-lock-order`, review the order, and commit {path}")
    if manifest is None:
        return [Finding("lock-order-drift", "error",
                        f"no committed lock-order manifest at {path}",
                        fix=fix, engine="concurrency")]
    committed_locks = dict(manifest.get("locks", {}))
    committed_edges = {(e[0], e[1]): (e[2] if len(e) > 2 else "")
                       for e in manifest.get("edges", [])}
    out: List[Finding] = []
    for lid, kind in sorted(graph.locks.items()):
        if lid not in committed_locks:
            out.append(Finding(
                "lock-order-drift", "error",
                f"lock {lid} ({kind}) is not in the committed manifest",
                location=path, fix=fix, engine="concurrency"))
        elif committed_locks[lid] != kind:
            out.append(Finding(
                "lock-order-drift", "error",
                f"lock {lid} changed kind: committed "
                f"{committed_locks[lid]}, extracted {kind}",
                location=path, fix=fix, engine="concurrency"))
    for lid in sorted(set(committed_locks) - set(graph.locks)):
        out.append(Finding(
            "lock-order-drift", "error",
            f"stale manifest lock {lid}: no such lock is extracted "
            "from the package anymore",
            location=path, fix=fix, engine="concurrency"))
    for (src, dst), loc in sorted(graph.edges.items()):
        if (src, dst) not in committed_edges:
            out.append(Finding(
                "lock-order-drift", "error",
                f"new acquisition edge {src} -> {dst} is not in the "
                "committed manifest",
                location=loc, fix=fix, engine="concurrency"))
    for (src, dst) in sorted(set(committed_edges) - set(graph.edges)):
        out.append(Finding(
            "lock-order-drift", "error",
            f"orphaned manifest edge {src} -> {dst}: not extracted "
            "from the package anymore",
            location=path, fix=fix, engine="concurrency"))
    return out


def lint_concurrency(root: Optional[str] = None, *,
                     lock_order: Optional[str] = None,
                     suppressions: Optional[Suppressions] = None,
                     registry: bool = True) -> Report:
    """The full static concurrency tier over the package: the
    lock-discipline pass on every module, cycle/double-acquire findings
    on the extracted lock-order graph, and (when ``lock_order`` names a
    manifest path, such as :data:`LOCK_ORDER_PATH`) the drift gate."""
    sources = package_sources(root)
    report = Report("concurrency", suppressions=suppressions)
    for filename in sorted(sources):
        report.extend(lint_locks(sources[filename], filename=filename))
    graph = extract_lock_graph(sources)
    report.extend(graph.findings())
    if lock_order is not None:
        report.extend(lock_order_diff(graph, load_lock_order(lock_order),
                                      path=lock_order))
    report.graph = graph
    if registry:
        report.count_into_registry()
    return report


# ---------------------------------------------------------------------------
# (c) runtime lock sanitizer


class DoubleAcquireError(RuntimeError):
    """A thread re-acquired a non-reentrant lock it already holds. The
    sanitizer raises (with the lock's name) instead of letting the test
    deadlock silently."""


class _SanitizedLock:
    """Instrumented stand-in for ``threading.Lock``/``RLock``. Delegates
    to a real lock; records acquisition-order edges, hold-while-blocking
    events, and same-thread double-acquires with the monitor."""

    def __init__(self, monitor: "LockMonitor", kind: str):
        self._inner = (_REAL_RLOCK if kind == "rlock" else _REAL_LOCK)()
        self._monitor = monitor
        self._kind = kind
        self.name: Optional[str] = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        mon = self._monitor
        mon._resolve_name(self)
        stack = mon._stack()
        if any(lk is self for lk in stack):
            if self._kind == "lock":
                mon._record_double(self)
                raise DoubleAcquireError(
                    f"double-acquire of non-reentrant lock "
                    f"{self.name or '<anonymous>'} on thread "
                    f"{threading.current_thread().name}")
            got = self._inner.acquire(blocking, timeout)
            if got:
                stack.append(self)      # reentrant: no new edge
            return got
        got = self._inner.acquire(False)
        if not got:
            if stack:
                mon._record_blocked(stack[-1], self)
            if not blocking:
                return False
            got = (self._inner.acquire(True) if timeout < 0
                   else self._inner.acquire(True, timeout))
            if not got:
                return False
        mon._record_acquire(stack, self)
        stack.append(self)
        return True

    def release(self):
        stack = self._monitor._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class _SanitizedCondition:
    """Instrumented ``threading.Condition``: the enter/exit (acquire/
    release) side is recorded like a lock; ``wait*``/``notify*``
    delegate to a real condition (which manages its own lock state —
    the brief release inside ``wait`` is invisible to the monitor, a
    documented approximation: a blocked waiter acquires nothing)."""

    def __init__(self, monitor: "LockMonitor",
                 lock: Optional[object] = None):
        inner = lock._inner if isinstance(lock, _SanitizedLock) else lock
        self._cond = _REAL_CONDITION(inner)
        self._monitor = monitor
        self._kind = "condition"
        self.name: Optional[str] = None

    def acquire(self, *a, **kw) -> bool:
        mon = self._monitor
        mon._resolve_name(self)
        stack = mon._stack()
        reentry = any(lk is self for lk in stack)
        got = self._cond.acquire(*a, **kw)
        if got:
            if not reentry:
                mon._record_acquire(stack, self)
            stack.append(self)
        return got

    def release(self):
        stack = self._monitor._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        self._cond.release()

    def wait(self, timeout: Optional[float] = None):
        return self._cond.wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        return self._cond.wait_for(predicate, timeout)

    def notify(self, n: int = 1):
        self._cond.notify(n)

    def notify_all(self):
        self._cond.notify_all()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class LockMonitor:
    """What :func:`sanitize` observed: acquisition-order edges between
    named paddle_tpu_torch locks, hold-while-blocking events,
    double-acquire attempts, and raw acquisition counts."""

    def __init__(self):
        self._mu = _REAL_LOCK()
        self._tls = threading.local()
        self.edges: Dict[Tuple[str, str], int] = {}
        self.blocked: List[Tuple[str, str]] = []   # (held, wanted)
        self.double_acquires: List[str] = []
        self.acquisitions = 0
        self.locks_created = 0

    # -- bookkeeping (called from instrumented locks) ----------------------
    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _record_acquire(self, stack: list, lock):
        with self._mu:
            self.acquisitions += 1
            if lock.name is None:
                return
            for held in stack:
                if held.name is not None and held.name != lock.name:
                    key = (held.name, lock.name)
                    self.edges[key] = self.edges.get(key, 0) + 1

    def _record_blocked(self, held, lock):
        self._resolve_name(lock)
        with self._mu:
            if held.name is not None and lock.name is not None:
                self.blocked.append((held.name, lock.name))

    def _record_double(self, lock):
        with self._mu:
            self.double_acquires.append(lock.name or "<anonymous>")

    def _resolve_name(self, lock):
        """Lazily name a lock at acquisition time by finding the
        paddle_tpu_torch object (or module) that holds it as an
        attribute: the acquiring frame's ``self`` almost always does."""
        if lock.name is not None:
            return
        f = sys._getframe(2)
        depth = 0
        while f is not None and depth < 10:
            if f.f_globals.get("__name__") != __name__:
                slf = f.f_locals.get("self")
                if slf is not None and getattr(
                        type(slf), "__module__", "").startswith(
                        "paddle_tpu_torch"):
                    try:
                        attrs = vars(slf).items()
                    except TypeError:
                        attrs = ()
                    for k, v in attrs:
                        if v is lock:
                            lock.name = f"{type(slf).__qualname__}.{k}"
                            return
                g = f.f_globals
                if g.get("__name__", "").startswith("paddle_tpu_torch"):
                    for k, v in g.items():
                        if v is lock:
                            mod = g["__name__"].rsplit(".", 1)[-1]
                            lock.name = f"{mod}.{k}"
                            return
            f = f.f_back
            depth += 1

    # -- results -----------------------------------------------------------
    def observed_edges(self) -> Set[Tuple[str, str]]:
        with self._mu:
            return set(self.edges)

    def check(self, manifest) -> List[Finding]:
        """``observed ⊆ committed``, scoped to the locks the committed
        graph actually orders (the nodes of its edge set): an observed
        edge between two ordered locks that the static graph does not
        bless is a sanitizer violation — either a real inversion or a
        path the extractor cannot see, and both must be triaged into
        the committed manifest. Leaf locks (never held across other
        acquisitions in the committed model) are out of scope. Accepts
        a loaded manifest dict or a :class:`LockGraph`."""
        if isinstance(manifest, LockGraph):
            committed = set(manifest.edges)
        else:
            committed = {(e[0], e[1])
                         for e in (manifest or {}).get("edges", [])}
        modeled = {n for e in committed for n in e}
        out = []
        for (src, dst) in sorted(self.observed_edges()):
            if src in modeled and dst in modeled \
                    and (src, dst) not in committed:
                out.append(Finding(
                    "sanitizer-violation", "error",
                    f"observed runtime acquisition {src} -> {dst} is "
                    "not in the committed static lock-order graph",
                    fix="triage: a genuine order inversion must be "
                        "fixed; a statically invisible path must be "
                        "added to paddle_tpu_torch/analysis/"
                        "lock_order.json",
                    engine="concurrency"))
        for name in self.double_acquires:
            out.append(Finding(
                "double-acquire", "error",
                f"runtime double-acquire of non-reentrant {name}",
                engine="concurrency"))
        return out

    def export_metrics(self, reg=None):
        """``concurrency_*`` counters into the observability registry."""
        from paddle_tpu_torch import observability
        reg = reg or observability.default()
        # snapshot under _mu, write counters OUTSIDE it: a registry
        # built inside the sanitize() context guards itself with a
        # _SanitizedLock whose acquire calls back into _record_acquire,
        # and _mu is not reentrant — holding it across reg.counter()
        # self-deadlocks the exporting thread
        with self._mu:
            acquisitions = self.acquisitions
            n_blocked = len(self.blocked)
            n_double = len(self.double_acquires)
            edges = sorted(self.edges.items())
        reg.counter(
            "concurrency_lock_acquisitions_total",
            "lock acquisitions recorded by the sanitizer").inc(
                acquisitions)
        reg.counter(
            "concurrency_hold_while_blocking_total",
            "blocking lock waits entered while holding another "
            "lock").inc(n_blocked)
        reg.counter(
            "concurrency_double_acquire_total",
            "same-thread double-acquires of non-reentrant locks "
            "refused by the sanitizer").inc(n_double)
        for (src, dst), n in edges:
            reg.counter(
                "concurrency_lock_order_edges_total",
                "observed lock acquisition-order edges").inc(
                    n, src=src, dst=dst)
        return self


class _Sanitize:
    """Context manager patching ``threading.Lock/RLock/Condition`` so
    locks *created inside the context* are instrumented. Locks created
    before entry keep their real classes (documented limitation: build
    the threaded system inside the context, as the threaded tests do)."""

    def __init__(self, register_metrics: bool = True):
        self.monitor = LockMonitor()
        self._register_metrics = register_metrics
        self._saved: Dict[str, Any] = {}

    def __enter__(self) -> LockMonitor:
        mon = self.monitor

        def make_lock():
            mon.locks_created += 1
            return _SanitizedLock(mon, "lock")

        def make_rlock():
            mon.locks_created += 1
            return _SanitizedLock(mon, "rlock")

        def make_condition(lock=None):
            mon.locks_created += 1
            return _SanitizedCondition(mon, lock)

        self._saved = {"Lock": threading.Lock, "RLock": threading.RLock,
                       "Condition": threading.Condition}
        threading.Lock = make_lock
        threading.RLock = make_rlock
        threading.Condition = make_condition
        return mon

    def __exit__(self, *exc):
        threading.Lock = self._saved["Lock"]
        threading.RLock = self._saved["RLock"]
        threading.Condition = self._saved["Condition"]
        if self._register_metrics:
            try:
                self.monitor.export_metrics()
            except Exception:
                pass
        return False


def sanitize(register_metrics: bool = True) -> _Sanitize:
    """Run threaded code under the lock sanitizer::

        with sanitize() as mon:
            fleet = build_fleet(...)        # locks created in here
            run_threaded_traffic(fleet)
        assert not mon.check(load_lock_order(LOCK_ORDER_PATH))

    Records actual acquisition orders and hold-while-blocking events,
    raises :class:`DoubleAcquireError` instead of deadlocking on a
    same-thread re-acquire of a non-reentrant lock, and exports
    ``concurrency_*`` metrics on exit."""
    return _Sanitize(register_metrics)


def main(argv=None) -> int:
    """Lint the package against the committed manifest (exit 1 on an
    error), or rewrite the manifest with ``--update-lock-order``."""
    import argparse
    ap = argparse.ArgumentParser(
        description="Concurrency lint of paddle_tpu_torch")
    ap.add_argument("--update-lock-order", action="store_true",
                    help="rewrite the manifest from the extracted graph")
    ap.add_argument("--lock-order", default=LOCK_ORDER_PATH)
    args = ap.parse_args(argv)
    if args.update_lock_order:
        graph = extract_lock_graph(package_sources())
        if not graph.acyclic():
            print("refusing to bless a cyclic lock order:",
                  graph.cycles())
            return 1
        with open(args.lock_order, "w") as f:
            json.dump(lock_order_manifest(graph), f, indent=1,
                      sort_keys=True)
            f.write("\n")
        print(f"wrote {args.lock_order}: {len(graph.locks)} locks, "
              f"{len(graph.edges)} edges")
        return 0
    from paddle_tpu_torch.analysis.findings import SUPPRESSIONS_PATH
    suppressions = Suppressions.load(SUPPRESSIONS_PATH)
    report = lint_concurrency(lock_order=args.lock_order,
                              suppressions=suppressions, registry=False)
    print(report.render_text())
    for rule, pat in suppressions.stale():
        print(f"  stale suppression: {rule}  {pat}")
    return 0 if report.ok() and not suppressions.stale() else 1


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
