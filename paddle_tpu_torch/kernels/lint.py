"""Kernel-registry lint: declared contracts against what the kernels and
their bindings do, and bindings that bypass the registry.

The port's counterpart of ``paddle_tpu/kernels/lint.py``, redesigned for
ctypes entry points instead of ``pallas_call`` sites. Two rules:

- ``kernel-contract``, per registered entry: the declared argument
  layouts have the ranks of its ``sample_inputs``; the tuner resolves a
  configuration inside the declared candidates, and every candidate's
  shared-memory estimate fits one Hopper block (227 KB); the plain
  version's output has the dense reference's shapes and dtypes; the
  committed tuning cache holds no dead entry; and each C entry point's
  ctypes signature has as many arguments as its ``extern "C"`` prototype
  in ``csrc/`` has parameters (the guard on the tunable arguments).
- ``composite-entry-contract``, per composite entry (the ``*_tp``
  entries, ``ring_attention``): its inner kernels are registered, its
  layouts have the ranks of its sample inputs, its version is set (and
  its tolerance, where it has a battery), and both its entry point and
  its plain version refuse to run without a mesh.
- ``kernel-registry-bypass``, over the package and ``csrc/``: every
  ``extern "C" int ptt_*`` entry point is named by exactly one registry
  entry, and every Python call that binds one (``build.bind``) lies in a
  registered home module. Deliberate exceptions go in :data:`ALLOWLIST`
  (empty), the counterpart of ``tools/kernel_registry_allowlist.txt``;
  an exception that matches nothing is itself a finding.

The reference's donation and collective checks read XLA's lowered HLO
(buffer aliasing, collective ops). A CUDA kernel launched through ctypes
has no lowered program to read, aliases nothing (every wrapper allocates
its outputs) and launches no collective, so those checks have no
counterpart here.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch

from paddle_tpu_torch.analysis.findings import Finding, Report
from paddle_tpu_torch.kernels import autotune as _autotune
from paddle_tpu_torch.kernels import registry as _registry

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_ROOT, "csrc")

#: ``module`` or ``module:symbol`` entries exempt from the bypass rule
#: (a binding outside a home module, or an entry point no entry names),
#: each with its reason; empty: every kernel goes through the registry
ALLOWLIST: Tuple[str, ...] = ()

_PROTOTYPE = re.compile(r'extern\s+"C"\s+int\s+(ptt_\w+)\s*\(([^)]*)\)', re.S)


def _layout_rank(layout: str) -> Optional[int]:
    """``"(P,ps,H,Dh)" -> 4``; None when the layout is not dimensioned
    (or only says what it broadcasts to)."""
    if not layout.startswith("("):
        return None
    body = layout[1:layout.index(")")]
    return len([p for p in body.split(",") if p.strip()])


def c_prototypes(csrc: str = CSRC) -> Dict[str, Tuple[str, int]]:
    """``{symbol: (file, parameter count)}`` of every ``extern "C" int
    ptt_*`` in ``csrc/*.cu``."""
    out: Dict[str, Tuple[str, int]] = {}
    for fn in sorted(os.listdir(csrc)):
        if not fn.endswith(".cu"):
            continue
        with open(os.path.join(csrc, fn)) as f:
            text = re.sub(r"//[^\n]*", "", f.read())
        for m in _PROTOTYPE.finditer(text):
            params = [p for p in m.group(2).split(",") if p.strip()]
            out[m.group(1)] = (fn, len(params))
    return out


def _bad(out: List[Finding], name: str, msg: str, fix: str = ""):
    out.append(Finding("kernel-contract", "error", msg,
                       location=f"kernels/{name}", fix=fix, engine="plan"))


def contract_findings(entry, tuner=None,
                      prototypes: Optional[Mapping] = None) -> List[Finding]:
    """Check one entry's declared contract (see the module docstring)."""
    out: List[Finding] = []
    args, kwargs = entry.sample_inputs(0)

    # 1. declared layouts vs sample-input ranks, in argument order
    layouts = entry.contract.arg_layouts
    if len(layouts) != len(args):
        _bad(out, entry.name, f"{len(layouts)} declared layouts for "
             f"{len(args)} sample arguments")
    for (arg, layout), a in zip(layouts.items(), args):
        rank = _layout_rank(layout)
        if rank is not None and isinstance(a, torch.Tensor) \
                and a.ndim != rank:
            _bad(out, entry.name, f"arg {arg!r} declared {layout} (rank "
                 f"{rank}) but the sample input has rank {a.ndim}",
                 fix="the contract's arg_layouts and sample_inputs are one "
                     "declared surface: align them")

    # 2. the tuner resolves inside the candidates, which fit a block
    blocks = (tuner or _autotune.KernelTuner(path=None)).get(
        entry, args, kwargs)
    if not entry.contract.admits(args, blocks):
        _bad(out, entry.name, f"the tuner resolved "
             f"{_registry.blocks_text(blocks)}, outside the contract's "
             f"candidates {dict(entry.contract.candidates(args))}",
             fix="extend the candidates or fix the prior / cache entry")
    for cand in entry.contract.grid(args):
        smem = entry.smem(args, cand)
        if smem > _registry.SMEM_BUDGET_BYTES:
            _bad(out, entry.name, f"candidate {_registry.blocks_text(cand)} "
                 f"takes {smem} bytes of shared memory, over a Hopper "
                 f"block's {_registry.SMEM_BUDGET_BYTES}",
                 fix="drop the candidate or shrink its staging")

    # 3. the plain version's outputs are the dense reference's
    try:
        got = entry.plain_fn(*args, **kwargs)
        want = entry.reference_fn(*args, **kwargs)
        flat = lambda o: o if isinstance(o, (tuple, list)) else (o,)
        got_sig = [(tuple(t.shape), t.dtype) for t in flat(got)]
        want_sig = [(tuple(t.shape), t.dtype) for t in flat(want)]
        if got_sig != want_sig:
            _bad(out, entry.name, f"the plain version gives {got_sig} but "
                 f"the dense reference {want_sig}",
                 fix="the implementations are one contract: align their "
                     "outputs")
    except Exception as e:   # a contract that cannot run is a finding
        _bad(out, entry.name, f"running the sample failed: "
             f"{type(e).__name__}: {e}")

    # 4. ctypes arity against the C prototype
    prototypes = c_prototypes() if prototypes is None else prototypes
    for sym, argtypes in entry.contract.symbols.items():
        if sym not in prototypes:
            _bad(out, entry.name, f"entry point {sym} is not an extern \"C\" "
                 "function of csrc/")
            continue
        src, n = prototypes[sym]
        if len(argtypes) != n:
            _bad(out, entry.name, f"{sym}: the ctypes signature has "
                 f"{len(argtypes)} arguments, the prototype in {src} has "
                 f"{n} parameters",
                 fix="a launch would pass its arguments shifted: align "
                     "the signature with the prototype")
    return out


def composite_entry_findings(entry) -> List[Finding]:
    """Check one composite entry's declared contract (module
    docstring)."""
    out: List[Finding] = []

    def bad(msg, fix=""):
        out.append(Finding("composite-entry-contract", "error", msg,
                           location=f"kernels/{entry.name}", fix=fix,
                           engine="plan"))

    known = set(_registry.names())
    for inner in entry.inner:
        if inner not in known:
            bad(f"inner kernel {inner!r} is not registered",
                fix="name registered kernels only")
    if not entry.inner:
        bad("no inner kernel: a composite entry runs registered "
            "kernels")
    args, kwargs = entry.sample_inputs(0)
    layouts = list(entry.arg_layouts.items())
    for (arg, layout), a in zip(layouts, args):
        rank = _layout_rank(layout)
        if rank is not None and isinstance(a, torch.Tensor) \
                and a.ndim != rank:
            bad(f"arg {arg!r} declared {layout} (rank {rank}) but the "
                f"sample input has rank {a.ndim}")
    if len(args) > len(layouts):
        bad(f"{len(layouts)} declared layouts for {len(args)} sample "
            "arguments")
    if entry.version < 1:
        bad(f"version {entry.version}: a contract states one")
    if entry.parity_fn is not None and not (
            callable(entry.parity_fn) and entry.atol and entry.atol > 0
            and entry.rtol and entry.rtol > 0):
        bad(f"a battery with atol {entry.atol}, rtol {entry.rtol}: it "
            "states both")
    if not entry.requires_mesh:
        bad("a composite entry requires a mesh")
    from paddle_tpu_torch.core import mesh as mesh_lib
    if mesh_lib.current_mesh() is None:
        for what, fn in (("fn", entry.fn), ("plain_fn", entry.plain_fn)):
            try:
                fn(*args, **kwargs)
            except ValueError as e:
                if "requires a mesh" not in str(e):
                    bad(f"{what} without a mesh raised {e!r}, not the "
                        "refusal")
            else:
                bad(f"{what} ran without a mesh",
                    fix="refuse to run without mesh= or a mesh_context")
    return out


def _bind_sites(path: str, module: str) -> List[Tuple[str, int]]:
    """``(module, line)`` of every ``build.bind(...)`` call in a file."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    sites = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr == "bind" \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == "build":
            sites.append((module, node.lineno))
    return sites


def _py_files(root: str) -> Iterable[Tuple[str, str]]:
    """``(path, module)`` of every ``.py`` under the package root."""
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(files):
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, os.path.dirname(root))
                yield path, rel[:-3].replace(os.sep, ".")


def load_allowlist(path: str) -> List[str]:
    """:data:`ALLOWLIST` entries kept in a file, one a line, ``#``
    comments dropped (the reference's allowlist file format); a missing
    file is an empty list."""
    entries = []
    if path and os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if line:
                    entries.append(line)
    return entries


def bypass_findings(*, root: str = _PKG_ROOT,
                    prototypes: Optional[Mapping] = None,
                    allowlist: Sequence[str] = ALLOWLIST) -> List[Finding]:
    """Entry points no registry entry names (or more than one does), and
    ``build.bind`` calls outside the home modules."""
    _registry.load_all()
    prototypes = c_prototypes() if prototypes is None else prototypes
    named: Dict[str, List[str]] = {}
    for name in _registry.names():
        for sym in _registry.get(name).contract.symbols:
            named.setdefault(sym, []).append(name)
    used = set()
    out: List[Finding] = []

    def bypass(msg, location, fix):
        out.append(Finding("kernel-registry-bypass", "error", msg,
                           location=location, fix=fix, engine="ast"))

    for sym, (src, _n) in sorted(prototypes.items()):
        owners = named.get(sym, [])
        if len(owners) == 1:
            continue
        if sym in allowlist:
            used.add(sym)
            continue
        bypass(f"entry point {sym} in csrc/{src} is named by "
               f"{len(owners)} registry entries {owners}, not one",
               f"csrc/{src}", "register the kernel (its contract's "
               "symbols) in one home module, or remove the entry point")
    homes = set(_registry.HOME_MODULES)
    for path, module in _py_files(root):
        if module.endswith(".kernels.build"):
            continue                     # the binder itself
        for mod, line in _bind_sites(path, module):
            if mod in homes:
                continue
            if mod in allowlist:
                used.add(mod)
                continue
            bypass(f"{mod}:{line} binds a csrc/ entry point outside the "
                   "registered home modules "
                   f"({', '.join(sorted(homes))})",
                   f"{os.path.basename(path)}:{line}",
                   "launch the kernel through a registered entry's wrapper")
    for ent in allowlist:
        if ent not in used:
            bypass(f"stale allowlist entry {ent!r} matches nothing",
                   "kernels/lint.py ALLOWLIST",
                   "delete it: a dead entry would accept a future bypass")
    return out


def lint_registry(suppressions=None, *, tuner=None,
                  committed: Optional[str] = _autotune.DEFAULT_CACHE_PATH,
                  root: str = _PKG_ROOT, csrc: str = CSRC,
                  allowlist: Sequence[str] = ALLOWLIST,
                  registry_metrics: bool = True) -> Report:
    """The whole kernel-registry report: every entry's contract, the
    committed tuning cache's dead entries, and the bypass scan."""
    _registry.load_all()
    report = Report("kernel_registry", suppressions=suppressions)
    prototypes = c_prototypes(csrc)
    for name in _registry.names():
        report.extend(contract_findings(_registry.get(name), tuner=tuner,
                                        prototypes=prototypes))
    for entry in _registry.composite_entries():
        report.extend(composite_entry_findings(entry))
    if committed is not None:
        for key in _autotune.KernelTuner(committed).stale_entries():
            report.add(Finding(
                "kernel-contract", "error",
                f"committed tune-cache entry {key!r} is dead (stale "
                "contract version, unknown kernel, or blocks outside the "
                "candidates)", location=committed,
                fix="re-measure on the card: python -m "
                    "paddle_tpu_torch.kernels.autotune --measure",
                engine="plan"))
    report.extend(bypass_findings(root=root, prototypes=prototypes,
                                  allowlist=allowlist))
    if registry_metrics:
        report.count_into_registry()
    return report


def main(argv=None) -> int:
    """``python -m paddle_tpu_torch.kernels.lint``: print the report;
    exit 1 on an error."""
    report = lint_registry()
    print(report.render_text())
    return 0 if report.ok() else 1


if __name__ == "__main__":  # pragma: no cover
    import sys
    sys.exit(main())
