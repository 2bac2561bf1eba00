"""Kernel registry: one entry per hand-written Hopper kernel.

The port's counterpart of ``paddle_tpu/kernels/registry.py``: each entry
pairs the CUDA wrapper with its plain PyTorch version and a dense
reference, states the parity tolerance per dtype, counts the wrapper's
launches so a run can show that the main path went through the kernel,
and declares its :class:`KernelContract`: the argument layouts, the C
entry points it launches with their ctypes signatures, and the launch
tunables the autotuner (``kernels/autotune.py``) chooses among, with the
configuration the kernel's source fixes as the prior (today every
tunable has that one candidate). The
parity battery (``kernels/harness.py``), the tuner and the registry lint
(``kernels/lint.py``) read it; ``chip_smoke.py`` iterates it.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib
import itertools
import json
import threading
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

#: shared memory one block may use on Hopper (bytes): the budget the
#: tunables' shared-memory estimates are held to
SMEM_BUDGET_BYTES = 232_448

#: a tunable's candidate values by name
Candidates = Mapping[str, Tuple[int, ...]]


@dataclasses.dataclass(frozen=True)
class KernelContract:
    """The declared contract of one kernel.

    ``version`` enters every autotuner cache key: bump it when the
    kernel's numerics, layouts or tunables change, and every persisted
    tuning entry of the old kernel becomes stale (detected, counted and
    ignored). ``candidates(args)`` gives each launch tunable's candidate
    values for a call (a kernel whose tiles follow the head dim declares
    one-candidate sets per head dim); ``prior(args)`` is the
    configuration the kernel's source fixes, which an empty cache
    resolves to. ``symbols`` maps each ``extern "C"`` entry point
    the wrapper launches to its ctypes argument types (the stream last)."""

    version: int
    #: argument name -> layout string, e.g. ``"(S,H,Dh)"`` or
    #: ``"(S,mp) i32"``, in the wrapper's argument order
    arg_layouts: Mapping[str, str]
    out_layout: str
    symbols: Mapping[str, Sequence]
    candidates: Callable[[tuple], Candidates]
    prior: Callable[[tuple], Dict[str, int]]

    def grid(self, args) -> Tuple[Dict[str, int], ...]:
        """Every configuration in the candidates' cartesian product."""
        cands = self.candidates(args)
        names = sorted(cands)
        return tuple(dict(zip(names, vals)) for vals in itertools.product(
            *(cands[n] for n in names)))

    def admits(self, args, blocks: Mapping[str, int]) -> bool:
        """``blocks`` names exactly the tunables, each a candidate."""
        cands = self.candidates(args)
        return (set(blocks) == set(cands)
                and all(blocks[n] in c for n, c in cands.items()))


def blocks_text(blocks: Mapping[str, int]) -> str:
    """A configuration as the cache and the reports write it."""
    return json.dumps(dict(blocks), sort_keys=True)


@dataclasses.dataclass
class KernelEntry:
    """One registered kernel.

    ``cuda_fn(*args, blocks=None, **kw)`` launches the kernel on CUDA
    tensors (and raises on anything else); ``blocks``, if given, must
    be a configuration the contract admits (the kernels fix their
    launch configuration); ``plain_fn`` is the plain
    PyTorch version the CPU path and the on-card parity check use;
    ``reference_fn`` is a dense per-row reference independent of both.
    ``work(*args, **kw)`` returns ``(bytes, flops)`` the call needs on
    these inputs (live tokens only), the numerator of its roofline
    bound. ``sample_inputs(seed)`` gives ``(args, kwargs)`` small enough
    for the CPU (float32, on the CPU); ``tune_signature(args)`` the
    ``((label, dim), ...)`` of the tuning key; ``smem(args, blocks)`` the
    shared memory one block of a configuration takes. ``launches`` is
    bumped by the wrapper once per kernel launch (:meth:`note_launch`),
    nowhere else."""

    name: str
    route: str
    source: str
    replaces: str
    cuda_fn: Callable
    plain_fn: Callable
    reference_fn: Callable
    #: dtype -> (atol, rtol) for kernel vs plain version
    tolerance: Dict[torch.dtype, Tuple[float, float]]
    work: Callable[..., Tuple[int, int]]
    contract: KernelContract
    sample_inputs: Callable[[int], Tuple[tuple, dict]]
    tune_signature: Callable[[tuple], Tuple[Tuple[str, int], ...]]
    smem: Callable[[tuple, Mapping[str, int]], int]
    launches: int = 0

    def note_launch(self, n: int = 1):
        """Count ``n`` launches (negative: take back counts of a graph
        capture, which launches nothing): process-wide in ``launches``,
        and in the calling thread's tally
        (:func:`thread_launch_counts`)."""
        with _count_lock:
            self.launches += n
        _thread_tally()[self.name] += n

    def blocks_for(self, args, blocks: Optional[Mapping[str, int]] = None,
                   ) -> Dict[str, int]:
        """The launch configuration of a call: ``blocks`` if given (it
        must be one the contract admits), else the default tuner's
        choice (a host dictionary lookup; under a graph capture it is
        made once, at capture, and baked into the graph)."""
        if blocks is None:
            from paddle_tpu_torch.kernels import autotune
            return autotune.default_tuner().get(self, args)
        if not self.contract.admits(args, blocks):
            raise ValueError(
                f"{self.name}: launch configuration {blocks_text(blocks)} "
                f"outside the contract's candidates "
                f"{dict(self.contract.candidates(args))}")
        return dict(blocks)


_count_lock = threading.Lock()
_local = threading.local()


def _thread_tally() -> "collections.Counter[str]":
    tally = getattr(_local, "tally", None)
    if tally is None:
        tally = _local.tally = collections.Counter()
    return tally


_REGISTRY: Dict[str, KernelEntry] = {}

#: modules that register kernels when imported, and the only modules that
#: may bind a ``csrc/`` entry point (``kernels/lint.py``)
HOME_MODULES = ("paddle_tpu_torch.serving.paged_attention",
                "paddle_tpu_torch.ops.attention")


def register(entry: KernelEntry) -> KernelEntry:
    _REGISTRY[entry.name] = entry
    return entry


def get(name: str) -> KernelEntry:
    if name not in _REGISTRY:
        load_all()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no kernel {name!r} registered "
                       f"(have: {', '.join(sorted(_REGISTRY)) or 'none'})")


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def load_all() -> Tuple[str, ...]:
    """Import every kernel home module and return the registered names."""
    for mod in HOME_MODULES:
        importlib.import_module(mod)
    return names()


def launch_counts() -> Dict[str, int]:
    """Every registered entry's launch count, by name."""
    return {name: e.launches for name, e in _REGISTRY.items()}


def thread_launch_counts() -> Dict[str, int]:
    """Launches counted by the calling thread since it started, by name:
    the difference of two reads is what this thread launched in between,
    whatever other threads launched meanwhile."""
    return dict(_thread_tally())


def count_delta(after: Dict[str, int],
                before: Dict[str, int]) -> Dict[str, int]:
    """The launches between two reads of :func:`launch_counts` or
    :func:`thread_launch_counts`, by name (names that moved only)."""
    return {n: c - before.get(n, 0) for n, c in after.items()
            if c != before.get(n, 0)}


def reset_launches():
    """Set every entry's launch count to 0 (before a measured run)."""
    with _count_lock:
        for entry in _REGISTRY.values():
            entry.launches = 0
