"""Kernel registry: one entry per hand-written Hopper kernel.

The port's counterpart of ``paddle_tpu/kernels/registry.py`` (subset):
each entry pairs the CUDA wrapper with its plain PyTorch version and a
dense reference, states the parity tolerance per dtype, and counts the
wrapper's launches so a run can show that the main path went through
the kernel. ``chip_smoke.py`` iterates the registry; the autotuner and
the lint are not ported.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib
import threading
from typing import Callable, Dict, Tuple

import torch


@dataclasses.dataclass
class KernelEntry:
    """One registered kernel.

    ``cuda_fn`` launches the kernel on CUDA tensors (and raises on
    anything else); ``plain_fn`` is the plain PyTorch version the CPU
    path and the on-card parity check use; ``reference_fn`` is a dense
    per-row reference independent of both. ``work(*args, **kw)``
    returns ``(bytes, flops)`` the call needs on these inputs (live
    tokens only), the numerator of its roofline bound. ``launches`` is
    bumped by the wrapper once per kernel launch
    (:meth:`note_launch`), nowhere else."""

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
    launches: int = 0

    def note_launch(self, n: int = 1):
        """Count ``n`` launches (negative: take back counts of a graph
        capture, which launches nothing): process-wide in ``launches``,
        and in the calling thread's tally
        (:func:`thread_launch_counts`)."""
        with _count_lock:
            self.launches += n
        _thread_tally()[self.name] += n


_count_lock = threading.Lock()
_local = threading.local()


def _thread_tally() -> "collections.Counter[str]":
    tally = getattr(_local, "tally", None)
    if tally is None:
        tally = _local.tally = collections.Counter()
    return tally


_REGISTRY: Dict[str, KernelEntry] = {}

#: modules that register kernels when imported
_HOME_MODULES = ("paddle_tpu_torch.serving.paged_attention",
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
    for mod in _HOME_MODULES:
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


def reset_launches():
    """Set every entry's launch count to 0 (before a measured run)."""
    with _count_lock:
        for entry in _REGISTRY.values():
            entry.launches = 0
