"""Device resolution for the port's entry points.

The counterpart of the JAX package's impl resolution: there the kernel
choice followed the backend, here it follows the device. Entry points
default to ``"cuda"``; the CPU is used only when the caller asks for it,
and a missing card is an error, never a silent CPU run.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict

import torch

from paddle_tpu_torch.kernels import registry


def resolve_device(device="cuda") -> torch.device:
    """``device`` (str or ``torch.device``) -> a usable ``torch.device``.

    Raises ``RuntimeError`` for a CUDA device when no card is visible and
    ``ValueError`` for device types the port does not run on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
        # "cuda" is the current card, where tensors made with it live
        return dev if dev.index is not None else torch.device(
            "cuda", torch.cuda.current_device())
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")


@contextlib.contextmanager
def graph_capture(graph, pool=None):
    """``torch.cuda.graph(graph, pool=pool)`` in ``"thread_local"``
    capture mode, with the cycle collector paused for the capture.

    An engine and its step graphs refer to each other, so a dropped
    engine lives until the collector finds it; if that happens inside
    another capture, its graphs and memory are freed there, which the
    capture does not allow: it fails.

    The default ``"global"`` mode fails a capture when any other thread
    makes a call that is unsafe during a capture (an allocation, a
    synchronizing copy, a pinned host buffer): a fleet's replicas serve
    from their own threads while a new replica captures its warmup plan.
    ``"thread_local"`` refuses those calls on the capturing thread only,
    where every captured body allocates from the capture stream, which
    PyTorch's allocator serves from the graph pool; other threads'
    streams and allocations stay outside the capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            yield
    finally:
        if enabled:
            gc.enable()


def counted_capture(graph, fn: Callable, *, pool=None,
                    process_wide: bool = False):
    """Capture ``fn()`` into ``graph`` (:func:`graph_capture`) and return
    ``(fn's result, launches)``: the kernel launches one replay makes, by
    registry entry.

    The kernel wrappers count launches in Python, which a replay never
    runs, so the counts the capture itself made are taken back (also when
    it fails); the caller adds ``launches`` on each replay
    (:func:`note_replay`), and registry counts stay the kernels the card
    ran. The capture reads the calling thread's counts, as other threads
    may launch meanwhile, or with ``process_wide`` every thread's (a
    backward launches its kernels from autograd's device threads; no
    other thread may launch during such a capture)."""
    counts = (registry.launch_counts if process_wide
              else registry.thread_launch_counts)
    before = counts()
    try:
        with graph_capture(graph, pool=pool):
            out = fn()
    finally:
        launches = registry.count_delta(counts(), before)
        for name, n in launches.items():
            registry.get(name).note_launch(-n)
    return out, launches


def note_replay(launches: Dict[str, int]):
    """Count one replay of a graph that :func:`counted_capture` made."""
    for name, n in launches.items():
        registry.get(name).note_launch(n)
