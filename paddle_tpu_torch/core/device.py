"""Device resolution for the port's entry points.

The counterpart of the JAX package's impl resolution: there the kernel
choice followed the backend, here it follows the device. Entry points
default to ``"cuda"``; the CPU is used only when the caller asks for it,
and a missing card is an error, never a silent CPU run.
"""

from __future__ import annotations

import contextlib
import gc

import torch


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
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")


@contextlib.contextmanager
def graph_capture(graph, pool=None):
    """``torch.cuda.graph(graph, pool=pool)`` with the cycle collector
    paused for the capture. An engine and its step graphs refer to each
    other, so a dropped engine lives until the collector finds it; if
    that happens inside another capture, its graphs and memory are freed
    there, which the capture does not allow: it fails."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool):
            yield
    finally:
        if enabled:
            gc.enable()
