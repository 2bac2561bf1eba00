"""Recompile detection over the port's step builds
(``paddle_tpu/observability/recompile.py``).

The reference counts XLA backend compiles through ``jax.monitoring``. The
port's counterpart of one compile is the build of one step signature
(:mod:`paddle_tpu_torch.serving.graphs`): a CUDA graph capture on the
card, and on the CPU or under eager dispatch the signature's first run,
counted the same way. Every build calls :func:`note_capture`, which bumps
one process-wide count; a :class:`RecompileDetector` snapshots that
count around each step, and an increase after warmup is a recompile,
logged as a structured warning and counted in
``<name>_recompiles_total``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

from paddle_tpu_torch.observability import registry as _registry

_lock = threading.Lock()
_count = 0


def note_capture() -> None:
    """Count one step build (a graph capture) in this process."""
    global _count
    with _lock:
        _count += 1


def capture_count() -> int:
    """Step builds (graph captures) observed in this process."""
    with _lock:
        return _count


def shape_signature(feeds: Optional[Dict[str, Any]]) -> str:
    """Stable ``name:dtype[shape]`` signature of a feed dict — the
    recompile warning's 'what changed' half."""
    if not feeds:
        return "<no feeds>"

    def one(v):
        shape = getattr(v, "shape", None)
        dtype = getattr(v, "dtype", None)
        if shape is None:
            return f"{type(v).__name__}"
        ds = getattr(dtype, "name", str(dtype))
        return f"{ds}[{','.join(map(str, shape))}]"

    return " ".join(f"{k}:{one(v)}" for k, v in sorted(feeds.items()))


class RecompileDetector:
    """Per-callsite watcher around the process-wide build count.

    Protocol::

      det = RecompileDetector("serving_decode")
      ... run step ...
      new = det.check(step=i, feeds=batch)   # builds since last check

    The first ``warmup`` checks that see builds are expected (first use)
    and counted but not warned about; any later increase fires a
    structured warning via ``log_fn`` and bumps the
    ``<name>_recompiles_total`` counter.
    """

    def __init__(self, name: str = "step", *, warmup: int = 1,
                 registry: Optional[_registry.MetricsRegistry] = None,
                 log_fn: Callable[[str], None] = None):
        self.name = name
        self.warmup = warmup
        self._reg = registry or _registry.default()
        self._log = log_fn if log_fn is not None else _warn
        self._baseline = capture_count()
        self._last = self._baseline
        self._checks = 0
        self.compiles_cum = 0     # builds since construction
        self.recompiles = 0       # builds after warmup

    def check(self, *, step: Optional[int] = None,
              feeds: Optional[Dict[str, Any]] = None) -> int:
        """Call once per step AFTER the step ran. Returns the number of
        new builds observed since the previous check."""
        now = capture_count()
        new = now - self._last
        self._last = now
        self._checks += 1
        self.compiles_cum = now - self._baseline
        if new and self._checks > self.warmup:
            self.recompiles += new
            self._reg.counter(
                f"{self.name}_recompiles_total",
                "post-warmup step builds (graph captures)").inc(new)
            at = f" step={step}" if step is not None else ""
            self._log(
                f"[observability] RECOMPILATION: fn={self.name}{at} "
                f"new_captures={new} total={self.recompiles} — arg "
                f"signature: {shape_signature(feeds)} (a signature the "
                "warmup plan does not cover; warm it up)")
        return new


def _warn(msg: str):
    import warnings
    warnings.warn(msg, RuntimeWarning, stacklevel=3)
