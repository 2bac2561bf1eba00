"""Deterministic fault injection for the resilience tests
(``paddle_tpu/resilience/faults.py``).

These wrappers make a mid-write kill or a flaky filesystem a
reproducible test input:

- :class:`TornWriteFS` — a filesystem whose process "dies" after writing
  N bytes: the write raises, and EVERY subsequent operation fails (a dead
  host does not come back to rename its manifest). Models kill -9 /
  preemption mid-save byte-exactly.
- :class:`FlakyFS` — the first K calls of selected operations raise
  ``IOError`` (transient NFS hiccups), then the filesystem heals.
  Drives the retry/backoff path deterministically.
- :func:`corrupt_file` — flip a byte mid-file (bit rot / truncated
  upload) to exercise hash verification on restore.
- :func:`simulate_preemption` — trip a :class:`PreemptionGuard` exactly
  the way the real SIGTERM handler does (or deliver a real signal).

All wrappers delegate unknown attributes to the wrapped fs, so they slot
anywhere a :class:`paddle_tpu_torch.fs.LocalFS` goes.
"""

from __future__ import annotations

import os
import signal
from typing import Iterable, Optional


class FaultInjected(IOError):
    """Raised by injected faults (subclasses IOError: retryable)."""


class HostDead(FaultInjected):
    """Any fs operation attempted after the simulated kill point."""


class _TornWriter:
    """File object that 'loses the host' after a byte budget: the prefix
    that fits is written (and flushed — it really lands on disk, exactly
    like a torn page), then :class:`FaultInjected` fires."""

    def __init__(self, f, fs: "TornWriteFS"):
        self._f = f
        self._fs = fs

    def write(self, data: bytes):
        fs = self._fs
        if fs.dead:
            raise HostDead("write after simulated kill")
        room = fs.kill_after_bytes - fs.bytes_written
        if len(data) > room:
            self._f.write(data[:max(0, room)])
            self._f.flush()
            fs.bytes_written = fs.kill_after_bytes
            fs.dead = True
            raise FaultInjected(
                f"simulated kill after {fs.kill_after_bytes} bytes")
        fs.bytes_written += len(data)
        return self._f.write(data)

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class TornWriteFS:
    """Kill-after-N-bytes filesystem wrapper (the mid-save host crash)."""

    _GUARDED = ("open_write", "rename", "upload", "touch", "mkdirs",
                "delete")

    def __init__(self, inner, kill_after_bytes: int):
        self.inner = inner
        self.kill_after_bytes = int(kill_after_bytes)
        self.bytes_written = 0
        self.dead = False

    def _check(self):
        if self.dead:
            raise HostDead("fs operation after simulated kill")

    def open_write(self, path: str):
        self._check()
        return _TornWriter(self.inner.open_write(path), self)

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if name in self._GUARDED and callable(attr):
            def guarded(*a, **kw):
                self._check()
                return attr(*a, **kw)
            return guarded
        return attr


class FlakyFS:
    """First ``fail_times`` calls of ``ops`` raise IOError, then heal."""

    def __init__(self, inner, fail_times: int,
                 ops: Iterable[str] = ("open_write", "rename", "upload")):
        self.inner = inner
        self.fail_times = int(fail_times)
        self.failures_injected = 0
        self.ops = tuple(ops)

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if name in self.ops and callable(attr):
            def flaky(*a, **kw):
                if self.failures_injected < self.fail_times:
                    self.failures_injected += 1
                    raise FaultInjected(
                        f"injected transient failure #"
                        f"{self.failures_injected} in {name}")
                return attr(*a, **kw)
            return flaky
        return attr


def corrupt_file(path: str, *, offset: Optional[int] = None):
    """Flip one byte of ``path`` in place (default: the middle)."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot corrupt empty file {path}")
    pos = size // 2 if offset is None else offset
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))
        f.flush()
        os.fsync(f.fileno())


def simulate_preemption(guard=None, *, real_signal: bool = False):
    """Trip preemption: through ``guard.trigger()`` (deterministic, any
    thread) or by delivering a real SIGTERM to this process."""
    if real_signal:
        os.kill(os.getpid(), signal.SIGTERM)
        return
    if guard is None:
        raise ValueError("pass a PreemptionGuard or real_signal=True")
    guard.trigger(signal.SIGTERM)
