"""Preemption handling: drain, then exit with a known code
(``paddle_tpu/resilience/preempt.py``).

:class:`PreemptionGuard` installs a SIGTERM handler that only sets a flag
(signal-handler-safe: no IO, no locks); the loop that owns the work
checks the flag, drains, and calls :meth:`PreemptionGuard.exit`, which
raises ``SystemExit`` with :data:`EXIT_PREEMPTED`. The fleet's replica
server drains its in-flight requests on SIGTERM and exits with
:data:`EXIT_DRAINED`.

Neither code is 143 (the shell's 128+SIGTERM for an unhandled kill): a
launcher can tell "drained on purpose" from "died rudely".
"""

from __future__ import annotations

import signal
import threading
from typing import Callable, Iterable, Optional

from paddle_tpu_torch import observability

# 64+19 is arbitrary but stable: outside the shell's 128+N signal band and
# distinct from every exit code the launcher/tests already use (0..9).
EXIT_PREEMPTED = 83

# Voluntary scale-in drain (the serving fleet's autoscaler shrinking the
# fleet): the worker migrated its in-flight state to peers and exited on
# purpose. Distinct from EXIT_PREEMPTED — a preempted worker WANTS a
# respawn (the platform took its slice), a drained worker must NOT be
# respawned (the fleet chose fewer replicas).
EXIT_DRAINED = 84


class PreemptionGuard:
    """Flag-setting signal trap with an explicit drain protocol.

    ``install=True`` hooks the given signals (default SIGTERM) when
    running on the main thread; elsewhere — or in tests — call
    :meth:`trigger` directly (``faults.simulate_preemption``). The
    previous handlers are preserved and restored by :meth:`uninstall`.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,), *,
                 install: bool = True,
                 log_fn: Callable[[str], None] = print):
        self._flag = threading.Event()
        self._log = log_fn
        self._previous = {}
        self.signals = tuple(signals)
        if install:
            self.install()

    def install(self):
        for sig in self.signals:
            try:
                self._previous[sig] = signal.signal(sig, self._handler)
            except ValueError:
                # not the main thread: signal delivery is the launcher's
                # problem, manual trigger() still works
                self._log("[preempt] cannot install handler off the main "
                          "thread; rely on trigger()")
                return

    def uninstall(self):
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()

    def _handler(self, signum, frame):
        self.trigger(signum)

    def trigger(self, signum: Optional[int] = None):
        """Mark preemption requested. STRICTLY flag-only: this runs inside
        a signal handler on the main thread, which may already hold the
        (non-reentrant) observability registry locks mid-step — touching
        any lock here could deadlock the very thread that must drain.
        Metrics are recorded at the drain site (:meth:`exit`) instead."""
        self._flag.set()

    @property
    def triggered(self) -> bool:
        return self._flag.is_set()

    def exit(self, code: int = EXIT_PREEMPTED):
        """Leave the process with the launcher-visible preemption code."""
        observability.default().counter(
            "resilience_preemptions_total",
            "preemptions drained to a snapshot + clean exit").inc()
        self._log(f"[preempt] drained and snapshotted; exiting {code}")
        raise SystemExit(code)
