"""Resilience (``paddle_tpu/resilience``): the snapshot engine (atomic,
hash-verified, background-written checkpoints), the preemption guard
with its exit codes, bounded retry with backoff, and deterministic fault
injection (torn writes, a flaky filesystem, corrupted files, simulated
preemption) so every recovery path is testable on the CPU. One process:
the reference's sharded, multi-host paths wait for the port's parallel
layer (see ROADMAP)."""

from paddle_tpu_torch.resilience.faults import (FaultInjected, FlakyFS,
                                                HostDead, TornWriteFS,
                                                corrupt_file,
                                                simulate_preemption)
from paddle_tpu_torch.resilience.preempt import (EXIT_DRAINED,
                                                 EXIT_PREEMPTED,
                                                 PreemptionGuard)
from paddle_tpu_torch.resilience.retry import (RetryPolicy, retry_call,
                                               retrying)
from paddle_tpu_torch.resilience.snapshot import (SnapshotCorruptionError,
                                                  SnapshotEngine,
                                                  SnapshotError,
                                                  flatten_tree,
                                                  unflatten_tree)

__all__ = [
    "EXIT_DRAINED", "EXIT_PREEMPTED", "FaultInjected", "FlakyFS", "HostDead",
    "PreemptionGuard", "RetryPolicy", "SnapshotCorruptionError",
    "SnapshotEngine", "SnapshotError", "TornWriteFS", "corrupt_file",
    "flatten_tree", "retry_call", "retrying", "simulate_preemption",
    "unflatten_tree",
]
