"""Resilience helpers (``paddle_tpu/resilience``, subset): bounded retry
with backoff, and the preemption guard with its exit codes. The sharded
snapshot engine and the fault-injection file systems are not ported."""

from paddle_tpu_torch.resilience.preempt import (EXIT_DRAINED,
                                                 EXIT_PREEMPTED,
                                                 PreemptionGuard)
from paddle_tpu_torch.resilience.retry import (RetryPolicy, retry_call,
                                               retrying)

__all__ = ["EXIT_DRAINED", "EXIT_PREEMPTED", "PreemptionGuard",
           "RetryPolicy", "retry_call", "retrying"]
