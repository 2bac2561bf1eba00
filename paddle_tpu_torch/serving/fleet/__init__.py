"""Multi-replica serving fleet: router, autoscaler, live migration.

The first subsystem that treats :class:`~paddle_tpu_torch.serving.
ServingEngine` replicas as cattle (ROADMAP open item 2). Three parts:

1. **Replica handles** (`replica.py`): :class:`ReplicaHandle` is the
   transport interface (submit / step / health / prefix digests /
   snapshot / restore); :class:`LocalReplica` implements it in-process
   — synchronous stepping for deterministic CI, optional background
   thread — so a process/HTTP transport can slot in later without the
   router changing.
2. **Router** (`router.py`): :class:`FleetRouter` places requests by
   **prefix affinity** first (the prompt's page-aligned content-hash
   digests vs each replica's published prefix index — shared-prompt
   traffic lands where its pages are hot) with **power-of-two-choices**
   over live ``health()`` as fallback; router-minted ``trace_id``
   propagates into replica spans so one Perfetto timeline crosses the
   fleet; :class:`FleetMonitor` folds per-replica metrics into
   fleet-level gauges behind one exposition endpoint.
3. **Autoscaler** (`autoscaler.py`): :class:`FleetAutoscaler` turns
   sustained SLO burn (each replica's BurnRateMonitor) into scale-out
   — new replicas fully ``warmup()``-captured before taking traffic
   — and sustained idle into scale-in via **live migration**: queued
   requests re-routed, in-flight slots snapshotted (sha256-verified
   per-page shards), restored into peers, decode resumed
   byte-identically.
4. **Fault tolerance** (`faults.py`): involuntary failure
   as a first-class citizen — :class:`FailureDetector` declares a
   replica dead (crash, hang, N consecutive exceptions, replica-
   surfaced loop death), :meth:`FleetRouter.eject_replica` redrives
   its requests **exactly once** (bit-identical greedy outputs, warm
   micro-checkpoint restore or cold ``prompt + observed`` resubmit,
   structured sheds for hopeless requests), per-replica
   :class:`CircuitBreaker`\\ s pause routing to transiently sick
   replicas (the autoscaler spawns replacements for the lost
   capacity), and :class:`ChaosReplica` injects all of it
   deterministically for the chaos test battery.
5. **Network serving** (`net/`):
   ``net.ReplicaServer`` runs one engine per process behind a framed
   wire protocol, ``net.NetReplica`` is the client-side
   :class:`ReplicaHandle` the router drives with zero code forks, and
   ``net.FrontDoor`` streams tokens to clients incrementally with
   bounded buffers and structured rejects.
"""

from paddle_tpu_torch.serving.fleet.replica import (FullReplay, LocalReplica,
                                                    ReplicaHandle)
from paddle_tpu_torch.serving.fleet.router import FleetMonitor, FleetRouter
from paddle_tpu_torch.serving.fleet.autoscaler import FleetAutoscaler
from paddle_tpu_torch.serving.fleet.faults import (ChaosReplica, ChaosSpec,
                                                   CircuitBreaker,
                                                   FailureDetector,
                                                   FaultPolicy,
                                                   ReplicaCrashed,
                                                   ReplicaUnavailable,
                                                   chaos_schedule)
from paddle_tpu_torch.serving.engine import SlotMigrationError
from paddle_tpu_torch.serving.paged_cache import prompt_prefix_digests

__all__ = [
    "ReplicaHandle", "LocalReplica", "FullReplay",
    "FleetRouter", "FleetMonitor",
    "FleetAutoscaler", "SlotMigrationError", "prompt_prefix_digests",
    "ChaosReplica", "ChaosSpec", "CircuitBreaker", "FailureDetector",
    "FaultPolicy", "ReplicaCrashed", "ReplicaUnavailable",
    "chaos_schedule",
]
