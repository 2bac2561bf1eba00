"""Inference facade (``paddle_tpu/inference.py``, serving subset): one
engine, a fleet of them behind a router, or a router over replica server
processes."""

from __future__ import annotations


def make_serving_engine(model, **kwargs):
    """Continuous-batching serving front end for a
    :class:`~paddle_tpu_torch.models.gpt.GPT`: builds a
    :class:`~paddle_tpu_torch.serving.ServingEngine` over a paged KV
    cache. ``submit()`` requests and drive ``step()`` (or
    ``generate_many``); the engine keeps its fixed decode slots full and
    reports tokens, TTFT, slot occupancy and page utilization through
    its metrics registry. ``device`` defaults to CUDA;
    ``cache_dtype=torch.int8`` serves over the int8 page pool, and
    ``draft_model`` / ``spec_k`` / ``draft_cache_dtype`` turn on exact
    speculative decoding; ``tier`` ("prefill" or "decode") makes one half
    of a disaggregated pair, ``host_spill_pages`` adds the host spill
    tier and ``snapshot_every_blocks`` keeps micro-snapshots for
    ``restore_slot`` (see
    :class:`~paddle_tpu_torch.serving.ServingEngine`)."""
    from paddle_tpu_torch.serving.engine import ServingEngine
    return ServingEngine(model, **kwargs)


def make_serving_fleet(model, *, num_replicas: int = 2,
                       policy: str = "affinity", registry=None,
                       tracer=None, warmup: bool = True, autoscaler=None,
                       seed: int = 0, faults=None, postmortem_dir=None,
                       shed_spike_threshold: int = 4, **engine_kwargs):
    """``num_replicas`` serving engines over one
    :class:`~paddle_tpu_torch.models.gpt.GPT` (the weights are shared and
    read-only) behind a
    :class:`~paddle_tpu_torch.serving.fleet.FleetRouter`: prefix-affinity
    routing with power-of-two-choices fallback, router-minted trace ids,
    fault tolerance (``faults=``, a ``FaultPolicy``) and, with
    ``autoscaler=``, burn-rate scaling with live migration on drain. Each
    engine gets its own metrics registry and the shared ``tracer``;
    ``engine_kwargs`` go to every
    :class:`~paddle_tpu_torch.serving.ServingEngine`. Returns the router,
    its replicas warmed (every signature captured on the card) unless
    ``warmup=False``."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serving import fleet
    from paddle_tpu_torch.serving.engine import ServingEngine
    registry = registry or obs.default()
    tracer = tracer or obs.tracing.default()
    reps = []
    for i in range(num_replicas):
        eng = ServingEngine(model, registry=obs.MetricsRegistry(),
                            tracer=tracer, **engine_kwargs)
        rep = fleet.LocalReplica(eng, name=f"replica{i}")
        if warmup:
            rep.warmup()
        reps.append(rep)
    return fleet.FleetRouter(reps, policy=policy, registry=registry,
                             tracer=tracer, seed=seed,
                             autoscaler=autoscaler, faults=faults,
                             postmortem_dir=postmortem_dir,
                             shed_spike_threshold=shed_spike_threshold)


def make_net_serving_fleet(addresses, *, policy: str = "affinity",
                           registry=None, tracer=None, seed: int = 0,
                           faults=None, postmortem_dir=None,
                           call_timeout_s: float = 60.0,
                           shed_spike_threshold: int = 4):
    """Process-isolated serving front end, the network sibling of
    :func:`make_serving_fleet`. Each address in ``addresses`` points at
    a replica server process (spawn them with
    ``python -m paddle_tpu_torch.serving.fleet.net.replica_server`` or
    :func:`paddle_tpu_torch.serving.fleet.net.spawn_replica_server`);
    this connects a :class:`~paddle_tpu_torch.serving.fleet.net.NetReplica`
    to each and fronts them with the same
    :class:`~paddle_tpu_torch.serving.fleet.FleetRouter` the in-process
    fleet uses: the same routing, breakers, exactly-once redrive and
    migration, since the router sees only the ``ReplicaHandle`` contract.
    A dead process shows up as transport errors that trip its breaker and
    eject it; wrap the router in a
    :class:`~paddle_tpu_torch.serving.fleet.net.FrontDoor` to stream
    tokens to clients. Returns the router."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serving import fleet
    from paddle_tpu_torch.serving.fleet import net
    registry = registry or obs.default()
    tracer = tracer or obs.tracing.default()
    reps = [net.NetReplica(addr, call_timeout_s=call_timeout_s,
                           registry=registry)
            for addr in addresses]
    return fleet.FleetRouter(reps, policy=policy, registry=registry,
                             tracer=tracer, seed=seed, faults=faults,
                             postmortem_dir=postmortem_dir,
                             shed_spike_threshold=shed_spike_threshold)
