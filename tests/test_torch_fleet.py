"""The port's serving fleet (``paddle_tpu_torch.serving.fleet``) held
against the JAX package's on the CPU, over the same weights, prompts and
router seeds: the same placement sequence (replica and affinity pages per
request) under ``affinity``, ``p2c`` and ``round_robin``; bitwise-equal
tokens per fleet rid; a mid-decode ``drain_replica`` equal to the
undrained run; router-minted trace ids in the replicas'
``request_stats``; the autoscaler's actions under an injected clock; the
``FleetMonitor`` gauge names; a two-tier fleet's prefill placement by
flops headroom; and the port's analytic bucket costs in the reference
cost model's ratios."""

import numpy as np
import pytest

from torch_fleet_pairs import GEOM, PACKAGES, VOCAB, Pair, prompts, where

POLICIES = ("affinity", "p2c", "round_robin")


@pytest.fixture(scope="module")
def pair():
    return Pair()


def shared_prefix_waves(seed=3):
    """Two waves sharing a 3-page system prompt, then unrelated prompts:
    the first wave publishes the prefix, the second finds it."""
    rng = np.random.default_rng(seed)
    sysp = rng.integers(1, VOCAB, 3 * GEOM["page_size"]).astype(np.int32)

    def wave(n):
        return [np.concatenate([sysp, rng.integers(
            1, VOCAB, int(rng.integers(2, 6))).astype(np.int32)])
            for _ in range(n)]
    return wave(3), wave(6) + prompts(4, seed=seed + 1, lo=4, hi=12)


_RUNS = {}


def routed_run(pair, pkg, policy):
    """Both waves through a 3-replica fleet of ``pkg``; returns
    (placements as (replica, affinity pages), {frid: tokens}, counters)."""
    key = (pkg, policy)
    if key not in _RUNS:
        router, _ = pair.router(pkg, 3, policy=policy, seed=7)
        first, second = shared_prefix_waves()
        placed, frids = [], []
        for wave in (first, second):
            for p in wave:
                f = router.submit(p, 6)
                frids.append(f)
                placed.append((where(router, f),
                               router._reqs[f].affinity_pages))
            router.run_until_idle(max_steps=10_000)
        outs = {f: np.asarray(router.result(f)) for f in frids}
        _RUNS[key] = (placed, outs, (router.routed_affinity_total,
                                     router.routed_balance_total))
    return _RUNS[key]


@pytest.mark.parametrize("policy", POLICIES)
def test_placements_equal_the_reference(pair, policy):
    jplaced, _, jcount = routed_run(pair, "jax", policy)
    pplaced, _, pcount = routed_run(pair, "port", policy)
    assert pplaced == jplaced
    assert pcount == jcount
    if policy == "affinity":
        assert jcount[0] >= 6          # the second wave found its prefix
    else:
        assert jcount[0] == 0


@pytest.mark.parametrize("policy", POLICIES)
def test_tokens_per_fleet_rid_equal_the_reference(pair, policy):
    _, jouts, _ = routed_run(pair, "jax", policy)
    _, pouts, _ = routed_run(pair, "port", policy)
    assert list(pouts) == list(jouts)
    for f in jouts:
        np.testing.assert_array_equal(pouts[f], jouts[f])
        assert len(pouts[f]) == 6


def _step_until_mid_decode(router, rep, cap, max_steps=1000):
    eng = rep.engine
    for _ in range(max_steps):
        router.step()
        if any(0 < len(eng.scheduler.slots[i].generated) < cap
               for i in eng.scheduler.decode_slots()):
            return
    raise AssertionError("no mid-decode window reached")


def test_drain_mid_decode_equals_the_undrained_run(pair):
    rng = np.random.default_rng(9)
    ps = [rng.integers(1, VOCAB, int(n)).astype(np.int32)
          for n in (5, 9, 6, 11)]
    got = {}
    for pkg in ("jax", "port"):
        ref_router, _ = pair.router(pkg, 2, seed=1, decode_block=4)
        ref_frids = [ref_router.submit(p, 16) for p in ps]
        ref_router.run_until_idle(max_steps=10_000)
        ref = [ref_router.result(f) for f in ref_frids]
        router, reps = pair.router(pkg, 2, seed=1, decode_block=4)
        frids = [router.submit(p, 16) for p in ps]
        _step_until_mid_decode(router, reps[1], 16)
        migrated = router.drain_replica(reps[1])
        assert migrated > 0 and len(router.replicas) == 1
        router.run_until_idle(max_steps=10_000)
        outs = [router.result(f) for f in frids]
        for want, have in zip(ref, outs):
            np.testing.assert_array_equal(have, want)
        assert router.migrations_total == migrated
        got[pkg] = (migrated, outs)
    assert got["port"][0] == got["jax"][0]
    for a, b in zip(got["port"][1], got["jax"][1]):
        np.testing.assert_array_equal(a, b)


def test_router_trace_ids_reach_request_stats(pair):
    for pkg in ("jax", "port"):
        pobs, _ = PACKAGES[pkg]
        tracer = pobs.Tracer()
        router, _ = pair.router(pkg, 2, tracer=tracer, seed=2)
        frids = [router.submit(p, 4) for p in prompts(4, seed=2)]
        router.run_until_idle(max_steps=10_000)
        routed = {s.attrs["fleet_rid"]: s.trace_id for s in tracer.spans()
                  if s.name == "router.route"}
        for f in frids:
            st = router.request_stats(f)
            assert st["trace_id"] == float(routed[f]) > 0
        # the replica's request span rides the router's trace
        roots = {s.trace_id for s in tracer.spans()
                 if s.name == "serving.request"}
        assert set(routed.values()) <= roots


def _fake_replica_cls(pfleet):
    class FakeReplica(pfleet.ReplicaHandle):
        def __init__(self, name, burn=0.0):
            self.name = name
            self.burn = burn
            self.closed = False
            self.warmed = False

        def page_size(self):
            return 4

        def prefix_digests(self):
            return frozenset()

        def health(self):
            return {"queue_depth": 0, "requests_in_flight": 0,
                    "slot_occupancy": 0.0, "page_utilization": 0.0,
                    "free_slots": 4,
                    "slo": {"burn_fast": self.burn,
                            "burn_slow": self.burn}}

        def idle(self):
            return True

        def step(self):
            return {}

        def warmup(self):
            self.warmed = True
            return self

        def drain_queue(self):
            return []

        def snapshot_inflight(self):
            return []

        def close(self):
            self.closed = True
    return FakeReplica


#: (clock, burn of the base replica) per tick: a spike that fades, a
#: sustained burn that scales out twice (cooldown between), then idle
#: long enough to scale back in to the floor
TICKS = [(0.0, 20.0), (0.5, 0.0), (3.0, 0.0), (4.0, 20.0), (5.0, 20.0),
         (6.5, 20.0), (7.0, 20.0), (10.0, 20.0), (12.0, 20.0),
         (13.0, 0.0), (18.5, 0.0), (22.0, 0.0), (27.5, 0.0), (40.0, 0.0)]


def test_autoscaler_takes_the_reference_actions(pair):
    seen = {}
    for pkg in ("jax", "port"):
        pobs, pfleet = PACKAGES[pkg]
        fake = _fake_replica_cls(pfleet)
        clock = [0.0]
        spawned = []

        def spawn(i):
            spawned.append(fake(f"auto{i}"))
            return spawned[-1]
        scaler = pfleet.FleetAutoscaler(
            spawn, min_replicas=1, max_replicas=3, scale_out_burn=6.0,
            sustain_s=2.0, idle_s=5.0, cooldown_s=3.0,
            registry=pobs.MetricsRegistry(), clock=lambda: clock[0])
        base = fake("base")
        router = pfleet.FleetRouter([base], policy="p2c",
                                    registry=pobs.MetricsRegistry(),
                                    autoscaler=scaler)
        actions = []
        for t, burn in TICKS:
            clock[0] = t
            base.burn = burn
            actions.append((scaler.tick(), len(router.replicas)))
        assert all(r.warmed for r in spawned)
        seen[pkg] = (actions, [e["action"] for e in scaler.events],
                     scaler.scale_outs, scaler.scale_ins)
    assert seen["port"] == seen["jax"]
    assert seen["jax"][2] >= 1 and seen["jax"][3] >= 1


def test_real_fleet_idle_scale_in_migrates_like_the_reference(pair):
    seen = {}
    for pkg in ("jax", "port"):
        pobs, pfleet = PACKAGES[pkg]
        clock = [0.0]
        scaler = pfleet.FleetAutoscaler(
            lambda i: None, min_replicas=1, max_replicas=2,
            idle_occupancy=1.0, idle_s=0.0, cooldown_s=0.0,
            registry=pobs.MetricsRegistry(), clock=lambda: clock[0])
        router, _ = pair.router(pkg, 2, seed=12, autoscaler=scaler)
        rng = np.random.default_rng(12)
        frids = [router.submit(rng.integers(1, VOCAB, 5).astype(np.int32),
                               12) for _ in range(2)]
        out = router.run_until_idle(max_steps=10_000)
        assert set(out) == set(frids) and len(router.replicas) == 1
        seen[pkg] = ([e["action"] for e in scaler.events],
                     router.migrations_total,
                     [np.asarray(out[f]).tolist() for f in frids])
    assert seen["port"] == seen["jax"]


def test_fleet_monitor_publishes_the_reference_gauges(pair):
    names = {}
    for pkg in ("jax", "port"):
        pobs, pfleet = PACKAGES[pkg]
        reg = pobs.MetricsRegistry()
        reps = pair.replicas(pkg, 2, names="m", ttft_budget_s=4.0)
        router = pfleet.FleetRouter(reps, registry=reg)
        mon = pfleet.FleetMonitor(router, registry=reg)
        for p in prompts(3, seed=13):
            router.submit(p, 4)
        router.step()
        first = mon.collect()
        router.run_until_idle(max_steps=10_000)
        h = mon.collect()
        assert h["requests_in_flight"] == 0
        names[pkg] = (sorted(n for n in reg.snapshot()
                             if n.startswith("fleet_")),
                      sorted(first), sorted(h["headroom"]))
    assert names["port"] == names["jax"]


def test_two_prefill_replicas_share_prompts_by_flops_headroom(pair):
    """A two-tier fleet places a fresh prompt on the prefill replica
    with the most flops headroom: once one has run a priced prefill, the
    next prompt goes to the other (with every headroom pinned at 1.0 it
    would stay on the first)."""
    placed = {}
    for pkg in ("jax", "port"):
        pobs, pfleet = PACKAGES[pkg]
        reps = (pair.replicas(pkg, 2, names="p", tier="prefill",
                              cost_gauges=True)
                + pair.replicas(pkg, 1, names="d", tier="decode",
                                cost_gauges=True))
        router = pfleet.FleetRouter(reps, policy="p2c",
                                    registry=pobs.MetricsRegistry())
        ps = prompts(2, seed=21)
        frids, order, out = [], [], {}
        for p in ps:
            frids.append(router.submit(p, 6))
            order.append(where(router, frids[-1]))
            out.update(router.step())
        heads = [r.health()["headroom"]["flops"] for r in reps[:2]]
        out.update(router.run_until_idle(max_steps=10_000))
        assert set(out) == set(frids)
        placed[pkg] = (order, heads[0] < 1.0, heads[1] < 1.0)
    assert placed["port"] == placed["jax"] == (["p0", "p1"], True, True)


#: largest relative gap, measured on this tiny model, between the port's
#: analytic cost ratios and the reference cost model's: 0.024
COST_RATIO_RTOL = 0.03


def test_bucket_cost_ratios_follow_the_reference_cost_model(pair):
    jeng, peng = pair.jax_engine(), pair.port_engine()
    jeng.warmup()
    peng.warmup()
    base = ("prefill", 1, 1)
    assert set(jeng.bucket_costs) <= set(peng.bucket_costs)
    for sig, cost in jeng.bucket_costs.items():
        want = cost.total_flops / jeng.bucket_costs[base].total_flops
        got = (peng.bucket_costs[sig].total_flops
               / peng.bucket_costs[base].total_flops)
        assert got == pytest.approx(want, rel=COST_RATIO_RTOL), sig
