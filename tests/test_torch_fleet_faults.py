"""The port's fleet fault machinery held against the JAX package's on the
CPU: ``chaos_schedule`` draws the same schedule from the same seed,
``CircuitBreaker``s walk the same transitions under the same clock, and
an ejected replica's requests are redriven to the same bit-identical
tokens as a failure-free run, cold (resubmitting ``prompt + observed``)
and warm (a micro-snapshot restored on a peer), or shed with the same
reasons (``redrive_budget``, ``deadline_expired``, ``no_replica``)."""

import numpy as np
import pytest

from torch_fleet_pairs import PACKAGES, Pair, drain, prompts

PKGS = ("jax", "port")


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module")
def pair():
    return Pair()


def faults(pkg, **kw):
    kw.setdefault("max_consecutive_failures", 1)
    kw.setdefault("probe_timeout_s", 30.0)
    return PACKAGES[pkg][1].FaultPolicy(**kw)


_REFS = {}


def reference(pair, ps, cap):
    """Failure-free tokens of the port engine (one warmed engine,
    reused: ``generate_many`` leaves it idle)."""
    eng = _REFS.get("port")
    if eng is None:
        eng = _REFS["port"] = pair.port_engine(num_slots=2, decode_block=2)
        eng.warmup()
    return eng.generate_many(ps, cap, max_steps=100_000)


@pytest.mark.parametrize("seed,n", [(0, 4), (7, 8), (123, 16)])
def test_chaos_schedule_draws_the_reference_schedule(seed, n):
    want = PACKAGES["jax"][1].chaos_schedule(seed, n)
    got = PACKAGES["port"][1].chaos_schedule(seed, n)
    assert [vars(s) for s in got] == [vars(s) for s in want]
    kw = dict(max_crash_step=5, p_crash=0.2, p_hang=0.6,
              max_submit_failures=1)
    assert [vars(s) for s in PACKAGES["port"][1].chaos_schedule(
        seed, n, **kw)] == [vars(s) for s in PACKAGES["jax"][1]
                            .chaos_schedule(seed, n, **kw)]


#: breaker operations: failure, success, probe, or a clock advance
OPS = ["f", "f", "a1", "a4.5", "p", "f", "a0.4", "a5", "p", "s", "f", "s",
       "f", "f", "f", "a6", "p", "s"]


def test_circuit_breakers_walk_the_reference_transitions():
    seen = {}
    for pkg in PKGS:
        clk = FakeClock()
        fired = []
        b = PACKAGES[pkg][1].CircuitBreaker(
            threshold=2, cooldown_s=5.0, clock=clk,
            on_transition=lambda old, new, tid: fired.append((old, new,
                                                              tid)))
        states = []
        for i, op in enumerate(OPS):
            if op == "f":
                b.record_failure(i)
            elif op == "s":
                b.record_success(i)
            elif op == "p":
                b.note_probe()
            else:
                clk.advance(float(op[1:]))
            states.append((b.state, b.allow()))
        seen[pkg] = (states, b.transitions, fired)
    assert seen["port"] == seen["jax"]
    assert ("open", "half_open") in seen["jax"][1]


def _until_mid_decode(router, chaos, cap):
    for _ in range(500):
        router.step()
        eng = chaos.inner.engine
        if any(0 < len(eng.scheduler.slots[i].generated) < cap
               for i in eng.scheduler.decode_slots()):
            return
    raise AssertionError("chaos replica never held mid-decode work")


@pytest.mark.parametrize("mode", ["cold", "warm"])
def test_eject_and_redrive_give_the_failure_free_tokens(pair, mode):
    cap = 10 if mode == "cold" else 12
    ps = prompts(6 if mode == "cold" else 2, lo=3,
                 hi=9 if mode == "cold" else 5)
    want = reference(pair, ps, cap)
    kw = dict(num_slots=2, decode_block=2)
    if mode == "warm":
        kw["snapshot_every_blocks"] = 1
    seen = {}
    for pkg in PKGS:
        pobs, _ = PACKAGES[pkg]
        tracer = pobs.Tracer()
        router, reps = pair.router(pkg, 3 if mode == "cold" else 2,
                                   tracer=tracer, faults=faults(pkg),
                                   wrap={1 if mode == "cold" else 0: {}},
                                   **kw)
        chaos = reps[1 if mode == "cold" else 0]
        frids = [router.submit(p, cap) for p in ps]
        if mode == "cold":
            _until_mid_decode(router, chaos, cap)
        else:
            for _ in range(500):
                router.step()
                if any(rec.checkpoint is not None
                       for rec in router._reqs.values()):
                    break
            else:
                raise AssertionError("no micro-snapshot reached the router")
        chaos.dead = True
        outs, rejects = drain(router, frids)
        assert not rejects
        for f, w in zip(frids, want):
            np.testing.assert_array_equal(outs[f], w)
        assert chaos not in router.replicas and router.ejected_total == 1
        modes = sorted(s.attrs.get("mode") for s in tracer.spans()
                       if s.name == "router.redrive")
        assert mode in modes
        seen[pkg] = ([outs[f].tolist() for f in frids], modes,
                     router.redrives_total,
                     router._reg.counter("fleet_redrive_total").value(
                         mode=mode))
    assert seen["port"] == seen["jax"]


def _budget_shed(pair, pkg):
    router, reps = pair.router(pkg, 2, faults=faults(pkg, max_redrives=0),
                               num_slots=2, decode_block=2)
    frids = [router.submit(p, 6) for p in prompts(2, lo=3, hi=5)]
    router.step()
    router.eject_replica(reps[0], reason="crashed")
    return router, frids


def _deadline_shed(pair, pkg):
    clk = FakeClock()
    router, _ = pair.router(pkg, 2, faults=faults(pkg), clock=clk,
                            num_slots=2, decode_block=2)
    frid = router.submit(prompts(1)[0], 6, ttft_deadline_s=0.5)
    clk.advance(1.0)
    router.eject_replica(router._where[frid][0], reason="crashed")
    return router, [frid]


def _no_replica_shed(pair, pkg):
    router, reps = pair.router(pkg, 1, faults=faults(pkg), wrap={0: {}},
                               num_slots=2, decode_block=2)
    frids = [router.submit(p, 6) for p in prompts(3, lo=3, hi=5)]
    router.step()
    reps[0].dead = True
    return router, frids


@pytest.mark.parametrize("case,reason", [
    (_budget_shed, "redrive_budget"), (_deadline_shed, "deadline_expired"),
    (_no_replica_shed, "no_replica")],
    ids=["redrive_budget", "deadline_expired", "no_replica"])
def test_hopeless_redrives_shed_with_the_reference_reasons(pair, case,
                                                           reason):
    seen = {}
    for pkg in PKGS:
        router, frids = case(pair, pkg)
        outs, rejects = drain(router, frids)
        shed = router._reg.counter("fleet_redrive_shed_total")
        seen[pkg] = ({f: o.tolist() for f, o in outs.items()}, rejects,
                     {r: shed.value(reason=r) for r in set(
                         rejects.values())})
    assert seen["port"] == seen["jax"]
    assert seen["jax"][1], "the case must shed"
    assert set(seen["jax"][1].values()) == {reason}
