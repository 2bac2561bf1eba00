"""The serving engine's observability, held against the JAX engine on the
CPU: the same seeded weights and prompts go through both engines, each
with a tracer and a TTFT budget, stepped in lockstep. Per-request
``request_stats`` counts are equal, and so are the span names and the
event names of every request's trace (a shed request included), the
``health()`` snapshot after every step (same keys; count-valued entries
equal), and the anatomy records' step ids, tokens and phases; the port's
anatomy records and flight-recorder bundles pass both packages'
validators. The burn-rate monitor gives the reference's burn and alert
sequence on the same observations, and the exposition server answers
``/metrics`` and ``/healthz`` on an ephemeral port."""

import collections
import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from paddle_tpu import observability as jax_obs
from paddle_tpu import serving as jax_serving
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.inference import make_serving_engine
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.serving import LoadShedError

torch.set_num_threads(2)

DIMS = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
            ffn_size=32, max_position=32)
KW = dict(num_slots=3, page_size=4, prefill_chunk=8, max_queue_depth=4)
#: stats that count (the rest are wall-clock seconds and trace ids)
COUNTS = ("prefill_chunks", "decode_blocks", "shared_tokens", "tokens",
          "spec_proposed", "spec_accepted")
#: health entries measured in seconds: the SLO monitor's burn rates
#: follow wall-clock windows and TTFTs, which differ between engines
TIMED = ("burn_fast", "burn_slow")


@pytest.fixture(scope="module")
def target():
    jmodel = JaxGPT(JaxGPTConfig.tiny(dropout=0.0, attn_impl="xla", **DIMS))
    params = jmodel.init(jax.random.PRNGKey(3))
    return jmodel, params, GPT.from_jax(GPTConfig(**DIMS),
                                        jax.device_get(params), device="cpu")


def _prompts():
    rng = np.random.default_rng(11)
    shared = rng.integers(1, 64, 9).astype(np.int32)
    return [np.concatenate([shared, rng.integers(1, 64, n).astype(np.int32)])
            for n in (3, 6, 1, 5)] + [shared.copy()]


def _untimed(h):
    return {k: (_untimed(v) if isinstance(v, dict) else v)
            for k, v in h.items() if k not in TIMED}


def _serve(eng, prompts, shed):
    """Submit, step to idle recording health after every step, submit
    the tail after the head has published its prefix; returns rids,
    per-step health and whether the extra submit was shed."""
    rids = [eng.submit(p, 6) for p in prompts[:4]]
    shed_seen = False
    try:
        eng.submit(prompts[0], 6)     # queue depth 4: shed at submit
    except (LoadShedError, jax_serving.LoadShedError):
        shed_seen = True
    assert shed_seen == shed
    healths = []
    while not eng.scheduler.idle():
        eng.step()
        healths.append(_untimed(eng.health()))
    rids.append(eng.submit(prompts[4], 6))   # a prefix hit + a CoW copy
    while not eng.scheduler.idle():
        eng.step()
        healths.append(_untimed(eng.health()))
    return rids, healths


def _traces(tracer):
    """Per request (by rid): root span events and child span names; the
    shed spans' verdicts; span counts by name over the whole ring."""
    spans = tracer.spans()
    by_id = {s.span_id: s for s in spans}
    per_req = {}
    for s in spans:
        if s.name == "serving.request" and "rid" in s.attrs:
            per_req[s.attrs["rid"]] = {
                "events": [e[1] for e in s.events],
                "children": collections.Counter(),
                "status": s.status}
    for s in spans:
        parent = by_id.get(s.parent_id)
        if parent is not None and parent.name == "serving.request":
            per_req[parent.attrs["rid"]]["children"][s.name] += 1
    sheds = [(s.status, s.attrs.get("shed_reason")) for s in spans
             if s.name == "serving.request" and "rid" not in s.attrs]
    return per_req, sheds, collections.Counter(s.name for s in spans)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "speculative"])
def test_engine_observability_matches_the_reference(target, spec):
    jmodel, params, model = target
    jtr, ptr = jax_obs.tracing.Tracer(), obs.Tracer()
    jkw = dict(draft_model=jmodel, draft_params=params) if spec else {}
    ref = jax_serving.ServingEngine(
        jmodel, params, attn_impl="lax", spec_k=3, ttft_budget_s=4.0,
        tracer=jtr, registry=jax_obs.MetricsRegistry(), **KW, **jkw)
    preg = obs.MetricsRegistry()
    eng = make_serving_engine(
        model, device="cpu", spec_k=3, ttft_budget_s=4.0, tracer=ptr,
        registry=preg, draft_model=model if spec else None, **KW)
    ref.warmup(cost_gauges=False)
    eng.warmup()
    assert set(eng.health()) == set(ref.health())
    prompts = _prompts()
    jrids, jhealth = _serve(ref, prompts, shed=True)
    prids, phealth = _serve(eng, prompts, shed=True)
    assert prids == jrids
    assert phealth == jhealth
    assert phealth[-1]["recompiles"] == 0 and phealth[-1]["steps"] > 0
    assert set(phealth[-1]["headroom"]) == set(ref.health()["headroom"])
    for r in prids:
        got, want = eng.request_stats(r), ref.request_stats(r)
        assert set(got) <= set(want)
        assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}
        assert got["trace_id"] > 0
        assert got["ttft_s"] >= got["prefill_s"] >= 0
    # the late request shared the published prefix and copied its tail
    # (speculation turns sharing off)
    assert (preg.counter("serving_prefix_cow_total").value() > 0) == \
        (not spec)
    assert _traces(ptr) == _traces(jtr)
    # anatomy: the same steps, tokens and phases; both validators pass
    precs, jrecs = eng.anatomy.records(), ref.anatomy.records()
    assert [(r["step"], r["tokens"], sorted(r["phases"])) for r in precs] \
        == [(r["step"], r["tokens"], sorted(r["phases"])) for r in jrecs]
    assert obs.validate_anatomy_records(precs) == len(precs) > 0
    assert jax_obs.validate_anatomy_records(precs) == len(precs)
    assert sorted(eng.anatomy.summary()) == sorted(
        k for k in ref.anatomy.summary() if k != "probe_samples")
    # a postmortem bundle passes both validators
    bundle = eng.flight.dump("eject", trace_ids=[1, 2])
    obs.validate_postmortem_bundle(bundle)
    jax_obs.validate_postmortem_bundle(json.loads(json.dumps(bundle)))
    assert bundle["anatomy"] and bundle["snapshots"]


def test_burn_rate_monitor_matches_the_reference():
    clock = [0.0]
    regs = (obs.MetricsRegistry(), jax_obs.MetricsRegistry())
    buckets = (0.1, 0.5, 1.0, 2.0)
    hists = [r.histogram("ttft", buckets=buckets) for r in regs]
    mons = [mod.BurnRateMonitor("ttft", 0.5, windows=(10.0, 40.0),
                                registry=r, clock=lambda: clock[0])
            for mod, r in ((obs, regs[0]), (jax_obs, regs[1]))]
    rng = np.random.default_rng(4)
    seqs = ([], [])
    for t in range(120):
        clock[0] = float(t)
        # a calm minute, a burst of violations, then recovery
        bad = 0.9 if 40 <= t < 70 else 0.005
        for v in np.where(rng.random(5) < bad, 1.5, 0.05):
            for h in hists:
                h.observe(float(v))
        for seq, mon in zip(seqs, mons):
            seq.append((mon.check(), mon.alerting(), mon.alerts_total))
    assert seqs[0] == seqs[1]
    assert mons[0].alerts_total > 0
    assert mons[0].status() == mons[1].status()


def test_exposition_serves_metrics_and_health(target):
    _, _, model = target
    eng = make_serving_engine(model, device="cpu", tracer=obs.Tracer(),
                              registry=obs.MetricsRegistry(), **KW)
    eng.generate_many(_prompts()[:2], 3)
    srv = eng.start_exposition()
    try:
        with urllib.request.urlopen(f"{srv.url}/metrics", timeout=10) as r:
            assert r.status == 200
            text = r.read().decode()
        assert "# TYPE serving_tokens_total counter" in text
        assert "serving_ttft_seconds_bucket" in text
        with urllib.request.urlopen(f"{srv.url}/healthz", timeout=10) as r:
            assert r.status == 200
            body = json.loads(r.read())
        assert body["status"] == "ok"
        assert body["providers"]["serving"]["recompiles"] == \
            eng.health()["recompiles"]
        with urllib.request.urlopen(f"{srv.url}/traces?limit=3",
                                    timeout=10) as r:
            assert json.loads(r.read())["count"] == 3
    finally:
        srv.stop()
