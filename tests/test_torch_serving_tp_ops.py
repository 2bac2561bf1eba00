"""Tensor-parallel serving of the port, the operational side
(``tests/test_serving_tp.py``'s steady-state, migration and config
classes) on gloo groups of 2 spawned CPU ranks (``torch_tp_pool``):
``warmup_plan()`` and ``reachable_signatures()`` equal the JAX tp
engine's, a warmed tp engine builds nothing more and every rank built
the same signatures; ``health()``; the refusals; the one-shard probe
engine; the collective probe's anatomy records through both validators;
a mid-decode drain with per-(page, tp shard) digests, a JAX tp=2
snapshot restored into the port's group and a port one into the JAX
engine, corrupt and cross-tp restores refused; a fleet counting a tp
replica's chips; and a follower's failure surfacing on rank 0."""

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
from paddle_tpu_torch.serving import SlotMigrationError
from paddle_tpu_torch.serving.engine import check_tp_graphs
from torch_tp_pool import TpPool

torch.set_num_threads(2)

DIMS = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
            ffn_size=64, max_position=128)
GEOM = dict(num_slots=4, page_size=8, max_tokens_per_slot=64)
MIG = dict(num_slots=2, page_size=8, max_tokens_per_slot=96)
CASE_S = 60


@pytest.fixture(scope="module")
def pool():
    p = TpPool(2)
    yield p
    p.close()


@pytest.fixture(scope="module")
def weights():
    jmodel = JaxGPT(JaxGPTConfig.tiny(num_heads=4, hidden_size=32,
                                      max_position=128))
    params = jmodel.init(jax.random.PRNGKey(0))
    host = jax.device_get(params)
    port = GPT.from_jax(GPTConfig(**DIMS), host, device="cpu")
    return jmodel, params, host, port


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 128, n).astype(np.int32)
            for n in (9, 17, 30, 5, 21)]


def jax_engine(weights, **kw):
    jmodel, params = weights[:2]
    return jax_serving.ServingEngine(jmodel, params, attn_impl="lax",
                                     registry=jax_obs.MetricsRegistry(),
                                     **{**GEOM, **kw})


def port_engine(weights, **kw):
    return make_serving_engine(weights[3], device="cpu",
                               registry=obs.MetricsRegistry(),
                               **{**GEOM, **kw})


# -- steady state -------------------------------------------------------------

@pytest.fixture(scope="module")
def warmed(pool, weights, prompts):
    """A warmed tp=2 engine (32-token slots) serving the short prompts,
    and the JAX tp=2 engine of the same geometry."""
    small = [p for p in prompts if len(p) <= 24]
    res = pool.run("serve", timeout_s=CASE_S, params=weights[2], dims=DIMS,
                   engine_kw={**GEOM, "max_tokens_per_slot": 32},
                   waves=[small], cap=8, warm=True,
                   report=("plan", "recompiles", "builds", "health"))
    return res, jax_engine(weights, tp=2, max_tokens_per_slot=32)


def test_warmup_plan_and_reachable_signatures_equal_the_jax_tp_engine(
        warmed):
    res, jeng = warmed
    plan, reachable, built = res[0]["plan"]
    assert plan == jeng.warmup_plan()
    assert set(reachable) == jeng.reachable_signatures()
    assert set(plan) >= set(reachable)
    assert set(built) == set(plan)
    assert any(sig[0] == "decode_probe" for sig in plan)


def test_warmed_tp_engine_builds_nothing_more(warmed):
    res, _ = warmed
    plan = res[0]["plan"][0]
    assert res[0]["recompiles"] == 0
    assert res[0]["builds"] == len(plan)
    # the collective probe's twin lives on rank 0 only
    assert res[1]["builds"] == len([s for s in plan
                                    if s[0] != "decode_probe"])


def test_health_reports_the_mesh_shape(warmed):
    h = warmed[0][0]["health"]
    assert (h["tp"], h["mesh_devices"], h["tp_probe"]) == (2, 2, False)


def test_collective_probe_lands_anatomy_records_both_validators_pass(
        pool, weights, prompts):
    res = pool.run("serve", timeout_s=CASE_S, params=weights[2], dims=DIMS,
                   engine_kw={**GEOM, "anatomy_probe_every": 1},
                   waves=[prompts[:3]], report=("anatomy",))
    recs, summary = res[0]["anatomy"]
    probed = [r for r in recs if "collective_exposed_s" in r]
    assert probed and all(r["probe_wall_s"] > 0 for r in probed)
    assert obs.validate_anatomy_records(recs) == len(recs)
    assert jax_obs.validate_anatomy_records(recs) == len(recs)
    assert summary["probe_samples"] == len(probed)
    assert 0.0 <= summary["collective_exposed_frac"] <= 1.0
    # the JAX tp engine samples the same decode rounds
    jeng = jax_engine(weights, tp=2, anatomy_probe_every=1)
    jeng.generate_many(prompts[:3], 16, eos_id=7)
    jsum = jeng.anatomy.summary()
    assert sorted(summary) == sorted(jsum)
    assert summary["probe_samples"] == jsum["probe_samples"]


# -- configuration ------------------------------------------------------------

def test_tp_must_divide_heads(weights):
    with pytest.raises(ValueError, match="divide num_heads"):
        port_engine(weights, tp=3)


def test_tp_refuses_speculative(weights):
    with pytest.raises(ValueError, match="speculative"):
        port_engine(weights, tp=2, draft_model=weights[3])


def test_tp_without_a_mesh_or_a_group_is_refused(weights):
    with pytest.raises(ValueError, match="needs a mesh"):
        port_engine(weights, tp=2)


def test_mesh_tp_disagreement_refused(pool, weights):
    res = pool.run("refuse_mesh_tp", timeout_s=30, params=weights[2],
                   dims=DIMS)
    assert all(msg is not None and "disagrees" in msg for msg in res)


def test_graphed_tp_engines_are_refused_but_probes_graph():
    """Collectives are not captured in the step graphs: a tp engine on
    the card with ``cuda_graphs=True`` raises, naming the ROADMAP item;
    the probe engine (no collectives) and tp=1 graph."""
    with pytest.raises(ValueError, match="NCCL across cards"):
        check_tp_graphs(2, False, True)
    check_tp_graphs(2, True, True)
    check_tp_graphs(1, False, True)
    check_tp_graphs(2, False, False)


def test_probe_engine_is_local(weights, prompts):
    eng = port_engine(weights, tp=2, tp_probe=True)
    h = eng.health()
    assert h["tp"] == 2 and h["tp_probe"] is True
    assert h["mesh_devices"] == 1
    assert eng.cache.local_heads == DIMS["num_heads"] // 2
    outs = eng.generate_many(prompts[:2], 16)
    assert all(len(t) == 16 for t in outs)
    # the reference's probe engine has the same shape of pool and plan
    jeng = jax_engine(weights, tp=2, tp_probe=True)
    assert eng.warmup_plan() == jeng.warmup_plan()
    assert eng.health()["mesh_devices"] == jeng.health()["mesh_devices"]


# -- migration ----------------------------------------------------------------

@pytest.fixture(scope="module")
def migration(pool, weights):
    rng = np.random.default_rng(1)
    prompt = rng.integers(1, 128, 21).astype(np.int32)
    jeng = jax_engine(weights, tp=2, **MIG)
    jeng.submit(prompt, 40)
    for _ in range(2):
        jeng.step()
    jsnap = jeng.snapshot_slot(0)
    res = pool.run("migrate", timeout_s=CASE_S, params=weights[2], dims=DIMS,
                   engine_kw=MIG, prompt=prompt, new_tokens=40,
                   jax_snap=jsnap, corrupt=True)[0]
    return prompt, jsnap, res


def test_mid_decode_drain_carries_one_shard_per_page_and_tp_shard(
        migration, weights):
    prompt, _, res = migration
    snap = res["snap"]
    assert snap["geometry"]["tp"] == 2
    assert sorted({m["tp_shard"] for m in snap["manifest"]}) == [0, 1]
    assert [m["tp_shard"] for m in snap["manifest"]] == \
        [0, 1] * (len(snap["manifest"]) // 2)
    assert all(np.asarray(s).shape[3] == DIMS["num_heads"] // 2
               for s in snap["shards"])
    # the restored pages read back to the carried bytes, per shard
    assert res["again"] == [m["sha256"] for m in snap["manifest"]]
    np.testing.assert_array_equal(res["tokens"], res["clean"])
    want = jax_engine(weights, tp=2, **MIG).generate_many([prompt], 40)[0]
    np.testing.assert_array_equal(res["clean"], want)


def test_jax_tp_snapshot_restores_into_the_port_group_and_back(migration,
                                                               weights):
    prompt, jsnap, res = migration
    jwant = jax_engine(weights, tp=2, **MIG).generate_many([prompt], 40)[0]
    # JAX -> port: same tokens; the re-snapshot carries the same digests
    np.testing.assert_array_equal(res["jax_tokens"], jwant)
    assert [r["sha256"] for r in res["jax_again"]["manifest"]] == \
        [r["sha256"] for r in jsnap["manifest"]]
    # port -> JAX: the port's tp=2 snapshot resumes on the JAX tp engine
    jdst = jax_engine(weights, tp=2, **MIG)
    rid = jdst.restore_slot(res["snap"])
    again = jdst.snapshot_slot(0)
    assert [r["sha256"] for r in again["manifest"]] == \
        [r["sha256"] for r in res["snap"]["manifest"]]
    done = {}
    while not jdst.scheduler.idle():
        done.update(jdst.step())
    np.testing.assert_array_equal(done[rid], res["clean"])


def test_corrupt_and_cross_tp_restores_are_refused(migration, weights):
    _, _, res = migration
    kind, msg = res["corrupt"]
    assert kind == "SlotMigrationError" and "sha256 mismatch" in msg
    assert res["pages_unchanged"]
    # a tp=1 engine refuses the tp=2 shard layout outright
    dst = port_engine(weights, **MIG)
    with pytest.raises(SlotMigrationError, match="geometry mismatch"):
        dst.restore_slot(res["snap"])
    assert dst.cache.pages_in_use == 0


# -- the fleet and failures ---------------------------------------------------

def test_fleet_router_counts_a_tp_replicas_chips(pool, weights):
    res = pool.run("fleet_chips", timeout_s=CASE_S, params=weights[2],
                   dims=DIMS)[0]
    assert res["chips_total"] == 3
    assert res["per"] == {"tp": 2, "plain": 1}


def test_a_failing_follower_surfaces_on_rank_0(pool, weights):
    """A follower raises at its second device call and its process exits:
    rank 0's pending call re-raises the follower's traceback at once
    instead of waiting out the group's timeout."""
    res = pool.run("follower_fails", timeout_s=CASE_S, expect_errors=True,
                   params=weights[2], dims=DIMS)
    assert "injected follower fault" in res[1]
    assert res[0]["error"] == "TpFollowerError"
    assert "injected follower fault" in res[0]["text"]
    assert res[0]["s"] < 15
