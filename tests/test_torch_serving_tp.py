"""Tensor-parallel serving of the port against the JAX tp engine
(``tests/test_serving_tp.py``'s greedy-parity classes): the port's engine
on gloo groups of 2 and 4 spawned CPU ranks (``torch_tp_pool``; rank 0
leads, the others follow) over the JAX model's weights gives the JAX
tp engine's tokens and the port's tp=1 tokens exactly, over fp32 and int8
pools, with prefix sharing on and off and over shared-prefix traffic;
the prefill tier's Megatron MLP split hands off tokens equal to the
colocated engine's; ``quantize_kv(group=)`` is bitwise the global call
and JAX's ``psum_axis`` under ``shard_map``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from paddle_tpu import observability as jax_obs
from paddle_tpu import serving as jax_serving
from paddle_tpu.core.compat import shard_map
from paddle_tpu.core.mesh import MeshConfig as JaxMeshConfig
from paddle_tpu.core.mesh import make_mesh as jax_make_mesh
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.serving.paged_cache import quantize_kv as jax_quantize_kv
from paddle_tpu_torch.serving.paged_cache import quantize_kv
from torch_tp_pool import TpPool

torch.set_num_threads(2)

#: the reference tp tests' model and geometry
DIMS = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
            ffn_size=64, max_position=128)
GEOM = dict(num_slots=4, page_size=8, max_tokens_per_slot=64)
CASE_S = 60


@pytest.fixture(scope="module")
def pools():
    ps = {2: TpPool(2), 4: TpPool(4)}
    yield ps
    for p in ps.values():
        p.close()


@pytest.fixture(scope="module")
def weights():
    jmodel = JaxGPT(JaxGPTConfig.tiny(num_heads=4, hidden_size=32,
                                      max_position=128))
    assert all(getattr(jmodel.cfg, k) == v for k, v in DIMS.items())
    params = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, params, jax.device_get(params)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 128, n).astype(np.int32)
            for n in (9, 17, 30, 5, 21)]


def jax_run(weights, waves, cap=16, eos=7, **kw):
    jmodel, params, _ = weights
    eng = jax_serving.ServingEngine(jmodel, params, attn_impl="lax",
                                    registry=jax_obs.MetricsRegistry(),
                                    **{**GEOM, **kw})
    return [[np.asarray(t) for t in eng.generate_many(w, cap, eos_id=eos)]
            for w in waves], eng


def port_run(pools, weights, n, waves, cap=16, eos=7, report=(), **kw):
    res = pools[n].run("serve", timeout_s=CASE_S, params=weights[2],
                       dims=DIMS, engine_kw={**GEOM, **kw}, waves=waves,
                       cap=cap, eos=eos, report=report)
    return res


def assert_tokens(got, want, what):
    for wave_g, wave_w in zip(got, want):
        assert len(wave_g) == len(wave_w)
        for a, b in zip(wave_g, wave_w):
            np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.fixture(scope="module")
def tp1(pools, weights, prompts):
    """The port's tp=1 tokens (rank 0 alone) and the JAX tp=1 engine's."""
    got = port_run(pools, weights, 2, [prompts], tp=1)[0]["tokens"]
    want, _ = jax_run(weights, [prompts])
    assert_tokens(got, want, "port tp=1 vs JAX tp=1")
    return got


@pytest.mark.parametrize("tp", [2, 4])
def test_fp_tp_tokens_equal_jax_tp_and_port_tp1(pools, weights, prompts,
                                                tp1, tp):
    res = port_run(pools, weights, tp, [prompts],
                   report=("health", "builds", "all_reduces"))
    want, _ = jax_run(weights, [prompts], tp=tp)
    assert_tokens(res[0]["tokens"], want, f"port tp={tp} vs JAX tp={tp}")
    assert_tokens(res[0]["tokens"], tp1, f"port tp={tp} vs port tp=1")
    h = res[0]["health"]
    assert (h["tp"], h["mesh_devices"], h["tp_probe"]) == (tp, tp, False)
    # every rank built and ran the same signatures; one attention-output
    # all-reduce per layer on every rank, nothing else
    assert len({r["builds"] for r in res}) == 1
    counts = [r["all_reduces"] for r in res]
    assert all(c == counts[0] for c in counts)
    assert set(counts[0]) == {"attn_out"}
    assert counts[0]["attn_out"] % DIMS["num_layers"] == 0


def test_fp_tp2_sharing_off(pools, weights, prompts):
    base = port_run(pools, weights, 2, [prompts], tp=1,
                    prefix_sharing=False)[0]["tokens"]
    got = port_run(pools, weights, 2, [prompts],
                   prefix_sharing=False)[0]["tokens"]
    want, _ = jax_run(weights, [prompts], tp=2, prefix_sharing=False)
    assert_tokens(got, want, "sharing off: port tp=2 vs JAX tp=2")
    assert_tokens(got, base, "sharing off: port tp=2 vs port tp=1")


def test_fp_tp2_shared_prefix_traffic(pools, weights):
    """A publisher wave commits a shared system prompt's pages, then
    followers map them (and copy a borrowed tail on write): tp=2 equals
    tp=1 and the JAX tp=2 engine, and sharing engaged."""
    rng = np.random.default_rng(3)
    sys_prompt = rng.integers(1, 128, 19).astype(np.int32)
    reqs = [np.concatenate([sys_prompt,
                            rng.integers(1, 128, n).astype(np.int32)])
            for n in (4, 9, 2, 6)]
    waves = [[reqs[0]], reqs[1:]]
    base = port_run(pools, weights, 2, waves, tp=1)[0]["tokens"]
    res = port_run(pools, weights, 2, waves, report=("shared",))[0]
    want, jeng = jax_run(weights, waves, tp=2)
    assert_tokens(res["tokens"], want, "shared prefix: port vs JAX tp=2")
    assert_tokens(res["tokens"], base, "shared prefix: tp=2 vs tp=1")
    assert res["shared"] > 0
    assert res["shared"] == jeng.cache.shared_tokens_total


def test_int8_tp2_equals_jax_int8_tp2_and_port_int8_tp1(pools, weights,
                                                         prompts):
    base = port_run(pools, weights, 2, [prompts], tp=1, cache_dtype="int8",
                    report=("pages",))[0]
    res = port_run(pools, weights, 2, [prompts], cache_dtype="int8",
                   report=("pages", "all_reduces"))
    want, _ = jax_run(weights, [prompts], tp=2, cache_dtype=jnp.int8)
    assert_tokens(res[0]["tokens"], want, "int8: port tp=2 vs JAX tp=2")
    assert_tokens(res[0]["tokens"], base["tokens"],
                  "int8: port tp=2 vs port int8 tp=1")
    # the MAX-completed per-token scales keep the stored int8 rows
    # bit-identical to tp=1; the scale rows agree to the last ulp (deeper
    # layers' inputs carry the all-reduce's summation order)
    for li, whole in enumerate(base["pages"]):
        for j in (0, 1):
            joined = np.concatenate([r["pages"][li][j] for r in res], axis=2)
            np.testing.assert_array_equal(joined, whole[j])
        for j in (2, 3):
            for r in res:
                np.testing.assert_allclose(r["pages"][li][j], whole[j],
                                           rtol=1e-5, atol=1e-7)
    # one MAX all-reduce of K's and V's abs-max rows stacked per layer
    assert res[0]["all_reduces"]["kv_amax"] == \
        res[0]["all_reduces"]["attn_out"]


def test_prefill_tier_mlp_split_hands_off_the_colocated_tokens(
        pools, weights, prompts, tp1):
    res = pools[2].run("handoff", timeout_s=CASE_S, params=weights[2],
                       dims=DIMS, engine_kw=GEOM, prompts=prompts)
    r0 = res[0]
    assert r0["mlp_sharded"] and not r0["decode_mlp_sharded"]
    for a, b in zip(r0["tokens"], tp1[0]):
        np.testing.assert_array_equal(a, b)
    # the prefill tier closes the MLP with a second all-reduce per layer
    pre = r0["prefill_all_reduces"]
    assert pre["mlp"] == pre["attn_out"] > 0
    assert "mlp" not in r0["decode_all_reduces"]


@pytest.mark.parametrize("n", [2, 4])
def test_quantize_kv_group_is_bitwise_the_global_call(pools, n):
    x = np.random.default_rng(n).standard_normal((3, 8, 16)).astype(
        np.float32) * np.linspace(0.1, 4.0, 8, dtype=np.float32)[:, None]
    res = pools[n].run("quantize", timeout_s=30, x=x)
    qg, sg = quantize_kv(torch.from_numpy(x), (1, 2))
    joined = np.concatenate([r[0] for r in res], axis=1)
    np.testing.assert_array_equal(joined, qg.numpy())
    for r in res:
        np.testing.assert_array_equal(r[1], sg.numpy())
    # without the group each rank's scale covers only its heads
    assert any(not np.array_equal(r[2], sg.numpy()) for r in res)
    # and JAX's psum_axis under shard_map gives the same bits
    mesh = jax_make_mesh(JaxMeshConfig(tp=n), devices=jax.devices()[:n])
    qs, ss = shard_map(
        lambda xl: jax_quantize_kv(xl, (1, 2), psum_axis="tp"),
        mesh=mesh, in_specs=JP(None, "tp", None),
        out_specs=(JP(None, "tp", None), JP()), check_vma=False)(
            jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(qs), joined)
    np.testing.assert_array_equal(np.asarray(ss), res[0][1])
