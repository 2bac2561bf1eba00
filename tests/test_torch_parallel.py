"""The port's parallelism layer (``paddle_tpu_torch.parallel``,
``core/mesh.py``) against the reference and numpy: meshes over gloo
groups of 2 and 4 spawned CPU ranks (``torch_tp_pool``), every collective
against its numpy result, the canned sharding plans' spec trees against
the JAX plans' on the same GPT and BERT trees, ``local_shard`` against
the shards ``jax.device_put`` places, the tp entry points' registry
contracts against the reference's, and the gloo backend's refusal of
ops it cannot run on CUDA tensors."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from paddle_tpu import kernels as jax_kernels
from paddle_tpu.core.mesh import MeshConfig as JaxMeshConfig
from paddle_tpu.core.mesh import make_mesh as jax_make_mesh
from paddle_tpu.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.models.bert import BertForPretraining as JaxBert
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.parallel import plan as jax_plan
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.core import mesh as mesh_lib
from paddle_tpu_torch.kernels import registry
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.parallel import collective as C
from paddle_tpu_torch.parallel import plan
from paddle_tpu_torch.serving import tp as tp_lib
from torch_tp_pool import TpPool, _local_input

torch.set_num_threads(2)

SEED = 3


@pytest.fixture(scope="module")
def pools():
    ps = {2: TpPool(2), 4: TpPool(4)}
    yield ps
    for p in ps.values():
        p.close()


# -- meshes -------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_make_mesh_names_every_axis_with_its_size(pools, n):
    got = pools[n].run("mesh_info", timeout_s=30)
    for rank, info in enumerate(got):
        assert info["names"] == mesh_lib.ALL_AXES
        assert info["shape"] == (1, 1, n, 1, 1, 1)
        assert info["sizes"] == dict(JaxMeshConfig(tp=n).axis_sizes())
        assert info["tp_index"] == rank
        assert "needs" in info["refused"]
        assert info["current"] and info["after"]


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh_lib.make_mesh(mesh_lib.MeshConfig(), device_type="cpu")


def test_single_device_mesh_and_device_counts():
    """``single_device_mesh`` names every canonical axis at size 1, as the
    reference's, over a one-rank group the caller starts (it starts
    none, so a process group can still be started after it);
    ``device_count``/``local_device_count`` count a rank as one device
    (the card it holds) and the cards this process sees."""
    import torch.distributed as dist
    from paddle_tpu.core import mesh as jax_mesh
    jm = jax_mesh.single_device_mesh()
    assert dist.is_initialized() is False
    assert mesh_lib.local_device_count() == (
        torch.cuda.device_count() if torch.cuda.is_available() else 1)
    assert mesh_lib.device_count() == mesh_lib.local_device_count()
    with pytest.raises(RuntimeError, match="initialized"):
        mesh_lib.single_device_mesh(device_type="cpu")
    assert dist.is_initialized() is False
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        m = mesh_lib.single_device_mesh(device_type="cpu")
        assert m.mesh_dim_names == tuple(jm.axis_names) == mesh_lib.ALL_AXES
        assert tuple(m.shape) == tuple(jm.devices.shape) == (1,) * 6
        assert mesh_lib.device_count() == dist.get_world_size() == 1
        with mesh_lib.mesh_context(m):
            x = torch.arange(4.0)
            assert torch.equal(C.all_reduce(x.clone(), "tp"), x)
            assert torch.equal(C.all_gather(x, "dp", tiled=False), x)
        dp = mesh_lib.make_mesh(device_type="cpu", axis_names=("dp",),
                                shape=(1,))
        assert dp.mesh_dim_names == ("dp",) and tuple(dp.shape) == (1,)
    finally:
        dist.destroy_process_group()
    assert jax_mesh.device_count() >= jax_mesh.local_device_count() >= 1


def test_mesh_config_matches_the_reference():
    for kw in ({}, {"tp": 2}, {"dp": 2, "tp": 4}, {"fsdp": 8}):
        ours, ref = mesh_lib.MeshConfig(**kw), JaxMeshConfig(**kw)
        assert ours.axis_sizes() == ref.axis_sizes()
        assert ours.size == ref.size
    assert mesh_lib.ALL_AXES == ("dp", "fsdp", "tp", "sp", "pp", "ep")


# -- collectives --------------------------------------------------------------

def _inputs(n):
    return [_local_input(SEED, r) for r in range(n)]


def _want(op, n):
    xs = _inputs(n)
    if op == "sum":
        return [np.sum(xs, 0)] * n
    if op == "sum_over_two_axes":
        return [np.sum(xs, 0)] * n
    if op == "max":
        return [np.max(xs, 0)] * n
    if op == "min":
        return [np.min(xs, 0)] * n
    if op == "prod":
        return [np.prod(xs, 0)] * n
    if op == "all_gather":
        return [np.concatenate(xs, 1)] * n
    if op == "all_gather_untiled":
        return [np.concatenate(xs, 1)] * n
    if op == "reduce_scatter":
        return list(np.split(np.sum(xs, 0), n, axis=0))
    if op == "broadcast":
        return [xs[n - 1]] * n
    if op == "all_to_all":
        return [np.concatenate([np.split(x, n, 0)[r] for x in xs], 1)
                for r in range(n)]
    if op == "ppermute":
        return [xs[(r - 1) % n] for r in range(n)]
    if op == "ppermute_partial":
        return [xs[0] if r == n - 1 else np.zeros_like(xs[0])
                for r in range(n)]
    if op == "barrier":
        return xs
    if op == "hierarchical":
        return [np.sum(xs, 0)] * n
    raise ValueError(op)


OPS = ["sum", "max", "min", "prod", "sum_over_two_axes", "all_gather",
       "all_gather_untiled", "reduce_scatter", "broadcast", "all_to_all",
       "ppermute", "ppermute_partial", "barrier"]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op", OPS)
def test_collective_matches_numpy(pools, op, n):
    got = pools[n].run("collective", timeout_s=30, op=op, seed=SEED)
    for r, (g, w) in enumerate(zip(got, _want(op, n))):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                   err_msg=f"{op} rank {r}")


@pytest.mark.parametrize("tiled", [False, True])
def test_all_gather_equals_the_references_on_a_jax_mesh(pools, tiled):
    """``all_gather(tiled=)`` on a 2-rank gloo group against the
    reference's ``parallel.collective.all_gather(tiled=)`` on a 2-device
    CPU mesh over the same input on every member (the reference's takes
    a replicated input): both concatenate, whatever the flag."""
    import jax.numpy as jnp

    from paddle_tpu.parallel import collective as jax_c
    jmesh = jax_make_mesh(axis_names=("tp",), shape=(2,),
                          devices=jax.devices()[:2])
    x = _inputs(1)[0]
    want = np.asarray(jax_c.all_gather(jnp.asarray(x), "tp", concat_axis=1,
                                       tiled=tiled, mesh=jmesh))
    op = "all_gather" if tiled else "all_gather_untiled"
    got = pools[2].run("collective", timeout_s=30, op=op, seed=SEED,
                       same_input=True)
    assert want.shape == (4, 12)
    for r in range(2):
        np.testing.assert_array_equal(got[r], want, err_msg=f"rank {r}")


def test_hierarchical_all_reduce_equals_one_sum(pools):
    got = pools[4].run("collective", timeout_s=30, op="hierarchical",
                       seed=SEED)
    for g, w in zip(got, _want("hierarchical", 4)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op", sorted(C.GLOO_CUDA_OPS | {
    "all_gather", "reduce_scatter", "all_to_all", "ppermute"}))
def test_gloo_refuses_cuda_ops_it_lacks_by_name(op):
    """The dispatch check needs no card: gloo runs all_reduce, broadcast
    and barrier on CUDA tensors; any other op raises naming itself and
    the backend; CPU tensors and NCCL pass."""
    C.check_backend(op, "cpu", "gloo")
    C.check_backend(op, "cuda", "nccl")
    if op in C.GLOO_CUDA_OPS:
        C.check_backend(op, "cuda", "gloo")
    else:
        with pytest.raises(NotImplementedError, match=f"{op}.*gloo"):
            C.check_backend(op, "cuda", "gloo")


# -- sharding plans -----------------------------------------------------------

def _to_tuples(tree):
    if isinstance(tree, dict):
        return {k: _to_tuples(v) for k, v in tree.items()}
    return () if tree is None else tuple(tree)


@pytest.fixture(scope="module")
def trees():
    """GPT and BERT parameter trees: the JAX tree (numpy) with the JAX
    layers' hints, and the port model's tree with the port layers' own
    hints (``nn.module.sharding_specs``), which equal them."""
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.models.convert import params_tree
    from paddle_tpu_torch.nn.module import sharding_specs
    gkw = dict(num_heads=4, hidden_size=32, max_position=128)
    gpt = JaxGPT(JaxGPTConfig.tiny(**gkw))
    gp = jax.device_get(gpt.init(jax.random.PRNGKey(0)))
    bert = JaxBert(JaxBertConfig.tiny())
    bp = jax.device_get(bert.init(jax.random.PRNGKey(1)))
    pg = GPT.from_jax(GPTConfig.tiny(**gkw), gp, device="cpu")
    pb = BertForPretraining.from_jax(BertConfig.tiny(), bp, device="cpu")
    out = {}
    for name, jm, jp, pm in (("gpt", gpt, gp, pg), ("bert", bert, bp, pb)):
        ours = sharding_specs(pm)
        assert _to_tuples(ours) == _to_tuples(jm.sharding_specs(jp))
        out[name] = (jp, jm.sharding_specs(jp), params_tree(pm), ours)
    return out


CANNED = ["replicated_plan", "fsdp_plan", "megatron_plan",
          "serving_tp_plan", "serving_prefill_tp_plan"]


@pytest.mark.parametrize("model", ["gpt", "bert"])
@pytest.mark.parametrize("name", CANNED)
def test_plan_spec_trees_equal_the_reference(trees, model, name):
    params, hints, port_params, port_hints = trees[model]
    ours = getattr(plan, name)().params_specs(port_params, port_hints)
    ref = getattr(jax_plan, name)().params_specs(params, hints)
    assert ours == _to_tuples(ref)


def test_small_fsdp_plan_splits_the_largest_dims_like_the_reference(trees):
    params, hints, port_params, port_hints = trees["bert"]
    ours = plan.fsdp_plan(min_size=64).params_specs(port_params, port_hints)
    ref = jax_plan.fsdp_plan(min_size=64).params_specs(params, hints)
    assert ours == _to_tuples(ref)
    assert "fsdp" in str(ours)


@pytest.mark.parametrize("mlp", [False, True], ids=["colocated", "prefill"])
def test_serving_plans_over_the_head_major_tree_equal_the_reference(mlp):
    """The engine's head-major views of a GPT (port) and the reference
    engine's ``_make_tp_params`` tree take the same specs."""
    cfg = JaxGPTConfig.tiny(num_heads=4, hidden_size=32, max_position=128)
    jmodel = JaxGPT(cfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    jeng = JaxEngine(jmodel, params, num_slots=2, page_size=8,
                     max_tokens_per_slot=16, attn_impl="lax")
    jtree = jeng._make_tp_params(params)
    model = GPT.from_jax(GPTConfig.tiny(num_heads=4, hidden_size=32,
                                        max_position=128),
                         jax.device_get(params), device="cpu")
    ours = tp_lib.head_major_tree(model)
    name = "serving_prefill_tp_plan" if mlp else "serving_tp_plan"
    got = getattr(plan, name)().params_specs(ours)
    ref = _to_tuples(getattr(jax_plan, name)().params_specs(jtree))
    assert got["blocks"] == {b: {"attn": v["attn"], "mlp": v["mlp"]}
                             for b, v in ref["blocks"].items()}
    for b, blk in ours["blocks"].items():
        for k in ("qkv_tp", "out_tp"):
            for leaf, t in blk["attn"][k].items():
                np.testing.assert_array_equal(
                    t.numpy(), np.asarray(jtree["blocks"][b]["attn"][k][leaf]))


def test_paged_pool_specs_equal_the_reference():
    fp = [(0, 0)] * 3
    q8 = [(0, 0, 0, 0)] * 2
    for pages in (fp, q8):
        assert plan.paged_pool_specs(pages) == [
            tuple(tuple(s) for s in ent)
            for ent in jax_plan.paged_pool_specs(pages)]


SHARD_CASES = [
    ((8, 6), ("tp", None), {"tp": 2}),
    ((8, 6), (None, "tp"), {"tp": 2}),
    ((4, 3, 8, 2), (None, None, "tp", None), {"tp": 4}),
    ((8, 4), (("dp", "tp"), None), {"dp": 2, "tp": 2}),
    ((8, 4), (("tp", "dp"), None), {"dp": 2, "tp": 2}),
    ((4, 8), ("dp", "tp"), {"dp": 2, "tp": 2}),
    ((6, 4), (), {"tp": 2}),
]


@pytest.mark.parametrize("shape,spec,sizes", SHARD_CASES,
                         ids=[f"{c[1]}-{c[2]}".replace(" ", "")
                              for c in SHARD_CASES])
def test_local_shard_equals_the_shards_device_put_places(pools, shape, spec,
                                                         sizes):
    n = int(np.prod(list(sizes.values())))
    t = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    got = pools[n].run("local_shards", timeout_s=30, tensors=[t],
                       specs=[spec], sizes=sizes)
    jmesh = jax_make_mesh(JaxMeshConfig(**sizes),
                          devices=jax.devices()[:n])
    arr = jax.device_put(t, NamedSharding(jmesh, jax.sharding.PartitionSpec(
        *spec)))
    flat = list(jmesh.devices.reshape(-1))
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    for rank in range(n):
        np.testing.assert_array_equal(got[rank][0], by_dev[flat[rank]])


# -- the tp entry points' contracts -------------------------------------------

def _tp_entries():
    return [e for e in registry.composite_entries() if e.name.endswith("_tp")]


def test_tp_entries_declare_the_reference_contracts():
    ours = {e.name: e for e in _tp_entries()}
    assert sorted(ours) == sorted(
        n for n in jax_kernels.names() if n.endswith("_tp"))
    for name, e in ours.items():
        ref = jax_kernels.get(name)
        assert e.requires_mesh and ref.requires_mesh
        assert dict(e.arg_layouts) == dict(ref.contract.arg_layouts)
        assert e.out_layout == ref.contract.out_layout
        assert e.collectives == tuple(ref.contract.collectives)
        assert len(e.inner) == 1 and e.inner[0] in registry.names()
        assert e.version == ref.contract.version
    # the seven kernels stay the only kernel entries
    assert len(registry.names()) == 7


@pytest.mark.parametrize("chunked", [False, True], ids=["decode", "prefill"])
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_tp_entry_on_a_head_slice_equals_the_inner_kernel_bitwise(chunked,
                                                                  int8):
    """Heads are independent: the tp entry on heads [h0, h1) of q and the
    pool equals the tp=1 entry's output on those heads, bit for bit."""
    from paddle_tpu_torch.serving import paged_attention as PA
    inner = {(False, False): PA.DECODE, (True, False): PA.PREFILL,
             (False, True): PA.DECODE_INT8,
             (True, True): PA.PREFILL_INT8}[(chunked, int8)]
    args, kw = inner.sample_inputs(5)
    full = inner.plain_fn(*args, **kw)
    name = inner.name + "_tp"
    entry = registry.get_composite(name)
    h = args[0].shape[-2]
    lo, hi = h // 2, h
    sl = (args[0][..., lo:hi, :], args[1][:, :, lo:hi], args[2][:, :, lo:hi])
    fake_mesh = object()
    for fn in (entry.fn, entry.plain_fn):
        got = fn(*sl, *args[3:], mesh=fake_mesh, **kw)
        assert torch.equal(got, full[..., lo:hi, :])
    with pytest.raises(ValueError, match="requires a mesh"):
        entry.fn(*sl, *args[3:], **kw)
    with pytest.raises(ValueError, match="head slice"):
        entry.fn(args[0], *sl[1:], *args[3:], mesh=fake_mesh, **kw)
