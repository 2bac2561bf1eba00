"""The port's pipelined BERT and GPT (``pipeline``/``stacked_layers``,
``nn.module.StackedLayers``, the sharded step over "pp") against the JAX
package's pipelined models.

The JAX side runs on the conftest's eight virtual CPU devices (a dp=2 x
fsdp=2 x pp=2 mesh, as ``tests/test_pipeline.py`` does), the port side in
gloo pools of CPU ranks (``torch_tp_pool``) on the same numpy batch and
the JAX weights:

- tiny BERT and GPT with ``pipeline=True`` in both layouts (layer list,
  stacked), GPipe and the circular schedule (v=2, also pre-interleaved),
  on pp=2 x dp=2, pp=2 x fsdp=2 and pp=2 x tp=2: the loss within
  ``rel=1e-5`` and every gradient within ``atol=2e-4, rtol=1e-3`` (the
  reference's tolerances, ``tests/test_pipeline.py``);
- the stacked layout against the layer list, exact; stacked trees carried
  across both ways (``models.convert``, ``stack_encoder_params``);
- a clip by global norm under pp=2 x fsdp=2 against the JAX sharded step
  (the norm of the rows split over "pp" summed over "pp");
- dropout: masks equal at pp=1 and pp=2 for one seed, different across
  microbatches and data shards; sharded steps with dropout at pp=2 on
  ranks seeded apart against pp=1, the ranks' parameters bit for bit;
- ``shard_eval_step`` of the pipelined models on pp=2 x dp/fsdp/tp;
- the stacked GPT's ``generate`` fallback and the refusals of
  ``generate_bucketed`` and the serving engine; ``Trainer.fit`` over a
  pipelined step; a sharded snapshot of a pp-split state restored at
  pp=2 (``shardings=`` naming "pp") and whole.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as joptim
from paddle_tpu import train as jtrain
from paddle_tpu.core.mesh import MeshConfig, make_mesh, mesh_context
from paddle_tpu.models import bert as jbert
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.parallel import api as jax_api
from paddle_tpu.parallel import plan as jax_plan
from paddle_tpu.parallel.pipeline import interleave_stack
from paddle_tpu_torch.models import bert as pbert
from paddle_tpu_torch.models.convert import params_tree, state_from_jax
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.resilience.snapshot import SnapshotEngine, flatten_tree
from torch_tp_pool import CLIP_NORM, TpPool, _digest

torch.set_num_threads(2)

CFG = dict(vocab_size=64, hidden_size=16, num_layers=4, num_heads=2,
           ffn_size=32, max_position=32, dropout=0.0, attn_dropout=0.0)
GPT_CFG = dict(vocab_size=64, hidden_size=16, num_layers=4, num_heads=2,
               ffn_size=32, max_position=32, dropout=0.0)
PP_M = 4


@pytest.fixture(scope="module")
def pools():
    ps = {2: TpPool(2), 4: TpPool(4)}
    yield ps
    for p in ps.values():
        p.close()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def _bert_batch(b=16, s=16, seed=1):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(s // 2, s + 1, b)
    return dict(
        input_ids=rng.integers(0, 64, (b, s)).astype(np.int32),
        token_type_ids=np.zeros((b, s), np.int32),
        attention_mask=np.arange(s)[None, :] < lengths[:, None],
        mlm_labels=rng.integers(0, 64, (b, s)).astype(np.int32),
        mlm_mask=(rng.random((b, s)) < 0.5).astype(np.float32),
        nsp_labels=rng.integers(0, 2, b).astype(np.int32))


def _jax_mesh():
    return make_mesh(MeshConfig(dp=2, fsdp=2, pp=2))


# name -> (port/JAX config fields of the pipelined model, params maker)
BERT_KINDS = {
    "gpipe_list": dict(pipeline=True, pp_microbatches=PP_M,
                       stacked_layers=False),
    "gpipe_stacked": dict(pipeline=True, pp_microbatches=PP_M),
    "circular_list": dict(pipeline=True, pp_microbatches=PP_M,
                          pp_schedule="circular", pp_circuits=2,
                          stacked_layers=False),
    "circular_pre": dict(pipeline=True, pp_microbatches=PP_M,
                         pp_schedule="circular", pp_circuits=2,
                         pp_pre_interleaved=True),
}


@functools.lru_cache(maxsize=None)
def _jax_bert(kind):
    """The JAX pipelined tiny BERT's loss and gradients on the dp=2 x
    fsdp=2 x pp=2 mesh, with its weights (numpy) and the batch."""
    fields = BERT_KINDS[kind]
    m = jbert.BertForPretraining(jbert.BertConfig.tiny(
        **CFG, attn_impl="xla", **fields))
    params = m.init(jax.random.PRNGKey(0))
    if kind == "circular_pre":
        params = dict(params, bert=dict(params["bert"]))
        params["bert"]["encoder"] = interleave_stack(
            params["bert"]["encoder"], 2, 2)
    batch = _bert_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with mesh_context(_jax_mesh()):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: m.loss(p, training=False, **jb)[0]))(params)
    return _np_tree(params), batch, float(loss), _flat(_np_tree(grads))


@functools.lru_cache(maxsize=None)
def _jax_gpt(stacked):
    fields = dict(pipeline=True, pp_microbatches=PP_M,
                  stacked_layers=stacked)
    m = JaxGPT(JaxGPTConfig.tiny(**GPT_CFG, attn_impl="xla", **fields))
    params = m.init(jax.random.PRNGKey(0))
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (16, 17), 0,
                                        64, jnp.int32))
    with mesh_context(_jax_mesh()):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: m.loss(p, jnp.asarray(ids), training=False)[0]))(
                params)
    return (_np_tree(params), {"ids": ids}, float(loss),
            _flat(_np_tree(grads)), fields)


def _hold(res, loss, grads, what):
    assert res["losses"][0]["loss"] == pytest.approx(loss, rel=1e-5), what
    assert set(res["grads"]) == set(grads), what
    for k, g in grads.items():
        np.testing.assert_allclose(res["grads"][k], g, atol=2e-4, rtol=1e-3,
                                   err_msg=f"{what} {k}")


MESHES = {"pp2_dp2": ({"pp": 2, "dp": 2}, "hints"),
          "pp2_fsdp2": ({"pp": 2, "fsdp": 2}, "fsdp"),
          "pp2_tp2": ({"pp": 2, "tp": 2}, "hints"),
          "pp2": ({"pp": 2}, "hints")}
BERT_CASES = [("gpipe_list", "pp2_dp2"), ("gpipe_list", "pp2_fsdp2"),
              ("gpipe_list", "pp2_tp2"), ("gpipe_stacked", "pp2_dp2"),
              ("gpipe_stacked", "pp2_fsdp2"), ("gpipe_stacked", "pp2_tp2"),
              ("circular_list", "pp2_dp2"), ("circular_pre", "pp2_fsdp2"),
              ("circular_pre", "pp2")]


@pytest.mark.parametrize("kind,mesh", BERT_CASES,
                         ids=[f"{k}-{m}" for k, m in BERT_CASES])
def test_bert_pipelined_loss_and_grads(pools, kind, mesh):
    """Every rank's loss and every gradient (gathered whole) equal the
    JAX pipelined BERT's."""
    params, batch, loss, grads = _jax_bert(kind)
    sizes, plan = MESHES[mesh]
    n = int(np.prod(list(sizes.values())))
    got = pools[n].run("pipe_train", timeout_s=120, params=params,
                       model="bert", cfg=dict(CFG, **BERT_KINDS[kind]),
                       sizes=sizes, batch=batch, plan_name=plan)
    for r, res in enumerate(got):
        _hold(res, loss, grads, f"{kind} {mesh} rank {r}")
    stacked = BERT_KINDS[kind].get("stacked_layers", True)
    name = "bert.encoder.ffn.fc1.weight" if stacked else \
        "bert.encoder.0.ffn.fc1.weight"
    spec = got[0]["specs"][name]
    assert (spec[0] == "pp") == stacked
    if stacked:    # each stage holds its own rows
        assert got[0]["local_shapes"][name][0] == 2


@pytest.mark.parametrize("stacked,mesh", [(False, "pp2_dp2"),
                                          (True, "pp2_tp2")])
def test_gpt_pipelined_loss_and_grads(pools, stacked, mesh):
    params, batch, loss, grads, fields = _jax_gpt(stacked)
    sizes, plan = MESHES[mesh]
    got = pools[4].run("pipe_train", timeout_s=120, params=params,
                       model="gpt", cfg=dict(GPT_CFG, **fields),
                       sizes=sizes, batch=batch, plan_name=plan)
    for r, res in enumerate(got):
        _hold(res, loss, grads, f"gpt stacked={stacked} rank {r}")


EVAL_CASES = [("bert", "pp2_dp2"), ("bert", "pp2_tp2"), ("gpt", "pp2_dp2"),
              ("gpt", "pp2_fsdp2")]


@pytest.mark.parametrize("model,mesh", EVAL_CASES,
                         ids=[f"{m}-{k}" for m, k in EVAL_CASES])
def test_shard_eval_step_of_pipelined_models(pools, model, mesh):
    """``shard_eval_step`` of a pipelined (stacked) model gives the JAX
    model's outputs on the same weights on every rank."""
    sizes, _ = MESHES[mesh]
    if model == "bert":
        params, batch, _, _ = _jax_bert("gpipe_stacked")
        jm = jbert.BertForPretraining(jbert.BertConfig.tiny(
            **CFG, attn_impl="xla", stacked_layers=True))
        feeds = {k: batch[k] for k in ("input_ids", "token_type_ids",
                                       "attention_mask")}
        want = jm(params, *(jnp.asarray(feeds[k]) for k in (
            "input_ids", "token_type_ids", "attention_mask")),
            training=False)
        cfg = dict(CFG, **BERT_KINDS["gpipe_stacked"])
    else:
        params, batch, _, _, fields = _jax_gpt(True)
        jm = JaxGPT(JaxGPTConfig.tiny(**GPT_CFG, attn_impl="xla",
                                      stacked_layers=True))
        feeds = {"ids": batch["ids"][:, :16]}
        want = (jm(params, jnp.asarray(feeds["ids"]), training=False),)
        cfg = dict(GPT_CFG, **fields)
    got = pools[4].run("pipe_eval", timeout_s=120, params=params,
                       model=model, cfg=cfg, sizes=sizes, batch=feeds)
    for r, res in enumerate(got):
        for a, b in zip(res, want):
            np.testing.assert_allclose(a, np.asarray(b), atol=2e-5,
                                       rtol=1e-5, err_msg=f"rank {r}")


def test_stacked_layout_equals_the_layer_list_exactly():
    """The same weights in the stacked layout and the layer list: equal
    losses and gradients, bit for bit, with dropout live (one generator
    threaded through the layers in order), and a stacked model from a
    seed holds the layer list's weights of that seed, stacked."""
    cfg = dict(CFG, dropout=0.3)
    lst = pbert.BertForPretraining(pbert.BertConfig.tiny(**cfg),
                                   device="cpu", seed=3)
    stk = pbert.BertForPretraining(
        pbert.BertConfig.tiny(**cfg, stacked_layers=True), device="cpu",
        seed=3)
    sd = state_from_jax(pbert.stack_encoder_params(
        params_tree(lst, lst.state_dict()), 4))
    assert set(sd) == set(stk.state_dict())
    for k, v in stk.state_dict().items():
        assert torch.equal(v, sd[k]), k
    feeds = {k: torch.from_numpy(v) for k, v in _bert_batch().items()}
    for m in (lst, stk):
        m.loss(**feeds, generator=torch.Generator().manual_seed(5))[0] \
            .backward()
    a = state_from_jax(pbert.stack_encoder_params(params_tree(
        lst, {k: p.grad for k, p in lst.named_parameters()}), 4))
    for k, p in stk.named_parameters():
        assert torch.equal(p.grad, a[k]), k
    back = state_from_jax(pbert.unstack_encoder_params(
        params_tree(stk, stk.state_dict()), 4))
    for k, v in lst.state_dict().items():
        assert torch.equal(back[k], v), k
    g_list = GPT(GPTConfig.tiny(**GPT_CFG), device="cpu", seed=2)
    g_stk = GPT(GPTConfig.tiny(**GPT_CFG, stacked_layers=True),
                device="cpu", seed=2)
    from paddle_tpu_torch.parallel.pipeline import stack_params_at
    sd = state_from_jax(stack_params_at(
        params_tree(g_list, g_list.state_dict()), ("blocks",), 4))
    for k, v in g_stk.state_dict().items():
        assert torch.equal(v, sd[k]), k
    ids = torch.from_numpy(np.arange(34).reshape(2, 17) % 64)
    assert torch.equal(g_list.loss(ids)[0], g_stk.loss(ids)[0])


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return tuple(np.shape(tree))


def test_stacked_trees_carry_across_both_ways():
    """A reference checkpoint of the stacked layout loads into the port
    and comes back unchanged (tree and bits); the port's stacking of a
    layer-list tree equals the reference's; the JAX model runs the
    port's tree to the port's outputs."""
    jcfg = jbert.BertConfig.tiny(**CFG, attn_impl="xla",
                                 stacked_layers=True)
    jm = jbert.BertForPretraining(jcfg)
    params = _np_tree(jm.init(jax.random.PRNGKey(4)))
    pm = pbert.BertForPretraining.from_jax(
        pbert.BertConfig.tiny(**CFG, stacked_layers=True), params,
        device="cpu")
    tree = params_tree(pm)
    assert _structure(tree) == _structure(params)
    for k, v in flatten_tree(params).items():
        got = flatten_tree(tree)[k]
        if not k.endswith("\x00empty"):
            np.testing.assert_array_equal(got.detach().numpy(), v,
                                          err_msg=k)
    # the layer-list tree of the reference, stacked by either package
    lm = jbert.BertForPretraining(jbert.BertConfig.tiny(**CFG,
                                                        attn_impl="xla"))
    lp = _np_tree(lm.init(jax.random.PRNGKey(5)))
    want = _np_tree(jbert.stack_encoder_params(lp, 4))
    got = pbert.stack_encoder_params(lp, 4)
    for k, v in flatten_tree(want).items():
        np.testing.assert_array_equal(flatten_tree(got)[k], v, err_msg=k)
    back = pbert.unstack_encoder_params(got, 4)
    for k, v in flatten_tree(lp).items():
        np.testing.assert_array_equal(flatten_tree(back)[k], v, err_msg=k)
    # the port's tree into the JAX model: the same logits
    ids = np.random.default_rng(6).integers(0, 64, (4, 16)).astype(np.int32)
    jt = jax.tree_util.tree_map(lambda t: np.asarray(t.detach()), tree)
    want = jm(jt, jnp.asarray(ids), training=False)
    pm.eval()
    with torch.no_grad():
        got = pm(torch.from_numpy(ids))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)
    # GPT's stacked tree too
    jg = JaxGPT(JaxGPTConfig.tiny(**GPT_CFG, stacked_layers=True))
    gp = _np_tree(jg.init(jax.random.PRNGKey(1)))
    pg = GPT.from_jax(GPTConfig.tiny(**GPT_CFG, stacked_layers=True), gp,
                      device="cpu")
    assert _structure(params_tree(pg)) == _structure(gp)
    assert set(state_from_jax(gp)) == set(pg.state_dict())


@functools.lru_cache(maxsize=None)
def _jax_clip(steps=3):
    m = jbert.BertForPretraining(jbert.BertConfig.tiny(
        **CFG, attn_impl="xla", **BERT_KINDS["gpipe_stacked"]))
    opt = joptim.Momentum(
        learning_rate=0.1, momentum=0.9,
        grad_clip=joptim.GradientClipByGlobalNorm(CLIP_NORM["global"]))
    step = jtrain.build_train_step(
        lambda p, **b: m.loss(p, training=False, **b)[0], opt)
    state = jtrain.make_train_state(m, opt, jax.random.PRNGKey(2))
    params = _np_tree(state["params"])
    batch = _bert_batch(seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    mesh = _jax_mesh()
    with mesh_context(mesh):
        run, placed = jax_api.shard_train_step(
            step, mesh, state, plan=jax_plan.fsdp_plan(min_size=128),
            hints=m.sharding_specs(state["params"]))
        losses = []
        for _ in range(steps):
            placed, met = run(placed, **jb)
            losses.append(float(met["loss"]))
    return params, batch, losses, _flat(_np_tree(placed["params"]))


def test_global_norm_clip_over_pp_and_fsdp(pools):
    """A clip by global norm under pp=2 x fsdp=2 sees the whole model's
    norm (the rows split over "pp" summed over "pp", the blocks over
    "fsdp"): losses and final parameters equal the JAX sharded step's,
    and the same on every rank."""
    params, batch, want, final = _jax_clip()
    got = pools[4].run("pipe_train", timeout_s=180, params=params,
                       model="bert",
                       cfg=dict(CFG, **BERT_KINDS["gpipe_stacked"]),
                       sizes={"pp": 2, "fsdp": 2}, batch=batch,
                       plan_name="fsdp", steps=3,
                       opt="momentum_global_clip", lr=0.1, gather=True)
    assert got[0]["specs"]["bert.encoder.ffn.fc1.weight"][0] == "pp"
    for r in got:
        np.testing.assert_allclose([m["loss"] for m in r["losses"]], want,
                                   rtol=2e-4, atol=1e-5)
        for k, v in final.items():
            np.testing.assert_allclose(r["params"][k], v, rtol=2e-4,
                                       atol=1e-5, err_msg=k)
            np.testing.assert_array_equal(r["params"][k],
                                          got[0]["params"][k], err_msg=k)


def test_dropout_masks_follow_layer_microbatch_and_shard(pools):
    """With dropout live, a pipelined BERT draws the same masks at pp=1
    (one process) and pp=2 for one seed; microbatches of identical rows
    draw different masks, and so do data shards fed the same rows; a
    second seed gives other masks."""
    params, _, _, _ = _jax_bert("gpipe_stacked")
    cfg = dict(CFG, **BERT_KINDS["gpipe_stacked"], dropout=0.2,
               attn_dropout=0.1)
    row = np.random.default_rng(9).integers(0, 64, (1, 16)).astype(np.int32)
    ids = np.repeat(row, 8, axis=0)         # every microbatch alike
    m = pbert.BertForPretraining.from_jax(pbert.BertConfig.tiny(**cfg),
                                          params, device="cpu")
    with torch.no_grad():
        one, _ = m.bert(torch.from_numpy(ids),
                        generator=torch.Generator().manual_seed(11))
        other, _ = m.bert(torch.from_numpy(ids),
                          generator=torch.Generator().manual_seed(12))
    one = one.numpy()
    assert not np.allclose(one, other.numpy())
    mb = ids.shape[0] // PP_M
    assert not np.allclose(one[:mb], one[mb:2 * mb])   # microbatches differ
    two = pools[2].run("pipe_dropout", timeout_s=60, params=params, cfg=cfg,
                       sizes={"pp": 2}, ids=ids, seed=11)
    for r in two:
        np.testing.assert_allclose(r, one, atol=1e-6, rtol=1e-6)
    four = pools[4].run("pipe_dropout", timeout_s=60, params=params,
                        cfg=cfg, sizes={"pp": 2, "dp": 2}, ids=ids, seed=11)
    # ranks 0/1 are dp shard 0 (pp 0, 1), ranks 2/3 dp shard 1
    np.testing.assert_array_equal(four[0], four[1])
    np.testing.assert_array_equal(four[2], four[3])
    np.testing.assert_allclose(four[0], one, atol=1e-6, rtol=1e-6)
    assert not np.allclose(four[0], four[2])


@pytest.mark.parametrize("kind", ["gpipe_stacked", "gpipe_list"])
def test_dropout_training_at_pp2_equals_pp1(pools, kind):
    """Two sharded SGD steps of a pipelined BERT with dropout live, at
    pp=2 with the ranks' default generators seeded apart, give pp=1's
    losses, gradients and parameters on stage 0's seed, and the ranks'
    parameters stay equal bit for bit (the embeddings, replicated over
    "pp", draw their masks alike on both stages)."""
    from paddle_tpu_torch import optimizer as poptim
    from paddle_tpu_torch import train as ptrain
    from paddle_tpu_torch.parallel import api as papi
    from torch_tp_pool import _bert_loss
    params, batch, _, _ = _jax_bert(kind)
    cfg = dict(CFG, **BERT_KINDS[kind], dropout=0.2, attn_dropout=0.1)
    got = pools[2].run("pipe_train", timeout_s=120, params=params,
                       model="bert", cfg=cfg, sizes={"pp": 2}, batch=batch,
                       steps=2, lr=0.1, gather=True, rng_seed=100)
    m = pbert.BertForPretraining.from_jax(pbert.BertConfig.tiny(**cfg),
                                          params, device="cpu")
    opt = poptim.SGD(m.parameters(), learning_rate=0.1)
    step = ptrain.build_train_step(_bert_loss, opt)
    state = ptrain.make_train_state(m, opt)
    feeds = {k: torch.from_numpy(v) for k, v in batch.items()}
    torch.manual_seed(100)
    losses, grads = [], None
    for _ in range(2):
        with papi.step_rng(None, "cpu"):
            state, met = step(state, **feeds)
        losses.append(float(met["loss"]))
        if grads is None:
            grads = {k: p.grad.numpy().copy()
                     for k, p in m.named_parameters()}
    for r in got:
        np.testing.assert_allclose([x["loss"] for x in r["losses"]],
                                   losses, rtol=1e-6)
        for k, g in grads.items():
            np.testing.assert_allclose(r["grads"][k], g, atol=1e-6,
                                       rtol=1e-5, err_msg=k)
        for k, p in m.named_parameters():
            np.testing.assert_allclose(r["params"][k], p.detach().numpy(),
                                       atol=1e-6, rtol=1e-5, err_msg=k)
            np.testing.assert_array_equal(r["params"][k],
                                          got[0]["params"][k], err_msg=k)
    assert losses[0] != losses[1]


def test_gpt_stacked_generate_falls_back_and_serving_refuses():
    """The stacked and pipeline layouts decode by the full refeed:
    ``generate(use_cache=True)`` gives the layer list's cached tokens;
    ``generate_bucketed`` and the serving engine refuse them with the
    reference's messages."""
    from paddle_tpu_torch.serving.engine import ServingEngine
    lst = GPT(GPTConfig.tiny(**GPT_CFG), device="cpu", seed=4)
    prompt = torch.from_numpy(np.arange(10).reshape(2, 5) % 64)
    want = lst.generate(prompt, 6, use_cache=True)
    for fields in (dict(stacked_layers=True),
                   dict(pipeline=True, pp_microbatches=2)):
        stk = GPT(GPTConfig.tiny(**GPT_CFG, **fields), device="cpu", seed=4)
        assert torch.equal(stk.generate(prompt, 6, use_cache=True), want)
        with pytest.raises(ValueError, match="LayerList layout"):
            stk.generate_bucketed(prompt, 6)
        with pytest.raises(ValueError, match="LayerList GPT layout"):
            ServingEngine(stk, device="cpu")


def test_trainer_fits_a_pipelined_step(pools):
    """``Trainer.fit`` over the sharded step of a pipelined BERT on pp=2:
    the loss falls, the ranks agree, and rank 0 logs the aggregate
    line."""
    params, batch, _, _ = _jax_bert("gpipe_stacked")
    got = pools[2].run("pipe_trainer", timeout_s=120, params=params,
                       cfg=dict(CFG, **BERT_KINDS["gpipe_stacked"]),
                       batch=batch, steps=4)
    assert got[0]["step"] == got[1]["step"] == 4
    assert got[0]["last"] == got[1]["last"]
    assert any(ln.startswith("[observability] step 2 [hosts] ")
               for ln in got[0]["lines"]), got[0]["lines"]


def test_pp_split_snapshot_restores_at_pp2_and_whole(pools, tmp_path):
    """A pp=2 stacked state saved as each stage's rows restores with
    ``shardings=`` naming "pp" to each rank's blocks, and without them
    to the whole state (pp=1), bit for bit."""
    params, batch, _, _ = _jax_bert("gpipe_stacked")
    got = pools[2].run("pipe_snapshot", timeout_s=120, params=params,
                       cfg=dict(CFG, **BERT_KINDS["gpipe_stacked"]),
                       batch=batch, directory=str(tmp_path), sizes={"pp": 2})
    key = "params/bert/encoder/attn/qkv_proj/weight"
    for r in got:
        assert r["specs"][key][0] == "pp"
        assert key in r["shards"] and r["differ"] == []
    assert got[0]["shapes"][key][0] == 2
    assert got[0]["mine"][key] != got[1]["mine"][key]
    eng = SnapshotEngine(str(tmp_path))
    whole = flatten_tree(eng.restore(1))
    eng.close()
    for k, digest in got[0]["whole"].items():
        assert _digest(torch.as_tensor(whole[k])) == digest, k
