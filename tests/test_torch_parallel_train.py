"""The port's training across ranks (``paddle_tpu_torch/parallel/api.py``,
``plan.state_specs``, the layers' sharding hints, LocalSGD, the cross-
process aggregate line, the staged transport) against the JAX package.

The JAX side runs on the conftest's virtual CPU devices, the port side in
a gloo pool of CPU ranks (``torch_tp_pool``) on the same numpy inputs and
the JAX weights:

- ``test_dp_loss_parity`` (``replicated`` and ``fsdp``) and
  ``test_tp_loss_parity`` of ``tests/test_parallel.py``: the port's
  losses against the JAX sharded step's, at rtol 2e-5 / atol 2e-6 and
  rtol 2e-4 / atol 1e-5;
- tiny BERT on dp, fsdp, Megatron tp, ring sp and dp x sp meshes against
  the JAX single-device losses (ragged valid lengths, so the global MLM
  mean shows);
- the optimizer's norms over split parameters (a clip by global norm
  and by norm, Lamb's and LarsMomentum's trust ratios) on an fsdp x tp
  mesh against the JAX sharded step: losses, and the final parameters
  gathered, equal on every rank;
- ``state_specs`` and the layers' ``sharding_specs`` against the
  reference's on BERT and GPT, and ``batch_specs``;
- ``LocalSGD`` / ``localsgd_average`` against the reference's inside a
  ``shard_map`` over a dp mesh;
- a sharded step refuses a capture; a staged op is refused without the
  mesh's switch.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu import train as jtrain
from paddle_tpu.core.compat import shard_map
from paddle_tpu.core.mesh import MeshConfig, make_mesh, mesh_context
from paddle_tpu.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.models.bert import BertForPretraining as JaxBert
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.ops import nn as jops_nn
from paddle_tpu.optimizer.compression import LocalSGD as JaxLocalSGD
from paddle_tpu.parallel import api as jax_api
from paddle_tpu.parallel import plan as jax_plan
from paddle_tpu_torch import optimizer, train
from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.nn.module import sharding_specs
from paddle_tpu_torch.parallel import api, plan
from torch_tp_pool import CLIP_NORM, TpPool

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pools():
    ps = {2: TpPool(2), 4: TpPool(4)}
    yield ps
    for p in ps.values():
        p.close()


def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return () if tree is None else tuple(tree)


# -- the reference's loss-parity model ----------------------------------------

def _toy():
    model = jnn.Sequential(jnn.Linear(16, 32), jnn.Sequential(),
                           jnn.Linear(32, 4, sharding=None))
    rng = np.random.RandomState(0)
    batch = {"x": rng.randn(32, 16).astype(np.float32),
             "y": rng.randint(0, 4, size=(32,))}
    return model, batch


def _toy_loss(model):
    def loss_fn(params, x, y):
        logits = model(params, x)
        return jops_nn.softmax_with_cross_entropy(
            logits, y, return_softmax=False).mean()
    return loss_fn


def _jax_losses(step, state, batch, n=4):
    losses = []
    for _ in range(n):
        state, m = step(state, **batch)
        losses.append(float(m["loss"]))
    return losses


@functools.lru_cache(maxsize=None)
def _jax_toy(plan_name):
    model, batch = _toy()
    opt = (joptim.Momentum(learning_rate=0.1, momentum=0.9)
           if plan_name != "megatron" else joptim.Adam(learning_rate=1e-2))
    step = jtrain.build_train_step(_toy_loss(model), opt)
    state = jtrain.make_train_state(model, opt, jax.random.PRNGKey(0))
    params = jax.device_get(state["params"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if plan_name == "megatron":
        mesh = make_mesh(MeshConfig(dp=2, tp=4))
        hints = model.sharding_specs(state["params"])
        p = None
    else:
        mesh = make_mesh(MeshConfig(dp=8))
        hints = {"params": None}
        p = (jax_plan.replicated_plan() if plan_name == "replicated"
             else jax_plan.fsdp_plan(min_size=128))
    with mesh_context(mesh):
        run, placed = jax_api.shard_train_step(step, mesh, state, plan=p,
                                               hints=hints)
        losses = _jax_losses(run, placed, jbatch)
    return params, batch, losses


@pytest.mark.parametrize("plan_name,sizes", [("replicated", {"dp": 4}),
                                             ("fsdp", {"fsdp": 4})])
def test_dp_loss_parity(pools, plan_name, sizes):
    params, batch, want = _jax_toy(plan_name)
    got = pools[4].run("sharded_train", timeout_s=120, params=params,
                       model="toy", sizes=sizes, plan_name=plan_name,
                       batch=batch, steps=4, opt="momentum", lr=0.1)
    for r in got:
        np.testing.assert_allclose([m["loss"] for m in r["losses"]], want,
                                   rtol=2e-5, atol=2e-6)
    if plan_name == "fsdp":
        # big parameters are held as blocks: a quarter of their rows
        assert got[0]["local_shapes"]["layers.0.weight"] == (16, 8)
        assert got[0]["specs"]["layers.0.weight"] == (None, "fsdp")


def test_tp_loss_parity(pools):
    params, batch, want = _jax_toy("megatron")
    got = pools[4].run("sharded_train", timeout_s=120, params=params,
                       model="toy", sizes={"dp": 2, "tp": 2},
                       plan_name="megatron", batch=batch, steps=4,
                       opt="adam", lr=1e-2, hints=True)
    for r in got:
        np.testing.assert_allclose([m["loss"] for m in r["losses"]], want,
                                   rtol=2e-4, atol=1e-5)
        assert r["local_shapes"]["layers.0.weight"] == (16, 16)  # column


# -- the optimizer's norms over split parameters ------------------------------

NORM_OPTS = {
    "adam_global_clip": (lambda: joptim.Adam(
        learning_rate=1e-2,
        grad_clip=joptim.GradientClipByGlobalNorm(CLIP_NORM["global"])),
        1e-2),
    "momentum_norm_clip": (lambda: joptim.Momentum(
        learning_rate=0.1, momentum=0.9,
        grad_clip=joptim.GradientClipByNorm(CLIP_NORM["tensor"])), 0.1),
    "lamb": (lambda: joptim.Lamb(learning_rate=1e-2), 1e-2),
    "lars": (lambda: joptim.LarsMomentum(learning_rate=1.0), 1.0),
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


@functools.lru_cache(maxsize=None)
def _jax_toy_norms(opt_name):
    model, batch = _toy()
    make, lr = NORM_OPTS[opt_name]
    opt = make()
    step = jtrain.build_train_step(_toy_loss(model), opt)
    state = jtrain.make_train_state(model, opt, jax.random.PRNGKey(0))
    params = jax.device_get(state["params"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    mesh = make_mesh(MeshConfig(dp=2, fsdp=2, tp=2))
    with mesh_context(mesh):
        run, placed = jax_api.shard_train_step(
            step, mesh, state, plan=jax_plan.fsdp_plan(min_size=128),
            hints=model.sharding_specs(state["params"]))
        losses = []
        for _ in range(4):
            placed, m = run(placed, **jbatch)
            losses.append(float(m["loss"]))
    return params, batch, lr, losses, _flat(jax.device_get(placed["params"]))


@pytest.mark.parametrize("opt_name", sorted(NORM_OPTS))
def test_norms_over_split_parameters(pools, opt_name):
    """On fsdp=2 x tp=2, the clips by norm and the trust ratios see whole
    tensors, as the reference's GSPMD step does: every rank's losses and
    final parameters, gathered, equal the JAX sharded step's, and the
    parameters that no axis splits (the biases, the last Linear over tp)
    are the same on every rank."""
    params, batch, lr, want, final = _jax_toy_norms(opt_name)
    got = pools[4].run("sharded_train", timeout_s=120, params=params,
                       model="toy", sizes={"fsdp": 2, "tp": 2},
                       plan_name="fsdp", batch=batch, steps=4, opt=opt_name,
                       lr=lr, hints=True, gather=True)
    assert got[0]["specs"]["layers.0.weight"] == (None, ("tp", "fsdp"))
    assert got[0]["local_shapes"]["layers.0.weight"] == (16, 8)
    for r in got:
        np.testing.assert_allclose([m["loss"] for m in r["losses"]], want,
                                   rtol=2e-4, atol=1e-5)
        for k, v in final.items():
            np.testing.assert_allclose(r["params"][k], v, rtol=2e-4,
                                       atol=1e-5, err_msg=k)
            np.testing.assert_array_equal(r["params"][k],
                                          got[0]["params"][k], err_msg=k)


# -- tiny BERT across ranks against the JAX single-device run -----------------

BERT_CFG = dict(dropout=0.0, attn_dropout=0.0)
BERT_STEPS = 3


def _bert_batch(b=4, s=32, vocab=128, seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(s // 4, s + 1, b)
    return dict(
        input_ids=rng.integers(0, vocab, (b, s)).astype(np.int64),
        token_type_ids=np.zeros((b, s), np.int64),
        attention_mask=np.arange(s)[None, :] < lengths[:, None],
        mlm_labels=rng.integers(0, vocab, (b, s)).astype(np.int64),
        mlm_mask=(rng.random((b, s)) < 0.15).astype(np.float32),
        nsp_labels=rng.integers(0, 2, b).astype(np.int64))


@functools.lru_cache(maxsize=None)
def _jax_bert():
    model = JaxBert(JaxBertConfig.tiny(attn_impl="xla", **BERT_CFG))
    opt = joptim.Adam(learning_rate=1e-3)
    step = jax.jit(jtrain.build_train_step(
        lambda p, **b: model.loss(p, **b), opt))
    state = jtrain.make_train_state(model, opt, jax.random.PRNGKey(7))
    params = jax.device_get(state["params"])
    batch = _bert_batch()
    jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
          for k, v in batch.items()}
    losses = []
    for _ in range(BERT_STEPS):
        state, m = step(state, **jb)
        losses.append({k: float(v) for k, v in m.items()})
    return params, batch, losses


BERT_MESHES = [
    ("dp2", {"dp": 2}, "replicated", None, {}),
    ("fsdp2", {"fsdp": 2}, "fsdp", None, {}),
    ("tp2", {"tp": 2}, "megatron", None, {}),
    ("sp2_ring", {"sp": 2}, "replicated", 1, {"attn_impl": "ring"}),
    ("dp2_sp2_ring", {"dp": 2, "sp": 2}, "replicated", 1,
     {"attn_impl": "ring"}),
]


@pytest.mark.parametrize("name,sizes,plan_name,seq_dim,extra", BERT_MESHES,
                         ids=[m[0] for m in BERT_MESHES])
def test_bert_losses_across_ranks(pools, name, sizes, plan_name, seq_dim,
                                  extra):
    """Every rank's loss, MLM and NSP loss at each step equal the JAX
    single-device run's (the MLM mean divides the global masked sum by
    the global count; the valid lengths are ragged)."""
    params, batch, want = _jax_bert()
    n = int(np.prod(list(sizes.values())))
    got = pools[n].run("sharded_train", timeout_s=300, params=params,
                       model="bert", sizes=sizes, plan_name=plan_name,
                       batch=batch, steps=BERT_STEPS, lr=1e-3,
                       cfg=dict(BERT_CFG, **extra),
                       hints=plan_name == "megatron", seq_dim=seq_dim)
    tol = (dict(rtol=2e-4, atol=1e-5) if plan_name == "megatron"
           else dict(rtol=2e-5, atol=2e-6))
    for r in got:
        for key in ("loss", "mlm_loss", "nsp_loss"):
            np.testing.assert_allclose([m[key] for m in r["losses"]],
                                       [m[key] for m in want],
                                       err_msg=f"{name} {key}", **tol)


def test_fsdp_final_parameters_gathered_equal_replicated(pools):
    """The fsdp ranks' blocks, gathered, equal the replicated ranks'
    parameters after the same steps (the update ran on the blocks and
    their sharded slots)."""
    params, batch, _ = _jax_bert()
    kw = dict(params=params, model="bert", batch=batch, steps=2, lr=1e-3,
              cfg=BERT_CFG, gather=True)
    rep = pools[2].run("sharded_train", timeout_s=300, sizes={"dp": 2},
                       plan_name="replicated", **kw)[0]["params"]
    got = pools[2].run("sharded_train", timeout_s=300, sizes={"fsdp": 2},
                       plan_name="fsdp", **kw)
    for r in got:
        assert any(r["local_shapes"][k] != v.shape
                   for k, v in rep.items())
        for k, v in rep.items():
            # the key third of a qkv bias has a zero gradient in exact
            # arithmetic: Adam turns its rounding noise into lr-sized steps
            w, g = v, r["params"][k]
            if k.endswith("qkv_proj.bias"):
                d = v.shape[0] // 3
                w, g = np.delete(v, np.s_[d:2 * d]), np.delete(g, np.s_[d:2 * d])
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


# -- specs ---------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models():
    jb = JaxBert(JaxBertConfig.tiny())
    bp = jax.device_get(jb.init(jax.random.PRNGKey(1)))
    pb = BertForPretraining.from_jax(BertConfig.tiny(), bp, device="cpu")
    gcfg = dict(num_heads=4, hidden_size=32, max_position=128)
    jg = JaxGPT(JaxGPTConfig.tiny(**gcfg))
    gp = jax.device_get(jg.init(jax.random.PRNGKey(0)))
    pg = GPT.from_jax(GPTConfig.tiny(**gcfg), gp, device="cpu")
    return {"bert": (jb, bp, pb), "gpt": (jg, gp, pg)}


@pytest.mark.parametrize("model", ["bert", "gpt"])
def test_layer_hints_equal_the_reference(model):
    jm, params, pm = _models()[model]
    want = jax.tree_util.tree_map(
        lambda s: None if s is None else tuple(s), jm.sharding_specs(params),
        is_leaf=lambda x: x is None or isinstance(x, JP))
    assert sharding_specs(pm) == want
    assert "tp" in str(want)


@pytest.mark.parametrize("plan_name", ["replicated_plan", "fsdp_plan",
                                       "megatron_plan"])
@pytest.mark.parametrize("model", ["bert", "gpt"])
def test_state_specs_equal_the_reference(model, plan_name):
    """Specs of the whole train state, optimizer slots included: under
    FSDP the Adam slots are split like their parameter."""
    jm, params, pm = _models()[model]
    jopt = joptim.Adam(learning_rate=1e-3)
    jstate = {"params": params, "opt": jax.device_get(jopt.init(params)),
              "step": np.zeros((), np.int32)}
    mk = (lambda n: getattr(plan, n)(min_size=64)) \
        if plan_name == "fsdp_plan" else (lambda n: getattr(plan, n)())
    jmk = (lambda n: getattr(jax_plan, n)(min_size=64)) \
        if plan_name == "fsdp_plan" else (lambda n: getattr(jax_plan, n)())
    ref = _tuples(jmk(plan_name).state_specs(jstate,
                                             jm.sharding_specs(params)))
    state = train.make_train_state(pm, optimizer.Adam(pm.parameters()))
    got = mk(plan_name).state_specs(state, sharding_specs(pm))
    assert got == ref
    if plan_name == "fsdp_plan":
        assert got["opt"]["slots"]["m"] == got["params"]
        assert "fsdp" in str(got["opt"]["slots"]["v"])


@pytest.mark.parametrize("seq_dim", [None, 1])
def test_batch_specs_equal_the_reference(seq_dim):
    batch = _bert_batch()
    batch["scale"] = np.float32(1.0)
    want = _tuples(jax_api.batch_specs(
        {k: jnp.asarray(v) for k, v in batch.items()}, seq_dim=seq_dim))
    assert api.batch_specs(batch, seq_dim=seq_dim) == want


# -- LocalSGD -------------------------------------------------------------------

def _jax_local_sgd(n, k, steps, seed):
    """The reference's ``LocalSGD.maybe_average`` inside a shard_map over
    an n-device dp mesh, fed the pool case's per-rank draws."""
    rngs = [np.random.default_rng(seed + r) for r in range(n)]
    shapes = ((3, 4), (5,))
    params = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
              for rng in rngs]
    mesh = make_mesh(MeshConfig(dp=n), devices=jax.devices()[:n])
    avg = JaxLocalSGD(k_steps=k, axis="dp")
    fn = jax.jit(shard_map(
        lambda ps, st: [p[None] for p in avg.maybe_average(
            [p[0] for p in ps], st[0])],
        mesh=mesh, in_specs=(JP("dp"), JP()), out_specs=JP("dp")))
    out = []
    for step in range(steps):
        stacked = [jnp.asarray(np.stack([params[r][i] for r in range(n)]))
                   for i in range(len(shapes))]
        res = [np.asarray(a) for a in fn(stacked, jnp.asarray([step]))]
        params = [[res[i][r] for i in range(len(shapes))]
                  for r in range(n)]
        out.append([list(p) for p in params])
        for r in range(n):
            params[r] = [p + rngs[r].standard_normal(p.shape).astype(
                np.float32) for p in params[r]]
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_local_sgd_matches_the_reference(pools, n):
    k, steps = 2, 5
    got = pools[n].run("local_sgd_average", timeout_s=60, k=k, steps=steps,
                       seed=11)
    want = _jax_local_sgd(n, k, steps, seed=11)
    for step in range(steps):
        for r in range(n):
            did, ps = got[r][step]
            assert did == (step % k == 0)
            for g, w in zip(ps, want[step][r]):
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        if step % k == 0:       # every rank holds the mean
            for r in range(1, n):
                for a, b in zip(got[r][step][1], got[0][step][1]):
                    np.testing.assert_array_equal(a, b)


def test_local_sgd_steps_in_the_dp_group(pools):
    """Two ranks training on their own halves with LocalSGD(k=2): after
    each sync step both hold the same parameters, the mean of theirs."""
    params, batch, _ = _jax_toy("replicated")
    got = pools[2].run("sharded_train", timeout_s=120, params=params,
                       model="toy", sizes={"dp": 2}, plan_name="replicated",
                       batch=batch, steps=5, opt="momentum", lr=0.1,
                       local_sgd=2)
    assert len(got[0]["synced"]) == 3                # steps 0, 2 and 4
    for a, b in zip(got[0]["synced"], got[1]["synced"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert not all(np.array_equal(x, y) for x, y in
                   zip(got[0]["final"], got[1]["final"]))


# -- refusals, aggregation -------------------------------------------------------

def test_staging_and_capture_refusals(pools):
    got = pools[2].run("staging", timeout_s=60)
    for r in got:
        assert r[False].startswith("refused: ppermute on CUDA tensors")
        assert r[True] == "cuda"
        assert r["all_reduce_False"] is None and r["all_reduce_True"] is None
        assert r["backend"] == "gloo"
        assert "NCCL across cards" in r["capture"] and \
            "cuda_graphs=False" in r["capture"]
        assert r["stats"] == {"calls": {}, "bytes": {}}


def test_graphs_refuse_a_step_with_collectives():
    graphs = train.TrainStepGraphs(lambda s, b: (s, {}), collectives="gloo")
    with pytest.raises(ValueError, match="NCCL across cards"):
        graphs.check_capturable()
    train.TrainStepGraphs(lambda s, b: (s, {})).check_capturable()


def test_aggregate_line_across_processes(pools):
    got = pools[2].run("aggregate_line", timeout_s=60)
    (s0, lines0), (s1, lines1) = got
    assert s0 == s1
    assert s0["a"] == {"min": 0.0, "max": 1.0, "mean": 0.5, "argmin": 0,
                       "argmax": 1}
    assert len(lines0) == 2 and lines1 == []
    assert lines0[0].startswith("[observability] step 2 [hosts] ")
    assert "(host1 high)" in lines0[0]


@pytest.mark.parametrize("plan_name,sizes", [
    ("replicated", {"dp": 2}), ("fsdp", {"fsdp": 2}), ("megatron", {"tp": 2})])
def test_shard_eval_step_outputs_equal_the_reference(pools, plan_name,
                                                     sizes):
    """``shard_eval_step`` gives every rank the whole batch's MLM and NSP
    logits, equal to the JAX model's forward on one device."""
    model = JaxBert(JaxBertConfig.tiny(attn_impl="xla", **BERT_CFG))
    params = jax.device_get(model.init(jax.random.PRNGKey(3)))
    batch = _bert_batch()
    feeds = {k: batch[k] for k in ("input_ids", "token_type_ids",
                                   "attention_mask")}
    want = model(params, *(jnp.asarray(feeds[k].astype(np.int32)
                                       if feeds[k].dtype == np.int64
                                       else feeds[k])
                           for k in feeds))
    got = pools[2].run("sharded_eval", timeout_s=120, params=params,
                       sizes=sizes, plan_name=plan_name, batch=feeds,
                       cfg=BERT_CFG)
    tol = (dict(rtol=2e-4, atol=1e-5) if plan_name == "megatron"
           else dict(rtol=2e-5, atol=2e-5))
    for mlm, nsp in got:
        np.testing.assert_allclose(mlm, np.asarray(want[0]), **tol)
        np.testing.assert_allclose(nsp, np.asarray(want[1]), **tol)


def test_with_sharding_constraint_cuts_and_gathers_back(pools):
    """A replicated activation constrained to ("dp", None): each rank
    gets its rows, and the transpose gathers every rank's gradient rows
    (``x``'s gradient is ``g`` on every rank)."""
    rng = np.random.default_rng(5)
    x, g = (rng.standard_normal((8, 3)).astype(np.float32) for _ in range(2))
    got = pools[4].run("constraint", timeout_s=60, x=x, g=g)
    for r, (blk, grad) in enumerate(got):
        np.testing.assert_array_equal(blk, x[2 * r:2 * (r + 1)])
        np.testing.assert_array_equal(grad, g)
