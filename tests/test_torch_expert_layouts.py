"""The MoE layouts of the port's sharded step beyond "ep" as a model axis
(``parallel/api.py`` ``ExpertPlacement``/``token_layout``, ``nn/moe.py``,
``parallel/functional.py`` ``all_to_all``), against the JAX package.

The JAX side runs ``shard_train_step`` / ``shard_eval_step`` on the
conftest's virtual CPU devices with the batch spec of each layout; the
port side runs in gloo pools of CPU ranks (``torch_tp_pool``) on the same
numpy batch and the JAX weights. Model, batch, optimizer and tolerances
are ``test_torch_expert_parallel``'s: ``MoEFeedForward(16, 32, 4)`` with
a residual and a readout on an (8, 8, 16) batch whose second half of
rows leans toward expert 0; 4 AdamW steps; losses and ``aux_loss``
within rtol 2e-5 / atol 2e-6, every expert count exactly, the parameters
gathered within 1e-5. Layouts:

- tokens over "ep" (GShard's all-to-all): ep=4 with ``P("ep")`` at every
  routing case, dp=2 x ep=2 with ``P(("dp", "ep"))`` and ``P(("ep",
  "dp"))``, ep=2 x tp=2, and each rank's all-to-all calls and bytes a
  step against the reckoning of ``nn/moe.py``;
- the sequence over "sp": dp=2 x sp=2 and sp=2 x ep=2
  (``batch_specs(seq_dim=1)``), and sp=2 x ep=2 with tokens over both;
- pp=2 x ep=2 with the MoE outside any stack; ep=4 with the biases
  whole;
- ``shard_eval_step`` on the reference's ``test_ep_sharded`` setup with
  the batch over ("dp", "ep");
- a ring-attention block and the MoE on sp=2 x ep=2;
- router noise, the step traced on fake tensors, and guards that routing
  each "ep" or "sp" shard on its own is another layer.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import test_torch_expert_parallel as ep
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu import train as jtrain
from paddle_tpu.core.mesh import mesh_context
from paddle_tpu.nn import moe as JM
from paddle_tpu.parallel import api as jax_api
from paddle_tpu.parallel import plan as jax_plan
from torch_tp_pool import TpPool

torch.set_num_threads(2)

D, FF, E, OUT, B, S = ep.D, ep.FF, ep.E, ep.OUT, ep.B, ep.S
STEPS, LR = ep.STEPS, ep.LR["adamw"]
#: the ring block's heads; its losses and parameters hold the tolerances
#: above too (the port's ring tests hold BERT's ring to 2e-5 / 2e-6)
HEADS = 2


@pytest.fixture(scope="module")
def pools():
    ps = {}

    def get(n):
        if n not in ps:
            ps[n] = TpPool(n)
        return ps[n]

    yield get
    for p in ps.values():
        p.close()


class _JaxRingNet(jnn.Layer):
    """The JAX side of ``torch_tp_pool.moe_net`` with ``heads``: a
    ring-attention block with its residual before the MoE."""

    def __init__(self, top_k, cf):
        super().__init__()
        self.attn = jnn.MultiHeadAttention(D, HEADS, attn_impl="ring")
        self.moe = JM.MoEFeedForward(D, FF, E, top_k=top_k,
                                     capacity_factor=cf)
        self.readout = jnn.Linear(D, OUT, sharding=None)

    def forward(self, params, x):
        x = x + self.attn(params["attn"], x)
        y, aux = self.moe(params["moe"], x)
        return self.readout(params["readout"], x + y), aux


@functools.lru_cache(maxsize=None)
def _init(top_k, cf, ring):
    if not ring:
        return ep._init(top_k, cf)
    model = _JaxRingNet(top_k, cf)
    return model, jax.device_get(model.init(jax.random.PRNGKey(0)))


def _jax_spec(spec, batch):
    if spec is None:
        return JP(("dp", "fsdp"))
    if spec == "seq":
        return jax_api.batch_specs(batch, seq_dim=1)
    return JP(*spec)


@functools.lru_cache(maxsize=None)
def _jax_run(top_k, cf, sizes, spec=None, rules=None, ring=False):
    """The JAX sharded step's metrics and final parameters over ``STEPS``
    AdamW steps on a mesh of ``sizes`` (a tuple of items) with the batch
    over ``spec`` (None, "seq" or spec entries) and the plan's ``rules``
    before the hints."""
    model, params = _init(top_k, cf, ring)
    optim = joptim.AdamW(learning_rate=LR)
    step = jtrain.build_train_step(ep._jax_loss(model), optim)
    state = jtrain.make_train_state(model, optim, jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in ep._batch(params).items()}
    mesh = ep._mesh(dict(sizes))
    plan = jax_plan.ShardingPlan(
        [(pat, None if s is None else JP(*s)) for pat, s in rules or ()])
    with mesh_context(mesh):
        run, placed = jax_api.shard_train_step(
            step, mesh, state, plan=plan,
            hints=model.sharding_specs(state["params"]),
            batch_spec=_jax_spec(spec, batch), donate_state=False)
        metrics = []
        for _ in range(STEPS):
            placed, m = run(placed, **batch)
            metrics.append({k: float(v) for k, v in m.items()})
    return params, {"metrics": metrics,
                    "params": ep._flat(jax.device_get(placed["params"]))}


def _cfg(top_k, cf, ring=False):
    return dict(ep._cfg(top_k, cf), **({"heads": HEADS} if ring else {}))


def _run(pools, sizes, top_k=2, cf=1.0, spec=None, rules=None, ring=False,
         whole=()):
    """The port's ranks and the JAX run of one layout, held to each other
    (``test_torch_expert_parallel._check``); returns the ranks'
    results."""
    n = int(np.prod(list(sizes.values())))
    params, want = _jax_run(top_k, cf, ep._items(sizes), spec,
                            rules and tuple(rules), ring)
    got = pools(n).run("moe_train", timeout_s=120, params=params,
                       cfg=_cfg(top_k, cf, ring), sizes=sizes,
                       batch=ep._batch(params), steps=STEPS, lr=LR,
                       batch_spec=spec,
                       plan_rules=rules and [list(r) for r in rules])
    if ring:
        _hold_key_bias(got, want)
    ep._check(got, want, sizes, whole)
    return got


def _hold_key_bias(got, want):
    """The key third of ``attn.qkv_proj.bias`` has a zero gradient in
    exact arithmetic (a constant added to a query's scores cancels in the
    softmax), so AdamW turns each side's rounding noise into steps of up
    to ``LR`` in either direction: there only the drift is held, to at
    most 2 x ``STEPS`` x ``LR`` (as ``chip_smoke._held_params``), and
    that third is then taken as the reference's for the other checks."""
    key = "attn.qkv_proj.bias"
    for r in got:
        mine = r["params"][key][D:2 * D]
        drift = np.abs(mine - want["params"][key][D:2 * D]).max()
        assert drift <= 2 * STEPS * LR, drift
        mine[...] = want["params"][key][D:2 * D]


def _a2a_reckoning(top_k, cf, shards, calls=3, itemsize=4):
    """``nn/moe.py``'s reckoning of a train step's all-to-alls on each
    rank: ``calls`` of ``E x min(C, n_local) x D x itemsize`` bytes, C the
    global capacity; 4 (dispatch and combine, forward and backward), or 3
    where the layer's input is a feed (no gradient to send back)."""
    n_tok = B * S
    cap = max(1, int(cf * n_tok * top_k / E))
    return {"calls": calls,
            "bytes": calls * E * min(cap, n_tok // shards) * D * itemsize}


# -- tokens over "ep": the all-to-all ---------------------------------------

@pytest.mark.parametrize("top_k,cf", ep.ROUTING)
def test_tokens_over_ep_equal_the_reference(pools, top_k, cf):
    """ep=4 with ``P("ep")``: each rank two rows, routed globally, its
    expert's tokens arriving by the all-to-all; "ep" is a data axis of
    the step."""
    got = _run(pools, {"ep": 4}, top_k, cf, spec=("ep",))
    for r in got:
        assert r["a2a"] == _a2a_reckoning(top_k, cf, 4)
        assert r["data_axes"] == ("ep",)


@pytest.mark.parametrize("spec", [(("dp", "ep"),), (("ep", "dp"),)],
                         ids=["dp_major", "ep_major"])
def test_tokens_over_dp_and_ep_in_either_order(pools, spec):
    """dp=2 x ep=2, the batch over both axes in the spec's order: the
    rank holding rows [b0, b1) follows that order, and so do its queue
    places."""
    got = _run(pools, {"dp": 2, "ep": 2}, spec=spec)
    for r in got:
        assert r["a2a"] == _a2a_reckoning(2, 1.0, 4)


def test_tokens_over_ep_with_experts_over_tp(pools):
    """ep=2 x tp=2 with ``P("ep")``: the all-to-all over "ep" and
    Megatron inside each expert over "tp"."""
    got = _run(pools, {"ep": 2, "tp": 2}, spec=("ep",))
    for r in got:
        assert r["a2a"] == _a2a_reckoning(2, 1.0, 2)


def test_the_model_axis_layout_sends_no_all_to_all(pools):
    """The default batch spec on ep=4: "ep" stays a model axis (no
    all-to-all, no "ep" among the data axes)."""
    _, params = ep._init(2, 1.0)
    got = pools(4).run("moe_train", timeout_s=120, params=params,
                       cfg=_cfg(2, 1.0), sizes={"ep": 4},
                       batch=ep._batch(params), steps=1, lr=LR)
    assert [(r["a2a"], r["data_axes"]) for r in got] == \
        [({"calls": 0, "bytes": 0}, ())] * 4


# -- the sequence over "sp", a pipeline mesh, biases whole ---------------------

@pytest.mark.parametrize("sizes,spec", [
    ({"dp": 2, "sp": 2}, "seq"),
    ({"sp": 2, "ep": 2}, "seq"),
    ({"sp": 2, "ep": 2}, ("ep", "sp"))],
    ids=["dp2_sp2", "sp2_ep2", "sp2_ep2_tokens_over_both"])
def test_sequence_over_sp_equals_the_reference(pools, sizes, spec):
    """A token's queue place counts every earlier row on all "sp" shards,
    then its row's earlier "sp" shards, then its own shard's."""
    got = _run(pools, sizes, spec=spec)
    for r in got:
        assert "sp" in r["data_axes"]
        assert r["a2a"]["calls"] == (3 if spec != "seq" else 0)


def test_pipeline_mesh_with_the_moe_outside_a_stack(pools):
    _run(pools, {"pp": 2, "ep": 2})


def test_expert_biases_whole(pools):
    """ep=4 under a plan that keeps ``b1``/``b2`` whole beside ``w1``/
    ``w2`` split: each rank reads its block of the biases, and every rank
    ends with the reference's whole biases."""
    rules, whole = ((r"moe/b[12]$", None),), ("b1", "b2")
    got = _run(pools, {"ep": 4}, rules=rules, whole=whole)
    assert got[0]["specs"]["moe.b1"] == ()
    got = _run(pools, {"ep": 4}, spec=("ep",), rules=rules, whole=whole)
    for r in got:
        assert r["grads"]["moe.b1"].shape == (E, FF)


# -- eval, ring attention -----------------------------------------------------

def test_shard_eval_step_with_the_batch_over_dp_and_ep(pools):
    """The reference's ``test_ep_sharded`` (top-2 at capacity factor 2.0
    on a (4, 8, 16) batch) with the batch over ("dp", "ep"): each rank
    one row, the output within 1e-4 of the unplaced layer's on both
    sides; 2 all-to-alls a rank."""
    moe = JM.MoEFeedForward(D, FF, E, top_k=2, capacity_factor=2.0)
    params = jax.device_get(moe.init(jax.random.PRNGKey(0)))
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, D))
    ref, _ = moe(params, x)
    sizes = {"dp": 2, "ep": 2}
    mesh = ep._mesh(sizes)
    with mesh_context(mesh):
        run, placed = jax_api.shard_eval_step(
            lambda p, x: moe(p, x)[0], mesh, params,
            hints=moe.sharding_specs(params), batch_spec=JP(("dp", "ep")))
        jout = run(placed, x=x)
    np.testing.assert_allclose(np.asarray(jout), np.asarray(ref),
                               atol=1e-4, rtol=1e-4)
    got = pools(4).run("moe_eval", timeout_s=120, params=params,
                       cfg=dict(d=D, ff=FF, e=E, top_k=2, cf=2.0),
                       sizes=sizes, x=np.asarray(x),
                       batch_spec=[["dp", "ep"]])
    cap = int(2.0 * 4 * 8 * 2 / E)
    for r in got:
        assert r["w1_local"] == (E // 2, D, FF)
        np.testing.assert_allclose(r["y"], np.asarray(ref), atol=1e-4,
                                   rtol=1e-4)
        assert r["a2a"] == {"calls": 2, "bytes": 2 * E * min(cap, 8) * D * 4}


def test_ring_attention_block_with_the_moe(pools):
    """One ``MultiHeadAttention(attn_impl="ring")`` block and the MoE,
    with residuals, on sp=2 x ep=2 under ``batch_specs(seq_dim=1)``: the
    ring over "sp", the MoE's routing global over it."""
    _run(pools, {"sp": 2, "ep": 2}, spec="seq", ring=True)


# -- noise, the trace, guards ---------------------------------------------------

@pytest.mark.parametrize("sizes,spec,shared", [
    ({"ep": 2, "tp": 2}, ("ep",), ("tp",)),
    ({"dp": 2, "ep": 2}, None, ("ep",)),
    ({"dp": 2, "ep": 2}, (("dp", "ep"),), ())],
    ids=["ep2_tp2_tokens_over_ep", "dp2_ep2_model_axis", "dp2_ep2_tokens"])
def test_router_noise_follows_the_tokens(pools, sizes, spec, shared):
    """Every rank draws its own noise; the placement broadcasts it over
    the axes whose ranks hold the same tokens, and only those."""
    _, params = ep._init(2, 1.0)
    got = pools(4).run("moe_noise", timeout_s=120, params=params,
                       cfg=_cfg(2, 1.0), sizes=sizes, batch_spec=spec)
    assert all(r["shared_axes"] == shared for r in got)
    names = [a for a in ("dp", "tp", "ep") if a in sizes]
    for i in range(4):
        for j in range(i + 1, 4):
            # the mesh is laid out in that axis order, minor last
            ci = np.unravel_index(i, [sizes[a] for a in names])
            cj = np.unravel_index(j, [sizes[a] for a in names])
            same = all(ci[k] == cj[k] for k, a in enumerate(names)
                       if a not in shared)
            assert np.array_equal(got[i]["noise"], got[j]["noise"]) == same


def test_the_exchange_traces_on_fake_tensors(pools):
    """The analysis tier traces a step of tokens over "ep" on fake
    tensors: three ``all_to_all`` nodes (the layer's input is a feed),
    each of the reckoned buffer."""
    _, params = ep._init(2, 1.0)
    got = pools(4).run("moe_trace", timeout_s=120, params=params,
                       cfg=_cfg(2, 1.0), sizes={"ep": 4},
                       batch=ep._batch(params), batch_spec=["ep"])
    cap = int(1.0 * B * S * 2 / E)
    slots = min(cap, B * S // 4)
    for r in got:
        assert r["kinds"].count("all_to_all") == 3
        assert all(int(np.prod(s)) == E * slots * D for s in r["a2a_shapes"])


#: the routing cases where a per-shard MoE drops other tokens than the
#: global one on this batch (elsewhere only its ``aux_loss`` differs)
_OUTPUT_DIFFERS = {"ep": {(1, 1.0), (1, 2.0), (2, 1.0)},
                   "sp": {(1, 2.0), (2, 1.0)}}


@pytest.mark.parametrize("top_k,cf", ep.ROUTING)
@pytest.mark.parametrize("axis", ["ep", "sp"])
def test_routing_each_shard_alone_is_another_layer(axis, top_k, cf):
    """Routing each of 4 row blocks ("ep" as ``P("ep")`` splits them) or
    each sequence half ("sp") on its own gives another ``aux_loss`` than
    the global routing, and in most routing cases another output
    (:data:`_OUTPUT_DIFFERS`): a per-shard MoE would fail the tests
    above."""
    model, params = ep._init(top_k, cf)
    x = jnp.asarray(ep._batch(params)["x"])
    y, aux = model.moe(params["moe"], x)
    parts = (jnp.split(x, 4, axis=0) if axis == "ep"
             else jnp.split(x, 2, axis=1))
    outs = [model.moe(params["moe"], p) for p in parts]
    y_local = jnp.concatenate([o[0] for o in outs], axis=0 if axis == "ep"
                              else 1)
    aux_local = np.mean([float(o[1]["aux_loss"]) for o in outs])
    assert abs(aux_local - float(aux["aux_loss"])) > 1e-3
    assert (float(jnp.abs(y - y_local).max()) > 0.1) == (
        (top_k, cf) in _OUTPUT_DIFFERS[axis])


@pytest.mark.parametrize("router,sizes,spec", [
    ((None, "ep"), {"ep": 2, "tp": 2}, None),
    (("tp", None), {"ep": 2, "tp": 2}, None),
    ((None, "ep"), {"ep": 4}, ("ep",))],
    ids=["experts_over_ep", "rows_over_tp", "tokens_over_ep"])
def test_router_split_equals_the_reference(pools, router, sizes, spec):
    """A plan that splits the router over "ep" (its expert columns) or
    "tp" (its rows): GSPMD gathers it before routing, and so does the
    port; the rank keeps its block, whose gradient is its slice of the
    whole (summed over "ep" where "ep" splits the tokens)."""
    rules = [(r"moe/router$", router)]
    got = _run(pools, sizes, spec=spec, rules=rules)
    axis = next(a for a in router if a)
    for r in got:
        assert r["specs"]["moe.router"] == router
        dim = router.index(axis)
        assert r["grads"]["moe.router"].shape[dim] == \
            r["params"]["moe.router"].shape[dim] // sizes[axis]
