"""Expert parallelism in the port's sharded step (``parallel/api.py``
``ExpertPlacement``, ``nn/moe.py``) and the sharded step's wrapped
optimizer, averages and FSDP re-gather, against the JAX package.

The JAX side runs ``shard_train_step`` / ``shard_eval_step`` on the
conftest's virtual CPU devices; the port side runs in gloo pools of CPU
ranks (``torch_tp_pool``) on the same numpy batch and the JAX weights. The
model is ``MoEFeedForward(d=16, ff=32, E=4)`` with a residual and a
replicated linear readout, loss = MSE + 0.01 ``aux_loss``:

- ``dp=2 x ep=2``, ``ep=4`` and ``dp=2 x ep=4``, top-1 and top-2 at
  capacity factor 1.0 (tokens dropped) and 2.0, on a batch whose two
  data halves route unevenly (so that routing each shard on its own would
  give other capacities, drops and ``aux_loss``): losses over 4 AdamW
  steps within rtol 2e-5 / atol 2e-6, ``aux_loss`` alike, the expert
  counts equal, the final parameters gathered within 1e-5, and each
  rank's expert bytes 1/ep of the whole;
- ``ep=2 x tp=2`` (the hints split the experts over both);
- ``shard_eval_step`` on the reference's ``test_ep_sharded`` setup;
- the layout a placed MoE still refuses (a MoE in a pipelined stack),
  and router noise alike on the ranks of a data shard;
- ``LookaheadOptimizer`` over Momentum and AdamW on ``fsdp`` and
  ``dp x ep`` meshes (losses, parameters and slow weights), and
  ``ExponentialMovingAverage`` / ``ModelAverage`` over the placed
  parameters;
- FSDP's re-gather in the backward: the same bits as keeping the
  gathered parameters, with the graph holding only blocks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu import train as jtrain
from paddle_tpu.core.mesh import MeshConfig, make_mesh, mesh_context
from paddle_tpu.nn import moe as JM
from paddle_tpu.parallel import api as jax_api
from paddle_tpu.parallel import plan as jax_plan
from paddle_tpu_torch.nn.module import sharding_specs
from paddle_tpu_torch.parallel import plan as port_plan
from paddle_tpu_torch.train import make_train_state
from torch_tp_pool import TpPool, _wrapped_optimizer, moe_net

torch.set_num_threads(2)

D, FF, E, OUT = 16, 32, 4, 8
B, S = 8, 8
STEPS = 4
#: AdamW's normalised update turns the rounding of a near-zero gradient
#: into up to ~1e-3 of its learning rate (the JAX step alone, on one device
#: and on ep=4, parts by 9e-6 at 1e-2), so AdamW steps at 1e-3
LR = {"adamw": 1e-3, "momentum": 1e-2}
LOSS_TOL = dict(rtol=2e-5, atol=2e-6)
PARAM_ATOL = 1e-5


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


class _JaxMoeNet(jnn.Layer):
    """The reference's side of ``torch_tp_pool.moe_net``."""

    def __init__(self, top_k, cf):
        super().__init__()
        self.moe = JM.MoEFeedForward(D, FF, E, top_k=top_k,
                                     capacity_factor=cf)
        self.readout = jnn.Linear(D, OUT, sharding=None)

    def forward(self, params, x):
        y, aux = self.moe(params["moe"], x)
        return self.readout(params["readout"], x + y), aux


def _jax_loss(model):
    def loss_fn(params, x, y):
        out, aux = model(params, x)
        loss = jnp.mean((out - y) ** 2) + 0.01 * aux["aux_loss"]
        counts = aux["expert_counts"].astype(jnp.float32)
        return loss, {"aux_loss": aux["aux_loss"],
                      **{f"count_{i}": counts[i] for i in range(E)}}
    return loss_fn


def _cfg(top_k, cf):
    return dict(d=D, ff=FF, e=E, out=OUT, top_k=top_k, cf=cf)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict)
                   else {name: np.asarray(v)})
    return out


@functools.lru_cache(maxsize=None)
def _init(top_k, cf):
    model = _JaxMoeNet(top_k, cf)
    return model, jax.device_get(model.init(jax.random.PRNGKey(0)))


def _batch(params, seed=1):
    """x (B, S, D) whose second half of rows leans toward expert 0 (so
    the two data halves route unevenly), and a regression target."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    r0 = np.asarray(params["moe"]["router"])[:, 0]
    x[B // 2:] += 1.5 * r0 / np.linalg.norm(r0)
    y = rng.standard_normal((B, S, OUT)).astype(np.float32)
    return {"x": x, "y": y}


def _jax_opt(name, lookahead=None):
    inner = {"adamw": lambda: joptim.AdamW(learning_rate=LR[name]),
             "momentum": lambda: joptim.Momentum(learning_rate=LR[name],
                                                 momentum=0.9)}[name]()
    return inner if lookahead is None else joptim.LookaheadOptimizer(
        inner, **lookahead)


def _mesh(sizes):
    n = int(np.prod(list(sizes.values())))
    return make_mesh(MeshConfig(**sizes), devices=jax.devices()[:n])


@functools.lru_cache(maxsize=None)
def _jax_run(top_k, cf, sizes, opt="adamw", lookahead=None,
             plan_name="hints", average=None):
    """The JAX sharded step's metrics and final parameters (and slow
    weights, average) over ``STEPS`` steps on a mesh of ``sizes`` (a
    tuple of items)."""
    sizes = dict(sizes)
    lookahead = dict(lookahead) if lookahead else None
    model, params = _init(top_k, cf)
    optim = _jax_opt(opt, lookahead)
    step = jtrain.build_train_step(_jax_loss(model), optim)
    state = jtrain.make_train_state(model, optim, jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in _batch(params).items()}
    mesh = _mesh(sizes)
    plan, hints = ((jax_plan.fsdp_plan(min_size=64), {"params": None})
                   if plan_name == "fsdp"
                   else (jax_plan.ShardingPlan(),
                         model.sharding_specs(state["params"])))
    avg = {"ema": lambda: joptim.ExponentialMovingAverage(decay=0.9),
           "model_average": joptim.ModelAverage}.get(average)
    avg = avg() if avg else None
    with mesh_context(mesh):
        # no donation: a Lookahead's slow weights start as the very
        # arrays of the parameters, which XLA will not donate twice
        run, placed = jax_api.shard_train_step(step, mesh, state, plan=plan,
                                               hints=hints,
                                               donate_state=False)
        avg_state = avg.init(placed["params"]) if avg else None
        metrics = []
        for _ in range(STEPS):
            placed, m = run(placed, **batch)
            metrics.append({k: float(v) for k, v in m.items()})
            if avg:
                avg_state = avg.update(avg_state, placed["params"])
    out = {"metrics": metrics,
           "params": _flat(jax.device_get(placed["params"]))}
    if lookahead:
        out["slow"] = _flat(jax.device_get(placed["opt"]["slow"]))
    if avg:
        out["average"] = _flat(jax.device_get(avg.apply(avg_state)))
    return params, out


def _items(d):
    return tuple(sorted(d.items())) if d else None


def _check(got, want, sizes, whole=()):
    """``whole``: expert tensors the plan keeps whole (no "ep" in their
    spec)."""
    for r in got:
        for key in ("loss", "aux_loss"):
            np.testing.assert_allclose([m[key] for m in r["metrics"]],
                                       [m[key] for m in want["metrics"]],
                                       err_msg=key, **LOSS_TOL)
        for i in range(E):
            assert [m[f"count_{i}"] for m in r["metrics"]] == \
                [m[f"count_{i}"] for m in want["metrics"]], i
        for k, v in want["params"].items():
            np.testing.assert_allclose(r["params"][k], v, rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)
            np.testing.assert_array_equal(r["params"][k],
                                          got[0]["params"][k], err_msg=k)
    # each rank holds its block of every expert tensor: 1/ep of it, and
    # 1/tp, 1/fsdp more where its spec names them
    block = 0
    for k, v in want["params"].items():
        if k.split(".")[-1] in ("w1", "b1", "w2", "b2"):
            axes = [a for e in got[0]["specs"][k] if e is not None
                    for a in ((e,) if isinstance(e, str) else e)]
            assert "ep" in axes or "ep" not in sizes \
                or k.split(".")[-1] in whole, k
            block += v.nbytes // int(np.prod([sizes.get(a, 1)
                                              for a in axes]))
    assert [r["expert_bytes"] for r in got] == [block] * len(got)


ROUTING = [(1, 1.0), (1, 2.0), (2, 1.0), (2, 2.0)]


@pytest.mark.parametrize("top_k,cf", ROUTING)
def test_the_batch_routes_unevenly_over_the_data_shards(top_k, cf):
    """Routing each data half on its own gives another ``aux_loss`` than
    the global routing the reference does (a mean of the halves'
    products of means), and, wherever a half overflows its own half
    capacity, another output: a per-rank MoE would fail the tests
    below. Only top-2 at 2.0 drops nothing either way."""
    model, params = _init(top_k, cf)
    x = jnp.asarray(_batch(params)["x"])
    y, aux = model.moe(params["moe"], x)
    halves = [model.moe(params["moe"], h) for h in (x[:B // 2],
                                                    x[B // 2:])]
    y_local = jnp.concatenate([h[0] for h in halves])
    aux_local = np.mean([float(h[1]["aux_loss"]) for h in halves])
    assert abs(aux_local - float(aux["aux_loss"])) > 1e-2
    assert (float(jnp.abs(y - y_local).max()) > 0.5) == ((top_k, cf)
                                                         != (2, 2.0))
    first, second = (np.asarray(h[1]["expert_counts"]) for h in halves)
    assert second[0] >= first[0] + 10


def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return () if tree is None else tuple(tree)


@pytest.mark.parametrize("lookahead", [None, {"alpha": 0.5, "k": 2}],
                         ids=["adamw", "lookahead"])
@pytest.mark.parametrize("plan_name", ["replicated", "fsdp"])
def test_state_specs_of_the_moe_equal_the_reference(plan_name, lookahead):
    """The layer's "ep" hints through ``plan.state_specs`` as the
    reference gives them: the experts over "ep" (and "tp"), AdamW's slots
    like their parameters, a Lookahead's state replicated."""
    model, params = _init(2, 1.0)
    jopt = _jax_opt("adamw", lookahead)
    jstate = jtrain.make_train_state(model, jopt, jax.random.PRNGKey(0))
    make = {"replicated": lambda p: p.ShardingPlan(),
            "fsdp": lambda p: p.fsdp_plan(min_size=64)}[plan_name]
    want = _tuples(make(jax_plan).state_specs(
        jstate, model.sharding_specs(jstate["params"])))
    pm = moe_net(params, _cfg(2, 1.0))
    state = make_train_state(pm, _wrapped_optimizer("adamw", pm.parameters(),
                                                LR["adamw"], lookahead))
    got = make(port_plan).state_specs(state, sharding_specs(pm))
    assert got == want
    assert got["params"]["moe"]["w1"][0] == "ep"


EP_MESHES = [({"dp": 2, "ep": 2}, 4), ({"ep": 4}, 4)]


@pytest.mark.parametrize("top_k,cf", ROUTING)
@pytest.mark.parametrize("sizes,n", EP_MESHES,
                         ids=["dp2_ep2", "ep4"])
def test_expert_parallel_equals_the_reference(pools, sizes, n, top_k, cf):
    params, want = _jax_run(top_k, cf, _items(sizes))
    got = pools(n).run("moe_train", timeout_s=120, params=params,
                       cfg=_cfg(top_k, cf), sizes=sizes,
                       batch=_batch(params), steps=STEPS, lr=LR["adamw"])
    assert got[0]["specs"]["moe.w1"] == ("ep", None, "tp")
    _check(got, want, sizes)


def test_dp2_ep4_equals_the_reference(pools):
    sizes = {"dp": 2, "ep": 4}
    params, want = _jax_run(2, 1.0, _items(sizes))
    got = pools(8).run("moe_train", timeout_s=180, params=params,
                       cfg=_cfg(2, 1.0), sizes=sizes, batch=_batch(params),
                       steps=STEPS, lr=LR["adamw"])
    _check(got, want, sizes)


def test_experts_over_ep_and_tp_equal_the_reference(pools):
    """The hints split ``w1``/``b1`` by columns and ``w2`` by rows over
    "tp" beside "ep": Megatron inside each expert."""
    sizes = {"ep": 2, "tp": 2}
    params, want = _jax_run(2, 1.0, _items(sizes))
    got = pools(4).run("moe_train", timeout_s=120, params=params,
                       cfg=_cfg(2, 1.0), sizes=sizes, batch=_batch(params),
                       steps=STEPS, lr=LR["adamw"])
    _check(got, want, sizes)


@pytest.mark.parametrize("sizes,n", [({"dp": 2, "ep": 2}, 4),
                                     ({"dp": 2, "ep": 4}, 8)],
                         ids=["dp2_ep2", "dp2_ep4"])
def test_shard_eval_step_equals_test_ep_sharded(pools, sizes, n):
    """The reference's ``test_ep_sharded``: top-2 at capacity factor 2.0
    on a (4, 8, 16) batch, the placed layer's output against the
    unplaced one within 1e-4."""
    moe = JM.MoEFeedForward(D, FF, E, top_k=2, capacity_factor=2.0)
    params = jax.device_get(moe.init(jax.random.PRNGKey(0)))
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, D))
    ref, _ = moe(params, x)
    mesh = _mesh(sizes)
    hints = moe.sharding_specs(params)
    with mesh_context(mesh):
        run, placed = jax_api.shard_eval_step(
            lambda p, x: moe(p, x)[0], mesh, params, hints=hints)
        jout = run(placed, x=x)
    np.testing.assert_allclose(np.asarray(jout), np.asarray(ref),
                               atol=1e-4, rtol=1e-4)
    got = pools(n).run("moe_eval", timeout_s=120, params=params,
                       cfg=dict(d=D, ff=FF, e=E, top_k=2, cf=2.0),
                       sizes=sizes, x=np.asarray(x))
    for r in got:
        assert r["w1_local"] == (E // sizes["ep"], D, FF)
        np.testing.assert_allclose(r["y"], np.asarray(ref), atol=1e-4,
                                   rtol=1e-4)


def test_refused_layouts_name_the_case(pools):
    """The one layout a placed MoE still refuses: a MoE inside a stack on
    a pipeline. (Tokens over "ep", a live "pp" with the MoE outside a
    stack, whole biases and a router split over "ep" or "tp" run since:
    ``test_torch_expert_layouts.py`` holds them to the reference.)"""
    _, params = _init(1, 1.0)
    got = pools(4).run("moe_refusals", timeout_s=120, params=params,
                       cfg=_cfg(1, 1.0))[0]
    assert sorted(got) == ["pipelined_stack"]
    assert "a MoEFeedForward inside a pipelined stack" \
        in got["pipelined_stack"]
    assert "aux_loss" in got["pipelined_stack"]


def test_router_noise_is_the_same_on_the_ranks_of_a_data_shard(pools):
    """Every rank draws its noise from its own generator; the placement
    broadcasts it over "ep", so the two ranks of a data shard route
    alike: every rank reports the same metrics (a data shard whose ranks
    routed apart would report two ``aux_loss`` values)."""
    _, params = _init(2, 1.0)
    cfg = dict(_cfg(2, 1.0), noise=1.0)
    got = pools(4).run("moe_train", timeout_s=120, params=params, cfg=cfg,
                       sizes={"dp": 2, "ep": 2}, batch=_batch(params),
                       steps=2, noise_seed=11)
    quiet = pools(4).run("moe_train", timeout_s=120, params=params,
                         cfg=_cfg(2, 1.0), sizes={"dp": 2, "ep": 2},
                         batch=_batch(params), steps=2)
    assert all(r["metrics"] == got[0]["metrics"] for r in got)
    assert got[0]["metrics"] != quiet[0]["metrics"]


# -- the sharded step's wrapped optimizer and averages ------------------------

WRAPPED_MESHES = [("fsdp", {"fsdp": 4}), ("hints", {"dp": 2, "ep": 2})]


@pytest.mark.parametrize("opt", ["momentum", "adamw"])
@pytest.mark.parametrize("plan_name,sizes", WRAPPED_MESHES,
                         ids=["fsdp4", "dp2_ep2"])
def test_lookahead_equals_the_reference(pools, plan_name, sizes, opt):
    """``LookaheadOptimizer(alpha=0.5, k=2)``: two pulls toward the slow
    weights in 4 steps. Losses, parameters and slow weights against the
    JAX sharded step (which replicates the slow weights; the port splits
    them like their parameters)."""
    lookahead = {"alpha": 0.5, "k": 2}
    params, want = _jax_run(2, 1.0, _items(sizes), opt=opt,
                            lookahead=_items(lookahead),
                            plan_name=plan_name)
    got = pools(4).run("moe_train", timeout_s=120, params=params,
                       cfg=_cfg(2, 1.0), sizes=sizes, batch=_batch(params),
                       steps=STEPS, opt=opt, lr=LR[opt], lookahead=lookahead,
                       plan_name=plan_name)
    for r in got:
        np.testing.assert_allclose([m["loss"] for m in r["metrics"]],
                                   [m["loss"] for m in want["metrics"]],
                                   **LOSS_TOL)
        for key in ("params", "slow"):
            for k, v in want[key].items():
                np.testing.assert_allclose(r[key][k], v, rtol=0,
                                           atol=PARAM_ATOL,
                                           err_msg=f"{key} {k}")


@pytest.mark.parametrize("average,plan_name,sizes", [
    ("ema", "fsdp", {"fsdp": 4}),
    ("model_average", "hints", {"dp": 2, "ep": 2})],
    ids=["ema_fsdp4", "model_average_dp2_ep2"])
def test_averages_over_placed_parameters(pools, average, plan_name, sizes):
    params, want = _jax_run(1, 1.0, _items(sizes), opt="momentum",
                            plan_name=plan_name, average=average)
    got = pools(4).run("moe_train", timeout_s=120, params=params,
                       cfg=_cfg(1, 1.0), sizes=sizes, batch=_batch(params),
                       steps=STEPS, opt="momentum", lr=LR["momentum"],
                       plan_name=plan_name,
                       average=average)
    for r in got:
        for k, v in want["average"].items():
            np.testing.assert_allclose(r["average"][k], v, rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)


# -- FSDP's re-gather in the backward -----------------------------------------

def test_fsdp_regather_is_bit_identical_and_saves_blocks(pools):
    """fsdp=4 with the re-gather and with the gathered parameters kept:
    the same metrics, parameters and last gradients bit for bit, and
    against the reference; the saved-tensor hook counts what the graph
    holds: with the re-gather no gathered parameter and only blocks,
    without it the gathered parameters and no block."""
    sizes = {"fsdp": 4}
    params, want = _jax_run(2, 1.0, _items(sizes), opt="adamw",
                            plan_name="fsdp")
    runs = {regather: pools(4).run(
        "moe_train", timeout_s=120, params=params, cfg=_cfg(2, 1.0),
        sizes=sizes, batch=_batch(params), steps=STEPS, lr=LR["adamw"],
        plan_name="fsdp",
        regather=regather) for regather in (True, False)}
    for new, old in zip(runs[True], runs[False]):
        assert new["metrics"] == old["metrics"]
        for key in ("params", "grads"):
            for k, v in old[key].items():
                np.testing.assert_array_equal(new[key][k], v,
                                              err_msg=f"{key} {k}")
        assert new["saved"]["gathered"] == 0 < new["saved"]["blocks"]
        assert old["saved"]["blocks"] == 0 < old["saved"]["gathered"]
        # a gathered parameter is fsdp (4) blocks
        assert old["saved"]["gathered"] == 4 * new["saved"]["blocks"]
    _check(runs[True], want, sizes)
