"""The port's cost tier (``paddle_tpu_torch.analysis.cost_model`` and
``hlo_lint``) against the reference's (``paddle_tpu.analysis``): the
reference's ``TestCostModel`` numbers, the matmul and convolution flops
of LeNet's and a narrow ResNet-18's forward, the two train steps' total
flops, ``lint_cost_report``'s findings on the same report contents, and
bucket coverage on the two packages' engines at one tiny configuration.
K1-K4 as registered ops (one node each in a trace, their static work
in the cost), and the collective rules over a two-rank gloo pool."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.analysis import cost_model as ref_cost
from paddle_tpu.analysis import hlo_lint as ref_hlo
from paddle_tpu_torch.analysis import (api, cost_model, estimate_cost,
                                       fx_lint, graph_lint, hlo_lint)
from paddle_tpu_torch.serving import paged_attention as PA
from torch_tp_pool import TpPool

F32 = jnp.float32


def _sds(*shape, dtype=F32):
    return jax.ShapeDtypeStruct(shape, dtype)


# ---------------------------------------------------------------------------
# the reference's TestCostModel numbers
# ---------------------------------------------------------------------------

def test_matmul_flops_and_bytes_exact():
    want = ref_cost.estimate_cost(lambda x, w: x @ w, _sds(8, 16),
                                  _sds(16, 32))
    got = estimate_cost(lambda x, w: x @ w, torch.zeros(8, 16),
                        torch.zeros(16, 32))
    assert got.per_op["mm"].flops == want.per_op["dot_general"].flops \
        == 2 * 8 * 16 * 32
    assert got.total_flops == want.total_flops
    assert (got.arg_bytes, got.out_bytes) == (want.arg_bytes,
                                              want.out_bytes) \
        == ((8 * 16 + 16 * 32) * 4, 8 * 32 * 4)
    assert got.collective_bytes == 0 and not got.collectives
    assert set(got.summary()) == set(want.summary()) == {
        "flops", "peak_hbm_bytes", "traffic_bytes", "collective_bytes"}


def test_in_place_state_lowers_the_peak():
    """The port's counterpart of donation: state written in place
    aliases its input (the reference: a donated input dies at its last
    use). Both packages: the in-place/donated peak is lower by the
    state's bytes, and the written/donated bytes are the state's."""
    a, b = (512, 512), (8,)
    ref_plain = ref_cost.estimate_cost(lambda s, x: s + x.sum(),
                                       _sds(*a), _sds(*b))
    ref_donated = ref_cost.estimate_cost(lambda s, x: s + x.sum(),
                                         _sds(*a), _sds(*b),
                                         donate_argnums=0)

    def in_place(s, x):
        s.add_(x.sum())
        return s
    plain = estimate_cost(lambda s, x: s + x.sum(), torch.zeros(a),
                          torch.zeros(b))
    written = estimate_cost(in_place, torch.zeros(a), torch.zeros(b))
    assert written.peak_hbm_bytes < plain.peak_hbm_bytes
    assert ref_donated.peak_hbm_bytes < ref_plain.peak_hbm_bytes
    assert written.donated_bytes == ref_donated.donated_bytes \
        == 512 * 512 * 4
    assert plain.peak_hbm_bytes - written.peak_hbm_bytes == 512 * 512 * 4


def test_report_roundtrip_and_render():
    r = estimate_cost(lambda x: torch.tanh(x).sum(), torch.zeros(64, 64))
    d = r.as_dict()
    assert d["per_op"]["tanh"]["count"] == 1
    assert d["per_op"]["tanh"]["flops"] == 64 * 64
    assert "flops" in r.render_text()
    rep = api.lint_fn(lambda x: x * 2.0, torch.ones(16), cost=True,
                      registry=False)
    assert rep.cost is not None and rep.cost.summary()["flops"] == 16
    assert '"cost"' in rep.render_json()


# ---------------------------------------------------------------------------
# zoo forwards: matmul + convolution flops equal the reference's exactly
# ---------------------------------------------------------------------------

def _ref_dense_flops(rep):
    return sum(rep.per_op[k].flops for k in ("dot_general", "convolution")
               if k in rep.per_op)


def _port_dense_flops(rep):
    return rep.flops_by_class.get("matmul", 0) + \
        rep.flops_by_class.get("conv", 0)


@pytest.mark.parametrize("name", ["lenet", "resnet18_narrow"])
def test_zoo_forward_dense_flops_equal_the_reference(name):
    import paddle_tpu.models as ref_models
    from paddle_tpu_torch.models.lenet import LeNet
    from paddle_tpu_torch.models.resnet import ResNet
    if name == "lenet":
        ref, port, x = ref_models.LeNet(), LeNet(device="cpu"), (8, 28, 28, 1)
        ref_fwd = ref
    else:
        ref = ref_models.ResNet(depth=18, num_classes=10, width=16, in_ch=3)
        port = ResNet(depth=18, num_classes=10, width=16, in_ch=3,
                      device="cpu").eval()
        x = (2, 32, 32, 3)

        def ref_fwd(p, img):
            return ref(p, img, training=False)
    params = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    want = ref_cost.estimate_cost(ref_fwd, params, _sds(*x))
    got = estimate_cost(lambda m, img: m(img), port, torch.zeros(x))
    assert _port_dense_flops(got) == _ref_dense_flops(want) > 0


@pytest.mark.parametrize("name", ["lenet_train", "resnet18_train"])
def test_train_step_flops_within_one_percent_of_the_reference(name):
    """Tolerance 1% of the total. The matmuls and convolutions (forward
    and both backward legs) agree exactly as above and are >98% of it;
    the rest is elementwise and reduction work whose op mix differs
    between an unfused aten graph and StableHLO (the softmax-CE and its
    gradient, Adam's update, BatchNorm's statistics: e.g. aten's
    ``_foreach_*`` chain against XLA's per-leaf elementwise ops, counted
    one flop per output element in both)."""
    from paddle_tpu import optimizer as ref_opt
    from paddle_tpu.ops import nn as ref_F
    from paddle_tpu.train import build_train_step as ref_build
    from paddle_tpu.train import make_train_state as ref_state
    import paddle_tpu.models as ref_models
    if name == "lenet_train":
        ref = ref_models.LeNet()
        shape = (8, 28, 28, 1)
        surface = graph_lint.lint_lenet
    else:
        ref = ref_models.ResNet(depth=18, num_classes=10, in_ch=3)
        shape = (4, 64, 64, 3)
        surface = graph_lint.lint_resnet18

    def loss_fn(params, image, label):
        kw = {} if name == "lenet_train" else {"training": True}
        logits = ref(params, image, **kw)
        return jnp.mean(ref_F.softmax_with_cross_entropy(logits, label))
    optim = ref_opt.Adam(learning_rate=1e-3)
    state = jax.eval_shape(lambda k: ref_state(ref, optim, k),
                           jax.random.PRNGKey(0))
    step = jax.jit(ref_build(loss_fn, optim), donate_argnums=0)
    lowered = step.lower(state, image=_sds(*shape),
                         label=_sds(shape[0], 1, dtype=jnp.int32))
    want = ref_cost.estimate_lowered(lowered).total_flops
    got = surface(None, cost=True).cost.total_flops
    assert abs(got - want) / want < 0.01, (got, want)


# ---------------------------------------------------------------------------
# lint_cost_report: the same findings on the same report contents
# ---------------------------------------------------------------------------

def _reports():
    port, ref = cost_model.CostReport("step"), ref_cost.CostReport("step")
    for rep, mod, op in ((port, cost_model, "mm"),
                         (ref, ref_cost, "dot_general")):
        rep.per_op[op] = mod.OpCost(count=3, flops=2_000_000, bytes=4096)
        rep.peak_hbm_bytes = 10 << 20
        rep.collectives = [
            mod.Collective("all_reduce", 1 << 20, 1, 2, "tp", "a"),
            mod.Collective("all_reduce", 1 << 19, 1, 2, "tp", "b"),
            mod.Collective("all_gather", 3 << 20, 1, 4, "", "c")]
    return port, ref


LINT_CASES = {
    "allowlist_none": dict(collective_allowlist=None),
    "allowlist_empty": dict(collective_allowlist=[]),
    "allowlist_partial": dict(collective_allowlist=["all_reduce"]),
    "allowlist_all": dict(collective_allowlist=["all_reduce",
                                                "all_gather"]),
    "budgets_exceeded": dict(hbm_budget_bytes=1 << 20,
                             flops_budget=1_000_000),
    "budgets_met": dict(hbm_budget_bytes=64 << 20, flops_budget=10 ** 9,
                        collective_allowlist=[]),
}


@pytest.mark.parametrize("case", sorted(LINT_CASES))
def test_lint_cost_report_equals_the_reference(case):
    """Exact: (rule, severity, message, location) of every finding."""
    port, ref = _reports()
    kw = LINT_CASES[case]
    got = [(f.rule, f.severity, f.message, f.location)
           for f in hlo_lint.lint_cost_report(port, **kw)]
    want = [(f.rule, f.severity, f.message, f.location)
            for f in ref_hlo.lint_cost_report(ref, **kw)]
    assert got == want


# ---------------------------------------------------------------------------
# bucket coverage on both packages' engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) per configuration, built once."""
    from paddle_tpu import serving
    from paddle_tpu.models.gpt import GPT, GPTConfig
    model = GPT(GPTConfig.tiny())
    params = model.init(jax.random.PRNGKey(0))
    out = {}
    for cfg in ((4, 8, 64), (6, 8, 72)):
        slots, page, cap = cfg
        out[cfg] = (serving.ServingEngine(
            model, params, attn_impl="lax", num_slots=slots, page_size=page,
            max_tokens_per_slot=cap),
            graph_lint.tiny_serving_engine(num_slots=slots, page_size=page,
                                           max_tokens_per_slot=cap))
    return out


@pytest.mark.parametrize("cfg", [(4, 8, 64), (6, 8, 72)])
def test_serving_bucket_coverage_both_packages(engines, cfg):
    ref_eng, eng = engines[cfg]
    assert ref_hlo.serving_bucket_coverage(ref_eng) == []
    assert hlo_lint.serving_bucket_coverage(eng) == []
    plan = set(eng.warmup_plan())
    assert plan == set(ref_eng.warmup_plan())
    skipped = sorted(plan, key=str)[0]
    got = hlo_lint.serving_bucket_coverage(eng, warmed=plan - {skipped})
    want = ref_hlo.serving_bucket_coverage(
        ref_eng, warmed=set(ref_eng.warmup_plan()) - {skipped})
    assert [(f.rule, f.location) for f in got] == \
        [(f.rule, f.location) for f in want] == \
        [("bucket-coverage", f"serving:{skipped}")]


@pytest.mark.parametrize("capacity,max_uniq", [(64, 48), (50, 50), (64, 64)])
def test_embedding_bucket_coverage_both_packages(capacity, max_uniq):
    from paddle_tpu.embedding_serving import DeviceEmbeddingCache as RefCache
    from paddle_tpu_torch.embedding_serving import DeviceEmbeddingCache
    ref = RefCache(capacity, 9, min_gather_bucket=8)
    cache = DeviceEmbeddingCache(capacity, 9, min_gather_bucket=8,
                                 device="cpu")
    assert ref_hlo.embedding_bucket_coverage(ref, max_uniq) == []
    assert hlo_lint.embedding_bucket_coverage(cache, max_uniq) == []
    plan = set(cache.warmup_plan(max_uniq))
    assert plan == set(ref.warmup_plan(max_uniq))
    skipped = sorted(plan, key=str)[-1]
    got = hlo_lint.embedding_bucket_coverage(cache, max_uniq,
                                             warmed=plan - {skipped})
    want = ref_hlo.embedding_bucket_coverage(ref, max_uniq,
                                             warmed=plan - {skipped})
    assert [(f.rule, f.location) for f in got] == \
        [(f.rule, f.location) for f in want] == \
        [("bucket-coverage", f"embedding:{skipped}")]
    assert hlo_lint.check_bucket_coverage(cache, max_uniq=max_uniq) == []
    with pytest.raises(ValueError):
        hlo_lint.check_bucket_coverage(cache)


# ---------------------------------------------------------------------------
# K1-K4 as registered ops
# ---------------------------------------------------------------------------

def _decode_inputs():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((4, 2, 16)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal((9, 8, 2, 16)).astype(
        np.float32)) for _ in range(2))
    bt = torch.from_numpy(rng.integers(1, 9, (4, 3)).astype(np.int32))
    lens = torch.tensor([0, 5, 17, 24], dtype=torch.int32)
    return q, kp, vp, bt, lens


def test_paged_ops_trace_as_one_node_with_static_work():
    args = _decode_inputs()
    tr = api.trace(PA.ragged_paged_decode_attention, args)
    summary = fx_lint.graph_summary(tr.gm)
    assert summary == {"ptt.paged_decode": 1}
    cost = cost_model.estimate_lowered(tr)
    nb, fl = PA.decode_static_work(*args)
    assert cost.per_op["ptt.paged_decode"].flops == fl
    assert cost.flops_by_class == {"paged": fl}
    # every column live: the static work is the live work at full lengths
    full = torch.full((4,), 3 * 8, dtype=torch.int32)
    assert (nb, fl) == PA.decode_work(*args[:4], full)
    assert PA.OPS[PA.DECODE.name] == "ptt.paged_decode"


def test_paged_ops_run_the_plain_versions_on_the_cpu():
    args = _decode_inputs()
    before = PA.DECODE.launches
    got = PA.ragged_paged_decode_attention(*args)
    assert torch.equal(got, PA.paged_decode_plain(*args))
    assert torch.equal(torch.ops.ptt.paged_decode(*args, None), got)
    assert PA.DECODE.launches == before
    for name in ("paged_prefill", "paged_decode_int8",
                 "paged_prefill_int8"):
        assert hasattr(torch.ops.ptt, name)


def test_prefill_static_work_fills_every_lane():
    rng = np.random.default_rng(1)
    q = torch.zeros(2, 4, 2, 16)
    kp = torch.zeros(9, 8, 2, 16)
    bt = torch.from_numpy(rng.integers(1, 9, (2, 3)).astype(np.int32))
    nb, fl = PA.prefill_static_work(q, kp, kp, bt, None, None)
    starts = torch.full((2,), 3 * 8 - 4, dtype=torch.int32)
    valid = torch.full((2,), 4, dtype=torch.int32)
    assert (nb, fl) == PA.prefill_work(q, kp, kp, bt, starts, valid)


# ---------------------------------------------------------------------------
# collectives over a two-rank gloo pool
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pool():
    p = TpPool(2)
    yield p
    p.close()


def test_collective_rules_on_two_ranks(pool):
    for res in pool.run("analysis_collectives", timeout_s=120):
        assert res["reduce_empty_allowlist"] == ["unexpected-collective"]
        assert res["reduce_allowlisted"] == []
        assert res["churn"] == ["resharding-churn"]
        assert res["worked"] == []
        assert res["collectives"] == [("all_reduce", 64 * 256 * 4, 2, "tp")]
