"""The port's DeepFM (``paddle_tpu_torch.models.deepfm``), its host-KV
train step (``parallel.host_kv``) and its vocab-parallel embedding
(``parallel.embedding``) against the JAX package on the CPU: logits,
losses and gradients within 1e-5, the train step over 3 steps (losses
and store rows), and the sharded lookup at tp=2 on gloo ranks against
the reference's on the CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jax_opt
from paddle_tpu.core.mesh import MeshConfig, make_mesh, mesh_context
from paddle_tpu.models.deepfm import DeepFM as JaxDeepFM
from paddle_tpu.models.deepfm import DeepFMHostKV as JaxDeepFMHostKV
from paddle_tpu.parallel import host_kv as jax_kv
from paddle_tpu.parallel.embedding import (
    ShardedEmbedding as JaxShardedEmbedding)
from paddle_tpu.parallel.embedding import \
    vocab_parallel_lookup as jax_lookup
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models.deepfm import DeepFM, DeepFMHostKV
from paddle_tpu_torch.ops.nn import sigmoid_cross_entropy_with_logits
from paddle_tpu_torch.parallel import host_kv as kv
from paddle_tpu_torch.parallel.embedding import (ShardedEmbedding,
                                                 vocab_parallel_lookup)
from paddle_tpu_torch.train import make_train_state
from torch_tp_pool import TpPool

torch.set_num_threads(2)
F, D, B = 5, 4, 16


@pytest.fixture(scope="module")
def pool():
    p = TpPool(2)
    yield p
    p.close()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _batch(seed, vocab=64, b=B, f=F):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(b, f)).astype(np.int64)
    label = (rng.random(b) < 0.4).astype(np.float32)
    vals = rng.random((b, f)).astype(np.float32)
    return ids, label, vals


@pytest.mark.parametrize("x", [0.0, 3.5, -40.0, 80.0])
def test_sigmoid_cross_entropy_with_logits_equals_the_reference(x):
    from paddle_tpu.ops import nn as jax_nn
    xs = np.array([x, -x, x / 3], np.float32)
    z = np.array([1.0, 0.0, 0.5], np.float32)
    want = np.asarray(jax_nn.sigmoid_cross_entropy_with_logits(xs, z))
    got = sigmoid_cross_entropy_with_logits(torch.from_numpy(xs),
                                            torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hidden", [(16, 8), ()])
@pytest.mark.parametrize("with_vals", [False, True])
def test_host_kv_model_logits_loss_and_gradients(hidden, with_vals):
    jm = JaxDeepFMHostKV(num_fields=F, embed_dim=D, hidden=hidden)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1)))
    pm = DeepFMHostKV.from_jax(params, F, device="cpu")
    assert pm.embed_dim == D and len(pm.dnn) == len(hidden)
    rng = np.random.default_rng(0)
    rows = rng.normal(0, 0.3, size=(32, 1 + D)).astype(np.float32)
    inv = rng.integers(0, 20, size=(B, F)).astype(np.int32)
    _, label, vals = _batch(1)
    fv = vals if with_vals else None

    def jloss(p, r):
        return jm.loss(p, r, inv, label, fv)[0]

    (jl, (jgp, jgr)) = jax.value_and_grad(jloss, argnums=(0, 1))(
        params, jnp.asarray(rows))
    rows_t = torch.from_numpy(rows).requires_grad_(True)
    fv_t = None if fv is None else torch.from_numpy(fv)
    logits = pm(rows_t, torch.from_numpy(inv), fv_t)
    np.testing.assert_allclose(
        logits.detach().numpy(), np.asarray(jm(params, rows, inv, fv)),
        rtol=1e-5, atol=1e-5)
    loss, aux = pm.loss(rows_t, torch.from_numpy(inv),
                        torch.from_numpy(label), fv_t)
    loss.backward()
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    np.testing.assert_allclose(rows_t.grad.numpy(), np.asarray(jgr),
                               rtol=1e-5, atol=1e-6)
    want = _flat(jgp)
    got = {k: p.grad.numpy() for k, p in pm.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    # the tree goes back the other way with a plain key flatten
    back = _flat(convert.params_tree(
        pm, {k: p.detach().numpy() for k, p in pm.named_parameters()}))
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(back[k], v)


def test_on_chip_table_model_logits_loss_and_gradients():
    jm = JaxDeepFM(64, F, embed_dim=D, hidden=(16, 8))
    params = jax.device_get(jm.init(jax.random.PRNGKey(2)))
    pm = DeepFM.from_jax(params, F, device="cpu")
    ids, label, _ = _batch(3)

    def jloss(p):
        return jm.loss(p, ids, label)[0]

    jl, jg = jax.value_and_grad(jloss)(params)
    np.testing.assert_allclose(pm(torch.from_numpy(ids)).detach().numpy(),
                               np.asarray(jm(params, ids)), rtol=1e-5,
                               atol=1e-5)
    loss, _ = pm.loss(torch.from_numpy(ids), torch.from_numpy(label))
    loss.backward()
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    for k, v in _flat(jg).items():
        np.testing.assert_allclose(dict(pm.named_parameters())[k].grad,
                                   v, rtol=1e-5, atol=1e-6, err_msg=k)


def test_seeded_init_follows_the_reference_schemes():
    m = DeepFMHostKV(26, 16, (400, 400), device="cpu", seed=0)
    again = DeepFMHostKV(26, 16, (400, 400), device="cpu", seed=0)
    for (k, a), (_, b) in zip(m.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), k
    limit = (6.0 / (416 + 400)) ** 0.5
    w = m.dnn[0].weight
    assert w.abs().max() <= limit and w.abs().max() > 0.9 * limit
    assert not m.dnn[0].bias.any() and not m.bias.any()
    t = DeepFM(1000, 4, 8, (16,), device="cpu").embedding.weight
    assert abs(float(t.std()) - 0.01) < 2e-3
    assert DeepFMHostKV.kv_dim_for(16) == 17


@pytest.mark.parametrize("prefetch", [False, True])
def test_host_kv_train_steps_equal_the_reference(prefetch):
    """3 steps of ``run_kv_epoch`` (Adam on the towers, adagrad on the
    host rows) in each package from the same weights and store seed:
    per-step losses and the store's rows within 1e-5."""
    vocab, lr = 300, 0.05
    jm = JaxDeepFMHostKV(num_fields=F, embed_dim=D, hidden=(16, 8))
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    batches = []
    for i in range(3):
        ids, label, _ = _batch(10 + i, vocab=vocab)
        batches.append(dict(feat_ids=ids, label=label))

    jopt = jax_opt.Adam(learning_rate=1e-3)
    jstate = {"params": params, "opt": jopt.init(params),
              "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(jax_kv.build_kv_train_step(
        lambda p, rows, inv, label: jm.loss(p, rows, inv, label), jopt))
    jstore = jax_kv.HostKVStore(1 + D, optimizer="adagrad", seed=4)
    jemb = jax_kv.HostKVEmbedding(jstore, lr=lr, min_bucket=32)
    jstate, jhist = jax_kv.run_kv_epoch(
        jstep, jstate, jemb,
        [dict(b, label=jnp.asarray(b["label"])) for b in batches],
        prefetch=prefetch)

    pm = DeepFMHostKV.from_jax(params, F, device="cpu")
    popt = opt.Adam(pm.parameters(), learning_rate=1e-3)
    state = make_train_state(pm, popt)
    step = kv.build_kv_train_step(
        lambda m, rows, inv, label: m.loss(rows, inv, label), popt)
    store = kv.HostKVStore(1 + D, optimizer="adagrad", seed=4)
    emb = kv.HostKVEmbedding(store, lr=lr, min_bucket=32)
    state, hist = kv.run_kv_epoch(step, state, emb, batches,
                                  prefetch=prefetch)

    assert int(state["step"]) == 3 and len(hist) == 3
    for a, b in zip(hist, jhist):
        assert float(a["loss"]) == pytest.approx(float(b["loss"]), rel=1e-5)
        assert float(a["prob_mean"]) == pytest.approx(
            float(b["prob_mean"]), rel=1e-5)
    every = np.arange(vocab, dtype=np.int64)
    assert len(store) == len(jstore)
    np.testing.assert_allclose(store.pull(every), jstore.pull(every),
                               rtol=1e-5, atol=1e-7)
    want = _flat(jax.device_get(jstate["params"]))
    for k, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_row_gradients_are_bit_reproducible():
    pm = DeepFMHostKV(F, D, (16,), device="cpu", seed=3)
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.normal(size=(64, 1 + D)).astype(np.float32))
    inv = torch.from_numpy(rng.integers(0, 40, size=(256, F)))
    label = torch.from_numpy((rng.random(256) < 0.5).astype(np.float32))
    grads = []
    for _ in range(2):
        r = rows.clone().requires_grad_(True)
        pm.loss(r, inv, label)[0].backward()
        grads.append(r.grad)
    assert torch.equal(grads[0], grads[1])


# -- the vocab-parallel lookup -------------------------------------------------

@pytest.fixture(scope="module")
def jax_tp_mesh():
    return make_mesh(MeshConfig(dp=4, tp=2))


def test_lookup_without_a_mesh_is_a_plain_take():
    table = torch.arange(12.0).reshape(6, 2)
    out = vocab_parallel_lookup(torch.tensor([0, 5]), table)
    np.testing.assert_array_equal(out.numpy(), [[0, 1], [10, 11]])
    layer = ShardedEmbedding(16, 4, combiner="sum", device="cpu")
    layer.reset_parameters(torch.Generator().manual_seed(0))
    got = layer(torch.tensor([[1, 2, 3]]))
    np.testing.assert_allclose(got[0].detach().numpy(),
                               layer.weight[1:4].sum(0).detach().numpy())


@pytest.mark.parametrize("combiner,padding_idx", [
    (None, None), ("sum", None), ("mean", 0), (None, 3)])
def test_sharded_lookup_at_tp2_equals_the_reference(pool, jax_tp_mesh,
                                                    combiner, padding_idx):
    rng = np.random.default_rng(7)
    table = rng.normal(size=(32, 8)).astype(np.float32)
    ids = rng.integers(0, 32, size=(4, 6)).astype(np.int64)
    ids[0, :3] = 1                                  # a repeated id
    ids[1, 0] = 0
    layer = JaxShardedEmbedding(32, 8, combiner=combiner,
                                padding_idx=padding_idx)
    shape = (4, 8) if combiner else (4, 6, 8)
    g = rng.normal(size=shape).astype(np.float32)

    def f(t):
        return layer({"weight": t}, jnp.asarray(ids))

    with mesh_context(jax_tp_mesh):
        want = np.asarray(jax.jit(f)(jnp.asarray(table)))
        want_g = np.asarray(jax.jit(jax.grad(
            lambda t: (f(t) * g).sum()))(jnp.asarray(table)))
        plain = np.asarray(jax.jit(lambda t: jax_lookup(
            jnp.asarray(ids), t, mesh=jax_tp_mesh))(jnp.asarray(table)))
    got = pool.run("embed_lookup", timeout_s=60, table=table, ids=ids, g=g,
                   combiner=combiner, padding_idx=padding_idx)
    for rank, (out, grad, lookup) in enumerate(got):
        np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(lookup, plain, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(grad, want_g[rank * 16:(rank + 1) * 16],
                                   rtol=1e-6, atol=1e-6)


def test_deepfm_with_tables_split_at_tp2_equals_the_reference(pool):
    jm = JaxDeepFM(64, F, embed_dim=D, hidden=(16, 8))
    params = jax.device_get(jm.init(jax.random.PRNGKey(5)))
    ids, label, _ = _batch(8)
    jl, jg = jax.value_and_grad(lambda p: jm.loss(p, ids, label)[0])(params)
    want = _flat(jg)
    got = pool.run("deepfm_tp", timeout_s=60, params=params, num_fields=F,
                   feat_ids=ids, label=label)
    for rank, (loss, logits, grads) in enumerate(got):
        assert loss == pytest.approx(float(jl), rel=1e-5)
        np.testing.assert_allclose(logits, np.asarray(jm(params, ids)),
                                   rtol=1e-5, atol=1e-5)
        for k, v in want.items():
            if k in ("embedding.weight", "linear_w.weight"):
                v = v[rank * 32:(rank + 1) * 32]
            np.testing.assert_allclose(grads[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
