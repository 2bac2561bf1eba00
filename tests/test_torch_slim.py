"""The rest of the port's ``slim`` (``paddle_tpu_torch.slim``) against the
JAX package's ``paddle_tpu.slim`` on the same numpy weights and batches
from seeds: magnitude masks equal (ties at the threshold pruned alike),
``sparsity_of``, three pruned SGD-momentum steps of a two-layer MLP
(parameters within 1e-5, the pruned weights exactly 0), the sensitivity
sweep's losses within 1e-6 relative, the distillation losses
(``soft_label_loss``, ``fsp_matrix``, ``fsp_loss``, ``distill_loss_fn``)
and their gradients within 1e-5, ``sa_search``'s trajectory equal for one
seed, and QAT's fake-quantised loss, its straight-through gradients and
``qat_convert`` within 1e-6 (per tensor and per channel; a conv's OIHW
weight against the reference's HWIO)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from paddle_tpu import optimizer as jopt
from paddle_tpu import slim as jslim
from paddle_tpu import train as jtrain
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch import slim
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.train import build_train_step, make_train_state

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)


def _weights(seed=0, din=8, hidden=16, dout=4):
    rng = np.random.default_rng(seed)
    w = {"fc1": {"weight": rng.standard_normal((din, hidden), np.float32),
                 "bias": rng.standard_normal(hidden, np.float32) * 0.1},
         "fc2": {"weight": rng.standard_normal((hidden, dout), np.float32),
                 "bias": rng.standard_normal(dout, np.float32) * 0.1}}
    # ties at the magnitude threshold
    w["fc1"]["weight"][0, :4] = 0.5
    w["fc1"]["weight"][1, :4] = -0.5
    return w


def _batch(seed=1, b=12):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((b, 8), np.float32),
            "y": rng.standard_normal((b, 4), np.float32)}


class _MLP(nn.Module):
    def __init__(self, w):
        super().__init__()
        self.fc1 = Linear(8, 16, device="cpu")
        self.fc2 = Linear(16, 4, device="cpu")
        with torch.no_grad():
            for name in ("fc1", "fc2"):
                for k, v in w[name].items():
                    getattr(self, name)._parameters[k].copy_(
                        torch.from_numpy(v))

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _jax_mlp(p, x):
    h = jax.nn.relu(x @ p["fc1"]["weight"] + p["fc1"]["bias"])
    return h @ p["fc2"]["weight"] + p["fc2"]["bias"]


def _jax_loss(p, x, y):
    return jnp.mean((_jax_mlp(p, x) - y) ** 2)


def _port_loss(m, x, y):
    return torch.mean((m(x) - y) ** 2)


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _close_trees(got, want, **tol):
    for k, v in want.items():
        if isinstance(v, dict):
            _close_trees(got[k], v, **tol)
        else:
            np.testing.assert_allclose(
                got[k].detach().numpy() if isinstance(got[k], torch.Tensor)
                else got[k], np.asarray(v), err_msg=k, **tol)


@pytest.mark.parametrize("sparsity", [0.0, 0.25, 0.5, 0.9])
def test_masks_and_sparsity_equal_the_reference(sparsity):
    w = _weights()
    want = jslim.magnitude_prune_masks(w, sparsity)
    got = slim.magnitude_prune_masks(_torch_tree(w), sparsity)
    _close_trees(got, want, rtol=0, atol=0)
    assert slim.sparsity_of(got) == jslim.sparsity_of(want)
    applied = slim.apply_masks(_torch_tree(w), got)
    _close_trees(applied, jslim.apply_masks(w, want), rtol=0, atol=0)
    with pytest.raises(ValueError):
        slim.magnitude_prune_masks(_torch_tree(w), 1.0)


def test_pruned_steps_equal_the_reference():
    w, batch = _weights(), _batch()
    jmasks = jslim.magnitude_prune_masks(w, 0.5)
    optimizer = jopt.Momentum(learning_rate=0.1, momentum=0.9)
    params = jax.tree_util.tree_map(jnp.asarray, w)
    jstate = {"params": params, "opt": optimizer.init(params),
              "step": jnp.zeros((), jnp.int32)}
    jstep = jslim.pruned_train_step(
        jtrain.build_train_step(_jax_loss, optimizer), jmasks)
    model = _MLP(w)
    opt = popt.Momentum(model.parameters(), learning_rate=0.1, momentum=0.9)
    state = make_train_state(model, opt)
    masks = slim.magnitude_prune_masks(
        {k: {n: p.detach() for n, p in getattr(model, k).named_parameters()}
         for k in ("fc1", "fc2")}, 0.5)
    step = slim.pruned_train_step(build_train_step(_port_loss, opt), masks)
    feeds = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(3):
        jstate, jm = jstep(jstate, **{k: jnp.asarray(v)
                                       for k, v in batch.items()})
        state, m = step(state, **feeds)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=1e-5)
    got = {k: {n: p for n, p in getattr(model, k).named_parameters()}
           for k in ("fc1", "fc2")}
    _close_trees(got, jax.device_get(jstate["params"]), **TOL)
    for k in ("fc1", "fc2"):
        pruned = masks[k]["weight"] == 0
        assert pruned.any()
        assert torch.all(getattr(model, k).weight[pruned] == 0)


def test_sensitivity_analysis_equals_the_reference():
    w, batch = _weights(), _batch()
    want = jslim.sensitivity_analysis(
        lambda p: _jax_loss(p, batch["x"], batch["y"]), w)
    x, y = (torch.from_numpy(batch[k]) for k in ("x", "y"))

    def loss(tree):
        h = torch.relu(x @ tree["fc1"]["weight"] + tree["fc1"]["bias"])
        return torch.mean((h @ tree["fc2"]["weight"] + tree["fc2"]["bias"]
                           - y) ** 2)

    got = slim.sensitivity_analysis(loss, _torch_tree(w))
    assert set(got) == set(want) == {("fc1", "weight"), ("fc2", "weight")}
    for path, by_s in want.items():
        assert set(got[path]) == set(by_s)
        for s, v in by_s.items():
            assert got[path][s] == pytest.approx(v, rel=1e-6)


def test_distillation_losses_and_gradients():
    rng = np.random.default_rng(3)
    s = rng.standard_normal((6, 10), np.float32)
    t = rng.standard_normal((6, 10), np.float32)
    for temp in (1.0, 2.5):
        want, jg = jax.value_and_grad(lambda a: jslim.soft_label_loss(
            a, jnp.asarray(t), temperature=temp))(jnp.asarray(s))
        st = torch.from_numpy(s).requires_grad_()
        got = slim.soft_label_loss(st, torch.from_numpy(t),
                                   temperature=temp)
        got.backward()
        assert float(got) == pytest.approx(float(want), rel=1e-5)
        np.testing.assert_allclose(st.grad.numpy(), np.asarray(jg), **TOL)
    feats = [rng.standard_normal((2, 4, 4, c), np.float32)
             for c in (3, 5, 3, 5)]
    np.testing.assert_allclose(
        slim.fsp_matrix(torch.from_numpy(feats[0]),
                        torch.from_numpy(feats[1])).numpy(),
        np.asarray(jslim.fsp_matrix(feats[0], feats[1])), **TOL)
    want = jslim.fsp_loss([(feats[0], feats[1])], [(feats[2], feats[3])])
    got = slim.fsp_loss([tuple(torch.from_numpy(f) for f in feats[:2])],
                        [tuple(torch.from_numpy(f) for f in feats[2:])])
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    with pytest.raises(ValueError):
        slim.fsp_matrix(torch.zeros(2, 4, 4, 3), torch.zeros(2, 2, 4, 3))


def test_distill_loss_fn_equals_the_reference():
    w, batch = _weights(), _batch()
    tw = _weights(seed=7)
    jloss = jslim.distill_loss_fn(
        lambda p, x, y: (_jax_loss(p, x, y), {"logits": _jax_mlp(p, x)}),
        lambda x, y: _jax_mlp(tw, x), alpha=0.3, temperature=2.0)
    (want, jaux), jg = jax.value_and_grad(
        lambda p: jloss(p, **batch), has_aux=True)(w)
    student, teacher = _MLP(w), _MLP(tw)
    ploss = slim.distill_loss_fn(
        lambda m, x, y: (_port_loss(m, x, y), {"logits": m(x)}),
        lambda x, y: teacher(x), alpha=0.3, temperature=2.0)
    got, aux = ploss(student, **{k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    got.backward()
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    for k in ("hard_loss", "kd_loss"):
        assert float(aux[k]) == pytest.approx(float(jaux[k]), rel=1e-5)
    assert all(p.grad is None for p in teacher.parameters())
    _close_trees({k: {n: p.grad for n, p in
                      getattr(student, k).named_parameters()}
                  for k in ("fc1", "fc2")}, jax.device_get(jg), **TOL)


def test_sa_search_follows_the_reference_for_a_seed():
    space = {"depth": [2, 4, 6], "width": [8, 16, 32, 64], "act": ["relu"]}

    def reward(cfg):
        return -abs(cfg["depth"] - 4) - abs(cfg["width"] - 32) / 16

    for seed in (0, 3):
        want = jslim.sa_search(space, reward, iters=30, seed=seed)
        assert slim.sa_search(space, reward, iters=30, seed=seed) == want
    g = torch.Generator().manual_seed(5)
    best, best_r, history = slim.sa_search(space, reward, iters=60,
                                           generator=g)
    assert len(history) == 61 and best_r == max(r for _, r in history)
    again = slim.sa_search(space, reward, iters=60,
                           generator=torch.Generator().manual_seed(5))
    assert again == (best, best_r, history)
    with pytest.raises(ValueError):
        slim.sa_search(space, reward, init={"depth": 3, "width": 8,
                                            "act": "relu"})


@pytest.mark.parametrize("channel_wise", [False, True])
def test_qat_loss_gradients_and_convert(channel_wise):
    w, batch = _weights(), _batch()
    jloss = jslim.qat_transform(_jax_loss, bit_length=4,
                                channel_wise=channel_wise)
    want, jg = jax.value_and_grad(lambda p: jloss(p, **batch))(w)
    model = _MLP(w)
    ploss = slim.qat_transform(_port_loss, bit_length=4,
                               channel_wise=channel_wise)
    got = ploss(model, **{k: torch.from_numpy(v) for k, v in batch.items()})
    got.backward()
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    _close_trees({k: {n: p.grad for n, p in
                      getattr(model, k).named_parameters()}
                  for k in ("fc1", "fc2")}, jax.device_get(jg), **TOL)
    _close_trees(slim.qat_convert(_torch_tree(w), bit_length=4,
                                  channel_wise=channel_wise),
                 jax.device_get(jslim.qat_convert(
                     w, bit_length=4, channel_wise=channel_wise)),
                 rtol=1e-6, atol=1e-7)
    # a conv's OIHW weight is scaled per output channel, the reference's
    # HWIO weight per its last axis: the same numbers transposed
    hwio = np.random.default_rng(9).standard_normal((3, 3, 4, 6),
                                                    np.float32)
    want = jslim.qat_convert({"conv": {"weight": hwio}},
                             channel_wise=channel_wise)["conv"]["weight"]
    got = slim.qat_convert({"conv": {"weight": torch.from_numpy(
        hwio.transpose(3, 2, 0, 1).copy())}},
        channel_wise=channel_wise)["conv"]["weight"]
    np.testing.assert_allclose(got.numpy().transpose(2, 3, 1, 0),
                               np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("per_channel", [True, False])
def test_quantization_error_equals_the_reference(per_channel):
    rng = np.random.default_rng(11)
    params = {"enc": {"weight": rng.standard_normal((16, 8)).astype(
                  np.float32),
                      "bias": rng.standard_normal(8).astype(np.float32)},
              "head": {"w": (3.0 * rng.standard_normal((8, 4))).astype(
                  np.float32)},
              "zero": {"weight": np.zeros((4, 4), np.float32)}}
    want = jslim.quantization_error(
        params, jslim.quantize_weights_int8(params, per_channel=per_channel))
    tparams = {k: {n: torch.from_numpy(v) for n, v in d.items()}
               for k, d in params.items()}
    got = slim.quantization_error(
        tparams, slim.quantize_weights_int8(tparams,
                                            per_channel=per_channel))
    assert set(got) == set(want) == {("enc", "weight"), ("head", "w"),
                                     ("zero", "weight")}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6 * max(want[k], 1.0), k
    assert got[("zero", "weight")] == 0.0 and got[("enc", "weight")] > 0
