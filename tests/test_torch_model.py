"""The port's dense model stack against the JAX reference on the CPU:
layers, activation, and GPT logits with the reference's weights carried
across by ``gpt_state_from_jax``. Inputs are made with numpy from seeds;
tolerance fp32 atol/rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.nn import layers as jax_layers
from paddle_tpu.ops import activation as jax_act
from paddle_tpu_torch.models.convert import gpt_state_from_jax
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.nn import layers
from paddle_tpu_torch.ops import activation

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_linear_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 12)).astype(np.float32)
    w = rng.standard_normal((12, 7)).astype(np.float32)
    b = rng.standard_normal((7,)).astype(np.float32)
    ref = jax_layers.Linear(12, 7).forward({"weight": jnp.asarray(w),
                                            "bias": jnp.asarray(b)},
                                           jnp.asarray(x))
    lin = layers.Linear(12, 7, device="cpu")
    lin.load_state_dict({"weight": _t(w), "bias": _t(b)})
    assert lin.weight.shape == (12, 7)          # (in, out), not nn.Linear's
    np.testing.assert_allclose(lin(_t(x)).detach().numpy(), np.asarray(ref),
                               **TOL)


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 9, 16)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal((16,)).astype(np.float32)
    bias = rng.standard_normal((16,)).astype(np.float32)
    ref = jax_layers.LayerNorm(16).forward(
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
        jnp.asarray(x))
    ln = layers.LayerNorm(16, device="cpu")
    ln.load_state_dict({"scale": _t(scale), "bias": _t(bias)})
    assert ln.epsilon == 1e-5
    np.testing.assert_allclose(ln(_t(x)).detach().numpy(), np.asarray(ref),
                               **TOL)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 301).astype(np.float32)
    ref = np.asarray(jax_act.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(activation.gelu(_t(x)).numpy(), ref, **TOL)
    erf = torch.nn.functional.gelu(_t(x)).numpy()
    assert np.abs(erf - ref).max() > 1e-4       # the erf form differs


def test_embedding_matches_reference():
    rng = np.random.default_rng(2)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, (3, 6)).astype(np.int32)
    ref = jax_layers.Embedding(50, 8).forward({"weight": jnp.asarray(table)},
                                              jnp.asarray(ids))
    emb = layers.Embedding(50, 8, device="cpu")
    emb.load_state_dict({"weight": _t(table)})
    np.testing.assert_allclose(emb(_t(ids).long()).detach().numpy(),
                               np.asarray(ref), **TOL)


@pytest.mark.parametrize("overrides", [
    {},                                                     # GPTConfig.tiny()
    dict(num_layers=2, num_heads=4, hidden_size=64, ffn_size=128),
], ids=["tiny", "h64"])
def test_gpt_logits_match_reference(overrides):
    jcfg = JaxGPTConfig.tiny(dropout=0.0, attn_impl="xla", **overrides)
    jmodel = JaxGPT(jcfg)
    params = jmodel.init(jax.random.PRNGKey(7))
    ids = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 17)).astype(np.int32)
    ref = np.asarray(jmodel.forward(params, jnp.asarray(ids)))
    cfg = GPTConfig.tiny(**overrides)
    model = GPT.from_jax(cfg, jax.device_get(params), device="cpu")
    with torch.no_grad():
        got = model(_t(ids).long()).numpy()
    assert got.shape == ref.shape == (2, 17, cfg.vocab_size)
    np.testing.assert_allclose(got, ref, **TOL)


def test_state_dict_keys_are_the_reference_tree_flattened():
    jcfg = JaxGPTConfig.tiny()
    params = jax.device_get(JaxGPT(jcfg).init(jax.random.PRNGKey(0)))
    state = gpt_state_from_jax(params)
    model = GPT(GPTConfig.tiny(), device="cpu")
    assert set(state) == set(model.state_dict())
    assert "blocks.1.attn.qkv_proj.weight" in state
    assert state["blocks.0.mlp.fc1.weight"].shape == (32, 64)


def test_seeded_init_is_deterministic_and_follows_reference_schemes():
    cfg = GPTConfig.tiny()
    a, b = GPT(cfg, device="cpu", seed=3), GPT(cfg, device="cpu", seed=3)
    for (k, va), (_, vb) in zip(a.state_dict().items(),
                                b.state_dict().items()):
        assert torch.equal(va, vb), k
    c = GPT(cfg, device="cpu", seed=4)
    assert not torch.equal(a.wte.weight, c.wte.weight)
    assert torch.all(a.ln_f.scale == 1) and torch.all(a.ln_f.bias == 0)
    lim = (6.0 / (32 + 96)) ** 0.5
    w = a.blocks[0].attn.qkv_proj.weight.detach()
    assert float(w.abs().max()) <= lim
    assert abs(float(a.wte.weight.detach().std()) - 0.02) < 0.004
