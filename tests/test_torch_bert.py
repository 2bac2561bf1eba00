"""The port's BERT pretraining model against the JAX package on the CPU:
``BertConfig.tiny`` with JAX-initialised weights carried across by
``state_from_jax``; MLM/NSP logits and the loss with a padded
``attention_mask`` (one row fully padded but its first token). The JAX
side runs its composed ("xla") attention; the port runs flash attention
(plain versions on the CPU). Tolerance fp32 atol/rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.models.bert import BertForPretraining as JaxBert
from paddle_tpu_torch.models import state_from_jax
from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)


def make_batch(cfg, b, s, seed, lengths=None):
    """Feeds as ``bench.py`` makes them, from numpy: ids, zero token
    types, 15% MLM mask, NSP labels; ``attention_mask`` from valid
    lengths."""
    rng = np.random.default_rng(seed)
    if lengths is None:
        lengths = rng.integers(1, s + 1, b)
    valid = np.arange(s)[None, :] < np.asarray(lengths)[:, None]
    return dict(
        input_ids=rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
        token_type_ids=np.zeros((b, s), np.int32),
        attention_mask=valid,
        mlm_labels=rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
        mlm_mask=(rng.random((b, s)) < 0.15).astype(np.float32),
        nsp_labels=rng.integers(0, 2, b).astype(np.int32),
    )


def jax_bert(seed=0, **kw):
    cfg = JaxBertConfig.tiny(dropout=0.0, attn_dropout=0.0, attn_impl="xla",
                             **kw)
    model = JaxBert(cfg)
    return cfg, model, model.init(jax.random.PRNGKey(seed))


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("pre_ln", [False, True], ids=["post_ln", "pre_ln"])
def test_logits_and_loss_match_reference(pre_ln):
    jcfg, jmodel, params = jax_bert(pre_ln=pre_ln)
    batch = make_batch(jcfg, 3, 24, seed=1, lengths=[24, 13, 1])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_mlm, j_nsp = jmodel.forward(params, jb["input_ids"],
                                  jb["token_type_ids"], jb["attention_mask"])
    j_loss, j_aux = jmodel.loss(params, **jb)

    cfg = BertConfig.tiny(dropout=0.0, attn_dropout=0.0, pre_ln=pre_ln)
    model = BertForPretraining.from_jax(cfg, jax.device_get(params),
                                        device="cpu")
    tb = torch_batch(batch)
    with torch.no_grad():
        mlm, nsp = model(tb["input_ids"], tb["token_type_ids"],
                         tb["attention_mask"])
        loss, aux = model.loss(**tb)
    assert mlm.shape == (3, 24, cfg.vocab_size) and nsp.shape == (3, 2)
    np.testing.assert_allclose(mlm.numpy(), np.asarray(j_mlm), **TOL)
    np.testing.assert_allclose(nsp.numpy(), np.asarray(j_nsp), **TOL)
    np.testing.assert_allclose(float(loss), float(j_loss), **TOL)
    for name in ("mlm_loss", "nsp_loss"):
        np.testing.assert_allclose(float(aux[name]), float(j_aux[name]),
                                   **TOL)


def test_state_dict_keys_are_the_reference_tree_flattened():
    _, _, params = jax_bert()
    state = state_from_jax(jax.device_get(params))
    model = BertForPretraining(BertConfig.tiny(), device="cpu")
    assert set(state) == set(model.state_dict())
    for key in ("bert.embeddings.word.weight", "bert.embeddings.ln.scale",
                "bert.encoder.1.attn.qkv_proj.weight",
                "bert.encoder.0.ffn.fc2.bias", "bert.encoder.1.ln2.scale",
                "bert.pooler.weight", "heads.transform.weight",
                "heads.ln.bias", "heads.decoder_bias", "heads.nsp.weight"):
        assert key in state, key
        assert tuple(state[key].shape) == tuple(model.state_dict()[key].shape)
    assert state["bert.encoder.0.ffn.fc1.weight"].shape == (32, 64)


def test_gradients_match_reference():
    jcfg, jmodel, params = jax_bert(seed=2)
    batch = make_batch(jcfg, 2, 16, seed=3, lengths=[16, 9])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_grads = jax.grad(lambda p: jmodel.loss(p, **jb)[0])(params)
    flat = state_from_jax(jax.device_get(j_grads))
    model = BertForPretraining.from_jax(
        BertConfig.tiny(dropout=0.0, attn_dropout=0.0),
        jax.device_get(params), device="cpu")
    loss, _ = model.loss(**torch_batch(batch))
    loss.backward()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), flat[name].numpy(),
                                   err_msg=name, **TOL)


def test_seeded_init_follows_the_reference_schemes():
    cfg = BertConfig.tiny()
    a = BertForPretraining(cfg, device="cpu", seed=3)
    b = BertForPretraining(cfg, device="cpu", seed=3)
    for (k, va), (_, vb) in zip(a.state_dict().items(),
                                b.state_dict().items()):
        assert torch.equal(va, vb), k
    assert torch.all(a.heads.decoder_bias == 0)
    assert torch.all(a.bert.encoder[0].ln1.scale == 1)
    word = a.bert.embeddings.word.weight.detach()
    assert abs(float(word.std()) - 0.02) < 0.004
    assert a.training                # dropout follows train()/eval()


def test_entry_point_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the CPU-only refusal is moot")
    with pytest.raises(RuntimeError, match="CUDA"):
        BertForPretraining(BertConfig.tiny())
