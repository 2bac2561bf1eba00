"""The port's book models (``paddle_tpu_torch/models/book.py``) against the
JAX package on the CPU at small sizes: each chapter's loss within 1e-5
relative and every gradient within atol 1e-5 / rtol 1e-4 from the same
``from_jax`` weights and numpy batches; semantic role labelling's
Viterbi paths and machine translation's beam ids exactly (scores within
1e-5); a seeded model on the CPU trains and every model defaults to the
card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import book as J
from paddle_tpu_torch.models import book as P
from torch_parity import close, grads_close, init, loss_close

torch.set_num_threads(2)
V, B, T = 40, 4, 9


def _rng(seed):
    return np.random.default_rng(seed)


def _ids(r, *shape, hi=V):
    return r.integers(0, hi, shape).astype(np.int32)


def _lengths(r):
    ls = r.integers(1, T, B).astype(np.int32)
    ls[0], ls[-1] = T, 2
    return ls


def _batch(name, r):
    if name == "LinearRegression":
        return (r.standard_normal((B, 13)).astype(np.float32),
                r.standard_normal(B).astype(np.float32))
    if name == "Word2Vec":
        return _ids(r, B, 4), _ids(r, B)
    if name == "SkipGramNS":
        return _ids(r, B), _ids(r, B), _ids(r, B, 5)
    if name in ("SentimentLSTM", "SentimentCNN"):
        return _ids(r, B, T), _lengths(r), _ids(r, B, hi=2)
    if name == "RNNLanguageModel":
        return _ids(r, B, T), _ids(r, B, T), _lengths(r)
    if name == "RecommenderSystem":
        return (_ids(r, B, hi=30), _ids(r, B, hi=2), _ids(r, B, hi=7),
                _ids(r, B, hi=21), _ids(r, B, hi=25),
                (r.random((B, 18)) < 0.2).astype(np.float32),
                r.uniform(1, 5, B).astype(np.float32))
    if name == "MachineTranslation":
        return (_ids(r, B, T), _lengths(r), _ids(r, B, 6), _ids(r, B, 6),
                np.array([6, 1, 4, 3], np.int32))
    # LabelSemanticRoles
    return (_ids(r, B, T), _ids(r, B), _ids(r, B, T, hi=2),
            _ids(r, B, T, hi=7), np.array([T, 0, 5, 1], np.int32))


#: (constructor args, keyword args) of each chapter at a small size
MODELS = {
    "LinearRegression": ((), {}),
    "Word2Vec": ((V,), dict(embed_dim=8, hidden=16)),
    "SkipGramNS": ((V,), dict(embed_dim=8)),
    "SentimentLSTM": ((V,), dict(embed_dim=8, hidden=12)),
    "SentimentCNN": ((V,), dict(embed_dim=8, hidden=10)),
    "RNNLanguageModel": ((V,), dict(embed_dim=12, hidden=12)),
    "RecommenderSystem": ((), dict(n_users=30, n_movies=25, dim=8)),
    "MachineTranslation": ((V, V), dict(embed_dim=8, hidden=12)),
    "LabelSemanticRoles": ((V, 7), dict(dim=8, hidden=10, depth=2)),
}


def _pair(name, seed=0, **override):
    args, kw = MODELS[name]
    kw = {**kw, **override}
    jm = getattr(J, name)(*args, **kw)
    params = init(jm, seed)
    pm = getattr(P, name).from_jax(params, *args, device="cpu", **kw)
    return jm, params, pm


@pytest.mark.parametrize("name", sorted(MODELS))
def test_loss_and_gradients_equal_the_reference(name):
    jm, params, pm = _pair(name)
    batch = _batch(name, _rng(1))
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, *b), has_aux=True))(
        params, tuple(map(jnp.asarray, batch)))
    loss, aux = pm.loss(*[torch.from_numpy(a) for a in batch])
    loss_close(loss, jl)
    for k in jaux:
        loss_close(aux[k], jaux[k], what=k)
    loss.backward()
    grads_close(pm, jg)


def test_rnn_language_model_tied_and_unpadded():
    jm, params, pm = _pair("RNNLanguageModel", tie_embeddings=True)
    assert pm.tie and not hasattr(pm, "proj")
    ids, targets, _ = _batch("RNNLanguageModel", _rng(2))
    jl, _ = jax.jit(jm.loss)(params, jnp.asarray(ids), jnp.asarray(targets))
    loss, aux = pm.loss(torch.from_numpy(ids), torch.from_numpy(targets))
    loss_close(loss, jl)
    loss_close(aux["ppl"], np.exp(float(jl)))


def test_srl_decode_equals_the_reference():
    jm, params, pm = _pair("LabelSemanticRoles")
    words, pred, mark, _, lengths = _batch("LabelSemanticRoles", _rng(3))
    want = jax.jit(jm.decode)(params, *map(jnp.asarray, (words, pred, mark,
                                                         lengths)))
    got = pm.decode(*[torch.from_numpy(a) for a in (words, pred, mark,
                                                    lengths)])
    close(got, want, what="viterbi")


@pytest.mark.parametrize("beam_size,length_penalty", [(3, 0.0), (2, 0.6)])
def test_machine_translation_beam_ids_equal_the_reference(beam_size,
                                                          length_penalty):
    jm, params, pm = _pair("MachineTranslation", eos_id=3)
    src, src_len = _batch("MachineTranslation", _rng(4))[:2]
    jseq, jsc = jax.jit(lambda p, s, n: jm.beam_search_translate(
        p, s, n, beam_size=beam_size, max_len=7,
        length_penalty=length_penalty))(params, jnp.asarray(src),
                                        jnp.asarray(src_len))
    seq, sc = pm.beam_search_translate(
        torch.from_numpy(src), torch.from_numpy(src_len),
        beam_size=beam_size, max_len=7, length_penalty=length_penalty)
    close(seq, jseq, what="beam ids")
    close(sc, jsc, 1e-5, 1e-5, what="scores")


def test_seeded_models_train_on_the_cpu_and_default_to_the_card(
        monkeypatch):
    m = P.SentimentLSTM(V, embed_dim=8, hidden=12, device="cpu", seed=3)
    again = P.SentimentLSTM(V, embed_dim=8, hidden=12, device="cpu", seed=3)
    for a, b in zip(m.parameters(), again.parameters()):
        assert torch.equal(a, b)
    opt = torch.optim.SGD(m.parameters(), lr=0.5)
    batch = [torch.from_numpy(a) for a in _batch("SentimentLSTM", _rng(5))]
    losses = []
    for _ in range(5):
        opt.zero_grad()
        loss, _ = m.loss(*batch)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.LinearRegression()
