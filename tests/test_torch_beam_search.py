"""The port's beam search (``paddle_tpu_torch.ops.beam_search`` and
``Transformer.beam_search_decode``) against the JAX package on the CPU:
``beam_init``, ``beam_search_step`` (tokens and parents exact, scores
within 1e-6, ties ranked as ``lax.top_k`` ranks them), ``gather_beams``
over flat and (B, K) leaves, ``beam_search_decode``'s backtracking and
length penalty, and the Transformer's beam search on weights from a JAX
``PRNGKey`` (2 + 2 layers, width 64, one head: the head dim is a
kernel's), cached and uncached: ids exact, scores within 1e-5; beam 1
equals greedy decoding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models.transformer import Transformer as JaxTransformer
from paddle_tpu.models.transformer import \
    TransformerConfig as JaxTransformerConfig
from paddle_tpu.ops import beam_search as jbs
from paddle_tpu_torch.models.transformer import Transformer, TransformerConfig
from paddle_tpu_torch.ops import beam_search as pbs

torch.set_num_threads(2)

CFG = dict(dropout=0.0, attn_dropout=0.0, max_len=16, d_model=64,
           num_heads=1, ffn_size=128, vocab_size=64)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _step_inputs(seed, b=3, k=4, v=11, ties=False):
    rng = np.random.default_rng(seed)
    logp = np.log(rng.dirichlet(np.ones(v), (b, k))).astype(np.float32)
    scores = (-3 * rng.random((b, k))).astype(np.float32)
    done = rng.random((b, k)) < 0.3
    if ties:
        logp[:, 1] = logp[:, 0]            # equal candidates of two beams
        scores[:, 1] = scores[:, 0]
        done[:, :2] = False
    return logp, scores, done


def test_beam_init_equals_the_reference():
    want = jbs.beam_init(3, 4)
    got = pbs.beam_init(3, 4, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", ["plain", "ties", "shrink"])
def test_beam_search_step_equals_the_reference(case):
    logp, scores, done = _step_inputs(1, ties=case == "ties")
    kw = dict(eos_id=1, pad_id=2)
    if case == "shrink":
        kw["beam_size"] = 2
    want = jbs.beam_search_step(jnp.asarray(logp), jnp.asarray(scores),
                                jnp.asarray(done), **kw)
    got = pbs.beam_search_step(_t(logp), _t(scores), _t(done), **kw)
    tok, sc, dn, par = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[0].numpy(), tok)
    np.testing.assert_allclose(got[1].numpy(), sc, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), dn)
    np.testing.assert_array_equal(got[3].numpy(), par)


def test_beam_search_step_refusals():
    logp, scores, done = (_t(a) for a in _step_inputs(2))
    with pytest.raises(ValueError, match=">= 1"):
        pbs.beam_search_step(logp, scores, done, eos_id=1, beam_size=0)
    with pytest.raises(ValueError, match="cannot grow"):
        pbs.beam_search_step(logp, scores, done, eos_id=1, beam_size=5)


def test_gather_beams_equals_the_reference():
    rng = np.random.default_rng(3)
    b, k = 2, 3
    parent = rng.integers(0, k, (b, k)).astype(np.int32)
    tree = {"flat": rng.standard_normal((b * k, 4, 5)).astype(np.float32),
            "lattice": rng.standard_normal((b, k, 6)).astype(np.float32),
            "pair": (rng.standard_normal((b * k, 2)).astype(np.float32),)}
    want = jbs.gather_beams(jax.tree_util.tree_map(jnp.asarray, tree),
                            jnp.asarray(parent))
    got = pbs.gather_beams({"flat": _t(tree["flat"]),
                            "lattice": _t(tree["lattice"]),
                            "pair": (_t(tree["pair"][0]),)}, _t(parent))
    np.testing.assert_array_equal(got["flat"].numpy(), want["flat"])
    np.testing.assert_array_equal(got["lattice"].numpy(), want["lattice"])
    np.testing.assert_array_equal(got["pair"][0].numpy(), want["pair"][0])


@pytest.mark.parametrize("kw", [{}, {"length_penalty": 0.6, "bos_id": 0}],
                         ids=["raw", "penalty_bos"])
def test_beam_search_decode_op_equals_the_reference(kw):
    rng = np.random.default_rng(4)
    b, t, k = 3, 7, 4
    toks = rng.integers(0, 6, (b, t, k)).astype(np.int32)   # eos_id 1 inside
    pars = rng.integers(0, k, (b, t, k)).astype(np.int32)
    scores = (-5 * rng.random((b, k))).astype(np.float32)
    want = jbs.beam_search_decode(jnp.asarray(toks), jnp.asarray(pars),
                                  jnp.asarray(scores), eos_id=1, pad_id=2,
                                  **kw)
    got = pbs.beam_search_decode(_t(toks), _t(pars), _t(scores), eos_id=1,
                                 pad_id=2, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-6)


@pytest.fixture(scope="module")
def pair():
    jm = JaxTransformer(JaxTransformerConfig.tiny(**CFG, attn_impl="xla"))
    params = jm.init(jax.random.PRNGKey(0))
    pm = Transformer.from_jax(TransformerConfig.tiny(**CFG),
                              jax.device_get(params), device="cpu")
    pm.eval()
    return jm, params, pm


def _src(seed=5, b=3, s=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 64, (b, s)).astype(np.int32)
    ids[0, s - 4:] = 2                       # padding in one row
    return ids


@pytest.mark.parametrize("use_cache", [True, False],
                         ids=["cached", "uncached"])
def test_transformer_beam_search_equals_the_reference(pair, use_cache):
    jm, params, pm = pair
    src = _src()
    want_ids, want_sc = jm.beam_search_decode(
        params, jnp.asarray(src), beam_size=3, max_len=10,
        use_cache=use_cache)
    got_ids, got_sc = pm.beam_search_decode(_t(src), beam_size=3, max_len=10,
                                            use_cache=use_cache)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_sc.numpy(), np.asarray(want_sc), rtol=0,
                               atol=1e-5)


def test_beam_one_equals_greedy(pair):
    _, _, pm = pair
    src = _t(_src(6))
    ids, _ = pm.beam_search_decode(src, beam_size=1, max_len=10)
    np.testing.assert_array_equal(
        ids.numpy(), pm.greedy_decode(src, max_len=10).numpy())
