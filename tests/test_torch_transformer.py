"""The port's Transformer (``paddle_tpu_torch.models.transformer``) and the
decoder layer against the JAX package on the CPU: tiny fp32 weights from a
JAX ``PRNGKey`` carried across, inputs from numpy seeds. ``forward``,
``loss`` and ``loss_packed`` within 1e-5, packed equal to padded (the
reference's ``test_matches_padded_baseline``), greedy tokens exact (cached
and uncached), three Adam steps within 1e-5 relative, fully masked
cross-attention rows giving zeros both ways, and the native feed ->
packer -> train step copy task converging (``tests/test_packing.py:166``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu import train as jtrain
from paddle_tpu.models.transformer import Transformer as JaxTransformer
from paddle_tpu.models.transformer import \
    TransformerConfig as JaxTransformerConfig
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.data import packing
from paddle_tpu_torch.models.transformer import (Transformer,
                                                 TransformerConfig,
                                                 sinusoid_positions)
from paddle_tpu_torch.ops import attention as FA
from paddle_tpu_torch.ops.sequence import make_segment_attention_bias
from paddle_tpu_torch.train import build_train_step, make_train_state

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(dropout=0.0, attn_dropout=0.0, max_len=16)
PACKED_KEYS = ("src", "src_seg", "src_pos", "tgt", "tgt_out", "tgt_seg",
               "tgt_pos")


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params, the port model on the same weights)."""
    jm = JaxTransformer(JaxTransformerConfig.tiny(**CFG, attn_impl="xla"))
    params = jm.init(jax.random.PRNGKey(0))
    pm = Transformer.from_jax(TransformerConfig.tiny(**CFG),
                              jax.device_get(params), device="cpu")
    pm.eval()
    return jm, params, pm


def _ragged(rng, n, lo, hi, vocab=(3, 64)):
    return [rng.integers(vocab[0], vocab[1],
                         size=int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


def _pairs(n=14, seed=2):
    rng = np.random.default_rng(seed)
    src = _ragged(rng, n, 3, 13)
    y = _ragged(rng, n, 3, 11)
    tgt_in = [np.concatenate([[0], t]).astype(np.int32) for t in y]
    tgt_out = [np.concatenate([t, [1]]).astype(np.int32) for t in y]
    return src, tgt_in, tgt_out


def _padded_ids(rng, b, s, pad=2):
    ids = rng.integers(3, 64, (b, s)).astype(np.int32)
    lengths = rng.integers(s // 2, s + 1, b)
    ids[np.arange(s)[None, :] >= lengths[:, None]] = pad
    return ids


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_sinusoid_positions_match_the_reference():
    from paddle_tpu.models.transformer import sinusoid_positions as jsin
    np.testing.assert_allclose(sinusoid_positions(40, 16).numpy(),
                               np.asarray(jsin(40, 16)), atol=1e-6)


def test_parameter_tree_matches_the_reference(pair):
    _, params, pm = pair
    from paddle_tpu_torch.models.convert import state_from_jax
    want = state_from_jax(jax.device_get(params))
    got = pm.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k


def test_forward_and_loss_match_the_reference(pair):
    jm, params, pm = pair
    rng = np.random.default_rng(3)
    src, tin = _padded_ids(rng, 3, 12), _padded_ids(rng, 3, 10)
    tout = _padded_ids(rng, 3, 10)

    @jax.jit
    def ref(params, src, tin, tout):
        return (jm.forward(params, src, tin),
                jm.loss(params, src, tin, tout, training=False))

    want, (jl, jaux) = ref(params, *(jnp.asarray(a) for a in (src, tin,
                                                               tout)))
    with torch.no_grad():
        got = pm(_t(src), _t(tin)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    with torch.no_grad():
        pl, paux = pm.loss(_t(src), _t(tin), _t(tout))
    np.testing.assert_allclose(float(pl), float(jl), **TOL)
    np.testing.assert_allclose(float(paux["token_acc"]),
                               float(jaux["token_acc"]), **TOL)


def test_loss_packed_matches_the_reference(pair):
    jm, params, pm = pair
    packed = packing.pack_pairs(*_pairs()[:2], 16, 16,
                                tgt_extras={"tgt_out": _pairs()[2]})
    jl, jaux = jax.jit(lambda p, *a: jm.loss_packed(p, *a, training=False))(
        params, *(jnp.asarray(packed[k]) for k in PACKED_KEYS))
    with torch.no_grad():
        pl, paux = pm.loss_packed(*(_t(packed[k]) for k in PACKED_KEYS))
    np.testing.assert_allclose(float(pl), float(jl), **TOL)
    assert float(paux["token_count"]) == float(jaux["token_count"])
    np.testing.assert_allclose(float(paux["token_sum"]),
                               float(jaux["token_sum"]), **TOL)


def test_packed_equals_padded(pair):
    """The reference's ``test_matches_padded_baseline``: the packed token
    sum is the sum of the one-pair-per-row losses."""
    _, _, pm = pair
    cfg = pm.cfg
    src, tgt_in, tgt_out = _pairs()
    tot_sum = tot_cnt = 0.0
    with torch.no_grad():
        for s, ti, to in zip(src, tgt_in, tgt_out):
            row = {}
            for name, seq in (("s", s), ("ti", ti), ("to", to)):
                a = np.full((1, 16), cfg.pad_id, np.int32)
                a[0, :len(seq)] = seq
                row[name] = _t(a)
            loss, _ = pm.loss(row["s"], row["ti"], row["to"])
            cnt = float((row["to"] != cfg.pad_id).sum())
            tot_sum += float(loss) * cnt
            tot_cnt += cnt
        packed = packing.pack_pairs(src, tgt_in, 16, 16,
                                    tgt_extras={"tgt_out": tgt_out})
        _, aux = pm.loss_packed(*(_t(packed[k]) for k in PACKED_KEYS))
    assert float(aux["token_count"]) == tot_cnt
    assert float(aux["token_sum"]) == pytest.approx(tot_sum, rel=2e-5)


@pytest.mark.parametrize("use_cache", [True, False])
def test_greedy_decode_tokens_equal_the_reference(pair, use_cache):
    jm, params, pm = pair
    src = _padded_ids(np.random.default_rng(4), 3, 12)
    want = np.asarray(jm.greedy_decode(params, jnp.asarray(src), max_len=12,
                                       use_cache=use_cache))
    got = pm.greedy_decode(_t(src), max_len=12, use_cache=use_cache)
    np.testing.assert_array_equal(got.numpy(), want)


def test_three_adam_steps_match_the_reference(pair):
    jm, params, _ = pair
    src, tgt_in, tgt_out = _pairs(n=20, seed=5)
    batches = list(packing.packed_batches(
        src, tgt_in, rows_per_batch=4, src_len=16, tgt_len=16,
        tgt_extras={"tgt_out": tgt_out}))[:3]
    jo = jopt.Adam(learning_rate=1e-3)
    state = {"params": params, "opt": jo.init(params),
             "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(jtrain.build_train_step(
        lambda p, **b: jm.loss_packed(p, *(b[k] for k in PACKED_KEYS),
                                      training=False), jo))
    want = []
    for b in batches:
        state, m = step(state, **{k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(m["loss"]))

    pm = Transformer.from_jax(TransformerConfig.tiny(**CFG),
                              jax.device_get(params), device="cpu")
    pstate = make_train_state(pm, opt.Adam(pm.parameters(),
                                           learning_rate=1e-3))
    pstep = build_train_step(
        lambda m, **b: m.loss_packed(*(b[k] for k in PACKED_KEYS)),
        pstate["opt"])
    got = [float(pstep(pstate, **{k: _t(v) for k, v in b.items()})[1]
                 ["loss"]) for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_decoder_layer_matches_the_reference(pair):
    """One decoder layer on its own, with full self and cross biases."""
    jm, params, pm = pair
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    mem = rng.standard_normal((2, 6, 16)).astype(np.float32)
    tseg = np.array([[1, 1, 2, 2, 2, 0, 0, 0], [1, 1, 1, 1, 1, 1, 1, 1]])
    sseg = np.array([[1, 1, 1, 2, 2, 0], [1, 1, 1, 1, 1, 1]])
    from paddle_tpu.ops import sequence as jseq
    jargs = dict(self_bias=jseq.make_segment_attention_bias(
        jnp.asarray(tseg)), cross_bias=jseq.make_segment_attention_bias(
        jnp.asarray(tseg), jnp.asarray(sseg)))
    want = np.asarray(jax.jit(jm.decoder[0].forward)(
        params["decoder"]["0"], jnp.asarray(x), jnp.asarray(mem), **jargs))
    with torch.no_grad():
        got = pm.decoder[0](
            _t(x), _t(mem), self_bias=make_segment_attention_bias(_t(tseg)),
            cross_bias=make_segment_attention_bias(_t(tseg), _t(sseg)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fully_masked_cross_rows_are_zero_both_ways():
    """A padding query (segment 0) of a target row whose source row holds
    no padding sees no key: the flash path emits 0 there and its
    backward adds nothing (the reference's
    ``test_empty_row_grads_not_inflated``), with the full segment bias."""
    rng = np.random.default_rng(7)
    tseg = _t(np.array([[1, 1, 2, 2, 0, 0], [1, 2, 2, 2, 2, 0]]))
    sseg = _t(np.array([[1, 1, 1, 2, 2, 2], [1, 1, 2, 2, 0, 0]]))
    bias = make_segment_attention_bias(tseg, sseg)
    q = _t(rng.standard_normal((2, 2, 6, 32)).astype(np.float32))
    k, v = (_t(rng.standard_normal((2, 2, 6, 32)).astype(np.float32))
            for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = FA.dot_product_attention(*leaves, bias=bias, impl="flash")
    dead = (tseg == 0)[:, None, :, None].expand_as(out) & \
        torch.tensor([True, False])[:, None, None, None].expand_as(out)
    assert torch.all(out[dead] == 0)
    do = _t(rng.standard_normal(out.shape).astype(np.float32))
    dq, dk, dv = torch.autograd.grad(out, leaves, do)
    assert torch.all(dq[dead] == 0)
    # the dead rows' cotangent contributes nothing to dk, dv
    leaves2 = [t.clone().requires_grad_() for t in (q, k, v)]
    out2 = FA.dot_product_attention(*leaves2, bias=bias, impl="flash")
    _, dk2, dv2 = torch.autograd.grad(
        out2, leaves2, torch.where(dead, torch.zeros_like(do), do))
    torch.testing.assert_close(dk, dk2, rtol=0, atol=1e-6)
    torch.testing.assert_close(dv, dv2, rtol=0, atol=1e-6)
    # and the flash path equals the composed one on the live rows
    ref = FA.scaled_dot_product_attention(q, k, v, bias=bias)
    torch.testing.assert_close(out.detach(), ref, **TOL)


def test_refusals_name_their_roadmap_items():
    # the pipelined layout is ported (test_torch_transformer_pipeline.py):
    # it builds, and refuses only a batch its microbatches do not divide
    pm = Transformer(TransformerConfig.tiny(pipeline=True,
                                            pp_microbatches=2), device="cpu")
    odd = torch.full((3, 4), 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="pp_microbatches=2"):
        pm.loss(odd, odd, odd)
    # beam search is ported (item 3's first half): it runs, and the JAX
    # parity lives in test_torch_beam_search.py
    m = Transformer(TransformerConfig.tiny(), device="cpu")
    ids, scores = m.beam_search_decode(
        torch.full((1, 4), 3, dtype=torch.int32), beam_size=2, max_len=5)
    assert ids.shape == (1, 5) and ids.dtype == torch.int32
    assert int(ids[0, 0]) == m.cfg.bos_id and scores.shape == (1,)
