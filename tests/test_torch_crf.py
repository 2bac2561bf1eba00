"""The port's ``ops/crf.py`` against the JAX package on the CPU: the
linear-chain CRF's negative log-likelihood and its gradients, Viterbi
paths (with ties, with and without ``label=``), CTC loss and gradients
(a row whose label cannot fit its frames included), greedy CTC decoding
and edit distance, over ragged rows with lengths 0 and T."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import crf as J
from paddle_tpu_torch.ops import crf as P
from torch_parity import GRAD_ATOL, GRAD_RTOL, close, loss_close, to_torch

torch.set_num_threads(2)
B, T, N = 5, 8, 4
LENGTHS = np.array([0, 1, 5, T, 3], np.int32)


def _crf_inputs(seed=0, ties=False):
    rng = np.random.default_rng(seed)
    em = rng.standard_normal((B, T, N)).astype(np.float32)
    tr = rng.standard_normal((N, N)).astype(np.float32)
    if ties:        # small integers: equal path scores are common
        em = rng.integers(-1, 2, (B, T, N)).astype(np.float32)
        tr = rng.integers(-1, 2, (N, N)).astype(np.float32)
    return dict(em=em, lab=rng.integers(0, N, (B, T)).astype(np.int32),
                tr=tr, start=rng.standard_normal(N).astype(np.float32),
                stop=rng.standard_normal(N).astype(np.float32))


@pytest.mark.parametrize("boundaries", [True, False], ids=["start_stop",
                                                           "plain"])
def test_crf_nll_and_gradients_equal_the_reference(boundaries):
    d = _crf_inputs(1)
    names = ("em", "tr", "start", "stop") if boundaries else ("em", "tr")

    def jloss(*args):
        kw = dict(zip(("start", "stop"), args[2:]))
        nll = J.linear_chain_crf(args[0], jnp.asarray(d["lab"]),
                                 jnp.asarray(LENGTHS), args[1], **kw)
        return (nll * jnp.arange(1, B + 1)).sum(), nll

    (_, jnll), jg = jax.value_and_grad(
        jloss, argnums=tuple(range(len(names))), has_aux=True)(
        *[jnp.asarray(d[n]) for n in names])
    pt = {n: torch.from_numpy(d[n]).requires_grad_(True) for n in names}
    kw = {n: pt[n] for n in ("start", "stop") if n in pt}
    nll = P.linear_chain_crf(pt["em"], *to_torch(d["lab"], LENGTHS),
                             pt["tr"], **kw)
    for g, w in zip(nll, np.asarray(jnll)):
        loss_close(g, w)
    (nll * torch.arange(1, B + 1)).sum().backward()
    for n, w in zip(names, jg):
        close(pt[n].grad, w, GRAD_ATOL, GRAD_RTOL, what=n)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("with_label", [False, True], ids=["paths",
                                                           "label_mask"])
def test_viterbi_equals_the_reference_exactly(ties, with_label):
    d = _crf_inputs(2, ties=ties)
    kw = dict(start=d["start"], stop=d["stop"])
    if with_label:
        kw["label"] = d["lab"]
    want = J.crf_decoding(jnp.asarray(d["em"]), jnp.asarray(d["tr"]),
                          jnp.asarray(LENGTHS),
                          **{k: jnp.asarray(v) for k, v in kw.items()})
    got = P.crf_decoding(*to_torch(d["em"], d["tr"], LENGTHS),
                         **{k: torch.from_numpy(v) for k, v in kw.items()})
    close(got, want, what="viterbi")
    assert not got[0].any()          # length 0: all zeros


def _ctc_inputs(seed=3):
    rng = np.random.default_rng(seed)
    v, lmax = 6, 4
    logits = rng.standard_normal((B, T, v)).astype(np.float32)
    labels = rng.integers(1, v, (B, lmax)).astype(np.int32)
    labels[1, 1] = labels[1, 0]              # a repeat needs a blank
    frames = np.array([T, T, 5, 2, 0], np.int32)
    # row 3: 4 labels in 2 frames, infeasible; row 4: 0 frames
    label_len = np.array([3, 2, 0, 4, 1], np.int32)
    return logits, frames, labels, label_len


def test_ctc_loss_and_gradients_equal_optax():
    logits, frames, labels, label_len = _ctc_inputs()

    def jloss(lg):
        loss = J.ctc_loss(lg, jnp.asarray(frames), jnp.asarray(labels),
                          jnp.asarray(label_len))
        return loss.sum(), loss

    (_, jl), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    loss = P.ctc_loss(lg, *to_torch(frames, labels, label_len))
    for g, w in zip(loss, np.asarray(jl)):
        loss_close(g, w)
    assert float(loss[3]) > 1e4              # infeasible: optax's ~1e5
    loss.sum().backward()
    feasible = [0, 1, 2, 4]
    close(lg.grad[feasible], np.asarray(jg)[feasible], GRAD_ATOL, GRAD_RTOL,
          what="logits grad")
    # the infeasible row's recursion runs at ~1e5, where a float32 ulp is
    # 0.0078: its gradient (softmax weights of differences of such sums)
    # is rounding-bound in both packages and is held to that resolution
    close(lg.grad[3], np.asarray(jg)[3], 5e-3, 0.0,
          what="infeasible row's logits grad")


def test_ctc_greedy_decoder_equals_the_reference():
    rng = np.random.default_rng(4)
    probs = rng.integers(0, 3, (B, T, 4)).astype(np.float32)  # ties too
    lengths = np.array([T, 0, 4, 1, 6], np.int32)
    want = J.ctc_greedy_decoder(jnp.asarray(probs), jnp.asarray(lengths),
                                blank=1)
    got = P.ctc_greedy_decoder(*to_torch(probs, lengths), blank=1)
    for g, w in zip(got, want):
        close(g, w, what="greedy")


@pytest.mark.parametrize("normalized", [True, False])
def test_edit_distance_equals_the_reference(normalized):
    rng = np.random.default_rng(5)
    hyp = rng.integers(0, 3, (B, 6)).astype(np.int32)
    ref = rng.integers(0, 3, (B, 5)).astype(np.int32)
    hl = np.array([6, 0, 3, 2, 5], np.int32)
    rl = np.array([5, 3, 0, 2, 4], np.int32)
    want = J.edit_distance(*map(jnp.asarray, (hyp, hl, ref, rl)),
                           normalized=normalized)
    got = P.edit_distance(*to_torch(hyp, hl, ref, rl),
                          normalized=normalized)
    close(got, want, what="edit distance")
