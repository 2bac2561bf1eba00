"""The port's recurrent layers (``paddle_tpu_torch/nn/rnn.py``) and the
RNN surfaces of ``ops/sequence.py`` against the JAX package on the CPU:
every cell and stack on the same numpy inputs and ``from_jax`` weights,
ragged lengths including 0 and T in both directions, outputs and final
states within 1e-6 and every gradient within atol 1e-5 / rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import rnn as J
from paddle_tpu.ops import sequence as JS
from paddle_tpu_torch.models.convert import load_jax
from paddle_tpu_torch.nn import rnn as P
from paddle_tpu_torch.ops import sequence as PS
from torch_parity import close, grads_close, init, to_torch

torch.set_num_threads(2)
B, T, D, H = 4, 7, 5, 6
LENGTHS = np.array([0, 3, T, 5], np.int32)


def _x(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, T, D)).astype(np.float32)


def _cell_pair(kind):
    if kind == "lstm":
        return J.LSTMCell(D, H, forget_bias=0.5), P.LSTMCell(D, H, 0.5)
    if kind == "lstmp":
        return J.LSTMPCell(D, H, 3), P.LSTMPCell(D, H, 3)
    if kind == "gru":
        return J.GRUCell(D, H), P.GRUCell(D, H)
    return J.SimpleRNNCell(D, H), P.SimpleRNNCell(D, H)


def _tree_close(got, want, what):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for g, w in zip(got, want):
            _tree_close(g, w, what)
    else:
        close(got, want, what=what)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("kind", ["lstm", "lstmp", "gru", "simple"])
def test_rnn_over_ragged_rows_equals_the_reference(kind, reverse):
    jc, pc = _cell_pair(kind)
    jr, pr = J.RNN(jc, reverse=reverse), P.RNN(pc, reverse=reverse)
    params = init(jr, seed=1)
    load_jax(pr, params)
    x = _x()
    weights = np.random.default_rng(9).standard_normal(
        (B, T, pc.proj_size if kind == "lstmp" else H)).astype(np.float32)

    def jloss(p):
        out, final = jr(p, jnp.asarray(x), jnp.asarray(LENGTHS))
        return (out * weights).sum(), (out, final)

    (_, (jo, jf)), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    xt, lt = to_torch(x, LENGTHS)
    po, pf = pr(xt, lt)
    _tree_close(po, jo, "outputs")
    _tree_close(pf, jf, "final state")
    # a row of length 0 keeps its initial state and outputs zeros
    assert float(po[0].detach().abs().max()) == 0.0
    (po * torch.from_numpy(weights)).sum().backward()
    grads_close(pr, jg)


@pytest.mark.parametrize("bidirectional", [False, True], ids=["uni", "bi"])
def test_lstm_stack_equals_the_reference(bidirectional):
    jm = J.LSTM(D, H, num_layers=2, bidirectional=bidirectional)
    pm = P.LSTM(D, H, num_layers=2, bidirectional=bidirectional)
    params = init(jm, seed=2)
    load_jax(pm, params)
    assert pm.output_size == jm.output_size
    x = _x(3)
    xt, lt = to_torch(x, LENGTHS)

    def jloss(p, xx):
        out, _ = jm(p, xx, jnp.asarray(LENGTHS))
        return jnp.tanh(out).sum(), out

    (_, jo), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                            has_aux=True)(params,
                                                          jnp.asarray(x))
    xt.requires_grad_(True)
    po, finals = pm(xt, lt)
    close(po, jo, what="outputs")
    assert len(finals) == 2
    torch.tanh(po).sum().backward()
    grads_close(pm, jg)
    close(xt.grad, jgx, 1e-5, 1e-4, what="input gradient")


def test_reverse_row_starts_at_its_own_last_step():
    """A reversed row of length L reads x[L-1] first: its first output
    (at position L-1) is the cell applied to x[L-1] from the zero
    state."""
    cell = P.SimpleRNNCell(D, H)
    cell.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(4))
    out, _ = P.RNN(cell, reverse=True)(x, torch.from_numpy(LENGTHS))
    for b, n in enumerate(LENGTHS):
        if n:
            first, _ = cell(cell.initial_state(1), x[b:b + 1, n - 1])
            torch.testing.assert_close(out[b, n - 1], first[0])
            assert float(out[b, n:].abs().sum()) == 0.0


@pytest.mark.parametrize("surface", ["dynamic_lstm", "dynamic_gru"])
def test_sequence_rnn_surfaces_equal_the_reference(surface):
    cells = ((J.LSTMCell(D, H), P.LSTMCell(D, H)) if surface ==
             "dynamic_lstm" else (J.GRUCell(D, H), P.GRUCell(D, H)))
    jr, pr = J.RNN(cells[0]), P.RNN(cells[1])
    params = init(jr, seed=5)
    load_jax(pr, params)
    x = _x(6)
    jo, jf = getattr(JS, surface)(jnp.asarray(x), jnp.asarray(LENGTHS),
                                  params, jr)
    po, pf = getattr(PS, surface)(*to_torch(x, LENGTHS), pr)
    close(po, jo, what="outputs")
    _tree_close(pf, jf, "final")


@pytest.mark.parametrize("surface", ["lstm_unit", "gru_unit"])
def test_one_step_units_equal_the_reference(surface):
    jc, pc = ((J.LSTMCell(D, H), P.LSTMCell(D, H)) if surface == "lstm_unit"
              else (J.GRUCell(D, H), P.GRUCell(D, H)))
    params = init(jc, seed=7)
    load_jax(pc, params)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, D)).astype(np.float32)
    h = rng.standard_normal((B, H)).astype(np.float32)
    c = rng.standard_normal((B, H)).astype(np.float32)
    jstate = (jnp.asarray(h), jnp.asarray(c)) if surface == "lstm_unit" \
        else jnp.asarray(h)
    pstate = tuple(to_torch(h, c)) if surface == "lstm_unit" \
        else torch.from_numpy(h)
    js, jo = getattr(JS, surface)(params, jstate, jnp.asarray(x), jc)
    ps, po = getattr(PS, surface)(pstate, torch.from_numpy(x), pc)
    close(po, jo, what="output")
    _tree_close(ps, js, "state")


def test_hints_follow_the_reference():
    assert P.LSTMCell(2, 3).param_sharding["w"] == (None, "tp")
    assert P.LSTMPCell(2, 3, 2).param_sharding["proj"] == ("tp", None)
    assert P.GRUCell(2, 3).param_sharding["w_h"] == (None, "tp")
