"""Recurrent layers (``paddle_tpu/nn/rnn.py``): LSTM, LSTMP, GRU and plain
RNN cells, unrolled over time by :class:`RNN`, :class:`BiRNN` and the
stacked :class:`LSTM`.

The cells keep the reference's parameter layout, so a reference tree
carries across with a plain key flatten (``models.convert``):

- LSTM: one fused ``(in + hidden, 4 * hidden)`` weight ``w`` over
  ``concat([x, h])`` and a bias ``b``, gates in the order i, f, g, o, and
  ``forget_bias`` added inside the forget gate's sigmoid (not
  ``torch.nn.LSTM``'s layout, two biases or packed-sequence masking);
- LSTMP: the same over ``concat([x, r])`` and a ``(hidden, proj)``
  projection ``proj`` of the output;
- GRU: ``w_rz`` ``(in + hidden, 2 * hidden)`` and ``w_h`` ``(in + hidden,
  hidden)`` over ``concat([x, r * h])``, with ``b_rz`` and ``b_h``.

Ragged batches are padded ``(B, T, D)`` rows with ``(B,)`` lengths (the
LoD analog): at a step at or past ``lengths[b]`` a row's state stays as
it was and its output is zero. The reverse direction walks the padded
time axis from ``T - 1`` down with the same mask, so a reversed row
starts at its own ``length - 1``.

The unrolled loop hoists each cell's input half of the gate product out
of the time loop (:meth:`LSTMCell.input_proj`): one ``(B*T, in)`` GEMM
with the bias in it, then one ``(B, hidden)`` GEMM a step against the
recurrent rows of the weight, sliced once a sequence
(:meth:`LSTMCell.recurrent_weights`) so that autograd sums their
gradient over the steps before it scatters it into the whole weight.
The sums are the reference's ``concat([x, h]) @ w + b`` split in two,
so they differ from it only in rounding (within the tests' 1e-5).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch.nn import initializer as I

COLUMN, ROW = (None, "tp"), ("tp", None)


def _param(*shape, device=None, dtype=None):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class _Cell(nn.Module):
    """A cell's step: ``forward(state, x) -> (new_state, out)``, the
    reference's, and its halves :meth:`input_proj` (the part of the gate
    products that reads ``x`` only, for a whole sequence at once) and
    :meth:`step` (the rest, on one step's slice of it and the
    :meth:`recurrent_weights`)."""

    def forward(self, state, x):
        return self.step(state, self.input_proj(x),
                         self.recurrent_weights())

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for name, p in self.named_parameters(recurse=False):
            if name.startswith("b"):
                I.zeros(p)
            else:
                I.xavier_uniform()(p, generator)


class LSTMCell(_Cell):
    """Fused-gate LSTM cell: ``gates = concat([x, h]) @ w + b`` split
    i, f, g, o; ``c = sigmoid(f + forget_bias) * c + sigmoid(i) *
    tanh(g)``, ``h = sigmoid(o) * tanh(c)``."""

    def __init__(self, input_size: int, hidden_size: int,
                 forget_bias: float = 1.0, *, device=None, dtype=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.forget_bias = forget_bias
        self.w = _param(input_size + hidden_size, 4 * hidden_size,
                        device=device, dtype=dtype)
        self.b = _param(4 * hidden_size, device=device, dtype=dtype)
        self.param_sharding = {"w": COLUMN, "b": None}

    def initial_state(self, batch: int, dtype=torch.float32, device=None):
        z = torch.zeros((batch, self.hidden_size), dtype=dtype,
                        device=device if device is not None
                        else self.w.device)
        return (z, z)

    def input_proj(self, x):
        return (torch.matmul(x, self.w[:self.input_size]) + self.b,)

    def recurrent_weights(self):
        return (self.w[self.input_size:],)

    def _gates(self, c, gates):
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f + self.forget_bias) * c \
            + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)

    def step(self, state, xp, rw):
        h, c = state
        c, h = self._gates(c, xp[0] + torch.matmul(h, rw[0]))
        return (h, c), h


class LSTMPCell(LSTMCell):
    """LSTM with a recurrent projection (``dynamic_lstmp_op``): the cell
    state is ``hidden_size`` wide, the recurrent and output state ``r =
    h @ proj`` is ``proj_size`` wide. The state is ``(r, c)``."""

    def __init__(self, input_size: int, hidden_size: int, proj_size: int,
                 forget_bias: float = 1.0, *, device=None, dtype=None):
        nn.Module.__init__(self)
        self.input_size, self.hidden_size = input_size, hidden_size
        self.proj_size = proj_size
        self.forget_bias = forget_bias
        self.w = _param(input_size + proj_size, 4 * hidden_size,
                        device=device, dtype=dtype)
        self.b = _param(4 * hidden_size, device=device, dtype=dtype)
        self.proj = _param(hidden_size, proj_size, device=device, dtype=dtype)
        self.param_sharding = {"w": COLUMN, "b": None, "proj": ROW}

    def initial_state(self, batch: int, dtype=torch.float32, device=None):
        device = device if device is not None else self.w.device
        return (torch.zeros((batch, self.proj_size), dtype=dtype,
                            device=device),
                torch.zeros((batch, self.hidden_size), dtype=dtype,
                            device=device))

    def recurrent_weights(self):
        return (self.w[self.input_size:], self.proj)

    def step(self, state, xp, rw):
        r, c = state
        c, h = self._gates(c, xp[0] + torch.matmul(r, rw[0]))
        r = torch.matmul(h, rw[1])
        return (r, c), r


class GRUCell(_Cell):
    """GRU cell: ``r, z = sigmoid(concat([x, h]) @ w_rz + b_rz)``, ``hh =
    tanh(concat([x, r * h]) @ w_h + b_h)``, ``h = (1 - z) * hh + z * h``."""

    def __init__(self, input_size: int, hidden_size: int, *, device=None,
                 dtype=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        kw = dict(device=device, dtype=dtype)
        self.w_rz = _param(input_size + hidden_size, 2 * hidden_size, **kw)
        self.w_h = _param(input_size + hidden_size, hidden_size, **kw)
        self.b_rz = _param(2 * hidden_size, **kw)
        self.b_h = _param(hidden_size, **kw)
        self.param_sharding = {"w_rz": COLUMN, "w_h": COLUMN, "b_rz": None,
                               "b_h": None}

    def initial_state(self, batch: int, dtype=torch.float32, device=None):
        return torch.zeros((batch, self.hidden_size), dtype=dtype,
                           device=device if device is not None
                           else self.w_h.device)

    def input_proj(self, x):
        n = self.input_size
        return (torch.matmul(x, self.w_rz[:n]) + self.b_rz,
                torch.matmul(x, self.w_h[:n]) + self.b_h)

    def recurrent_weights(self):
        n = self.input_size
        return (self.w_rz[n:], self.w_h[n:])

    def step(self, state, xp, rw):
        h = state
        rz = torch.sigmoid(xp[0] + torch.matmul(h, rw[0]))
        r, z = rz.chunk(2, dim=-1)
        hh = torch.tanh(xp[1] + torch.matmul(r * h, rw[1]))
        h = (1 - z) * hh + z * h
        return h, h


class SimpleRNNCell(_Cell):
    """``h = activation(concat([x, h]) @ w + b)`` (tanh by default)."""

    def __init__(self, input_size: int, hidden_size: int,
                 activation=torch.tanh, *, device=None, dtype=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        self.w = _param(input_size + hidden_size, hidden_size, device=device,
                        dtype=dtype)
        self.b = _param(hidden_size, device=device, dtype=dtype)

    def initial_state(self, batch: int, dtype=torch.float32, device=None):
        return torch.zeros((batch, self.hidden_size), dtype=dtype,
                           device=device if device is not None
                           else self.w.device)

    def input_proj(self, x):
        return (torch.matmul(x, self.w[:self.input_size]) + self.b,)

    def recurrent_weights(self):
        return (self.w[self.input_size:],)

    def step(self, state, xp, rw):
        h = self.activation(xp[0] + torch.matmul(state, rw[0]))
        return h, h


def _where_state(valid, new, old):
    if isinstance(new, torch.Tensor):
        return torch.where(valid, new, old)
    return type(new)(_where_state(valid, n, o) for n, o in zip(new, old))


class RNN(nn.Module):
    """Unroll ``cell`` over time (``recurrent_op`` / ``DynamicRNN``).

    ``forward(x, lengths=None, initial_state=None)``: x (B, T, D) ->
    (outputs (B, T, H), final state). With ``lengths`` (B,), positions at
    or past a row's length leave its state as it was and output zeros;
    ``reverse`` walks the time axis from the end."""

    def __init__(self, cell: _Cell, reverse: bool = False):
        super().__init__()
        self.cell = cell
        self.reverse = reverse

    def forward(self, x, lengths=None, initial_state=None):
        b, t, _ = x.shape
        state = (initial_state if initial_state is not None
                 else self.cell.initial_state(b, x.dtype, x.device))
        xp = self.cell.input_proj(x)             # hoisted: (B, T, G) each
        rw = self.cell.recurrent_weights()
        outs = [None] * t
        for i in (range(t - 1, -1, -1) if self.reverse else range(t)):
            new_state, out = self.cell.step(state, [p[:, i] for p in xp],
                                            rw)
            if lengths is not None:
                valid = (lengths > i)[:, None]
                new_state = _where_state(valid, new_state, state)
                out = torch.where(valid, out, torch.zeros_like(out))
            state = new_state
            outs[i] = out
        return torch.stack(outs, dim=1), state


class BiRNN(nn.Module):
    """Forward and backward passes, outputs concatenated on the last axis;
    the final state is ``(forward's, backward's)``."""

    def __init__(self, fwd_cell: _Cell, bwd_cell: _Cell):
        super().__init__()
        self.fwd = RNN(fwd_cell)
        self.bwd = RNN(bwd_cell, reverse=True)

    def forward(self, x, lengths=None):
        of, sf = self.fwd(x, lengths)
        ob, sb = self.bwd(x, lengths)
        return torch.cat([of, ob], dim=-1), (sf, sb)


class LSTM(nn.Module):
    """A stack of (optionally bidirectional) LSTM layers
    (``cudnn_lstm_op``'s role): ``forward(x, lengths=None) -> (outputs,
    [final state of each layer])``. Parameters live at
    ``stack.{i}.cell.*`` (``stack.{i}.{fwd,bwd}.cell.*`` when
    bidirectional), the reference's tree."""

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, bidirectional: bool = False, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        size, layers = input_size, []
        for _ in range(num_layers):
            if bidirectional:
                layers.append(BiRNN(LSTMCell(size, hidden_size, **kw),
                                    LSTMCell(size, hidden_size, **kw)))
                size = 2 * hidden_size
            else:
                layers.append(RNN(LSTMCell(size, hidden_size, **kw)))
                size = hidden_size
        self.stack = nn.ModuleList(layers)
        self.output_size = size

    def forward(self, x, lengths=None):
        finals = []
        for layer in self.stack:
            x, final = layer(x, lengths)
            finals.append(final)
        return x, finals
