"""Sequence ops over padded+lengths batches (``paddle_tpu/ops/sequence.py``,
the LoD world).

Reference mapping: ``operators/sequence_ops/`` (seq_pool, seq_expand,
seq_pad/unpad, seq_mask, seq_softmax, seq_concat, seq_reverse over LoD
ragged tensors). Static shapes keep the ragged representation as
(data (B, T, ...), lengths (B,)); each op masks by lengths. The segment
variants cover the packed-sequence layout (:mod:`paddle_tpu_torch.data.
packing`), and :func:`make_segment_attention_bias` gates attention within
packed segments. Out-of-range indices follow the reference's
(``jax.ops``/``.at[]``) semantics: dropped, not raised.

The ops register under the reference's names. The RNN surfaces
(``dynamic_lstm``, ``dynamic_gru``, ``lstm_unit``, ``gru_unit``) run the
cells of :mod:`paddle_tpu_torch.nn.rnn`, which hold their own parameters
(the reference passes a parameter tree beside the layer).
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.registry import register_op

NEG_INF = -1e30


def _take(x, idx):
    """``take_along_axis(x, idx, axis=1)`` for a (B, T) index over x of
    rank 2 or 3 (the index repeated over the last axis)."""
    if x.ndim == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape,
                                                    x.shape[-1]))


@register_op("sequence_mask")
def sequence_mask(lengths, maxlen=None, dtype=torch.bool):
    """(B,) lengths -> (B, T) validity mask (sequence_mask_op)."""
    if maxlen is None:
        maxlen = int(lengths.max())  # reads the lengths on the host
    pos = torch.arange(maxlen, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).to(dtype)


@register_op("sequence_pool")
def sequence_pool(x, lengths, pool_type="sum"):
    """Pool (B, T, D) over valid positions (sequence_pool_op:
    sum/average/sqrt/max/last/first)."""
    mask = sequence_mask(lengths, x.shape[1], x.dtype)[..., None]
    if pool_type == "sum":
        return (x * mask).sum(1)
    if pool_type in ("average", "mean"):
        denom = torch.clamp(lengths[:, None], min=1).to(x.dtype)
        return (x * mask).sum(1) / denom
    if pool_type == "sqrt":
        denom = torch.sqrt(torch.clamp(lengths[:, None], min=1).to(x.dtype))
        return (x * mask).sum(1) / denom
    if pool_type == "max":
        neg = torch.finfo(x.dtype).min
        return torch.where(mask > 0, x, torch.full_like(x, neg)).amax(1)
    if pool_type == "last":
        idx = torch.clamp(lengths - 1, min=0)
        return _take(x, idx[:, None].long())[:, 0]
    if pool_type == "first":
        return x[:, 0]
    raise ValueError(f"unknown pool_type {pool_type}")


@register_op("sequence_softmax")
def sequence_softmax(x, lengths):
    """Masked softmax over the time dim (sequence_softmax_op)."""
    mask = sequence_mask(lengths, x.shape[1], torch.bool)
    z = torch.where(mask, x, torch.full_like(x, NEG_INF))
    p = torch.softmax(z, dim=1)
    return torch.where(mask, p, torch.zeros_like(p))


@register_op("sequence_reverse")
def sequence_reverse(x, lengths):
    """Reverse each row's valid prefix, keeping padding in place
    (sequence_reverse_op)."""
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]
    ln = lengths[:, None].long()
    src = torch.where(pos < ln, ln - 1 - pos, pos)
    return _take(x, src)


@register_op("sequence_expand")
def sequence_expand(x, times):
    """Repeat each row ``times`` times (a Python int; the LoD expand is
    data-dependent, see the reference)."""
    return torch.repeat_interleave(x, times, dim=0)


@register_op("sequence_pad")
def sequence_pad(rows, maxlen, pad_value=0.0):
    """Host-side helper: list of (len_i, D) arrays -> ((B, maxlen, D),
    lengths) as CPU tensors (sequence_pad_op: padding happens at ingest,
    matching the native feed's ragged slots)."""
    rows = [r.detach().cpu().numpy() if isinstance(r, torch.Tensor)
            else np.asarray(r) for r in rows]
    b = len(rows)
    d = np.shape(rows[0])[-1] if np.ndim(rows[0]) > 1 else None
    shape = (b, maxlen, d) if d else (b, maxlen)
    out = np.full(shape, pad_value, dtype=np.asarray(rows[0]).dtype)
    lengths = np.zeros((b,), np.int64)
    for i, r in enumerate(rows):
        r = np.asarray(r)
        n = min(len(r), maxlen)
        out[i, :n] = r[:n]
        lengths[i] = n
    return torch.from_numpy(out), torch.from_numpy(lengths)


@register_op("sequence_unpad")
def sequence_unpad(x, lengths):
    """(B, T, ...) -> list of valid prefixes (host-side numpy)."""
    xs = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    ls = np.asarray(lengths.cpu() if isinstance(lengths, torch.Tensor)
                    else lengths)
    return [xs[i, :ls[i]] for i in range(xs.shape[0])]


@register_op("sequence_conv")
def sequence_conv(x, lengths, filter_weight, context_start=-1,
                  padding_value=0.0):
    """Context-window convolution over time (sequence_conv_op): at each
    step t, the rows x[t+context_start : t+context_start+ctx_len] are
    concatenated and multiplied by ``filter_weight`` ((ctx_len*D, F)).
    Positions beyond each row's length are masked. x: (B, T, D) ->
    (B, T, F)."""
    b, t, d = x.shape
    ctx_len = filter_weight.shape[0] // d
    mask = sequence_mask(lengths, t, x.dtype)[..., None]
    xm = x * mask + padding_value * (1 - mask)
    pos = torch.arange(t, device=x.device)
    cols = []
    for j in range(ctx_len):
        off = context_start + j
        shifted = torch.roll(xm, -off, dims=1)
        valid = (pos + off >= 0) & (pos + off < t)
        cols.append(torch.where(valid[None, :, None], shifted,
                                torch.full_like(shifted, padding_value)))
    ctx = torch.cat(cols, dim=-1)                  # (B, T, ctx_len*D)
    out = torch.einsum("btc,cf->btf", ctx, filter_weight)
    return out * mask


@register_op("sequence_slice")
def sequence_slice(x, lengths, offsets, slice_lengths):
    """Per-row slice of the valid prefix (sequence_slice_op): row i keeps
    x[i, offsets[i] : offsets[i]+slice_lengths[i]], left-aligned into the
    same (B, T, ...) shape with zeros after; returns (out, new_lengths)."""
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)
    src = offsets[:, None] + pos[None, :]          # (B, T) gather index
    valid = (pos[None, :] < slice_lengths[:, None]) & \
        (src < lengths[:, None])
    gathered = _take(x, torch.clamp(src, 0, t - 1).long())
    shape = valid.shape + (1,) * (x.ndim - 2)
    out = torch.where(valid.reshape(shape), gathered,
                      torch.zeros_like(gathered))
    new_len = torch.minimum(slice_lengths,
                            torch.clamp(lengths - offsets, min=0))
    return out, new_len


@register_op("sequence_erase")
def sequence_erase(x, lengths, tokens):
    """Remove every occurrence of ``tokens`` from each row's valid prefix
    (sequence_erase_op), left-compacting survivors. x: (B, T) int;
    returns (out (B, T), new_lengths)."""
    t = x.shape[1]
    tokens = torch.as_tensor(tokens, device=x.device).reshape(-1)
    valid = sequence_mask(lengths, t, torch.bool)
    keep = valid & ~torch.isin(x, tokens)
    pos = torch.arange(t, device=x.device)[None, :]
    # stable left-compaction: sort by (dropped, original position)
    order = torch.argsort(torch.where(keep, pos, t + 1), dim=1, stable=True)
    compacted = torch.gather(x, 1, order)
    new_len = keep.sum(dim=1)
    out_mask = pos < new_len[:, None]
    return torch.where(out_mask, compacted, torch.zeros_like(compacted)), \
        new_len


@register_op("sequence_enumerate")
def sequence_enumerate(x, lengths, win_size, pad_value=0):
    """Sliding windows over each row (sequence_enumerate_op): output
    (B, T, win_size) where out[b, t] = x[b, t:t+win], positions past the
    row's length filled with ``pad_value``."""
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]
    wins = []
    for j in range(win_size):
        shifted = torch.roll(x, -j, dims=1)
        valid = (pos + j) < lengths[:, None]
        wins.append(torch.where(valid, shifted,
                                torch.full_like(shifted, pad_value)))
    return torch.stack(wins, dim=-1)


@register_op("sequence_concat")
def sequence_concat(x, x_lengths, y, y_lengths, pad_value=0):
    """Row-wise ragged concat (sequence_concat_op): row i becomes
    x[i,:lx] ++ y[i,:ly], padded to Tx+Ty; returns (out, lengths).
    x/y: (B, T) or (B, T, D)."""
    tx, ty = x.shape[1], y.shape[1]
    pos = torch.arange(tx + ty, device=x.device)[None, :]
    from_x = pos < x_lengths[:, None]
    y_idx = torch.clamp(pos - x_lengths[:, None], 0, ty - 1).long()
    x_idx = torch.clamp(pos, 0, tx - 1).long().expand_as(y_idx)
    sel = from_x if x.ndim == 2 else from_x[..., None]
    out = torch.where(sel, _take(x, x_idx), _take(y, y_idx))
    new_len = x_lengths + y_lengths
    keep = pos < new_len[:, None]
    if x.ndim == 3:
        keep = keep[..., None]
    return torch.where(keep, out, torch.full_like(out, pad_value)), new_len


# -- packed-segment variants (sequence packing) --------------------------------

def _in_range(segment_ids, num_segments):
    """Ids in ``[0, num_segments)``; the reference drops the others."""
    ids = segment_ids.long()
    return ids, (ids >= 0) & (ids < num_segments)


@register_op("segment_sum")
def segment_sum(data, segment_ids, num_segments):
    """``jax.ops.segment_sum``: per-segment sums over the leading axis;
    ids outside ``[0, num_segments)`` are dropped."""
    ids, ok = _in_range(segment_ids, num_segments)
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, ids[ok], data[ok])


@register_op("segment_max")
def segment_max(data, segment_ids, num_segments):
    """``jax.ops.segment_max``: per-segment maxima over the leading axis;
    an empty segment holds the dtype's lowest value (-inf for floats)."""
    ids, ok = _in_range(segment_ids, num_segments)
    low = (-float("inf") if data.is_floating_point()
           else torch.iinfo(data.dtype).min)
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), low)
    idx = ids[ok].reshape((-1,) + (1,) * (data.ndim - 1)).expand_as(data[ok])
    return out.scatter_reduce(0, idx, data[ok], "amax", include_self=True)


def make_segment_attention_bias(segment_ids, kv_segment_ids=None,
                                dtype=torch.float32):
    """Packed sequences: (B, Tq) segment ids -> additive (B, 1, Tq, Tkv)
    bias blocking cross-segment attention (0 within a segment, ``-1e30``
    across; padding, segment 0, attends padding). Pass ``kv_segment_ids``
    for cross-attention between two packed streams (decoder queries vs
    encoder keys: a pair shares its segment number across streams)."""
    if kv_segment_ids is None:
        kv_segment_ids = segment_ids
    same = segment_ids[:, :, None] == kv_segment_ids[:, None, :]
    return torch.where(same, 0.0, NEG_INF).to(dtype)[:, None, :, :]


@register_op("sequence_first_step")
def sequence_first_step(x, lengths):
    """sequence_first_step (sequence_pool FIRST): (B, T, ...) -> (B, ...)."""
    del lengths  # the first step is index 0 regardless
    return x[:, 0]


@register_op("sequence_last_step")
def sequence_last_step(x, lengths):
    """sequence_last_step (sequence_pool LAST)."""
    idx = torch.clamp(lengths - 1, min=0).long()
    idx = idx.reshape((-1,) + (1,) * (x.ndim - 1)).expand(
        (x.shape[0], 1) + tuple(x.shape[2:]))
    return torch.gather(x, 1, idx)[:, 0]


@register_op("sequence_expand_as")
def sequence_expand_as(x, ref_lengths, maxlen):
    """sequence_expand_as_op: repeat row i of x ``ref_lengths[i]`` times
    into a padded (B, maxlen, ...) layout (LoD -> padded analog)."""
    out = x[:, None].expand((x.shape[0], maxlen) + tuple(x.shape[1:]))
    mask = torch.arange(maxlen, device=x.device)[None, :] < \
        ref_lengths[:, None]
    return out * mask.reshape(mask.shape + (1,) * (x.ndim - 1)).to(x.dtype)


@register_op("sequence_reshape")
def sequence_reshape(x, lengths, new_dim):
    """sequence_reshape_op: re-chunk each row's valid timesteps into
    ``new_dim``-wide steps. Padded form: (B, T, D) -> (B, T*D//new_dim,
    new_dim) with adjusted lengths. Rows whose ``lengths * D`` is not
    divisible by ``new_dim`` get length -1, an in-band error the caller
    must check (as the reference's)."""
    b, t, d = x.shape
    if (t * d) % new_dim:
        raise ValueError(f"T*D={t*d} not divisible by new_dim={new_dim}")
    divisible = (lengths * d) % new_dim == 0
    new_lengths = torch.where(divisible, lengths * d // new_dim,
                              torch.full_like(lengths, -1))
    return x.reshape(b, t * d // new_dim, new_dim), new_lengths


@register_op("sequence_scatter")
def sequence_scatter(x, index, updates, lengths):
    """sequence_scatter_op: per-row scatter-add of updates at index
    positions (positions past lengths, and indices outside the row, are
    ignored)."""
    k = index.shape[1]
    valid = torch.arange(k, device=x.device)[None, :] < lengths[:, None]
    valid = valid & (index >= 0) & (index < x.shape[1])
    upd = torch.where(valid, updates, torch.zeros_like(updates)).to(x.dtype)
    idx = torch.where(valid, index, torch.zeros_like(index)).long()
    return x.scatter_add(1, idx, upd)


def dynamic_lstm(x, lengths, rnn):
    """layers.dynamic_lstm (``dynamic_lstm_op``): a ragged-batch LSTM, an
    :class:`~paddle_tpu_torch.nn.rnn.RNN` over an ``LSTMCell`` on padded
    rows and lengths. Returns ``(outputs (B, T, H), final state)``."""
    return rnn(x, lengths)


def dynamic_gru(x, lengths, rnn):
    """layers.dynamic_gru (``dynamic_gru_op``): as :func:`dynamic_lstm`
    over a ``GRUCell``."""
    return rnn(x, lengths)


def lstm_unit(state, x, cell):
    """layers.lstm_unit (``lstm_unit_op``): one ``LSTMCell`` step,
    ``(new (h, c), h)``."""
    return cell(state, x)


def gru_unit(state, x, cell):
    """layers.gru_unit (``gru_unit_op``): one ``GRUCell`` step."""
    return cell(state, x)
