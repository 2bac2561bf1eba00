"""DeepFM, the CTR model over high-dimensional sparse embeddings
(``paddle_tpu/models/deepfm.py``).

Two placements of the table (:func:`paddle_tpu_torch.parallel.host_kv.
fits_hbm` decides):

- :class:`DeepFM`: the table fits the card; its rows split over "tp"
  (:mod:`paddle_tpu_torch.parallel.embedding`), the whole model one step.
- :class:`DeepFMHostKV`: the table lives in the host KV store
  (:mod:`paddle_tpu_torch.parallel.host_kv`); the step takes the batch's
  pulled rows as a differentiable input and the host applies the sparse
  optimizer to their gradient. One combined value per id:
  ``row = [w_linear, e_0..e_{D-1}]``.

The modules keep the reference's parameter names (``dnn.{i}.weight``,
``dnn_out.bias``, ``bias``, ``embedding.weight``) and ``Linear``'s
``(in, out)`` layout, so a reference parameter tree carries across with a
plain key flatten (:meth:`from_jax`, ``models.convert``). Weights are
drawn from ``seed`` with the reference's schemes (xavier-uniform dense
weights, zero biases, normal(0, 0.01) tables); the draws differ from
``jax.random``'s.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.nn.layers import Linear, embedding
from paddle_tpu_torch.ops.nn import sigmoid_cross_entropy_with_logits


class _DeepFMTowers(nn.Module):
    """The dense half over gathered embeddings: FM second order, the DNN
    tower and the bias."""

    def __init__(self, num_fields: int, embed_dim: int = 8,
                 hidden: Sequence[int] = (400, 400, 400), *,
                 device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.num_fields = num_fields
        self.embed_dim = embed_dim
        layers = []
        in_dim = num_fields * embed_dim
        for h in hidden:
            layers.append(Linear(in_dim, h, sharding=None, **kw))
            in_dim = h
        self.dnn = nn.ModuleList(layers)
        self.dnn_out = Linear(in_dim, 1, sharding=None, **kw)
        self.bias = nn.Parameter(torch.zeros(1, **kw))

    def _init(self, seed: int):
        """Every layer's weights from ``seed`` (the bias stays zero)."""
        gen = torch.Generator(device=self.bias.device)
        gen.manual_seed(seed)
        for mod in self.modules():
            if hasattr(mod, "reset_parameters"):
                mod.reset_parameters(gen)

    @property
    def device(self) -> torch.device:
        return self.bias.device

    def forward_embedded(self, emb, w, feat_vals=None):
        """``emb`` (B, F, D) per-feature embeddings, ``w`` (B, F)
        first-order weights -> (B,) logits."""
        b, f, _ = emb.shape
        if feat_vals is None:
            feat_vals = torch.ones((b, f), dtype=torch.float32,
                                   device=emb.device)
        emb = emb * feat_vals[..., None]
        first = (w * feat_vals).sum(-1)
        # FM second order: 0.5 * ((sum e)^2 - sum e^2)
        s = emb.sum(dim=1)
        second = 0.5 * (s * s - (emb * emb).sum(dim=1)).sum(-1)
        h = emb.reshape(b, -1)
        for layer in self.dnn:
            h = torch.relu(layer(h))
        dnn_logit = self.dnn_out(h)[:, 0]
        return first + second + dnn_logit + self.bias[0]

    def _loss(self, logits, label):
        loss = sigmoid_cross_entropy_with_logits(
            logits, label.to(torch.float32)).mean()
        return loss, {"prob_mean": torch.sigmoid(logits).mean()}

    @classmethod
    def _load(cls, model, params):
        from paddle_tpu_torch.models.convert import state_from_jax
        model.load_state_dict(state_from_jax(params))
        return model


def _tower_dims(params, num_fields: int):
    """``(embed_dim, hidden)`` of a reference parameter tree."""
    dnn = params.get("dnn", {})
    hidden = tuple(int(dnn[str(i)]["weight"].shape[1])
                   for i in range(len(dnn)))
    first = dnn["0"]["weight"] if hidden else params["dnn_out"]["weight"]
    return int(first.shape[0]) // num_fields, hidden


class DeepFM(_DeepFMTowers):
    """The table on the card. ``forward(feat_ids, feat_vals=None)``:
    feat_ids (B, F) hashed into [0, vocab); feat_vals (B, F) optional
    values. Under a mesh whose ``axis`` has more than one rank, the two
    tables hold this rank's block of rows (their hints' placement)."""

    def __init__(self, vocab_size: int, num_fields: int, embed_dim: int = 8,
                 hidden: Sequence[int] = (400, 400, 400), axis: str = "tp",
                 *, device="cuda", dtype: torch.dtype = torch.float32,
                 seed: int = 0):
        super().__init__(num_fields, embed_dim, hidden, device=device,
                         dtype=dtype)
        from paddle_tpu_torch.parallel.embedding import ShardedEmbedding
        kw = dict(device=self.device, dtype=dtype)
        self.embedding = ShardedEmbedding(vocab_size, embed_dim, axis=axis,
                                          **kw)
        self.linear_w = ShardedEmbedding(vocab_size, 1, axis=axis, **kw)
        self._init(seed)

    def forward(self, feat_ids, feat_vals=None):
        emb = self.embedding(feat_ids)                # (B, F, D)
        w = self.linear_w(feat_ids)[..., 0]           # (B, F)
        return self.forward_embedded(emb, w, feat_vals)

    def loss(self, feat_ids, label, feat_vals=None):
        """label: (B,) 0/1 clicks. Returns (logloss, aux)."""
        return self._loss(self.forward(feat_ids, feat_vals), label)

    @classmethod
    def from_jax(cls, params, num_fields: int, *, axis: str = "tp",
                 device="cuda") -> "DeepFM":
        """The port model of a reference parameter tree (nested dicts of
        numpy arrays, ``jax.device_get(params)``)."""
        vocab, embed_dim = params["embedding"]["weight"].shape
        _, hidden = _tower_dims(params, num_fields)
        return cls._load(cls(int(vocab), num_fields, int(embed_dim), hidden,
                             axis, device=device), params)


class DeepFMHostKV(_DeepFMTowers):
    """The table beyond the card: the module holds the towers only, and
    the sparse table is a :class:`~paddle_tpu_torch.parallel.host_kv.
    HostKVStore` with ``dim = 1 + embed_dim`` whose pulled rows the step
    consumes: ``rows[:, 0]`` the first-order weight, ``rows[:, 1:]`` the
    embedding."""

    kv_dim_for = staticmethod(lambda embed_dim: 1 + embed_dim)

    def __init__(self, num_fields: int, embed_dim: int = 8,
                 hidden: Sequence[int] = (400, 400, 400), *,
                 device="cuda", dtype: torch.dtype = torch.float32,
                 seed: int = 0):
        super().__init__(num_fields, embed_dim, hidden, device=device,
                         dtype=dtype)
        self._init(seed)

    def forward(self, rows, inv, feat_vals: Optional[torch.Tensor] = None):
        """rows: (U_pad, 1+D) pulled rows (a differentiable input); inv:
        (B, F) indices into rows. The gather's backward sums each row's
        gradients in a fixed order (:func:`~paddle_tpu_torch.nn.layers.
        embedding`), so the rows' gradient is reproducible bit for bit."""
        gathered = embedding(inv, rows)               # (B, F, 1+D)
        return self.forward_embedded(gathered[..., 1:], gathered[..., 0],
                                     feat_vals)

    def loss(self, rows, inv, label, feat_vals=None):
        return self._loss(self.forward(rows, inv, feat_vals), label)

    def predict_proba(self, rows, inv, feat_vals=None):
        """Serving forward: (B,) click probabilities from pulled rows.
        ``rows`` may carry trailing padding lanes (``inv`` never points at
        them), so one graph serves any batch whose unique ids fit its
        width."""
        return torch.sigmoid(self.forward(rows, inv, feat_vals))

    @classmethod
    def from_jax(cls, params, num_fields: int, *,
                 device="cuda") -> "DeepFMHostKV":
        """The port model of a reference parameter tree (nested dicts of
        numpy arrays, ``jax.device_get(params)``)."""
        embed_dim, hidden = _tower_dims(params, num_fields)
        return cls._load(cls(num_fields, embed_dim, hidden, device=device),
                         params)
