"""BERT pretraining (``paddle_tpu/models/bert.py``): embeddings, a stack of
post-LN encoder layers over flash attention, the pooler, and the MLM
(tied-embedding decoder) and NSP heads with their losses.

Module attribute names mirror the reference's parameter tree
(``bert.embeddings.word.weight``, ``bert.encoder.{i}.attn.qkv_proj.weight``,
``heads.decoder_bias``, ...), so its weights carry across with a key
flatten and no transposes (:mod:`paddle_tpu_torch.models.convert`). Only
the layer-list layout is ported (see ROADMAP for the pipeline and stacked
layouts).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layers import Dropout, Embedding, LayerNorm, Linear
from paddle_tpu_torch.nn.transformer import TransformerEncoderLayer
from paddle_tpu_torch.ops import activation as ops_act
from paddle_tpu_torch.ops.attention import make_padding_bias


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    attn_dropout: float = 0.1
    pre_ln: bool = False
    attn_impl: str = "auto"

    @classmethod
    def base(cls, **kw):
        return cls(**kw)

    @classmethod
    def large(cls, **kw):
        return cls(hidden_size=1024, num_layers=24, num_heads=16,
                   ffn_size=4096, **kw)

    @classmethod
    def tiny(cls, **kw):
        """Test-size config."""
        kw.setdefault("vocab_size", 128)
        kw.setdefault("hidden_size", 32)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 2)
        kw.setdefault("ffn_size", 64)
        kw.setdefault("max_position", 64)
        return cls(**kw)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, **kw):
        super().__init__()
        self.word = Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.position = Embedding(cfg.max_position, cfg.hidden_size, **kw)
        self.token_type = Embedding(cfg.type_vocab_size, cfg.hidden_size,
                                    **kw)
        self.ln = LayerNorm(cfg.hidden_size, **kw)
        self.drop = Dropout(cfg.dropout)

    def forward(self, input_ids, token_type_ids=None,
                generator: Optional[torch.Generator] = None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.word(input_ids) + self.position(pos[None, :])
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = x + self.token_type(token_type_ids)
        return self.drop(self.ln(x), generator)


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig, **kw):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, **kw)
        self.encoder = nn.ModuleList([
            TransformerEncoderLayer(
                cfg.hidden_size, cfg.num_heads, cfg.ffn_size,
                dropout=cfg.dropout, attn_dropout=cfg.attn_dropout,
                pre_ln=cfg.pre_ln, attn_impl=cfg.attn_impl, **kw)
            for _ in range(cfg.num_layers)])
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                generator: Optional[torch.Generator] = None):
        """Returns (sequence_output (B, S, D), pooled_output (B, D)).
        ``attention_mask`` (B, S) bool marks valid keys; it becomes a
        key-padding bias (B, 1, 1, S)."""
        bias = (make_padding_bias(attention_mask)
                if attention_mask is not None else None)
        x = self.embeddings(input_ids, token_type_ids, generator)
        for layer in self.encoder:
            x = layer(x, bias=bias, generator=generator)
        return x, torch.tanh(self.pooler(x[:, 0]))


class BertPretrainingHeads(nn.Module):
    """MLM head (transform + tied-embedding decoder) + NSP head."""

    def __init__(self, cfg: BertConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        self.ln = LayerNorm(cfg.hidden_size, **kw)
        self.decoder_bias = nn.Parameter(torch.zeros(cfg.vocab_size, **kw))
        self.nsp = Linear(cfg.hidden_size, 2, **kw)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        I.zeros(self.decoder_bias)

    def forward(self, sequence_output, pooled_output, word_table):
        h = ops_act.gelu(self.transform(sequence_output))
        h = self.ln(h)
        mlm_logits = torch.einsum("bsd,vd->bsv", h, word_table) \
            + self.decoder_bias
        return mlm_logits, self.nsp(pooled_output)


class BertForPretraining(nn.Module):
    """BERT with MLM + NSP losses.

    Weights are initialised from ``seed`` through a ``torch.Generator``
    on ``device`` with the reference's schemes (xavier-uniform linears,
    normal(0.02) embeddings, unit/zero layer norms, zero decoder bias).
    ``device`` defaults to CUDA and raises without a card unless
    ``device="cpu"`` is given. Dropout follows the module's training mode
    (on at construction, as for any ``nn.Module``) and draws from the
    ``generator`` passed to :meth:`forward` / :meth:`loss`."""

    def __init__(self, cfg: BertConfig, *, device="cuda",
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        self.cfg = cfg
        self.bert = BertModel(cfg, **kw)
        self.heads = BertPretrainingHeads(cfg, **kw)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        for mod in self.modules():
            if hasattr(mod, "reset_parameters"):
                mod.reset_parameters(gen)

    @property
    def device(self) -> torch.device:
        return self.heads.decoder_bias.device

    def forward(self, input_ids, token_type_ids=None, attention_mask=None, *,
                generator: Optional[torch.Generator] = None):
        """Returns (mlm_logits (B, S, V), nsp_logits (B, 2))."""
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask,
                                generator)
        return self.heads(seq, pooled, self.bert.embeddings.word.weight)

    def loss(self, input_ids, token_type_ids, attention_mask, mlm_labels,
             mlm_mask, nsp_labels, *,
             generator: Optional[torch.Generator] = None):
        """mlm_labels: (B, S) target ids; mlm_mask: (B, S) 1.0 where
        masked; nsp_labels: (B,). Returns (loss, metrics). The MLM
        log-softmax runs in fp32 over every position, as the reference's
        does."""
        mlm_logits, nsp_logits = self.forward(
            input_ids, token_type_ids, attention_mask, generator=generator)
        mlm_lp = torch.log_softmax(mlm_logits.float(), dim=-1)
        mlm_nll = -torch.gather(mlm_lp, -1, mlm_labels[..., None].long())[..., 0]
        denom = torch.clamp(mlm_mask.sum(), min=1.0)
        mlm_loss = (mlm_nll * mlm_mask).sum() / denom
        nsp_lp = torch.log_softmax(nsp_logits.float(), dim=-1)
        nsp_loss = -torch.gather(nsp_lp, -1,
                                 nsp_labels[:, None].long()).mean()
        loss = mlm_loss + nsp_loss
        return loss, {"mlm_loss": mlm_loss, "nsp_loss": nsp_loss}

    @classmethod
    def from_jax(cls, cfg: BertConfig, params, *,
                 device="cuda") -> "BertForPretraining":
        """Build the port model from a reference parameter tree given as
        nested dicts of numpy arrays (``jax.device_get(params)``)."""
        from paddle_tpu_torch.models.convert import state_from_jax
        state = state_from_jax(params)
        model = cls(cfg, device=device,
                    dtype=state["heads.decoder_bias"].dtype)
        model.load_state_dict(state)
        return model
