"""BERT pretraining (``paddle_tpu/models/bert.py``): embeddings, a stack of
post-LN encoder layers over flash attention, the pooler, and the MLM
(tied-embedding decoder) and NSP heads with their losses.

Module attribute names mirror the reference's parameter tree
(``bert.embeddings.word.weight``, ``bert.encoder.{i}.attn.qkv_proj.weight``,
``heads.decoder_bias``, ...), so its weights carry across with a key
flatten and no transposes (:mod:`paddle_tpu_torch.models.convert`). The
encoder is a layer list, or with ``stacked_layers`` one
``nn.module.StackedLayers`` whose parameters are the reference's stacked
``(L, ...)`` leaves (``bert.encoder.attn.qkv_proj.weight``);
:func:`stack_encoder_params` / :func:`unstack_encoder_params` move a
checkpoint between the two. The layers carry the reference's sharding
hints (``nn.module.sharding_specs``; a stacked leaf's hint has "pp" in
front).

Pipeline parallelism (``pipeline=True``): the encoder stack runs through
``parallel.pipeline.gpipe_layer_stack`` over the ambient mesh's "pp"
axis (GPipe, or the circular schedule with ``pp_circuits`` chunks per
rank), ``pp_microbatches`` microbatches, the key-padding bias riding as
each microbatch's extra; embeddings and heads stay outside the pipelined
middle, replicated over "pp". Without a mesh (or at pp=1) the same
schedule runs in one process. It does not compose with a sequence split
over "sp" (the reference never composes the ring with the pipeline).

Sequence parallel (``attn_impl="ring"`` under a mesh whose "sp" axis has
more than one rank): each rank feeds its own block of ``S/sp`` tokens.
Positions start at the block's offset in the sequence, the pooled output
is sp rank 0's first token broadcast to every rank, and the MLM loss is
the global masked sum over the global mask count; so the losses and the
pooled output are the unsharded model's on every rank. Over the axes the
sharded step's batch spec splits the batch over ("dp", "fsdp", and "ep"
where it names it: ``parallel.functional.current_token_layout``) both
losses are means over the whole batch (``parallel.functional.
global_mean``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch.core import mesh as mesh_lib
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layers import Dropout, Embedding, LayerNorm, Linear
from paddle_tpu_torch.nn.module import StackedLayers, pipeline_layers
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
    # pipeline parallelism: the encoder stack through the schedule over
    # the "pp" mesh axis (parallel/pipeline.py), pp_microbatches
    # microbatches; embeddings and heads stay outside it
    pipeline: bool = False
    pp_microbatches: int = 2
    # "gpipe", or "circular" (pp_circuits chunks per rank: a smaller
    # bubble, parallel.pipeline.pipeline_bubble_fraction)
    pp_schedule: str = "gpipe"
    pp_circuits: int = 1
    # the stacked encoder is stored in the circular schedule's
    # interleaved order (parallel.pipeline.interleave_stack), so a split
    # over "pp" holds each stage's chunks and no weight moves per step
    pp_pre_interleaved: bool = False
    # the encoder as stacked (L, ...) parameters (nn.module.StackedLayers),
    # split over "pp" by placement; on by default with pipeline. It
    # changes the checkpoint's tree: stack_encoder_params moves one over
    stacked_layers: Optional[bool] = None

    def __post_init__(self):
        if self.stacked_layers is None:
            self.stacked_layers = self.pipeline

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


def stack_encoder_params(params, num_layers: int):
    """A layer-list BERT checkpoint tree (the reference's nested dicts of
    arrays or tensors, ``models.convert.params_tree`` of the port) in the
    stacked layout."""
    from paddle_tpu_torch.parallel import pipeline as pp_lib
    return pp_lib.stack_params_at(params, ("bert", "encoder"), num_layers)


def unstack_encoder_params(params, num_layers: int):
    """Inverse of :func:`stack_encoder_params`."""
    from paddle_tpu_torch.parallel import pipeline as pp_lib
    return pp_lib.unstack_params_at(params, ("bert", "encoder"), num_layers)


def _sp_block(cfg: BertConfig):
    """``(mesh, this rank's index)`` on the ambient mesh's "sp" axis when
    the sequence is split over it, else ``(None, 0)``."""
    mesh = mesh_lib.current_mesh()
    n = mesh_lib.axis_size(mesh, mesh_lib.SP) if mesh is not None else 1
    if n == 1:
        return None, 0
    if cfg.attn_impl != "ring":
        raise ValueError(f"the sequence is split over sp={n} ranks: BERT "
                         "needs attn_impl='ring' there")
    return mesh, mesh_lib.axis_index(mesh, mesh_lib.SP)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, **kw):
        super().__init__()
        self.cfg = cfg
        self.word = Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.position = Embedding(cfg.max_position, cfg.hidden_size,
                                  sharding=None, **kw)
        self.token_type = Embedding(cfg.type_vocab_size, cfg.hidden_size,
                                    sharding=None, **kw)
        self.ln = LayerNorm(cfg.hidden_size, **kw)
        self.drop = Dropout(cfg.dropout)

    def forward(self, input_ids, token_type_ids=None,
                generator: Optional[torch.Generator] = None):
        s = input_ids.shape[1]
        _, block = _sp_block(self.cfg)
        pos = torch.arange(block * s, (block + 1) * s,
                           device=input_ids.device)
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

        make_layer = functools.partial(
            TransformerEncoderLayer, cfg.hidden_size, cfg.num_heads,
            cfg.ffn_size, dropout=cfg.dropout, attn_dropout=cfg.attn_dropout,
            pre_ln=cfg.pre_ln, attn_impl=cfg.attn_impl)

        if cfg.stacked_layers:
            self.encoder = StackedLayers(make_layer, cfg.num_layers, **kw)
        else:
            self.encoder = nn.ModuleList([make_layer(**kw)
                                          for _ in range(cfg.num_layers)])
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size, sharding=None,
                             **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                generator: Optional[torch.Generator] = None):
        """Returns (sequence_output (B, S, D), pooled_output (B, D)).
        ``attention_mask`` (B, S) bool marks valid keys; it becomes a
        key-padding bias (B, 1, 1, S)."""
        bias = (make_padding_bias(attention_mask)
                if attention_mask is not None else None)
        if self.cfg.pipeline:
            mesh = mesh_lib.current_mesh()
            if mesh is not None and mesh_lib.axis_size(mesh, mesh_lib.SP) > 1:
                raise ValueError("a pipelined BERT does not compose with a "
                                 "sequence split over sp")
        x = self.embeddings(input_ids, token_type_ids, generator)
        if self.cfg.pipeline:
            x = self._encoder_pipelined(x, bias, generator)
        elif self.cfg.stacked_layers:
            x = self.encoder(x, bias=bias, generator=generator)
        else:
            for layer in self.encoder:
                x = layer(x, bias=bias, generator=generator)
        first = x[:, 0]
        mesh, _ = _sp_block(self.cfg)
        if mesh is not None:         # the first token lies on sp rank 0
            from paddle_tpu_torch.parallel.functional import broadcast_from
            first = broadcast_from(first, mesh_lib.SP, 0, mesh)
        return x, torch.tanh(self.pooler(first))

    def _encoder_pipelined(self, x, bias, generator):
        """The encoder stack through the pipeline over "pp" (module
        docstring): stacked rows as they are held (whole, or this stage's
        under a split over "pp"), or the layer list stacked here; the
        bias microbatched as an extra; with dropout live, one seed drawn
        from ``generator`` for the step."""
        from paddle_tpu_torch.parallel import pipeline as pp_lib
        cfg = self.cfg
        extras = extras_spec = None
        if bias is not None:
            extras, extras_spec = pp_lib.microbatch_extras(
                bias, cfg.pp_microbatches)
        seed = None
        if self.training and (cfg.dropout > 0 or cfg.attn_dropout > 0):
            seed = pp_lib.step_seed(generator, x.device)
        apply, params = pipeline_layers(self.encoder)
        return pp_lib.gpipe_layer_stack(
            lambda lp, h, extra, gen: apply(lp, h, bias=extra,
                                            generator=gen),
            params, x, num_microbatches=cfg.pp_microbatches,
            num_layers=cfg.num_layers, seed=seed, extras=extras,
            extras_spec=extras_spec, schedule=cfg.pp_schedule,
            num_circuits=cfg.pp_circuits,
            pre_interleaved=cfg.pp_pre_interleaved)


class BertPretrainingHeads(nn.Module):
    """MLM head (transform + tied-embedding decoder) + NSP head."""

    def __init__(self, cfg: BertConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size,
                                sharding=None, **kw)
        self.ln = LayerNorm(cfg.hidden_size, **kw)
        self.decoder_bias = nn.Parameter(torch.zeros(cfg.vocab_size, **kw))
        self.nsp = Linear(cfg.hidden_size, 2, sharding=None, **kw)
        self.param_sharding = {"decoder_bias": ("tp",)}

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        I.zeros(self.decoder_bias)

    def forward(self, sequence_output, pooled_output, word: Embedding):
        """``word`` is the tied word embedding (the decoder's table)."""
        h = ops_act.gelu(self.transform(sequence_output))
        h = self.ln(h)
        mlm_logits = word.attend(h, self.decoder_bias)
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
        return self.heads(seq, pooled, self.bert.embeddings.word)

    def loss(self, input_ids, token_type_ids, attention_mask, mlm_labels,
             mlm_mask, nsp_labels, *,
             generator: Optional[torch.Generator] = None):
        """mlm_labels: (B, S) target ids; mlm_mask: (B, S) 1.0 where
        masked; nsp_labels: (B,). Returns (loss, metrics). The MLM
        log-softmax runs in fp32 over every position, as the reference's
        does. Under a mesh both losses are means over the global batch
        (module docstring)."""
        mlm_logits, nsp_logits = self.forward(
            input_ids, token_type_ids, attention_mask, generator=generator)
        mlm_lp = torch.log_softmax(mlm_logits.float(), dim=-1)
        mlm_nll = -torch.gather(mlm_lp, -1, mlm_labels[..., None].long())[..., 0]
        nsp_lp = torch.log_softmax(nsp_logits.float(), dim=-1)
        nsp_nll = -torch.gather(nsp_lp, -1, nsp_labels[:, None].long())
        mesh = mesh_lib.current_mesh()
        if mesh is None:
            denom = torch.clamp(mlm_mask.sum(), min=1.0)
            mlm_loss = (mlm_nll * mlm_mask).sum() / denom
            nsp_loss = nsp_nll.mean()
        else:
            from paddle_tpu_torch.parallel.functional import (
                current_token_layout, global_mean)
            batch, seq = current_token_layout()
            mlm_loss = global_mean((mlm_nll * mlm_mask).sum(),
                                   mlm_mask.sum(), batch + seq, mesh)
            # every sp rank holds the same sequences' NSP terms
            nsp_loss = global_mean(nsp_nll.sum(), torch.full(
                (), float(nsp_nll.numel()), device=nsp_nll.device), batch,
                mesh)
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
