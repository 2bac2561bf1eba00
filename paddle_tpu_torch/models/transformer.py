"""Transformer encoder-decoder (base/big) for WMT en-de
(``paddle_tpu/models/transformer.py``).

Pre-LN encoder and decoder stacks over flash attention
(:mod:`paddle_tpu_torch.nn.transformer`), a shared vocabulary with the
tied output projection, sinusoid positions, label-smoothed cross
entropy, greedy decoding and beam search (cached or not). Packed
variable-length
training (:meth:`Transformer.loss_packed`) reads the slabs of
:mod:`paddle_tpu_torch.data.packing`: segment ids gate every attention
through a full ``(B, 1, S, S)`` bias (:func:`~paddle_tpu_torch.ops.
sequence.make_segment_attention_bias`; within a segment only, and a
target segment against its own source segment in cross-attention), and
per-segment positions index the sinusoid table. On the card all three
attentions of a layer run the flash kernels (K5 forward, K6a/K6b
backward) with that bias.

Module attribute names mirror the reference's tree (``embed``,
``encoder.{i}``, ``decoder.{i}.self_attn.qkv_proj``,
``decoder.{i}.cross_attn.q_proj``/``kv_proj``, ``enc_ln``, ``dec_ln``),
so its weights carry across as a key flatten (:meth:`Transformer.
from_jax`). Dropout follows the module's training mode and draws from the
``generator`` passed down (the reference splits a key per layer).

Under a low-precision policy the sinusoid table is added in the
embedding's dtype (the reference adds it in float32, which promotes its
whole residual stream to float32; the port keeps the compute dtype so the
kernels run in it).

``pipeline=True`` runs the encoder and the decoder stack each through
:func:`paddle_tpu_torch.parallel.pipeline.gpipe_layer_stack` over the
ambient mesh's "pp" axis (``pp_schedule`` "gpipe" or "circular" with
``pp_circuits`` chunks a rank, ``pp_microbatches`` microbatches): the
encoder's key-padding bias rides with each microbatch as an extra, and
the decoder's extras are the encoder memory and its bias (every decoder
stage cross-attends them; the memory's gradient is summed over "pp").
The layer list stays the parameter layout, so a checkpoint carries
across unchanged (the stages take their rows of it at run time, as the
reference's do). As in the reference, the padded loss and forward are
pipelined, while greedy decoding, beam search and the packed path
(:meth:`Transformer.loss_packed`) run the stacks sequentially. On the
card each stage layer's attentions run K5 forward and K6a/K6b backward
(K5 again in the schedule's recompute).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.nn.layers import Dropout, Embedding, LayerNorm
from paddle_tpu_torch.nn.transformer import (TransformerDecoderLayer,
                                             TransformerEncoderLayer)
from paddle_tpu_torch.ops.attention import make_padding_bias
from paddle_tpu_torch.ops.sequence import make_segment_attention_bias


@dataclasses.dataclass
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    num_heads: int = 8
    ffn_size: int = 2048
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    max_len: int = 256
    dropout: float = 0.1
    attn_dropout: Optional[float] = None  # None = follow dropout
    label_smoothing: float = 0.1
    bos_id: int = 0
    eos_id: int = 1
    pad_id: int = 2
    pre_ln: bool = True
    attn_impl: str = "auto"
    # the encoder and decoder stacks each through a pipelined stage
    # sequence over "pp" (module docstring); the padded loss and forward
    # only: decoding and the packed path run the stacks sequentially
    pipeline: bool = False
    pp_microbatches: int = 2
    pp_schedule: str = "gpipe"    # or "circular" (interleaved)
    pp_circuits: int = 1

    @classmethod
    def big(cls, **kw):
        """Transformer-big (Vaswani et al. table 3)."""
        return cls(d_model=1024, num_heads=16, ffn_size=4096, **kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 64)
        kw.setdefault("d_model", 16)
        kw.setdefault("num_heads", 2)
        kw.setdefault("ffn_size", 32)
        kw.setdefault("num_encoder_layers", 2)
        kw.setdefault("num_decoder_layers", 2)
        kw.setdefault("max_len", 32)
        return cls(**kw)


def sinusoid_positions(max_len: int, dim: int, *, device=None):
    """(max_len, dim) float32: sines over the first half of the features,
    cosines over the second (the reference's layout)."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    # a Python base, not a tensor: nothing is copied from the host, so a
    # captured step may compute the table
    angle = pos / torch.pow(10000.0, 2 * i / dim)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


class Transformer(nn.Module):
    """Shared-vocab encoder-decoder with the tied output projection.

    Weights are initialised from ``seed`` through a ``torch.Generator``
    on ``device`` with the reference's schemes (normal(d_model^-0.5)
    embedding, xavier-uniform linears, unit/zero layer norms).
    ``device`` defaults to CUDA and raises without a card unless
    ``device="cpu"`` is given."""

    def __init__(self, cfg: TransformerConfig, *, device="cuda",
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_size, cfg.d_model,
                               init_std=cfg.d_model ** -0.5, **kw)
        self.drop = Dropout(cfg.dropout)
        layer = dict(dropout=cfg.dropout, attn_dropout=cfg.attn_dropout,
                     activation="relu", pre_ln=cfg.pre_ln,
                     attn_impl=cfg.attn_impl, **kw)
        self.encoder = nn.ModuleList([
            TransformerEncoderLayer(cfg.d_model, cfg.num_heads, cfg.ffn_size,
                                    **layer)
            for _ in range(cfg.num_encoder_layers)])
        self.decoder = nn.ModuleList([
            TransformerDecoderLayer(cfg.d_model, cfg.num_heads, cfg.ffn_size,
                                    **layer)
            for _ in range(cfg.num_decoder_layers)])
        # pre-LN stacks need a final LayerNorm
        self.enc_ln = LayerNorm(cfg.d_model, **kw)
        self.dec_ln = LayerNorm(cfg.d_model, **kw)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        for mod in self.modules():
            if hasattr(mod, "reset_parameters"):
                mod.reset_parameters(gen)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def _table(self, rows: int, like):
        return sinusoid_positions(rows, self.cfg.d_model,
                                  device=like.device).to(like.dtype)

    def _embed(self, ids, generator=None):
        x = self.embed(ids) * math.sqrt(self.cfg.d_model)
        x = x + self._table(ids.shape[1], x)
        return self.drop(x, generator)

    def _pipelined(self, stack, x, extras, generator, apply_layer):
        """``stack`` (a layer list) through the pipeline over "pp":
        ``extras`` ((B, ...) side inputs) microbatched with the batch,
        ``apply_layer(apply, layer_params, h, extra, generator)``; with
        dropout live, one seed drawn from ``generator`` for the step."""
        from paddle_tpu_torch.nn.module import pipeline_layers
        from paddle_tpu_torch.parallel import pipeline as pp_lib
        cfg = self.cfg
        if x.shape[0] % cfg.pp_microbatches:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"pp_microbatches={cfg.pp_microbatches}")
        extras, extras_spec = pp_lib.microbatch_extras(extras,
                                                       cfg.pp_microbatches)
        seed = None
        if self.training and (cfg.dropout > 0 or (
                cfg.attn_dropout or 0) > 0):
            seed = pp_lib.step_seed(generator, x.device)
        apply, params = pipeline_layers(stack)
        return pp_lib.gpipe_layer_stack(
            lambda lp, h, extra, gen: apply_layer(apply, lp, h, extra, gen),
            params, x, num_microbatches=cfg.pp_microbatches,
            num_layers=len(stack), seed=seed, extras=extras,
            extras_spec=extras_spec, schedule=cfg.pp_schedule,
            num_circuits=cfg.pp_circuits)

    def encode(self, src_ids, *, generator: Optional[torch.Generator] = None,
               pipelined: Optional[bool] = None):
        """Returns (memory (B, S, D), its key-padding bias (B, 1, 1, S)).
        ``pipelined`` (default: the config's ``pipeline``) runs the stack
        through the pipeline over "pp"."""
        cfg = self.cfg
        if pipelined is None:
            pipelined = cfg.pipeline
        bias = make_padding_bias(src_ids != cfg.pad_id)
        x = self._embed(src_ids, generator)
        if pipelined:
            x = self._pipelined(
                self.encoder, x, bias, generator,
                lambda apply, lp, h, extra, gen: apply(
                    lp, h, bias=extra, generator=gen))
        else:
            for layer in self.encoder:
                x = layer(x, bias=bias, generator=generator)
        if cfg.pre_ln:
            x = self.enc_ln(x)
        return x, bias

    def _logits(self, x):
        if self.cfg.pre_ln:
            x = self.dec_ln(x)
        return self.embed.attend(x)          # tied output projection

    def decode(self, tgt_ids, memory, memory_bias, *,
               generator: Optional[torch.Generator] = None,
               pipelined: Optional[bool] = None):
        """Teacher-forced decoder logits (B, S_tgt, V). ``pipelined`` as
        in :meth:`encode`: the memory and its bias ride with each
        microbatch."""
        if pipelined is None:
            pipelined = self.cfg.pipeline
        x = self._embed(tgt_ids, generator)
        if pipelined:
            x = self._pipelined(
                self.decoder, x, {"memory": memory, "bias": memory_bias},
                generator,
                lambda apply, lp, h, extra, gen: apply(
                    lp, h, extra["memory"], cross_bias=extra["bias"],
                    generator=gen))
        else:
            for layer in self.decoder:
                x = layer(x, memory, cross_bias=memory_bias,
                          generator=generator)
        return self._logits(x)

    def forward(self, src_ids, tgt_ids, *,
                generator: Optional[torch.Generator] = None):
        """Teacher-forced logits: (B, S_tgt, V)."""
        memory, memory_bias = self.encode(src_ids, generator=generator)
        return self.decode(tgt_ids, memory, memory_bias, generator=generator)

    def _nll(self, logits, tgt_out):
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, tgt_out[..., None].long())[..., 0]
        eps = self.cfg.label_smoothing
        if eps > 0:
            nll = (1 - eps) * nll + eps * (-logp.mean(dim=-1))
        return nll

    def loss(self, src_ids, tgt_in, tgt_out, *,
             generator: Optional[torch.Generator] = None):
        """tgt_in = [BOS, y...], tgt_out = [y..., EOS]; pad_id positions of
        tgt_out are masked from the loss. Label smoothing per cfg.
        Returns (loss, {"token_acc"})."""
        logits = self.forward(src_ids, tgt_in, generator=generator).float()
        nll = self._nll(logits, tgt_out)
        mask = (tgt_out != self.cfg.pad_id).float()
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = (nll * mask).sum() / denom
        tok_acc = ((logits.argmax(-1) == tgt_out) * mask).sum() / denom
        return loss, {"token_acc": tok_acc}

    # -- packed variable-length training (data/packing.py) ----------------

    def _embed_packed(self, ids, pos, generator=None):
        x = self.embed(ids) * math.sqrt(self.cfg.d_model)
        # per-segment positions are < the row length: size the table by
        # the packed row too (an index past it would raise)
        table = self._table(max(self.cfg.max_len, ids.shape[1]), x)
        x = x + table[pos.long()]
        return self.drop(x, generator)

    def encode_packed(self, src, src_seg, src_pos, *,
                      generator: Optional[torch.Generator] = None):
        """Encoder over packed rows: attention within segments only."""
        bias = make_segment_attention_bias(src_seg)
        x = self._embed_packed(src, src_pos, generator)
        for layer in self.encoder:
            x = layer(x, bias=bias, generator=generator)
        if self.cfg.pre_ln:
            x = self.enc_ln(x)
        return x

    def loss_packed(self, src, src_seg, src_pos, tgt_in, tgt_out, tgt_seg,
                    tgt_pos, *, generator: Optional[torch.Generator] = None):
        """Packed teacher-forced loss; the token sum and count are also
        returned so callers can aggregate exactly across batches:
        (loss, {"token_sum", "token_count"})."""
        memory = self.encode_packed(src, src_seg, src_pos,
                                    generator=generator)
        # decoder self: same segment (the layer's causal mask supplies
        # row-causality); cross: target segment against source segment,
        # padding (segment 0) queries see only padding keys
        self_bias = make_segment_attention_bias(tgt_seg)
        cross_bias = make_segment_attention_bias(tgt_seg, src_seg)
        x = self._embed_packed(tgt_in, tgt_pos, generator)
        for layer in self.decoder:
            x = layer(x, memory, self_bias=self_bias, cross_bias=cross_bias,
                      generator=generator)
        nll = self._nll(self._logits(x), tgt_out)
        mask = (tgt_seg > 0).float()
        tok_sum = (nll * mask).sum()
        tok_count = mask.sum()
        loss = tok_sum / torch.clamp(tok_count, min=1.0)
        return loss, {"token_sum": tok_sum, "token_count": tok_count}

    # -- cached incremental decoding ------------------------------------------

    def _decode_state(self, memory, max_len: int, beam_expand: int = 1):
        """Per-layer state for cached decoding: empty self-attention KV
        buffers and the cross-attention heads, made once from the
        unexpanded ``memory`` and repeated ``beam_expand`` times."""
        cfg = self.cfg
        dh = cfg.d_model // cfg.num_heads
        batch = memory.shape[0] * beam_expand
        caches, cross = [], []
        for layer in self.decoder:
            caches.append(tuple(memory.new_zeros(
                (batch, cfg.num_heads, max_len, dh)) for _ in range(2)))
            k, v = layer.cross_attn.cross_kv(memory)
            if beam_expand > 1:
                k = torch.repeat_interleave(k, beam_expand, dim=0)
                v = torch.repeat_interleave(v, beam_expand, dim=0)
            cross.append((k, v))
        return caches, cross

    def _cached_step(self, tok, t: int, caches, cross, memory_bias,
                     table_len: int):
        """tok (B,) at position ``t`` -> (logits (B, V), caches)."""
        x = self.embed(tok[:, None]) * math.sqrt(self.cfg.d_model)
        table = self._table(max(self.cfg.max_len, table_len), x)
        x = x + table[t][None, None]
        pos = torch.tensor(t, device=x.device)
        new_caches = []
        for layer, cache, kv in zip(self.decoder, caches, cross):
            x, cache = layer.decode_step(x, pos, cache, kv,
                                         cross_bias=memory_bias)
            new_caches.append(cache)
        return self._logits(x)[:, 0], new_caches

    @torch.no_grad()
    def greedy_decode(self, src_ids, max_len: Optional[int] = None,
                      use_cache: bool = True):
        """Greedy generation (the reference's beam search with beam 1):
        (B, max_len) token ids starting with BOS, PAD after EOS.
        ``use_cache=True`` decodes through per-layer self-attention KV
        caches and the memory's cross-attention heads made once; the
        uncached path refeeds the whole prefix each step. Stops early
        when every row has emitted EOS (one host read per step)."""
        cfg = self.cfg
        max_len = max_len or cfg.max_len
        b = src_ids.shape[0]
        # inference: always the sequential stacks (the pipelined path
        # needs a pp mesh and a batch the microbatches divide)
        memory, memory_bias = self.encode(src_ids, pipelined=False)
        tgt = torch.full((b, max_len), cfg.pad_id, dtype=torch.int32,
                         device=src_ids.device)
        tgt[:, 0] = cfg.bos_id
        done = torch.zeros((b,), dtype=torch.bool, device=src_ids.device)
        if use_cache:
            caches, cross = self._decode_state(memory, max_len)
        for t in range(max_len - 1):
            if bool(done.all()):
                break
            if use_cache:
                logits, caches = self._cached_step(
                    tgt[:, t], t, caches, cross, memory_bias, max_len)
            else:
                logits = self.decode(tgt, memory, memory_bias,
                                     pipelined=False)[:, t]
            nxt = logits.argmax(-1).to(torch.int32)
            nxt = torch.where(done, torch.full_like(nxt, cfg.pad_id), nxt)
            tgt[:, t + 1] = nxt
            done = done | (nxt == cfg.eos_id)
        return tgt

    @torch.no_grad()
    def beam_search_decode(self, src_ids, *, beam_size: int = 4,
                           max_len: Optional[int] = None,
                           length_penalty: float = 0.6,
                           use_cache: bool = True):
        """Beam search (fluid ``beam_search_op`` and ``layers.beam_search``'s
        translation path) over :mod:`paddle_tpu_torch.ops.beam_search`'s
        dense (B, K) lattice, every one of the ``max_len - 1`` steps run as
        the reference runs them. GNMT length normalization
        ((5 + len) / 6)^alpha over each beam's non-pad tokens. Returns
        ``(best_ids (B, max_len) int32, best_scores (B,))``.

        ``use_cache=True`` decodes through beam-expanded self-attention KV
        caches, reordered with their beams at every step, and the
        cross-attention heads made once from the unexpanded memory; the
        uncached path refeeds every prefix each step. The encoder runs
        once (on the card: K5 once per encoder layer)."""
        from paddle_tpu_torch.ops import beam_search as bs
        cfg = self.cfg
        max_len = max_len or cfg.max_len
        b, k, v = src_ids.shape[0], beam_size, cfg.vocab_size
        dev = src_ids.device
        memory, memory_bias = self.encode(src_ids, pipelined=False)
        mem_bias = torch.repeat_interleave(memory_bias, k, dim=0)
        tgt = torch.full((b, k, max_len), cfg.pad_id, dtype=torch.int32,
                         device=dev)
        tgt[:, :, 0] = cfg.bos_id
        scores, done = bs.beam_init(b, k, device=dev)

        def select(logits_t, t, tgt, scores, done):
            """Beam bookkeeping for logits_t (B*K, V) at step t."""
            logp = torch.log_softmax(logits_t.float(), dim=-1)
            tok, scores, done, src_beam = bs.beam_search_step(
                logp.reshape(b, k, v), scores, done, eos_id=cfg.eos_id,
                pad_id=cfg.pad_id)
            tgt = torch.gather(tgt, 1, src_beam[..., None].expand(
                b, k, max_len))
            tgt[:, :, t + 1] = tok
            return tgt, scores, done, src_beam

        if use_cache:
            caches, cross = self._decode_state(memory, max_len,
                                               beam_expand=k)
            for t in range(max_len - 1):
                logits, caches = self._cached_step(
                    tgt.reshape(b * k, max_len)[:, t], t, caches, cross,
                    mem_bias, max_len)
                tgt, scores, done, src_beam = select(logits, t, tgt, scores,
                                                     done)
                # the KV caches ride with their beams (flat B*K rows)
                caches = bs.gather_beams(caches, src_beam)
        else:
            mem = torch.repeat_interleave(memory, k, dim=0)
            for t in range(max_len - 1):
                logits = self.decode(tgt.reshape(b * k, max_len), mem,
                                     mem_bias, pipelined=False)[:, t]
                tgt, scores, done, _ = select(logits, t, tgt, scores, done)
        # length-normalized final ranking
        lengths = (tgt != cfg.pad_id).sum(-1).float()
        norm = scores / ((5.0 + lengths) / 6.0) ** length_penalty
        best = torch.argmax(norm, dim=1)
        rows = torch.arange(b, device=dev)
        return tgt[rows, best], norm[rows, best]

    @classmethod
    def from_jax(cls, cfg: TransformerConfig, params, *,
                 device="cuda") -> "Transformer":
        """Build the port model from a reference parameter tree given as
        nested dicts of numpy arrays (``jax.device_get(params)``)."""
        from paddle_tpu_torch.models.convert import state_from_jax
        state = state_from_jax(params)
        model = cls(cfg, device=device, dtype=state["embed.weight"].dtype)
        model.load_state_dict(state)
        return model
