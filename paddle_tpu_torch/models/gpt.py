"""Decoder-only causal LM (``paddle_tpu/models/gpt.py``): pre-LN blocks,
learned positions, head tied to ``wte``. Module attribute names mirror
the reference's parameter tree, so its weights carry across with a key
flatten and no transposes (:mod:`paddle_tpu_torch.models.convert`).

Decoding: :meth:`GPT.generate` samples autoregressively, by full refeed
or through per-layer KV caches (``use_cache=True``: :meth:`GPT.prefill`
seeds static ``(B, H, Smax, Dh)`` buffers, :meth:`GPT.decode_step`
writes one token's k/v in place and attends over the whole cache through
the composed path). :meth:`GPT.generate_bucketed` pads prompt and horizon
to pow2 buckets; each bucket's decode step is one captured CUDA graph on
the card, the counterpart of the reference's one compiled program per
bucket.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.core.device import graph_capture, resolve_device
from paddle_tpu_torch.observability import recompile
from paddle_tpu_torch.nn.layers import Dropout, Embedding, LayerNorm
from paddle_tpu_torch.nn.transformer import FeedForward, MultiHeadAttention


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_size: int = 3072
    max_position: int = 1024
    dropout: float = 0.0
    attn_impl: str = "auto"

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 128)
        kw.setdefault("hidden_size", 32)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 2)
        kw.setdefault("ffn_size", 64)
        kw.setdefault("max_position", 64)
        return cls(**kw)


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = LayerNorm(cfg.hidden_size, **kw)
        self.attn = MultiHeadAttention(cfg.hidden_size, cfg.num_heads,
                                       dropout=cfg.dropout, causal=True,
                                       attn_impl=cfg.attn_impl, **kw)
        self.ln2 = LayerNorm(cfg.hidden_size, **kw)
        self.mlp = FeedForward(cfg.hidden_size, cfg.ffn_size,
                               activation="gelu", dropout=cfg.dropout, **kw)

    def forward(self, x, generator: Optional[torch.Generator] = None, *,
                cache=None, cache_pos=None, return_kv: bool = False):
        """``cache``/``cache_pos`` (one decode step) and ``return_kv``
        (the prefill) return ``(x, (k, v))``, as
        :meth:`MultiHeadAttention.forward` does."""
        if cache is not None or return_kv:
            a, kv = self.attn(self.ln1(x), generator=generator, cache=cache,
                              cache_pos=cache_pos, return_kv=return_kv)
            x = x + a
            return x + self.mlp(self.ln2(x), generator), kv
        x = x + self.attn(self.ln1(x), generator=generator)
        return x + self.mlp(self.ln2(x), generator)


class GPT(nn.Module):
    """Causal LM; ``forward(ids)`` returns logits ``(B, S, V)``.

    Weights are initialised from ``seed`` through a ``torch.Generator``
    on ``device`` with the reference's schemes (xavier-uniform linears,
    normal(0.02) ``wte``, normal(0.01) ``wpe``). ``device`` defaults to
    CUDA and raises without a card unless ``device="cpu"`` is given."""

    def __init__(self, cfg: GPTConfig, *, device="cuda",
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        self.cfg = cfg
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size, init_std=0.02,
                             **kw)
        self.wpe = Embedding(cfg.max_position, cfg.hidden_size, init_std=0.01,
                             **kw)
        self.drop = Dropout(cfg.dropout)
        self.blocks = nn.ModuleList([GPTBlock(cfg, **kw)
                                     for _ in range(cfg.num_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, **kw)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        for mod in self.modules():
            if hasattr(mod, "reset_parameters"):
                mod.reset_parameters(gen)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    def forward(self, ids, *, generator: Optional[torch.Generator] = None):
        pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
        x = self.drop(self.wte(ids) + self.wpe(pos), generator)
        for block in self.blocks:
            x = block(x, generator)
        x = self.ln_f(x)
        return torch.einsum("bsd,vd->bsv", x, self.wte.weight)

    def loss(self, ids, *, generator: Optional[torch.Generator] = None):
        """Next-token LM loss over ids (B, S): predict ``ids[:, 1:]``.
        Returns ``(loss, {"ppl": exp(loss)})``; dropout follows the
        module's training mode (``GPT`` starts in ``eval()``)."""
        logits = self.forward(ids[:, :-1], generator=generator)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, ids[:, 1:, None].long())[..., 0]
        loss = nll.mean()
        return loss, {"ppl": torch.exp(loss)}

    # -- incremental decoding (KV cache) ----------------------------------

    def init_cache(self, batch_size: int, max_len: int,
                   dtype: Optional[torch.dtype] = None):
        """Per-layer (k, v) zero buffers (B, H, max_len, Dh) on the
        model's device, of ``dtype`` (default: the weights' dtype)."""
        cfg = self.cfg
        shape = (batch_size, cfg.num_heads, max_len,
                 cfg.hidden_size // cfg.num_heads)
        kw = dict(dtype=dtype or self.wte.weight.dtype, device=self.device)
        return [(torch.zeros(shape, **kw), torch.zeros(shape, **kw))
                for _ in range(cfg.num_layers)]

    @torch.no_grad()
    def prefill(self, ids, cache):
        """Attention over the prompt ``ids`` (B, S0) that seeds the caches
        (positions ``[0, S0)``, written in place). Returns (logits
        (B, S0, V), cache)."""
        s0 = ids.shape[1]
        pos = torch.arange(s0, device=ids.device)[None, :]
        x = self.wte(ids) + self.wpe(pos)
        for block, (ck, cv) in zip(self.blocks, cache):
            x, (k, v) = block(x, return_kv=True)
            ck[:, :, :s0].copy_(k)
            cv[:, :, :s0].copy_(v)
        x = self.ln_f(x)
        return torch.einsum("bsd,vd->bsv", x, self.wte.weight), cache

    @torch.no_grad()
    def decode_step(self, token_ids, pos, cache):
        """One cached decode step: ``token_ids`` (B,) at position ``pos``
        (a 0-dim integer tensor on the model's device) -> (logits (B, V),
        cache). The position embedding clamps to ``max_position - 1``
        (as the reference's gather does); the write lands at ``pos``."""
        wpos = pos.clamp(max=self.cfg.max_position - 1).reshape(1, 1)
        x = self.wte(token_ids[:, None]) + self.wpe(wpos)
        for block, kv in zip(self.blocks, cache):
            x, _ = block(x, cache=kv, cache_pos=pos)
        x = self.ln_f(x)
        return x[:, 0] @ self.wte.weight.T, cache

    @torch.no_grad()
    def generate(self, prompt_ids, max_new_tokens: int = 32,
                 temperature: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 use_cache: bool = False,
                 cache_dtype: Optional[torch.dtype] = None):
        """Autoregressive sampling; greedy when ``generator`` is None,
        else Gumbel-max sampling of ``logits / temperature`` with one
        uniform draw of (B, V) from ``generator`` per new token, so the
        cached and the uncached path consume the generator identically.
        ``prompt_ids`` (B, S0) with S0 + max_new_tokens <= max_position;
        returns ids (B, S0 + max_new_tokens), int32 on the model's device.

        ``use_cache=True`` decodes through per-layer KV caches of
        ``cache_dtype`` (default: the weights' dtype): the same tokens,
        O(S) work per token instead of the full refeed's O(S^2)."""
        dev = self.device
        prompt = torch.as_tensor(prompt_ids, device=dev).to(torch.int32)
        b, s0 = prompt.shape
        total = s0 + max_new_tokens
        ids = torch.zeros((b, total), dtype=torch.int32, device=dev)
        ids[:, :s0] = prompt

        def sample(logits):
            logits = logits.float()
            if generator is None:
                return logits.argmax(-1).to(torch.int32)
            u = torch.rand(logits.shape, generator=generator, device=dev)
            gumbel = -torch.log(-torch.log(u))
            return (logits / temperature + gumbel).argmax(-1).to(torch.int32)

        if use_cache:
            cache = self.init_cache(b, total, dtype=cache_dtype)
            logits, cache = self.prefill(prompt, cache)
            ids[:, s0] = sample(logits[:, s0 - 1])
            pos = torch.tensor(s0, device=dev)     # advanced on the device
            for t in range(s0 + 1, total):
                logits, cache = self.decode_step(ids[:, t - 1], pos, cache)
                ids[:, t] = sample(logits)
                pos.add_(1)
            return ids
        for t in range(s0, total):
            ids[:, t] = sample(self.forward(ids)[:, t - 1])
        return ids

    # -- bucketed decoding (build cap) ------------------------------------

    def generate_bucketed(self, prompt_ids, max_new_tokens: int = 32, *,
                          min_bucket: int = 8):
        """Greedy :meth:`generate` with power-of-two shape buckets: the
        prompt is right-padded to the next pow2 length (at least
        ``min_bucket``, at most ``max_position``) and the horizon rounded
        up the same way, so every request whose (batch, prompt, horizon)
        lands in one bucket reuses one build: on the card one captured
        CUDA graph of the bucket's decode step, replayed per token, with
        the real prompt length a device scalar (pad K/V is masked, then
        overwritten). Each build counts as one capture
        (:func:`~paddle_tpu_torch.observability.recompile.note_capture`);
        on the CPU the bucket runs eagerly and its first use counts the
        same way. Tokens equal ``generate(use_cache=True)``. Returns
        (B, S0 + max_new_tokens) int32 ids on the model's device."""
        cfg = self.cfg
        prompt_host = np.asarray(torch.as_tensor(prompt_ids).cpu(),
                                 np.int32)
        b, s0 = prompt_host.shape

        def pow2(n):
            return 1 << max(int(n) - 1, 0).bit_length()

        s0b = min(max(pow2(s0), min_bucket), cfg.max_position)
        nb = max(pow2(max_new_tokens), min_bucket)
        if s0 + max_new_tokens > cfg.max_position:
            raise ValueError("prompt + max_new_tokens exceeds max_position")
        s0b = max(s0b, s0)  # max_position clamp must never truncate
        padded = np.zeros((b, s0b), np.int32)
        padded[:, :s0] = prompt_host
        buckets = self.__dict__.setdefault("_decode_buckets", {})
        bucket = buckets.get((b, s0b, nb))
        if bucket is None:
            bucket = buckets[(b, s0b, nb)] = _DecodeBucket(self, b, s0b, nb)
        gen = bucket.run(padded, s0)
        out = np.concatenate([prompt_host, gen[:, :max_new_tokens]], axis=1)
        return torch.from_numpy(out).to(self.device)

    @classmethod
    def from_jax(cls, cfg: GPTConfig, params, *, device="cuda") -> "GPT":
        """Build the port model from a reference parameter tree given as
        nested dicts of numpy arrays (``jax.device_get(params)``)."""
        from paddle_tpu_torch.models.convert import state_from_jax
        state = state_from_jax(params)
        model = cls(cfg, device=device, dtype=state["wte.weight"].dtype)
        model.load_state_dict(state)
        return model


class _DecodeBucket:
    """One ``generate_bucketed`` bucket: static caches for ``s0b + nb``
    positions, the last token, the write position and the generated
    tokens, all on the model's device, and the greedy decode step over
    them (which advances the position and the output column on the
    device). On the card the step is captured once as a CUDA graph and
    replayed ``nb - 1`` times per call: no host work between tokens."""

    def __init__(self, model: GPT, b: int, s0b: int, nb: int):
        dev = model.device
        self.model, self.nb = model, nb
        self.cache = model.init_cache(b, s0b + nb)
        self.tok = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((), dtype=torch.long, device=dev)
        self.col = torch.zeros((1,), dtype=torch.long, device=dev)
        self.gen = torch.zeros((b, nb), dtype=torch.int32, device=dev)
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        recompile.note_capture()
        if dev.type == "cuda":
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._step()                 # warm-up before the capture
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with graph_capture(graph):
                self._step()
            self.graph = graph
        else:
            self._step()

    @torch.no_grad()
    def _step(self):
        logits, _ = self.model.decode_step(self.tok, self.pos, self.cache)
        nxt = logits.argmax(-1).to(torch.int32)
        self.gen.index_copy_(1, self.col, nxt[:, None])
        self.tok.copy_(nxt)
        self.pos.add_(1)
        self.col.add_(1)

    @torch.no_grad()
    def run(self, padded: np.ndarray, prompt_len: int) -> np.ndarray:
        """Greedy tokens (B, nb) after the right-padded prompt ``padded``
        (B, s0b) whose real length is ``prompt_len``: the prefill seeds
        the caches causally over the padded buffer, the first token comes
        from position ``prompt_len - 1``, and each decode step overwrites
        the pad in cache order (each step masks keys past its position)."""
        dev = self.model.device
        pl = torch.tensor(prompt_len, device=dev)
        logits, _ = self.model.prefill(torch.from_numpy(padded).to(dev),
                                       self.cache)
        first = logits.index_select(1, (pl - 1).reshape(1))[:, 0]
        self.gen[:, 0] = first.argmax(-1).to(torch.int32)
        self.tok.copy_(self.gen[:, 0])
        self.pos.copy_(pl)
        self.col.fill_(1)
        for _ in range(self.nb - 1):
            if self.graph is not None:
                self.graph.replay()
            else:
                self._step()
        return self.gen.cpu().numpy()
