"""Decoder-only causal LM (``paddle_tpu/models/gpt.py``): pre-LN blocks,
learned positions, head tied to ``wte``. Module attribute names mirror
the reference's parameter tree, so its weights carry across with a key
flatten and no transposes (:mod:`paddle_tpu_torch.models.convert`)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch.core.device import resolve_device
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

    def forward(self, x, generator: Optional[torch.Generator] = None):
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

    @classmethod
    def from_jax(cls, cfg: GPTConfig, params, *, device="cuda") -> "GPT":
        """Build the port model from a reference parameter tree given as
        nested dicts of numpy arrays (``jax.device_get(params)``)."""
        from paddle_tpu_torch.models.convert import state_from_jax
        state = state_from_jax(params)
        model = cls(cfg, device=device, dtype=state["wte.weight"].dtype)
        model.load_state_dict(state)
        return model
