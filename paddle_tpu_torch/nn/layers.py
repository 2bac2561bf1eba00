"""Standard layers, with the reference's parameter names and layouts so
that weights carry across from ``paddle_tpu`` as a plain key flatten
(``paddle_tpu/nn/layers.py``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from paddle_tpu_torch.nn import initializer as I


class Linear(nn.Module):
    """``y = x @ W + b`` with ``W`` stored ``(in, out)``, as the
    reference stores it (not ``nn.Linear``'s ``(out, in)``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, device=None, dtype=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                               device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.empty(out_features, device=device,
                                              dtype=dtype))
                     if bias else None)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Xavier-uniform weight, zero bias (the reference's defaults)."""
        I.xavier_uniform()(self.weight, generator)
        if self.bias is not None:
            I.zeros(self.bias)

    def forward(self, x):
        out = torch.matmul(x, self.weight)
        if self.bias is not None:
            out = out + self.bias
        return out


class LayerNorm(nn.Module):
    """Layer norm over the last axis: biased variance, ``eps`` inside the
    rsqrt, parameters named ``scale``/``bias`` (``ops/nn.py:186``)."""

    def __init__(self, normalized_shape: int, epsilon: float = 1e-5, *,
                 device=None, dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.empty(normalized_shape, device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.empty(normalized_shape, device=device,
                                             dtype=dtype))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        I.ones(self.scale)
        I.zeros(self.bias)

    def forward(self, x):
        return F.layer_norm(x, self.scale.shape, self.scale, self.bias,
                            self.epsilon)


class Embedding(nn.Module):
    """Token/position lookup table ``(num_embeddings, embedding_dim)``."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 init_std: float = 0.02, device=None, dtype=None):
        super().__init__()
        self.init_std = init_std
        self.weight = nn.Parameter(torch.empty(num_embeddings, embedding_dim,
                                               device=device, dtype=dtype))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        I.normal(0.0, self.init_std)(self.weight, generator)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


def dropout(x, rate: float = 0.5, *, training: bool = True,
            generator: Optional[torch.Generator] = None):
    """Upscale-in-train dropout (``ops/nn.py:229``): keep each element
    with probability ``1 - rate`` and divide it by that, zero the rest.
    The identity when not ``training`` or at rate 0. Draws come from
    ``generator`` (the default generator of ``x``'s device when None)."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class Dropout(nn.Module):
    """:func:`dropout` in the module's training mode: the identity in
    ``eval()`` or at rate 0."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return dropout(x, self.rate, training=self.training,
                       generator=generator)
