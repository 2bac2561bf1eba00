"""Activations used by the ported models."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation: the reference's ``jax.nn.gelu`` default
    (``approximate=True``), not PyTorch's erf default."""
    return F.gelu(x, approximate="tanh")


def relu(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)`` (the reference's ``jax.nn.relu``)."""
    return F.relu(x)
