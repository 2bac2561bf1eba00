"""Losses of the ported models (``paddle_tpu/ops/nn.py``, the subset the
port's models use so far)."""

from __future__ import annotations

import torch


def sigmoid_cross_entropy_with_logits(x: torch.Tensor,
                                      label: torch.Tensor) -> torch.Tensor:
    """``max(x, 0) - x * z + log(1 + exp(-|x|))`` elementwise (fluid's op
    of the same name), written as the reference writes it."""
    return torch.clamp(x, min=0) - x * label + torch.log1p(
        torch.exp(-torch.abs(x)))
