"""Weight-decay regularizers (``paddle_tpu/optimizer/regularizer.py``):
gradient transforms ``(grads, params) -> grads`` over lists of tensors."""

from __future__ import annotations

import torch


class L2Decay:
    def __init__(self, coeff):
        self.coeff = coeff

    def __call__(self, grads, params):
        return [g + self.coeff * p for g, p in zip(grads, params)]


class L1Decay:
    def __init__(self, coeff):
        self.coeff = coeff

    def __call__(self, grads, params):
        return [g + self.coeff * torch.sign(p) for g, p in zip(grads, params)]
