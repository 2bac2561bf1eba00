"""Gradient clipping (``paddle_tpu/optimizer/clip.py``), over a list of
gradient tensors; each returns new tensors and leaves its input alone."""

from __future__ import annotations

from typing import List

import torch


class GradClipBase:
    def __call__(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        raise NotImplementedError


class GradientClipByValue(GradClipBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, grads):
        return [torch.clamp(g, self.min, self.max) for g in grads]


class GradientClipByNorm(GradClipBase):
    """Per-tensor L2 clip."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, grads):
        out = []
        for g in grads:
            norm = torch.sqrt(torch.sum(torch.square(g)))
            out.append(g * torch.clamp(
                self.clip_norm / torch.clamp(norm, min=1e-12), max=1.0))
        return out


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


class GradientClipByGlobalNorm(GradClipBase):
    """Global-norm clip over all gradients (the BERT/Transformer
    standard)."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, grads):
        scale = torch.clamp(
            self.clip_norm / torch.clamp(global_norm(grads), min=1e-12),
            max=1.0)
        return [(g * scale).to(g.dtype) for g in grads]
