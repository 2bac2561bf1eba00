"""Gradient clipping (``paddle_tpu/optimizer/clip.py``), over a list of
gradient tensors; each returns new tensors and leaves its input alone.

A sharded step (``parallel/api.py``) holds some gradients as blocks of
the whole tensor. It passes ``reduce_sq``: a function that takes a 1-D
float32 tensor of squared sums, one for each gradient, and returns each
one summed over the ranks that hold the other blocks of its gradient.
The norms are then those of the whole tensors, as in the reference's
GSPMD step. Without it, each gradient is taken as a whole tensor."""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

ReduceSq = Optional[Callable[[torch.Tensor], torch.Tensor]]


class GradClipBase:
    def __call__(self, grads: List[torch.Tensor],
                 reduce_sq: ReduceSq = None) -> List[torch.Tensor]:
        raise NotImplementedError


class GradientClipByValue(GradClipBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, grads, reduce_sq=None):
        return [torch.clamp(g, self.min, self.max) for g in grads]


class GradientClipByNorm(GradClipBase):
    """Per-tensor L2 clip."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, grads, reduce_sq=None):
        sq = [torch.sum(torch.square(g)) for g in grads]
        if reduce_sq is not None and sq:
            whole = reduce_sq(torch.stack([s.float() for s in sq]))
            sq = [whole[i].to(s.dtype) for i, s in enumerate(sq)]
        out = []
        for g, s in zip(grads, sq):
            norm = torch.sqrt(s)
            out.append(g * torch.clamp(
                self.clip_norm / torch.clamp(norm, min=1e-12), max=1.0))
        return out


def global_norm(grads, reduce_sq: ReduceSq = None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    if reduce_sq is None or not grads:
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in grads))
    return torch.sqrt(torch.sum(reduce_sq(torch.stack(
        [torch.sum(torch.square(g.float())) for g in grads]))))


class GradientClipByGlobalNorm(GradClipBase):
    """Global-norm clip over all gradients (the BERT/Transformer
    standard)."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, grads, reduce_sq=None):
        scale = torch.clamp(
            self.clip_norm / torch.clamp(global_norm(grads, reduce_sq),
                                         min=1e-12),
            max=1.0)
        return [(g * scale).to(g.dtype) for g in grads]
