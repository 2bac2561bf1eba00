"""Shared model-zoo pieces (``paddle_tpu/models/common.py``): the
classification loss head, and :class:`ZooModel`, the seeded build,
device placement and ``from_jax`` every zoo model shares.

The zoo keeps the reference's interfaces with PyTorch's idiom for the
mode: a model's ``forward``/``loss``/``detect`` run in the module's mode
(``train()``, PyTorch's default, or ``eval()``) where the reference
takes ``training=``; BatchNorm then normalises by the batch and moves
its running statistics (through the train step's state tape,
``nn.module.capture_state``), or uses them. Dropout draws from an
explicit ``torch.Generator`` where the reference takes a key, and is off
without one, as the reference's is without a key. Images are NHWC.
"""

from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.ops import nn as ops_nn


def classification_loss(logits, label):
    """Softmax cross-entropy and top-1 accuracy, the standard image-
    classification head (``softmax_with_cross_entropy`` + ``accuracy``):
    ``(loss, {"acc": acc})``."""
    loss = ops_nn.softmax_with_cross_entropy(logits, label[:, None]).mean()
    acc = (logits.argmax(-1) == label).float().mean()
    return loss, {"acc": acc}


class eval_mode:
    """Run a block with ``module`` in eval mode, then restore its mode
    (the reference's detect calls its forward with ``training=False``)."""

    def __init__(self, module: nn.Module):
        self.module = module

    def __enter__(self):
        self.was = self.module.training
        self.module.eval()
        return self.module

    def __exit__(self, *exc):
        self.module.train(self.was)


class ZooModel(nn.Module):
    """A zoo model built on the CPU, initialised from one CPU
    ``torch.Generator`` of ``seed`` (each module's ``reset_parameters`` in
    module order: the reference's schemes, not JAX's bits) and moved to
    ``device``, so the same seed gives the same weights on the CPU and
    the card."""

    def _finish(self, device, seed: int):
        gen = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if hasattr(mod, "reset_parameters"):
                mod.reset_parameters(gen)
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @classmethod
    def from_jax(cls, params, *args, device="cuda", **kwargs):
        """The model of a reference parameter tree (numpy arrays, the
        running statistics with it): built with the reference
        constructor's ``args``/``kwargs`` on ``device``, then loaded
        (``models.convert.load_jax``, HWIO conv weights to OIHW)."""
        from paddle_tpu_torch.models.convert import load_jax
        return load_jax(cls(*args, device=device, **kwargs), params)
