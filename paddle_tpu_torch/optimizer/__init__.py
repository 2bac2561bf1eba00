"""Optimizers (``paddle_tpu/optimizer/__init__.py``, subset): SGD,
Momentum, Adam and AdamW as ``torch.optim.Optimizer`` subclasses that
apply exactly the reference's update rules to each parameter's ``.grad``.

As in the reference, one ``step()``: applies the regularizer (a gradient
transform), then the gradient clip, then increments the step count and
only then reads the learning rate (``step -> lr`` schedule, or a float)
for the new step, and updates every parameter that has a gradient;
parameters whose ``.grad`` is None (frozen ones) pass through untouched,
and AdamW never decays them. Slot buffers (``velocity``, ``m``, ``v``)
live in ``self.state[p]``, created as zeros of the parameter's shape and
dtype; updates happen in place.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from paddle_tpu_torch.optimizer import lr_scheduler
from paddle_tpu_torch.optimizer.clip import (GradClipBase,
                                             GradientClipByGlobalNorm,
                                             GradientClipByNorm,
                                             GradientClipByValue, global_norm)
from paddle_tpu_torch.optimizer.regularizer import L1Decay, L2Decay

__all__ = ["Adam", "AdamW", "GradClipBase", "GradientClipByGlobalNorm",
           "GradientClipByNorm", "GradientClipByValue", "L1Decay", "L2Decay",
           "Momentum", "Optimizer", "SGD", "global_norm", "lr_scheduler"]


def _f32(x) -> float:
    """Round a Python number to float32, as the reference's f32 scalars."""
    return float(np.float32(x))


class Optimizer(torch.optim.Optimizer):
    """Base optimizer. ``learning_rate`` is a float or a ``step -> lr``
    schedule; ``regularization`` an L1/L2 decay applied to the gradients
    before the rule; ``grad_clip`` a :class:`GradClipBase`."""

    SLOTS = ()

    def __init__(self, params, learning_rate=0.001, regularization=None,
                 grad_clip: Optional[GradClipBase] = None):
        super().__init__(params, {})
        self._lr = (learning_rate if callable(learning_rate)
                    else lr_scheduler.constant(learning_rate))
        self.regularization = regularization
        self.grad_clip = grad_clip
        #: the reference's state["step"]: steps applied so far
        self.num_steps = 0

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = [p for group in self.param_groups for p in group["params"]
                  if p.grad is not None]
        grads = [p.grad for p in params]
        if self.regularization is not None:
            grads = self.regularization(grads, params)
        if self.grad_clip is not None:
            grads = self.grad_clip(grads)
        self.num_steps += 1
        self._update(params, grads, _f32(self._lr(self.num_steps)),
                     self.num_steps)
        return loss

    def _update(self, params, grads, lr, step):
        for p, g in zip(params, grads):
            state = self.state[p]
            if not state:
                for s in self.SLOTS:
                    state[s] = torch.zeros_like(p)
            self._apply(p, g, state, lr, step)

    def _apply(self, p, g, slots, lr, step):
        raise NotImplementedError


class SGD(Optimizer):
    def _apply(self, p, g, slots, lr, step):
        p.sub_(lr * g.to(p.dtype))


class Momentum(Optimizer):
    SLOTS = ("velocity",)

    def __init__(self, params, learning_rate, momentum=0.9,
                 use_nesterov=False, **kw):
        super().__init__(params, learning_rate, **kw)
        self.mu = momentum
        self.nesterov = use_nesterov

    def _apply(self, p, g, slots, lr, step):
        v = slots["velocity"]
        v.mul_(self.mu).add_(g)
        upd = g + self.mu * v if self.nesterov else v
        p.sub_(lr * upd.to(p.dtype))


class Adam(Optimizer):
    SLOTS = ("m", "v")

    def __init__(self, params, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(params, learning_rate, **kw)
        self.b1, self.b2, self.eps = beta1, beta2, epsilon

    def _apply(self, p, g, slots, lr, step):
        g32 = g.float()
        m, v = slots["m"], slots["v"]
        m.copy_(self.b1 * m + (1 - self.b1) * g32)
        v.copy_(self.b2 * v + (1 - self.b2) * torch.square(g32))
        t = np.float32(step)
        mhat = m / float(np.float32(1) - np.float32(self.b1) ** t)
        vhat = v / float(np.float32(1) - np.float32(self.b2) ** t)
        upd = lr * mhat / (torch.sqrt(vhat) + self.eps)
        p.sub_(upd.to(p.dtype))


class AdamW(Adam):
    """Adam with decoupled weight decay (the BERT recipe optimizer): after
    the Adam step, ``p -= lr * weight_decay * p_before``, with the new
    step's learning rate. ``decay_mask_fn(p) -> bool`` selects which
    parameters decay (default: all; recipes often pass
    ``lambda p: p.ndim > 1`` to spare biases and norm scales)."""

    def __init__(self, params, learning_rate=0.001, weight_decay=0.01,
                 decay_mask_fn: Optional[Callable] = None, **kw):
        super().__init__(params, learning_rate, **kw)
        self.wd = weight_decay
        self.decay_mask_fn = decay_mask_fn

    def _update(self, params, grads, lr, step):
        decays = []
        if self.wd:
            coeff = _f32(np.float32(lr) * np.float32(self.wd))
            decays = [(p, coeff * p) for p in params
                      if self.decay_mask_fn is None or self.decay_mask_fn(p)]
        super()._update(params, grads, lr, step)
        for p, d in decays:
            p.sub_(d)
