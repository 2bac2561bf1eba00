"""Automatic mixed precision: dynamic loss scaling (``paddle_tpu/amp.py``).

bf16 keeps float32's exponent range and needs no loss scaling, so the
default policy is just ``dtypes.get_policy("bf16")`` applied by
:func:`~paddle_tpu_torch.train.build_train_step`. This module adds the
fp16-style pieces with the reference's semantics:
:class:`DynamicLossScale` (scale, unscale, finite check, grow after
``growth_interval`` clean steps, back off on overflow, clip to
``[min_scale, max_scale]``) and :func:`scaled_train_step`, whose step is
skipped on overflow.

Everything stays on the device: the scale, the growth counter and the
finite flag are 0-d tensors, and a skipped step is undone with
``torch.where`` over the parameters and every optimizer slot, so the
step reads no host value and is captured in a CUDA graph like any other
(:class:`~paddle_tpu_torch.train.TrainStepGraphs`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.nn.module import capture_state
from paddle_tpu_torch.train import (TrainStepGraphs, _policy_call,
                                    make_train_state)


@dataclasses.dataclass
class LossScaleConfig:
    init_scale: float = 2.0 ** 15
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 1000   # incr_every_n_steps in the reference
    min_scale: float = 1.0
    max_scale: float = 2.0 ** 24


class DynamicLossScale:
    """Functional dynamic loss scale: state = ``{scale, growth_counter}``
    (float32 and int32 0-d tensors); on overflow the step is skipped and
    the scale backs off; after ``growth_interval`` clean steps it
    grows."""

    def __init__(self, config: Optional[LossScaleConfig] = None):
        self.config = config or LossScaleConfig()

    def init(self, device="cuda") -> Dict[str, torch.Tensor]:
        """The initial state on ``device`` (the card unless the caller
        asks for the CPU)."""
        device = resolve_device(device)
        return {
            "scale": torch.full((), self.config.init_scale,
                                dtype=torch.float32, device=device),
            "growth_counter": torch.zeros((), dtype=torch.int32,
                                          device=device),
        }

    def scale(self, loss, state):
        return loss * state["scale"].to(loss.dtype)

    def unscale(self, grads, state):
        inv = 1.0 / state["scale"]
        return [g * inv.to(g.dtype) for g in grads]

    def grads_finite(self, grads) -> torch.Tensor:
        ok = torch.ones((), dtype=torch.bool, device=grads[0].device)
        for g in grads:
            ok = ok & torch.all(torch.isfinite(g))
        return ok

    def update(self, state, grads_finite) -> Dict[str, torch.Tensor]:
        cfg = self.config
        counter = torch.where(grads_finite, state["growth_counter"] + 1, 0)
        grow = counter >= cfg.growth_interval
        scale = state["scale"]
        new_scale = torch.where(
            grads_finite,
            torch.where(grow, scale * cfg.growth_factor, scale),
            scale * cfg.backoff_factor)
        new_scale = torch.clamp(new_scale, cfg.min_scale, cfg.max_scale)
        return {"scale": new_scale,
                "growth_counter": torch.where(grow, 0, counter).to(
                    torch.int32)}


def _opt_tensors(optimizer):
    return list(optimizer.params()) + list(optimizer.state_tensors())


def scaled_train_step(
    loss_fn: Callable,
    optimizer,
    *,
    policy: Optional[dtypes.Policy] = None,
    loss_scale: Optional[DynamicLossScale] = None,
) -> Callable:
    """fp16-style train step: scaled loss, unscaled grads, skip on
    overflow.

    ``step(state, **batch) -> (state, metrics)`` where ``state`` also
    carries ``"loss_scale"`` (:func:`make_amp_state`). The optimizer sees
    the unscaled gradients, zeroed where they are not finite, and then
    every parameter, slot and the optimizer's step count are set back to
    their values before the step unless all gradients were finite;
    ``state["step"]`` advances by the finite flag. Metrics: ``loss``
    (unscaled), ``grads_finite``, ``loss_scale`` (the new scale) and the
    loss function's aux values. On the card the step is captured
    (:class:`~paddle_tpu_torch.train.TrainStepGraphs`)."""
    policy = policy or dtypes.get_policy("bf16")
    loss_scale = loss_scale or DynamicLossScale()

    def step(state, batch):
        model, opt = state["model"], state["opt"]
        ls = state["loss_scale"]
        opt.zero_grad(set_to_none=True)
        with capture_state() as tape:     # BN running statistics, as in
            out = _policy_call(loss_fn, model, policy, batch)  # the step
            loss, aux = out if isinstance(out, tuple) else (out, {})
            loss_scale.scale(loss.float(), ls).backward()
        params = [p for p in opt.params() if p.grad is not None]
        grads = loss_scale.unscale([p.grad for p in params], ls)
        finite = loss_scale.grads_finite(grads)
        new_ls = loss_scale.update(ls, finite)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.grad.copy_(torch.where(finite, g, 0.0))
            saved = [t.clone() for t in _opt_tensors(opt)]
            opt.step()
            # read after the step: the reference's promotion may have
            # replaced a tensor with a float32 one, which keeps that
            # dtype on a skipped step too (``where`` promotes)
            for t, old in zip(_opt_tensors(opt), saved):
                t.copy_(torch.where(finite, t, old))
            tape.apply(where=finite)
            state["step"].add_(finite.to(torch.int32))
            for k, v in new_ls.items():
                ls[k].copy_(v)
        metrics = {"loss": loss.detach(), "grads_finite": finite,
                   "loss_scale": ls["scale"].clone(),
                   **{k: v.detach() for k, v in aux.items()}}
        return state, metrics

    return TrainStepGraphs(step, loss_fn=loss_fn)


def make_amp_state(model, optimizer,
                   loss_scale: Optional[DynamicLossScale] = None):
    """:func:`~paddle_tpu_torch.train.make_train_state` plus the loss
    scale's state under ``"loss_scale"``, on the model's device."""
    loss_scale = loss_scale or DynamicLossScale()
    state = make_train_state(model, optimizer)
    state["loss_scale"] = loss_scale.init(state["step"].device)
    return state
