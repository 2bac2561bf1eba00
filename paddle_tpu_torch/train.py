"""Train-step builder (``paddle_tpu/train.py``): forward, backward,
gradient accumulation, mixed-precision casts and the optimizer as one
call.

The step keeps the reference's shape, ``step(state, **batch) -> (state,
metrics)``, but PyTorch is eager and stateful: the step updates the
model's parameters and the optimizer's slots **in place** and returns the
same ``state`` dict with its ``step`` count advanced (the reference
returns a new state and donates the old one). Metrics are 0-d tensors on
the model's device, so a step does not wait for the device; read them
with ``float()`` when needed.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch import nn

from paddle_tpu_torch.core import dtypes


def make_train_state(model: nn.Module, optimizer) -> Dict[str, Any]:
    """``{"model", "opt", "step"}``. The model holds the parameters
    (already initialised from its seed); ``opt`` is the optimizer over
    them."""
    return {"model": model, "opt": optimizer, "step": 0}


class _LossModule(nn.Module):
    """Lets ``torch.func.functional_call`` run ``loss_fn(model, **batch)``
    with the model's parameters swapped for their compute-dtype casts."""

    def __init__(self, model, loss_fn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, **batch):
        return self.loss_fn(self.model, **batch)


def _policy_call(fn: Callable, model: nn.Module,
                 policy: Optional[dtypes.Policy], batch: Mapping):
    """``fn(model, **batch)``; under a policy, the parameters enter as
    differentiable casts to its compute dtype (the fp32 masters get the
    gradients) and floating feeds are cast too."""
    if policy is None:
        return fn(model, **batch)
    batch = policy.cast_to_compute(dict(batch))
    params = {f"model.{n}": policy.cast_to_compute(p)
              for n, p in model.named_parameters()}
    return torch.func.functional_call(_LossModule(model, fn), params,
                                      args=(), kwargs=batch)


def _split(batch: Mapping, n: int):
    """Cut every feed tensor into ``n`` micro-batches along its first
    axis (which must divide)."""
    for key, val in batch.items():
        if val.shape[0] % n:
            raise ValueError(f"batch axis of {key!r} ({val.shape[0]}) is "
                             f"not divisible by grad_accum_steps={n}")
    return [dict(zip(batch, parts))
            for parts in zip(*(v.chunk(n) for v in batch.values()))]


def build_train_step(
    loss_fn: Callable,
    optimizer,
    *,
    policy: Optional[dtypes.Policy] = None,
    trainable_mask: Optional[Mapping[str, bool]] = None,
    grad_accum_steps: int = 1,
) -> Callable:
    """Build ``step(state, **batch) -> (state, metrics)``.

    ``loss_fn(model, **batch)`` returns a scalar loss or ``(loss,
    aux_dict)``. ``policy`` casts parameters and floating feeds to its
    compute dtype for the forward; gradients arrive in the parameters'
    dtype (fp32 master weights). ``trainable_mask`` maps parameter names
    to bools: False leaves that parameter untouched by the optimizer.
    ``grad_accum_steps > 1`` splits the batch into micro-batches and
    averages their gradients (sum, then divide, as the reference does);
    the loss and aux metrics are the micro-batches' means."""
    if grad_accum_steps < 1:
        raise ValueError("grad_accum_steps must be >= 1")

    def forward_backward(model, batch):
        out = _policy_call(loss_fn, model, policy, batch)
        loss, aux = out if isinstance(out, tuple) else (out, {})
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def step(state, **batch):
        model, opt = state["model"], state["opt"]
        opt.zero_grad(set_to_none=True)
        if grad_accum_steps > 1:
            outs = [forward_backward(model, mb)
                    for mb in _split(batch, grad_accum_steps)]
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(grad_accum_steps)
            loss = torch.stack([o[0] for o in outs]).mean()
            aux = {k: torch.stack([o[1][k] for o in outs]).mean()
                   for k in outs[0][1]}
        else:
            loss, aux = forward_backward(model, batch)
        if trainable_mask is not None:
            for name, p in model.named_parameters():
                if not trainable_mask.get(name, True):
                    p.grad = None
        opt.step()
        state["step"] += 1
        return state, {"loss": loss, **aux}

    return step


def build_eval_step(model_fn: Callable,
                    policy: Optional[dtypes.Policy] = None) -> Callable:
    """``step(model, **batch) -> model_fn(model, **batch)`` under
    ``torch.no_grad()``, with the policy's compute casts."""
    def step(model, **batch):
        with torch.no_grad():
            return _policy_call(model_fn, model, policy, batch)

    return step
