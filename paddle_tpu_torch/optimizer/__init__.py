"""Optimizers (``paddle_tpu/optimizer/__init__.py``): the reference's update
rules as ``torch.optim.Optimizer`` subclasses over each parameter's
``.grad``, its wrappers and averagers, and ``recompute`` with the saving
policies of ``jax.checkpoint_policies`` (:data:`checkpoint_policies`).

As in the reference, one ``step()``: applies the regularizer (a gradient
transform), then the gradient clip, then increments the step count and
only then reads the learning rate (``step -> lr`` schedule, or a float)
for the new step, and updates every parameter that has a gradient;
parameters whose ``.grad`` is None (frozen ones) pass through untouched,
and AdamW never decays them.

The step count is the reference's ``state["step"]``: an int32 0-d tensor
on the parameters' device (:attr:`Optimizer.state_step`), and the
learning rate and Adam's bias corrections are computed from it on the
device, so a step reads no host value and can be captured in a CUDA
graph. Slot buffers live in ``self.state[p]``, made when the optimizer is
built (zeros, or the rule's initial value).

Dtypes follow the reference's promotion rules, where the learning rate
is a float32 array: Adam, AdamW and Lamb keep float32 ``m``/``v`` whatever
the parameter's dtype; a rule whose result is float32 for a lower-precision
parameter (SGD, Momentum, AdamW's decay, ...) turns that parameter into
float32 at its first step (``p.data`` is replaced, the parameter object
and its state entry stay), and a slot whose new value has another dtype
is replaced by a new tensor. Every other write is in place, so the
state's tensors settle after at most two steps, and a captured train step
(:class:`~paddle_tpu_torch.train.TrainStepGraphs`) waits for that.

Two ways to apply a rule: per parameter (``_apply``, the plain version,
a line-by-line copy of the reference's), and for SGD, Momentum, Adam and
AdamW also multi-tensor (``foreach=True``, the default): one chain of
``torch._foreach_*`` calls over all float32 parameters of a device, in the
reference's operation order, so a few launches per operation cover every
parameter. Parameters of other dtypes, or with a slot of another dtype,
take the plain rule.

Norms: the gradient clips by norm and the trust ratios of LarsMomentum
and Lamb take norms of whole tensors. A sharded step
(``parallel.api.shard_train_step``) holds blocks of them and sets
:attr:`Optimizer.norm_reduce`, which sums each block's squared sum over
the ranks that hold the tensor's other blocks, so the norms are the
whole tensors' as in the reference's GSPMD step.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import types
from typing import Callable, Dict, List, Optional

import torch

from paddle_tpu_torch.optimizer import compression, lr_scheduler
from paddle_tpu_torch.optimizer.clip import (GradClipBase,
                                             GradientClipByGlobalNorm,
                                             GradientClipByNorm,
                                             GradientClipByValue, global_norm)
from paddle_tpu_torch.optimizer.compression import DGC
from paddle_tpu_torch.optimizer.regularizer import L1Decay, L2Decay

__all__ = ["DGC", "Adadelta", "AdadeltaOptimizer", "Adagrad",
           "AdagradOptimizer", "Adam", "AdamOptimizer", "AdamW", "Adamax",
           "AdamaxOptimizer", "DecayedAdagrad", "DecayedAdagradOptimizer",
           "Dpsgd", "ExponentialMovingAverage", "Ftrl", "FtrlOptimizer",
           "GradClipBase", "GradientClipByGlobalNorm", "GradientClipByNorm",
           "GradientClipByValue", "L1Decay", "L2Decay", "Lamb",
           "LambOptimizer", "LarsMomentum", "LarsMomentumOptimizer",
           "LookaheadOptimizer", "ModelAverage", "Momentum",
           "MomentumOptimizer", "Optimizer", "RMSProp", "RMSPropOptimizer",
           "SGD", "SGDOptimizer", "checkpoint_policies", "compression",
           "global_norm", "lr_scheduler", "recompute"]


def _store(holder: dict, key, new: torch.Tensor):
    """Write ``new`` into ``holder[key]`` in place, or replace the entry
    when the reference's promotion gave it another dtype."""
    old = holder[key]
    if old.dtype == new.dtype:
        old.copy_(new)
    else:
        holder[key] = new


def _store_param(p: torch.Tensor, new: torch.Tensor):
    if p.dtype == new.dtype:
        p.copy_(new)
    else:
        p.data = new


class Optimizer(torch.optim.Optimizer):
    """Base optimizer. ``learning_rate`` is a float or a ``step -> lr``
    schedule (called with the 0-d device step; the schedules of
    :mod:`lr_scheduler` compute on the device); ``regularization`` an
    L1/L2 decay applied to the gradients before the rule; ``grad_clip`` a
    :class:`GradClipBase`; ``name`` the reference's label; ``foreach``
    the multi-tensor path where the rule has one."""

    SLOTS = ()
    #: slots kept in float32 whatever the parameter's dtype
    FP32_SLOTS = False
    #: ``(params, sq) -> sq``: ``sq`` a 1-D float32 tensor of squared
    #: sums, one for each of ``params``, each summed over the ranks that
    #: hold the other blocks of its parameter (set by a sharded step);
    #: None: every parameter is whole
    norm_reduce: Optional[Callable[[List[torch.Tensor], torch.Tensor],
                                   torch.Tensor]] = None

    def __init__(self, params, learning_rate=0.001, regularization=None,
                 grad_clip: Optional[GradClipBase] = None, name=None,
                 foreach: bool = True):
        super().__init__(params, {})
        self._lr = (learning_rate if callable(learning_rate)
                    else lr_scheduler.constant(learning_rate))
        self.regularization = regularization
        self.grad_clip = grad_clip
        self.name = name
        self.foreach = foreach
        params = self.params()
        if not params:
            raise ValueError("optimizer got an empty parameter list")
        #: the reference's state["step"]: steps applied so far
        self.state_step = torch.zeros((), dtype=torch.int32,
                                      device=params[0].device)
        for p in params:
            self.state[p] = {s: self._init_slot(p, s) for s in self.SLOTS}

    def params(self) -> List[torch.Tensor]:
        return [p for group in self.param_groups for p in group["params"]]

    def _init_slot(self, p, slot):
        return torch.zeros_like(
            p, dtype=torch.float32 if self.FP32_SLOTS else p.dtype)

    @property
    def num_steps(self) -> int:
        """Steps applied so far (reads the device count)."""
        return int(self.state_step)

    def state_tensors(self) -> List[torch.Tensor]:
        """The step count and every slot tensor, in a fixed order."""
        return [self.state_step] + [self.state[p][s] for p in self.params()
                                    for s in self.SLOTS]

    def lr_at(self, step: torch.Tensor) -> torch.Tensor:
        """The learning rate of ``step`` as a float32 0-d tensor on its
        device."""
        lr = self._lr(step)
        if not isinstance(lr, torch.Tensor):
            return torch.full((), float(lr), dtype=torch.float32,
                              device=step.device)
        return lr.to(torch.float32)

    def _transform_grads(self, params, grads):
        if self.regularization is not None:
            grads = self.regularization(grads, params)
        if self.grad_clip is not None:
            if self.norm_reduce is None:
                grads = self.grad_clip(grads)
            else:
                grads = self.grad_clip(grads, reduce_sq=lambda sq:
                                       self.norm_reduce(params, sq))
        return grads

    def _sq_sums(self, p, *ts):
        """The squared sums of ``ts`` (tensors shaped like ``p``), each
        of the whole tensor when ``p`` is a block of one."""
        sq = [torch.sum(torch.square(t)) for t in ts]
        if self.norm_reduce is None:
            return sq
        whole = self.norm_reduce([p] * len(ts),
                                 torch.stack([s.float() for s in sq]))
        return [whole[i].to(s.dtype) for i, s in enumerate(sq)]

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = [p for p in self.params() if p.grad is not None]
        grads = self._transform_grads(params, [p.grad for p in params])
        self.state_step.add_(1)
        self._update(params, grads, self.lr_at(self.state_step),
                     self.state_step)
        return loss

    def _update(self, params, grads, lr, step):
        groups: Dict[torch.device, list] = collections.defaultdict(list)
        multi = self.foreach and type(self)._apply_foreach is not \
            Optimizer._apply_foreach
        for p, g in zip(params, grads):
            slots = self.state[p]
            if multi and p.dtype == g.dtype == torch.float32 and all(
                    t.dtype == torch.float32 for t in slots.values()):
                groups[p.device].append((p, g))
                continue
            new_p, new_slots = self._apply(g, p, slots, lr, step)
            _store_param(p, new_p)
            for s in self.SLOTS:
                _store(slots, s, new_slots[s])
        for pairs in groups.values():
            ps, gs = (list(x) for x in zip(*pairs))
            self._apply_foreach(ps, gs, [self.state[p] for p in ps], lr,
                                step)

    def _apply(self, g, p, slots, lr, step):
        """The plain rule: ``(new_p, new_slots)`` for one parameter."""
        raise NotImplementedError

    def _apply_foreach(self, ps, gs, slots, lr, step):
        """The multi-tensor rule, in place over float32 lists."""
        raise NotImplementedError


class SGD(Optimizer):
    def _apply(self, g, p, slots, lr, step):
        return p - lr * g.to(p.dtype).float(), slots

    def _apply_foreach(self, ps, gs, slots, lr, step):
        torch._foreach_sub_(ps, torch._foreach_mul(gs, lr))


class Momentum(Optimizer):
    SLOTS = ("velocity",)

    def __init__(self, params, learning_rate, momentum=0.9,
                 use_nesterov=False, **kw):
        super().__init__(params, learning_rate, **kw)
        self.mu = momentum
        self.nesterov = use_nesterov

    def _apply(self, g, p, slots, lr, step):
        v = self.mu * slots["velocity"] + g
        upd = g + self.mu * v if self.nesterov else v
        return p - lr * upd.to(p.dtype).float(), {"velocity": v}

    def _apply_foreach(self, ps, gs, slots, lr, step):
        vs = [s["velocity"] for s in slots]
        torch._foreach_mul_(vs, self.mu)
        torch._foreach_add_(vs, gs)
        if self.nesterov:
            upd = torch._foreach_mul(vs, self.mu)
            torch._foreach_add_(upd, gs)
            torch._foreach_mul_(upd, lr)
        else:
            upd = torch._foreach_mul(vs, lr)
        torch._foreach_sub_(ps, upd)


class LarsMomentum(Optimizer):
    """LARS: a layerwise-adaptive rate."""

    SLOTS = ("velocity",)

    def __init__(self, params, learning_rate, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005, epsilon=1e-9,
                 **kw):
        super().__init__(params, learning_rate, **kw)
        self.mu, self.coeff = momentum, lars_coeff
        self.wd, self.eps = lars_weight_decay, epsilon

    def _apply(self, g, p, slots, lr, step):
        pn, gn = (torch.sqrt(s) for s in self._sq_sums(p, p, g))
        local = self.coeff * pn / (gn + self.wd * pn + self.eps)
        local = torch.where((pn == 0) | (gn == 0), 1.0, local)
        v = self.mu * slots["velocity"] + lr * local.float() * (
            g + self.wd * p).float()
        return p - v.to(p.dtype), {"velocity": v}


class Adagrad(Optimizer):
    SLOTS = ("moment",)

    def __init__(self, params, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kw):
        self.eps = epsilon
        self.init_acc = initial_accumulator_value
        super().__init__(params, learning_rate, **kw)

    def _init_slot(self, p, slot):
        return torch.full_like(p, self.init_acc)

    def _apply(self, g, p, slots, lr, step):
        m = slots["moment"] + torch.square(g)
        return p - lr * g.float() / (torch.sqrt(m) + self.eps), {"moment": m}


class Adam(Optimizer):
    """Adam; ``lazy_mode`` (the reference's sparse-rows switch) is
    accepted and has no effect, as there."""

    SLOTS = ("m", "v")
    FP32_SLOTS = True

    def __init__(self, params, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        super().__init__(params, learning_rate, **kw)
        self.b1, self.b2, self.eps = beta1, beta2, epsilon
        del lazy_mode

    def _bias_corrections(self, step):
        t = step.to(torch.float32)
        return 1 - self.b1 ** t, 1 - self.b2 ** t

    def _apply(self, g, p, slots, lr, step):
        g32 = g.float()
        m = self.b1 * slots["m"] + (1 - self.b1) * g32
        v = self.b2 * slots["v"] + (1 - self.b2) * torch.square(g32)
        bc1, bc2 = self._bias_corrections(step)
        mhat = m / bc1
        vhat = v / bc2
        upd = lr * mhat / (torch.sqrt(vhat) + self.eps)
        return p - upd.to(p.dtype), {"m": m, "v": v}

    def _apply_foreach(self, ps, gs, slots, lr, step):
        ms = [s["m"] for s in slots]
        vs = [s["v"] for s in slots]
        torch._foreach_mul_(ms, self.b1)
        torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - self.b1))
        torch._foreach_mul_(vs, self.b2)
        sq = torch._foreach_mul(gs, gs)
        torch._foreach_mul_(sq, 1 - self.b2)
        torch._foreach_add_(vs, sq)
        bc1, bc2 = self._bias_corrections(step)
        upd = torch._foreach_div(ms, bc1)            # mhat
        torch._foreach_mul_(upd, lr)                 # lr * mhat
        den = torch._foreach_div(vs, bc2)            # vhat
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        torch._foreach_sub_(ps, upd)


class AdamW(Adam):
    """Adam with decoupled weight decay (the BERT recipe optimizer): after
    the Adam step, ``p -= lr * weight_decay * p_before``, with the new
    step's learning rate. ``decay_mask_fn(p) -> bool`` selects which
    parameters decay (default: all; recipes often pass
    ``lambda p: p.ndim > 1`` to spare biases and norm scales). As in the
    reference, the decay of a lower-precision parameter is float32, so
    such a parameter becomes float32 at its first decayed step."""

    def __init__(self, params, learning_rate=0.001, weight_decay=0.01,
                 decay_mask_fn: Optional[Callable] = None, **kw):
        super().__init__(params, learning_rate, **kw)
        self.wd = weight_decay
        self.decay_mask_fn = decay_mask_fn

    def _update(self, params, grads, lr, step):
        if not self.wd:
            return super()._update(params, grads, lr, step)
        decayed = [p for p in params
                   if self.decay_mask_fn is None or self.decay_mask_fn(p)]
        coeff = lr * self.wd
        if self.foreach and decayed:
            decays = torch._foreach_mul([p.float() for p in decayed], coeff)
        else:
            decays = [coeff * p.float() for p in decayed]
        super()._update(params, grads, lr, step)
        same = [(p, d) for p, d in zip(decayed, decays) if p.dtype == d.dtype]
        if self.foreach and same:
            torch._foreach_sub_([p for p, _ in same], [d for _, d in same])
        else:
            for p, d in same:
                p.sub_(d)
        for p, d in zip(decayed, decays):
            if p.dtype != d.dtype:
                p.data = p.data - d


class Adamax(Optimizer):
    SLOTS = ("m", "inf")

    def __init__(self, params, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(params, learning_rate, **kw)
        self.b1, self.b2, self.eps = beta1, beta2, epsilon

    def _apply(self, g, p, slots, lr, step):
        m = self.b1 * slots["m"] + (1 - self.b1) * g
        u = torch.maximum(self.b2 * slots["inf"], torch.abs(g))
        t = step.to(torch.float32)
        upd = lr / (1 - self.b1 ** t) * m.float() / (u + self.eps)
        return p - upd.to(p.dtype), {"m": m, "inf": u}


class DecayedAdagrad(Optimizer):
    SLOTS = ("moment",)

    def __init__(self, params, learning_rate, decay=0.95, epsilon=1e-6,
                 **kw):
        super().__init__(params, learning_rate, **kw)
        self.decay, self.eps = decay, epsilon

    def _apply(self, g, p, slots, lr, step):
        m = self.decay * slots["moment"] + (1 - self.decay) * torch.square(g)
        return p - lr * g.float() / (torch.sqrt(m) + self.eps), {"moment": m}


class Adadelta(Optimizer):
    SLOTS = ("avg_sq_grad", "avg_sq_update")

    def __init__(self, params, learning_rate=1.0, epsilon=1e-6, rho=0.95,
                 **kw):
        super().__init__(params, learning_rate, **kw)
        self.eps, self.rho = epsilon, rho

    def _apply(self, g, p, slots, lr, step):
        asg = self.rho * slots["avg_sq_grad"] + (1 - self.rho) * \
            torch.square(g)
        upd = g * torch.sqrt(slots["avg_sq_update"] + self.eps) / \
            torch.sqrt(asg + self.eps)
        asu = self.rho * slots["avg_sq_update"] + (1 - self.rho) * \
            torch.square(upd)
        return p - lr * upd.float(), {"avg_sq_grad": asg,
                                      "avg_sq_update": asu}


class RMSProp(Optimizer):
    SLOTS = ("mean_square", "mean_grad", "momentum")

    def __init__(self, params, learning_rate, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, **kw):
        super().__init__(params, learning_rate, **kw)
        self.rho, self.eps = rho, epsilon
        self.mu, self.centered = momentum, centered

    def _apply(self, g, p, slots, lr, step):
        ms = self.rho * slots["mean_square"] + (1 - self.rho) * \
            torch.square(g)
        if self.centered:
            mg = self.rho * slots["mean_grad"] + (1 - self.rho) * g
            denom = torch.sqrt(ms - torch.square(mg) + self.eps)
        else:
            mg = slots["mean_grad"]
            denom = torch.sqrt(ms + self.eps)
        mom = self.mu * slots["momentum"] + lr * g.float() / denom
        return p - mom, {"mean_square": ms, "mean_grad": mg, "momentum": mom}


class Ftrl(Optimizer):
    SLOTS = ("squared", "linear")

    def __init__(self, params, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kw):
        super().__init__(params, learning_rate, **kw)
        self.l1, self.l2, self.lr_power = l1, l2, lr_power

    def _apply(self, g, p, slots, lr, step):
        sq, lin = slots["squared"], slots["linear"]
        new_sq = sq + torch.square(g)
        if self.lr_power == -0.5:
            sigma = (torch.sqrt(new_sq) - torch.sqrt(sq)).float() / lr
        else:
            sigma = (new_sq ** -self.lr_power
                     - sq ** -self.lr_power).float() / lr
        new_lin = lin + g - sigma * p
        if self.lr_power == -0.5:
            denom = torch.sqrt(new_sq).float() / lr + 2 * self.l2
        else:
            denom = (new_sq ** -self.lr_power).float() / lr + 2 * self.l2
        pre = torch.clamp(new_lin, -self.l1, self.l1) - new_lin
        return pre / denom, {"squared": new_sq, "linear": new_lin}


class Lamb(Optimizer):
    """LAMB, the large-batch BERT optimizer."""

    SLOTS = ("m", "v")
    FP32_SLOTS = True

    def __init__(self, params, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, **kw):
        super().__init__(params, learning_rate, **kw)
        self.wd, self.b1, self.b2 = lamb_weight_decay, beta1, beta2
        self.eps = epsilon

    def _apply(self, g, p, slots, lr, step):
        g32 = g.float()
        m = self.b1 * slots["m"] + (1 - self.b1) * g32
        v = self.b2 * slots["v"] + (1 - self.b2) * torch.square(g32)
        t = step.to(torch.float32)
        mhat = m / (1 - self.b1 ** t)
        vhat = v / (1 - self.b2 ** t)
        r = mhat / (torch.sqrt(vhat) + self.eps) + self.wd * p.float()
        pn, rn = (torch.sqrt(s) for s in self._sq_sums(p, p.float(), r))
        trust = torch.where((pn > 0) & (rn > 0), pn / rn, 1.0)
        return p - (lr * trust * r).to(p.dtype), {"m": m, "v": v}


class Dpsgd(Optimizer):
    """Differentially private SGD: each gradient is clipped to
    ``[-clip, clip]`` and gets Gaussian noise of std
    ``sigma * clip / batch_size``, drawn from a ``torch.Generator`` on the
    parameters' device seeded with ``seed`` (the reference threads a PRNG
    key through its state; the two draw different numbers)."""

    def __init__(self, params, learning_rate, clip=10.0, batch_size=16,
                 sigma=1.0, seed=0, **kw):
        super().__init__(params, learning_rate, **kw)
        self.clip_v, self.batch, self.sigma = clip, batch_size, sigma
        self.seed = seed
        self.generator = torch.Generator(device=self.state_step.device)
        self.generator.manual_seed(seed)

    def _transform_grads(self, params, grads):
        noisy = [torch.clamp(g, -self.clip_v, self.clip_v)
                 + self.sigma * self.clip_v / self.batch * torch.randn(
                     g.shape, generator=self.generator, device=g.device)
                 for g in grads]
        return super()._transform_grads(params, noisy)

    def _apply(self, g, p, slots, lr, step):
        return p - lr * g.float(), slots


# -- wrappers and averagers --------------------------------------------------

class LookaheadOptimizer:
    """k-step lookahead: every ``k``-th step of ``inner`` pulls the slow
    weights toward the fast ones by ``alpha`` and resets the fast weights
    to them (on the device: no host value per step)."""

    def __init__(self, inner: Optimizer, alpha=0.5, k=5):
        self.inner, self.alpha, self.k = inner, alpha, k
        self.slow = [p.detach().clone() for p in inner.params()]

    @property
    def state_step(self) -> torch.Tensor:
        return self.inner.state_step

    @property
    def num_steps(self) -> int:
        return self.inner.num_steps

    def params(self) -> List[torch.Tensor]:
        return self.inner.params()

    def zero_grad(self, set_to_none: bool = True):
        self.inner.zero_grad(set_to_none=set_to_none)

    def state_tensors(self) -> List[torch.Tensor]:
        return self.inner.state_tensors() + self.slow

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None):
        loss = self.inner.step(closure)
        sync = (self.inner.state_step % self.k) == 0
        for i, p in enumerate(self.inner.params()):
            s = self.slow[i]
            new = torch.where(sync, s + self.alpha * (p - s), s)
            if new.dtype == s.dtype:
                s.copy_(new)
            else:
                self.slow[i] = s = new
            _store_param(p, torch.where(sync, s, p))
        return loss


class ExponentialMovingAverage:
    """Parameter EMA for evaluation: after each optimizer step,
    :meth:`update` folds the parameters in with decay
    ``min(decay, (1 + t) / (10 + t))``; :meth:`apply` returns the
    averages, in the order of ``params``."""

    def __init__(self, params, decay=0.999):
        self.params = list(params)
        self.decay = decay
        self.ema = [p.detach().clone() for p in self.params]
        self.step = torch.zeros((), dtype=torch.int32,
                                device=self.params[0].device)

    @torch.no_grad()
    def update(self):
        self.step.add_(1)
        d = torch.clamp((1.0 + self.step) / (10.0 + self.step),
                        max=self.decay)
        for i, p in enumerate(self.params):
            new = d * self.ema[i].float() + (1 - d) * p.float()
            _store(self.ema, i, new)

    def apply(self) -> List[torch.Tensor]:
        return list(self.ema)


class ModelAverage:
    """Average of the parameters over every :meth:`update` so far (the
    reference keeps the window arguments and averages all updates)."""

    def __init__(self, params, average_window_rate=0.15,
                 min_average_window=10000, max_average_window=10000):
        self.params = list(params)
        self.max_window = max_average_window
        self.sum = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.int32,
                                 device=self.params[0].device)

    @torch.no_grad()
    def update(self):
        for s, p in zip(self.sum, self.params):
            s.add_(p)
        self.count.add_(1)

    def apply(self) -> List[torch.Tensor]:
        c = torch.clamp(self.count, min=1).to(torch.float32)
        return [s.float() / c for s in self.sum]


class _SavingPolicy:
    """A selective-checkpoint policy (``torch.utils.checkpoint``'s
    ``policy_fn(ctx, op, *args, **kwargs)``) named as its counterpart in
    ``jax.checkpoint_policies``: it keeps the output of every op it
    ``saves`` for the backward and lets the recompute rebuild the rest."""

    def __init__(self, name: str, saves: Callable):
        self.name = name
        self.saves = saves

    def __call__(self, ctx, op, *args, **kwargs):
        from torch.utils.checkpoint import CheckpointPolicy
        return (CheckpointPolicy.MUST_SAVE if self.saves(op)
                else CheckpointPolicy.PREFER_RECOMPUTE)

    def __repr__(self):
        return f"checkpoint_policies.{self.name}"


def _packet(op):
    return getattr(op, "overloadpacket", op)


def _dots(batch_dims: bool) -> Callable:
    """Whether an op is a matrix product (JAX's ``dot_general``); with
    ``batch_dims=False`` only those without batch dimensions (``mm``,
    ``addmm``: a matmul of (B, S, D) by (D, F) reaches the dispatcher as
    one ``mm`` over B x S rows, as JAX contracts it with no batch dim).
    The registered kernels (``ptt::flash_*``, ``ptt::paged_*``) are no
    dots, as a ``pallas_call`` is none in JAX."""
    aten = torch.ops.aten
    ops = {aten.mm, aten.addmm, aten.matmul}
    if batch_dims:
        ops |= {aten.bmm, aten.baddbmm}
    return lambda op: _packet(op) in ops


#: the saving policies ``recompute(fn, policy=)`` takes, named as
#: ``jax.checkpoint_policies``
checkpoint_policies = types.SimpleNamespace(
    nothing_saveable=_SavingPolicy("nothing_saveable", lambda op: False),
    everything_saveable=_SavingPolicy("everything_saveable",
                                      lambda op: True),
    dots_saveable=_SavingPolicy("dots_saveable", _dots(True)),
    dots_with_no_batch_dims_saveable=_SavingPolicy(
        "dots_with_no_batch_dims_saveable", _dots(False)),
)


def _context_fn(policy) -> Callable:
    """``torch.utils.checkpoint.checkpoint``'s ``context_fn`` for a saving
    policy (None or ``nothing_saveable``: plain recompute)."""
    from torch.utils import checkpoint
    if policy is None or policy is checkpoint_policies.nothing_saveable:
        return checkpoint.noop_context_fn
    if not callable(policy):
        raise TypeError(f"policy must be one of optimizer."
                        f"checkpoint_policies, got {policy!r}")
    return functools.partial(checkpoint.create_selective_checkpoint_contexts,
                             policy)


def _held_tensors(owner) -> Dict[tuple, torch.Tensor]:
    """The parameters and buffers a module holds right now, by (module,
    slot kind, name): under ``torch.func.functional_call`` (a train
    step's compute-dtype casts, a sharded step's gathered views) these
    are the swapped-in tensors."""
    if not isinstance(owner, torch.nn.Module):
        return {}
    return {(mod, kind, n): t for mod in owner.modules()
            for kind in ("_parameters", "_buffers")
            for n, t in getattr(mod, kind).items() if t is not None}


@contextlib.contextmanager
def _holding(slots, tensors):
    """``tensors`` in the module ``slots`` for the block's length."""
    old = []
    try:
        for (mod, kind, n), t in zip(slots, tensors):
            held = getattr(mod, kind)
            old.append((held, n, held[n]))
            held[n] = t
        yield
    finally:
        for held, n, t in reversed(old):
            held[n] = t


def recompute(fn, policy=None):
    """Activation recomputation: ``fn`` under
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, its
    activations recomputed in the backward. ``policy``, one of
    :data:`checkpoint_policies`, keeps the outputs of the ops it saves
    (selective checkpointing), as ``jax.checkpoint(fn, policy=)`` keeps
    its residuals; None recomputes everything, as ``jax.checkpoint(fn)``,
    and ``everything_saveable`` runs ``fn`` as it is (nothing to
    recompute; the residuals are what autograd keeps anyway). Keyword
    tensors enter the checkpoint as arguments too, so the RNG state of
    their device is saved and restored around the recompute (dropout
    draws the same masks twice). Where ``fn`` is a module's bound method
    (``recompute(layer.forward)``, per block), the tensors the module
    holds when it runs are its arguments as well, as the parameters are
    a JAX function's: the recompute reads them again even where a train
    step had swapped in compute-dtype casts only for the forward."""
    from torch.utils import checkpoint

    if policy is checkpoint_policies.everything_saveable:
        return fn
    context_fn = _context_fn(policy)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        held = _held_tensors(getattr(fn, "__self__", None))
        slots, keys = list(held), list(kwargs)
        m, n = len(slots), len(slots) + len(args)

        def run(*values):
            with _holding(slots, values[:m]):
                return fn(*values[m:n], **dict(zip(keys, values[n:])))
        return checkpoint.checkpoint(run, *held.values(), *args,
                                     *kwargs.values(), use_reentrant=False,
                                     context_fn=context_fn)
    return wrapped


SGDOptimizer = SGD
MomentumOptimizer = Momentum
AdagradOptimizer = Adagrad
AdamOptimizer = Adam
AdamaxOptimizer = Adamax
AdadeltaOptimizer = Adadelta
RMSPropOptimizer = RMSProp
FtrlOptimizer = Ftrl
LambOptimizer = Lamb
DecayedAdagradOptimizer = DecayedAdagrad
LarsMomentumOptimizer = LarsMomentum
