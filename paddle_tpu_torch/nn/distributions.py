"""Probability distributions (``paddle_tpu/nn/distributions.py``, fluid's
``layers.distributions``): ``Uniform``, ``Normal``, ``Categorical`` and
``MultivariateNormalDiag``, each with ``sample``, ``entropy``,
``log_prob`` and ``kl_divergence`` (``Categorical`` and
``MultivariateNormalDiag`` with the reference's additions).

Parameters become float32 tensors on the device of the tensors given, or
on ``device`` (the card unless the caller asks for the CPU) when none is
a tensor. ``sample`` draws from a ``torch.Generator`` where the reference
takes a PRNG key (the device's default generator when None): the same
distributions, not JAX's bits.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from paddle_tpu_torch.core.device import resolve_device

__all__ = ["Distribution", "Uniform", "Normal", "Categorical",
           "MultivariateNormalDiag", "kl_divergence"]

_LOG_2PI = math.log(2.0 * math.pi)


def _params(*values, device=None):
    """``values`` as float32 tensors on one device: that of the first
    tensor among them, else ``device`` (the card by default)."""
    dev = next((v.device for v in values if isinstance(v, torch.Tensor)),
               None)
    if dev is None:
        dev = resolve_device(device if device is not None else "cuda")
    return tuple(torch.as_tensor(v, dtype=torch.float32, device=dev)
                 for v in values)


class Distribution:
    """Base class (``distributions.py:28``)."""

    def sample(self, shape=(), *,
               generator: Optional[torch.Generator] = None):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def kl_divergence(self, other):
        raise NotImplementedError

    def prob(self, value):
        return torch.exp(self.log_prob(value))

    def _value(self, value, like):
        return torch.as_tensor(value, dtype=like.dtype, device=like.device)


class Uniform(Distribution):
    """Uniform on ``[low, high)``; ``log_prob`` is -inf outside it."""

    def __init__(self, low, high, *, device=None):
        self.low, self.high = _params(low, high, device=device)

    @property
    def batch_shape(self):
        return torch.broadcast_shapes(self.low.shape, self.high.shape)

    def sample(self, shape=(), *, generator=None):
        shape = tuple(shape) + tuple(self.batch_shape)
        u = torch.rand(shape, generator=generator, dtype=self.low.dtype,
                       device=self.low.device)
        return self.low + u * (self.high - self.low)

    def log_prob(self, value):
        value = self._value(value, self.low)
        inside = (self.low <= value) & (value < self.high)
        return torch.where(inside, 0.0, -math.inf) \
            - torch.log(self.high - self.low)

    def entropy(self):
        return torch.log(self.high - self.low).expand(self.batch_shape)

    def kl_divergence(self, other):
        if not isinstance(other, Uniform):
            raise TypeError("kl_divergence expects another Uniform")
        contained = (other.low <= self.low) & (self.high <= other.high)
        kl = torch.log(other.high - other.low) \
            - torch.log(self.high - self.low)
        return torch.where(contained, kl, math.inf)


class Normal(Distribution):
    """Normal(loc, scale)."""

    def __init__(self, loc, scale, *, device=None):
        self.loc, self.scale = _params(loc, scale, device=device)

    @property
    def batch_shape(self):
        return torch.broadcast_shapes(self.loc.shape, self.scale.shape)

    def sample(self, shape=(), *, generator=None):
        shape = tuple(shape) + tuple(self.batch_shape)
        eps = torch.randn(shape, generator=generator, dtype=self.loc.dtype,
                          device=self.loc.device)
        return self.loc + eps * self.scale

    def entropy(self):
        return (0.5 + 0.5 * _LOG_2PI + torch.log(self.scale)).expand(
            self.batch_shape)

    def log_prob(self, value):
        value = self._value(value, self.loc)
        var = self.scale * self.scale
        return (-((value - self.loc) ** 2) / (2.0 * var)
                - torch.log(self.scale) - 0.5 * _LOG_2PI)

    def kl_divergence(self, other):
        if not isinstance(other, Normal):
            raise TypeError("kl_divergence expects another Normal")
        var_ratio = (self.scale / other.scale) ** 2
        t1 = ((self.loc - other.loc) / other.scale) ** 2
        return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


class Categorical(Distribution):
    """Categorical over the last axis of ``logits``."""

    def __init__(self, logits, *, device=None):
        self.logits, = _params(logits, device=device)

    @property
    def _log_normalized(self):
        logits = self.logits - self.logits.amax(-1, keepdim=True)
        return logits - torch.log(torch.exp(logits).sum(-1, keepdim=True))

    @property
    def probs(self):
        return torch.softmax(self.logits, dim=-1)

    def sample(self, shape=(), *, generator=None):
        """``shape + logits.shape[:-1]`` category ids (int64)."""
        shape = tuple(shape)
        batch = tuple(self.logits.shape[:-1])
        flat = self.probs.reshape(-1, self.logits.shape[-1])
        n = math.prod(shape)
        draws = torch.multinomial(flat, n, replacement=True,
                                  generator=generator)     # (M, n)
        return draws.T.reshape(shape + batch)

    def log_prob(self, value):
        value = torch.as_tensor(value, device=self.logits.device).long()
        return torch.gather(self._log_normalized.expand(
            value.shape + self.logits.shape[-1:]), -1, value[..., None])[
            ..., 0]

    def entropy(self):
        """``-sum p log p``, with ``0 log 0 = 0`` where a logit is -inf
        (masked before the product, so gradients stay finite)."""
        logp = self._log_normalized
        dead = torch.isneginf(logp)
        plogp = torch.exp(logp) * torch.where(dead, 0.0, logp)
        return -plogp.sum(-1, keepdim=True)

    def kl_divergence(self, other):
        if not isinstance(other, Categorical):
            raise TypeError("kl_divergence expects another Categorical")
        logp, logq = self._log_normalized, other._log_normalized
        dead = torch.isneginf(logp)
        term = torch.exp(logp) * torch.where(dead, 0.0, logp - logq)
        return term.sum(-1, keepdim=True)


class MultivariateNormalDiag(Distribution):
    """Multivariate normal with a diagonal covariance: ``scale`` is the
    ``[k, k]`` covariance matrix, its off-diagonal entries ignored, as the
    reference's."""

    def __init__(self, loc, scale, *, device=None):
        self.loc, self.scale = _params(loc, scale, device=device)
        if self.scale.ndim < 2 or self.scale.shape[-1] != \
                self.scale.shape[-2]:
            raise ValueError("scale must be a [k, k] diagonal covariance "
                             f"matrix, got {tuple(self.scale.shape)}")

    @property
    def _diag(self):
        return torch.diagonal(self.scale, dim1=-2, dim2=-1)

    def _log_det(self):
        return torch.log(self._diag).sum(-1)

    def sample(self, shape=(), *, generator=None):
        shape = tuple(shape) + tuple(self.loc.shape)
        eps = torch.randn(shape, generator=generator, dtype=self.loc.dtype,
                          device=self.loc.device)
        return self.loc + eps * torch.sqrt(self._diag)

    def entropy(self):
        k = self.loc.shape[-1]
        return 0.5 * (k * (1.0 + _LOG_2PI) + self._log_det())

    def log_prob(self, value):
        value = self._value(value, self.loc)
        k = self.loc.shape[-1]
        diff = value - self.loc
        maha = (diff * diff / self._diag).sum(-1)
        return -0.5 * (k * _LOG_2PI + self._log_det() + maha)

    def kl_divergence(self, other):
        if not isinstance(other, MultivariateNormalDiag):
            raise TypeError("kl_divergence expects another "
                            "MultivariateNormalDiag")
        dp, dq = self._diag, other._diag
        diff = other.loc - self.loc
        k = self.loc.shape[-1]
        return 0.5 * ((dp / dq).sum(-1) + (diff * diff / dq).sum(-1) - k
                      + other._log_det() - self._log_det())


def kl_divergence(p: Distribution, q: Distribution):
    """``p.kl_divergence(q)``."""
    return p.kl_divergence(q)
