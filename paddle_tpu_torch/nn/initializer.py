"""Parameter initializers (``paddle_tpu/nn/initializer.py``): constant,
uniform, normal, truncated normal, Xavier and MSRA (Kaiming).

Each factory returns ``init(tensor, generator=None)``, which fills
``tensor`` in place from ``generator`` (the default generator of the
tensor's device when None) and returns it. Fans follow the reference's
:func:`_fans`: dense weights are ``(in, out)`` and conv kernels HWIO, so
the receptive field is every axis but the last two. The draws differ from
the reference's (``torch.Generator`` is not ``jax.random``); the
distributions are the same.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _fans(shape, fan_in=None, fan_out=None):
    # Conv kernels here are HWIO; dense kernels are (in, out).
    if fan_in is not None and fan_out is not None:
        return fan_in, fan_out
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def constant(value=0.0):
    @torch.no_grad()
    def init(tensor, generator: Optional[torch.Generator] = None):
        return tensor.fill_(value)

    return init


zeros = constant(0.0)
ones = constant(1.0)


def uniform(low=-1.0, high=1.0):
    @torch.no_grad()
    def init(tensor, generator: Optional[torch.Generator] = None):
        return tensor.uniform_(low, high, generator=generator)

    return init


def normal(mean=0.0, std=1.0):
    @torch.no_grad()
    def init(tensor, generator: Optional[torch.Generator] = None):
        return tensor.normal_(mean, std, generator=generator)

    return init


def truncated_normal(mean=0.0, std=1.0):
    """``mean + std * z`` with ``z`` a standard normal truncated to
    [-2, 2] (not rescaled to unit variance, as the reference draws it),
    by inverting the normal CDF over a uniform draw."""

    @torch.no_grad()
    def init(tensor, generator: Optional[torch.Generator] = None):
        lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0)))
                  for b in (-2.0, 2.0))
        u = torch.empty(tensor.shape, dtype=torch.float32,
                        device=tensor.device)
        u.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=generator)
        z = torch.erfinv(u).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
        return tensor.copy_(z.mul_(std).add_(mean))

    return init


def xavier_uniform(fan_in=None, fan_out=None):
    """Xavier/Glorot uniform (reference ``XavierInitializer``)."""

    @torch.no_grad()
    def init(tensor, generator: Optional[torch.Generator] = None):
        fi, fo = _fans(tuple(tensor.shape), fan_in, fan_out)
        limit = math.sqrt(6.0 / (fi + fo))
        return tensor.uniform_(-limit, limit, generator=generator)

    return init


def xavier_normal(fan_in=None, fan_out=None):
    @torch.no_grad()
    def init(tensor, generator: Optional[torch.Generator] = None):
        fi, fo = _fans(tuple(tensor.shape), fan_in, fan_out)
        return tensor.normal_(0.0, math.sqrt(2.0 / (fi + fo)),
                              generator=generator)

    return init


def msra_uniform(fan_in=None):
    """Kaiming/He uniform (reference ``MSRAInitializer``)."""

    @torch.no_grad()
    def init(tensor, generator: Optional[torch.Generator] = None):
        fi, _ = _fans(tuple(tensor.shape), fan_in, None)
        limit = math.sqrt(6.0 / fi)
        return tensor.uniform_(-limit, limit, generator=generator)

    return init


def msra_normal(fan_in=None):
    @torch.no_grad()
    def init(tensor, generator: Optional[torch.Generator] = None):
        fi, _ = _fans(tuple(tensor.shape), fan_in, None)
        return tensor.normal_(0.0, math.sqrt(2.0 / fi), generator=generator)

    return init
