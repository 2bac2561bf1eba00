"""Learning-rate schedules (``paddle_tpu/optimizer/lr_scheduler.py``).

Each schedule is a pure ``step -> lr`` function of the (1-based) step
count, computed in float32 as the reference's ``jnp`` schedules are. A
0-d step tensor (the optimizer's device step count) gives a 0-d float32
tensor on its device, with no host value on the way, so the learning
rate can live inside a captured CUDA graph; a Python number gives a
Python float.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _schedule(fn):
    """Run ``fn`` on the step as a float32 0-d tensor: a tensor step keeps
    its device and the result stays a tensor; a number gives a float."""
    @functools.wraps(fn)
    def sched(step):
        if isinstance(step, torch.Tensor):
            return fn(step.to(torch.float32))
        return float(fn(torch.tensor(float(step), dtype=torch.float32)))
    return sched


def constant(value):
    @_schedule
    def sched(s):
        return torch.full_like(s, value)
    return sched


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    @_schedule
    def sched(s):
        s = torch.clamp(s, min=1.0)
        return learning_rate * d_model ** -0.5 * torch.minimum(
            s ** -0.5, s * warmup_steps ** -1.5)
    return sched


def _exponent(s, decay_steps, staircase):
    e = s / decay_steps
    return torch.floor(e) if staircase else e


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    @_schedule
    def sched(s):
        return learning_rate * decay_rate ** _exponent(s, decay_steps,
                                                       staircase)
    return sched


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    @_schedule
    def sched(s):
        return learning_rate * torch.exp(
            -decay_rate * _exponent(s, decay_steps, staircase))
    return sched


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    @_schedule
    def sched(s):
        return learning_rate / (
            1.0 + decay_rate * _exponent(s, decay_steps, staircase))
    return sched


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0, cycle=False):
    @_schedule
    def sched(s):
        if cycle:
            ds = decay_steps * torch.clamp(torch.ceil(s / decay_steps),
                                           min=1.0)
        else:
            ds = decay_steps
            s = torch.clamp(s, max=decay_steps)
        return ((learning_rate - end_learning_rate) * (1 - s / ds) ** power
                + end_learning_rate)
    return sched


def piecewise_decay(boundaries, values):
    """``values[i]`` for the i boundaries at or below the step, as the
    reference's right-sided ``searchsorted`` (boundaries ascending)."""
    boundaries = list(boundaries)
    values = [float(v) for v in np.asarray(values, np.float32)]

    @_schedule
    def sched(s):
        out = torch.full_like(s, values[0])
        for b, v in zip(boundaries, values[1:]):
            out = torch.where(s >= b, v, out)
        return out
    return sched


def cosine_decay(learning_rate, step_each_epoch, epochs):
    @_schedule
    def sched(s):
        epoch = torch.floor(s / step_each_epoch)
        return learning_rate * 0.5 * (torch.cos(epoch * math.pi / epochs)
                                      + 1)
    return sched


def cosine_decay_steps(learning_rate, total_steps, end_lr=0.0):
    """Continuous cosine over steps (the BERT/ResNet recipes' variant)."""
    @_schedule
    def sched(s):
        frac = torch.clamp(s / total_steps, 0.0, 1.0)
        return end_lr + (learning_rate - end_lr) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    return sched


def linear_lr_warmup(base_sched, warmup_steps, start_lr, end_lr):
    """Wrap another schedule with linear warmup."""
    if not callable(base_sched):
        base_sched = constant(base_sched)

    @_schedule
    def sched(s):
        warm = start_lr + (end_lr - start_lr) * torch.clamp(
            s, max=warmup_steps) / warmup_steps
        return torch.where(s < warmup_steps, warm, base_sched(s))
    return sched
