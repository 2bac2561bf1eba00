"""Learning-rate schedules (``paddle_tpu/optimizer/lr_scheduler.py``).

Each schedule is a pure ``step -> lr`` function of the (1-based) step
count, returning a Python float; the optimizer calls it once per step
with its new step count.
"""

from __future__ import annotations

import bisect
import math


def constant(value):
    def sched(step):
        del step
        return float(value)
    return sched


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    def sched(step):
        s = max(float(step), 1.0)
        return learning_rate * d_model ** -0.5 * min(
            s ** -0.5, s * warmup_steps ** -1.5)
    return sched


def _exponent(step, decay_steps, staircase):
    e = float(step) / decay_steps
    return math.floor(e) if staircase else e


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    def sched(step):
        return learning_rate * decay_rate ** _exponent(step, decay_steps,
                                                       staircase)
    return sched


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    def sched(step):
        return learning_rate * math.exp(
            -decay_rate * _exponent(step, decay_steps, staircase))
    return sched


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    def sched(step):
        return learning_rate / (
            1.0 + decay_rate * _exponent(step, decay_steps, staircase))
    return sched


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0, cycle=False):
    def sched(step):
        s = float(step)
        if cycle:
            ds = decay_steps * max(1.0, math.ceil(s / decay_steps))
        else:
            ds = decay_steps
            s = min(s, decay_steps)
        return ((learning_rate - end_learning_rate) * (1 - s / ds) ** power
                + end_learning_rate)
    return sched


def piecewise_decay(boundaries, values):
    boundaries = list(boundaries)
    values = [float(v) for v in values]

    def sched(step):
        return values[bisect.bisect_right(boundaries, step)]
    return sched


def cosine_decay(learning_rate, step_each_epoch, epochs):
    def sched(step):
        epoch = math.floor(float(step) / step_each_epoch)
        return learning_rate * 0.5 * (math.cos(epoch * math.pi / epochs) + 1)
    return sched


def cosine_decay_steps(learning_rate, total_steps, end_lr=0.0):
    """Continuous cosine over steps (the BERT/ResNet recipes' variant)."""
    def sched(step):
        frac = min(max(float(step) / total_steps, 0.0), 1.0)
        return end_lr + (learning_rate - end_lr) * 0.5 * (
            1 + math.cos(math.pi * frac))
    return sched


def linear_lr_warmup(base_sched, warmup_steps, start_lr, end_lr):
    """Wrap another schedule with linear warmup."""
    if not callable(base_sched):
        base_sched = constant(base_sched)

    def sched(step):
        s = float(step)
        if s < warmup_steps:
            return start_lr + (end_lr - start_lr) * s / warmup_steps
        return base_sched(step)
    return sched
