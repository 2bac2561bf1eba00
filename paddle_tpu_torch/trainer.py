"""Training loop (``paddle_tpu/trainer.py``, subset): epochs, steps,
logging, hooks, evaluation and prediction over a train step built by
:func:`paddle_tpu_torch.train.build_train_step`.

Every step lands in a :class:`~paddle_tpu_torch.observability.MetricsRegistry`:
``train_step_seconds`` (host clock around the step call; on CUDA that is
the launch time unless the launch queue is full, so a rate over a run is
taken from wall time ending in a synchronise), ``train_steps_total``,
``train_examples_total`` and ``train_tokens_total`` (examples x sequence
length for 2-D integer feeds). Checkpointing, the lint gate, preemption
and step telemetry are not ported (see ROADMAP).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Optional

import torch

from paddle_tpu_torch import observability


class Trainer:
    """Epoch/step driver. ``train_step(state, **batch) -> (state,
    metrics)``; ``hooks`` are called as ``hook(trainer, n, metrics)``
    after each step (``n`` counts steps within the epoch)."""

    def __init__(self, train_step: Callable, state: Dict[str, Any], *,
                 log_every: int = 100,
                 log_fn: Callable[[str], None] = print,
                 hooks: Iterable[Callable] = (),
                 registry: Optional[observability.MetricsRegistry] = None):
        self.train_step = train_step
        self.state = state
        self.log_every = log_every
        self.log_fn = log_fn
        self.hooks = list(hooks)
        self.registry = registry if registry is not None \
            else observability.default()

    @property
    def step_count(self) -> int:
        return int(self.state["step"])

    def fit(self, data_iter: Iterable[Dict[str, Any]], *, epochs: int = 1,
            steps_per_epoch: Optional[int] = None,
            make_iter: Optional[Callable] = None) -> Dict[str, float]:
        """Train over batches (feed dicts). ``make_iter`` re-creates the
        iterator for each epoch; ``steps_per_epoch`` caps an epoch.
        Returns the last step's metrics as floats."""
        if epochs > 1 and make_iter is None and not hasattr(
                data_iter, "__len__"):
            raise ValueError(
                "epochs > 1 with a one-shot iterator: pass make_iter= so "
                "each epoch gets a fresh pass over the data")
        reg = self.registry
        step_s = reg.histogram("train_step_seconds",
                               "host time of one train-step call")
        steps = reg.counter("train_steps_total", "train steps taken")
        examples = reg.counter("train_examples_total", "examples trained on")
        tokens = reg.counter("train_tokens_total",
                             "tokens trained on (2-D integer feeds)")
        last: Dict[str, float] = {}
        gstep = self.step_count
        for epoch in range(epochs):
            it = iter(make_iter() if make_iter is not None else data_iter)
            t0 = time.perf_counter()
            n = 0
            metrics: Dict[str, Any] = {}
            for batch in it:
                t_step = time.perf_counter()
                self.state, metrics = self.train_step(self.state, **batch)
                step_s.observe(time.perf_counter() - t_step)
                n += 1
                gstep += 1
                steps.inc()
                ex, tok = _batch_counts(batch)
                examples.inc(ex)
                if tok:
                    tokens.inc(tok)
                if self.log_every and n % self.log_every == 0:
                    last = _floats(metrics)
                    rate = n / (time.perf_counter() - t0)
                    self.log_fn(f"[trainer] epoch {epoch} step {gstep} "
                                f"{_fmt(last)} ({rate:.2f} it/s)")
                for hook in self.hooks:
                    hook(self, n, metrics)
                if steps_per_epoch and n >= steps_per_epoch:
                    break
            if n == 0:
                raise ValueError(
                    f"epoch {epoch} yielded no batches (exhausted "
                    "iterator? pass make_iter= for multi-epoch runs)")
            last = _floats(metrics)
            self.log_fn(f"[trainer] epoch {epoch} done: {_fmt(last)}")
        return last

    def evaluate(self, eval_step: Callable,
                 data_iter: Iterable[Dict[str, Any]]):
        """Run ``eval_step(model, **batch)`` over batches and return the
        outputs."""
        outs = []
        hist = self.registry.histogram("eval_step_seconds",
                                       "per-batch eval wall time")
        count = self.registry.counter("eval_steps_total", "eval steps")
        model = self.state["model"]
        for batch in data_iter:
            t0 = time.perf_counter()
            out = eval_step(model, **batch)
            hist.observe(time.perf_counter() - t0)
            count.inc()
            outs.append(out)
        return outs

    def predict(self, predict_step: Callable,
                data_iter: Iterable[Dict[str, Any]]):
        """Forward-only pass collecting host numpy outputs per batch."""
        model = self.state["model"]
        return [_to_host(predict_step(model, **batch)) for batch in data_iter]


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _floats(metrics: Dict[str, Any]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def _fmt(metrics: Dict[str, float]) -> str:
    return " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))


def _batch_counts(batch: Dict[str, Any]):
    """(examples, tokens) of one feed dict: examples is the first axis of
    the first tensor; tokens is B x T over (B, T) integer feeds, else
    None."""
    leaves = [x for x in batch.values()
              if isinstance(x, torch.Tensor) and x.ndim >= 1]
    if not leaves:
        return 0, None
    examples = int(leaves[0].shape[0])
    tokens = None
    for x in leaves:
        if x.ndim == 2 and not x.is_floating_point() and x.dtype != torch.bool:
            tokens = max(tokens or 0, int(x.shape[0]) * int(x.shape[1]))
    return examples, tokens
