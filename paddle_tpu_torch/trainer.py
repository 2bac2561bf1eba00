"""Training loop (``paddle_tpu/trainer.py``): epochs, steps, logging,
hooks, step telemetry, checkpointing with resume, preemption, evaluation
and prediction over a train step built by
:func:`paddle_tpu_torch.train.build_train_step` (or
:func:`paddle_tpu_torch.amp.scaled_train_step`).

Checkpoints hold the reference's tree (:func:`state_tree`):
``{"params", "opt": {"step", "slots": {slot: params-like tree}}, "step"}``
(and ``"loss_scale"``), named as the reference names the model's
parameters, so a float32 checkpoint written by either package's
``Trainer`` resumes in the other.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import torch

from paddle_tpu_torch import io as io_lib
from paddle_tpu_torch import observability
from paddle_tpu_torch.models.convert import params_tree
from paddle_tpu_torch.optimizer import LookaheadOptimizer


def _opt_tree(opt, model) -> dict:
    """The reference's optimizer state: ``{"step", "slots"}`` (a
    Lookahead: ``{"inner", "slow"}``)."""
    named = list(model.named_parameters())
    if isinstance(opt, LookaheadOptimizer):
        slow = dict(zip(opt.params(), opt.slow))
        return {"inner": _opt_tree(opt.inner, model),
                "slow": params_tree(model, {n: slow[p] for n, p in named})}
    missing = [n for n, p in named if p not in opt.state]
    if missing:
        raise ValueError(f"the optimizer does not hold parameters "
                         f"{missing[:3]} of the model; a checkpoint needs "
                         "every parameter's slots")
    return {"step": opt.state_step,
            "slots": {s: params_tree(model, {n: opt.state[p][s]
                                             for n, p in named})
                      for s in opt.SLOTS}}


def state_tree(state: Mapping[str, Any]) -> dict:
    """A port train state ``{model, opt, step[, loss_scale]}`` as the
    reference's state tree, its leaves the live tensors (no copy)."""
    model = state["model"]
    tree = {"params": params_tree(model),
            "opt": _opt_tree(state["opt"], model),
            "step": state["step"]}
    if "loss_scale" in state:
        tree["loss_scale"] = dict(state["loss_scale"])
    return tree


def load_state_tree(state: Mapping[str, Any], tree: Mapping[str, Any]):
    """Write a restored tree (:func:`state_tree`'s layout, host tensors)
    into the live state's tensors, in place, so a captured train step
    keeps replaying on them. A parameter whose dtype changed (AdamW's
    float32 promotion of a bf16 parameter) takes the restored dtype."""
    def walk(live, got, path):
        for k, t in live.items():
            if isinstance(t, Mapping):
                walk(t, got[k], path + (k,))
            elif t.dtype == got[k].dtype:
                with torch.no_grad():
                    t.copy_(got[k])
            elif isinstance(t, torch.nn.Parameter):
                t.data = got[k].to(t.device)
            else:
                raise ValueError(f"{'/'.join(path + (k,))}: checkpoint "
                                 f"dtype {got[k].dtype}, state {t.dtype}")
    walk(state_tree(state), tree, ())


class Trainer:
    """Epoch/step driver. ``train_step(state, **batch) -> (state,
    metrics)``; ``hooks`` are called as ``hook(trainer, n, metrics)``
    after each step (``n`` counts steps within the epoch).

    Telemetry: every ``fit`` drives a
    :class:`~paddle_tpu_torch.observability.StepTelemetry` (step time,
    examples/s and tokens/s, the data-wait split, a recompile detector
    over graph captures, periodic device-memory gauges) in ``registry``
    (the process default unless given); ``run_log=`` also writes one JSONL
    record per step; ``telemetry=False`` turns it off.

    Resilience: ``checkpoint_dir`` saves through the snapshot engine
    every ``checkpoint_every`` global steps (labelled with the state's
    true step, which a skipped AMP step does not advance), keeps
    ``keep_checkpoints``, and forces a final save at the end of ``fit``;
    :meth:`restore` resumes from the newest *valid* snapshot, falling back
    past torn or corrupt saves. ``preemption_guard=`` makes ``fit`` take
    an emergency snapshot after the step in flight when the guard trips,
    and exit with ``resilience.EXIT_PREEMPTED``."""

    def __init__(self, train_step: Callable, state: Dict[str, Any], *,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1000,
                 keep_checkpoints: int = 3,
                 log_every: int = 100,
                 log_fn: Callable[[str], None] = print,
                 hooks: Iterable[Callable] = (),
                 run_log: Optional[str] = None,
                 telemetry: bool = True,
                 tokens_per_example: Optional[int] = None,
                 preemption_guard=None,
                 registry: Optional[observability.MetricsRegistry] = None):
        self.train_step = train_step
        self.state = state
        self.log_every = log_every
        self.log_fn = log_fn
        self.hooks = list(hooks)
        self.checkpoint_every = checkpoint_every
        self.run_log = run_log
        self.telemetry = telemetry
        self.tokens_per_example = tokens_per_example
        self.preemption_guard = preemption_guard
        self.registry = registry if registry is not None \
            else observability.default()
        self.manager = None
        if checkpoint_dir is not None:
            self.manager = io_lib.CheckpointManager(
                checkpoint_dir, max_to_keep=keep_checkpoints,
                save_interval_steps=checkpoint_every)

    # -- resume ------------------------------------------------------------
    def restore(self) -> int:
        """Resume from the newest VALID checkpoint if one exists (torn or
        corrupt saves are skipped), writing it into the state's tensors in
        place. Returns the restored step (0 if none)."""
        if self.manager is None:
            return 0
        step = self.manager.latest_step()
        if step is None:
            return 0
        restored = self.manager.restore(step, target=state_tree(self.state))
        load_state_tree(self.state, restored)
        step = self.step_count
        self.log_fn(f"[trainer] resumed from step {step}")
        return step

    @property
    def step_count(self) -> int:
        return int(self.state["step"])

    # -- loops -------------------------------------------------------------
    def fit(self, data_iter: Iterable[Dict[str, Any]], *, epochs: int = 1,
            steps_per_epoch: Optional[int] = None,
            make_iter: Optional[Callable] = None,
            lint: str = "off",
            lint_cost: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
        """Train over batches (feed dicts). ``make_iter`` re-creates the
        iterator for each epoch; ``steps_per_epoch`` caps an epoch.
        Returns the last step's metrics as floats.

        ``lint='warn'|'error'`` statically analyzes the train step against
        epoch 0's first batch before any step runs
        (:mod:`paddle_tpu_torch.analysis`: a trace on fake tensors, so no
        kernel launches and no state moves; host syncs, float64, state
        not updated in place, re-seeded generators, tensor branches);
        ``'warn'`` logs findings, ``'error'`` raises
        :class:`~paddle_tpu_torch.analysis.LintError` on error-severity
        ones. ``lint_cost`` adds the cost tier to the same gate: a dict of
        :func:`~paddle_tpu_torch.analysis.lint_fn` cost options, e.g.
        ``{"hbm_budget_bytes": 2 << 30, "collective_allowlist": []}``
        (unexpected collectives, resharding round trips, the peak-memory
        and flops budgets; ``{}`` for the cost report alone), read when
        ``lint`` is on."""
        if lint not in ("off", "warn", "error"):
            raise ValueError(f"lint must be 'off', 'warn' or 'error', got "
                             f"{lint!r}")
        if epochs > 1 and make_iter is None and not hasattr(
                data_iter, "__len__"):
            raise ValueError(
                "epochs > 1 with a one-shot iterator: pass make_iter= so "
                "each epoch gets a fresh pass over the data")
        last_metrics: Dict[str, float] = {}
        tel = None
        if self.telemetry:
            tel = observability.StepTelemetry(
                "train", run_log=self.run_log, run_meta={"epochs": epochs},
                registry=self.registry, log_fn=self.log_fn,
                memory_every=self.log_every or 50,
                aggregate_every=self.log_every)
        # host-mirrored global step: one device read here, none per step
        gstep = self.step_count
        try:
            with observability.tracing.default().span(
                    "trainer.fit", epochs=epochs, start_step=gstep):
                last_metrics = self._fit_epochs(
                    epochs, data_iter, make_iter, steps_per_epoch, tel,
                    gstep, lint, lint_cost)
        finally:
            if tel is not None:
                tel.close(summary={"metrics": last_metrics})
        if self.manager is not None:
            last = self.step_count
            if self.manager.last_saved_step != last:
                self.manager.save(last, state_tree(self.state), wait=True,
                                  force=True)
            else:
                self.manager.wait()
        return last_metrics

    def _fit_epochs(self, epochs, data_iter, make_iter, steps_per_epoch,
                    tel, gstep, lint="off", lint_cost=None):
        last_metrics: Dict[str, float] = {}
        metrics: Dict[str, Any] = {}
        for epoch in range(epochs):
            it = iter(make_iter() if make_iter is not None else data_iter)
            t0 = time.perf_counter()
            n = 0
            while True:
                t_fetch = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                data_wait_s = time.perf_counter() - t_fetch
                if lint != "off" and epoch == 0 and n == 0:
                    # ahead-of-time gate on the real first batch (a trace
                    # on fake tensors: nothing runs); data_wait was taken
                    # above, so the trace is not booked as an input stall
                    self._lint(batch, lint, lint_cost)
                if tel is not None:
                    tel.data_wait(data_wait_s)
                t_step = time.perf_counter()
                self.state, metrics = self.train_step(self.state, **batch)
                step_time_s = time.perf_counter() - t_step
                n += 1
                gstep += 1
                tracer = observability.tracing.default()
                if tracer.enabled:
                    tracer.record_span("trainer.step",
                                       duration_s=step_time_s,
                                       step=gstep, epoch=epoch,
                                       data_wait_s=round(data_wait_s, 6))
                if tel is not None:
                    ex, tok = _batch_counts(batch, self.tokens_per_example)
                    tel.step(gstep, feeds=batch, step_time_s=step_time_s,
                             examples=ex, tokens=tok, epoch=epoch)
                if self.log_every and n % self.log_every == 0:
                    last_metrics = _floats(metrics)
                    rate = n / (time.perf_counter() - t0)
                    self.log_fn(f"[trainer] epoch {epoch} step {gstep} "
                                f"{_fmt(last_metrics)} ({rate:.2f} it/s)")
                # gate on the GLOBAL step so epochs shorter than
                # checkpoint_every still checkpoint across epochs
                if self.manager is not None \
                        and gstep % self.checkpoint_every == 0:
                    # label with the TRUE state step (a skipped AMP step
                    # does not advance it); one device read per checkpoint
                    gstep = self.step_count
                    self.manager.save(gstep, state_tree(self.state))
                for hook in self.hooks:
                    hook(self, n, metrics)
                if self.preemption_guard is not None \
                        and self.preemption_guard.triggered:
                    self._emergency_snapshot()
                    self.preemption_guard.exit()
                if steps_per_epoch and n >= steps_per_epoch:
                    break
            if n == 0:
                raise ValueError(
                    f"epoch {epoch} yielded no batches (exhausted "
                    "iterator? pass make_iter= for multi-epoch runs)")
            last_metrics = _floats(metrics)
            self.log_fn(f"[trainer] epoch {epoch} done: {_fmt(last_metrics)}")
        return last_metrics

    def _lint(self, batch: Dict[str, Any], mode: str, lint_cost=None):
        """Static analysis of the train step against one batch
        (:mod:`paddle_tpu_torch.analysis`); 'warn' logs, 'error' raises.
        ``lint_cost`` (a dict of cost options) adds the cost tier."""
        from paddle_tpu_torch import analysis
        cost_kw = dict(lint_cost, cost=True) if lint_cost is not None \
            else {}
        report = analysis.lint_train_step(self.train_step, self.state,
                                          batch, **cost_kw)
        analysis.enforce(report, mode, log_fn=self.log_fn)
        return report

    def _emergency_snapshot(self):
        """Forced synchronous snapshot of the current state (the
        preemption path); a no-op without a checkpoint manager."""
        if self.manager is None:
            return
        step = self.step_count
        self.manager.save(step, state_tree(self.state), wait=True,
                          force=True)
        self.log_fn(f"[trainer] emergency snapshot at step {step}")

    def evaluate(self, eval_step: Callable,
                 data_iter: Iterable[Dict[str, Any]],
                 metrics: Optional[Dict[str, Any]] = None):
        """Run ``eval_step(model, **batch)`` over batches and return the
        outputs; with ``metrics`` (``{name: (metric, extractor)}``, a
        :mod:`paddle_tpu_torch.metrics` object and ``extractor(out,
        batch) -> update args``) stream each batch into its metric and
        return ``{name: metric.eval()}`` instead. With telemetry on, each
        batch lands in ``eval_step_seconds``, ``eval_steps_total`` and
        ``eval_examples_total``."""
        outs = []
        reg = self.registry if self.telemetry else None
        model = self.state["model"]
        for batch in data_iter:
            t0 = time.perf_counter()
            out = eval_step(model, **batch)
            if reg is not None:
                reg.histogram("eval_step_seconds",
                              "per-batch eval wall time").observe(
                                  time.perf_counter() - t0)
                reg.counter("eval_steps_total").inc()
                ex, _ = _batch_counts(batch, None)
                reg.counter("eval_examples_total").inc(ex)
            if metrics:
                for name, (metric, extract) in metrics.items():
                    metric.update(*extract(out, batch))
            else:
                outs.append(out)
        if metrics:
            return {name: m.eval() for name, (m, _) in metrics.items()}
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


def _batch_counts(batch: Dict[str, Any], tokens_per_example=None):
    """(examples, tokens) of one feed dict: examples is the first axis of
    the first tensor; tokens is examples x ``tokens_per_example`` when
    given, else B x T over (B, T) integer feeds, else None."""
    leaves = [x for x in batch.values()
              if isinstance(x, torch.Tensor) and x.ndim >= 1]
    if not leaves:
        return 0, None
    examples = int(leaves[0].shape[0])
    if tokens_per_example is not None:
        return examples, examples * int(tokens_per_example)
    tokens = None
    for x in leaves:
        if x.ndim == 2 and not x.is_floating_point() and x.dtype != torch.bool:
            tokens = max(tokens or 0, int(x.shape[0]) * int(x.shape[1]))
    return examples, tokens
