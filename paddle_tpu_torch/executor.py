"""Executor and Program: the run-a-model facade (``paddle_tpu/executor.py``,
fluid ``executor.py``).

- :class:`Program` wraps a step function ``fn(state, **feeds) ->
  (state, fetches)`` (a train program) or ``fn(state, **feeds) ->
  fetches`` (an inference program; ``state`` may be the model).
- :meth:`Program.compile` gives a :class:`CompiledProgram`, the port's
  counterpart of the reference's ``jax.jit``: a train program with
  ``donate_state`` (its state updated in place, as the port's train
  steps do) runs as one captured CUDA graph per feed signature on the
  card (:class:`~paddle_tpu_torch.train.TrainStepGraphs`; a step from
  ``build_train_step`` is one already) and eagerly on the CPU; any other
  program runs eagerly. With a mesh, a step from ``build_train_step``
  is put on it by :func:`~paddle_tpu_torch.parallel.api.
  shard_train_step`: ``state_shardings`` is the sharding plan (a
  :class:`~paddle_tpu_torch.parallel.plan.ShardingPlan`, default
  replicated), feeds are cut over ("dp", "fsdp") except
  ``replicated_feeds``.
- :class:`Executor` runs programs (``run``), trains over a dataset
  (``train_from_dataset``: the native MultiSlot dataset or a reader
  creator, checkpoints every N steps, ``resume`` fast-forwarding the
  stream, a preemption guard) and infers over one
  (``infer_from_dataset``).

``Executor(lint='warn'|'error', lint_cost=...)`` lints each
:class:`Program` once, against its first run's state and feeds, before
its first dispatch (:mod:`paddle_tpu_torch.analysis`: a trace on fake
tensors, nothing runs); a program is marked linted only after the
report was enforced, so a caught ``LintError`` leaves the gate armed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.observability import registry as _registry

@dataclasses.dataclass
class Program:
    """A step function and how to run it (the ProgramDesc's role).

    ``donate_state``: the program updates its state in place (a train
    program); it is then captured on the card. ``replicated_feeds``:
    feeds every rank takes whole under a mesh (the rest are cut over the
    data axes). ``state_shardings``: the sharding plan of the state under
    a mesh (a ``ShardingPlan``)."""

    fn: Callable
    name: str = "program"
    donate_state: bool = False
    replicated_feeds: Sequence[str] = ()
    state_shardings: Any = None

    def compile(self, mesh=None,
                state_shardings: Any = None) -> "CompiledProgram":
        if state_shardings is None:
            state_shardings = self.state_shardings
        return CompiledProgram(self, mesh, state_shardings)


class CompiledProgram:
    """A program bound to how it runs (module docstring): ``__call__(state,
    **feeds)`` returns what the program returns."""

    def __init__(self, program: Program, mesh=None,
                 state_shardings: Any = None):
        from paddle_tpu_torch.train import TrainStepGraphs
        self.program = program
        self.mesh = mesh
        self.state_shardings = state_shardings
        fn = program.fn
        if isinstance(fn, TrainStepGraphs):
            self._fn = fn
        elif program.donate_state:
            self._fn = TrainStepGraphs(lambda state, batch: fn(state,
                                                               **batch))
        else:
            self._fn = fn
        self._run = None            # the sharded step, once placed
        self._placed_state = None

    def _sharded(self, state, feeds):
        from paddle_tpu_torch.parallel import api
        from paddle_tpu_torch.parallel.plan import P
        if getattr(self._fn, "rebuild", None) is None:
            raise TypeError(
                f"Program {self.program.name!r} under a mesh needs a step "
                "made by train.build_train_step")
        if self._run is None or self._placed_state is not state:
            spec = {k: (P() if k in self.program.replicated_feeds or
                        getattr(v, "ndim", 0) == 0 else api.BATCH_SPEC)
                    for k, v in feeds.items()}
            self._run, self._placed_state = api.shard_train_step(
                self._fn, self.mesh, state, plan=self.state_shardings,
                batch_spec=spec)
        return self._run

    def __call__(self, state, **feeds):
        if self.mesh is not None:
            return self._sharded(state, feeds)(state, **feeds)
        return self._fn(state, **feeds)


def _dataset_batches(dataset, batch_size, feed_builder, drop_last=False):
    """Batches of a native ``MultiSlotDataset`` (its ``batches`` stream)
    or of a reader creator (a callable yielding samples, batched here by
    ``feed_builder(samples) -> feed``, which reader creators need)."""
    if hasattr(dataset, "batches"):
        yield from dataset.batches(batch_size, drop_last=drop_last)
        return
    if feed_builder is None:
        raise ValueError(
            "reader-creator datasets need feed_builder(samples) -> feed "
            "dict (native MultiSlotDataset batches pass through as-is)")
    buf = []
    for sample in dataset():
        buf.append(sample)
        if len(buf) == batch_size:
            yield feed_builder(buf)
            buf = []
    if buf and not drop_last:
        yield feed_builder(buf)      # the trailing partial batch


def _to_numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _device_feeds(feed: Dict[str, Any], device) -> Dict[str, Any]:
    """numpy feeds as tensors on ``device`` (None: as they are)."""
    out = {}
    for k, v in feed.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        if device is not None and isinstance(v, torch.Tensor):
            v = v.to(device, non_blocking=True)
        out[k] = v
    return out


def _state_device(state):
    if isinstance(state, dict) and isinstance(state.get("step"),
                                              torch.Tensor):
        return state["step"].device
    if isinstance(state, torch.nn.Module):
        return next(state.parameters()).device
    return None


class Executor:
    """Feed/fetch runner (fluid ``Executor``: ``run(program, feed,
    fetch_list)``). ``place`` is kept for familiarity; placement is the
    state's device and the mesh's. numpy feeds go to the state's device
    (a port train state's, or a model's). ``lint``/``lint_cost``: the
    static gate (module docstring; ``lint_cost``, a dict of
    :func:`~paddle_tpu_torch.analysis.lint_fn` cost options, adds the
    cost tier to a gate that ``lint`` turns on)."""

    def __init__(self, place=None, mesh=None, lint: str = "off",
                 lint_cost: Optional[Dict[str, Any]] = None):
        if lint not in ("off", "warn", "error"):
            raise ValueError(f"lint must be 'off', 'warn' or 'error', got "
                             f"{lint!r}")
        self.place = place
        self.mesh = mesh
        self.lint = lint
        self.lint_cost = lint_cost
        self._cache: Dict[int, tuple] = {}
        self._linted: set = set()

    def run(self, program, state=None, feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence[str]] = None, return_numpy=True):
        """Run one step: ``(state, fetches)``. ``fetch_list`` selects keys
        of a dict result; ``return_numpy`` copies the fetches to the host
        as numpy arrays (else they stay tensors on the device)."""
        reg = _registry.default()
        if isinstance(program, Program):
            key = id(program)     # the entry holds the Program: no reuse
            if key not in self._cache:
                self._cache[key] = (program, program.compile(self.mesh))
                reg.counter("executor_program_compiles_total",
                            "Program cache misses (new compiled programs)"
                            ).inc(name=program.name)
            cached, compiled = self._cache[key]
            if cached is not program:
                raise RuntimeError("executor cache holds another program")
        else:
            compiled = program
        feed = _device_feeds(feed or {}, _state_device(state))
        if isinstance(program, Program) and self.lint != "off" \
                and key not in self._linted and state is not None:
            # before the first dispatch, once per program; marked only
            # after enforcement, so a caught LintError keeps it armed
            self._lint(program, state, feed)
            self._linted.add(key)
        t0 = time.perf_counter()
        out = compiled(state, **feed)
        reg.counter("executor_run_calls_total").inc()
        reg.histogram("executor_run_seconds",
                      "Executor.run dispatch wall time").observe(
                          time.perf_counter() - t0)
        if isinstance(out, tuple) and len(out) == 2:
            state, fetches = out
        else:
            fetches = out
        if fetch_list and isinstance(fetches, dict):
            fetches = {k: fetches[k] for k in fetch_list}
        if return_numpy:
            fetches = _to_numpy(fetches)
        return state, fetches

    def _lint(self, program: Program, state, feed):
        """Static analysis of ``program.fn`` against this run's state and
        feeds (:mod:`paddle_tpu_torch.analysis`); 'warn' warns, 'error'
        raises :class:`~paddle_tpu_torch.analysis.LintError` on
        error-severity findings. A ``donate_state`` program's state is
        the state it updates in place (the undonated-buffer rule reads
        it); an inference program's is only read."""
        from paddle_tpu_torch import analysis
        cost_kw = dict(self.lint_cost, cost=True) \
            if self.lint_cost is not None else {}
        if not program.donate_state:
            cost_kw["state_argnum"] = None
        report = analysis.lint_train_step(program.fn, state, feed,
                                          name=program.name, **cost_kw)
        analysis.enforce(report, self.lint)
        return report

    def train_from_dataset(self, program, dataset, state, *,
                           batch_size=64, epochs=1, feed_builder=None,
                           fetch_handler=None, run_log=None,
                           checkpoint_dir=None, checkpoint_every=0,
                           resume=False, preemption_guard=None):
        """Train ``program`` over every batch of ``dataset`` for
        ``epochs`` (fluid ``train_from_dataset``): a native MultiSlot
        dataset's batches or a reader creator's, batched by
        ``feed_builder``; the ragged last batch is dropped (a new shape
        would capture a graph for one step). ``fetch_handler(step,
        fetches)`` sees each step's fetches (tensors on the device);
        ``run_log`` writes one JSONL record a step.

        ``state`` is a port train state (``{"model", "opt", "step", ...}``).
        ``checkpoint_dir`` snapshots it every ``checkpoint_every`` dataset
        steps (``io.CheckpointManager``); ``resume=True`` restores the
        newest valid snapshot into the state's tensors, in place, and
        fast-forwards the (deterministic) stream past the steps it holds.
        ``preemption_guard`` (``resilience.PreemptionGuard``), once
        triggered, saves the state after the step in flight and exits
        with ``resilience.EXIT_PREEMPTED``. Returns ``(state, last
        fetches)``."""
        from paddle_tpu_torch import io as io_lib
        from paddle_tpu_torch.observability.telemetry import StepTelemetry
        from paddle_tpu_torch.trainer import load_state_tree, state_tree
        fetches = None
        step_i = start_step = 0
        mgr = None
        if checkpoint_dir is not None:
            mgr = io_lib.CheckpointManager(
                checkpoint_dir, save_interval_steps=max(1, checkpoint_every))
            if resume:
                # one verified scan decides the resume point
                manifest = mgr.latest_valid_manifest()
                if manifest is not None:
                    start_step = int(manifest["step"])
                    load_state_tree(state, mgr.restore(
                        start_step, target=state_tree(state)))
        tel = StepTelemetry("executor_dataset", run_log=run_log,
                            run_meta={"batch_size": batch_size,
                                      "epochs": epochs})
        try:
            for epoch in range(epochs):
                it = iter(_dataset_batches(dataset, batch_size,
                                           feed_builder, drop_last=True))
                while True:
                    t_fetch = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        break
                    if step_i < start_step:
                        step_i += 1      # a step the snapshot holds
                        continue
                    tel.data_wait(time.perf_counter() - t_fetch)
                    t_step = time.perf_counter()
                    state, fetches = self.run(program, state, feed=batch,
                                              return_numpy=False)
                    step_i += 1
                    tel.step(step_i, feeds=batch,
                             step_time_s=time.perf_counter() - t_step,
                             examples=batch_size, epoch=epoch)
                    if fetch_handler is not None:
                        fetch_handler(step_i - 1, fetches)
                    if mgr is not None and checkpoint_every \
                            and step_i % checkpoint_every == 0:
                        mgr.save(step_i, state_tree(state))
                    if preemption_guard is not None \
                            and preemption_guard.triggered:
                        if mgr is not None:
                            mgr.save(step_i, state_tree(state), wait=True,
                                     force=True)
                        preemption_guard.exit()
        finally:
            tel.close()
            if mgr is not None:
                mgr.wait()
                mgr.close()
        return state, fetches

    def infer_from_dataset(self, program, dataset, state, *,
                           batch_size=64, feed_builder=None):
        """A forward-only pass (fluid ``infer_from_dataset``): each
        batch's fetches as numpy, in a list."""
        outs = []
        for batch in _dataset_batches(dataset, batch_size, feed_builder):
            _, fetches = self.run(program, state, feed=batch,
                                  return_numpy=True)
            outs.append(fetches)
        return outs

    def close(self):
        self._cache.clear()


__all__ = ["CompiledProgram", "Executor", "Program"]
