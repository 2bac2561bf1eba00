"""Train-step builder (``paddle_tpu/train.py``): forward, backward,
gradient accumulation, mixed-precision casts, rematerialisation and the
optimizer as one call, captured once per batch signature as a CUDA graph
on the card.

The step keeps the reference's shape, ``step(state, **batch) -> (state,
metrics)``, but PyTorch is eager and stateful: the step updates the
model's parameters and the optimizer's slots **in place** and returns the
same ``state`` dict, its ``step`` (an int32 0-d tensor on the model's
device, as the reference's) advanced in place (the reference returns a
new state and donates the old one). Metrics are 0-d tensors on the
model's device, so a step does not wait for the device; read them with
``float()`` when needed.

``cuda_graphs=True`` (the default) is the port's counterpart of ``jit``:
on the card, the whole step (forward, backward through the flash kernels,
clipping, the optimizer) is captured once per batch signature (every
feed's name, shape, dtype and device) and replayed from then on
(:class:`TrainStepGraphs`). On the CPU, and with ``cuda_graphs=False``,
every call runs eagerly.

``sharding=`` puts the step on a mesh (what
:func:`paddle_tpu_torch.parallel.api.shard_train_step` passes): the
forward reads the parameters through it (FSDP gathers its shards there),
the loss runs under its mesh, and its gradient hook runs between the
backward and the update (the all-reduce or reduce-scatter over the data
axes). A step with collectives in it runs eagerly: a graphed one raises
(:meth:`TrainStepGraphs.check_capturable`).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch import nn

from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.core.device import counted_capture, note_replay
from paddle_tpu_torch.nn.module import active_tape, capture_state, use_tape
from paddle_tpu_torch.observability import recompile


def make_train_state(model: nn.Module, optimizer) -> Dict[str, Any]:
    """``{"model", "opt", "step"}``. The model holds the parameters
    (already initialised from its seed); ``opt`` is the optimizer over
    them; ``step`` an int32 0-d tensor on the model's device."""
    device = next(model.parameters()).device
    return {"model": model, "opt": optimizer,
            "step": torch.zeros((), dtype=torch.int32, device=device)}


class _LossModule(nn.Module):
    """Lets ``torch.func.functional_call`` run ``loss_fn(model, **batch)``
    with the model's parameters swapped for their compute-dtype casts."""

    def __init__(self, model, loss_fn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, *args, **batch):
        return self.loss_fn(self.model, *args, **batch)


def _policy_call(fn: Callable, model: nn.Module,
                 policy: Optional[dtypes.Policy], batch: Mapping,
                 views: Optional[Callable] = None):
    """``fn(model, **batch)``; under a policy, the parameters enter as
    differentiable casts to its compute dtype (the fp32 masters get the
    gradients), and so do the floating buffers (BatchNorm's running
    statistics, as the reference's policy casts its whole tree: an eval
    forward stays in the compute dtype; the tape still writes the fp32
    masters) and the floating feeds. ``views(name, p)``, where given, is
    the tensor the forward reads for parameter ``p`` (a sharded step's
    gathered parameter), cast after it is taken."""
    if policy is None and views is None:
        return fn(model, **batch)
    if policy is not None:
        batch = policy.cast_to_compute(dict(batch))
    params = {}
    for n, p in model.named_parameters():
        t = p if views is None else views(n, p)
        params[f"model.{n}"] = t if policy is None \
            else policy.cast_to_compute(t)
    if policy is not None:
        for n, b in model.named_buffers():
            if b.is_floating_point():
                params[f"model.{n}"] = policy.cast_to_compute(b)
    return torch.func.functional_call(_LossModule(model, fn), params,
                                      args=(), kwargs=batch)


def _remat_call(fn: Callable, model: nn.Module,
                policy: Optional[dtypes.Policy], batch: Mapping,
                views: Optional[Callable] = None):
    """:func:`_policy_call` under ``torch.utils.checkpoint`` (non-
    reentrant): its activations are recomputed in the backward. The feeds
    go in as the checkpoint's arguments, so it saves and restores the RNG
    state of their device and dropout draws the same masks twice. The
    recompute reports running state to the tape that was active when the
    forward ran (on the card autograd runs it on a thread of its own)."""
    from torch.utils import checkpoint

    keys = list(batch)
    tape = active_tape()

    def run(*values):
        with use_tape(tape):
            return _policy_call(fn, model, policy, dict(zip(keys, values)),
                                views)

    return checkpoint.checkpoint(run, *batch.values(), use_reentrant=False)


def _split(batch: Mapping, n: int):
    """Cut every feed tensor into ``n`` micro-batches along its first
    axis (which must divide)."""
    for key, val in batch.items():
        if val.shape[0] % n:
            raise ValueError(f"batch axis of {key!r} ({val.shape[0]}) is "
                             f"not divisible by grad_accum_steps={n}")
    return [dict(zip(batch, parts))
            for parts in zip(*(v.chunk(n) for v in batch.values()))]


def _signature(batch: Mapping) -> tuple:
    return tuple(sorted(
        (k, tuple(v.shape), v.dtype, v.device)
        if isinstance(v, torch.Tensor) else (k, repr(v))
        for k, v in batch.items()))


def _layout(state: Mapping) -> tuple:
    """Every tensor a train step reads from its state, as (object id, data
    pointer, dtype, shape): the model's parameters and buffers, the
    optimizer's parameters and state tensors, and the state's own tensors
    (its step, the loss scale's)."""
    tensors = []
    for v in state.values():
        if isinstance(v, nn.Module):
            tensors += list(v.parameters()) + list(v.buffers())
        elif hasattr(v, "state_tensors"):
            tensors += list(v.params()) + list(v.state_tensors())
        elif isinstance(v, torch.Tensor):
            tensors.append(v)
        elif isinstance(v, Mapping):
            tensors += [t for t in v.values() if isinstance(t, torch.Tensor)]
    return tuple((id(t), t.data_ptr(), t.dtype, tuple(t.shape))
                 for t in tensors)


class _Captured:
    """One batch signature's graph, static feeds and static metrics."""

    def __init__(self, graph, feeds, metrics, launches):
        self.graph = graph
        self.feeds = feeds
        self.metrics = metrics
        #: kernel launches one replay makes, by registry entry
        self.launches = launches

    def replay(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        for k, v in batch.items():
            if isinstance(v, torch.Tensor):
                self.feeds[k].copy_(v, non_blocking=True)
        self.graph.replay()
        note_replay(self.launches)
        # the static metrics are overwritten by the next replay
        return {k: v.clone() for k, v in self.metrics.items()}


class TrainStepGraphs:
    """An eager train step ``step(state, batch) -> (state, metrics)``
    served through one captured CUDA graph per batch signature.

    A graph reads and writes the tensors it was captured on, so the step
    must keep its state on the device and write it in place (the
    parameters, the optimizer's slots and step, ``state["step"]``). The
    port's optimizers do, once the state's dtypes have settled: following
    the reference's promotion, a lower-precision parameter or slot may
    become float32 in the first steps (bf16 parameters under Momentum: the
    parameter at step 1, the velocity at step 2), and then it is a new
    tensor. So a signature's calls run eagerly, as real steps, on a side
    stream (PyTorch's warm-up before a capture), until one leaves the
    state's tensors as it found them (:func:`_layout`: the same objects,
    storage, dtypes and shapes); the next call copies the feeds into
    static buffers, captures the step into a graph
    (:func:`~paddle_tpu_torch.core.device.counted_capture`:
    "thread_local" mode, cycle collector paused, the kernel launches of
    one replay) and replays it; every later call copies the feeds in and
    replays. So the trajectory is the eager one. A step that still
    changes the state after ``MAX_WARM`` eager calls, or changes it while
    it is captured, raises. All graphs share one memory pool. Each capture
    counts as one build, process-wide
    (:func:`~paddle_tpu_torch.observability.recompile.note_capture`); its
    launch counts are process-wide (the backward launches from autograd's
    threads), so a capture must not overlap another thread's kernel
    launches. A capture that fails raises, and so does every later build:
    nothing falls back to eager dispatch (after a failed capture PyTorch
    may leave its allocator and the default CUDA generator in capture
    mode, so the process should not train on).

    Every replay checks that the state's tensors are still those the
    graphs were captured on, and raises if not: a call with another
    state, or a restore that replaced a tensor (a restore writes into the
    state's tensors, :meth:`Trainer.restore
    <paddle_tpu_torch.trainer.Trainer.restore>`). With ``enabled=False``,
    or for a state on the CPU, every call runs eagerly. ``loss_fn``, the
    loss function :func:`build_train_step` (or ``scaled_train_step``)
    made the step from, is what the analysis tiers' source lint reads
    beside the step."""

    #: eager calls of one signature that may change the state's tensors
    MAX_WARM = 4

    def __init__(self, step: Callable, enabled: bool = True,
                 collectives: Optional[str] = None, rebuild=None,
                 loss_fn: Optional[Callable] = None):
        self.step = step
        self.loss_fn = loss_fn
        self.enabled = enabled
        #: the backend of the collectives the step holds, or None
        self.collectives = collectives
        self._rebuild = rebuild
        self.pool = None
        self.builds = 0
        self._graphs: Dict[tuple, _Captured] = {}
        self._warm_calls: Dict[tuple, int] = {}
        self._settled = set()
        self._side = None
        self._failed: Optional[BaseException] = None
        self._layout = None

    def rebuild(self, **changes) -> "TrainStepGraphs":
        """The same step built again by :func:`build_train_step` with
        ``changes`` to its arguments (a sharded step's ``sharding=``)."""
        if self._rebuild is None:
            raise TypeError("this step was not made by build_train_step")
        return self._rebuild(**changes)

    def check_capturable(self):
        """Raise if the step holds collectives: a gloo collective cannot
        be captured in a CUDA graph, and captured NCCL collectives across
        cards are ROADMAP's "NCCL across cards". Such a step runs eagerly
        (``cuda_graphs=False``)."""
        if self.collectives is not None:
            raise ValueError(
                f"the train step holds {self.collectives} collectives, "
                "which a CUDA graph cannot capture (captured NCCL "
                "collectives across cards are ROADMAP's \"NCCL across "
                "cards\"); "
                "build it with cuda_graphs=False")

    def __call__(self, state, **batch):
        device = state["step"].device
        if not (self.enabled and device.type == "cuda"):
            return self.step(state, batch)
        self.check_capturable()
        sig = _signature(batch)
        cap = self._graphs.get(sig)
        if cap is None:
            if sig not in self._settled:
                return self._warm(device, sig, state, batch)
            cap = self._graphs[sig] = self._capture(state, batch)
        else:
            self._check(state)
        return state, cap.replay(batch)

    def _check(self, state):
        if _layout(state) != self._layout:
            raise ValueError("the train state's tensors are not those the "
                             "step was captured on (another state, or a "
                             "tensor replaced); build a new step for them")

    def _warm(self, device, sig, state, batch):
        n = self._warm_calls[sig] = self._warm_calls.get(sig, 0) + 1
        before = _layout(state)
        cur = torch.cuda.current_stream(device)
        if self._side is None:
            self._side = torch.cuda.Stream(device)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            out = self.step(state, batch)
        cur.wait_stream(self._side)
        if _layout(state) == before:
            self._settled.add(sig)
        elif n >= self.MAX_WARM:
            raise RuntimeError(f"the train step replaced state tensors in "
                               f"each of {n} eager calls; it cannot be "
                               "captured")
        return out

    def _capture(self, state, batch) -> _Captured:
        self.check_capturable()
        if self._failed is not None:
            raise RuntimeError("cannot capture the train step: an earlier "
                               "capture failed") from self._failed
        device = state["step"].device
        feeds = {k: v.to(device, copy=True) if isinstance(v, torch.Tensor)
                 else v for k, v in batch.items()}
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        recompile.note_capture()
        self.builds += 1
        if self._layout is not None:
            self._check(state)
        before = _layout(state)
        graph = torch.cuda.CUDAGraph()
        try:
            (_, metrics), launches = counted_capture(
                graph, lambda: self.step(state, feeds), pool=self.pool,
                process_wide=True)
            if _layout(state) != before:
                raise RuntimeError("the train step replaced state tensors "
                                   "while it was captured: the graph would "
                                   "read stale ones")
        except Exception as e:
            self._failed = e
            raise
        self._layout = before
        return _Captured(graph, feeds, metrics, launches)


def build_train_step(
    loss_fn: Callable,
    optimizer,
    *,
    policy: Optional[dtypes.Policy] = None,
    trainable_mask: Optional[Mapping[str, bool]] = None,
    grad_accum_steps: int = 1,
    remat: bool = False,
    cuda_graphs: bool = True,
    sharding=None,
) -> Callable:
    """Build ``step(state, **batch) -> (state, metrics)``.

    ``loss_fn(model, **batch)`` returns a scalar loss or ``(loss,
    aux_dict)``. ``policy`` casts parameters and floating feeds to its
    compute dtype for the forward; gradients arrive in the parameters'
    dtype (fp32 master weights). ``trainable_mask`` maps parameter names
    to bools: False leaves that parameter untouched by the optimizer.
    ``grad_accum_steps > 1`` splits the batch into micro-batches and
    averages their gradients (sum, then divide, as the reference does);
    the loss and aux metrics are the micro-batches' means. Every forward
    (each micro-batch's, and the remat recompute in the backward) runs
    under ``nn.module.capture_state``: it reads the running statistics
    as the step found them, and after the optimizer's update the step
    writes the last value recorded for each buffer (the last
    micro-batch's), in place, as the reference's state tape does. ``remat``
    recomputes the loss function's activations in the backward
    (``torch.utils.checkpoint``, non-reentrant): the same losses and
    gradients for less memory. ``cuda_graphs`` captures the step on the
    card (:class:`TrainStepGraphs`). ``sharding`` is a sharded step's
    placement (module docstring): it gives the forward's parameter
    ``views``, what the forward's graph saves of them (``saving()``, a
    context around each forward), the loss's ``mesh``, the gradient hook
    ``sync_grads(model)`` and ``metrics(dict)``, the metrics over the
    data axes."""
    if grad_accum_steps < 1:
        raise ValueError("grad_accum_steps must be >= 1")
    call = _remat_call if remat else _policy_call
    views = sharding.views if sharding is not None else None

    def forward_backward(model, batch):
        with (sharding.saving() if sharding is not None
              else contextlib.nullcontext()):
            out = call(loss_fn, model, policy, batch, views)
        loss, aux = out if isinstance(out, tuple) else (out, {})
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def step(state, batch):
        if sharding is None:
            return local_step(state, batch)
        from paddle_tpu_torch.core.mesh import mesh_context
        with mesh_context(sharding.mesh):
            return local_step(state, batch)

    def local_step(state, batch):
        model, opt = state["model"], state["opt"]
        opt.zero_grad(set_to_none=True)
        with capture_state() as tape:
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
        metrics = {"loss": loss, **aux}
        if sharding is not None:
            sharding.sync_grads(model)
            metrics = sharding.metrics(metrics)
        opt.step()
        tape.apply()
        state["step"].add_(1)
        return state, metrics

    def rebuild(**changes):
        kw = dict(policy=policy, trainable_mask=trainable_mask,
                  grad_accum_steps=grad_accum_steps, remat=remat,
                  cuda_graphs=cuda_graphs, sharding=sharding)
        kw.update(changes)
        return build_train_step(loss_fn, optimizer, **kw)

    return TrainStepGraphs(
        step, enabled=cuda_graphs, rebuild=rebuild, loss_fn=loss_fn,
        collectives=sharding.backend if sharding is not None else None)


def build_eval_step(model_fn: Callable,
                    policy: Optional[dtypes.Policy] = None) -> Callable:
    """``step(model, **batch) -> model_fn(model, **batch)`` under
    ``torch.no_grad()``, with the policy's compute casts."""
    def step(model, **batch):
        with torch.no_grad():
            return _policy_call(model_fn, model, policy, batch)

    return step
