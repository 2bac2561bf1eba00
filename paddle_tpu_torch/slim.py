"""Model compression (``paddle_tpu/slim.py``, fluid ``contrib/slim``):
magnitude pruning, sensitivity analysis, distillation losses,
simulated-annealing search, quant-aware training and post-training int8
weights.

Trees are nested dicts of tensors, the reference's parameter trees
(:func:`paddle_tpu_torch.models.convert.params_tree` gives a model's); a
leaf's path is its keys, so ``("fc", "weight")`` names the parameter
``fc.weight``. The default predicate selects weight matrices and filters
(leaves of rank 2 and up named ``weight`` or ``w``), never biases, norms
or other 1-D state.

- Pruning: :func:`magnitude_prune_masks` gives 0/1 masks zeroing the
  smallest-magnitude ``sparsity`` share of each selected leaf (the
  threshold is the ``k``-th smallest ``|w|``, ``k = round(size *
  sparsity)``, and ties at it are pruned too, as in the reference);
  :func:`pruned_train_step` wraps a train step so the masks multiply the
  parameters in place after every update, inside the step, so a step
  captured as a CUDA graph keeps the pruned weights at zero in every
  replay.
- Distillation: :func:`soft_label_loss` (``KL(teacher_T || student_T) *
  T^2``), :func:`fsp_matrix`/:func:`fsp_loss` over NHWC feature maps and
  :func:`distill_loss_fn`, which adds the KD term to a student loss of
  the port's ``loss_fn(model, **batch)`` form.
- :func:`sa_search` draws from numpy's PCG64 of ``seed`` (the reference's
  stream, so one seed gives the reference's trajectory) or from a
  ``torch.Generator``.
- Quant-aware training: :func:`qat_transform` runs ``loss_fn(model,
  **batch)`` on the selected weights fake-quantised (abs-max, the
  straight-through gradient of :mod:`paddle_tpu_torch.ops.quant`) through
  ``torch.func.functional_call``; :func:`qat_convert` snaps a tree's
  weights to the same grid. Channel-wise scales are per output channel:
  the last axis of a Linear's ``(in, out)`` weight, as the reference's,
  and the first of a conv's OIHW (or OIDHW) weight, where the reference's
  HWIO puts it last.
- Int8 weights (the WeightQuantization path of contrib/slim's
  quantization_pass): stored int8 with symmetric per-channel scales and
  dequantized to the compute dtype at use. A quantized leaf becomes
  ``{"q": int8, "scale": float32, "axis": -1 or None}`` with the
  reference's values: ``scale = max(amax, 1e-8) / 127`` over every axis
  but the last, ``q = clip(round(w / scale), -127, 127)``, computed in
  the weight's dtype.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def quantizable(path: Tuple[str, ...], leaf) -> bool:
    """Weight matrices and filters only (``_prunable``): never biases,
    norms or other 1-D state."""
    name = path[-1] if path else ""
    return getattr(leaf, "ndim", 0) >= 2 and name in ("weight", "w")


def _walk(tree, fn, path=()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _tree_map(fn, a, b):
    if isinstance(a, dict):
        return {k: _tree_map(fn, a[k], b[k]) for k in a}
    return fn(a, b)


# -- pruning ------------------------------------------------------------------

def _magnitude_mask(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """One leaf's 0/1 mask in its dtype: zero where ``|w|`` is at or below
    the ``k``-th smallest ``|w|``, ``k = round(w.numel() * sparsity)``."""
    k = int(round(w.numel() * sparsity))
    if k == 0:
        return torch.ones_like(w)
    mag = w.detach().abs()
    thresh = torch.sort(mag.reshape(-1)).values[k - 1]
    return (mag > thresh).to(w.dtype)


def magnitude_prune_masks(params, sparsity: float, *,
                          predicate: Optional[Callable] = None):
    """Per-leaf magnitude masks (SensitivePruneStrategy's ratio pruning):
    a tree like ``params`` with a 0/1 mask (the leaf's dtype and device)
    on each leaf ``predicate(path, leaf)`` selects and ones elsewhere;
    non-tensor leaves pass through."""
    if not 0.0 <= sparsity < 1.0:
        raise ValueError(f"sparsity must be in [0, 1); got {sparsity}")
    predicate = predicate or quantizable

    def mask(path, leaf):
        if predicate(path, leaf) and sparsity > 0.0:
            return _magnitude_mask(leaf, sparsity)
        return torch.ones_like(leaf) if isinstance(leaf, torch.Tensor) \
            else leaf

    return _walk(params, mask)


def apply_masks(params, masks):
    """``params * masks`` leaf by leaf (a new tree)."""
    return _tree_map(lambda p, m: p * m, params, masks)


def sparsity_of(masks) -> float:
    """The share of zeros over every mask leaf."""
    zeros = total = 0
    for _, m in _leaves(masks):
        zeros += int(m.numel()) - int(torch.count_nonzero(m))
        total += int(m.numel())
    return zeros / max(total, 1)


def _flat_masks(masks) -> Dict[str, torch.Tensor]:
    return {".".join(path): m for path, m in _leaves(masks)
            if isinstance(m, torch.Tensor)}


def pruned_train_step(step: Callable, masks) -> Callable:
    """``step`` (a train step of :func:`~paddle_tpu_torch.train.
    build_train_step`, or any ``step(state, **batch) -> (state,
    metrics)``) with the masks re-applied after every update: each masked
    parameter of ``state["model"]`` (``masks`` keyed by the model's
    parameter tree) is multiplied by its mask in place, so pruned weights
    stay zero through momentum and Adam's slots (slim's retrain phase).
    For a :class:`~paddle_tpu_torch.train.TrainStepGraphs` the multiply is
    part of the step it captures: every replay keeps them at zero. The
    masks move to the parameters' device once, on the first call (an
    eager warm-up call, before any capture)."""
    from paddle_tpu_torch.train import TrainStepGraphs
    flat = _flat_masks(masks)
    placed: Dict[Tuple[str, Any], torch.Tensor] = {}

    def mask_params(state):
        model = state["model"]
        named = dict(model.named_parameters())
        missing = sorted(set(flat) - set(named))
        if missing:
            raise KeyError(f"masks for parameters the model does not "
                           f"have: {missing[:3]}")
        with torch.no_grad():
            for name, m in flat.items():
                p = named[name]
                key = (name, p.device)
                if key not in placed:
                    placed[key] = m.to(device=p.device, dtype=p.dtype)
                p.mul_(placed[key])

    if isinstance(step, TrainStepGraphs):
        inner = step.step

        def masked(state, batch):
            state, metrics = inner(state, batch)
            mask_params(state)
            return state, metrics

        return TrainStepGraphs(masked, enabled=step.enabled,
                               collectives=step.collectives,
                               loss_fn=step.loss_fn)

    def wrapped(state, **batch):
        state, metrics = step(state, **batch)
        mask_params(state)
        return state, metrics

    return wrapped


def sensitivity_analysis(loss_fn: Callable, params, *,
                         sparsities: Sequence[float] = (0.3, 0.5, 0.7),
                         predicate: Optional[Callable] = None
                         ) -> Dict[Tuple[str, ...], Dict[float, float]]:
    """Per-layer sensitivity (slim ``sensitive.py``): prune one selected
    leaf at a time to each sparsity and record ``float(loss_fn(tree))``.
    Returns ``{path: {0.0: base loss, sparsity: loss, ...}}``."""
    predicate = predicate or quantizable
    base = float(loss_fn(params))
    out: Dict[Tuple[str, ...], Dict[float, float]] = {}
    for path, leaf in _leaves(params):
        if not predicate(path, leaf):
            continue
        out[path] = {0.0: base}
        for s in sparsities:
            masks = magnitude_prune_masks(
                params, s, predicate=lambda p, _, t=path: p == t)
            out[path][s] = float(loss_fn(apply_masks(params, masks)))
    return out


# -- distillation -------------------------------------------------------------

def soft_label_loss(student_logits, teacher_logits, *,
                    temperature: float = 1.0):
    """Soft-target KD loss (slim's distillation strategy):
    ``KL(teacher_T || student_T) * T^2``, the mean over the batch, in
    float32."""
    t = temperature
    sp = torch.log_softmax(student_logits.float() / t, -1)
    tlogp = torch.log_softmax(teacher_logits.float() / t, -1)
    kl = (tlogp.exp() * (tlogp - sp)).sum(-1)
    return kl.mean() * (t * t)


def fsp_matrix(a, b):
    """Flow-of-solution-procedure matrix: NHWC feature maps ``a`` (B, H,
    W, Ca) and ``b`` (B, H, W, Cb) -> (B, Ca, Cb), ``sum_hw a b / (H W)``."""
    ba, h, w, ca = a.shape
    bb, h2, w2, cb = b.shape
    if (ba, h, w) != (bb, h2, w2):
        raise ValueError(f"FSP needs matching spatial dims; "
                         f"{tuple(a.shape)} vs {tuple(b.shape)}")
    return torch.einsum("bnc,bnd->bcd", a.reshape(ba, h * w, ca),
                        b.reshape(bb, h * w, cb)) / (h * w)


def fsp_loss(student_pairs, teacher_pairs):
    """The mean over feature pairs of the mean squared difference of the
    student's and the teacher's FSP matrices: ``[((a_s, b_s), (a_t,
    b_t)), ...]``."""
    losses = [((fsp_matrix(a_s, b_s) - fsp_matrix(a_t, b_t)) ** 2).mean()
              for (a_s, b_s), (a_t, b_t) in zip(student_pairs,
                                                 teacher_pairs)]
    return torch.stack(losses).mean()


def distill_loss_fn(student_loss_fn: Callable, teacher_fn: Callable, *,
                    alpha: float = 0.5, temperature: float = 2.0
                    ) -> Callable:
    """``loss(model, **batch) = (1 - alpha) * hard + alpha * KD``:
    ``student_loss_fn(model, **batch) -> (hard loss, {"logits", ...})``,
    ``teacher_fn(**batch) -> logits`` (a frozen teacher: its logits are
    detached). Returns ``(loss, aux + {"hard_loss", "kd_loss"})``, a loss
    function for ``build_train_step``."""

    def loss(model, **batch):
        hard, aux = student_loss_fn(model, **batch)
        with torch.no_grad():
            teacher_logits = teacher_fn(**batch)
        kd = soft_label_loss(aux["logits"], teacher_logits.detach(),
                             temperature=temperature)
        total = (1 - alpha) * hard + alpha * kd
        return total, dict(aux, hard_loss=hard, kd_loss=kd)

    return loss


# -- search -------------------------------------------------------------------

class _Draws:
    """Integers below ``n`` and uniforms in [0, 1): numpy's PCG64 of a
    seed, or a ``torch.Generator`` (on the CPU)."""

    def __init__(self, seed: int, generator: Optional[torch.Generator]):
        self.gen = generator
        self.rng = None if generator is not None else \
            np.random.default_rng(seed)

    def integers(self, n: int) -> int:
        if self.gen is None:
            return int(self.rng.integers(n))
        return int(torch.randint(n, (), generator=self.gen))

    def random(self) -> float:
        if self.gen is None:
            return float(self.rng.random())
        return float(torch.rand((), generator=self.gen,
                                dtype=torch.float64))


def sa_search(space: Dict[str, Sequence], eval_fn: Callable[[dict], float],
              *, iters: int = 50, init_temp: float = 1.0,
              cooling: float = 0.95, seed: int = 0,
              init: Optional[dict] = None,
              generator: Optional[torch.Generator] = None):
    """Simulated annealing over a discrete space (slim light_nas's
    ``sa_controller``): mutate one knob a step, accept a worse candidate
    with ``exp((r - r_cur) / T)``, multiply ``T`` by ``cooling``.
    ``space``: ``{knob: [choices]}``; ``eval_fn(config) -> reward`` to
    maximise. Draws come from ``generator`` when given, else from numpy's
    PCG64 of ``seed`` (the reference's draws). Returns ``(best_config,
    best_reward, history)``."""
    draws = _Draws(seed, generator)
    keys = sorted(space)
    cur = dict(init) if init is not None else \
        {k: space[k][draws.integers(len(space[k]))] for k in keys}
    for k in keys:
        if cur[k] not in list(space[k]):
            raise ValueError(f"init[{k!r}]={cur[k]!r} not in space")
    cur_r = float(eval_fn(cur))
    best, best_r = dict(cur), cur_r
    temp = init_temp
    history = [(dict(cur), cur_r)]
    # only knobs with more than one choice can move (an evaluation is a
    # training run in NAS)
    mutable = [k for k in keys if len(space[k]) > 1]
    if not mutable:
        return best, best_r, history
    for _ in range(iters):
        cand = dict(cur)
        k = mutable[draws.integers(len(mutable))]
        choices = [c for c in space[k] if c != cand[k]]
        cand[k] = choices[draws.integers(len(choices))]
        r = float(eval_fn(cand))
        if r >= cur_r or draws.random() < math.exp(
                (r - cur_r) / max(temp, 1e-8)):
            cur, cur_r = cand, r
        if cur_r > best_r:
            best, best_r = dict(cur), cur_r
        history.append((dict(cand), r))
        temp *= cooling
    return best, best_r, history


# -- quant-aware training -----------------------------------------------------

def _channel_axis(leaf) -> int:
    """The output-channel axis: first for a conv's OI... weight, last for
    a Linear's (in, out)."""
    return 0 if leaf.ndim >= 4 else -1


def _fake_quant_params(params, *, bit_length: int,
                       predicate: Optional[Callable], channel_wise: bool):
    from paddle_tpu_torch.ops import quant as Q
    pred = predicate or quantizable

    def fq(path, leaf):
        if not pred(path, leaf):
            return leaf
        if channel_wise and leaf.ndim >= 2:
            return Q.fake_channel_wise_quantize_abs_max(
                leaf, bit_length=bit_length, axis=_channel_axis(leaf))[0]
        return Q.fake_quantize_abs_max(leaf, bit_length=bit_length)[0]

    return _walk(params, fq)


def qat_transform(loss_fn: Callable, *, bit_length: int = 8,
                  predicate: Optional[Callable] = None,
                  channel_wise: bool = False) -> Callable:
    """``loss_fn(model, **batch)`` run with the selected parameters
    fake-quantised (abs-max; the gradient passes straight through to the
    float weights, which the optimizer keeps), through
    ``torch.func.functional_call`` (QuantizationTransformPass). A loss
    function for ``build_train_step``."""

    @functools.wraps(loss_fn)
    def wrapped(model, *args, **kwargs):
        from paddle_tpu_torch.nn.module import held_params
        tree = {}
        # as held: under a policy the step has swapped in its casts
        for name, p in held_params(model).items():
            node = tree
            *path, leaf = name.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = p
        fq = _fake_quant_params(tree, bit_length=bit_length,
                                predicate=predicate,
                                channel_wise=channel_wise)
        from paddle_tpu_torch.train import _LossModule
        return torch.func.functional_call(
            _LossModule(model, loss_fn),
            {"model." + ".".join(path): v for path, v in _leaves(fq)},
            args, kwargs)

    return wrapped


def qat_convert(params, *, bit_length: int = 8,
                predicate: Optional[Callable] = None,
                channel_wise: bool = False):
    """Deployment weights of a QAT run (QuantizationFreezePass): the
    selected leaves of ``params`` snapped to the grid the training saw
    (pass :func:`qat_transform`'s ``channel_wise``)."""
    with torch.no_grad():
        return _fake_quant_params(params, bit_length=bit_length,
                                  predicate=predicate,
                                  channel_wise=channel_wise)


# -- post-training int8 weights -----------------------------------------------


def quantize_int8(w: torch.Tensor, per_channel: bool = True) -> dict:
    """One tensor's quantized leaf (module docstring)."""
    if per_channel:
        amax = w.abs().amax(dim=tuple(range(w.ndim - 1)), keepdim=True)
    else:
        amax = w.abs().amax()
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.to(torch.float32),
            "axis": -1 if per_channel else None}


def quantize_weights_int8(params, *, predicate: Optional[Callable] = None,
                          per_channel: bool = True):
    """Symmetric int8 weight quantization. Returns a tree where each leaf
    ``predicate(path, leaf)`` selects (default: 2-D and up leaves named
    ``weight`` or ``w``) becomes ``{"q", "scale", "axis"}``; other leaves
    pass through."""
    predicate = predicate or quantizable
    return _walk(params, lambda path, leaf: quantize_int8(
        torch.as_tensor(leaf), per_channel) if predicate(path, leaf)
        else leaf)


def _is_qleaf(node) -> bool:
    return isinstance(node, dict) and set(node) == {"q", "scale", "axis"}


def dequantize_int8(leaf: dict, dtype=torch.float32) -> torch.Tensor:
    """``q * scale`` in float32, then ``dtype``."""
    return (leaf["q"].to(torch.float32) * leaf["scale"]).to(dtype)


def dequantize_weights(qparams, dtype=torch.float32, *,
                       keep_int8_resident: bool = False):
    """Inverse of :func:`quantize_weights_int8`: a dense tree in
    ``dtype``. ``keep_int8_resident`` is the reference's guard against
    XLA constant-folding baked int8 constants back to float; nothing
    folds here (an exported program keeps its int8 weights as buffers,
    dequantized at run time), so it is accepted and changes nothing."""
    del keep_int8_resident

    def walk(node):
        if _is_qleaf(node):
            return dequantize_int8(node, dtype)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(qparams)


def quantization_error(params, qparams) -> Dict[Tuple[str, ...], float]:
    """Per-quantized-leaf relative L2 error ``|w - deq(q)| / |w|`` by the
    leaf's key path: the accuracy-budget check before shipping a
    quantized artifact."""
    deq = dequantize_weights(qparams)
    out: Dict[Tuple[str, ...], float] = {}

    def walk(a, b, q, path):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], q[k], path + (k,))
        elif _is_qleaf(q):
            a = torch.as_tensor(a, dtype=torch.float32)
            num = float(torch.linalg.vector_norm(a - b.to(a.device)))
            den = float(torch.linalg.vector_norm(a)) or 1.0
            out[path] = num / den

    walk(params, deq, qparams, ())
    return out
