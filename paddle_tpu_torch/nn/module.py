"""Per-parameter sharding hints (``paddle_tpu/nn/module.py``:
``ParamSpec.sharding`` and ``Layer.sharding_specs``), the containers
:class:`LayerList` and :class:`Sequential`, :class:`StackedLayers`, the stacked ``(L, ...)`` layout of a stack of
identical layers, and the state tape (:func:`capture_state`) that holds
back BatchNorm's running-statistics updates for the train step.

A layer declares the spec each of its parameters would take on a mesh in
``param_sharding``, ``{parameter name: spec or None}`` (a spec is a tuple
with one entry per dimension, as :mod:`paddle_tpu_torch.parallel.plan`
writes it; None is replicated). The port's layers declare the
reference's hints: ``Linear`` column-split over "tp" (``(None, "tp")``,
its bias ``("tp",)``), ``Embedding`` vocab-split (``("tp", None)``), the
attention's output projection and the MLP's ``fc2`` row-split, and the
models' overrides. :func:`sharding_specs` gives them as the reference's
tree, the input of ``ShardingPlan.params_specs(..., hints=)``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

Spec = Optional[Tuple[Any, ...]]


def sharding_specs(model: nn.Module) -> dict:
    """The reference's tree of ``model``'s hints (``Layer.sharding_specs``):
    the shape of ``models.convert.params_tree(model)`` with each
    parameter's spec or None, and ``{}`` for a parameterless leaf
    module."""
    from paddle_tpu_torch.models.convert import params_tree
    values = {}
    for mod_name, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            key = f"{mod_name}.{pname}" if mod_name else pname
            values[key] = getattr(mod, "param_sharding", {}).get(pname)
    return params_tree(model, values)


class LayerList(nn.ModuleList):
    """Indexable list of sublayers (the reference's ``LayerList``): its
    members' parameters sit under ``"0"``, ``"1"``, ..., as the
    reference's tree holds them."""


class Sequential(nn.Module):
    """Layers applied in order (the reference's ``Sequential``), held in
    ``layers`` (a :class:`LayerList`, so the tree is the reference's
    ``{"layers": {"0": ...}}``). Keyword arguments (``generator=``) go
    only to the layers whose ``forward`` accepts them."""

    def __init__(self, *layers):
        super().__init__()
        self.layers = LayerList(layers)

    def forward(self, x, **kwargs):
        import inspect
        for layer in self.layers:
            accepted = {}
            if kwargs:
                sig = inspect.signature(layer.forward)
                accepted = {k: v for k, v in kwargs.items()
                            if k in sig.parameters}
            x = layer(x, **accepted)
        return x


class StackedLayers(nn.Module):
    """``L`` structurally identical layers stored as stacked ``(L, ...)``
    parameters (``paddle_tpu/nn/module.py`` ``StackedLayers``): the layout
    a pipeline splits over "pp" by placement, each stage holding its own
    rows.

    ``make_layer(device=, dtype=)`` builds one layer. A template of it
    lives on the meta device, outside the module tree; the module holds
    one ``nn.Parameter`` of shape ``(L, *shape)`` per parameter of the
    template, under the template's own names at this module's path with
    no layer index (``bert.encoder.attn.qkv_proj.weight``), so the
    reference's stacked tree carries across with a plain key flatten
    (``models.convert``). Parameterless submodules (dropouts) are kept as
    empty containers, as the reference's tree keeps ``{}``. Each hint
    gains the stage axis in front: ``("pp",)`` for a hint of None, else
    ``("pp", *hint)``.

    Layer ``i`` runs as the template through
    ``torch.func.functional_call`` on the ``i``-th rows
    (:meth:`layer_params`); :meth:`forward` applies the layers in order,
    each with the same keyword arguments (the dropout ``generator``
    shared, as a layer list's loop shares it)."""

    def __init__(self, make_layer, num_layers: int, *,
                 stage_axis: str = "pp", device=None, dtype=None):
        super().__init__()
        template = make_layer(device="meta", dtype=dtype)
        # not a child: its (meta) parameters stay out of the module tree
        object.__setattr__(self, "template", template)
        object.__setattr__(self, "_make_layer", make_layer)
        self.num_layers = num_layers
        self.stage_axis = stage_axis
        shells = {"": self}
        for name, mod in template.named_modules():
            if name:
                parent, _, leaf = name.rpartition(".")
                shells[name] = nn.Module()
                shells[parent].add_module(leaf, shells[name])
        for name, p in template.named_parameters():
            parent, _, leaf = name.rpartition(".")
            shell = shells[parent]
            shell.register_parameter(leaf, nn.Parameter(torch.empty(
                (num_layers,) + tuple(p.shape), device=device,
                dtype=p.dtype)))
            hint = getattr(template.get_submodule(parent),
                           "param_sharding", {}).get(leaf)
            if "param_sharding" not in shell.__dict__:
                shell.param_sharding = {}
            shell.param_sharding[leaf] = ((stage_axis,) if hint is None
                                          else (stage_axis, *hint))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Layer by layer, each initialised as a layer of a layer list
        would be (its modules' ``reset_parameters`` in module order), so
        a stacked model from a seed holds the layer list's weights of
        that seed, stacked."""
        stacked = self.stacked_params()
        ref = next(iter(stacked.values()))
        for i in range(self.num_layers):
            layer = self._make_layer(device=ref.device, dtype=ref.dtype)
            for mod in layer.modules():
                if hasattr(mod, "reset_parameters"):
                    mod.reset_parameters(generator)
            with torch.no_grad():
                for name, p in layer.named_parameters():
                    stacked[name][i].copy_(p)

    def train(self, mode: bool = True):
        super().train(mode)
        self.template.train(mode)
        return self

    def stacked_params(self) -> dict:
        """``{template name: the (rows, ...) tensor}`` as the module holds
        it now (a sharded step's view where one is swapped in)."""
        return held_params(self)

    def layer_params(self, i: int, stacked: Optional[dict] = None) -> dict:
        """Layer ``i``'s parameters: the ``i``-th row of each."""
        stacked = stacked if stacked is not None else self.stacked_params()
        return {name: t[i] for name, t in stacked.items()}

    def apply_layer(self, params: dict, x, *args, **kwargs):
        """The template on ``params`` (one layer's tensors by name)."""
        return torch.func.functional_call(self.template, params,
                                          (x,) + args, kwargs)

    def forward(self, x, **kwargs):
        stacked = self.stacked_params()
        rows = next(iter(stacked.values())).shape[0]
        if rows != self.num_layers:
            raise ValueError(
                f"this module holds {rows} of {self.num_layers} layers (a "
                "stack split over pp): run it through the pipeline")
        for i in range(self.num_layers):
            x = self.apply_layer(self.layer_params(i, stacked), x, **kwargs)
        return x


def layer_modules(model: nn.Module):
    """``(name, module, stacked)`` for every module of ``model``, and for
    every ``StackedLayers`` the modules of its template under the
    stacked names (``stacked`` True: their parameters' specs carry the
    stage axis in front)."""
    for name, mod in model.named_modules():
        yield name, mod, False
        if isinstance(mod, StackedLayers):
            for sub, tmod in mod.template.named_modules():
                yield (f"{name}.{sub}" if sub else name), tmod, True


def held_params(module: nn.Module) -> dict:
    """``{name: tensor}`` of ``module``'s parameters as it holds them now
    (read through the attributes, so a tensor swapped in by
    ``torch.func.functional_call`` is what comes back)."""
    out = {}
    for name, _ in module.named_parameters():
        obj = module
        for part in name.split("."):
            obj = getattr(obj, part)
        out[name] = obj
    return out


def pipeline_layers(stack) -> tuple:
    """``(apply, params)`` of a stack of identical layers for
    ``parallel.pipeline.gpipe_layer_stack``: a :class:`StackedLayers`'
    template and its stacked tensors as held, or a layer list's first
    layer run on each layer's parameters (a list of dicts, which the
    pipeline stacks)."""
    if isinstance(stack, StackedLayers):
        return stack.apply_layer, stack.stacked_params()
    first = stack[0]

    def apply(params, x, *args, **kwargs):
        return torch.func.functional_call(first, params, (x,) + args,
                                          kwargs)

    return apply, [held_params(layer) for layer in stack]


# -- state tape (BatchNorm's running statistics) ---------------------------

class StateCapture:
    """The running-state updates a forward reported: ``{(id(module),
    name): (module, name, value)}``, the last report of each buffer
    winning (``paddle_tpu/nn/module.py`` ``StateCapture``)."""

    def __init__(self):
        self.updates: Dict[Tuple[int, str], Tuple[Any, str, Any]] = {}

    def apply(self, where=None):
        """Write each recorded value into its buffer in place (cast to the
        buffer's dtype: a bf16 forward's statistics land in the fp32
        masters), so a captured graph keeps the buffers' storage; with
        ``where`` (a bool 0-d tensor) only where it holds, with no host
        sync. The buffer is looked up on its module now, so a forward
        that ran on swapped-in casts (``torch.func.functional_call``)
        still writes the master."""
        with torch.no_grad():
            for module, name, value in self.updates.values():
                buf = module._buffers[name]
                if where is not None:
                    value = torch.where(where, value.to(buf.dtype), buf)
                buf.copy_(value)


class _Tape(threading.local):
    #: this thread's active StateCapture, or None. Per thread, as the
    #: reference's ``_StateTape``: two train steps in two threads each
    #: report to their own tape. Work that autograd runs on its own
    #: threads for a step (a remat recompute in a CUDA backward) runs
    #: under the step's tape through :func:`use_tape`.
    active: Optional[StateCapture] = None


_TAPE = _Tape()


def active_tape() -> Optional[StateCapture]:
    """This thread's active :class:`StateCapture` (None outside any
    capture): what a recompute later run on another thread must report
    to (:func:`use_tape`)."""
    return _TAPE.active


@contextlib.contextmanager
def use_tape(cap: Optional[StateCapture]):
    """Make ``cap`` (a capture taken with :func:`active_tape`, or None)
    this thread's active tape inside the block: a remat recompute run by
    autograd's threads reports to the step that ran the forward."""
    prev = _TAPE.active
    _TAPE.active = cap
    try:
        yield cap
    finally:
        _TAPE.active = prev


@contextlib.contextmanager
def capture_state():
    """Collect the running-state updates of the forwards run inside, on
    this thread (BatchNorm in training mode), instead of writing them;
    the caller applies them (:meth:`StateCapture.apply`) when it chooses,
    as ``build_train_step`` does after the optimizer's update. Nested
    captures hide the outer one: what runs inside the inner one reports
    only to it."""
    with use_tape(StateCapture()) as cap:
        yield cap


def report_state(module: nn.Module, updates: Dict[str, Any]) -> bool:
    """Record ``{buffer name: new value}`` of ``module`` on the active
    tape; False (nothing recorded) outside any capture."""
    cap = _TAPE.active
    if cap is None:
        return False
    for name, value in updates.items():
        cap.updates[(id(module), name)] = (module, name, value.detach())
    return True
