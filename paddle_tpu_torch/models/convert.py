"""Weights across from the reference: a parameter tree of the JAX
package -> this package's ``state_dict``.

The port's module attribute names mirror the reference trees (GPT:
``wte``, ``blocks.{i}.attn.qkv_proj.weight``, ``blocks.{i}.ln1.scale``;
BERT: ``bert.embeddings.word.weight``, ``bert.encoder.{i}.ffn.fc1.bias``,
``heads.decoder_bias``, ...) and its ``Linear`` keeps the ``(in, out)``
layout, so the conversion is a key flatten with no transposes, and
:func:`params_tree` gives a model's parameters back as the reference's
tree (the names of a checkpoint that both packages read).

The one layout that differs is the conv weight: the reference's is HWIO,
``nn.layers.Conv2D`` holds torch's OIHW. A module names such parameters
in ``jax_layouts`` (``{"weight": "HWIO"}``), and :func:`load_jax`
transposes them on the way in; BatchNorm's running ``mean``/``variance``
are buffers here and non-trainable parameters there, under the same
names, so they load with the rest. :func:`state_tree` gives a model's
parameters and buffers as one tree (what ``inference.fold_batch_norms``
reads).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def state_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flatten a nested ``{name: {...: array}}`` tree (numpy arrays, or
    anything ``np.asarray`` takes) into ``{"a.b.c": tensor}``. Empty
    sub-trees (parameterless layers such as dropout) are dropped."""
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, node):
        if isinstance(node, Mapping):
            for key, sub in node.items():
                walk(f"{prefix}.{key}" if prefix else str(key), sub)
        else:
            out[prefix] = torch.from_numpy(np.array(node, copy=True))

    walk("", params)
    return out


#: the first slice's name for :func:`state_from_jax`
gpt_state_from_jax = state_from_jax


def params_tree(model, values: Optional[Mapping[str, Any]] = None) -> dict:
    """The reference's nested parameter tree of ``model``, the inverse of
    :func:`state_from_jax`: ``{"bert": {"encoder": {"0": {...}}}}``, with
    an empty dict for each leaf module that holds no parameter (the
    reference's parameterless layers, such as dropout, init to ``{}``).
    Leaves are the parameters, or ``values[name]`` (an optimizer's slot
    of that parameter, say) where ``values`` is given."""
    tree: dict = {}

    def node(path):
        d = tree
        for part in path:
            d = d.setdefault(part, {})
        return d

    for name, mod in model.named_modules():
        if name and not list(mod.children()) and \
                not any(True for _ in mod.parameters()):
            node(name.split("."))
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node(path)[leaf] = p if values is None else values[name]
    return tree


def load_jax(model, params, strict: bool = True):
    """Load a reference parameter tree into ``model`` (in place, returned):
    :func:`state_from_jax`, with each parameter a module lists in its
    ``jax_layouts`` as HWIO transposed to OIHW."""
    state = state_from_jax(params)
    for name, mod in model.named_modules():
        for pname, layout in getattr(mod, "jax_layouts", {}).items():
            key = f"{name}.{pname}" if name else pname
            if key in state and layout == "HWIO":
                # (kh, kw, in, out) -> torch's (out, in, kh, kw)
                state[key] = state[key].permute(3, 2, 0, 1).contiguous()
    model.load_state_dict(state, strict=strict)
    return model


def state_tree(model) -> dict:
    """``model``'s parameters and buffers as one nested tree in the
    port's layouts (the inverse of :func:`state_from_jax`)."""
    tree: dict = {}
    for name, value in model.state_dict().items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree
