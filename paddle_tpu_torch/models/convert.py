"""Weights across from the reference: a parameter tree of the JAX
package -> this package's ``state_dict``.

The port's module attribute names mirror the reference trees (GPT:
``wte``, ``blocks.{i}.attn.qkv_proj.weight``, ``blocks.{i}.ln1.scale``;
BERT: ``bert.embeddings.word.weight``, ``bert.encoder.{i}.ffn.fc1.bias``,
``heads.decoder_bias``, ...) and its ``Linear`` keeps the ``(in, out)``
layout, so the conversion is a key flatten with no transposes, and
:func:`params_tree` gives a model's parameters back as the reference's
tree (the names of a checkpoint that both packages read).
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
