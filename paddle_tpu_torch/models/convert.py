"""Weights across from the reference: a parameter tree of the JAX
package -> this package's ``state_dict``.

The port's module attribute names mirror the reference trees (GPT:
``wte``, ``blocks.{i}.attn.qkv_proj.weight``, ``blocks.{i}.ln1.scale``;
BERT: ``bert.embeddings.word.weight``, ``bert.encoder.{i}.ffn.fc1.bias``,
``heads.decoder_bias``, ...) and its ``Linear`` keeps the ``(in, out)``
layout, so the conversion is a key flatten with no transposes.
"""

from __future__ import annotations

from typing import Dict, Mapping

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
