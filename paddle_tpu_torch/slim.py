"""Post-training int8 weight quantization (``paddle_tpu/slim.py:170-240``,
the WeightQuantization path of contrib/slim's quantization_pass): weights
stored int8 with per-channel symmetric scales, dequantized to the compute
dtype at use. The rest of the reference's ``slim.py`` (pruning,
distillation, ``sa_search``, quant-aware training) is ROADMAP Queue 1
item 5.

Trees are nested dicts of tensors, the reference's parameter trees
(:func:`paddle_tpu_torch.models.convert.params_tree` gives a model's). A
quantized leaf becomes ``{"q": int8, "scale": float32, "axis": -1 or
None}`` with the reference's values: ``scale = max(amax, 1e-8) / 127``
over every axis but the last (per output channel of the port's ``(in,
out)`` Linear weights, as of the reference's), ``q = clip(round(w /
scale), -127, 127)``, computed in the weight's dtype.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def quantizable(path: Tuple[str, ...], leaf) -> bool:
    """Weight matrices and filters only (``_prunable``): never biases,
    norms or other 1-D state."""
    name = path[-1] if path else ""
    return getattr(leaf, "ndim", 0) >= 2 and name in ("weight", "w")


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

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if predicate(path, tree):
            return quantize_int8(torch.as_tensor(tree), per_channel)
        return tree

    return walk(params, ())


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
