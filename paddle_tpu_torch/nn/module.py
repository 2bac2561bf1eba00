"""Per-parameter sharding hints (``paddle_tpu/nn/module.py``:
``ParamSpec.sharding`` and ``Layer.sharding_specs``).

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

from typing import Any, Optional, Tuple

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
