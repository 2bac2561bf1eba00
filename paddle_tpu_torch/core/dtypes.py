"""Mixed-precision policy and dtype names (``paddle_tpu/core/dtypes.py``).

A :class:`Policy` names where each dtype is used: parameters stay fp32
(the master weights), compute runs in the policy's ``compute_dtype``,
outputs and losses come back in ``output_dtype``. ``cast_to_compute``,
``cast_to_param`` and ``cast_to_output`` cast the floating tensors of a
tensor, a dict, a list or a tuple (nested) and leave everything else
(integer ids, bool masks, Python scalars) as it is.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, x):
        return _cast_floating(x, self.compute_dtype)

    def cast_to_param(self, x):
        return _cast_floating(x, self.param_dtype)

    def cast_to_output(self, x):
        return _cast_floating(x, self.output_dtype)


def _cast_floating(tree, dtype):
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floating(v, dtype) for v in tree)
    return tree


FULL = Policy()
BF16_COMPUTE = Policy(compute_dtype=torch.bfloat16)
BF16_FULL = Policy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                   output_dtype=torch.bfloat16)

_POLICIES = {"full": FULL, "float32": FULL, "bf16": BF16_COMPUTE,
             "bfloat16": BF16_COMPUTE, "bf16_full": BF16_FULL}


def get_policy(name: str) -> Policy:
    """Look up a policy by name ("full", "bf16", "bf16_full")."""
    if name not in _POLICIES:
        raise ValueError(f"unknown policy {name!r}")
    return _POLICIES[name]


#: the reference's dtype names (its ``VarType`` surface)
_DTYPES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "complex64": torch.complex64,
}


def convert_dtype(dtype) -> torch.dtype:
    """A dtype given by name, as a numpy dtype or as a ``torch.dtype`` ->
    the ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else getattr(
        dtype, "__name__", None) or str(dtype)
    name = {"float": "float32", "int": "int64", "bool_": "bool"}.get(
        name, name)
    if name not in _DTYPES:
        import numpy as np
        name = np.dtype(dtype).name
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}")
    return _DTYPES[name]


def is_floating(dtype) -> bool:
    """Whether ``dtype`` (any form :func:`convert_dtype` takes) is a real
    floating type (``jnp.issubdtype(dtype, np.floating)``: complex is
    not)."""
    dt = convert_dtype(dtype)
    return dt.is_floating_point
