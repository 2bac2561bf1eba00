"""Mixed-precision policy (``paddle_tpu/core/dtypes.py``, policy subset).

A :class:`Policy` names where each dtype is used: parameters stay fp32
(the master weights), compute runs in the policy's ``compute_dtype``,
outputs and losses come back in ``output_dtype``. ``cast_to_compute``
casts the floating tensors of a tensor, a dict, a list or a tuple
(nested) and leaves everything else (integer ids, bool masks, Python
scalars) as it is.
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
