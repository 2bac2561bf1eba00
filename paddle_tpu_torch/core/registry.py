"""Op registry (``paddle_tpu/core/registry.py``): the OpInfoMap.

An op is a function over tensors plus what the framework keeps beside it:

- ``reference``: the numpy reference implementation (the reference's
  own, for the OpTest-style checks), or None where it has none;
- ``has_grad``: whether gradients flow through the op;
- ``module``: the module that registered it.

The op modules of :mod:`paddle_tpu_torch.ops` register under the
reference's names when they are imported.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Dict, Optional


@dataclasses.dataclass
class OpInfo:
    name: str
    fn: Callable
    reference: Optional[Callable] = None  # numpy reference impl
    has_grad: bool = True
    doc: str = ""
    module: str = ""


_OP_REGISTRY: Dict[str, OpInfo] = {}


def register_op(name: str, *, reference: Optional[Callable] = None,
                has_grad: bool = True):
    """Decorator registering an op into the global OpInfoMap."""
    module = sys._getframe(1).f_globals.get("__name__", "")

    def wrap(fn: Callable) -> Callable:
        if name in _OP_REGISTRY:
            raise ValueError(f"op {name!r} already registered")
        _OP_REGISTRY[name] = OpInfo(
            name=name, fn=fn, reference=reference, has_grad=has_grad,
            doc=(fn.__doc__ or "").strip().splitlines()[0] if fn.__doc__ else "",
            module=module,
        )
        return fn

    return wrap


def get_op(name: str) -> OpInfo:
    if name not in _OP_REGISTRY:
        raise KeyError(f"op {name!r} not registered; have {len(_OP_REGISTRY)} ops")
    return _OP_REGISTRY[name]


def list_ops():
    return sorted(_OP_REGISTRY)


def all_ops() -> Dict[str, OpInfo]:
    return dict(_OP_REGISTRY)
