"""Lock-discipline annotation for the threaded serving plane
(``paddle_tpu/analysis/concurrency.py``, the ``guarded_by`` decorator
only).

Classes declare which lock guards which fields; at runtime the
decorator only records ``cls.__guarded_by__``. The reference's AST lint,
lock-order graph and test-time sanitizer that enforce the contract are
not ported yet.
"""

from __future__ import annotations

from typing import Callable


def guarded_by(lock: str, *fields: str) -> Callable[[type], type]:
    """Class decorator declaring that ``lock`` (an attribute name, e.g.
    ``"_lock"``) guards ``fields`` (attribute names). Stackable for
    classes with more than one lock::

        @guarded_by("_cv", "_pending", "_error")
        @guarded_by("_vlock", "_versions", "_dirty")
        class StreamingUpdateChannel: ...

    Records ``cls.__guarded_by__``, a merged ``{field: lock}`` dict
    (inherited entries included)."""
    def deco(cls: type) -> type:
        merged = dict(getattr(cls, "__guarded_by__", {}))
        for f in fields:
            merged[f] = lock
        cls.__guarded_by__ = merged
        return cls
    return deco
