"""Static and runtime analysis (``paddle_tpu/analysis``, the port's
subset): the findings spine, the concurrency lint, lock-order graph and
sanitizer, and the conformance lints. Names load from their submodule on
first use, so ``python -m paddle_tpu_torch.analysis.concurrency`` runs
the module once."""

import importlib

_EXPORTS = {
    "Finding": "findings", "Report": "findings", "Suppressions": "findings",
    "RULES": "findings", "SUPPRESSIONS_PATH": "findings",
    "guarded_by": "concurrency", "lint_concurrency": "concurrency",
    "sanitize": "concurrency", "LOCK_ORDER_PATH": "concurrency",
    "lint_interfaces": "conformance", "lint_reject_vocab": "conformance",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(name)
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)
