"""Static and runtime analysis (``paddle_tpu/analysis``, subset): the
``guarded_by`` lock annotation the fleet's threaded classes carry."""

from paddle_tpu_torch.analysis.concurrency import guarded_by

__all__ = ["guarded_by"]
