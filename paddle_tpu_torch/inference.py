"""Inference facade (``paddle_tpu/inference.py``, serving subset)."""

from __future__ import annotations


def make_serving_engine(model, **kwargs):
    """Continuous-batching serving front end for a
    :class:`~paddle_tpu_torch.models.gpt.GPT`: builds a
    :class:`~paddle_tpu_torch.serving.ServingEngine` over a paged KV
    cache. ``submit()`` requests and drive ``step()`` (or
    ``generate_many``); the engine keeps its fixed decode slots full and
    reports tokens, TTFT, slot occupancy and page utilization through
    its metrics registry. ``device`` defaults to CUDA;
    ``cache_dtype=torch.int8`` serves over the int8 page pool, and
    ``draft_model`` / ``spec_k`` / ``draft_cache_dtype`` turn on exact
    speculative decoding; ``tier`` ("prefill" or "decode") makes one half
    of a disaggregated pair, ``host_spill_pages`` adds the host spill
    tier and ``snapshot_every_blocks`` keeps micro-snapshots for
    ``restore_slot`` (see
    :class:`~paddle_tpu_torch.serving.ServingEngine`)."""
    from paddle_tpu_torch.serving.engine import ServingEngine
    return ServingEngine(model, **kwargs)
