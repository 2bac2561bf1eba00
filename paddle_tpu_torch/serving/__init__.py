"""Continuous-batching GPT serving over a paged KV cache."""

from paddle_tpu_torch.serving.engine import ServingEngine
from paddle_tpu_torch.serving.paged_attention import (
    paged_prefill_attention, ragged_paged_decode_attention,
    ragged_paged_decode_int8_attention, ragged_paged_prefill_attention,
    ragged_paged_prefill_int8_attention)
from paddle_tpu_torch.serving.paged_cache import (KV_SCALE_FLOOR,
                                                  PagedCacheConfig,
                                                  PagedKVCache,
                                                  PageOverflowError,
                                                  prompt_prefix_digests,
                                                  quantize_kv)
from paddle_tpu_torch.serving.scheduler import (REJECT_REASONS,
                                                ContinuousBatchingScheduler,
                                                LoadShedError, Reject,
                                                SLOScheduler)

__all__ = ["ContinuousBatchingScheduler", "KV_SCALE_FLOOR", "LoadShedError",
           "PageOverflowError", "PagedCacheConfig", "PagedKVCache",
           "REJECT_REASONS", "Reject", "SLOScheduler", "ServingEngine",
           "paged_prefill_attention", "prompt_prefix_digests", "quantize_kv",
           "ragged_paged_decode_attention",
           "ragged_paged_decode_int8_attention",
           "ragged_paged_prefill_attention",
           "ragged_paged_prefill_int8_attention"]
