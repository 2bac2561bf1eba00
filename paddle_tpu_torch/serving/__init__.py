"""Continuous-batching GPT serving over a paged KV cache."""

from paddle_tpu_torch.serving.engine import ServingEngine
from paddle_tpu_torch.serving.paged_attention import (
    ragged_paged_decode_attention, ragged_paged_prefill_attention)
from paddle_tpu_torch.serving.paged_cache import (PagedCacheConfig,
                                                  PagedKVCache,
                                                  PageOverflowError,
                                                  prompt_prefix_digests)
from paddle_tpu_torch.serving.scheduler import (REJECT_REASONS,
                                                ContinuousBatchingScheduler,
                                                LoadShedError, Reject,
                                                SLOScheduler)

__all__ = ["ContinuousBatchingScheduler", "LoadShedError", "PageOverflowError",
           "PagedCacheConfig", "PagedKVCache", "REJECT_REASONS", "Reject",
           "SLOScheduler", "ServingEngine", "prompt_prefix_digests",
           "ragged_paged_decode_attention", "ragged_paged_prefill_attention"]
