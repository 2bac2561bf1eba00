"""Continuous-batching GPT serving over a paged KV cache."""

from paddle_tpu_torch.serving.engine import (MIGRATION_FORMAT,
                                             PREFIX_BUNDLE_FORMAT,
                                             ServingEngine,
                                             SlotMigrationError)
from paddle_tpu_torch.serving.paged_attention import (
    paged_prefill_attention, ragged_paged_decode_attention,
    ragged_paged_decode_int8_attention, ragged_paged_prefill_attention,
    ragged_paged_prefill_int8_attention)
from paddle_tpu_torch.serving.paged_cache import (KV_SCALE_FLOOR,
                                                  HostPagePool,
                                                  PagedCacheConfig,
                                                  PagedKVCache,
                                                  PageOverflowError,
                                                  SpilledPage,
                                                  payload_digest,
                                                  prompt_prefix_digests,
                                                  quantize_kv)
from paddle_tpu_torch.serving.scheduler import (REJECT_REASONS,
                                                ContinuousBatchingScheduler,
                                                LoadShedError, Reject,
                                                SLOScheduler)

__all__ = ["ContinuousBatchingScheduler", "HostPagePool", "KV_SCALE_FLOOR",
           "LoadShedError", "MIGRATION_FORMAT", "PREFIX_BUNDLE_FORMAT",
           "PageOverflowError", "PagedCacheConfig", "PagedKVCache",
           "REJECT_REASONS", "Reject", "SLOScheduler", "ServingEngine",
           "SlotMigrationError", "SpilledPage", "paged_prefill_attention",
           "payload_digest", "prompt_prefix_digests", "quantize_kv",
           "ragged_paged_decode_attention",
           "ragged_paged_decode_int8_attention",
           "ragged_paged_prefill_attention",
           "ragged_paged_prefill_int8_attention"]
