"""Online embedding serving (``paddle_tpu/embedding_serving``): device-cached
host-KV lookups with streaming updates.

The serving half of the parameter-server world: millions of sparse
embedding rows live in a host or remote KV store; inference pulls hot
rows through a fixed-shape device cache; online-learning pushes from a
trainer serve within a bounded staleness window. Four parts:

1. **Device hot-row cache** (``device_cache.py``):
   :class:`DeviceEmbeddingCache`, a device table (capacity << vocab)
   with a host id -> slot index, one power-of-two-bucketed gather per
   lookup and one bucketed in-place install, each a captured CUDA graph
   on the card; LRU/LFU eviction; ``warmup()`` captures every width, so
   steady state captures nothing.
2. **Streaming updates** (``streaming.py``):
   :class:`StreamingUpdateChannel`, an AsyncCommunicator-style trainer ->
   server push channel (merged background applies, value or gradient
   pushes) with per-row version counters; channel lag (seconds and
   updates behind) is the observable, engine-enforced staleness bound.
3. **Serving engine** (``engine.py``): :class:`EmbeddingServingEngine`,
   ``submit``/``step``/``serve`` batches of sparse ids -> dense rows ->
   DeepFM probabilities (one captured graph per gather width and batch
   shape), miss pulls overlapped with device work, structured
   :class:`EmbeddingLoadShedError` rejects when the miss pipeline
   saturates, hit-rate/staleness/miss-latency metrics.
4. **Persistence** (``persistence.py``): manifest-committed, sha256-
   verified KV-table snapshots with the streaming version counters, in
   the reference's format.
"""

from paddle_tpu_torch.embedding_serving.device_cache import (
    CacheCapacityError, DeviceEmbeddingCache)
from paddle_tpu_torch.embedding_serving.engine import (EmbeddingLoadShedError,
                                                       EmbeddingServingEngine,
                                                       EmbedReject)
from paddle_tpu_torch.embedding_serving.persistence import (
    committed_steps, latest_valid_step, restore_kv_snapshot,
    save_kv_snapshot)
from paddle_tpu_torch.embedding_serving.streaming import (
    StreamingUpdateChannel)

__all__ = [
    "CacheCapacityError", "DeviceEmbeddingCache",
    "StreamingUpdateChannel",
    "EmbeddingLoadShedError", "EmbeddingServingEngine", "EmbedReject",
    "committed_steps", "latest_valid_step", "restore_kv_snapshot",
    "save_kv_snapshot",
]
