"""DataFeeder + device prefetch (``paddle_tpu/data/feeder.py``; parity:
``python/paddle/fluid/data_feeder.py`` DataFeeder and
``operators/reader/buffered_reader.cc``, the double-buffered host to device
pipeline).

:func:`device_iterator` keeps ``prefetch`` batches on the device ahead of
the one yielded. With a mesh (:func:`paddle_tpu_torch.core.mesh.make_mesh`)
each rank keeps its block of every feed's rows over the batch axes
("dp", "fsdp"), and the feeds named in ``replicated`` whole: what the
reference's ``batch_sharding`` and ``replicated`` shardings leave on a
rank's device. The copies are plain (pageable) ones; the asynchronous
pinned staging is :class:`paddle_tpu_torch.data.native_feed.DeviceLoader`.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core import mesh as mesh_lib
from paddle_tpu_torch.core.device import resolve_device


class DataFeeder:
    """Stack per-sample tuples into named batch dicts (DataFeeder.feed)."""

    def __init__(self, feed_names: Sequence[str]):
        self.feed_names = list(feed_names)

    def feed(self, samples: Iterable[tuple]) -> Dict[str, np.ndarray]:
        cols = list(zip(*samples))
        if len(cols) != len(self.feed_names):
            raise ValueError(
                f"sample arity {len(cols)} != feed names {self.feed_names}")
        return {n: np.stack(c) for n, c in zip(self.feed_names, cols)}


def _rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of ``t``'s rows over the batch axes."""
    from paddle_tpu_torch.parallel import plan
    if t.ndim == 0:
        return t
    spec = (mesh_lib.BATCH_AXES,) + (None,) * (t.ndim - 1)
    return plan.local_shard(t, spec, mesh)


def device_iterator(batch_reader, feed_names, mesh=None, prefetch=2,
                    replicated: Sequence[str] = (), device=None):
    """Iterate device-resident batch dicts with ``prefetch`` batches in
    flight (buffered_reader.cc double-buffering parity). ``batch_reader``
    is a reader creator of sample lists (``reader.batch``). ``device``
    defaults to the mesh's device type, else CUDA."""
    feeder = DataFeeder(feed_names)
    if device is None:
        device = mesh.device_type if mesh is not None else "cuda"
    dev = resolve_device(device)
    replicated = set(replicated)

    def put(batch):
        out = {}
        for k, v in feeder.feed(batch).items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if mesh is not None and k not in replicated:
                t = _rows(t, mesh)
            out[k] = t.to(dev, copy=True)
        return out

    window: collections.deque = collections.deque()
    for batch in batch_reader():
        window.append(put(batch))
        if len(window) > prefetch:
            yield window.popleft()
    while window:
        yield window.popleft()
