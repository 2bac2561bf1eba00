"""Cross-process metric aggregation
(``paddle_tpu/observability/aggregate.py``).

In a multi-process run every process sees only its own step time,
throughput and data wait; one slow process drags the whole group, since
the collectives wait for the slowest member. ``aggregate()`` all-gathers
a dict of scalars over the ``torch.distributed`` world and returns
min/max/mean (+argmin/argmax process index) per key, so process 0's log
line shows the skew. The gather runs on the CPU over a gloo group (the
world's own when it is gloo, else one made once for this), so it never
touches a card. One process, or no process group: the identity (min ==
max == mean == the local value).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.distributed as dist

_GROUPS: dict = {}


def _cpu_group():
    """A gloo group over the whole world (cached per world)."""
    if dist.get_backend() == "gloo":
        return None
    key = id(dist.group.WORLD)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(backend="gloo")
    return _GROUPS[key]


def process_count() -> int:
    """Processes in the ``torch.distributed`` world (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def aggregate(values: Mapping[str, float]) -> Dict[str, Dict[str, float]]:
    """All-gather ``{name: scalar}`` over the processes -> per-name stats.

    Every process must call with the same key set (keys are sorted into
    a dense vector before the collective); the result is the same on
    every process: ``{name: {min, max, mean, argmin, argmax}}``, argmin
    and argmax being process indices."""
    keys = sorted(values)
    local = np.asarray([float(values[k]) for k in keys], np.float64)
    n = process_count()
    if n == 1 or not keys:
        rows = local[None, :]
    else:
        mine = torch.from_numpy(local)
        parts = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(parts, mine, group=_cpu_group())
        rows = torch.stack(parts).numpy()
    out: Dict[str, Dict[str, float]] = {}
    for j, k in enumerate(keys):
        col = rows[:, j]
        out[k] = {
            "min": float(col.min()), "max": float(col.max()),
            "mean": float(col.mean()),
            "argmin": int(col.argmin()), "argmax": int(col.argmax()),
        }
    return out


def format_aggregate(stats: Mapping[str, Dict[str, float]]) -> str:
    """One human line per metric: ``name min/mean/max (slowest host)``."""
    parts = []
    for k in sorted(stats):
        s = stats[k]
        parts.append(f"{k} {s['min']:.4g}/{s['mean']:.4g}/{s['max']:.4g}"
                     f" (host{int(s['argmax'])} high)")
    return "[hosts] " + "  ".join(parts)
