"""Cross-process metric aggregation
(``paddle_tpu/observability/aggregate.py``, one process).

``aggregate()`` returns min/max/mean (+argmin/argmax process index) per
key of a dict of scalars, so process 0's log line can show the skew
between processes. The port runs one process until its
``torch.distributed`` layer lands (see ROADMAP), so the gather is the
identity: min == max == mean == the local value.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def aggregate(values: Mapping[str, float]) -> Dict[str, Dict[str, float]]:
    """``{name: scalar}`` -> ``{name: {min, max, mean, argmin, argmax}}``
    over the processes (one here)."""
    keys = sorted(values)
    rows = np.asarray([[float(values[k]) for k in keys]], np.float64)
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
