"""Structured JSONL run log: one record per step, crash-safe append
(``paddle_tpu/observability/runlog.py``; same schema, so either
package's validator reads either package's log).

Newline-delimited JSON, each line a self-contained record. A crash
mid-write loses at most the final (partial) line, which
``read_run_log`` tolerates and drops.

Record kinds:
  run_meta   once at open: schema version, argv-ish context    (optional)
  step       per training step: timing/throughput/recompiles   (the bulk)
  summary    once at close: aggregate numbers                  (optional)

Step records carry (validated by :func:`validate_record`):
  ts                float  unix seconds
  kind              "step"
  step              int    global step index (>= 0)
  step_time_s       float  wall seconds for the step           (>= 0)
  examples_per_sec  float                                      (>= 0)
and optionally: epoch, tokens_per_sec, data_wait_s, compute_s,
recompiles (cumulative int), compiles_cum, metrics (dict of floats),
memory (per-device dict), host (process index).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional

SCHEMA_VERSION = 1

_KINDS = ("run_meta", "step", "summary")

# field -> (type(s), required) for step records
_STEP_REQUIRED = {
    "ts": (int, float),
    "step": (int,),
    "step_time_s": (int, float),
    "examples_per_sec": (int, float),
}
_STEP_NUMERIC_OPT = ("tokens_per_sec", "data_wait_s", "compute_s",
                     "recompiles", "compiles_cum", "epoch", "host")


class RunLogWriter:
    """Append-only JSONL writer. Every ``write`` flushes the line to the
    OS so a crashed run keeps everything up to its last whole step;
    ``fsync_every`` additionally fsyncs every N records (0 = never) for
    power-loss durability without per-step fsync cost."""

    def __init__(self, path: str, *, meta: Optional[Dict[str, Any]] = None,
                 fsync_every: int = 0):
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self.path = path
        self._f = open(path, "a", encoding="utf-8")
        self._fsync_every = int(fsync_every)
        self._since_sync = 0
        if meta is not None:
            self.write(dict(meta, kind="run_meta",
                            schema_version=SCHEMA_VERSION))

    def write(self, record: Dict[str, Any]):
        rec = dict(record)
        rec.setdefault("kind", "step")
        rec.setdefault("ts", time.time())
        line = json.dumps(rec, separators=(",", ":"), sort_keys=True,
                          default=_jsonable)
        self._f.write(line + "\n")
        self._f.flush()
        if self._fsync_every:
            self._since_sync += 1
            if self._since_sync >= self._fsync_every:
                os.fsync(self._f.fileno())
                self._since_sync = 0
        return rec

    def close(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _jsonable(x):
    """Last-resort coercion: tensors / numpy types -> python."""
    try:
        return float(x)
    except Exception:
        return str(x)


def read_run_log(path: str) -> List[Dict[str, Any]]:
    """Read all whole records; a trailing partial line (crash artifact)
    is dropped, an interior malformed line raises."""
    out: List[Dict[str, Any]] = []
    with open(path, encoding="utf-8") as f:
        lines = f.read().split("\n")
    # trailing "" after a final newline, or a partial record, is the tail
    body, tail = lines[:-1], lines[-1]
    for i, line in enumerate(body):
        if not line.strip():
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}:{i + 1}: malformed record: {e}") from e
    if tail.strip():
        try:
            out.append(json.loads(tail))
        except json.JSONDecodeError:
            pass  # partial final line: crash-safe read drops it
    return out


def validate_record(rec: Dict[str, Any], *, index: int = 0):
    """Schema-check one record; raises ValueError with a precise
    message."""

    def fail(msg):
        raise ValueError(f"record {index}: {msg} (record={rec!r})")

    if not isinstance(rec, dict):
        fail("not a JSON object")
    kind = rec.get("kind", "step")
    if kind not in _KINDS:
        fail(f"unknown kind {kind!r} (expected one of {_KINDS})")
    if not isinstance(rec.get("ts"), (int, float)):
        fail("missing/non-numeric 'ts'")
    if kind != "step":
        return
    for field, types in _STEP_REQUIRED.items():
        v = rec.get(field)
        if not isinstance(v, types) or isinstance(v, bool):
            fail(f"missing/mistyped required step field {field!r}")
        if v < 0:
            fail(f"negative {field!r}: {v}")
    for field in _STEP_NUMERIC_OPT:
        if field in rec and (not isinstance(rec[field], (int, float))
                             or isinstance(rec[field], bool)):
            fail(f"non-numeric optional field {field!r}")
    if "metrics" in rec:
        m = rec["metrics"]
        if not isinstance(m, dict):
            fail("'metrics' must be an object")
        for k, v in m.items():
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                fail(f"non-numeric metrics[{k!r}]")


def validate_run_log(path: str, *, require_steps: int = 0) -> int:
    """Validate every record in a JSONL run log; returns the number of
    step records. Raises ValueError on the first malformed record or if
    fewer than ``require_steps`` step records are present."""
    steps = 0
    records = read_run_log(path)
    for i, rec in enumerate(records):
        validate_record(rec, index=i)
        if rec.get("kind", "step") == "step":
            steps += 1
    if steps < require_steps:
        raise ValueError(
            f"{path}: {steps} step records < required {require_steps}")
    return steps
