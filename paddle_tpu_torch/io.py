"""Save/load of parameter and training-state trees (``paddle_tpu/io.py``,
the checkpoint half).

- :func:`save_params` / :func:`load_params`: a whole tree in one pickled
  file of ``{"a/b/c": numpy array}``, the reference's format (an empty
  dict node is kept by a ``\\x00empty`` key). numpy has no bf16, so a bf16
  tensor is stored as its uint16 bits and its key listed under the
  ``\\x00bfloat16`` entry; such a file loads as bf16 only here.
  :func:`load_params` returns CPU tensors.
- :class:`CheckpointManager`: the reference's facade over
  :class:`~paddle_tpu_torch.resilience.snapshot.SnapshotEngine`
  (background writes, hash-verified atomic manifests) with its
  ``save_interval_steps`` gating.

The inference-export half (``save_inference_model`` and the
``Predictor`` over ``torch.export``) lives in
:mod:`paddle_tpu_torch.inference`.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Optional

import numpy as np

from paddle_tpu_torch.resilience.snapshot import (SnapshotEngine,
                                                  flatten_tree, host_arrays,
                                                  to_tensor, unflatten_tree)

# the keys of bf16 leaves, stored as uint16 bits (\x00 cannot appear in
# a field name)
_BF16_KEY = "\x00bfloat16"


def save_params(params: Any, path: str):
    """Persist a parameter/state tree (dicts of tensors or arrays) in one
    file; tensors are copied to the host."""
    flat, bf16 = {}, []
    for key, (a, dtype) in host_arrays(flatten_tree(params)).items():
        flat[key] = a
        if dtype is not None:
            bf16.append(key)
    if bf16:
        flat[_BF16_KEY] = np.asarray(bf16)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(flat, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_params(path: str, target: Optional[Any] = None) -> Any:
    """Load a tree saved by :func:`save_params` (or by the reference's)
    as CPU tensors. With ``target``, keys and shapes must match."""
    with open(path, "rb") as f:
        flat = pickle.load(f)
    bf16 = set(np.asarray(flat.pop(_BF16_KEY, [])).tolist())
    if target is not None:
        tflat = flatten_tree(target)
        missing = set(tflat) - set(flat)
        extra = set(flat) - set(tflat)
        if missing or extra:
            raise ValueError(
                f"checkpoint mismatch: missing={sorted(missing)[:5]} "
                f"extra={sorted(extra)[:5]}")
        for k, v in tflat.items():
            if hasattr(v, "shape") and \
                    tuple(np.shape(flat[k])) != tuple(v.shape):
                raise ValueError(f"shape mismatch for {k}: "
                                 f"{np.shape(flat[k])} vs {tuple(v.shape)}")
    return unflatten_tree({
        k: to_tensor(v, "bfloat16" if k in bf16 else None)
        for k, v in flat.items()})


save_persistables = save_params
load_persistables = load_params


class CheckpointManager:
    """Versioned, asynchronous checkpoints: a facade over
    :class:`~paddle_tpu_torch.resilience.snapshot.SnapshotEngine` that adds
    the ``save_interval_steps`` gating and the reference's method names
    (``save/restore/latest_step/wait/close``, ``.manager`` exposing
    ``all_steps()``)."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        self.directory = (directory if "://" in directory
                          else os.path.abspath(directory))
        self.manager = SnapshotEngine(self.directory,
                                      max_to_keep=max_to_keep)
        self._interval = max(1, int(save_interval_steps))
        # interval gating uses a cached high-water mark: latest_step()
        # hash-verifies every kept snapshot, far too heavy per step
        self._last_saved: Optional[int] = None

    def save(self, step: int, state: Any, wait: bool = False,
             force: bool = False) -> bool:
        """``force=True`` bypasses the interval gate (the final save of a
        run). Returns whether a save was started."""
        last = self.last_saved_step
        if not force and self._interval > 1 and last is not None \
                and step - last < self._interval:
            return False
        self.manager.save(step, state, wait=wait)
        self._last_saved = step
        return True

    def restore(self, step: Optional[int] = None,
                target: Optional[Any] = None,
                shardings: Optional[Any] = None):
        """Load the newest VALID snapshot (or ``step``) as a tree of CPU
        tensors; integrity is verified before any bytes are trusted.
        ``shardings`` (a tree of ``(spec, mesh)``) reads each rank's
        blocks only (``SnapshotEngine.restore``)."""
        return self.manager.restore(step, target=target,
                                    shardings=shardings)

    def latest_step(self) -> Optional[int]:
        return self.manager.latest_step()

    @property
    def last_saved_step(self) -> Optional[int]:
        """High-water mark of saves issued through this manager (a cheap
        committed-manifest scan on first use; no hash pass)."""
        if self._last_saved is None:
            self._last_saved = self.manager.latest_step(verify=False)
        return self._last_saved

    def latest_valid_manifest(self) -> Optional[dict]:
        return self.manager.latest_valid_manifest()

    def wait(self):
        self.manager.wait_until_finished()

    def close(self):
        self.manager.close()
