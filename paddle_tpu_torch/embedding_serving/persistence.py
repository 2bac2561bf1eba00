"""KV-store snapshots with the resilience manifest discipline
(``paddle_tpu/embedding_serving/persistence.py``; the same files, so
either package restores the other's snapshots).

The embedding service's durable state is the backing KV table (plus the
streaming channel's per-row version counters, so a restored server
resumes with correct freshness bookkeeping). Persistence follows the
two-phase pattern of ``resilience/snapshot.py``: write the payload
files, fsync, then commit a ``manifest.json`` (per-file sha256 + sizes
+ schema) via tmp-write → fsync → atomic rename. No manifest ⇒ the
snapshot is invisible; a torn save can never be restored; a bit-rotted
payload is REFUSED (:class:`SnapshotCorruptionError`, shared with the
resilience engine) and ``latest_valid_step`` falls back past it.

Layout::

    <dir>/step_00000042/table.kv        native kv_save blob
                        versions.npz    streaming version counters
                        manifest.json   committed last, atomically
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

from paddle_tpu_torch.resilience.snapshot import SnapshotCorruptionError

MANIFEST = "manifest.json"
FORMAT_VERSION = 1
_TABLE = "table.kv"
_VERSIONS = "versions.npz"
_CHUNK = 1 << 16


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def _fsync_file(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _step_dirname(step: int) -> str:
    return f"step_{int(step):08d}"


def _parse_step(name: str) -> Optional[int]:
    if not name.startswith("step_"):
        return None
    try:
        return int(name[len("step_"):])
    except ValueError:
        return None


def save_kv_snapshot(store, directory: str, step: int, *,
                     versions: Optional[Dict[int, int]] = None) -> str:
    """Snapshot ``store`` (HostKVStore/RemoteKVStore surface) at
    ``step``. Returns the committed step directory. Re-saving a step
    that already committed is a no-op (committed steps are immutable,
    like the resilience engine)."""
    sdir = os.path.join(directory, _step_dirname(step))
    if os.path.exists(os.path.join(sdir, MANIFEST)):
        return sdir
    os.makedirs(sdir, exist_ok=True)
    table_path = os.path.join(sdir, _TABLE)
    store.save(table_path)          # flushes outstanding async ops first
    _fsync_file(table_path)
    files = {_TABLE: {"sha256": _sha256(table_path),
                      "bytes": os.path.getsize(table_path)}}
    if versions is not None:
        vpath = os.path.join(sdir, _VERSIONS)
        ids = np.fromiter(versions, np.int64, len(versions))
        vs = np.asarray([versions[int(i)] for i in ids], np.int64)
        np.savez(vpath, ids=ids, versions=vs)
        _fsync_file(vpath)
        files[_VERSIONS] = {"sha256": _sha256(vpath),
                            "bytes": os.path.getsize(vpath)}
    manifest = {"format_version": FORMAT_VERSION, "step": int(step),
                "dim": int(store.dim),
                "optimizer": getattr(store, "optimizer", None),
                "rows": len(store), "files": files,
                "created_at": time.time()}
    tmp = os.path.join(sdir, MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(sdir, MANIFEST))
    return sdir


def _verify(sdir: str, manifest: dict):
    for name, rec in manifest["files"].items():
        path = os.path.join(sdir, name)
        if not os.path.exists(path):
            raise SnapshotCorruptionError(f"{path} missing")
        if os.path.getsize(path) != rec["bytes"] or \
                _sha256(path) != rec["sha256"]:
            raise SnapshotCorruptionError(
                f"{path} does not match its manifest hash")


def committed_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        step = _parse_step(name)
        if step is not None and os.path.exists(
                os.path.join(directory, name, MANIFEST)):
            out.append(step)
    return sorted(out)


def latest_valid_step(directory: str) -> Optional[int]:
    """Newest committed step whose payload verifies — torn/corrupt
    snapshots are skipped, falling back to the previous good one."""
    for step in reversed(committed_steps(directory)):
        sdir = os.path.join(directory, _step_dirname(step))
        try:
            with open(os.path.join(sdir, MANIFEST)) as f:
                manifest = json.load(f)
            _verify(sdir, manifest)
            return step
        except (SnapshotCorruptionError, OSError, ValueError,
                KeyError):
            continue
    return None


def restore_kv_snapshot(store, directory: str,
                        step: Optional[int] = None
                        ) -> Dict[int, int]:
    """Load the newest valid (or a specific committed) snapshot into
    ``store``; hashes are re-verified first and a corrupt payload is
    refused. Returns the saved version counters ({} when none were
    stored)."""
    if step is None:
        step = latest_valid_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no valid committed snapshot under {directory}")
    sdir = os.path.join(directory, _step_dirname(step))
    mpath = os.path.join(sdir, MANIFEST)
    if not os.path.exists(mpath):
        raise FileNotFoundError(f"step {step} was never committed")
    with open(mpath) as f:
        manifest = json.load(f)
    if manifest.get("dim") != store.dim:
        raise SnapshotCorruptionError(
            f"snapshot dim {manifest.get('dim')} != store dim "
            f"{store.dim}")
    _verify(sdir, manifest)
    store.load(os.path.join(sdir, _TABLE))
    versions: Dict[int, int] = {}
    if _VERSIONS in manifest["files"]:
        with np.load(os.path.join(sdir, _VERSIONS)) as z:
            versions = {int(i): int(v)
                        for i, v in zip(z["ids"], z["versions"])}
    return versions
