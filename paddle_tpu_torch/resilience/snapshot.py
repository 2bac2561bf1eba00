"""Async snapshots with an atomic manifest commit
(``paddle_tpu/resilience/snapshot.py``).

Write path (``SnapshotEngine.save``):

1. **Host copy, synchronously** (the double buffer): every tensor leaf is
   copied to host memory as a numpy array (a bf16 tensor as its uint16
   bits, its dtype recorded in the manifest; numpy has no bf16); device
   tensors through pinned memory, all copies in flight at once. The
   caller may change the state the moment ``save`` returns.
2. **Background write**: one worker thread pickles and writes
   ``shards_pNNNNN.pkl`` through the injected fs (local or a fault
   wrapper), fsyncs, then writes a ``commit_pNNNNN.json`` with the file's
   sha256 (under a ``.tmp`` name, renamed once whole: process 0 reads
   it as soon as its name exists). At most ONE save is in flight and ONE pending (the second
   buffer); a third ``save`` blocks: backpressure, not unbounded host
   memory.
3. **Two-phase manifest commit** (process 0): wait for every process's
   commit record, merge them into ``manifest.json.tmp`` (per-file sha256
   and size, the flat tree's shapes), fsync, then atomically ``rename``
   to ``manifest.json``. A save killed at ANY earlier point leaves no
   manifest: the step directory is garbage, never a lie.

Read path: ``latest_valid_manifest`` scans step dirs newest-first and
returns the first whose manifest parses AND whose shard files all match
their recorded hashes: a torn or bit-rotted save is skipped, falling
back to the previous good one. ``restore`` re-verifies hashes before
unpickling and refuses a corrupted shard (``SnapshotCorruptionError``).

The files are the reference's, byte layout and names, so a float32 tree
written by either package restores in the other; a bf16 leaf restores as
bf16 only here. ``process_index``/``process_count`` default to one
process (0 of 1).

Sharded state (the ranks of a mesh, one process each): a leaf given as a
:class:`Shard` (:func:`shard_leaf`: this rank's block, its index region
in the whole leaf) is written as that region, and only by the first rank
that holds that block, so each unique block has one copy among the
processes' files. ``restore(shardings=)`` takes a tree of ``(spec,
mesh)`` pairs and gives :class:`Shard` leaves back: each rank reads every
file whole (it hashes it, then unpickles it, one file at a time) and
keeps only the slices that meet its blocks; a leaf without a pair
(``None`` or absent) is assembled whole on the host, from whatever
regions the files hold. Across N ranks the files are thus read N times:
the format is one pickle per process, and its manifest records no
regions, so a rank cannot tell which files it needs before it opens
them. The reference's sharded files (one process, one
region per device) restore here either way, and the port's restore in
the reference.

Emits ``resilience_snapshot_seconds`` / ``resilience_restore_seconds``
histograms and ``resilience_snapshots_total`` counters.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch import fs as fs_lib
from paddle_tpu_torch import observability
from paddle_tpu_torch.analysis.concurrency import guarded_by
from paddle_tpu_torch.resilience.retry import RetryPolicy, retry_call

MANIFEST = "manifest.json"
MANIFEST_TMP = MANIFEST + ".tmp"
FORMAT_VERSION = 1
_CHUNK = 1 << 16

# marker KEY for empty dict nodes: structure must survive the round trip
_EMPTY_KEY = "\x00empty"
_BF16 = "bfloat16"


class SnapshotError(IOError):
    """Base class for snapshot failures."""


class SnapshotCorruptionError(SnapshotError):
    """A shard file does not match the hash its manifest recorded."""


def _registry():
    return observability.default()


@dataclasses.dataclass
class Shard:
    """One rank's block of a leaf split over a mesh: ``data`` (the block),
    the whole leaf's ``shape``, the block's ``index`` (``(start, stop)``
    per dim) and ``write``: whether this rank writes it (the first of the
    ranks that hold this same block)."""

    data: Any
    shape: Tuple[int, ...]
    index: Tuple[Tuple[int, int], ...]
    write: bool = True


def shard_leaf(local, spec, mesh) -> Shard:
    """``local``, this rank's block of a leaf under ``spec`` (a spec tuple,
    as ``parallel.plan`` writes it) on ``mesh``, as a :class:`Shard`."""
    from paddle_tpu_torch.parallel.plan import block_index, mesh_coords
    coords = mesh_coords(mesh)
    shape = list(local.shape)
    named = set()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        named.update(axes)
        for a in axes:
            shape[dim] *= coords.get(a, (0, 1))[1]
    write = all(i == 0 for a, (i, _) in coords.items() if a not in named)
    return Shard(local, tuple(shape), block_index(tuple(shape), spec, coords),
                 write)


def _region(shape, placement) -> tuple:
    """This rank's region of a leaf of ``shape`` under a ``(spec, mesh)``
    placement."""
    from paddle_tpu_torch.parallel.plan import block_index, mesh_coords
    spec, mesh = placement
    return block_index(tuple(shape), tuple(spec), mesh_coords(mesh))


def _flatten_placements(tree, prefix=()) -> Dict[str, Any]:
    """``{"a/b": (spec, mesh) or None}`` of a ``shardings`` tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten_placements(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


def _copy_overlap(dst: np.ndarray, dst_idx, src_idx, data: np.ndarray,
                  seen: np.ndarray):
    """Copy the intersection of a stored slice (``data`` covering
    ``src_idx`` of the whole leaf) into a region buffer (``dst`` covering
    ``dst_idx``) and mark it in ``seen``; a no-op when they are
    disjoint."""
    sel_dst, sel_src = [], []
    for (da, db), (sa, sb) in zip(dst_idx, src_idx):
        lo, hi = max(da, sa), min(db, sb)
        if lo >= hi:
            return
        sel_dst.append(slice(lo - da, hi - da))
        sel_src.append(slice(lo - sa, hi - sa))
    dst[tuple(sel_dst)] = data[tuple(sel_src)]
    seen[tuple(sel_dst)] = True


# -- tree <-> flat dict -------------------------------------------------------

def flatten_tree(tree, prefix=()) -> Dict[str, Any]:
    """``{"a/b/c": leaf}`` of a dict tree; an empty dict becomes one
    ``.../\\x00empty`` key. Keys must be str; lists and tuples are
    refused."""
    if isinstance(tree, dict):
        if not tree:
            return {"/".join(prefix + (_EMPTY_KEY,)): np.int8(0)}
        out = {}
        for k in sorted(tree):
            if not isinstance(k, str):
                raise TypeError(
                    f"snapshot state dict keys must be str, got "
                    f"{type(k).__name__} key {k!r} at "
                    f"{'/'.join(prefix) or '<root>'}")
            out.update(flatten_tree(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        raise TypeError(
            f"snapshot state trees must be dicts with array leaves; got a "
            f"{type(tree).__name__} container at "
            f"{'/'.join(prefix) or '<root>'} — convert it to a dict "
            "(e.g. {'0': ..., '1': ...}) before checkpointing")
    return {"/".join(prefix): tree}


def unflatten_tree(flat: Dict[str, Any]):
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if parts[-1] == _EMPTY_KEY:
            continue  # the walk above materialized the empty dict
        node[parts[-1]] = val
    return tree


def host_arrays(leaves: Dict[str, Any]) -> Dict[str, tuple]:
    """``{key: (numpy copy, dtype name or None)}`` of the leaves, bf16 as
    its uint16 bits (dtype "bfloat16"). Device tensors are copied into
    pinned host memory asynchronously, all of them, then the host waits
    once for their devices (instead of one synchronous copy per tensor)."""
    out, devices = {}, set()
    for key, leaf in leaves.items():
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            if t.is_cuda:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                devices.add(t.device)
            else:
                host = t.clone()
            out[key] = host
        else:
            out[key] = np.array(leaf, copy=True)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    for key, a in out.items():
        if not isinstance(a, torch.Tensor):
            out[key] = (a, None)
        elif a.dtype == torch.bfloat16:
            out[key] = (a.view(torch.int16).numpy().view(np.uint16), _BF16)
        else:
            out[key] = (a.numpy(), None)
    return out


def to_tensor(a, dtype: Optional[str] = None) -> torch.Tensor:
    """A host array read back as a CPU tensor (copied only when the array
    is read-only, as arrays unpickled from bytes are); uint16 bits
    recorded as "bfloat16" as bf16."""
    a = np.asarray(a)
    t = torch.from_numpy(a if a.flags.writeable else a.copy())
    if dtype == _BF16:
        t = t.view(torch.bfloat16)
    return t


def _fsync(f):
    f.flush()
    try:
        os.fsync(f.fileno())
    except (AttributeError, OSError, ValueError):
        pass  # fs wrappers / non-file objects: flush is the best we have


def _write_bytes(fs, path: str, payload: bytes):
    """Chunked write + fsync so a mid-write kill tears at a real offset."""
    f = fs.open_write(path)
    try:
        for off in range(0, len(payload), _CHUNK):
            f.write(payload[off:off + _CHUNK])
        _fsync(f)
    finally:
        f.close()


def _shard_file(process: int) -> str:
    return f"shards_p{process:05d}.pkl"


def _commit_file(process: int) -> str:
    return f"commit_p{process:05d}.json"


def _step_dirname(step: int) -> str:
    return f"step_{int(step):010d}"


def _parse_step(name: str) -> Optional[int]:
    if not name.startswith("step_"):
        return None
    try:
        return int(name[len("step_"):])
    except ValueError:
        return None


@guarded_by("_err_lock", "_error")
class SnapshotEngine:
    """Async, atomically committed checkpoints under ``directory``.

    ``fs`` defaults to :func:`paddle_tpu_torch.fs.get_fs`; the
    fault-injection tests pass wrapped filesystems. With
    ``process_count > 1`` every process writes its own file and process 0
    publishes the manifest once all commit records are there (the
    directory must be shared)."""

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 fs=None, retry: Optional[RetryPolicy] = None,
                 process_index: int = 0, process_count: int = 1,
                 manifest_wait_s: float = 300.0):
        if fs is None:
            fs, directory = fs_lib.get_fs(directory)
        elif directory.startswith("file://"):
            directory = directory[len("file://"):]
        self.fs = fs
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.retry = retry or RetryPolicy(max_attempts=3, base_delay_s=0.1,
                                          deadline_s=manifest_wait_s)
        self.manifest_wait_s = manifest_wait_s
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.fs.mkdirs(self.directory)
        # writer-thread failure handoff: the worker sets it, the next
        # save()/wait() read-and-clears it under _err_lock
        self._err_lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._worker = threading.Thread(
            target=self._drain, name="snapshot-writer", daemon=True)
        self._worker.start()
        self._closed = False

    # -- write side ---------------------------------------------------------
    def save(self, step: int, state: Any, *, wait: bool = False):
        """Snapshot ``state`` at ``step``. Returns once the host copy is
        taken (double buffer); the write happens on the worker thread;
        ``wait=True`` blocks until the manifest is committed. A failure in
        a previous background save is re-raised here (or in ``wait``)."""
        self._raise_pending()
        t0 = time.perf_counter()
        flat = flatten_tree(state)
        blocks = {k: v for k, v in flat.items() if isinstance(v, Shard)}
        leaves = {}
        for key, (a, dtype) in host_arrays(
                {k: v.data if k in blocks else v
                 for k, v in flat.items()}).items():
            if key in blocks:
                b = blocks[key]
                leaves[key] = {"shape": tuple(b.shape),
                               "shards": [(tuple(b.index), a)] if b.write
                               else []}
            else:
                leaves[key] = {"shape": tuple(a.shape),
                               "shards": [(tuple((0, d) for d in a.shape),
                                           a)]}
            if dtype is not None:
                leaves[key]["dtype"] = dtype
        blocking_s = time.perf_counter() - t0
        _registry().histogram(
            "resilience_snapshot_blocking_seconds",
            "host-copy time save() spends on the caller's thread").observe(
                blocking_s)
        # a completed span on the caller's thread; the queue carries it so
        # the writer's snapshot.write span parents to it
        tracer = observability.tracing.default()
        span = None
        if tracer.enabled:
            span = tracer.record_span("snapshot.save_blocking",
                                      duration_s=blocking_s, step=step)
        # blocks when one save is already pending behind the in-flight one
        self._queue.put((int(step), leaves, t0, span))
        if wait:
            self.wait_until_finished()

    def _drain(self):
        tracer = observability.tracing.default()
        while True:
            job = self._queue.get()
            try:
                if job is None:
                    return
                step, leaves, t0, parent = job
                tw0 = tracer.now()
                self._write_snapshot(step, leaves)
                if tracer.enabled:
                    tracer.record_span("snapshot.write", start=tw0,
                                       parent=parent, step=step)
                _registry().histogram(
                    "resilience_snapshot_seconds",
                    "save() start to manifest commit").observe(
                        time.perf_counter() - t0)
                _registry().counter(
                    "resilience_snapshots_total",
                    "successfully committed snapshots").inc()
            except BaseException as e:  # surfaced on next save()/wait()
                with self._err_lock:
                    self._error = e
            finally:
                self._queue.task_done()

    def _write_snapshot(self, step: int, leaves: Dict[str, dict]):
        sdir = self._step_dir(step)
        if self.fs.is_exist(os.path.join(sdir, MANIFEST)):
            # committed snapshots are immutable: a re-save of the same
            # step (an emergency snapshot right after a periodic one) is a
            # no-op
            _registry().counter(
                "resilience_snapshot_already_committed_total",
                "saves skipped because the step was already committed"
            ).inc()
            return
        self.fs.mkdirs(sdir)
        payload = pickle.dumps(
            {"format": FORMAT_VERSION, "process": self.process_index,
             "leaves": {k: {"shape": v["shape"], "shards": v["shards"]}
                        for k, v in leaves.items()}},
            protocol=pickle.HIGHEST_PROTOCOL)
        digest = hashlib.sha256(payload).hexdigest()
        fname = _shard_file(self.process_index)
        retry_call(_write_bytes, self.fs, os.path.join(sdir, fname),
                   payload, policy=self.retry, op="shard_write")
        commit = {"file": fname, "sha256": digest, "bytes": len(payload),
                  "process": self.process_index}
        cpath = os.path.join(sdir, _commit_file(self.process_index))
        retry_call(_write_bytes, self.fs, cpath + ".tmp",
                   json.dumps(commit).encode(),
                   policy=self.retry, op="commit_write")
        self.fs.rename(cpath + ".tmp", cpath)
        if self.process_index == 0:
            self._commit_manifest(step, sdir, leaves)
            self._gc()

    def _commit_manifest(self, step: int, sdir: str, leaves: Dict[str, dict]):
        """Phase two: merge every process's commit record, write tmp,
        fsync, rename. Only an intact rename makes the snapshot visible."""
        files = {}
        deadline = time.monotonic() + self.manifest_wait_s
        for p in range(self.process_count):
            cpath = os.path.join(sdir, _commit_file(p))
            while True:
                if self.fs.is_exist(cpath):
                    with self.fs.open_read(cpath) as f:
                        rec = json.loads(f.read().decode())
                    files[rec["file"]] = {"sha256": rec["sha256"],
                                          "bytes": rec["bytes"]}
                    break
                if time.monotonic() > deadline:
                    raise SnapshotError(
                        f"process {p} never committed its shards for step "
                        f"{step} (waited {self.manifest_wait_s}s)")
                time.sleep(0.02)
        tree = {}
        for k, v in sorted(leaves.items()):
            tree[k] = {"shape": list(v["shape"])}
            if "dtype" in v:
                tree[k]["dtype"] = v["dtype"]
        manifest = {
            "format": FORMAT_VERSION,
            "step": int(step),
            "process_count": self.process_count,
            "files": files,
            "tree": tree,
            "created_unix": time.time(),
        }
        tmp = os.path.join(sdir, MANIFEST_TMP)
        retry_call(_write_bytes, self.fs, tmp,
                   json.dumps(manifest, indent=1).encode(),
                   policy=self.retry, op="manifest_write")
        self.fs.rename(tmp, os.path.join(sdir, MANIFEST))

    def _gc(self):
        """Keep the newest ``max_to_keep`` committed snapshots; sweep
        uncommitted (torn) step dirs strictly OLDER than the newest
        committed one. "Committed" means the manifest file exists: no hash
        pass here (integrity is the read path's job)."""
        committed = self._committed_steps()
        if not committed:
            return
        newest = committed[-1]
        for s in committed[:-self.max_to_keep] if self.max_to_keep else []:
            self.fs.delete(self._step_dir(s))
        dirs, _ = self.fs.ls_dir(self.directory)
        for name in dirs:
            s = _parse_step(name)
            if s is not None and s < newest and s not in committed:
                self.fs.delete(os.path.join(self.directory, name))

    # -- read side ----------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, _step_dirname(step))

    def _candidate_steps(self) -> List[int]:
        dirs, _ = self.fs.ls_dir(self.directory)
        return sorted(s for s in (_parse_step(d) for d in dirs)
                      if s is not None)

    def _committed_steps(self) -> List[int]:
        """Steps whose manifest FILE exists, ascending (no hash pass)."""
        return [s for s in self._candidate_steps()
                if self.fs.is_exist(os.path.join(self._step_dir(s),
                                                 MANIFEST))]

    def _load_manifest(self, step: int) -> dict:
        """Parse + hash-verify one step's manifest; raises on any defect."""
        sdir = self._step_dir(step)
        mpath = os.path.join(sdir, MANIFEST)
        if not self.fs.is_exist(mpath):
            raise SnapshotError(f"no manifest for step {step} (torn save?)")
        with self.fs.open_read(mpath) as f:
            manifest = json.loads(f.read().decode())
        if manifest.get("format") != FORMAT_VERSION:
            raise SnapshotError(
                f"manifest format {manifest.get('format')!r} != "
                f"{FORMAT_VERSION}")
        for fname, meta in manifest["files"].items():
            fpath = os.path.join(sdir, fname)
            if not self.fs.is_exist(fpath):
                raise SnapshotCorruptionError(
                    f"step {step}: shard file {fname} is missing")
            h = hashlib.sha256()
            n = 0
            with self.fs.open_read(fpath) as f:
                while True:
                    chunk = f.read(_CHUNK)
                    if not chunk:
                        break
                    h.update(chunk)
                    n += len(chunk)
            if n != meta["bytes"] or h.hexdigest() != meta["sha256"]:
                raise SnapshotCorruptionError(
                    f"step {step}: shard file {fname} fails verification "
                    f"(got {n}B/{h.hexdigest()[:12]}, manifest says "
                    f"{meta['bytes']}B/{meta['sha256'][:12]})")
        return manifest

    def latest_valid_manifest(self) -> Optional[dict]:
        """Newest manifest that parses AND verifies, skipping past torn or
        corrupted saves. None when no restorable snapshot exists."""
        for step in reversed(self._candidate_steps()):
            try:
                return self._load_manifest(step)
            except SnapshotError:
                _registry().counter(
                    "resilience_invalid_snapshots_total",
                    "snapshots skipped as torn/corrupt during scan").inc()
        return None

    def all_steps(self) -> List[int]:
        """Steps with a valid (verified) manifest, ascending."""
        out = []
        for step in self._candidate_steps():
            try:
                self._load_manifest(step)
                out.append(step)
            except SnapshotError:
                pass
        return out

    def latest_step(self, *, verify: bool = True) -> Optional[int]:
        """Newest restorable step. ``verify=True`` hash-checks (what a
        resume decision needs); ``verify=False`` is a cheap committed-
        manifest scan."""
        if not verify:
            committed = self._committed_steps()
            return committed[-1] if committed else None
        m = self.latest_valid_manifest()
        return None if m is None else int(m["step"])

    def restore(self, step: Optional[int] = None, *, target: Any = None,
                shardings: Any = None):
        """Load a snapshot as a tree of CPU tensors (bf16 leaves as bf16).
        ``step=None`` takes the newest valid one (falling back past
        corrupt saves); an explicit ``step`` is verified and REFUSED if
        corrupted. With ``target``, key/shape agreement is enforced before
        any shard bytes are read.

        ``shardings`` is a tree of ``(spec, mesh)`` pairs (or None)
        mirroring the state: a leaf with a pair comes back as this rank's
        :class:`Shard`, copied out of the slices that meet its region;
        every other leaf is assembled whole. Every file is read whole on
        every rank either way (module docstring).
        ``resilience_restore_max_region_bytes`` gauges the largest region
        buffer the restore made, not the bytes it read."""
        t0 = time.perf_counter()
        if step is None:
            manifest = self.latest_valid_manifest()
            if manifest is None:
                return None
            step = int(manifest["step"])
        else:
            manifest = self._load_manifest(step)  # raises on corruption
        sdir = self._step_dir(step)
        tree_meta = manifest["tree"]
        shapes = {k: tuple(v["shape"]) for k, v in tree_meta.items()}
        if target is not None:
            self._check_target(target, shapes)
        places = ({k: v for k, v in _flatten_placements(shardings).items()
                   if v is not None} if shardings is not None else {})
        needed = {k: (_region(shape, places[k]) if k in places
                      else tuple((0, d) for d in shape))
                  for k, shape in shapes.items()}
        # stream the files once, copying only the slices that meet each
        # leaf's region into a buffer made on first need (or aliasing a
        # stored slice that IS the region)
        bufs: Dict[str, np.ndarray] = {}
        seen: Dict[str, Any] = {}
        for fname in manifest["files"]:
            with self.fs.open_read(os.path.join(sdir, fname)) as f:
                part = pickle.loads(f.read())
            for key, rec in part["leaves"].items():
                region = needed.get(key)
                if region is None:
                    continue
                for idx, data in rec["shards"]:
                    idx = tuple(tuple(int(x) for x in i) for i in idx)
                    if seen.get(key) is True:
                        break
                    if idx == region and key not in bufs:
                        bufs[key], seen[key] = data, True
                        continue
                    if key not in bufs:
                        bufs[key] = np.empty(tuple(b - a for a, b in region),
                                             dtype=data.dtype)
                        seen[key] = np.zeros(bufs[key].shape, dtype=bool)
                    _copy_overlap(bufs[key], region, idx, data, seen[key])
        flat: Dict[str, Any] = {}
        max_region = 0
        for key, region in needed.items():
            got = seen.get(key)
            if key not in bufs or (got is not True and not got.all()):
                raise SnapshotCorruptionError(
                    f"step {step}: the files do not cover {key} region "
                    f"{region}")
            max_region = max(max_region, bufs[key].nbytes)
            t = to_tensor(bufs[key], tree_meta[key].get("dtype"))
            if key in places:
                spec, mesh = places[key]
                t = shard_leaf(t, tuple(spec), mesh)
            flat[key] = t
        tree = unflatten_tree(flat)
        _registry().gauge(
            "resilience_restore_max_region_bytes",
            "largest single host buffer the last restore made").set(
                float(max_region))
        restore_s = time.perf_counter() - t0
        _registry().histogram(
            "resilience_restore_seconds",
            "verified manifest to assembled host tree").observe(restore_s)
        tracer = observability.tracing.default()
        if tracer.enabled:
            tracer.record_span("snapshot.restore", duration_s=restore_s,
                               step=step, sharded=bool(places))
        return tree

    def _check_target(self, target: Any, shapes: Dict[str, tuple]):
        """Key/shape agreement between ``target`` and a manifest's tree
        schema, BEFORE any shard bytes are read."""
        tflat = flatten_tree(target)
        missing = set(tflat) - set(shapes)
        extra = set(shapes) - set(tflat)
        if missing or extra:
            raise SnapshotError(
                f"snapshot/target mismatch: missing={sorted(missing)[:5]}"
                f" extra={sorted(extra)[:5]}")
        for k, v in tflat.items():
            if hasattr(v, "shape") and shapes[k] != tuple(v.shape):
                raise SnapshotError(
                    f"shape mismatch for {k}: {shapes[k]} vs "
                    f"{tuple(v.shape)}")

    # -- lifecycle ----------------------------------------------------------
    def _raise_pending(self):
        with self._err_lock:
            e, self._error = self._error, None
        if e is not None:
            raise e

    def wait_until_finished(self):
        self._queue.join()
        self._raise_pending()

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._queue.put(None)
        self._worker.join()
        self._raise_pending()
