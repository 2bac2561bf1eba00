"""Host-resident KV embedding: the parameter-server world on one card
(``paddle_tpu/parallel/host_kv.py``).

A table beyond the card's memory lives in host memory (the package's own
``native/kv_store.cc``): the device step sees only the rows of the
current batch, so the "RPC" of the reference's pserver world is a host
hash lookup and a copy of a few MB to the card, which a prefetch overlaps
with the previous device step.

Per batch (sync mode)::

  uniq, inv = np.unique(feat_ids)            # host dedup
  rows = store.pull(uniq)                    # host KV gather (C++ threads)
  ...device: emb = embedding(inv, rows); the rows' gradient comes back
  store.push(uniq, grad_rows, lr)            # host sparse optimizer

Async mode: ``prefetch_batch`` starts the pull of batch N+1 while batch N
runs on the card; ``apply_grads(..., wait=False)`` applies the push on
the library's threads (hogwild-delayed, the AsyncCommunicator analog).

The number of unique ids varies by batch; ``rows`` is padded to a
power-of-two bucket, so the device step sees O(log U_max) shapes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from paddle_tpu_torch import native

OPT_SGD = 0
OPT_ADAGRAD = 1
_OPT_NAMES = {"sgd": OPT_SGD, "adagrad": OPT_ADAGRAD}


def _lib():
    lib = native.load_library("kvstore", ["kv_store.cc"])
    lib.kv_create.restype = ctypes.c_void_p
    lib.kv_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                              ctypes.c_uint64, ctypes.c_int, ctypes.c_int]
    lib.kv_destroy.argtypes = [ctypes.c_void_p]
    P_I64 = ctypes.POINTER(ctypes.c_int64)
    P_F32 = ctypes.POINTER(ctypes.c_float)
    lib.kv_pull.argtypes = [ctypes.c_void_p, P_I64, ctypes.c_int64, P_F32]
    lib.kv_pull_async.restype = ctypes.c_int64
    lib.kv_pull_async.argtypes = [ctypes.c_void_p, P_I64, ctypes.c_int64,
                                  P_F32]
    lib.kv_push.argtypes = [ctypes.c_void_p, P_I64, ctypes.c_int64, P_F32,
                            ctypes.c_float]
    lib.kv_push_async.restype = ctypes.c_int64
    lib.kv_push_async.argtypes = [ctypes.c_void_p, P_I64, ctypes.c_int64,
                                  P_F32, ctypes.c_float]
    lib.kv_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.kv_flush.argtypes = [ctypes.c_void_p]
    lib.kv_set_rows.argtypes = [ctypes.c_void_p, P_I64, ctypes.c_int64,
                                P_F32]
    lib.kv_size.restype = ctypes.c_int64
    lib.kv_size.argtypes = [ctypes.c_void_p]
    lib.kv_save.restype = ctypes.c_int
    lib.kv_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.kv_load.restype = ctypes.c_int
    lib.kv_load.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    return lib


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class HostKVStore:
    """ctypes handle over the native sharded KV table.

    ``dim`` is the row width the model sees (the optimizer's slot state is
    held natively beside it). Rows materialize lazily on first pull with a
    deterministic per-id init (uniform +-init_scale), the same bits as the
    reference's store with the same seed.
    """

    # class-level defaults, so a partly built instance (the native build
    # or load failed inside __init__) still tears down cleanly
    _h = None
    _lib = None

    def __init__(self, dim: int, *, optimizer: str = "adagrad",
                 init_scale: float = 0.01, seed: int = 0,
                 num_shards: int = 64, num_threads: int = 8):
        self._lib = _lib()
        self.dim = int(dim)
        self.optimizer = optimizer
        self._h = self._lib.kv_create(
            self.dim, _OPT_NAMES[optimizer], float(init_scale), int(seed),
            int(num_shards), int(num_threads)) or None
        if not self._h:
            raise RuntimeError("kv_create failed")

    def _handle(self):
        """The native handle, or a Python error after ``close()`` (a NULL
        handle handed to the library would crash in native code)."""
        h = self._h
        if h is None:
            raise RuntimeError("HostKVStore is closed")
        return h

    def pull(self, ids: np.ndarray, out: Optional[np.ndarray] = None
             ) -> np.ndarray:
        """Rows of ``ids``. ``out`` (if given) must be a C-contiguous
        float32 array of at least ids.size rows; the rows fill its leading
        slice (a pull straight into a padded buffer)."""
        ids = np.ascontiguousarray(ids, np.int64).ravel()
        if out is None:
            out = np.empty((ids.size, self.dim), np.float32)
        else:
            self._check_out(ids, out)
        self._lib.kv_pull(self._handle(), _i64p(ids), ids.size, _f32p(out))
        return out[:ids.size]

    def pull_async(self, ids: np.ndarray,
                   out: Optional[np.ndarray] = None) -> "PullHandle":
        """Start a pull on the library's threads; the handle keeps ``ids``
        and ``out`` alive until its ``wait()``."""
        ids = np.ascontiguousarray(ids, np.int64).ravel()
        if out is None:
            out = np.empty((ids.size, self.dim), np.float32)
        else:
            self._check_out(ids, out)
        ticket = self._lib.kv_pull_async(self._handle(), _i64p(ids),
                                         ids.size, _f32p(out))
        return PullHandle(self, ticket, ids, out)

    def _check_out(self, ids, out):
        if (out.dtype != np.float32 or not out.flags.c_contiguous
                or out.ndim != 2 or out.shape[0] < ids.size
                or out.shape[1] != self.dim):
            raise ValueError(
                f"out buffer must be C-contiguous float32 (>= {ids.size},"
                f" {self.dim}); got {out.dtype} {out.shape}")

    def push(self, ids: np.ndarray, grads: np.ndarray, lr: float,
             wait: bool = True):
        """Apply the store's optimizer to ``ids`` with ``grads``; with
        ``wait=False`` on the library's threads (it copies its inputs)."""
        ids = np.ascontiguousarray(ids, np.int64).ravel()
        grads = np.ascontiguousarray(grads, np.float32)
        if grads.shape != (ids.size, self.dim):
            raise ValueError(f"grads shape {grads.shape} != "
                             f"({ids.size}, {self.dim})")
        fn = self._lib.kv_push if wait else self._lib.kv_push_async
        fn(self._handle(), _i64p(ids), ids.size, _f32p(grads), float(lr))

    def set_rows(self, ids: np.ndarray, vals: np.ndarray):
        ids = np.ascontiguousarray(ids, np.int64).ravel()
        vals = np.ascontiguousarray(vals, np.float32)
        if vals.shape != (ids.size, self.dim):
            raise ValueError(f"vals shape {vals.shape} != "
                             f"({ids.size}, {self.dim})")
        self._lib.kv_set_rows(self._handle(), _i64p(ids), ids.size,
                              _f32p(vals))

    def flush(self):
        """Barrier for every outstanding async pull and push."""
        self._lib.kv_flush(self._handle())

    def __len__(self):
        return int(self._lib.kv_size(self._handle()))

    def save(self, path: str):
        """The table to ``path`` (the reference's binary format)."""
        self.flush()
        if self._lib.kv_save(self._handle(), str(path).encode()) != 0:
            raise IOError(f"kv_save({path}) failed")

    def load(self, path: str):
        if self._lib.kv_load(self._handle(), str(path).encode()) != 0:
            raise IOError(f"kv_load({path}) failed (dim/optimizer mismatch "
                          "or unreadable file)")

    def close(self):
        """Flush and destroy the native table. Idempotent, and safe on a
        store whose library never loaded (interpreter exit's ``__del__``
        must not fail over a half-built instance)."""
        h, self._h = getattr(self, "_h", None), None
        lib = getattr(self, "_lib", None)
        if h and lib is not None:
            try:
                lib.kv_flush(h)
            finally:
                lib.kv_destroy(h)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass  # interpreter teardown: never raise from __del__


class PullHandle:
    """An async pull in flight; its buffers stay alive here until
    ``wait()``. The library's threads write ``out`` (and read ``ids``)
    directly, so an abandoned handle still waits before they are freed
    (``__del__``); pushes copy their inputs, pulls do not."""

    def __init__(self, store: HostKVStore, ticket: int, ids, out):
        self._store, self._ticket = store, ticket
        self._ids, self._out = ids, out
        self._done = False

    def wait(self) -> np.ndarray:
        if not self._done:
            h = self._store._h
            if h is not None:       # a closed store flushed already
                self._store._lib.kv_wait(h, self._ticket)
            self._done = True
        return self._out

    def __del__(self):
        try:
            self.wait()
        except Exception:
            pass  # store already torn down


class SparseBatch(NamedTuple):
    """One batch's sparse rows, padded for the device step: ``rows[inv]``
    gives the per-feature rows; ``uniq`` is padded with -1 (zero rows) to
    a power-of-two bucket."""
    uniq: np.ndarray   # (U_pad,) int64, -1 padding
    rows: np.ndarray   # (U_pad, dim) float32
    inv: np.ndarray    # feat_ids.shape int32 indices into rows


def _bucket(n: int, minimum: int) -> int:
    b = max(minimum, 1)
    while b < n:
        b *= 2
    return b


class HostKVEmbedding:
    """Batch-level orchestration over :class:`HostKVStore`.

    The model's side: the step takes ``rows`` (U_pad, dim) as a
    differentiable input and ``inv`` as indices; its gradient with
    respect to ``rows`` is what :meth:`apply_grads` pushes back. The
    learning rate of the sparse optimizer lives here, on the host.
    """

    def __init__(self, store: HostKVStore, *, lr: float = 0.01,
                 min_bucket: int = 256):
        self.store = store
        self.lr = lr
        self.min_bucket = min_bucket

    def _dedup(self, feat_ids: np.ndarray):
        uniq, inv = np.unique(np.asarray(feat_ids, np.int64),
                              return_inverse=True)
        pad = _bucket(uniq.size, self.min_bucket)
        uniq_p = np.full((pad,), -1, np.int64)
        uniq_p[:uniq.size] = uniq
        return uniq, uniq_p, inv.reshape(feat_ids.shape).astype(np.int32)

    def lookup_batch(self, feat_ids: np.ndarray) -> SparseBatch:
        uniq, uniq_p, inv = self._dedup(feat_ids)
        rows = np.zeros((uniq_p.size, self.store.dim), np.float32)
        self.store.pull(uniq, out=rows)   # fills rows[:U] in place
        return SparseBatch(uniq_p, rows, inv)

    def prefetch_batch(self, feat_ids: np.ndarray) -> "SparsePrefetch":
        uniq, uniq_p, inv = self._dedup(feat_ids)
        rows = np.zeros((uniq_p.size, self.store.dim), np.float32)
        return SparsePrefetch(self.store.pull_async(uniq, out=rows),
                              uniq_p, inv)

    def apply_grads(self, batch: SparseBatch, grad_rows, *,
                    wait: bool = True):
        """Push the real rows' gradients (padding lanes dropped)."""
        if isinstance(grad_rows, torch.Tensor):
            grad_rows = grad_rows.detach().float().cpu().numpy()
        grad_rows = np.asarray(grad_rows, np.float32)
        real = batch.uniq >= 0
        self.store.push(batch.uniq[real], grad_rows[real], self.lr,
                        wait=wait)

    def flush(self):
        self.store.flush()


class SparsePrefetch:
    """A pull in flight straight into the padded rows buffer."""

    def __init__(self, handle: PullHandle, uniq_p, inv):
        self._handle, self._uniq_p, self._inv = handle, uniq_p, inv

    def wait(self) -> SparseBatch:
        return SparseBatch(self._uniq_p, self._handle.wait(), self._inv)


def fits_hbm(vocab_size: int, dim: int, *, budget_bytes: int,
             dtype_bytes: int = 4, optimizer_slots: int = 2) -> bool:
    """Placement policy: a table (with its device optimizer state) that
    fits the per-table device memory budget is sharded on the card;
    otherwise it goes to the host KV world (the beyond-HBM case)."""
    return vocab_size * dim * dtype_bytes * (1 + optimizer_slots) \
        <= budget_bytes


def _to_device(v, device):
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(v)
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return v


def build_kv_train_step(loss_fn, optimizer):
    """Train step for models with host-resident sparse tables.

    ``loss_fn(model, rows, **batch)`` returns a loss or ``(loss, aux)``;
    ``rows`` is the pulled ``(U_pad, dim)`` float32 tensor. Returns
    ``step(state, rows, **batch) -> (state, grad_rows, metrics)``
    (``state`` from :func:`paddle_tpu_torch.train.make_train_state`): the
    dense parameters update on the device through ``optimizer`` (in
    place, as the port's train step does), and ``grad_rows``, the
    gradient with respect to ``rows`` on the device, goes back to the
    host store. Numpy feeds are copied to the model's device. The step
    runs eagerly: its row width follows the batch's bucket."""

    def step(state, rows, **batch):
        model = state["model"]
        device = next(model.parameters()).device
        rows_t = _to_device(rows, device).float().requires_grad_(True)
        feeds = {k: _to_device(v, device) for k, v in batch.items()}
        optimizer.zero_grad(set_to_none=True)
        out = loss_fn(model, rows_t, **feeds)
        loss, aux = out if isinstance(out, tuple) else (out, {})
        loss.backward()
        optimizer.step()
        state["step"] += 1
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in aux.items()}}
        return state, rows_t.grad, metrics

    return step


def run_kv_epoch(step_fn, state, emb: HostKVEmbedding, batches,
                 ids_key: str = "feat_ids", *, prefetch: bool = True,
                 async_push: bool = False):
    """Drive one epoch of host-KV training.

    ``prefetch=True`` pulls batch i+1's rows (C++ threads, no GIL) while
    batch i runs on the card, the parameter prefetch of the reference's
    worker pipeline. ``async_push=True`` applies the gradient pushes on
    background threads (delayed, hogwild updates): reads may then be one
    batch stale, the reference's async semantics. ``prefetch=False,
    async_push=False`` is strictly synchronous (what parity tests use).

    ``batches`` yields dicts; ``batch[ids_key]`` are the sparse feature
    ids, every other key is fed to ``step_fn``. Returns ``(state,
    metrics per step)``."""
    history = []
    it = iter(batches)
    batch = next(it, None)
    pf = None
    while batch is not None:
        nxt = next(it, None) if prefetch else None
        if prefetch and pf is not None:
            sb = pf.wait()       # issued last iteration
        else:
            # the first batch, or strictly synchronous: pull after the
            # previous push landed
            sb = emb.lookup_batch(batch[ids_key])
        feed = {k: v for k, v in batch.items() if k != ids_key}
        state, grad_rows, metrics = step_fn(state, sb.rows, inv=sb.inv,
                                            **feed)
        if prefetch and nxt is not None:
            # the next batch's dedup and pull start once this step is
            # issued, so both run while the card works
            pf = emb.prefetch_batch(nxt[ids_key])
        emb.apply_grads(sb, grad_rows, wait=not async_push)
        history.append(metrics)
        batch = nxt if prefetch else next(it, None)
    emb.flush()
    return state, history
