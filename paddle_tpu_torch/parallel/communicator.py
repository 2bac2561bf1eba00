"""Async-update communicators: the reference's non-BSP training modes
(``paddle_tpu/parallel/communicator.py``).

- :class:`AsyncCommunicator`: the "pserver" is a host-resident master
  copy of the dense parameters; device steps produce gradients, a host
  thread merges and applies them with a port optimizer while the device
  keeps stepping on stale parameters (sparse tables get the same mode
  from ``HostKVStore``'s async push).
- GeoSGD in two forms: :func:`geo_sgd_sync`, the delta merge over a mesh
  axis on ``torch.distributed`` (each rank holds its own worker's row,
  the masked deltas are all-reduced over the axis), and
  :class:`GeoSgdCommunicator`, the same math on stacked ``(K, ...)``
  replicas in one process.
- :class:`FLCommunicator`: federated averaging over stacked clients.

Parameter sets are trees: nested dicts, lists or tuples with tensors at
the leaves (stacked leaves carry the replica or client axis first).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np
import torch

from paddle_tpu_torch.core import mesh as mesh_lib
from paddle_tpu_torch.parallel import collective


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        if any(set(t) != set(first) for t in trees[1:]):
            raise ValueError("trees have different keys")
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        if any(len(t) != len(first) for t in trees[1:]):
            raise ValueError("trees have different lengths")
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _host(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().to("cpu", copy=True)


class AsyncCommunicator:
    """Background gradient merge and apply over a host master copy.

    ``make_optimizer(params)`` builds a port optimizer over a list of
    tensors (``lambda ps: SGD(ps, 0.1)``); it runs on the host copy of
    ``params`` (a tree of tensors). ``push(grads)`` never waits for the
    optimizer: a worker thread drains the queue, merges up to
    ``max_merge`` pending gradient trees (the send-queue merge of the
    reference's communicator) into their mean and applies ONE optimizer
    step for it. ``pull()`` copies the current master parameters (what a
    trainer would fetch from the pserver).
    """

    _error: Optional[Exception] = None

    def __init__(self, make_optimizer, params, *, max_merge: int = 20,
                 queue_size: int = 64):
        self._lock = threading.Lock()
        self._params = _tree_map(_host, params)
        self._flat = _leaves(self._params)
        self.optimizer = make_optimizer(self._flat)
        self._q: queue.Queue = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._cv = threading.Condition()
        self._pending = 0
        self.max_merge = max_merge
        self.merged_updates = 0    # optimizer applications
        self.pushed = 0            # gradients received
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def push(self, grads):
        """Enqueue one step's gradients (copied to the host; blocks only
        when the queue is full, like a bounded send queue)."""
        self._raise_if_failed()
        grads = _tree_map(_host, grads)
        with self._cv:
            self._pending += 1
        self._q.put(grads)

    def pull(self):
        with self._lock:
            return _tree_map(lambda p: p.detach().clone(), self._params)

    def _worker(self):
        while not self._stop.is_set() or not self._q.empty():
            try:
                items = [self._q.get(timeout=0.05)]
            except queue.Empty:
                continue
            # the whole merge batch first: the count is known before any
            # compute can raise, so _pending stays right
            while len(items) < self.max_merge:
                try:
                    items.append(self._q.get_nowait())
                except queue.Empty:
                    break
            count = len(items)
            try:
                merged = items[0]
                for nxt in items[1:]:
                    merged = _tree_map(torch.add, merged, nxt)
                mean = _leaves(_tree_map(lambda g: g / count, merged))
                if len(mean) != len(self._flat):
                    raise ValueError("gradient tree does not match the "
                                     "parameters")
                with self._lock:
                    for p, g in zip(self._flat, mean):
                        p.grad = g.to(p.dtype).reshape(p.shape)
                    self.optimizer.step()
                    for p in self._flat:
                        p.grad = None
                    self.merged_updates += 1
                    self.pushed += count
            except Exception as e:
                # surfaces at the next flush()/push() instead of killing
                # the thread and leaving waiters hung
                self._error = e
            with self._cv:
                self._pending -= count
                self._cv.notify_all()

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("AsyncCommunicator worker failed") from err

    def flush(self):
        """Wait until every pushed gradient has been applied."""
        with self._cv:
            self._cv.wait_for(lambda: self._pending == 0)
        self._raise_if_failed()

    def stop(self):
        self.flush()
        self._stop.set()
        self._thread.join()


def geo_sgd_sync(local_params, anchor, *, participants=None, axis="dp",
                 mesh=None):
    """One GeoSGD sync point over the ranks of ``axis``. Each rank holds
    its own worker's row: ``local_params`` is a tree of ``(1, ...)``
    leaves (its block of the stacked ``(n, ...)`` parameters), ``anchor``
    the replicated tree of ``(...)`` leaves. ``participants`` is an
    ``(n,)`` bool mask of the workers pushing this round (every rank
    passes the same mask). The merge, with ``m_k`` this rank's flag::

        anchor' = anchor + all_reduce(m_k * (local_k - anchor)) / n
        local_k' = anchor' if m_k else local_k

    With everyone participating this is replica averaging (LocalSGD); the
    anchor matters when participation is partial. Returns
    ``(new_local, new_anchor)``."""
    mesh = mesh if mesh is not None else mesh_lib.current_mesh()
    if mesh is None:
        raise ValueError("geo_sgd_sync requires a mesh")
    n = mesh_lib.axis_size(mesh, axis)
    rows = _leaves(local_params)[0].shape[0]
    if rows != 1:
        raise ValueError(f"each rank holds exactly its own worker row; got "
                         f"local leaves with {rows} rows")
    if participants is None:
        participants = np.ones((n,), bool)
    mask = np.asarray(participants, bool).reshape(-1)
    if mask.shape != (n,):
        raise ValueError(f"participants must be ({n},), got {mask.shape}")
    m = float(mask[mesh_lib.axis_index(mesh, axis)])

    def merge(p, a):
        delta = (m * (p[0] - a)).contiguous()
        return a + collective.all_reduce(delta, axis, mesh=mesh) / n

    new_anchor = _tree_map(merge, local_params, anchor)
    new_local = _tree_map(lambda p, a: a[None].clone() if m else p,
                          local_params, new_anchor)
    return new_local, new_anchor


class GeoSgdCommunicator:
    """GeoSGD over K stacked local replicas in one process.

    Replica parameters are stacked ``(K, ...)`` leaves. Each replica
    pushes on its own cadence (``sync_every`` may be per replica, the
    reference's per-trainer push count); at a sync point the
    participating replicas' deltas move the anchor and those replicas
    reset to it while the rest keep training locally::

        anchor' = anchor + sum_{k in S}(params_k - anchor) / K
        params_k' = anchor'  (k in S);  unchanged otherwise
    """

    def __init__(self, sync_every):
        every = np.atleast_1d(np.asarray(sync_every, np.int64))
        if (every < 1).any():
            raise ValueError("sync_every must be >= 1")
        self.sync_every = every

    def init_anchor(self, stacked_params):
        """Anchor = replica 0 (replicas start identical)."""
        return _tree_map(lambda x: x[0].clone(), stacked_params)

    def sync(self, stacked_params, anchor, participants=None):
        k = _leaves(stacked_params)[0].shape[0]
        m = (torch.ones((k,), dtype=torch.bool) if participants is None
             else torch.as_tensor(np.asarray(participants, bool)))

        def bmask(p):
            return m.to(p.device).reshape((k,) + (1,) * (p.ndim - 1))

        new_anchor = _tree_map(
            lambda p, a: a + torch.where(bmask(p), p - a,
                                         p.new_zeros(())).sum(0) / k,
            stacked_params, anchor)
        new_stacked = _tree_map(
            lambda p, a: torch.where(bmask(p), a[None], p),
            stacked_params, new_anchor)
        return new_stacked, new_anchor

    def maybe_sync(self, stacked_params, anchor, step: int):
        """Host-loop form: the replicas whose cadence divides ``step + 1``
        take part this round."""
        participants = (step + 1) % self.sync_every == 0
        if not participants.any():
            return stacked_params, anchor
        k = _leaves(stacked_params)[0].shape[0]
        return self.sync(stacked_params, anchor,
                         np.broadcast_to(participants, (k,)))


class FLCommunicator:
    """Federated-averaging server (the reference's fl_listen_and_serv: a
    synchronous loop over ``Fanin`` clients, merged globals re-sent each
    round).

    Rounds are explicit: each round the caller trains a subset of clients
    (rows of stacked ``(K, ...)`` leaves) from the current globals, then
    :meth:`aggregate` folds the participants back weighted by their
    example counts::

        global' = sum_{k in S} n_k * params_k / sum_{k in S} n_k
    """

    def __init__(self, min_fanin: int = 1):
        if min_fanin < 1:
            raise ValueError("min_fanin must be >= 1")
        self.min_fanin = min_fanin
        self.rounds = 0

    def broadcast(self, global_params, num_clients: int):
        """globals -> stacked ``(K, ...)`` client copies for this round."""
        return _tree_map(
            lambda x: x[None].expand((num_clients,) + tuple(x.shape))
            .clone(), global_params)

    def aggregate(self, stacked_params, *, num_examples,
                  participants=None):
        """FedAvg merge. ``num_examples``: ``(K,)`` per-client sample
        counts this round; ``participants``: an optional ``(K,)`` bool
        mask of the clients that reported back. Returns the new globals
        (each leaf in its own dtype)."""
        k = _leaves(stacked_params)[0].shape[0]
        n = torch.as_tensor(np.asarray(num_examples, np.float32))
        if tuple(n.shape) != (k,):
            raise ValueError(f"num_examples must be ({k},), got "
                             f"{tuple(n.shape)}")
        m = (torch.ones((k,), dtype=torch.bool) if participants is None
             else torch.as_tensor(np.asarray(participants, bool))
             .reshape(k))
        if int(m.sum()) < self.min_fanin:
            raise ValueError(
                f"only {int(m.sum())} clients reported; fanin "
                f"{self.min_fanin} required (fl_listen_and_serv Fanin)")
        w = n * m
        total = float(w.sum())
        if total <= 0.0:
            raise ValueError(
                "every participating client reported 0 examples: "
                "aggregating would zero the globals; skip this round")
        w = w / total

        def merge(p):
            # cast back per leaf: float32 weights must not promote bf16
            # or integer leaves round over round
            return torch.tensordot(w.to(p.device), p.float(), dims=1) \
                .to(p.dtype)

        self.rounds += 1
        return _tree_map(merge, stacked_params)
