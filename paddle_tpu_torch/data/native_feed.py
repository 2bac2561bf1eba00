"""The native multi-threaded MultiSlot feed and the device loader
(``paddle_tpu/data/native_feed.py``).

Reference mapping: ``Dataset``/``DataFeed`` python wrappers (``dataset.py``
+ ``data_feed_desc.py`` driving the C++ MultiSlotDataFeed) and the
double-buffered device reader (``operators/reader/buffered_reader.cc``).
:class:`MultiSlotDataset` is ctypes over this package's own copy of
``native/data_feed.cc`` (byte for byte the reference's, so the same files
give the same batches and the same shuffle); :class:`DeviceLoader` stages
host batches onto the card one step ahead on a thread of its own.
"""

from __future__ import annotations

import ctypes
import itertools
import queue
import threading
import time
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch import native
from paddle_tpu_torch.core.device import resolve_device


def _lib():
    lib = native.load_library("datafeed", ["data_feed.cc"])
    lib.df_create.restype = ctypes.c_void_p
    lib.df_create.argtypes = [ctypes.c_char_p]
    lib.df_destroy.argtypes = [ctypes.c_void_p]
    lib.df_add_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.df_load_into_memory.restype = ctypes.c_int64
    lib.df_load_into_memory.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.df_last_error.restype = ctypes.c_char_p
    lib.df_last_error.argtypes = [ctypes.c_void_p]
    lib.df_shuffle.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.df_reset.argtypes = [ctypes.c_void_p]
    lib.df_next_batch.restype = ctypes.c_int64
    lib.df_next_batch.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int]
    lib.df_slot_maxlen.restype = ctypes.c_int64
    lib.df_slot_maxlen.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.df_slot_int_data.restype = ctypes.POINTER(ctypes.c_int64)
    lib.df_slot_int_data.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.df_slot_float_data.restype = ctypes.POINTER(ctypes.c_float)
    lib.df_slot_float_data.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.df_slot_lengths.restype = ctypes.POINTER(ctypes.c_int64)
    lib.df_slot_lengths.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.df_size.restype = ctypes.c_int64
    lib.df_size.argtypes = [ctypes.c_void_p]
    return lib


class MultiSlotDataset:
    """In-memory MultiSlot dataset backed by the native feed.

    slots: [(name, "int64"|"float32"), ...] in file column order. A line
    holds, per slot, a count and that many values. ``load_into_memory``
    parses the files on ``num_threads`` threads (instances kept in file
    order); ``global_shuffle(seed)`` permutes them with the library's
    ``mt19937_64``; a malformed line or a missing file raises
    ``RuntimeError`` with the library's message, as the reference does.
    """

    def __init__(self, slots: Sequence[Tuple[str, str]]):
        self._lib = _lib()
        self.slots = list(slots)
        spec = ",".join(
            f"{name}:{'f' if dtype.startswith('float') else 'i'}"
            for name, dtype in self.slots)
        self._h = self._lib.df_create(spec.encode())
        self._loaded = False

    def set_filelist(self, paths: Sequence[str]):
        for p in paths:
            self._lib.df_add_file(self._h, str(p).encode())

    def load_into_memory(self, num_threads: int = 8) -> int:
        n = self._lib.df_load_into_memory(self._h, num_threads)
        if n < 0:
            raise RuntimeError(
                self._lib.df_last_error(self._h).decode())
        self._loaded = True
        return int(n)

    def global_shuffle(self, seed: int = 0):
        self._lib.df_shuffle(self._h, seed)

    def __len__(self):
        return int(self._lib.df_size(self._h))

    # -- batch iteration ---------------------------------------------------
    def batches(self, batch_size: int, *, pad_value: int = 0,
                drop_last: bool = True, with_lengths: bool = False):
        """Yield {slot: np.ndarray (B, maxlen)} (+ f"{slot}_len" arrays
        when with_lengths — the LoD offsets analog). Single consumer."""
        self._lib.df_reset(self._h)
        while True:
            bs = self._lib.df_next_batch(self._h, batch_size, pad_value,
                                         int(drop_last))
            if bs == 0:
                return
            if bs < 0:
                err = self._lib.df_last_error(self._h)
                raise RuntimeError(
                    f"native data feed error (df_next_batch rc={int(bs)}): "
                    f"{err.decode() if err else 'unknown'}")
            out: Dict[str, np.ndarray] = {}
            for i, (name, dtype) in enumerate(self.slots):
                ml = self._lib.df_slot_maxlen(self._h, i)
                n = int(bs * ml)
                if dtype.startswith("float"):
                    ptr = self._lib.df_slot_float_data(self._h, i)
                    arr = np.ctypeslib.as_array(ptr, shape=(n,)).astype(
                        np.float32, copy=True)
                else:
                    ptr = self._lib.df_slot_int_data(self._h, i)
                    arr = np.ctypeslib.as_array(ptr, shape=(n,)).astype(
                        np.int64, copy=True)
                out[name] = arr.reshape(int(bs), int(ml))
                if with_lengths:
                    lp = self._lib.df_slot_lengths(self._h, i)
                    out[name + "_len"] = np.ctypeslib.as_array(
                        lp, shape=(int(bs),)).astype(np.int64, copy=True)
            yield out

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.df_destroy(self._h)
            self._h = None


def _signature(batch: Mapping) -> tuple:
    return tuple((k, tuple(np.shape(v)), np.asarray(v).dtype.str)
                 for k, v in batch.items())


class _Slot:
    """One staging slot of a batch signature: a pinned host buffer and a
    device buffer per feed, and the event of the last copy out of the
    pinned ones."""

    __slots__ = ("pinned", "dev", "copied")

    def __init__(self, pinned, dev):
        self.pinned = pinned
        self.dev = dev
        self.copied = None


class DeviceLoader:
    """Background-thread device prefetcher (``buffered_reader.cc``
    analog): host batches (dicts of numpy arrays or CPU tensors) are
    staged onto ``device`` one step ahead of consumption, at most
    ``buffer_size`` ahead.

    On the card every batch signature (feed names, shapes, dtypes) gets a
    ring of ``buffer_size + 1`` slots, each a pinned host buffer and a
    device buffer per feed, allocated once and reused: the loader thread
    writes a batch into a free slot's pinned buffers and copies them to
    its device buffers with ``non_blocking=True`` on a stream of its own,
    and the consumer's current stream waits on that copy's event before
    the batch is yielded. A slot goes back to the loader when the
    consumer asks for the next batch, with an event recorded on the
    consumer's stream; the loader's stream waits on it before the slot's
    device buffers are written again, and the loader waits on the slot's
    last copy before its pinned buffers are. So a yielded batch holds the
    slot's device buffers: use it (or copy it) before taking the next.

    Fault F9's discipline: pinned memory is allocated only for a new
    signature. The first batch is read in the constructor, on the
    caller's thread, and its ring allocated there, before a train step
    can capture; a later new signature is allocated by the loader thread
    and counted (:meth:`stats` ``pinned_allocations``, each with the
    process's CUDA graph capture count at that moment).

    On the CPU a batch is copied into fresh tensors (no pinned memory, no
    streams). Closing, early ``break`` included, stops the thread; an
    exception in the reader is raised in the consumer (the reference's
    ``:124-178``)."""

    def __init__(self, batch_iter: Iterable, *, buffer_size: int = 2,
                 device="cuda"):
        if buffer_size < 1:
            raise ValueError("buffer_size must be >= 1")
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._iter = iter(batch_iter)
        self._n_slots = buffer_size + 1
        self._q: queue.Queue = queue.Queue()
        self._free: queue.Queue = queue.Queue()
        for i in range(self._n_slots):
            self._free.put((i, None))
        self._rings: Dict[tuple, List[_Slot]] = {}
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._batches = 0
        self._host_s = 0.0
        self._wait_s = 0.0
        self._allocations: List[dict] = []
        self._stream = (torch.cuda.Stream(self.device) if self._cuda
                        else None)
        self._error = None
        try:
            first = next(self._iter, None)
        except Exception as e:  # raised in the consumer, as any later one
            first, self._error = None, e
        if first is not None and self._cuda:
            self._ring(first)
        self._first = first
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="DeviceLoader")
        self._thread.start()

    # -- loader thread -------------------------------------------------------
    def _ring(self, batch: Mapping) -> List[_Slot]:
        sig = _signature(batch)
        ring = self._rings.get(sig)
        if ring is None:
            from paddle_tpu_torch.observability import recompile
            ring = []
            for _ in range(self._n_slots):
                pinned, dev = {}, {}
                for k, v in batch.items():
                    t = torch.as_tensor(v)
                    pinned[k] = torch.empty(t.shape, dtype=t.dtype,
                                            pin_memory=True)
                    dev[k] = torch.empty(t.shape, dtype=t.dtype,
                                         device=self.device)
                ring.append(_Slot(pinned, dev))
            with self._lock:
                self._allocations.append({
                    "feeds": [k for k, *_ in sig],
                    "bytes": self._n_slots * sum(
                        t.numel() * t.element_size()
                        for t in ring[0].pinned.values()),
                    "thread": threading.current_thread().name,
                    "captures_before": recompile.capture_count()})
            self._rings[sig] = ring
        return ring

    def _stage(self, batch: Mapping, slot: int, released):
        if not self._cuda:
            return {k: torch.as_tensor(v).clone() for k, v in batch.items()}
        s = self._ring(batch)[slot]
        if s.copied is not None:
            t0 = time.perf_counter()
            s.copied.synchronize()     # the last copy out of these is done
            with self._lock:
                self._wait_s += time.perf_counter() - t0
        for k, v in batch.items():
            s.pinned[k].copy_(torch.as_tensor(v))
        with torch.cuda.stream(self._stream):
            if released is not None:
                self._stream.wait_event(released)
            for k, t in s.pinned.items():
                s.dev[k].copy_(t, non_blocking=True)
            s.copied = torch.cuda.Event()
            s.copied.record(self._stream)
        return dict(s.dev), s.copied

    def _take_slot(self):
        while not self._stop.is_set():
            try:
                return self._free.get(timeout=0.1)
            except queue.Empty:
                continue
        return None

    def _worker(self):
        try:
            if self._error is not None:
                raise self._error
            first, self._first = self._first, None
            source = (self._iter if first is None
                      else itertools.chain([first], self._iter))
            for batch in source:
                taken = self._take_slot()
                if taken is None:
                    return
                slot, released = taken
                t0 = time.perf_counter()
                staged = self._stage(batch, slot, released)
                with self._lock:
                    self._host_s += time.perf_counter() - t0
                    self._batches += 1
                self._q.put((slot, staged))
                if self._stop.is_set():
                    return
        except Exception as e:  # surface in the consumer
            self._q.put(e)
        finally:
            self._q.put(None)

    # -- consumer --------------------------------------------------------------
    def close(self, timeout: float = 5.0):
        """Stop the loader thread and wait for it (up to ``timeout`` s: a
        reader blocked in its own I/O finishes that item first)."""
        self._stop.set()
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout)

    def stats(self) -> dict:
        """Batches staged; the loader thread's host ms per batch (the
        write into pinned memory and the copies' issue) and its ms per
        batch waiting for a slot's last copy (which waits in turn for the
        consumer's use of the slot); and every pinned allocation with the
        CUDA graph capture count before it."""
        with self._lock:
            n = max(self._batches, 1)
            return {"batches": self._batches,
                    "host_ms_per_batch": (self._host_s - self._wait_s)
                    * 1e3 / n,
                    "wait_ms_per_batch": self._wait_s * 1e3 / n,
                    "pinned_allocations": [dict(a)
                                           for a in self._allocations]}

    def __iter__(self):
        held = None
        try:
            while True:
                if held is not None:
                    released = None
                    if self._cuda:
                        released = torch.cuda.Event()
                        released.record(torch.cuda.current_stream(
                            self.device))
                    self._free.put((held, released))
                    held = None
                item = self._q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                held, staged = item
                if self._cuda:
                    batch, copied = staged
                    torch.cuda.current_stream(self.device).wait_event(copied)
                else:
                    batch = staged
                yield batch
        finally:
            self.close()
