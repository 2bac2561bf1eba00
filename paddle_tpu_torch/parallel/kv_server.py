"""Parameter-server process and remote client for the host KV store
(``paddle_tpu/parallel/kv_server.py``).

The server (the package's own ``native/kv_server.cc``) serves the C++ KV
store over a length-prefixed TCP protocol, the reference's wire byte for
byte, so a client of either package talks to a server of the other.
:class:`RemoteKVStore` has :class:`~paddle_tpu_torch.parallel.host_kv.
HostKVStore`'s surface, so ``HostKVEmbedding``, the DeepFM KV pipeline and
the embedding serving engine run unchanged against a remote table: a pull
or push is one round trip per batch, and prefetch hides the wire latency
as it hides the hash lookups.

Run a standalone pserver:
    python -m paddle_tpu_torch.parallel.kv_server --dim 9 --port 0
It prints ``PORT <n>`` once serving.
"""

from __future__ import annotations

import ctypes
import socket
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from paddle_tpu_torch import native
from paddle_tpu_torch.parallel.host_kv import _OPT_NAMES

OP_PULL, OP_PUSH, OP_SET, OP_SIZE, OP_DIM, OP_SAVE, OP_LOAD = range(1, 8)


def _lib():
    lib = native.load_library("kvserver", ["kv_server.cc", "kv_store.cc"])
    lib.kvs_start.restype = ctypes.c_void_p
    lib.kvs_start.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                              ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int]
    lib.kvs_port.restype = ctypes.c_int
    lib.kvs_port.argtypes = [ctypes.c_void_p]
    lib.kvs_stop.argtypes = [ctypes.c_void_p]
    return lib


class KVServer:
    """In-process handle on a serving pserver (native accept loop)."""

    # class-level defaults: a partially-constructed server (native
    # build/load failed mid-__init__) must still stop() cleanly
    _h = None
    _lib = None

    def __init__(self, dim: int, *, optimizer: str = "adagrad",
                 init_scale: float = 0.01, seed: int = 0,
                 num_shards: int = 64, num_threads: int = 8,
                 port: int = 0):
        self._lib = _lib()
        self._h = self._lib.kvs_start(
            dim, _OPT_NAMES[optimizer], float(init_scale), int(seed),
            int(num_shards), int(num_threads), int(port)) or None
        if not self._h:
            raise RuntimeError("kv server failed to start")
        self.dim = dim
        self.port = int(self._lib.kvs_port(self._h))

    def stop(self):
        """Idempotent shutdown; safe when the native library never
        loaded (no AttributeError spew at interpreter exit)."""
        h, self._h = getattr(self, "_h", None), None
        lib = getattr(self, "_lib", None)
        if h and lib is not None:
            lib.kvs_stop(h)

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


class _Conn:
    def __init__(self, host, port, timeout: Optional[float] = None):
        # timeout covers connect AND each recv (liveness probes must not
        # block through the TCP retry schedule on a partitioned server)
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def request(self, op: int, n: int, payload: bytes,
                resp_len: int) -> bytes:
        self.sock.sendall(struct.pack("<BQ", op, n) + payload)
        out = bytearray()
        while len(out) < resp_len:
            chunk = self.sock.recv(resp_len - len(out))
            if not chunk:
                raise ConnectionError("kv server closed the connection")
            out.extend(chunk)
        return bytes(out)

    def close(self):
        self.sock.close()


class RemoteKVStore:
    """Client for a KV pserver; drop-in for HostKVStore (same surface, so
    HostKVEmbedding/run_kv_epoch work against a remote table).

    Thread-safety: a small connection pool backs the async calls; each
    in-flight operation owns one connection.
    """

    def __init__(self, host: str, port: int, *, pool_size: int = 4):
        self._host, self._port = host, port
        self._pool = [_Conn(host, port)]
        self._pool_lock = threading.Lock()
        self._executor = ThreadPoolExecutor(max_workers=pool_size)
        self._futures = []
        self._fut_lock = threading.Lock()
        d = self._call(OP_DIM, 0, b"", 4)
        self.dim = struct.unpack("<I", d)[0]

    # -- connection pool ---------------------------------------------------
    def _acquire(self) -> _Conn:
        with self._pool_lock:
            if self._pool:
                return self._pool.pop()
        return _Conn(self._host, self._port)

    def _release(self, conn: _Conn):
        with self._pool_lock:
            self._pool.append(conn)

    def _call(self, op, n, payload, resp_len) -> bytes:
        conn = self._acquire()
        try:
            out = conn.request(op, n, payload, resp_len)
        except Exception:
            # a failed/half-read socket is protocol-desynced: drop it so
            # the pool never hands it to the next call
            try:
                conn.close()
            except Exception:
                pass
            raise
        self._release(conn)
        return out

    # -- HostKVStore-compatible surface -----------------------------------
    def pull(self, ids: np.ndarray, out: Optional[np.ndarray] = None
             ) -> np.ndarray:
        ids = np.ascontiguousarray(ids, np.int64).ravel()
        raw = self._call(OP_PULL, ids.size, ids.tobytes(),
                         ids.size * self.dim * 4)
        vals = np.frombuffer(raw, np.float32).reshape(ids.size, self.dim)
        if out is None:
            # writable copy: HostKVStore.pull returns mutable rows
            return vals.copy()
        out[:ids.size] = vals   # one copy, straight into the caller buffer
        return out[:ids.size]

    def pull_async(self, ids: np.ndarray,
                   out: Optional[np.ndarray] = None) -> "_RemoteHandle":
        ids = np.ascontiguousarray(ids, np.int64).ravel()
        fut = self._executor.submit(self.pull, ids, out)
        self._track(fut)
        return _RemoteHandle(fut, out)

    def push(self, ids: np.ndarray, grads: np.ndarray, lr: float,
             wait: bool = True):
        ids = np.ascontiguousarray(ids, np.int64).ravel()
        grads = np.ascontiguousarray(grads, np.float32)
        if grads.shape != (ids.size, self.dim):
            raise ValueError(f"grads shape {grads.shape} != "
                             f"({ids.size}, {self.dim})")
        payload = struct.pack("<f", lr) + ids.tobytes() + grads.tobytes()

        def do():
            r = self._call(OP_PUSH, ids.size, payload, 1)
            if r != b"\x01":
                raise IOError("kv server push failed")

        if wait:
            do()
        else:
            self._track(self._executor.submit(do))

    def set_rows(self, ids: np.ndarray, vals: np.ndarray):
        ids = np.ascontiguousarray(ids, np.int64).ravel()
        vals = np.ascontiguousarray(vals, np.float32)
        if vals.shape != (ids.size, self.dim):
            raise ValueError(f"vals shape {vals.shape} != "
                             f"({ids.size}, {self.dim})")
        r = self._call(OP_SET, ids.size, ids.tobytes() + vals.tobytes(), 1)
        if r != b"\x01":
            raise IOError("kv server set_rows failed")

    def _track(self, fut):
        with self._fut_lock:
            self._futures = [f for f in self._futures if not f.done()]
            self._futures.append(fut)

    def flush(self):
        with self._fut_lock:
            futures, self._futures = self._futures, []
        for f in futures:
            f.result()   # re-raises remote errors

    def __len__(self):
        return struct.unpack("<Q", self._call(OP_SIZE, 0, b"", 8))[0]

    def save(self, path: str):
        self.flush()
        p = str(path).encode()
        if self._call(OP_SAVE, len(p), p, 1) != b"\x01":
            raise IOError(f"remote kv_save({path}) failed")

    def load(self, path: str):
        p = str(path).encode()
        if self._call(OP_LOAD, len(p), p, 1) != b"\x01":
            raise IOError(f"remote kv_load({path}) failed")

    def ping(self, timeout: float = 2.0) -> bool:
        """Liveness probe: one cheap size round-trip on a FRESH, timed
        connection (pooled sockets can look alive after a server death
        until their next use; a hung/partitioned server must time out,
        not block the watchdog)."""
        try:
            c = _Conn(self._host, self._port, timeout=timeout)
            try:
                c.request(OP_SIZE, 0, b"", 8)
                return True
            finally:
                c.close()
        except OSError:
            return False

    def close(self):
        self._executor.shutdown(wait=True)
        with self._pool_lock:
            for c in self._pool:
                c.close()
            self._pool = []


class PSMonitor:
    """Parameter-server liveness watchdog — the pserver half of the
    reference's failure detection (heart_beat_monitor.cc:57 tracks
    worker beats on the pserver; trainers learn of a dead pserver from
    failed RPC). Pings the remote store every ``check_every_s``; after
    ``misses`` consecutive failures calls ``on_lost()`` once and stops.
    Compose with fleet.ElasticCoordinator (or any restart policy) to
    respawn a pserver and :meth:`RemoteKVStore.load` its last snapshot.
    """

    def __init__(self, store: "RemoteKVStore", *, check_every_s: float = 1.0,
                 misses: int = 2, on_lost=None, log_fn=print):
        self._store = store
        self._stop = threading.Event()
        self.lost = threading.Event()

        def watch():
            failed = 0
            while not self._stop.wait(check_every_s):
                if self._store.ping(timeout=max(0.5, check_every_s)):
                    failed = 0
                    continue
                failed += 1
                if failed >= misses:
                    log_fn(f"[ps-monitor] pserver "
                           f"{self._store._host}:{self._store._port} "
                           f"lost ({failed} failed pings)")
                    self.lost.set()
                    if on_lost is not None:
                        on_lost()
                    return

        self._thread = threading.Thread(target=watch, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)


class _RemoteHandle:
    """Matches host_kv.PullHandle: wait() returns the pulled rows (the
    padded ``out`` buffer when one was supplied)."""

    def __init__(self, fut, out):
        self._fut = fut
        self._out = out

    def wait(self) -> np.ndarray:
        res = self._fut.result()
        return self._out if self._out is not None else res


def main():
    import argparse
    import signal
    import sys

    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, required=True)
    ap.add_argument("--optimizer", default="adagrad")
    ap.add_argument("--init-scale", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args()
    server = KVServer(args.dim, optimizer=args.optimizer,
                      init_scale=args.init_scale, seed=args.seed,
                      port=args.port)
    print(f"PORT {server.port}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    server.stop()
    sys.exit(0)


if __name__ == "__main__":
    main()
