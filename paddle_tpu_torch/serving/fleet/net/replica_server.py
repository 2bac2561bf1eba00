"""A serving replica in its own process, behind the wire protocol.

``ReplicaServer`` wraps one :class:`~paddle_tpu_torch.serving.ServingEngine`
in a :class:`~paddle_tpu_torch.serving.fleet.replica.LocalReplica` (reusing
its mutation lock, busy-time accounting and monotonic heartbeat) and
serves the full :class:`ReplicaHandle` surface as RPCs over a
``selectors`` event loop — single-threaded on purpose: every RPC is
serialized, so the engine sees exactly the interleaving an in-process
``LocalReplica`` would, and the byte-parity tests hold across the
socket.

Graceful shutdown follows the resilience preemption discipline
(:mod:`paddle_tpu_torch.resilience.preempt`): SIGTERM/SIGINT flips the
replica to ``draining`` (the router stops routing to it and migrates
its queue), the server finishes what is in flight — self-stepping if
the router has already moved on — and exits with ``EXIT_DRAINED``.
``kill -9`` is the chaos case: the socket dies mid-frame, the client's
:class:`~paddle_tpu_torch.serving.fleet.net.wire.WireError` feeds the
router's breaker/detector, and the redrive machinery takes over.

Run standalone (the process the fleet actually deploys)::

    python -m paddle_tpu_torch.serving.fleet.net.replica_server \
        --config '{"vocab_size": 64, ..., "dtype": "bfloat16"}' \
        --engine '{"num_slots": 2, "cache_dtype": "int8"}' \
        --seed 0 --port 0 --device cuda

The bound address is announced on stdout as ``PTNW_LISTENING host
port`` once warmup completes — :func:`spawn_replica_server` wraps the
spawn-and-wait dance for tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import hashlib
import json
import os
import selectors
import signal
import socket
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.resilience.preempt import EXIT_DRAINED
from paddle_tpu_torch.serving.fleet.net import wire
from paddle_tpu_torch.serving.fleet.replica import LocalReplica


class _Conn:
    def __init__(self, sock, max_frame_bytes):
        self.sock = sock
        self.decoder = wire.MessageDecoder(max_frame_bytes)


class ReplicaServer:
    """Event-loop RPC server over one engine. ``serve_forever()`` runs
    the loop inline (the deployed process); ``serve_step()`` runs one
    poll iteration, which lets a test drive the server from a plain
    background thread and still join it deterministically."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 *, name: str = "net0",
                 max_frame_bytes: int = wire.DEFAULT_MAX_FRAME_BYTES,
                 codec: Optional[str] = None, clock=time.monotonic):
        self.replica = LocalReplica(engine, name=name, clock=clock)
        self.codec = codec or wire.default_codec()
        self.max_frame_bytes = int(max_frame_bytes)
        self._lsock = socket.create_server((host, int(port)))
        self._lsock.setblocking(False)
        self.address: Tuple[str, int] = self._lsock.getsockname()[:2]
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._lsock, selectors.EVENT_READ, None)
        self._conns: Dict[socket.socket, _Conn] = {}
        self.draining = False
        self._shutdown = False
        self.rpcs_total = 0
        self._weights: Optional[str] = None     # weights_digest, lazily

    # -- lifecycle ---------------------------------------------------------
    def install_signal_handlers(self):
        """SIGTERM/SIGINT → drain, not die: in-flight work finishes,
        the exit code says 'drained' so a launcher restarts without
        burning its crash budget."""
        signal.signal(signal.SIGTERM, self._on_term)
        signal.signal(signal.SIGINT, self._on_term)
        return self

    def _on_term(self, signum, frame):
        self.request_drain()

    def request_drain(self):
        self.draining = True
        self.replica.draining = True

    def serve_step(self, timeout: float = 0.05) -> int:
        """One poll iteration; returns the number of RPCs dispatched."""
        n = 0
        for key, _ in self._sel.select(timeout):
            if key.fileobj is self._lsock:
                self._accept()
            else:
                n += self._service(key.data)
        return n

    def serve_forever(self, poll_s: float = 0.05) -> int:
        """Loop until shutdown or drain-complete; returns the exit
        code (``EXIT_DRAINED`` after a graceful drain, 0 otherwise)."""
        while not self._shutdown:
            self.serve_step(poll_s)
            if self.draining:
                if not self.replica.idle() and not self._conns:
                    # the router is gone but work remains: self-step to
                    # completion rather than holding requests hostage
                    self.replica.step()
                if self.replica.idle():
                    self.close()
                    return EXIT_DRAINED
        self.close()
        return EXIT_DRAINED if self.draining else 0

    def close(self):
        for sock in list(self._conns):
            self._drop(sock)
        try:
            self._sel.unregister(self._lsock)
        except KeyError:
            pass
        self._lsock.close()
        self._sel.close()

    # -- socket plumbing ---------------------------------------------------
    def _accept(self):
        try:
            sock, _addr = self._lsock.accept()
        except OSError:
            return
        sock.setblocking(True)          # replies use blocking sendall
        sock.settimeout(30.0)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = _Conn(sock, self.max_frame_bytes)
        self._conns[sock] = conn
        self._sel.register(sock, selectors.EVENT_READ, conn)

    def _drop(self, sock):
        try:
            self._sel.unregister(sock)
        except KeyError:
            pass
        self._conns.pop(sock, None)
        try:
            sock.close()
        except OSError:
            pass

    def _service(self, conn: _Conn) -> int:
        try:
            data = conn.sock.recv(1 << 16)
        except OSError:
            self._drop(conn.sock)
            return 0
        if not data:
            self._drop(conn.sock)
            return 0
        try:
            msgs = conn.decoder.feed(data)
        except wire.WireError:
            self._drop(conn.sock)   # a corrupt stream cannot be resynced
            return 0
        n = 0
        for msg in msgs:
            self._reply(conn, msg)
            n += 1
        return n

    def _reply(self, conn: _Conn, msg):
        mid = msg.get("id", 0) if isinstance(msg, dict) else 0
        try:
            if not isinstance(msg, dict) or "op" not in msg:
                raise ValueError(f"malformed request: {msg!r}")
            value = self._dispatch(msg["op"], msg.get("args") or {})
            resp = {"id": mid, "ok": True, "value": value}
        except Exception as e:      # the RPC failed, not the server
            resp = {"id": mid, "ok": False,
                    "error": wire.error_to_wire(e)}
        try:
            conn.sock.sendall(wire.encode_message(resp, codec=self.codec))
        except OSError:
            self._drop(conn.sock)

    # -- RPC surface: exactly ReplicaHandle --------------------------------
    def _dispatch(self, op: str, a: Dict):
        rep = self.replica
        self.rpcs_total += 1
        if op == "hello":
            if self._weights is None:
                self._weights = weights_digest(rep.engine.model)
            return {"name": rep.name, "pid": os.getpid(),
                    "wire_version": wire.WIRE_VERSION,
                    "codec": self.codec,
                    "page_size": rep.page_size(),
                    "draining": self.draining,
                    "weights_sha256": self._weights}
        if op == "submit":
            if self.draining:
                # structurally refuse new work mid-drain; the router
                # reads this as a transport-unavailable and re-routes
                from paddle_tpu_torch.serving.fleet.faults import \
                    ReplicaUnavailable
                raise ReplicaUnavailable(f"{rep.name} is draining")
            return rep.submit(
                np.asarray(a["prompt"], np.int32),
                int(a["max_new_tokens"]),
                None if a.get("eos_id") is None else int(a["eos_id"]),
                lane=a.get("lane", "default"),
                ttft_deadline_s=a.get("ttft_deadline_s"),
                trace_id=a.get("trace_id"))
        if op == "step":
            return {"results": rep.step()}
        if op == "health":
            # heartbeat_age_s inside is the replica's own MONOTONIC
            # delta — ages cross the wire as deltas, never timestamps
            h = dict(rep.health())
            h["draining"] = self.draining
            h["rpcs_total"] = self.rpcs_total
            return h
        if op == "prefix_digests":
            return sorted(rep.prefix_digests())
        if op == "can_accept":
            return bool(rep.can_accept(int(a["total_tokens"])))
        if op == "idle":
            return bool(rep.idle())
        if op == "result":
            return rep.result(int(a["rid"]))
        if op == "request_stats":
            return rep.request_stats(int(a["rid"]))
        if op == "progress":
            since = a.get("since")
            if since is not None:
                since = {int(k): int(v) for k, v in since.items()}
            return {"streams": rep.progress(since)}
        if op == "poll_checkpoints":
            return rep.poll_checkpoints()
        if op == "poll_handoffs":
            return rep.poll_handoffs()
        if op == "reject_reason":
            rej = rep.reject_reason(int(a["rid"]))
            return None if rej is None else wire.reject_to_wire(rej)
        if op == "drain_queue":
            return rep.drain_queue()
        if op == "snapshot_inflight":
            return rep.snapshot_inflight()
        if op == "restore":
            return rep.restore(a["snap"])
        if op == "export_prefix_pages":
            return rep.export_prefix_pages(
                [int(d) for d in a.get("digests", ())])
        if op == "import_prefix_pages":
            return rep.import_prefix_pages(a.get("bundle"))
        if op == "warmup":
            rep.warmup()
            return True
        if op == "postmortem":
            return rep.postmortem(a.get("reason", "remote"),
                                  trace_ids=tuple(a.get("trace_ids", ())))
        if op == "set_draining":
            if bool(a.get("draining", True)):
                self.request_drain()
            else:
                self.draining = False
                self.replica.draining = False
            return True
        if op == "shutdown":
            self._shutdown = True
            return True
        raise ValueError(f"unknown op {op!r}")


# -- standalone process entry ----------------------------------------------

#: JSON spellings of the dtypes ``--config`` / ``--engine`` may name
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}


def weights_digest(model) -> str:
    """sha256 over a model's parameters in ``state_dict`` order (each
    tensor's bits on the host): two processes that built the same
    weights agree on it. The server reports it in ``hello``."""
    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(name.encode("utf-8"))
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def _build_engine(config: Dict, engine_kwargs: Dict, seed: int,
                  device: str = "cuda"):
    """The GPT of ``GPTConfig.tiny(**config)``, its weights made from
    ``seed`` on ``device``, behind a ``ServingEngine(**engine_kwargs)``.
    ``config["dtype"]`` (the weights') and ``engine_kwargs["cache_dtype"]``
    / ``["draft_cache_dtype"]`` are dtype names (:data:`DTYPES`)."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig

    config = dict(config)
    dtype = DTYPES[config.pop("dtype", "float32")]
    engine_kwargs = dict(engine_kwargs)
    for key in ("cache_dtype", "draft_cache_dtype"):
        if engine_kwargs.get(key) is not None:
            engine_kwargs[key] = DTYPES[engine_kwargs[key]]
    model = GPT(GPTConfig.tiny(**config), device=device, dtype=dtype,
                seed=int(seed))
    return serving.ServingEngine(model, device=model.device,
                                 registry=obs.MetricsRegistry(),
                                 **engine_kwargs)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--name", default="net0")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--config", default="{}",
                    help="GPTConfig.tiny(**...) overrides, JSON")
    ap.add_argument("--engine", default="{}",
                    help="ServingEngine kwargs, JSON")
    ap.add_argument("--codec", default=None,
                    choices=(None, "json", "msgpack"))
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and the engine")
    ap.add_argument("--no-warmup", action="store_true")
    args = ap.parse_args(argv)

    engine = _build_engine(json.loads(args.config),
                           json.loads(args.engine), args.seed, args.device)
    server = ReplicaServer(engine, args.host, args.port, name=args.name,
                           codec=args.codec).install_signal_handlers()
    if not args.no_warmup:
        server.replica.warmup()     # announce only once routable
    print(f"PTNW_LISTENING {server.address[0]} {server.address[1]}",
          flush=True)
    return server.serve_forever()


def spawn_replica_server(*, config: Optional[Dict] = None,
                         engine: Optional[Dict] = None, seed: int = 0,
                         name: str = "net0", warmup: bool = True,
                         codec: Optional[str] = None, device: str = "cuda",
                         env: Optional[Dict[str, str]] = None,
                         startup_timeout_s: float = 180.0):
    """Spawn ``replica_server`` as a real subprocess on ``device`` and
    wait for its ``PTNW_LISTENING`` announcement; returns
    ``(subprocess.Popen, (host, port))``. The chaos battery gets its
    ``kill -9`` victims from here."""
    import select
    import subprocess

    cmd = [sys.executable, "-m",
           "paddle_tpu_torch.serving.fleet.net.replica_server",
           "--config", json.dumps(config or {}),
           "--engine", json.dumps(engine or {}),
           "--seed", str(seed), "--name", name, "--device", device]
    if codec:
        cmd += ["--codec", codec]
    if not warmup:
        cmd += ["--no-warmup"]
    child_env = dict(os.environ)
    # the child imports this package from where this process found it,
    # whatever its working directory
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))))
    child_env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [child_env.get("PYTHONPATH")] if p])
    if env:
        child_env.update(env)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            env=child_env, text=True)
    deadline = time.monotonic() + startup_timeout_s
    line = ""
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"replica server {name} died during startup "
                f"(rc={proc.returncode})")
        ready, _, _ = select.select([proc.stdout], [], [], 0.5)
        if not ready:
            continue
        line = proc.stdout.readline()
        if line.startswith("PTNW_LISTENING"):
            _tag, host, port = line.split()
            return proc, (host, int(port))
    proc.kill()
    raise TimeoutError(
        f"replica server {name} never announced within "
        f"{startup_timeout_s}s (last line: {line!r})")


if __name__ == "__main__":
    sys.exit(main())
