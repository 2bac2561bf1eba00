"""NetReplica: the ReplicaHandle a socket implements.

:class:`NetReplica` speaks the
:mod:`~paddle_tpu_torch.serving.fleet.net.wire` protocol to a
:class:`~paddle_tpu_torch.serving.fleet.net.replica_server.ReplicaServer`
in another process and presents *exactly* the
:class:`~paddle_tpu_torch.serving.fleet.replica.ReplicaHandle` surface. The
router cannot tell it apart from a :class:`LocalReplica`, so every
fleet behavior (routing, breakers, redrive, migration) works over the
socket with zero router forks.

Failure discipline:

- **Connect/reconnect** goes through ``resilience.retry_call`` with
  exponential backoff — a replica process still warming up is a
  retryable condition, not an error.
- **Calls** are covered by a per-call deadline (``settimeout``); a
  timeout or any socket error **drops the connection** before raising.
  Dropping is load-bearing: a late response to a timed-out call would
  otherwise be mis-paired with the next request — killing the socket
  kills the stale stream, and request/response ids are checked anyway.
- Raised transport failures are ``OSError``/``TimeoutError`` shaped
  (``WireError`` subclasses ``ConnectionError``), which is precisely
  the router's ``TRANSPORT_ERRORS`` tuple — a refused connect or a
  ``kill -9``'d peer feeds the ``FailureDetector`` /
  ``CircuitBreaker`` as one more consecutive transport failure,
  unchanged.
- **Postmortem** falls back to a client-side flight recorder: the
  usual dump trigger is the *remote end dying*, when the RPC cannot
  succeed. Health snapshots are noted on every successful ``health()``
  call, so the client-side bundle carries the victim's last-known
  trajectory plus the transport error that ended it.
"""

from __future__ import annotations

import socket
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from paddle_tpu_torch.observability.flight import FlightRecorder
from paddle_tpu_torch.resilience.retry import RetryPolicy, retry_call
from paddle_tpu_torch.serving.fleet.net import wire
from paddle_tpu_torch.serving.fleet.replica import ReplicaHandle

DEFAULT_CONNECT_RETRY = RetryPolicy(
    max_attempts=6, base_delay_s=0.05, max_delay_s=1.0,
    deadline_s=30.0, retry_on=(OSError, TimeoutError))


class NetReplica(ReplicaHandle):
    """Client-side ReplicaHandle over one socket connection."""

    def __init__(self, address: Tuple[str, int], *,
                 name: Optional[str] = None,
                 connect_timeout_s: float = 5.0,
                 call_timeout_s: float = 60.0,
                 retry: RetryPolicy = DEFAULT_CONNECT_RETRY,
                 codec: Optional[str] = None,
                 registry=None, sleep=time.sleep):
        self.address = (address[0], int(address[1]))
        self.connect_timeout_s = float(connect_timeout_s)
        self.call_timeout_s = float(call_timeout_s)
        self.retry = retry
        self.codec = codec or wire.default_codec()
        self._sleep = sleep
        self._sock: Optional[socket.socket] = None
        self._decoder = wire.MessageDecoder()
        self._pending: list = []
        self._next_id = 0
        self.draining = False
        self.calls_total = 0
        self.reconnects_total = 0
        self._page_size: Optional[int] = None
        self.remote_pid: Optional[int] = None
        self.remote_weights: Optional[str] = None
        # the client-side black box: health trajectories noted here are
        # all that survives the remote process being kill -9'd
        self.flight = FlightRecorder(
            name=name or f"net:{self.address[0]}:{self.address[1]}",
            registry=registry)
        self._last_transport_error: Optional[str] = None
        self.name = name or self.flight.name
        self.connect()

    # -- transport ---------------------------------------------------------
    def connect(self) -> "NetReplica":
        """(Re)connect with backoff and re-run the hello handshake."""
        self._drop()

        def _dial():
            s = socket.create_connection(self.address,
                                         timeout=self.connect_timeout_s)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return s

        self._sock = retry_call(_dial, policy=self.retry,
                                op=f"net_connect:{self.name}",
                                sleep=self._sleep)
        self._decoder = wire.MessageDecoder()
        self._pending = []
        self.reconnects_total += 1
        hello = self._call("hello", {})
        if hello.get("wire_version") != wire.WIRE_VERSION:
            self._drop()
            raise wire.WireError(
                f"server wire version {hello.get('wire_version')!r}, "
                f"client speaks {wire.WIRE_VERSION}")
        self._page_size = int(hello["page_size"])
        self.remote_pid = hello.get("pid")
        # sha256 of the server's weights (None from a server that
        # does not report it)
        self.remote_weights = hello.get("weights_sha256")
        self.draining = bool(hello.get("draining", False))
        if self.name.startswith("net:") and hello.get("name"):
            self.name = self.flight.name = str(hello["name"])
        return self

    def connected(self) -> bool:
        return self._sock is not None

    def _drop(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._pending = []

    def _call(self, op: str, args: Dict,
              timeout: Optional[float] = None):
        """One RPC. Transport failures close the socket then raise —
        the caller (usually the router) sees an ``OSError``-shaped
        exception and charges it to the breaker."""
        if self._sock is None:
            self.connect()      # lazy reconnect after a failed call
        sock = self._sock
        self.calls_total += 1
        mid = self._next_id = self._next_id + 1
        try:
            sock.settimeout(self.call_timeout_s
                            if timeout is None else timeout)
            sock.sendall(wire.encode_message(
                {"id": mid, "op": op, "args": args}, codec=self.codec))
            resp = wire.recv_message(sock, self._decoder, self._pending)
        except (OSError, TimeoutError) as e:
            # the connection is now ambiguous (a late reply would pair
            # with the wrong request) — kill it so reconnect starts clean
            self._last_transport_error = f"{type(e).__name__}: {e}"
            self._drop()
            raise
        if resp.get("id") != mid:
            self._last_transport_error = (
                f"response id {resp.get('id')!r} != request {mid}")
            self._drop()
            raise wire.WireError(self._last_transport_error)
        if resp.get("ok"):
            return resp.get("value")
        raise wire.error_from_wire(resp.get("error") or {})

    # -- ReplicaHandle surface ---------------------------------------------
    def page_size(self) -> int:
        if self._page_size is None:
            self.connect()
        return int(self._page_size)

    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None, *, lane: str = "default",
               ttft_deadline_s: Optional[float] = None,
               trace_id: Optional[int] = None) -> int:
        return int(self._call("submit", {
            "prompt": np.asarray(prompt, np.int32),
            "max_new_tokens": int(max_new_tokens),
            "eos_id": None if eos_id is None else int(eos_id),
            "lane": lane, "ttft_deadline_s": ttft_deadline_s,
            "trace_id": trace_id}))

    def step(self) -> Dict[int, np.ndarray]:
        out = self._call("step", {})
        return {int(r): np.asarray(a) for r, a in out["results"].items()}

    def health(self) -> Dict[str, object]:
        h = self._call("health", {})
        # heartbeat_age_s arrived as the REMOTE host's monotonic delta;
        # pass it through untouched (never re-derive from local clocks)
        self.draining = bool(h.get("draining", False))
        self.flight.note(h)
        return h

    def prefix_digests(self) -> frozenset:
        return frozenset(int(d) for d in self._call("prefix_digests", {}))

    def can_accept(self, total_tokens: int) -> bool:
        if self.draining:
            return False
        return bool(self._call("can_accept",
                               {"total_tokens": int(total_tokens)}))

    def idle(self) -> bool:
        return bool(self._call("idle", {}))

    def result(self, rid: int) -> Optional[np.ndarray]:
        out = self._call("result", {"rid": int(rid)})
        return None if out is None else np.asarray(out)

    def request_stats(self, rid: int) -> Optional[Dict[str, float]]:
        return self._call("request_stats", {"rid": int(rid)})

    def progress(self, since: Optional[Dict[int, int]] = None
                 ) -> Dict[int, List[int]]:
        out = self._call("progress", {"since": since})
        # FullReplay markers survive decode_payload; keep them intact
        return {int(r): v for r, v in out["streams"].items()}

    def poll_checkpoints(self) -> List[Tuple[int, Dict]]:
        return [(int(r), snap)
                for r, snap in self._call("poll_checkpoints", {})]

    def poll_handoffs(self) -> List[Tuple[int, Dict]]:
        return [(int(r), snap)
                for r, snap in self._call("poll_handoffs", {})]

    def reject_reason(self, rid: int):
        out = self._call("reject_reason", {"rid": int(rid)})
        return None if out is None else wire.reject_from_wire(out)

    def drain_queue(self) -> List[Tuple]:
        return [tuple(item) for item in self._call("drain_queue", {})]

    def snapshot_inflight(self) -> List[Tuple[int, Dict]]:
        return [(int(r), snap)
                for r, snap in self._call("snapshot_inflight", {})]

    def restore(self, snap: Dict, *, parent_span=None) -> int:
        # parent_span is a live tracer handle — process-local by nature,
        # so it does not cross the wire
        return int(self._call("restore", {"snap": snap}))

    def export_prefix_pages(self, digests) -> Optional[Dict]:
        return self._call("export_prefix_pages",
                          {"digests": [int(d) for d in digests]})

    def import_prefix_pages(self, bundle) -> int:
        return int(self._call("import_prefix_pages", {"bundle": bundle}))

    def warmup(self):
        # warmup builds every (bucket, batch) signature, so it gets
        # its own generous deadline
        self._call("warmup", {},
                   timeout=max(self.call_timeout_s, 600.0))
        return self

    def postmortem(self, reason: str, trace_ids=()) -> Optional[Dict]:
        try:
            bundle = self._call("postmortem",
                                {"reason": reason,
                                 "trace_ids": list(trace_ids)})
            if bundle is not None:
                return bundle
        except (OSError, TimeoutError, wire.RemoteError):
            pass        # the usual case: we are here BECAUSE it died
        # client-side testimony: last noted health trajectory + the
        # transport error that ended the relationship
        return self.flight.dump(
            reason, trace_ids=trace_ids,
            extra={"remote": False, "address": list(self.address),
                   "transport_error": self._last_transport_error or ""})

    # -- remote lifecycle --------------------------------------------------
    def request_drain(self, draining: bool = True) -> bool:
        """Flip the remote server's draining flag (the soft half of the
        SIGTERM discipline, reachable without process signals)."""
        ok = bool(self._call("set_draining", {"draining": draining}))
        self.draining = draining
        return ok

    def shutdown_server(self) -> bool:
        """Ask the remote process to exit its serve loop."""
        try:
            return bool(self._call("shutdown", {}))
        finally:
            self._drop()

    def close(self):
        # closes the CLIENT socket only — the remote replica keeps
        # serving (other routers may hold connections); use
        # shutdown_server() to take the process down
        self._drop()
