"""Streaming front door: the client-facing edge of the fleet.

Clients connect over the :mod:`~paddle_tpu_torch.serving.fleet.net.wire`
protocol and send ``generate`` requests; the front door routes them
through a :class:`~paddle_tpu_torch.serving.fleet.router.FleetRouter` and
streams tokens back **incrementally** as they decode —
``FleetRouter.progress(frid)`` is the feed, which exists because the
router already polls every replica's emitted tokens each step for
crash redrive (``faults.enabled`` powers both; it is on by default).
One client request produces a frame sequence::

    accepted {rid}  →  tokens {rid, tokens[...]}*  →  finished {rid, tokens}
                    or  reject {rid?, reason, reject{...}}

Failure and overload are **structured, never a bare disconnect**:

- A router/engine shed surfaces as a ``reject`` frame carrying the
  full typed :class:`~paddle_tpu_torch.serving.Reject` (reason, lane, queue
  depth, ``retry_after_s``).
- **Backpressure**: each connection's outbound buffer is bounded
  (``max_buffer_frames``). A reader that stops draining while decode
  keeps producing is *shed* — pending frames are dropped, one final
  ``reject(reason="slow_reader")`` frame is sent, and the connection
  closes. The fleet's decode slots are never held hostage by the
  slowest TCP receiver.

Every connection and request transition lands in a **crash-safe JSONL
netlog** (one line per event, flushed at the write): schema-tagged,
monotonic frame ids, and every accepted request terminated by exactly
one of ``finished`` / ``shed`` / ``redriven`` (``redriven`` = the
request outlived its connection or the front door's shutdown — it is
the router's redrive/replay machinery's responsibility from that line
on, not lost). :func:`validate_netlog_file` validates the log (the
reference's netlog format and schema tag: either package's validator
reads either package's log).

The loop is single-threaded and explicitly pumpable: ``pump()`` runs
one accept/read → ``router.step()`` → deliver cycle (the deterministic
test drive), ``start()``/``stop()`` wrap it in a daemon thread for live
serving.
"""

from __future__ import annotations

import json
import os
import selectors
import socket
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from paddle_tpu_torch.analysis.concurrency import guarded_by
from paddle_tpu_torch.serving.fleet.net import wire
from paddle_tpu_torch.serving.scheduler import LoadShedError, Reject

NETLOG_SCHEMA = "paddle_tpu.netlog-v1"     # the reference's format tag

NETLOG_EVENTS = frozenset({
    "listen", "conn_open", "conn_close", "accept", "reject",
    "stream", "finished", "shed", "redriven", "close"})

# netlog terminals: every accepted rid must hit exactly one
NETLOG_TERMINALS = frozenset({"finished", "shed", "redriven"})


class _ClientConn:
    def __init__(self, sock, cid: int, max_frame_bytes: int):
        self.sock = sock
        self.cid = cid
        self.decoder = wire.MessageDecoder(max_frame_bytes)
        self.outbox: "deque[bytes]" = deque()
        self.out_off = 0            # bytes of outbox[0] already sent
        self.rids: set = set()      # live frids owned by this conn
        self.tags: Dict[int, Any] = {}
        self.delivered: Dict[int, int] = {}   # frid -> tokens sent
        self.closing = False        # flush outbox, then close


@guarded_by("_netlog_lock", "_netlog", "_frame")
class FrontDoor:
    """Client-facing streaming server over one FleetRouter."""

    def __init__(self, router, host: str = "127.0.0.1", port: int = 0,
                 *, netlog_path: Optional[str] = None,
                 max_buffer_frames: int = 64,
                 max_frame_bytes: int = wire.DEFAULT_MAX_FRAME_BYTES,
                 codec: Optional[str] = None, registry=None):
        self.router = router
        self.codec = codec or wire.default_codec()
        self.max_buffer_frames = int(max_buffer_frames)
        self.max_frame_bytes = int(max_frame_bytes)
        from paddle_tpu_torch import observability as obs
        self._reg = registry or obs.default()
        self._lsock = socket.create_server((host, int(port)))
        self._lsock.setblocking(False)
        self.address: Tuple[str, int] = self._lsock.getsockname()[:2]
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._lsock, selectors.EVENT_READ, None)
        self._conns: Dict[socket.socket, _ClientConn] = {}
        self._owner: Dict[int, _ClientConn] = {}   # frid -> conn
        self._conn_seq = 0
        self._netlog_lock = threading.Lock()
        self._frame = 0
        self._netlog = None
        self.netlog_path = netlog_path
        if netlog_path:
            d = os.path.dirname(os.path.abspath(netlog_path))
            os.makedirs(d, exist_ok=True)
            self._netlog = open(netlog_path, "a", encoding="utf-8")
        self.accepted_total = 0
        self.finished_total = 0
        self.shed_total = 0
        self.stream_frames_total = 0
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._closed = False
        self._log("listen", host=self.address[0], port=self.address[1])

    # -- netlog ------------------------------------------------------------
    def _log(self, event: str, **fields):
        """One JSONL line, flushed at the write — a ``kill -9`` of this
        process tears at most the line being written, never a committed
        one (the validator tolerates a torn FINAL line only). The lock
        makes a line and its frame id atomic across threads (pump loop
        vs. a closing owner): interleaved writers would tear interior
        lines and duplicate frame ids, both of which the validator
        treats as corruption."""
        with self._netlog_lock:
            if self._netlog is None:
                return
            rec = {"schema": NETLOG_SCHEMA, "frame": self._frame,
                   "ts": time.time(), "event": event}
            rec.update(fields)
            self._frame += 1
            self._netlog.write(json.dumps(rec, sort_keys=True) + "\n")
            self._netlog.flush()

    # -- health / exposition ----------------------------------------------
    def health(self) -> Dict[str, object]:
        return {"connections": len(self._conns),
                "accepted_total": self.accepted_total,
                "finished_total": self.finished_total,
                "shed_total": self.shed_total,
                "stream_frames_total": self.stream_frames_total,
                "live_requests": len(self._owner),
                "address": list(self.address)}

    def start_exposition(self, port: int = 0, host: str = "127.0.0.1"):
        """Operator plane for the whole edge: ``/healthz`` aggregates
        the front door and the fleet (degraded fleet → 503, as usual),
        ``/debug/postmortem`` serves the router's bundle ring."""
        from paddle_tpu_torch import observability as obs
        srv = obs.ExpositionServer(registry=self._reg,
                                   tracer=self.router.tracer,
                                   port=port, host=host)
        srv.add_health("frontdoor", self.health)
        srv.add_health("fleet", self.router.health)
        srv.add_postmortem("fleet", self.router.postmortems)
        srv.add_json("/debug/netlog",
                     lambda: dict(self.health(),
                                  netlog_path=self.netlog_path))
        return srv.start()

    # -- lifecycle ---------------------------------------------------------
    def start(self, poll_s: float = 0.005) -> "FrontDoor":
        if self._thread is not None:
            raise RuntimeError("front door already started")
        self._stop_evt.clear()

        def loop():
            while not self._stop_evt.is_set():
                if not self.pump():
                    time.sleep(poll_s)

        self._thread = threading.Thread(target=loop, name="frontdoor",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._thread is not None:
            self._stop_evt.set()
            self._thread.join()
            self._thread = None

    def close(self):
        if self._closed:
            return
        self.stop()
        # requests still live at shutdown are the ROUTER's from here on
        # (its replay records and redrive machinery own them); the
        # netlog terminal says so explicitly — detached, not lost
        for conn in list(self._conns.values()):
            self._orphan(conn, "frontdoor_close")
            self._drop(conn)
        try:
            self._sel.unregister(self._lsock)
        except KeyError:
            pass
        self._lsock.close()
        self._sel.close()
        self._log("close")
        with self._netlog_lock:
            if self._netlog is not None:
                self._netlog.close()
                self._netlog = None
        self._closed = True

    # -- the pump ----------------------------------------------------------
    def pump(self) -> int:
        """One full cycle: accept/read sockets, step the fleet once if
        work is pending, deliver tokens/finishes/rejects, flush
        outboxes. Returns the number of frames delivered + requests
        accepted (0 = completely idle)."""
        work = self._pump_io()
        finished: Dict[int, np.ndarray] = {}
        if not self.router.idle():
            finished = self.router.step()
            work += 1
        work += self._deliver(finished)
        self._flush_all()
        return work

    def _pump_io(self) -> int:
        n = 0
        for key, _ in self._sel.select(0):
            if key.fileobj is self._lsock:
                self._accept()
            else:
                n += self._read(key.data)
        return n

    def _accept(self):
        try:
            sock, _addr = self._lsock.accept()
        except OSError:
            return
        sock.setblocking(False)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._conn_seq += 1
        conn = _ClientConn(sock, self._conn_seq, self.max_frame_bytes)
        self._conns[sock] = conn
        self._sel.register(sock, selectors.EVENT_READ, conn)
        self._log("conn_open", conn=conn.cid)
        self._reg.gauge("frontdoor_connections",
                        "open front-door client connections").set(
                            len(self._conns))

    def _drop(self, conn: _ClientConn):
        try:
            self._sel.unregister(conn.sock)
        except KeyError:
            pass
        if self._conns.pop(conn.sock, None) is not None:
            self._log("conn_close", conn=conn.cid)
        for frid in list(conn.rids):
            self._owner.pop(frid, None)
        conn.rids.clear()
        try:
            conn.sock.close()
        except OSError:
            pass
        self._reg.gauge("frontdoor_connections",
                        "open front-door client connections").set(
                            len(self._conns))

    def _orphan(self, conn: _ClientConn, why: str):
        """Terminal-log every live request of a vanishing connection:
        the router keeps decoding it (and would redrive it through a
        crash), but nobody is listening — ``redriven`` in the netlog
        marks the handoff so the accounting never shows a lost rid."""
        for frid in list(conn.rids):
            self._log("redriven", rid=frid, conn=conn.cid, cause=why)
            self._owner.pop(frid, None)
        conn.rids.clear()

    def _read(self, conn: _ClientConn) -> int:
        try:
            data = conn.sock.recv(1 << 16)
        except BlockingIOError:
            return 0
        except OSError:
            self._orphan(conn, "conn_error")
            self._drop(conn)
            return 0
        if not data:
            self._orphan(conn, "conn_closed")
            self._drop(conn)
            return 0
        try:
            msgs = conn.decoder.feed(data)
        except wire.WireError:
            self._orphan(conn, "wire_error")
            self._drop(conn)
            return 0
        n = 0
        for msg in msgs:
            n += self._handle(conn, msg)
        return n

    def _handle(self, conn: _ClientConn, msg) -> int:
        if not isinstance(msg, dict) or msg.get("op") != "generate":
            self._send(conn, {"event": "reject", "rid": None,
                              "tag": None, "reason": "bad_request",
                              "detail": f"unsupported message {msg!r}"
                                        [:200]})
            return 1
        tag = msg.get("tag")
        lane = msg.get("lane", "default")
        try:
            prompt = np.asarray(msg["prompt"], np.int32).reshape(-1)
            frid = self.router.submit(
                prompt, int(msg.get("max_new_tokens", 32)),
                None if msg.get("eos_id") is None
                else int(msg["eos_id"]),
                lane=lane,
                ttft_deadline_s=msg.get("ttft_deadline_s"))
        except LoadShedError as e:
            # overload is an ANSWER, not a hangup: the typed verdict
            # (reason, queue depth, retry_after_s) goes to the client
            self._log("reject", conn=conn.cid, tag=tag,
                      reason=e.reject.reason)
            self._reg.counter(
                "frontdoor_rejects_total",
                "generate requests rejected at the front door").inc(
                    reason=e.reject.reason)
            self._send(conn, {"event": "reject", "rid": None,
                              "tag": tag, "reason": e.reject.reason,
                              "reject": wire.reject_to_wire(e.reject)})
            return 1
        except (ValueError, KeyError, TypeError) as e:
            self._send(conn, {"event": "reject", "rid": None,
                              "tag": tag, "reason": "bad_request",
                              "detail": f"{type(e).__name__}: {e}"})
            return 1
        conn.rids.add(frid)
        conn.tags[frid] = tag
        conn.delivered[frid] = 0
        self._owner[frid] = conn
        self.accepted_total += 1
        self._log("accept", rid=frid, conn=conn.cid, tag=tag, lane=lane,
                  prompt_tokens=int(prompt.shape[0]))
        self._reg.counter("frontdoor_requests_total",
                          "generate requests accepted").inc(lane=lane)
        self._send(conn, {"event": "accepted", "rid": frid, "tag": tag})
        return 1

    # -- delivery ----------------------------------------------------------
    def _deliver(self, finished: Dict[int, np.ndarray]) -> int:
        n = 0
        for frid, toks in finished.items():
            conn = self._owner.pop(frid, None)
            if conn is None:
                continue            # orphaned earlier; router owns it
            toks = [int(t) for t in np.asarray(toks).reshape(-1)]
            self.finished_total += 1
            self._log("finished", rid=frid, conn=conn.cid,
                      tokens=len(toks))
            self._send(conn, {"event": "finished", "rid": frid,
                              "tag": conn.tags.pop(frid, None),
                              "tokens": toks})
            conn.rids.discard(frid)
            conn.delivered.pop(frid, None)
            n += 1
        # post-acceptance sheds (redrive budget, deadline, engine TTFT
        # shed lifted by the router) — pop-on-read, typed all the way
        for frid, conn in list(self._owner.items()):
            rej = self.router.reject_reason(frid)
            if rej is None:
                continue
            self._owner.pop(frid, None)
            self.shed_total += 1
            self._log("shed", rid=frid, conn=conn.cid,
                      reason=rej.reason)
            self._reg.counter(
                "frontdoor_shed_total",
                "accepted requests shed, by reason").inc(
                    reason=rej.reason)
            self._send(conn, {"event": "reject", "rid": frid,
                              "tag": conn.tags.pop(frid, None),
                              "reason": rej.reason,
                              "reject": wire.reject_to_wire(rej)})
            conn.rids.discard(frid)
            conn.delivered.pop(frid, None)
            n += 1
        # incremental tokens for everything still decoding
        for frid, conn in list(self._owner.items()):
            obs = self.router.progress(frid)
            if obs is None:
                continue
            done = conn.delivered.get(frid, 0)
            if len(obs) <= done:
                continue
            tail = [int(t) for t in obs[done:]]
            conn.delivered[frid] = len(obs)
            self.stream_frames_total += 1
            self._log("stream", rid=frid, conn=conn.cid,
                      tokens=len(tail), total=len(obs))
            self._send(conn, {"event": "tokens", "rid": frid,
                              "tag": conn.tags.get(frid),
                              "tokens": tail})
            n += 1
        return n

    # -- outbound / backpressure ------------------------------------------
    def _send(self, conn: _ClientConn, payload: Dict):
        if conn.closing:
            return
        conn.outbox.append(wire.encode_message(payload, codec=self.codec))
        if len(conn.outbox) > self.max_buffer_frames:
            self._shed_slow_reader(conn)

    def _shed_slow_reader(self, conn: _ClientConn):
        """The reader stopped draining while decode kept producing:
        drop its queued frames, terminal-log every live request, send
        one final structured reject, close. Dropping BEFORE the final
        frame keeps the shed itself from blocking on the same full
        socket that caused it."""
        conn.outbox.clear()
        conn.out_off = 0
        rids = sorted(conn.rids)
        for frid in rids:
            self._owner.pop(frid, None)
            self.shed_total += 1
            self._log("shed", rid=frid, conn=conn.cid,
                      reason="slow_reader")
        self._reg.counter(
            "frontdoor_shed_total",
            "accepted requests shed, by reason").inc(
                reason="slow_reader", n=max(1, len(rids)))
        conn.rids.clear()
        conn.delivered.clear()
        rej = Reject("slow_reader", "default", len(rids), 0.0, 0.05)
        conn.outbox.append(wire.encode_message(
            {"event": "reject", "rid": None, "tag": None,
             "reason": "slow_reader", "rids": rids,
             "reject": wire.reject_to_wire(rej)}, codec=self.codec))
        conn.closing = True         # flush the verdict, then hang up

    def _flush_all(self):
        for conn in list(self._conns.values()):
            self._flush(conn)

    def _flush(self, conn: _ClientConn):
        while conn.outbox:
            buf = conn.outbox[0]
            try:
                sent = conn.sock.send(
                    memoryview(buf)[conn.out_off:])
            except BlockingIOError:
                return              # kernel buffer full: try next pump
            except OSError:
                self._orphan(conn, "conn_error")
                self._drop(conn)
                return
            conn.out_off += sent
            if conn.out_off >= len(buf):
                conn.outbox.popleft()
                conn.out_off = 0
        if conn.closing:
            self._drop(conn)


class FrontDoorClient:
    """Minimal blocking client for tests and the bench. Frames arrive
    as events; :meth:`generate` runs one request to completion and
    reports how many partial (``tokens``) deliveries it observed —
    the streaming acceptance number."""

    def __init__(self, address: Tuple[str, int], *,
                 timeout_s: float = 60.0, codec: Optional[str] = None):
        self.sock = socket.create_connection(
            (address[0], int(address[1])), timeout=timeout_s)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.codec = codec or wire.default_codec()
        self._decoder = wire.MessageDecoder()
        self._pending: list = []

    def send_generate(self, prompt, max_new_tokens: int = 32,
                      eos_id: Optional[int] = None, *,
                      lane: str = "default",
                      ttft_deadline_s: Optional[float] = None,
                      tag=None):
        self.sock.sendall(wire.encode_message(
            {"op": "generate",
             "prompt": [int(t) for t in np.asarray(prompt).reshape(-1)],
             "max_new_tokens": int(max_new_tokens),
             "eos_id": None if eos_id is None else int(eos_id),
             "lane": lane, "ttft_deadline_s": ttft_deadline_s,
             "tag": tag}, codec=self.codec))

    def next_event(self, timeout: Optional[float] = None) -> Dict:
        if timeout is not None:
            self.sock.settimeout(timeout)
        return wire.recv_message(self.sock, self._decoder, self._pending)

    def generate(self, prompt, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None, *, lane: str = "default",
                 ttft_deadline_s: Optional[float] = None, tag=None,
                 timeout_s: float = 120.0) -> Dict[str, Any]:
        """Send one request; block until it finishes or rejects.
        Returns ``{"rid", "tokens", "partials", "ttft_s", "reject"}``
        (``tokens`` is None on reject; ``ttft_s`` is wall time from
        send to the first streamed token)."""
        self.send_generate(prompt, max_new_tokens, eos_id, lane=lane,
                           ttft_deadline_s=ttft_deadline_s, tag=tag)
        t0 = time.monotonic()
        rid, partials, ttft = None, 0, None
        streamed: List[int] = []
        deadline = t0 + timeout_s
        while True:
            ev = self.next_event(timeout=max(0.01,
                                             deadline - time.monotonic()))
            kind = ev.get("event")
            if kind == "accepted":
                rid = ev["rid"]
            elif kind == "tokens":
                if ttft is None:
                    ttft = time.monotonic() - t0
                partials += 1
                streamed.extend(int(t) for t in ev["tokens"])
            elif kind == "finished":
                return {"rid": ev["rid"], "tag": ev.get("tag"),
                        "tokens": [int(t) for t in ev["tokens"]],
                        "streamed": streamed, "partials": partials,
                        "ttft_s": ttft, "reject": None}
            elif kind == "reject":
                return {"rid": ev.get("rid"), "tag": ev.get("tag"),
                        "tokens": None, "streamed": streamed,
                        "partials": partials, "ttft_s": ttft,
                        "reject": ev.get("reject")
                        or {"reason": ev.get("reason")}}
            else:
                raise wire.WireError(f"unexpected event {ev!r}")

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


# -- netlog validation ------------------------------------------------------

def validate_netlog_file(path: str, *, require_requests: int = 0
                         ) -> Dict[str, int]:
    """Validate a front-door netlog: schema tag on every line, strictly
    monotonic frame ids, known events, and the no-silent-loss ledger —
    every ``accept``ed rid terminated by exactly one of ``finished`` /
    ``shed`` / ``redriven``. A torn FINAL line (the process died mid-
    write) is tolerated; a torn interior line is corruption. Raises
    ``ValueError`` with a precise message; returns a summary dict."""

    def fail(msg):
        raise ValueError(f"netlog {path}: {msg}")

    with open(path, "r", encoding="utf-8") as f:
        raw = f.read().split("\n")
    if raw and raw[-1] == "":
        raw.pop()
    recs: List[Dict] = []
    for i, line in enumerate(raw):
        try:
            recs.append(json.loads(line))
        except ValueError:
            if i == len(raw) - 1:
                break               # torn final line: crash mid-write
            fail(f"line {i + 1} is not JSON: {line[:80]!r}")
    if not recs:
        fail("empty log")
    last_frame = -1
    accepted: Dict[int, int] = {}   # rid -> terminal count
    counts = {"accept": 0, "finished": 0, "shed": 0, "redriven": 0,
              "reject": 0, "stream": 0}
    for i, r in enumerate(recs):
        if not isinstance(r, dict):
            fail(f"line {i + 1} is {type(r).__name__}, not an object")
        if r.get("schema") != NETLOG_SCHEMA:
            fail(f"line {i + 1} schema is {r.get('schema')!r}, "
                 f"expected {NETLOG_SCHEMA!r}")
        ev = r.get("event")
        if ev not in NETLOG_EVENTS:
            fail(f"line {i + 1} has unknown event {ev!r}")
        frame = r.get("frame")
        if not isinstance(frame, int) or isinstance(frame, bool):
            fail(f"line {i + 1} frame is {frame!r}, want int")
        if frame <= last_frame:
            fail(f"line {i + 1} frame {frame} not monotonic "
                 f"(previous {last_frame})")
        last_frame = frame
        if not isinstance(r.get("ts"), (int, float)):
            fail(f"line {i + 1} missing numeric ts")
        if ev in counts:
            counts[ev] += 1
        if ev == "accept":
            rid = r.get("rid")
            if not isinstance(rid, int):
                fail(f"line {i + 1} accept without int rid")
            if rid in accepted:
                fail(f"line {i + 1} rid {rid} accepted twice")
            accepted[rid] = 0
        elif ev in NETLOG_TERMINALS:
            rid = r.get("rid")
            if not isinstance(rid, int):
                fail(f"line {i + 1} {ev} without int rid")
            if rid not in accepted:
                fail(f"line {i + 1} {ev} for rid {rid} never accepted")
            accepted[rid] += 1
            if accepted[rid] > 1:
                fail(f"line {i + 1} rid {rid} terminated twice")
    dangling = sorted(r for r, n in accepted.items() if n == 0)
    if dangling:
        fail(f"accepted rids with no terminal: {dangling[:8]}"
             f"{'...' if len(dangling) > 8 else ''} "
             f"({len(dangling)} total)")
    if len(accepted) < require_requests:
        fail(f"only {len(accepted)} accepted requests, "
             f"required >= {require_requests}")
    counts["accepted_requests"] = len(accepted)
    counts["lines"] = len(recs)
    return counts
