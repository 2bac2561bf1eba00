"""Length-prefixed framed wire protocol for network serving.

One message = one **envelope frame** (msgpack when the optional
``msgpack`` package is importable, JSON otherwise — the container rule:
no new hard dependencies) followed by N **binary frames**, one per
numpy array the payload references. Every frame is::

    !4sBBI  = MAGIC "PTNW" | version | kind | payload length

and every binary frame's bytes are sha256-checksummed against the
digest the envelope declared for it — the same integrity discipline as
the migration manifest (``ServingEngine.snapshot_slot`` hashes each
(page, tp-shard) the same way), so a KV snapshot crossing a socket is
verified twice: once per frame here, once per shard by
``restore_slot``. A checksum or framing mismatch raises
:class:`WireError`, which subclasses :class:`ConnectionError` so it
lands in the router's ``TRANSPORT_ERRORS`` and feeds the
breaker/detector machinery like any other dead transport.

The payload codec round-trips exactly the structures the
:class:`~paddle_tpu_torch.serving.fleet.replica.ReplicaHandle` surface
traffics in: numpy arrays (binary frames), tuples (preserved — a
quantized snapshot shard is a ``(kv, scales)`` tuple, not a list),
int-keyed dicts (``progress`` maps rid → tokens; JSON would silently
stringify the keys), ``bytes``, sets, and the
:class:`~paddle_tpu_torch.serving.fleet.replica.FullReplay` marker the
``progress(since=)`` contract-hardening introduced (a full replay that
loses its marker in transit would be double-counted by the router).
Wall-clock timestamps are deliberately absent from the protocol:
heartbeat ages travel as the sender's **monotonic deltas**, never as
timestamps a receiver would subtract its own clock from (NTP steps
between hosts would mis-detect hangs).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from paddle_tpu_torch.serving.engine import SlotMigrationError
from paddle_tpu_torch.serving.fleet.faults import (ReplicaCrashed,
                                                   ReplicaUnavailable)
from paddle_tpu_torch.serving.fleet.replica import FullReplay
from paddle_tpu_torch.serving.scheduler import (LoadShedError, REJECT_REASONS,
                                                Reject)

try:                                # optional accelerator, never required
    import msgpack                  # type: ignore
except ImportError:                 # pragma: no cover - env-dependent
    msgpack = None

MAGIC = b"PTNW"
WIRE_VERSION = 1
KIND_JSON = 1
KIND_MSGPACK = 2
KIND_BIN = 3
_HEADER = struct.Struct("!4sBBI")
HEADER_BYTES = _HEADER.size

# one frame is bounded: a runaway length prefix (corruption, a non-PTNW
# client) must fail fast instead of allocating gigabytes
DEFAULT_MAX_FRAME_BYTES = 1 << 28


class WireError(ConnectionError):
    """Protocol-level failure: bad magic/version, oversized or torn
    frame, checksum mismatch, peer gone mid-message. A
    :class:`ConnectionError` (→ ``OSError``) on purpose: the router
    already treats ``OSError`` as a transport failure, so a corrupt
    stream feeds the circuit breaker exactly like a refused connect."""


class RemoteError(RuntimeError):
    """A remote exception type this side has no class for; carries the
    remote type name + message so the failure is attributable."""


def default_codec() -> str:
    return "msgpack" if msgpack is not None else "json"


# -- payload codec ----------------------------------------------------------

def encode_payload(obj: Any) -> Tuple[Any, List[np.ndarray]]:
    """Lower ``obj`` to a codec-safe tree + the array buffers it
    references (in placeholder order)."""
    bufs: List[np.ndarray] = []

    def enc(x):
        if isinstance(x, np.ndarray):
            bufs.append(np.ascontiguousarray(x))
            return {"__buf__": len(bufs) - 1}
        if isinstance(x, (np.integer,)):
            return int(x)
        if isinstance(x, (np.floating,)):
            return float(x)
        if isinstance(x, (np.bool_,)):
            return bool(x)
        if isinstance(x, (bytes, bytearray)):
            return {"__bytes__": bytes(x).hex()}
        if isinstance(x, tuple):
            return {"__tuple__": [enc(v) for v in x]}
        if isinstance(x, FullReplay):
            return {"__full_replay__": [enc(v) for v in x]}
        if isinstance(x, (set, frozenset)):
            return {"__set__": sorted(enc(v) for v in x)}
        if isinstance(x, dict):
            if all(isinstance(k, str) and not k.startswith("__")
                   for k in x):
                return {k: enc(v) for k, v in x.items()}
            # int keys (progress maps) or reserved-prefix keys: JSON
            # would stringify/collide them — pair-encode instead
            return {"__map__": [[enc(k), enc(v)] for k, v in x.items()]}
        if isinstance(x, list):
            return [enc(v) for v in x]
        if x is None or isinstance(x, (bool, int, float, str)):
            return x
        raise TypeError(
            f"wire payload cannot carry {type(x).__name__}: {x!r}")

    return enc(obj), bufs


def decode_payload(obj: Any, bufs: List[np.ndarray]) -> Any:
    def dec(x):
        if isinstance(x, dict):
            if "__buf__" in x:
                return bufs[int(x["__buf__"])]
            if "__bytes__" in x:
                return bytes.fromhex(x["__bytes__"])
            if "__tuple__" in x:
                return tuple(dec(v) for v in x["__tuple__"])
            if "__full_replay__" in x:
                return FullReplay(dec(v) for v in x["__full_replay__"])
            if "__set__" in x:
                return frozenset(dec(v) for v in x["__set__"])
            if "__map__" in x:
                return {dec(k): dec(v) for k, v in x["__map__"]}
            return {k: dec(v) for k, v in x.items()}
        if isinstance(x, list):
            return [dec(v) for v in x]
        return x

    return dec(obj)


def _dumps(obj: Any, codec: str) -> Tuple[bytes, int]:
    if codec == "msgpack" and msgpack is not None:
        return msgpack.packb(obj, use_bin_type=True), KIND_MSGPACK
    return (json.dumps(obj, separators=(",", ":"),
                       allow_nan=True).encode("utf-8"), KIND_JSON)


def _loads(data: bytes, kind: int) -> Any:
    if kind == KIND_MSGPACK:
        if msgpack is None:
            raise WireError("peer sent a msgpack envelope but msgpack "
                            "is not importable here")
        return msgpack.unpackb(data, raw=False)
    return json.loads(data.decode("utf-8"))


def encode_message(payload: Any, *, codec: Optional[str] = None) -> bytes:
    """One full message as bytes: envelope frame + binary frames."""
    codec = codec or default_codec()
    body, bufs = encode_payload(payload)
    meta = []
    for a in bufs:
        raw = a.tobytes()
        meta.append({"dtype": str(a.dtype), "shape": list(a.shape),
                     "bytes": len(raw),
                     "sha256": hashlib.sha256(raw).hexdigest()})
    head, kind = _dumps({"v": WIRE_VERSION, "bufs": meta, "body": body},
                        codec)
    out = [_HEADER.pack(MAGIC, WIRE_VERSION, kind, len(head)), head]
    for a, m in zip(bufs, meta):
        raw = a.tobytes()
        out.append(_HEADER.pack(MAGIC, WIRE_VERSION, KIND_BIN, len(raw)))
        out.append(raw)
    return b"".join(out)


class MessageDecoder:
    """Incremental frame parser: ``feed(bytes)`` returns every message
    completed so far. Shared by the selectors-based servers (non-
    blocking reads land partial frames) and the blocking client (one
    recv can carry several pipelined responses)."""

    def __init__(self, max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES):
        self.max_frame_bytes = int(max_frame_bytes)
        self._buf = bytearray()
        self._head: Optional[Dict] = None   # envelope awaiting buffers
        self._bufs: List[np.ndarray] = []

    def feed(self, data: bytes) -> List[Any]:
        self._buf.extend(data)
        out = []
        while True:
            frame = self._next_frame()
            if frame is None:
                return out
            kind, raw = frame
            if self._head is None:
                if kind == KIND_BIN:
                    raise WireError("binary frame with no envelope")
                self._head = _loads(bytes(raw), kind)
                if self._head.get("v") != WIRE_VERSION:
                    raise WireError(
                        f"envelope version {self._head.get('v')!r}, "
                        f"want {WIRE_VERSION}")
                self._bufs = []
            else:
                if kind != KIND_BIN:
                    raise WireError(
                        "expected binary frame "
                        f"{len(self._bufs)}/{len(self._head['bufs'])}, "
                        f"got kind {kind}")
                m = self._head["bufs"][len(self._bufs)]
                if len(raw) != int(m["bytes"]):
                    raise WireError(
                        f"shard frame is {len(raw)}B, manifest says "
                        f"{m['bytes']}B")
                digest = hashlib.sha256(raw).hexdigest()
                if digest != m["sha256"]:
                    raise WireError(
                        f"shard checksum mismatch: {digest[:12]} != "
                        f"{m['sha256'][:12]} (torn or corrupt frame)")
                self._bufs.append(
                    np.frombuffer(bytes(raw), dtype=np.dtype(m["dtype"]))
                    .reshape(m["shape"]).copy())
            if self._head is not None \
                    and len(self._bufs) == len(self._head["bufs"]):
                head, bufs = self._head, self._bufs
                self._head, self._bufs = None, []
                out.append(decode_payload(head["body"], bufs))

    def _next_frame(self) -> Optional[Tuple[int, bytearray]]:
        if len(self._buf) < HEADER_BYTES:
            return None
        magic, ver, kind, length = _HEADER.unpack_from(self._buf)
        if magic != MAGIC:
            raise WireError(f"bad frame magic {bytes(magic)!r}")
        if ver != WIRE_VERSION:
            raise WireError(f"frame version {ver}, want {WIRE_VERSION}")
        if length > self.max_frame_bytes:
            raise WireError(f"frame of {length}B exceeds the "
                            f"{self.max_frame_bytes}B bound")
        if len(self._buf) < HEADER_BYTES + length:
            return None
        raw = self._buf[HEADER_BYTES:HEADER_BYTES + length]
        del self._buf[:HEADER_BYTES + length]
        return kind, raw


def recv_message(sock, decoder: MessageDecoder, pending: list) -> Any:
    """Blocking read until one full message is available. ``pending``
    holds messages a previous recv over-read (pipelined responses)."""
    while not pending:
        data = sock.recv(1 << 16)
        if not data:
            raise WireError("peer closed the connection mid-message")
        pending.extend(decoder.feed(data))
    return pending.pop(0)


# -- structured rejects / errors --------------------------------------------

def reject_to_wire(rej: Reject) -> Dict[str, Any]:
    return dataclasses.asdict(rej)


def reject_from_wire(d: Dict[str, Any]) -> Reject:
    rej = Reject(**d)
    if rej.reason not in REJECT_REASONS:
        # an unknown reason means the peer speaks a newer (or corrupted)
        # vocabulary — surface it as protocol drift, not a silent pass
        raise WireError(f"unknown Reject reason {rej.reason!r} "
                        f"(registered: {REJECT_REASONS})")
    return rej


# remote exception types this side re-raises as themselves; anything
# else comes back as RemoteError so the type name survives the wire
_ERROR_TYPES = {
    "LoadShedError": LoadShedError,
    "SlotMigrationError": SlotMigrationError,
    "ReplicaCrashed": ReplicaCrashed,
    "ReplicaUnavailable": ReplicaUnavailable,
    "ValueError": ValueError,
    "KeyError": KeyError,
    "TypeError": TypeError,
    "RuntimeError": RuntimeError,
    "NotImplementedError": NotImplementedError,
}


def error_to_wire(exc: BaseException) -> Dict[str, Any]:
    d: Dict[str, Any] = {"type": type(exc).__name__, "message": str(exc)}
    rej = getattr(exc, "reject", None)
    if isinstance(rej, Reject):
        d["reject"] = reject_to_wire(rej)
    return d


def error_from_wire(d: Dict[str, Any]) -> BaseException:
    t = d.get("type", "RemoteError")
    if t == "LoadShedError" and d.get("reject"):
        return LoadShedError(reject_from_wire(d["reject"]))
    cls = _ERROR_TYPES.get(t)
    if cls is not None:
        return cls(d.get("message", ""))
    return RemoteError(f"{t}: {d.get('message', '')}")
