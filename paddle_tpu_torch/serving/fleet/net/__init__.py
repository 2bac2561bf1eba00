"""Network serving: process-isolated replicas + a streaming front door.

The router speaks only
:class:`~paddle_tpu_torch.serving.fleet.replica.ReplicaHandle`; this
package puts a socket behind it. :mod:`wire` is a length-prefixed
framed protocol (msgpack/JSON envelopes, sha256-checksummed binary frames);
:mod:`replica_server` runs one ``ServingEngine`` in its own process
behind that protocol; :class:`NetReplica` is the client-side handle
the router drives exactly like a ``LocalReplica`` — breakers, redrive
and migration included, zero router forks. :class:`FrontDoor` is the
client-facing edge: it routes ``generate`` requests through a
``FleetRouter`` and streams tokens incrementally with bounded
per-connection buffers and structured rejects.
"""

from paddle_tpu_torch.serving.fleet.net.frontdoor import (NETLOG_SCHEMA,
                                                          FrontDoor,
                                                          FrontDoorClient,
                                                          validate_netlog_file)
from paddle_tpu_torch.serving.fleet.net.replica import (DEFAULT_CONNECT_RETRY,
                                                        NetReplica)
from paddle_tpu_torch.serving.fleet.net.replica_server import (
    ReplicaServer, spawn_replica_server)
from paddle_tpu_torch.serving.fleet.net.wire import (MessageDecoder,
                                                     RemoteError, WireError,
                                                     decode_payload,
                                                     default_codec,
                                                     encode_message,
                                                     encode_payload,
                                                     error_from_wire,
                                                     error_to_wire,
                                                     reject_from_wire,
                                                     reject_to_wire)

__all__ = [
    "NETLOG_SCHEMA",
    "FrontDoor",
    "FrontDoorClient",
    "validate_netlog_file",
    "DEFAULT_CONNECT_RETRY",
    "NetReplica",
    "ReplicaServer",
    "spawn_replica_server",
    "MessageDecoder",
    "RemoteError",
    "WireError",
    "decode_payload",
    "default_codec",
    "encode_message",
    "encode_payload",
    "error_from_wire",
    "error_to_wire",
    "reject_from_wire",
    "reject_to_wire",
]
