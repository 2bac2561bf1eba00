"""Live exposition endpoint (``paddle_tpu/observability/exposition.py``):
scrape a RUNNING engine.

A stdlib ``http.server`` on a background daemon thread, serving
read-only views:

  ``/metrics``  Prometheus text exposition of the registry (0.0.4).
  ``/healthz``  structured JSON health: server status + uptime + one
                object per registered provider (the serving engine
                publishes slot occupancy, queue depth, page
                utilization, recompile count — see
                ``ServingEngine.health``). A provider that raises, or
                reports ``{"degraded": true}``, marks the response
                degraded (HTTP 503) instead of crashing the endpoint.
  ``/traces``   recent ring-buffer spans as JSON (``?limit=N``,
                ``?trace_id=T``), newest last.
  ``/debug/postmortem``
                recent flight-recorder postmortem bundles from every
                registered provider (``?limit=N`` most recent,
                ``?replica=NAME`` one provider).
  extra routes  any read-only JSON view a subsystem hangs off the one
                operator endpoint with ``add_json`` (the network front
                door's ``/debug/netlog``).

Opt-in and port-0 by default: nothing binds unless a caller starts a
server, and tests take an ephemeral port. The handler thread only
*reads* registry/tracer state (both lock-protected), so scraping never
blocks the serving loop.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

from paddle_tpu_torch.observability import registry as _registry
from paddle_tpu_torch.observability import tracing as _tracing

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class ExpositionServer:
    """Background-thread HTTP exposition over a registry + tracer.

    ::

        srv = ExpositionServer(registry=reg, tracer=tr).start()
        srv.add_health("serving", engine.health)
        ... requests hit http://127.0.0.1:{srv.port}/metrics ...
        srv.stop()
    """

    def __init__(self, registry: Optional[_registry.MetricsRegistry] = None,
                 tracer: Optional[_tracing.Tracer] = None,
                 port: int = 0, host: str = "127.0.0.1"):
        self.registry = registry or _registry.default()
        self.tracer = tracer or _tracing.default()
        self._host = host
        self._want_port = int(port)
        self._health: Dict[str, Callable[[], dict]] = {}
        self._postmortem: Dict[str, Callable[[], list]] = {}
        self._json: Dict[str, Callable[[], object]] = {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._t0 = time.monotonic()

    def add_health(self, name: str,
                   provider: Callable[[], dict]) -> "ExpositionServer":
        """Register a named health provider (a zero-arg callable
        returning a JSON-able dict); its output nests under ``name`` in
        the ``/healthz`` body."""
        self._health[name] = provider
        return self

    def add_postmortem(self, name: str,
                       provider: Callable[[], list]) -> "ExpositionServer":
        """Register a postmortem-bundle provider (a zero-arg callable
        returning a list of bundle dicts, oldest → newest — e.g.
        ``FlightRecorder.bundles``);
        served under ``/debug/postmortem``."""
        self._postmortem[name] = provider
        return self

    def add_json(self, path: str,
                 provider: Callable[[], object]) -> "ExpositionServer":
        """Register an extra read-only JSON route (a zero-arg callable
        returning a JSON-able value), e.g. the network front door's
        ``/debug/netlog`` ledger. Reserved routes cannot be shadowed."""
        route = "/" + path.strip("/")
        if route in ("/metrics", "/healthz", "/traces",
                     "/debug/postmortem", "/"):
            raise ValueError(f"route {route!r} is reserved")
        self._json[route] = provider
        return self

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "ExpositionServer":
        if self._httpd is not None:
            return self
        server = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):    # silence per-request stderr
                pass

            def do_GET(self):
                server._handle(self)

        self._httpd = ThreadingHTTPServer((self._host, self._want_port),
                                          _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="exposition",
            daemon=True)
        self._t0 = time.monotonic()
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("exposition server not started")
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def __enter__(self) -> "ExpositionServer":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- request handling -------------------------------------------------
    def _handle(self, h: BaseHTTPRequestHandler):
        try:
            parsed = urlparse(h.path)
            route = parsed.path.rstrip("/") or "/"
            if route == "/metrics":
                body = self.registry.render_prometheus().encode()
                self._reply(h, 200, PROMETHEUS_CONTENT_TYPE, body)
            elif route == "/healthz":
                status, payload = self.healthz()
                self._reply(h, 200 if status == "ok" else 503,
                            "application/json",
                            json.dumps(payload, default=str).encode())
            elif route == "/traces":
                q = parse_qs(parsed.query)
                try:
                    limit = int(q["limit"][0]) if "limit" in q else None
                    trace_id = (int(q["trace_id"][0])
                                if "trace_id" in q else None)
                except ValueError as e:
                    # caller input error, not a server fault: a scraper
                    # must not page on endpoint health over a typo
                    self._reply(h, 400, "text/plain",
                                f"bad query parameter: {e}".encode())
                    return
                payload = self.traces(limit=limit, trace_id=trace_id)
                self._reply(h, 200, "application/json",
                            json.dumps(payload, default=str).encode())
            elif route == "/debug/postmortem":
                q = parse_qs(parsed.query)
                try:
                    limit = int(q["limit"][0]) if "limit" in q else None
                except ValueError as e:
                    self._reply(h, 400, "text/plain",
                                f"bad query parameter: {e}".encode())
                    return
                replica = q["replica"][0] if "replica" in q else None
                payload = self.postmortems(limit=limit, replica=replica)
                self._reply(h, 200, "application/json",
                            json.dumps(payload, default=str).encode())
            elif route in self._json:
                # the healthz discipline: a sick provider is a 503 with
                # the error in the body, never a dead endpoint
                try:
                    payload, code = self._json[route](), 200
                except Exception as e:
                    payload = {"error": f"{type(e).__name__}: {e}"}
                    code = 503
                self._reply(h, code, "application/json",
                            json.dumps(payload, default=str).encode())
            else:
                routes = " ".join(
                    ["/metrics", "/healthz", "/traces",
                     "/debug/postmortem"] + sorted(self._json))
                self._reply(h, 404, "text/plain",
                            f"paddle_tpu exposition: {routes}\n"
                            .encode())
        except BrokenPipeError:
            pass                     # scraper went away mid-reply
        except Exception as e:       # never take the endpoint down
            try:
                self._reply(h, 500, "text/plain",
                            f"exposition error: {e}".encode())
            except Exception:
                pass

    @staticmethod
    def _reply(h, code: int, ctype: str, body: bytes):
        h.send_response(code)
        h.send_header("Content-Type", ctype)
        h.send_header("Content-Length", str(len(body)))
        h.end_headers()
        h.wfile.write(body)

    # -- payloads (also callable without HTTP, for tests) -----------------
    def healthz(self):
        """(status, payload): "ok" unless any provider raised OR
        reported itself degraded (``{"degraded": true}`` in its
        payload), so load balancers see a sick provider as HTTP 503
        without the provider having to crash."""
        status = "ok"
        providers: Dict[str, dict] = {}
        for name, fn in self._health.items():
            try:
                providers[name] = fn()
                if isinstance(providers[name], dict) \
                        and providers[name].get("degraded"):
                    status = "degraded"
            except Exception as e:
                status = "degraded"
                providers[name] = {"error": f"{type(e).__name__}: {e}"}
        payload = {
            "status": status,
            "time": time.time(),
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "tracing_enabled": bool(self.tracer.enabled),
            "providers": providers,
        }
        return status, payload

    def postmortems(self, limit: Optional[int] = None,
                    replica: Optional[str] = None) -> dict:
        """Recent postmortem bundles across providers, oldest → newest;
        a provider that raises reports an error entry instead of taking
        the endpoint down (the healthz discipline)."""
        bundles: list = []
        errors: Dict[str, str] = {}
        for name, fn in self._postmortem.items():
            if replica is not None and name != replica:
                continue
            try:
                bundles.extend(fn())
            except Exception as e:
                errors[name] = f"{type(e).__name__}: {e}"
        bundles.sort(key=lambda b: b.get("ts", 0.0))
        if limit is not None and limit >= 0:
            bundles = bundles[-limit:]
        payload = {"count": len(bundles), "bundles": bundles}
        if errors:
            payload["errors"] = errors
        return payload

    def traces(self, limit: Optional[int] = None,
               trace_id: Optional[int] = None) -> dict:
        spans = self.tracer.spans(trace_id=trace_id, limit=limit)
        return {
            "capacity": self.tracer.capacity,
            "dropped": self.tracer.dropped,
            "count": len(spans),
            "spans": [s.to_record() for s in spans],
        }
