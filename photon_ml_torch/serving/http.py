"""Threaded HTTP core: route table + readiness semantics.

Counterpart of ``photon_ml_tpu/serving/http.py``: one core serves both
the model server's request path (``/v1/score``) and the monitor's
observer routes (``/status``, ``/metrics``).  Every endpoint answers
``GET /healthz`` (and ``/``) from one state machine:

- ``warming`` → 503: up, not serviceable yet (model load, warm-up);
- ``ready`` → 200;
- ``stopping`` → 503: graceful drain in progress.

Each connection gets a socket timeout, so a stalled client is dropped
instead of pinning a handler thread, and request bodies are bounded by
``max_body``.  Route errors may carry response headers
(``HttpError(..., headers={"Retry-After": "1"})``).

Request identity: every dispatch adopts (or mints) a trace context from
``X-Photon-Trace`` / ``X-Photon-Request-Id`` and echoes both headers on
EVERY response (404s, 413s, 500s and 503 sheds included).  Routes read
the context through ``tracing.context()``; a route that began a
``RequestTrace`` leaves it attached, and the core stamps the response
write and finishes the trace after the bytes go out.

Stdlib only (``telemetry.monitor`` imports this module; ``tracing`` is
stdlib-only at import time for the same reason).
"""

from __future__ import annotations

import http.server
import json
import logging
import socket
import threading
import time

from photon_ml_torch.serving import tracing

logger = logging.getLogger(__name__)

WARMING = "warming"
READY = "ready"
STOPPING = "stopping"

_STATES = (WARMING, READY, STOPPING)

DEFAULT_TIMEOUT_S = 30.0
DEFAULT_MAX_BODY = 32 << 20


class Readiness:
    """Thread-safe readiness state + human reason."""

    def __init__(self, state: str = WARMING, reason: str | None = None):
        self._check(state)
        self._lock = threading.Lock()
        self._state = state
        self._reason = reason

    @staticmethod
    def _check(state: str) -> None:
        if state not in _STATES:
            raise ValueError(
                f"readiness state {state!r} not in {_STATES}")

    def set(self, state: str, reason: str | None = None) -> None:
        self._check(state)
        with self._lock:
            self._state = state
            self._reason = reason

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def snapshot(self) -> tuple[str, str | None]:
        with self._lock:
            return self._state, self._reason

    def healthz(self) -> tuple[int, dict]:
        """(HTTP code, JSON body) for ``GET /healthz``."""
        state, reason = self.snapshot()
        body = {"ok": state == READY, "state": state}
        if reason:
            body["reason"] = reason
        return (200 if state == READY else 503), body


class HttpError(Exception):
    """Raise from a route handler to answer a structured error."""

    def __init__(self, code: int, headers: dict | None = None, **body):
        self.code = int(code)
        self.body = body
        self.headers = dict(headers) if headers else None
        super().__init__(f"{code}: {body}")


class _Handler(http.server.BaseHTTPRequestHandler):
    """Route-table dispatch; the endpoint rides as a class attribute
    (one handler class per ``HttpEndpoint``)."""

    endpoint: "HttpEndpoint | None" = None
    timeout = DEFAULT_TIMEOUT_S
    MAX_BODY = DEFAULT_MAX_BODY

    def _send(self, code: int, body: str, ctype: str,
              headers: dict | None = None) -> None:
        data = body.encode()
        t0 = time.perf_counter()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        # Every response, sheds and errors included, carries the trace
        # identity.
        for k, v in (getattr(self, "_trace_hdrs", None) or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(data)
        self._sent = (code, time.perf_counter() - t0)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj), "application/json")

    def _dispatch(self, method: str) -> None:
        ctx = tracing.from_headers(self.headers)
        tracing.set_context(ctx)
        self._trace_hdrs = {
            tracing.REQUEST_ID_HEADER: ctx.trace_id,
            tracing.TRACE_HEADER: ctx.header_value(),
        }
        self._sent = None
        try:
            self._dispatch_routed(method)
        finally:
            # A route that began a RequestTrace left it attached: its
            # write stage is the send just made, and the finish covers
            # every outcome (200s, sheds, 500s).
            rt = tracing.take_attached()
            if rt is not None:
                sent = self._sent
                if sent is not None:
                    rt.stamp("write", sent[1])
                tracing.finish(rt, status=sent[0] if sent else None)
            tracing.clear()

    def _dispatch_routed(self, method: str) -> None:
        ep = self.endpoint
        path = self.path.split("?", 1)[0]
        if path in ("/", "/healthz"):
            code, body = ep.readiness.healthz()
            self._send_json(code, body)
            return
        route = ep.routes.get((method, path))
        if route is None:
            self._send_json(404, {
                "error": "unknown route",
                "routes": sorted({p for _, p in ep.routes} | {"/healthz"}),
            })
            return
        body = b""
        if method == "POST":
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                length = 0
            if length > self.MAX_BODY:
                self._send_json(413, {"error": "request body too large",
                                      "max_bytes": self.MAX_BODY})
                return
            try:
                body = self.rfile.read(length) if length else b""
            except (TimeoutError, socket.timeout, OSError) as e:
                logger.warning("http: request body read failed (%r); "
                               "closing connection", e)
                self.close_connection = True
                return
        headers = None
        try:
            # (code, payload, ctype), or with response headers (the
            # fleet frontend forwards a replica's Retry-After)
            # (code, payload, ctype, headers).
            result = route(body)
            code, payload, ctype = result[:3]
            if len(result) == 4:
                headers = result[3]
        except HttpError as e:
            code, payload, ctype = e.code, json.dumps(e.body), \
                "application/json"
            headers = e.headers
        except Exception as e:   # a handler bug must answer, not hang
            logger.exception("http route %s %s failed", method, path)
            code, payload, ctype = 500, json.dumps(
                {"error": f"{type(e).__name__}: {e}"}), "application/json"
        self._send(code, payload, ctype, headers=headers)

    def do_GET(self) -> None:    # noqa: N802 (http.server API)
        self._dispatch("GET")

    def do_POST(self) -> None:   # noqa: N802 (http.server API)
        self._dispatch("POST")

    def log_message(self, format, *args):   # noqa: A002 (stdlib API)
        logger.debug("http: " + format, *args)


class HttpEndpoint:
    """The threaded server: binds at construction (port 0 = ephemeral;
    the bound port is in ``.port``), serves after ``start()``.

    ``routes``: ``{(method, path): fn(body: bytes) -> (code, payload,
    content_type[, headers])}``; ``/healthz`` is built in.
    """

    def __init__(self, routes: dict, readiness: Readiness | None = None,
                 port: int = 0, host: str = "127.0.0.1",
                 request_timeout_s: float = DEFAULT_TIMEOUT_S,
                 max_body: int = DEFAULT_MAX_BODY):
        self.routes = dict(routes)
        self.readiness = readiness if readiness is not None \
            else Readiness(READY)
        handler = type("_BoundHandler", (_Handler,), {
            "endpoint": self,
            "timeout": float(request_timeout_s),
            "MAX_BODY": int(max_body),
        })
        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                      handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._started = False
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="photon-http-endpoint")

    def start(self) -> None:
        self._thread.start()
        self._started = True

    def close(self) -> None:
        # shutdown() waits on an event only serve_forever() sets: a
        # never-started server must skip it.
        if self._started:
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
        self._httpd.server_close()
