"""Health-routed fleet frontend.

Counterpart of ``photon_ml_tpu/serving/frontend.py``: one HTTP surface
over the supervised replica fleet (``serving.fleet``).  Clients talk to
it as to one ``ModelServer`` (the same ``POST /v1/score`` and the same
``/healthz`` states), and it owns the fleet's resilience:

- **Health routing**: a request goes to the READY replica with the
  fewest outstanding requests; draining, broken and starting replicas
  get nothing.
- **One retry**: a connection-level failure (refused, reset, timed out,
  a torn response: the replica never answered) is retried exactly once
  on another ready replica, inside the request's remaining deadline.
  An HTTP answer from a replica, whatever its status, is forwarded as
  it came and never retried: scoring is idempotent, so the one retry is
  safe, but an answered error is the replica's verdict.
- **Shedding**: no ready replica answers 503 with ``Retry-After`` at
  once; a replica's own shed (429/503) is forwarded with its
  ``Retry-After`` and counts into ``serve.shed``, the input of the
  monitor's ``serve_shed_rate`` rule.
- **The fleet view**: ``/status`` holds the supervisor's per-replica
  state (restarts, breaker, swap) beside the frontend's counters;
  ``/metrics`` both, in Prometheus text.

The frontend holds no model and places no tensor: it never touches the
card, and a swap or restart shows here only in the routing table.
"""

from __future__ import annotations

import http.client
import json
import logging
import socket
import threading
import time
import urllib.error
import urllib.request

from photon_ml_torch import telemetry
from photon_ml_torch.config import ServingConfig
from photon_ml_torch.serving import tracing
from photon_ml_torch.serving.http import (
    READY,
    STOPPING,
    WARMING,
    HttpEndpoint,
    HttpError,
    Readiness,
)
from photon_ml_torch.telemetry import monitor as _mon

logger = logging.getLogger(__name__)

# Connection-level failures: the replica produced no HTTP answer, so one
# retry on another replica is safe (scoring is a pure read).  urllib
# wraps most in URLError; the rest surface while reading the response.
_RETRIABLE = (urllib.error.URLError, ConnectionError, socket.timeout,
              TimeoutError, http.client.HTTPException)

# The least remaining deadline worth spending on a retry.
_MIN_RETRY_BUDGET_S = 0.05


class FleetFrontend:
    """The fleet's request path.  Binds at construction (``config.port``;
    0: ephemeral), serves after ``start()``; its readiness follows the
    fleet's ready count through ``update_readiness`` (called by the
    supervisor's control step)."""

    def __init__(self, config: ServingConfig, supervisor, run_logger=None):
        self.config = config
        self.supervisor = supervisor
        self._log = run_logger
        self.readiness = Readiness(WARMING, reason="no replica is ready yet")
        self._lock = threading.Lock()
        self.requests = 0
        self.retries = 0
        self.failed = 0
        self.shed = 0
        self.t0 = time.monotonic()
        self._http = HttpEndpoint(
            {
                ("POST", "/v1/score"): self._route_score,
                ("GET", "/status"): self._route_status,
                ("GET", "/metrics"): self._route_metrics,
            },
            readiness=self.readiness, port=config.port, host=config.host,
            request_timeout_s=config.http_timeout_s)
        self.port = self._http.port
        supervisor.attach_frontend(self)

    def start(self) -> "FleetFrontend":
        self._http.start()
        logger.info("fleet frontend on http://%s:%d (%d replica(s))",
                    self.config.host, self.port, self.config.replicas)
        return self

    def close(self) -> None:
        self.readiness.set(STOPPING, reason="fleet stopping")
        self._http.close()

    def update_readiness(self, ready_count: int) -> None:
        """Supervisor hook: one ready replica or more, the fleet serves."""
        state = self.readiness.state
        if state == STOPPING:
            return
        if ready_count > 0 and state != READY:
            self.readiness.set(READY)
        elif ready_count == 0 and state == READY:
            self.readiness.set(WARMING, reason="no replica is ready")

    # -- request path --------------------------------------------------------

    def _forward(self, url: str, body: bytes, timeout_s: float,
                 trace_headers: dict | None = None):
        """One attempt against one replica → (code, payload, ctype,
        headers) for any HTTP answer; raises a ``_RETRIABLE`` on a
        connection-level failure.  ``trace_headers`` carry the trace
        context one hop on, so the replica's record joins this one."""
        req = urllib.request.Request(
            url + "/v1/score", data=body,
            headers={"Content-Type": "application/json",
                     **(trace_headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as r:
                return (r.status, r.read().decode(),
                        r.headers.get("Content-Type", "application/json"),
                        {})
        except urllib.error.HTTPError as e:
            # The replica answered: forward its verdict as it came
            # (Retry-After on a shed included), never retried.
            payload = e.read().decode()
            headers = {}
            ra = e.headers.get("Retry-After")
            if ra is not None:
                headers["Retry-After"] = ra
            return (e.code, payload,
                    e.headers.get("Content-Type", "application/json"),
                    headers)

    def _count(self, field: str, telemetry_name: str | None = None) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + 1)
        if telemetry_name:
            telemetry.count(telemetry_name)

    def _route_score(self, body: bytes):
        t0 = time.perf_counter()
        # The request trace, minted or adopted by the HTTP core, goes one
        # hop on to the replica; the core finishes it after the write.
        rt = tracing.begin()
        ctx = tracing.context()
        fwd_headers = None
        if ctx is not None:
            fwd_headers = {tracing.TRACE_HEADER: ctx.child_header(),
                           tracing.REQUEST_ID_HEADER: ctx.trace_id}
        deadline = time.monotonic() + self.config.request_timeout_s
        tried: set[int] = set()
        attempt = 0
        while True:
            replica = self.supervisor.acquire_replica(exclude=tried)
            if replica is None:
                # Nothing to route to (all down or draining, or the one
                # untried replica died): shed honestly.
                if rt is not None:
                    rt.shed = "no_replica"
                self._count("shed", "serve.shed")
                telemetry.count("serve.shed_no_replica")
                raise HttpError(
                    503, headers={"Retry-After": "1"},
                    error="no ready replica"
                          + (" (retry exhausted)" if tried else ""))
            url = replica.url
            tried.add(replica.idx)
            attempt += 1
            budget = deadline - time.monotonic()
            if budget <= 0:
                self.supervisor.release_replica(replica)
                self._count("failed", "serve.frontend_failed")
                raise HttpError(503, error="request deadline exhausted "
                                           "before a replica answered")
            t_f = time.perf_counter()
            if rt is not None and attempt == 1:
                # Routing: from route entry to the first forward.
                rt.stamp("route", t_f - t0)
            try:
                code, payload, ctype, headers = self._forward(
                    url, body, budget, trace_headers=fwd_headers)
            except _RETRIABLE as e:
                # The replica never answered: count it toward its wedge
                # detection and retry exactly once on another replica
                # inside the remaining budget.
                if rt is not None:
                    dt = time.perf_counter() - t_f
                    # A failed attempt's time is the retry's cost (the
                    # serve-report split's retry column).
                    rt.stamp("retry", dt)
                    rt.attempts.append({
                        "replica": replica.idx,
                        "ms": round(dt * 1e3, 3),
                        "outcome": f"connect_fail:{type(e).__name__}"})
                self.supervisor.note_failure(replica.idx)
                remaining = deadline - time.monotonic()
                retriable = attempt == 1 and remaining > _MIN_RETRY_BUDGET_S
                logger.warning(
                    "fleet frontend: replica %d connection failed (%s: %s);"
                    " %s", replica.idx, type(e).__name__, e,
                    "retrying once on another replica" if retriable
                    else "giving up")
                if retriable:
                    self._count("retries", "serve.frontend_retries")
                    self._event("fleet_retry", replica=replica.idx,
                                error=f"{type(e).__name__}: {e}")
                    continue
                self._count("failed", "serve.frontend_failed")
                raise HttpError(
                    502, error=f"replica connection failed after "
                               f"{attempt} attempt(s): "
                               f"{type(e).__name__}: {e}")
            finally:
                self.supervisor.release_replica(replica)
            if rt is not None:
                dt = time.perf_counter() - t_f
                rt.stamp("forward", dt)
                rt.attempts.append({"replica": replica.idx,
                                    "ms": round(dt * 1e3, 3),
                                    "outcome": code})
            if code == 200:
                self._count("requests", "serve.requests")
                telemetry.observe("serve.request_s",
                                  time.perf_counter() - t0)
            elif code in (429, 503):
                # A replica's own shed (saturation, admission, deadline):
                # the fleet's shed pressure, serve_shed_rate's input.
                self._count("shed", "serve.shed")
                telemetry.count("serve.shed_replica")
            with self._lock:
                total = self.requests
                retries, shed = self.retries, self.shed
            _mon.progress("serve", total, unit="requests", retries=retries,
                          shed=shed)
            return code, payload, ctype, headers or None

    def _event(self, kind: str, **fields) -> None:
        if self._log is not None:
            self._log.event(kind, **fields)

    # -- observer routes -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "requests": self.requests,
                "retries": self.retries,
                "failed": self.failed,
                "shed": self.shed,
                "uptime_s": round(time.monotonic() - self.t0, 1),
            }

    def _route_status(self, body: bytes):
        rec = tracing.active()
        stages = tracing.stage_summary()
        st = {
            "state": self.readiness.state,
            "frontend": self.stats(),
            "fleet": self.supervisor.status(),
            **({"tracing": rec.snapshot()} if rec is not None else {}),
            **({"stages": stages} if stages else {}),
        }
        mon = _mon.active()
        if mon is not None:
            st.update(mon.status())
        return 200, json.dumps(st), "application/json"

    def _route_metrics(self, body: bytes):
        lines = [_mon.prometheus_text(_mon.active()).rstrip("\n")]
        fleet = self.supervisor.status()
        fe = self.stats()
        lines.append("# TYPE photon_fleet_ready_replicas gauge")
        lines.append(f"photon_fleet_ready_replicas {fleet['ready']}")
        lines.append("# TYPE photon_fleet_replica_restarts_total counter")
        lines.append("photon_fleet_replica_restarts_total "
                     f"{fleet['restarts']}")
        for name in ("requests", "retries", "failed", "shed"):
            lines.append(f"# TYPE photon_frontend_{name}_total counter")
            lines.append(f"photon_frontend_{name}_total {fe[name]}")
        return 200, "\n".join(lines) + "\n", "text/plain; version=0.0.4"
