"""Live run monitoring: progress snapshots, online alerts, and the
status endpoint.

Counterpart of ``photon_ml_tpu/telemetry/monitor.py``, with the same
rules, thresholds, events and exposition.  The live tier on top of the
telemetry session:

- **Progress snapshots**: instrumented loops (the serving batcher; the
  streaming solvers, coordinate descent, the tuner and the scorer) call
  ``monitor.progress(stage, done, total)`` per unit of work; the monitor
  throttles to a wall-clock cadence (``every_s``) and emits ``progress``
  JSONL events carrying a rolling throughput and an ETA.
- **Online alert rules**, evaluated at snapshot cadence: non-finite or
  diverging loss, throughput collapse, prefetch stall, retry storms,
  sink saturation, device-memory growth (the ``device.bytes_in_use``
  gauge the telemetry session samples from ``torch.cuda.memory_stats``),
  and the serving rules: tail latency, queue wait and shed rate.  Each
  rule LATCHES per (rule, stage): a fault produces exactly one ``alert``
  event, shown by ``telemetry watch``, the status endpoint and the
  report.
- **Status endpoint**: ``GET /status`` (JSON: phase, per-stage progress,
  ETA, alerts) and ``GET /metrics`` (Prometheus text of the telemetry
  registry), on the shared HTTP core; the model server mounts the same
  routes on its own port.

Off by default: ``progress()`` with no active monitor is one global
read and an early return.  The monitor and its status thread read only
the registry: they never call into ``torch.cuda`` (no synchronization,
no allocation).

All monitor state mutates under one lock; the status thread reads
through locked snapshot methods; events go through the (locked)
``RunLogger``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import re
import statistics
import threading
import time

from photon_ml_torch import telemetry
# The status endpoint rides the model server's HTTP core (stdlib only,
# so no import cycle).
from photon_ml_torch.serving.http import (
    READY,
    STOPPING,
    WARMING,
    HttpEndpoint,
    Readiness,
)

logger = logging.getLogger(__name__)

DEFAULT_EVERY_S = 2.0
# Rolling window for throughput/ETA and the alert rules' rate queries.
DEFAULT_WINDOW_S = 30.0
# Per-stage bounded history caps (snapshots are cadence-throttled, so
# these cover minutes of run at the default cadence).
_SAMPLE_CAP = 256
_RATE_HISTORY_CAP = 64

# Alert-rule thresholds; every one overridable per Monitor (the unit
# tests pin exactly which rules fire on synthetic streams).
DEFAULT_THRESHOLDS: dict = {
    # loss_diverging: finite loss worse than divergence_ratio x the
    # best loss this stage has seen (only defined for positive best).
    "divergence_ratio": 2.0,
    # throughput_collapse: current rate below collapse_fraction x the
    # median of the stage's previous snapshot rates, once at least
    # collapse_min_snapshots rates are on record.
    "collapse_fraction": 0.25,
    "collapse_min_snapshots": 4,
    # prefetch_stall: consumer blocked on the queue more than this
    # fraction of recent wall clock (rate of the seconds-counter), or
    # any hard stall timeout.
    "stall_wait_fraction": 0.75,
    # retry_storm: transient-I/O retries per second over the window,
    # or any store.gave_up.
    "retry_rate_per_s": 0.5,
    # sink_saturation: sink.queue_depth gauge at/above this depth for
    # this many consecutive snapshot evaluations (writer queue is 4
    # deep — sustained 3 means the sink tier is the bottleneck).
    "sink_queue_depth": 3,
    "sink_queue_streak": 2,
    # device_memory_growth: device.bytes_in_use grew by both this
    # ratio and this many MB since the monitor's first sample.
    "memory_growth_ratio": 1.5,
    "memory_growth_min_mb": 256.0,
    # serve_tail_latency: the serving tier's per-request
    # latency p99 (the bounded-reservoir rolling estimate over
    # serve.request_s) above this many seconds, once at least
    # serve_min_requests requests are on record — the online signal
    # that the micro-batcher/device path is falling behind its SLO.
    "serve_p99_s": 0.5,
    "serve_min_requests": 20,
    # serve_shed_rate: the shed fraction over the rolling
    # window — serve.shed / (serve.shed + serve.requests), both as
    # windowed rates — above this fraction, once at least
    # serve_shed_min_events (sheds + served) are on record.  Shedding
    # is the DESIGNED overload response (503 + Retry-After beats queue
    # collapse), but a sustained shed fraction means the fleet is
    # under-provisioned and an operator must see it.
    "serve_shed_fraction": 0.2,
    "serve_shed_min_events": 20,
    # serve_queue_wait: the batcher-is-the-bottleneck
    # signal — the queue-wait stage's p99 (from the request-tracing
    # tier's serve.stage.queue_wait_s histogram) exceeding this
    # fraction of the end-to-end request p99, once at least
    # queue_wait_min_requests requests are on record.  A tail
    # dominated by queue wait means requests are waiting on batch
    # formation/device capacity, not on the work itself — add
    # replicas or widen buckets rather than chasing the engine.
    "queue_wait_fraction": 0.5,
    "queue_wait_min_requests": 20,
}

_ACTIVE: "Monitor | None" = None
_ACTIVE_LOCK = threading.Lock()


def active() -> "Monitor | None":
    """The active monitor, or None when live monitoring is off."""
    return _ACTIVE


def progress(stage: str, done, total=None, unit: str = "units",
             **fields) -> None:
    """Report ``done`` (of ``total``) work units for ``stage``.  The
    hot-path contract: one module-global read + early return when
    monitoring is off; when on, emission is throttled to the monitor's
    wall-clock cadence, so per-chunk call sites pay dict bookkeeping,
    not I/O."""
    m = _ACTIVE
    if m is not None:
        m.progress(stage, done, total, unit, **fields)


def phase_begin(name: str) -> None:
    """Driver-phase entry hook (``RunLogger.timed`` calls this) — the
    status endpoint and ``watch`` report the innermost open phase."""
    m = _ACTIVE
    if m is not None:
        m.phase_begin(name)


def phase_end(name: str) -> None:
    m = _ACTIVE
    if m is not None:
        m.phase_end(name)


class Monitor:
    """One live-monitoring session (create via ``start()`` /
    ``maybe_monitor()`` — the module helpers dispatch to the single
    active monitor).

    ``run_logger``: the events channel (``progress`` / ``alert`` /
    ``monitor_summary`` JSONL lines); when None a pure stdlib-logging
    ``RunLogger`` is created and owned.  ``status_port`` spawns the
    HTTP status server (port 0 = ephemeral; the bound port is in
    ``status_port`` and logged as a ``status_server`` event).
    ``telemetry_session`` overrides the registry the alert rules read
    (tests); by default the rules look up the live session at
    evaluation time, and registry-backed rules simply stay inactive
    when telemetry is off.
    """

    def __init__(self, run_logger=None, every_s: float = DEFAULT_EVERY_S,
                 window_s: float = DEFAULT_WINDOW_S,
                 status_port: int | None = None,
                 alerts: bool = True,
                 thresholds: dict | None = None,
                 telemetry_session=None,
                 clock=time.monotonic):
        if every_s < 0:
            raise ValueError(f"every_s must be >= 0, got {every_s!r}")
        owns = False
        if run_logger is None:
            from photon_ml_torch.utils.run_log import RunLogger

            run_logger = RunLogger(None)
            owns = True
        self._log = run_logger
        self._owns_logger = owns
        self.every_s = float(every_s)
        self.window_s = float(window_s)
        self._alerts_enabled = alerts
        self.thresholds = {**DEFAULT_THRESHOLDS, **(thresholds or {})}
        unknown = set(self.thresholds) - set(DEFAULT_THRESHOLDS)
        if unknown:
            raise ValueError(f"unknown alert thresholds: {sorted(unknown)}")
        self._session = telemetry_session
        self._clock = clock
        self._lock = threading.Lock()
        self._stages: dict[str, dict] = {}
        self._phases: list[str] = []
        self._alerts: list[dict] = []
        self._fired: set = set()
        self._snapshots = 0
        self._sink_high_streak = 0
        self._dev_first_bytes: float | None = None
        self._closed = False
        # Readiness for /healthz: the monitored run is WARMING (plan
        # build, kernel build or the first work unit in progress) until
        # the first progress snapshot arrives, then READY: the same
        # warming→503 / ready→200 semantics as the model server.
        self.readiness = Readiness(
            WARMING, reason="no progress snapshot yet "
                            "(plan/kernel build or first work unit pending)")
        self._server: _StatusServer | None = None
        self.status_port: int | None = None
        if status_port is not None:
            self._server = _StatusServer(self, status_port)
        self.t0 = self._clock()

    # -- lifecycle ----------------------------------------------------------

    def _open(self) -> None:
        self._log.event("monitor_start", every_s=self.every_s)
        if self._server is not None:
            self._server.start()
            self.status_port = self._server.port
            self._log.event("status_server", port=self._server.port,
                            routes=["/status", "/metrics"])
            logger.info("status endpoint on http://127.0.0.1:%d/status",
                        self._server.port)

    def close(self) -> None:
        """Emit the summary event, stop the status server, deactivate.
        Idempotent."""
        global _ACTIVE
        if self._closed:
            return
        self._closed = True
        self.readiness.set(STOPPING, reason="monitor closing")
        if self._server is not None:
            self._server.close()
            self._server = None
        self._log.event("monitor_summary", **self.summary())
        if self._owns_logger:
            self._log.close()
        with _ACTIVE_LOCK:
            if _ACTIVE is self:
                _ACTIVE = None

    # -- phase tracking ------------------------------------------------------

    def phase_begin(self, name: str) -> None:
        with self._lock:
            self._phases.append(name)

    def phase_end(self, name: str) -> None:
        with self._lock:
            if name in self._phases:
                # Remove the innermost match (phases nest; a missed
                # begin must not corrupt the stack).
                for i in range(len(self._phases) - 1, -1, -1):
                    if self._phases[i] == name:
                        del self._phases[i]
                        break

    # -- progress ------------------------------------------------------------

    def mark_ready(self) -> None:
        """Flip /healthz to ready (200).  Progress snapshots do this
        implicitly — work flowing means the warm-up is behind us; the
        model server calls it explicitly after its bucket warm-up."""
        self.readiness.set(READY)

    def progress(self, stage: str, done, total=None,
                 unit: str = "units", **fields) -> None:
        now = self._clock()
        done = float(done)
        if self.readiness.state == WARMING:
            self.mark_ready()
        with self._lock:
            st = self._stages.get(stage)
            first = st is None
            if first:
                st = self._stages[stage] = {
                    "stage": stage, "done": done, "total": total,
                    "unit": unit, "rate": None, "eta_s": None,
                    "fields": {}, "samples": [], "rates": [],
                    "last_emit": -math.inf, "updated": now,
                    "first_loss": None, "best_loss": None,
                    "last_loss": None,
                }
            if done < st["done"]:
                # A new pass/sweep restarted the unit count: reset the
                # rate window so the rolling throughput never goes
                # negative across the seam.
                st["samples"] = []
            st["done"] = done
            st["total"] = None if total is None else float(total)
            st["unit"] = unit
            st["updated"] = now
            if fields:
                st["fields"].update(fields)
            loss = fields.get("loss")
            if loss is not None:
                loss = float(loss)
                st["last_loss"] = loss
                if math.isfinite(loss):
                    if st["first_loss"] is None:
                        st["first_loss"] = loss
                    if st["best_loss"] is None or loss < st["best_loss"]:
                        st["best_loss"] = loss
            st["samples"].append((now, done))
            cutoff = now - self.window_s
            samples = st["samples"]
            while len(samples) > 2 and samples[0][0] < cutoff:
                samples.pop(0)
            if len(samples) > _SAMPLE_CAP:
                # Every-other decimation keeping the just-appended
                # newest sample (``del samples[::2]`` would drop it and
                # lag the rolling rate by one update).
                del samples[1::2]
            complete = (st["total"] is not None
                        and done >= st["total"])
            if (not first and not complete
                    and now - st["last_emit"] < self.every_s):
                return               # throttled: no event, no alerts
            st["last_emit"] = now
            rate = None
            if len(samples) >= 2 and samples[-1][0] > samples[0][0]:
                rate = ((samples[-1][1] - samples[0][1])
                        / (samples[-1][0] - samples[0][0]))
            st["rate"] = rate
            eta = None
            if (st["total"] is not None and rate is not None and rate > 0
                    and st["total"] > done):
                eta = (st["total"] - done) / rate
            st["eta_s"] = eta
            if rate is not None:
                st["rates"].append(rate)
                del st["rates"][:-_RATE_HISTORY_CAP]
            self._snapshots += 1
            phase = self._phases[-1] if self._phases else None
            rec = {
                "stage": stage, "done": done, "unit": unit,
                **({"total": st["total"]}
                   if st["total"] is not None else {}),
                **({"rate": round(rate, 3)} if rate is not None else {}),
                **({"eta_s": round(eta, 1)} if eta is not None else {}),
                **({"phase": phase} if phase else {}),
                **fields,
            }
        t = self._session if self._session is not None \
            else telemetry.active()
        if stage == "serve" and t is not None:
            # Serve progress snapshots carry the stage-latency table
            # so `telemetry watch` renders the serve stage
            # decomposition live — cadence-throttled with the event,
            # zero cost on the hot path.
            from photon_ml_torch.serving import tracing as _tracing

            stage_tbl = _tracing.stage_summary(session=t)
            if stage_tbl:
                rec["stages_ms"] = stage_tbl
        self._log.event("progress", **rec)
        if t is not None:
            t.count("monitor.progress_events")
        self._evaluate_alerts(now)

    # -- alert rules ---------------------------------------------------------

    def _fire(self, rule: str, stage: str | None, message: str,
              severity: str = "warn", **context) -> None:
        key = (rule, stage)
        with self._lock:
            if key in self._fired:
                return
            self._fired.add(key)
            alert = {"rule": rule, "severity": severity,
                     "message": message, "t": round(self._log.now(), 6),
                     **({"stage": stage} if stage else {}), **context}
            self._alerts.append(alert)
        self._log.event("alert", rule=rule, severity=severity,
                        message=message,
                        **({"stage": stage} if stage else {}), **context)
        t = self._session if self._session is not None \
            else telemetry.active()
        if t is not None:
            t.count("monitor.alerts")
        logger.warning("ALERT [%s] %s%s: %s", severity, rule,
                       f" ({stage})" if stage else "", message)

    def _evaluate_alerts(self, now: float) -> None:
        """Run every rule against the current stage states and the
        telemetry registry.  Called at snapshot cadence (never from the
        throttled fast path), so rule cost is amortized to ~nothing."""
        if not self._alerts_enabled:
            return
        th = self.thresholds
        with self._lock:
            stages = [(s, dict(st, rates=list(st["rates"])))
                      for s, st in self._stages.items()]
        for stage, st in stages:
            loss = st["last_loss"]
            if loss is not None and not math.isfinite(loss):
                self._fire("loss_nonfinite", stage,
                           f"loss is {loss!r}; the solve is numerically "
                           "dead", severity="error", loss=loss)
            elif (loss is not None and st["best_loss"] is not None
                  and st["best_loss"] > 0
                  and loss > th["divergence_ratio"] * st["best_loss"]):
                self._fire(
                    "loss_diverging", stage,
                    f"loss {loss:.6g} is "
                    f"{loss / st['best_loss']:.2f}x the best seen "
                    f"({st['best_loss']:.6g}); the solve is diverging",
                    severity="error", loss=loss, best=st["best_loss"])
            rates = st["rates"]
            if (len(rates) > th["collapse_min_snapshots"]
                    and rates[-1] is not None):
                base = statistics.median(rates[:-1][-_RATE_HISTORY_CAP:])
                if base > 0 and rates[-1] < th["collapse_fraction"] * base:
                    self._fire(
                        "throughput_collapse", stage,
                        f"throughput {rates[-1]:.3g}/s is below "
                        f"{th['collapse_fraction']:.0%} of the rolling "
                        f"median {base:.3g}/s", rate=round(rates[-1], 3),
                        baseline=round(base, 3))
        t = self._session if self._session is not None \
            else telemetry.active()
        if t is None:
            return
        if t.counter("prefetch.stall_timeouts") > 0:
            self._fire("prefetch_stall", None,
                       "prefetch pipeline hit its stall deadline (see "
                       "stall_timeout_s); the disk/staging tier is "
                       "wedged", severity="error",
                       stall_timeouts=t.counter("prefetch.stall_timeouts"))
        else:
            wait_rate = t.rate("prefetch.consumer_wait_s", self.window_s)
            if (wait_rate is not None
                    and wait_rate > th["stall_wait_fraction"]):
                self._fire(
                    "prefetch_stall", None,
                    f"consumer blocked on the prefetch queue "
                    f"{wait_rate:.0%} of recent wall clock (threshold "
                    f"{th['stall_wait_fraction']:.0%}); the disk tier "
                    "is not keeping up",
                    blocked_fraction=round(wait_rate, 3))
        gave_up = t.counter("store.gave_up")
        retry_rate = t.rate("store.retries", self.window_s)
        if gave_up > 0:
            self._fire("retry_storm", None,
                       f"{gave_up} chunk-store I/O operation(s) "
                       "exhausted their retry budget",
                       severity="error", gave_up=gave_up)
        elif retry_rate is not None and retry_rate > th["retry_rate_per_s"]:
            self._fire("retry_storm", None,
                       f"transient I/O retries at {retry_rate:.2f}/s "
                       f"(threshold {th['retry_rate_per_s']:g}/s); the "
                       "spill-dir storage is degrading",
                       retries_per_s=round(retry_rate, 3))
        # serve_tail_latency: the serving tier's request
        # latency histogram, once enough requests are on record.  The
        # p99 comes from the bounded reservoir — a stride-decimated
        # rolling estimate of the stream, the same estimator /metrics
        # exposes — and the rule latches per (rule, stage) like every
        # other rule: one alert per incident, not one per snapshot.
        p99 = t.percentile("serve.request_s", 0.99)
        if (p99 is not None
                and t.counter("serve.requests") >= th["serve_min_requests"]
                and p99 > th["serve_p99_s"]):
            # Name the dominant stage: with request tracing
            # on, the serve.stage.* histograms say WHERE the tail goes
            # — the alert carries the first diagnostic step.
            from photon_ml_torch.serving import tracing as _tracing

            dom = _tracing.dominant_stage(
                _tracing.stage_summary(session=t))
            self._fire(
                "serve_tail_latency", "serve",
                f"p99 request latency {p99 * 1e3:.1f} ms exceeds the "
                f"{th['serve_p99_s'] * 1e3:.0f} ms threshold; the "
                "serving tier is missing its tail SLO"
                + (f" (dominant stage: {dom[0]}, p99 {dom[1]:.1f} ms)"
                   if dom is not None else ""),
                p99_ms=round(p99 * 1e3, 2),
                threshold_ms=round(th["serve_p99_s"] * 1e3, 2),
                requests=t.counter("serve.requests"),
                **({"dominant_stage": dom[0],
                    "dominant_p99_ms": dom[1]} if dom is not None
                   else {}))
        # serve_queue_wait: queue wait dominating the
        # request tail IS the "batcher is the bottleneck" signal —
        # per-request wait vs shared compute is exactly the split the
        # tracing tier measures.  Latched like every rule.
        qw_p99 = t.percentile("serve.stage.queue_wait_s", 0.99)
        if (qw_p99 is not None and p99 is not None and p99 > 0
                and t.counter("serve.requests")
                >= th["queue_wait_min_requests"]
                and qw_p99 > th["queue_wait_fraction"] * p99):
            self._fire(
                "serve_queue_wait", "serve",
                f"p99 queue wait {qw_p99 * 1e3:.1f} ms is "
                f"{qw_p99 / p99:.0%} of the p99 request latency "
                f"{p99 * 1e3:.1f} ms (threshold "
                f"{th['queue_wait_fraction']:.0%}); the micro-batcher "
                "is the bottleneck — add replicas or raise batch "
                "capacity",
                queue_wait_p99_ms=round(qw_p99 * 1e3, 2),
                request_p99_ms=round(p99 * 1e3, 2),
                fraction=round(qw_p99 / p99, 3))
        # serve_shed_rate: the 429/503 shed fraction over
        # the rolling window.  Both legs come from the registry's
        # windowed counter rates, so one ancient burst of sheds cannot
        # fire the rule forever — and like every rule it latches: one
        # overload incident, one alert.
        shed_n = t.counter("serve.shed")
        served_n = t.counter("serve.requests")
        if shed_n + served_n >= th["serve_shed_min_events"]:
            shed_rate = t.rate("serve.shed", self.window_s)
            req_rate = t.rate("serve.requests", self.window_s)
            total_rate = (shed_rate or 0.0) + (req_rate or 0.0)
            if shed_rate is not None and total_rate > 0:
                frac = shed_rate / total_rate
                if frac > th["serve_shed_fraction"]:
                    self._fire(
                        "serve_shed_rate", "serve",
                        f"{frac:.0%} of scoring requests shed "
                        f"(429/503) over the window (threshold "
                        f"{th['serve_shed_fraction']:.0%}); the "
                        "serving tier is under-provisioned for the "
                        "offered load",
                        shed_fraction=round(frac, 3),
                        shed=shed_n, served=served_n)
        # replica_restarts: ANY replica restart latches —
        # the fleet healed itself, but an operator must know a replica
        # crashed or wedged (severity warn: the request path survived
        # by design).
        restarts = t.counter("fleet.replica_restarts")
        if restarts > 0:
            self._fire(
                "replica_restarts", None,
                f"{restarts} serving replica restart(s): a replica "
                "crashed or wedged and was restarted by the "
                "supervisor (see fleet_replica_* run-log events)",
                restarts=restarts)
        depth = t.gauge_value("sink.queue_depth")
        with self._lock:
            if (depth is not None
                    and depth["last"] >= th["sink_queue_depth"]):
                self._sink_high_streak += 1
            else:
                self._sink_high_streak = 0
            streak = self._sink_high_streak
        if depth is not None and streak >= th["sink_queue_streak"]:
            self._fire("sink_saturation", None,
                       f"sink queue depth {depth['last']:g} for "
                       f"{streak} consecutive snapshots; the output "
                       "sink is the bottleneck",
                       queue_depth=depth["last"])
        mem = t.gauge_value("device.bytes_in_use")
        if mem is not None:
            with self._lock:
                if self._dev_first_bytes is None:
                    self._dev_first_bytes = mem["last"]
                first = self._dev_first_bytes
            grown_mb = (mem["last"] - first) / 1e6
            if (first > 0
                    and mem["last"] > th["memory_growth_ratio"] * first
                    and grown_mb > th["memory_growth_min_mb"]):
                self._fire(
                    "device_memory_growth", None,
                    f"device memory grew {grown_mb:.0f} MB "
                    f"({mem['last'] / max(first, 1):.2f}x) since "
                    "monitoring started; a leak or an unbounded "
                    "residency", first_mb=round(first / 1e6, 1),
                    last_mb=round(mem["last"] / 1e6, 1))

    # -- snapshots for the endpoint / bench ----------------------------------

    def status(self) -> dict:
        """JSON-ready live snapshot: the ``/status`` body."""
        now = self._clock()
        with self._lock:
            stages = {}
            latest = None
            for name, st in self._stages.items():
                stages[name] = {
                    "done": st["done"], "total": st["total"],
                    "unit": st["unit"],
                    "rate": (None if st["rate"] is None
                             else round(st["rate"], 3)),
                    "eta_s": (None if st["eta_s"] is None
                              else round(st["eta_s"], 1)),
                    "age_s": round(now - st["updated"], 3),
                    **{k: v for k, v in st["fields"].items()
                       if isinstance(v, (int, float, str, bool))
                       or v is None},
                }
                if latest is None or st["updated"] > latest[1]:
                    latest = (name, st["updated"])
            out = {
                "phase": self._phases[-1] if self._phases else None,
                "uptime_s": round(now - self.t0, 1),
                "snapshots": self._snapshots,
                "stages": stages,
                "current_stage": latest[0] if latest else None,
                "eta_s": (stages[latest[0]]["eta_s"] if latest else None),
                "alerts": list(self._alerts),
            }
        fl = _fleet_status()
        if fl is not None:
            out["fleet"] = fl
        return out

    def summary(self) -> dict:
        """Run-end summary (the ``monitor_summary`` event body; bench
        arms embed it as their ``progress`` block)."""
        st = self.status()
        return {
            "snapshots": st["snapshots"],
            "stages": st["stages"],
            "alerts": st["alerts"],
        }


def _fleet_status() -> dict | None:
    """This host's slice of the training fleet's view for ``/status``:
    its identity and its reduce and barrier counters.  Every host serves
    its own status endpoint (a dashboard joins them on ``host``; offline,
    ``telemetry fleet-report`` joins the hosts' run logs).  None outside
    a fleet."""
    from photon_ml_torch.parallel import fleet

    ctx = fleet.active()
    if ctx is None or not ctx.is_fleet:
        return None
    t = telemetry.active()
    out = {
        "host": ctx.host_id,
        "n_hosts": ctx.n_hosts,
        "transport": ctx.transport,
    }
    if t is not None:
        out.update({
            "reduces": t.counter("fleet.psums"),
            "chunks_streamed": t.counter("fleet.chunks_streamed"),
            "barrier_wait_s": round(
                float(t.counter("fleet.barrier_wait_s")), 3),
        })
    return out


# ---------------------------------------------------------------------------
# Status endpoint
# ---------------------------------------------------------------------------

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    return "photon_" + _PROM_BAD.sub("_", name)


def _prom_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"')


def prometheus_text(monitor: "Monitor | None" = None,
                    session=None) -> str:
    """Prometheus text exposition (version 0.0.4) of the telemetry
    registry plus the monitor's progress/alert state.  Counters map to
    ``counter``, gauges to ``gauge`` (last value), histograms to
    ``summary`` (quantiles from the bounded reservoir)."""
    t = session if session is not None else telemetry.active()
    lines: list[str] = []
    if t is not None:
        s = t.summary()
        for name, v in s.get("counters", {}).items():
            pn = _prom_name(name + ("_total" if "." in name else ""))
            lines.append(f"# TYPE {pn} counter")
            lines.append(f"{pn} {v}")
        for name, g in s.get("gauges", {}).items():
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} gauge")
            lines.append(f"{pn} {g['last']}")
        stage_family = False
        for name, h in s.get("histograms", {}).items():
            if name.startswith("serve.stage.") and name.endswith("_s"):
                # The request-tracing stage histograms export as ONE
                # labeled family: a dashboard slices
                # photon_serve_stage_seconds{stage="queue_wait"}
                # against its siblings instead of discovering N
                # flat-named series.
                stage = _prom_label(name[len("serve.stage."):-2])
                pn = "photon_serve_stage_seconds"
                if not stage_family:
                    lines.append(f"# TYPE {pn} summary")
                    stage_family = True
                for q, key in ((0.5, "p50"), (0.95, "p95"),
                               (0.99, "p99")):
                    if h.get(key) is not None:
                        lines.append(
                            f'{pn}{{stage="{stage}",quantile="{q}"}} '
                            f'{h[key]}')
                lines.append(f'{pn}_count{{stage="{stage}"}} '
                             f"{h['count']}")
                lines.append(f'{pn}_sum{{stage="{stage}"}} {h["sum"]}')
                continue
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} summary")
            for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                if h.get(key) is not None:
                    lines.append(f'{pn}{{quantile="{q}"}} {h[key]}')
            lines.append(f"{pn}_count {h['count']}")
            lines.append(f"{pn}_sum {h['sum']}")
    if monitor is not None:
        st = monitor.status()
        lines.append("# TYPE photon_monitor_progress_done gauge")
        lines.append("# TYPE photon_monitor_progress_total gauge")
        lines.append("# TYPE photon_monitor_progress_rate gauge")
        for stage, ent in st["stages"].items():
            lbl = f'{{stage="{_prom_label(stage)}"}}'
            lines.append(f"photon_monitor_progress_done{lbl} "
                         f"{ent['done']}")
            if ent["total"] is not None:
                lines.append(f"photon_monitor_progress_total{lbl} "
                             f"{ent['total']}")
            if ent["rate"] is not None:
                lines.append(f"photon_monitor_progress_rate{lbl} "
                             f"{ent['rate']}")
        lines.append("# TYPE photon_monitor_alerts_total counter")
        lines.append(f"photon_monitor_alerts_total {len(st['alerts'])}")
    return "\n".join(lines) + "\n"


def status_routes(monitor: "Monitor") -> dict:
    """The monitor's observer routes for the shared HTTP core —
    ``/status`` (live JSON snapshot) + ``/metrics`` (Prometheus text).
    The model server mounts the same routes next to its ``/v1/score``
    request path, so the two surfaces cannot drift."""
    return {
        ("GET", "/status"): lambda body: (
            200, json.dumps(monitor.status()), "application/json"),
        ("GET", "/metrics"): lambda body: (
            200, prometheus_text(monitor), "text/plain; version=0.0.4"),
    }


class _StatusServer:
    """The opt-in observer endpoint: the shared ``HttpEndpoint`` core
    with the monitor's routes and readiness (``/healthz`` answers 503
    while the run is still warming, 200 once progress flows).  Binds
    127.0.0.1 only; port 0 asks the kernel for an ephemeral port — the
    bound one is in ``.port``."""

    def __init__(self, monitor: Monitor, port: int,
                 host: str = "127.0.0.1"):
        self._ep = HttpEndpoint(status_routes(monitor),
                                readiness=monitor.readiness,
                                port=port, host=host)
        self.port = self._ep.port

    def start(self) -> None:
        self._ep.start()

    def close(self) -> None:
        self._ep.close()


# ---------------------------------------------------------------------------
# Session management (the telemetry start/maybe_session pattern)
# ---------------------------------------------------------------------------


def start(run_logger=None, every_s: float = DEFAULT_EVERY_S,
          status_port: int | None = None, **kw) -> Monitor:
    """Activate the (one per process) live monitor."""
    global _ACTIVE
    m = Monitor(run_logger, every_s=every_s, status_port=status_port,
                **kw)
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            if m._server is not None:
                m._server.close()
            if m._owns_logger:
                m._log.close()
            raise RuntimeError("a monitor session is already active")
        _ACTIVE = m
    m._open()
    return m


@contextlib.contextmanager
def maybe_monitor(enabled: bool, run_logger=None,
                  status_port: int | None = None,
                  every_s: float = DEFAULT_EVERY_S, **kw):
    """Monitor context honoring the config knobs: disabled (and no
    status port — a requested endpoint implies monitoring) or an
    already-active monitor (the driver configured one) yields without
    creating anything; otherwise a monitor spans the block."""
    if (not enabled and status_port is None) or _ACTIVE is not None:
        yield _ACTIVE
        return
    m = start(run_logger, every_s=every_s, status_port=status_port, **kw)
    try:
        yield m
    finally:
        m.close()
