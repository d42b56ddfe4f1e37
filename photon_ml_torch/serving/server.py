"""ModelServer: the persistent online scoring process.

Counterpart of ``photon_ml_tpu/serving/server.py``.  Lifecycle:

1. **Bind first**: the HTTP endpoint is up at construction, answering
   ``/healthz`` 503 ``warming``.
2. **Load** the model (``io.model_io.load_game_model``: manifest first,
   legacy layout second) and build the ``ScoringEngine`` on the
   configured device.
3. **Warm** every micro-batch bucket, then flip to ready.
4. **Serve** ``POST /v1/score`` → parse → micro-batch → one fused call;
   ``GET /status`` reports state, model, batcher, the monitor's status,
   the tracer's snapshot and the per-stage latency table, and
   ``GET /metrics`` the Prometheus text of the telemetry registry.
5. **Hot swap**: a watcher polls the manifest signature; a newly
   published manifest is loaded and warmed off the request path, then
   swapped in between batches.  A corrupt manifest keeps the previous
   good model and counts a swap failure.

The tiers follow the config (``telemetry``, ``monitor``, ``trace``; the
reference's defaults turn all three on): the server starts each one
that no caller has started already and closes the ones it started.
``_load_engine`` fires the ``serve.manifest_load`` fault seam with the
manifest's path.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

from photon_ml_torch import telemetry
from photon_ml_torch.config import ServingConfig
from photon_ml_torch.io.model_io import load_game_model, model_manifest_path
from photon_ml_torch.reliability import faults
from photon_ml_torch.serving import tracing
from photon_ml_torch.serving.batcher import (
    DeadlineExceeded,
    MicroBatcher,
    ServerClosing,
    ServerOverloaded,
    ServerSaturated,
)
from photon_ml_torch.serving.engine import BadRequest, ScoringEngine
from photon_ml_torch.serving.http import (
    READY,
    STOPPING,
    WARMING,
    HttpEndpoint,
    HttpError,
    Readiness,
)

logger = logging.getLogger(__name__)


def _manifest_signature(model_dir: str) -> tuple | None:
    """(path, mtime_ns, size) of the manifest, else of the legacy
    metadata.json; None when neither exists."""
    for path in (model_manifest_path(model_dir),
                 os.path.join(model_dir, "metadata.json")):
        try:
            st = os.stat(path)
            return (path, st.st_mtime_ns, st.st_size)
        except OSError:  # photon-lint: disable=swallowed-exception (an absent candidate means "try the next layout"; a fully absent model dir returns None and the caller raises with context)
            continue
    return None


def _peak_rss_mb() -> float | None:
    try:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return ru / 1024.0 if os.uname().sysname == "Linux" \
            else ru / (1024.0 * 1024.0)
    except Exception:  # photon-lint: disable=swallowed-exception (RSS is advisory status info; platforms without rusage report null)
        return None


class ModelServer:
    """The serving process.  ``start()`` loads, warms and flips ready;
    ``serve_forever()`` blocks until ``stop()`` (or SIGTERM via
    ``__main__``)."""

    def __init__(self, config: ServingConfig, run_logger=None):
        config.validate()
        self.config = config
        self._log = run_logger
        self._lock = threading.Lock()
        self._engine: ScoringEngine | None = None
        self._engine_sig: tuple | None = None
        self.readiness = Readiness(
            WARMING, reason="model load + bucket warm-up in progress")
        self._batcher: MicroBatcher | None = None
        self._watcher: threading.Thread | None = None
        # _stop_evt wakes serve_forever()/the watcher; _stopped is
        # stop()'s own idempotency latch.
        self._stop_evt = threading.Event()
        self._stopped = False
        self._monitor = None
        self._telemetry = None
        self._tracer = None
        self.swaps = 0
        self.swap_failures = 0
        self.last_swap_error: str | None = None
        self.t0 = time.monotonic()
        self._http = HttpEndpoint(self._routes(), readiness=self.readiness,
                                  port=config.port, host=config.host,
                                  request_timeout_s=config.http_timeout_s)
        self._http.start()
        self.port = self._http.port

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ModelServer":
        from photon_ml_torch.cache import enable_compilation_cache
        from photon_ml_torch.telemetry import monitor as _mon

        cfg = self.config
        enable_compilation_cache(cfg.compilation_cache_dir)
        logger.info("model server bound on http://%s:%d (warming)",
                    cfg.host, self.port)
        if cfg.telemetry != "off" and telemetry.active() is None:
            self._telemetry = telemetry.start(
                cfg.telemetry, run_logger=self._log, device=cfg.device)
        if cfg.monitor == "on" and _mon.active() is None:
            self._monitor = _mon.start(
                run_logger=self._log, every_s=cfg.monitor_every_s)
        if cfg.trace == "on" and tracing.active() is None:
            self._tracer = tracing.start(
                role="replica",
                threshold_s=cfg.trace_threshold_ms / 1e3,
                sample_every=cfg.trace_sample_every,
                cap=cfg.trace_buffer, run_logger=self._log)
        try:
            engine = self._load_engine()
            engine.warm(cfg.buckets())
            with self._lock:
                self._engine = engine
                self._engine_sig = _manifest_signature(cfg.model_dir)
            self._batcher = MicroBatcher(
                self._current_engine, cfg.buckets(),
                deadline_s=cfg.batch_deadline_ms / 1e3,
                max_queue=cfg.max_queue)
        except BaseException:
            self.readiness.set(STOPPING, reason="startup failed")
            raise
        self.readiness.set(READY)
        if self._monitor is not None:
            self._monitor.mark_ready()
        self._event("serving_ready", port=self.port,
                    model_version=engine.version, buckets=cfg.buckets(),
                    device=str(engine.device))
        logger.info("model server READY on http://%s:%d (model %s, "
                    "buckets %s, device %s)", cfg.host, self.port,
                    engine.version, cfg.buckets(), engine.device)
        if cfg.hot_swap_poll_s > 0:
            self._watcher = threading.Thread(
                target=self._watch, daemon=True,
                name="photon-serve-swap-watcher")
            self._watcher.start()
        return self

    def serve_forever(self) -> None:
        # photon-lint: disable=eternal-wait (the main thread parks until stop() or the CLI signal handler sets the event; there is nothing to time out toward)
        self._stop_evt.wait()

    def stop(self) -> None:
        """Graceful drain: refuse new work, score the queue, stop the
        watcher and endpoint.  Idempotent."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
        self.readiness.set(STOPPING, reason="draining")
        self._stop_evt.set()
        if self._watcher is not None:
            self._watcher.join(timeout=10.0)
        if self._batcher is not None:
            self._batcher.close()
        self._http.close()
        with self._lock:
            engine, self._engine = self._engine, None
        if engine is not None:
            engine.close()
        for session in (self._tracer, self._monitor, self._telemetry):
            if session is not None:
                session.close()
        self._event("serving_stopped", swaps=self.swaps,
                    swap_failures=self.swap_failures)

    def _event(self, kind: str, **fields) -> None:
        if self._log is not None:
            self._log.event(kind, **fields)

    # -- model load / hot swap ----------------------------------------------

    def _load_engine(self) -> ScoringEngine:
        cfg = self.config
        sig = _manifest_signature(cfg.model_dir)
        if sig is None:
            raise FileNotFoundError(
                f"no model manifest or metadata.json under "
                f"{cfg.model_dir!r}")
        version = f"{sig[1]:x}-{sig[2]:x}"
        t0 = time.perf_counter()
        # corrupt_file/delete_file faults hit the real manifest, so the
        # keep-the-previous-model path is injectable.
        faults.fire("serve.manifest_load", path=sig[0])
        with telemetry.span("serve_model_load", cat="serve"):
            model, task = load_game_model(cfg.model_dir)
            engine = ScoringEngine(
                model, task, version=version,
                ell_row_capacity=cfg.ell_row_capacity,
                dense_feature_shards=tuple(cfg.dense_feature_shards),
                spill_dir=cfg.spill_dir, entity_chunk=cfg.entity_chunk,
                host_max_resident=cfg.host_max_resident,
                device=cfg.device)
        logger.info("loaded model %s from %s in %.2fs", version,
                    cfg.model_dir, time.perf_counter() - t0)
        return engine

    def _current_engine(self) -> ScoringEngine:
        with self._lock:
            engine = self._engine
        if engine is None:
            raise ServerClosing("no engine (server stopping)")
        return engine

    def _watch(self) -> None:
        """Poll the manifest signature; load + warm a changed model off
        the request path, then swap atomically."""
        cfg = self.config
        while not self._stop_evt.wait(cfg.hot_swap_poll_s):
            sig = None
            try:
                sig = _manifest_signature(cfg.model_dir)
                with self._lock:
                    current = self._engine_sig
                if sig is None or sig == current:
                    continue
                self._event("serving_swap_detected", signature=list(sig))
                engine = self._load_engine()
                engine.warm(cfg.buckets())
                with self._lock:
                    old, self._engine = self._engine, engine
                    self._engine_sig = sig
                    self.swaps += 1
                    self.last_swap_error = None
                telemetry.count("serve.swaps")
                # The single dispatcher thread means at most one batch
                # still runs on the old engine; retiring drops only its
                # entity-store windows.
                if old is not None:
                    old.close()
                self._event("serving_swapped", model_version=engine.version)
                logger.info("hot-swapped to model %s", engine.version)
            except Exception as e:
                # A bad manifest must never take the server down: keep
                # the previous good model and remember the bad signature
                # so one corrupt file logs one failure.
                with self._lock:
                    self.swap_failures += 1
                    self.last_swap_error = f"{type(e).__name__}: {e}"
                    self._engine_sig = sig
                telemetry.count("serve.swap_failures")
                self._event("serving_swap_failed",
                            error=self.last_swap_error)
                logger.warning("hot swap failed (%s); keeping model %s",
                               self.last_swap_error,
                               self._current_engine().version)

    # -- HTTP surface --------------------------------------------------------

    def _routes(self) -> dict:
        return {
            ("POST", "/v1/score"): self._route_score,
            ("GET", "/status"): self._route_status,
            ("GET", "/metrics"): self._route_metrics,
        }

    def _route_score(self, body: bytes):
        # The request trace begins here; the HTTP core finishes it after
        # the response write, sheds and errors included.
        t0 = time.perf_counter()
        rt = tracing.begin()
        if self.readiness.state != READY:
            state, reason = self.readiness.snapshot()
            raise HttpError(503, error=f"server is {state}",
                            **({"reason": reason} if reason else {}))
        try:
            payload = json.loads(body) if body else None
        except json.JSONDecodeError as e:
            raise HttpError(400, error=f"malformed JSON body: {e}")
        if not isinstance(payload, dict) or "rows" not in payload:
            raise HttpError(400, error="body must be a JSON object "
                                       "with a 'rows' list")
        engine = self._current_engine()
        try:
            parsed = engine.parse_rows(payload["rows"])
        except BadRequest as e:
            raise HttpError(400, error=str(e))
        try:
            margins, preds, version, degraded = self._batcher.submit(
                parsed, timeout_s=self.config.request_timeout_s,
                trace=rt, t_admit=t0)
        except ServerSaturated as e:
            raise HttpError(429, error=str(e), headers={
                "Retry-After": f"{e.retry_after_s:.0f}"})
        except (ServerOverloaded, DeadlineExceeded) as e:
            if rt is not None and rt.shed is None:
                rt.shed = "deadline"
            raise HttpError(503, error=str(e), headers={
                "Retry-After": f"{e.retry_after_s:.0f}"})
        except (ServerClosing, TimeoutError) as e:
            raise HttpError(503, error=str(e))
        if degraded:
            telemetry.count("serve.degraded_responses")
        t_ser = 0.0 if rt is None else time.perf_counter()
        out = {"margins": [float(v) for v in margins],
               "predictions": [float(v) for v in preds],
               "model_version": version,
               "n": int(len(margins)),
               **({"degraded": True} if degraded else {})}
        payload = json.dumps(out)
        if rt is not None:
            rt.stamp("serialize", time.perf_counter() - t_ser)
            rt.rows = int(len(margins))
            rt.degraded = bool(degraded)
        return 200, payload, "application/json"

    def serving_status(self) -> dict:
        with self._lock:
            engine = self._engine
            swaps, failures = self.swaps, self.swap_failures
            last_err = self.last_swap_error
        rec = tracing.active()
        stages = tracing.stage_summary()
        return {
            "state": self.readiness.state,
            "uptime_s": round(time.monotonic() - self.t0, 1),
            "model": engine.describe() if engine is not None else None,
            "batcher": (self._batcher.stats()
                        if self._batcher is not None else None),
            "swaps": swaps,
            "swap_failures": failures,
            **({"last_swap_error": last_err} if last_err else {}),
            **({"tracing": rec.snapshot()} if rec is not None else {}),
            **({"stages": stages} if stages else {}),
            "peak_rss_mb": _peak_rss_mb(),
        }

    def _route_status(self, body: bytes):
        st = {"serving": self.serving_status()}
        if self._monitor is not None:
            st.update(self._monitor.status())
        return 200, json.dumps(st), "application/json"

    def _route_metrics(self, body: bytes):
        from photon_ml_torch.telemetry.monitor import prometheus_text

        return 200, prometheus_text(self._monitor), \
            "text/plain; version=0.0.4"
