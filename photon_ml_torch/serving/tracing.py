"""End-to-end request tracing across the serving path.

Counterpart of ``photon_ml_tpu/serving/tracing.py``, with the same
headers, stage names, sampling rules and JSONL event schema, so a trace
log written by either package loads in the other's ``serve-report``.

- **Trace context**: a trace id + hop count minted here (or adopted
  from a client ``X-Photon-Trace: <id>/<hop>`` header, else a bare
  ``X-Photon-Request-Id``) and echoed on EVERY response, sheds and
  errors included, so a client can correlate any outcome with
  ``/status`` and the run log.
- **Per-request stage marks**: each request records monotonic stage
  durations (``admission``, ``queue_wait``, ``serialize``, ``write``);
  the SHARED micro-batch work (``assemble``, ``store_lookup``,
  ``dispatch``, ``d2h``) is recorded ONCE as a batch trace that member
  requests link to by batch id.  On CUDA, ``dispatch`` is the copy of
  the batch to the card plus the kernels' launch (asynchronous), and
  ``d2h`` is the one blocking copy back, so the kernels' device time
  lands in ``d2h``, not in ``dispatch``.
- **Tail-based sampling**: a request slower than ``threshold_s`` (or
  every ``sample_every``-th request, a deterministic floor) is kept in a
  bounded ring and written as a ``request_trace`` event (its batch once
  as a ``batch_trace`` event).  Every request folds its stages into the
  ``serve.stage.<stage>_s`` histograms, the
  ``photon_serve_stage_seconds{stage=...}`` family on ``/metrics``.
- **Join**: ``python -m photon_ml_torch.telemetry serve-report`` joins
  the logs by trace id into the latency-decomposition table.

Tracing off takes no timestamp; tracing on costs a few
``perf_counter`` calls and histogram folds a request and no device
synchronization.  ``wall_t`` (one ``time.time()`` at request start,
never subtracted) only anchors timelines across processes.

Stdlib only at import time: ``serving.http`` imports this module and
``telemetry.monitor`` imports ``serving.http``, so the telemetry
package is reached lazily inside functions.
"""

from __future__ import annotations

import collections
import itertools
import logging
import os
import re
import threading
import time

logger = logging.getLogger(__name__)

TRACE_HEADER = "X-Photon-Trace"
REQUEST_ID_HEADER = "X-Photon-Request-Id"

# Client-supplied ids are echoed into headers and logs: accept only a
# conservative token alphabet, mint otherwise.
_ID_RE = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")

# Stage vocabulary (the serve-report table's row order).  Request
# stages are recorded per request, batch stages once per micro-batch,
# frontend stages by a fleet frontend.
REQUEST_STAGES = ("admission", "queue_wait", "serialize", "write")
BATCH_STAGES = ("assemble", "store_lookup", "dispatch", "d2h")
FRONTEND_STAGES = ("route", "forward", "retry")
ALL_STAGES = FRONTEND_STAGES + REQUEST_STAGES + BATCH_STAGES

# Batches whose members were all dropped by sampling age out of this
# pending window (a batch must outlive its members' finish: the write
# stage lands after the batch completes).
_PENDING_BATCH_CAP = 256


def _telemetry():
    """Lazy handle on the telemetry package (see the module docstring)."""
    from photon_ml_torch import telemetry

    return telemetry


# stage -> "serve.stage.<stage>_s", interned once.
_STAGE_METRIC: dict[str, str] = {}


def _stage_metric(stage: str) -> str:
    name = _STAGE_METRIC.get(stage)
    if name is None:
        name = _STAGE_METRIC[stage] = f"serve.stage.{stage}_s"
    return name


class TraceContext:
    """The propagated identity: trace id + hop count.  Hop 0 is the
    process that minted the id; each forward increments."""

    __slots__ = ("trace_id", "hop")

    def __init__(self, trace_id: str, hop: int = 0):
        self.trace_id = trace_id
        self.hop = int(hop)

    def header_value(self) -> str:
        return f"{self.trace_id}/{self.hop}"

    def child_header(self) -> str:
        """The value forwarded downstream (one more hop)."""
        return f"{self.trace_id}/{self.hop + 1}"


# Minted ids: a per-process random prefix + a counter (unique across
# processes and within one, without a syscall per request).
_MINT_PREFIX = os.urandom(6).hex()
_MINT_SEQ = itertools.count()


def mint() -> TraceContext:
    return TraceContext(f"{_MINT_PREFIX}{next(_MINT_SEQ) & 0xFFFFFFFF:08x}",
                        0)


def parse_trace_header(value: str | None) -> TraceContext | None:
    """``X-Photon-Trace: <id>/<hop>`` → context, or None on anything
    malformed (the caller mints instead; a bad header never 400s)."""
    if not value:
        return None
    trace_id, sep, hop = value.partition("/")
    if not _ID_RE.match(trace_id):
        return None
    if not sep:
        return TraceContext(trace_id, 0)
    try:
        return TraceContext(trace_id, max(0, int(hop)))
    except ValueError:  # photon-lint: disable=swallowed-exception (a malformed client hop means "no adoptable context"; the caller mints a fresh one — logging each hostile header would be a log-spam vector)
        return None


def from_headers(headers) -> TraceContext:
    """Adopt the request's trace context: ``X-Photon-Trace`` first, a
    bare ``X-Photon-Request-Id`` second, else mint."""
    ctx = parse_trace_header(headers.get(TRACE_HEADER))
    if ctx is not None:
        return ctx
    rid = headers.get(REQUEST_ID_HEADER)
    if rid and _ID_RE.match(rid):
        return TraceContext(rid, 0)
    return mint()


# ---------------------------------------------------------------------------
# Per-handler-thread request state (set by the HTTP core, read by the
# routes; a request runs start to finish on one thread).
# ---------------------------------------------------------------------------

_LOCAL = threading.local()


def set_context(ctx: TraceContext) -> None:
    _LOCAL.ctx = ctx


def context() -> TraceContext | None:
    return getattr(_LOCAL, "ctx", None)


def attach(rt: "RequestTrace") -> None:
    """Hand the live request trace to the HTTP core: it stamps the
    response write and finishes the trace after the bytes go out, on
    every outcome."""
    _LOCAL.rt = rt


def take_attached() -> "RequestTrace | None":
    rt = getattr(_LOCAL, "rt", None)
    _LOCAL.rt = None
    return rt


def clear() -> None:
    _LOCAL.ctx = None
    _LOCAL.rt = None


class RequestTrace:
    """One request's stage record.  ``stages``: stage → seconds;
    ``batch`` links the shared micro-batch trace; ``attempts`` holds a
    frontend's forward attempts."""

    __slots__ = ("trace_id", "hop", "role", "wall_t", "t0", "stages",
                 "batch", "status", "rows", "attempts", "shed",
                 "degraded", "total_s", "sampled")

    def __init__(self, ctx: TraceContext, role: str):
        self.trace_id = ctx.trace_id
        self.hop = ctx.hop
        self.role = role
        self.wall_t = time.time()      # timeline anchor, never subtracted
        self.t0 = time.perf_counter()
        self.stages: dict[str, float] = {}
        self.batch: str | None = None
        self.status: int | None = None
        self.rows = 0
        self.attempts: list[dict] = []
        self.shed: str | None = None
        self.degraded = False
        self.total_s: float | None = None
        self.sampled: str | None = None

    def stamp(self, stage: str, dur_s: float) -> None:
        self.stages[stage] = self.stages.get(stage, 0.0) + float(dur_s)


class BatchTrace:
    """One micro-batch's shared stages, recorded once however many of
    its member requests are kept."""

    __slots__ = ("batch_id", "wall_t", "t0", "bucket", "rows",
                 "requests", "stages", "total_s", "emitted")

    def __init__(self, batch_id: str, bucket: int, rows: int,
                 requests: int):
        self.batch_id = batch_id
        self.wall_t = time.time()
        self.t0 = time.perf_counter()
        self.bucket = bucket
        self.rows = rows
        self.requests = requests
        self.stages: dict[str, float] = {}
        self.total_s: float | None = None
        self.emitted = False

    def stamp(self, stage: str, dur_s: float) -> None:
        self.stages[stage] = self.stages.get(stage, 0.0) + float(dur_s)


class TraceRecorder:
    """The process's tracing session (one at a time, through
    ``start()``).

    A finished request is kept when its latency is at least
    ``threshold_s`` (tail) or its sequence number hits the
    ``sample_every`` floor; kept requests go to a bounded ring
    (``cap``) and to ``run_logger`` as ``request_trace`` events, the
    linked batch once as ``batch_trace``.  Dropped requests still fold
    into the ``serve.stage.<stage>_s`` histograms."""

    def __init__(self, role: str = "replica", threshold_s: float = 0.05,
                 sample_every: int = 100, cap: int = 512,
                 run_logger=None, owns_logger: bool = False):
        if threshold_s < 0:
            raise ValueError(f"threshold_s must be >= 0, got "
                             f"{threshold_s!r}")
        if sample_every < 0:
            raise ValueError(f"sample_every must be >= 0 (0 = no "
                             f"floor), got {sample_every!r}")
        if cap < 1:
            raise ValueError(f"cap must be >= 1, got {cap!r}")
        self.role = role
        self.threshold_s = float(threshold_s)
        self.sample_every = int(sample_every)
        self.cap = int(cap)
        self._log = run_logger
        self._owns_logger = owns_logger
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=cap)
        self._batch_ring: collections.deque = collections.deque(
            maxlen=cap)
        self._pending: collections.OrderedDict = collections.OrderedDict()
        self._req_seq = 0
        self._batch_seq = 0
        # A per-recorder random prefix: a restarted server appending to
        # the same log restarts the sequence, and bare integers would
        # join a request to another incarnation's batch.
        self._bid_prefix = os.urandom(4).hex()
        self.requests = 0
        self.sampled_tail = 0
        self.sampled_floor = 0
        self.batches = 0
        self._closed = False

    # -- request side --------------------------------------------------------

    def begin(self) -> RequestTrace:
        """A request trace on the current thread's context (minted when
        the HTTP core set none), attached for the core's finish."""
        ctx = context() or mint()
        rt = RequestTrace(ctx, self.role)
        attach(rt)
        return rt

    def finish(self, rt: RequestTrace, status: int | None = None) -> None:
        rt.total_s = time.perf_counter() - rt.t0
        if status is not None and rt.status is None:
            rt.status = status
        tel = _telemetry().active()
        if tel is not None:
            # Histogram folds only: the recorder's own ``requests``
            # tally is the request count of record.
            for stage, dur in rt.stages.items():
                tel.observe(_stage_metric(stage), dur)
        sampled = "tail" if rt.total_s >= self.threshold_s else None
        emit_batch = None
        with self._lock:
            if self._closed:
                return
            self.requests += 1
            seq = self._req_seq
            self._req_seq += 1
            if (sampled is None and self.sample_every
                    and seq % self.sample_every == 0):
                sampled = "floor"
            if sampled is None:
                return
            rt.sampled = sampled
            if sampled == "tail":
                self.sampled_tail += 1
            else:
                self.sampled_floor += 1
            self._ring.append(rt)
            if rt.batch is not None:
                bt = self._pending.get(rt.batch)
                if bt is not None and not bt.emitted:
                    # Emitted once, when its first kept member links it.
                    bt.emitted = True
                    self._batch_ring.append(bt)
                    emit_batch = bt
        if tel is not None:
            tel.count("serve.trace.sampled")
        if emit_batch is not None:
            self._log_batch(emit_batch)
        self._log_request(rt)

    # -- batch side ----------------------------------------------------------

    def begin_batch(self, bucket: int, rows: int, requests: int
                    ) -> BatchTrace:
        with self._lock:
            seq = self._batch_seq
            self._batch_seq += 1
        return BatchTrace(f"{self._bid_prefix}.{seq}", bucket, rows,
                          requests)

    def finish_batch(self, bt: BatchTrace) -> None:
        bt.total_s = time.perf_counter() - bt.t0
        tel = _telemetry().active()
        if tel is not None:
            for stage, dur in bt.stages.items():
                tel.observe(_stage_metric(stage), dur)
        with self._lock:
            if self._closed:
                return
            self.batches += 1
            self._pending[bt.batch_id] = bt
            while len(self._pending) > _PENDING_BATCH_CAP:
                self._pending.popitem(last=False)

    # -- export / lifecycle --------------------------------------------------

    def _log_request(self, rt: RequestTrace) -> None:
        if self._log is None:
            return
        self._log.event(
            "request_trace", trace=rt.trace_id, hop=rt.hop,
            role=rt.role, wall_t=round(rt.wall_t, 6),
            total_ms=round((rt.total_s or 0.0) * 1e3, 3),
            stages_ms={k: round(v * 1e3, 3)
                       for k, v in rt.stages.items()},
            sampled=rt.sampled,
            **({"batch": rt.batch} if rt.batch is not None else {}),
            **({"status": rt.status} if rt.status is not None else {}),
            **({"rows": rt.rows} if rt.rows else {}),
            **({"attempts": rt.attempts} if rt.attempts else {}),
            **({"shed": rt.shed} if rt.shed else {}),
            **({"degraded": True} if rt.degraded else {}))

    def _log_batch(self, bt: BatchTrace) -> None:
        if self._log is None:
            return
        self._log.event(
            "batch_trace", batch=bt.batch_id,
            wall_t=round(bt.wall_t, 6),
            total_ms=round((bt.total_s or 0.0) * 1e3, 3),
            bucket=bt.bucket, rows=bt.rows, requests=bt.requests,
            stages_ms={k: round(v * 1e3, 3)
                       for k, v in bt.stages.items()})

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "role": self.role,
                "requests": self.requests,
                "sampled_tail": self.sampled_tail,
                "sampled_floor": self.sampled_floor,
                "batches": self.batches,
                "buffered": len(self._ring),
                "threshold_ms": round(self.threshold_s * 1e3, 3),
                "sample_every": self.sample_every,
            }

    def retained(self) -> list[RequestTrace]:
        """The ring's current contents."""
        with self._lock:
            return list(self._ring)

    def close(self) -> None:
        """Emit the summary event and deactivate.  Idempotent."""
        global _ACTIVE
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self._log is not None:
            self._log.event("serve_trace_summary", **self.snapshot())
        if self._owns_logger:
            self._log.close()
        with _ACTIVE_LOCK:
            if _ACTIVE is self:
                _ACTIVE = None


_ACTIVE: TraceRecorder | None = None
_ACTIVE_LOCK = threading.Lock()


def active() -> TraceRecorder | None:
    return _ACTIVE


def start(role: str = "replica", threshold_s: float = 0.05,
          sample_every: int = 100, cap: int = 512,
          run_logger=None) -> TraceRecorder:
    """Activate the process's trace recorder."""
    global _ACTIVE
    owns = False
    if run_logger is None:
        from photon_ml_torch.utils.run_log import RunLogger

        run_logger = RunLogger(None)
        owns = True
    rec = TraceRecorder(role, threshold_s=threshold_s,
                        sample_every=sample_every, cap=cap,
                        run_logger=run_logger, owns_logger=owns)
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            if owns:
                run_logger.close()
            raise RuntimeError("a trace recorder is already active")
        _ACTIVE = rec
    return rec


def begin() -> RequestTrace | None:
    """Module-level request begin: None when tracing is off (one
    global read)."""
    rec = _ACTIVE
    if rec is None:
        return None
    return rec.begin()


def finish(rt: RequestTrace | None, status: int | None = None) -> None:
    rec = _ACTIVE
    if rec is not None and rt is not None:
        rec.finish(rt, status=status)


def stage_summary(session=None) -> dict | None:
    """Per-stage latency table ``{stage: {count, p50_ms, p99_ms}}`` from
    the session's ``serve.stage.<stage>_s`` histograms (the ``/status``
    stages block and the monitor's dominant-stage input).  Reads only
    the prefixed histograms, so a ``/status`` poll does not sort every
    reservoir while request threads wait on the registry lock."""
    tel = _telemetry()
    t = session if session is not None else tel.active()
    if t is None:
        return None
    out = {}
    for name, h in t.histogram_quantiles(
            "serve.stage.", (0.50, 0.99)).items():
        if not name.endswith("_s"):
            continue
        stage = name[len("serve.stage."):-2]
        q50, q99 = h["quantiles"]
        out[stage] = {
            "count": h["count"],
            "p50_ms": None if q50 is None else round(q50 * 1e3, 3),
            "p99_ms": None if q99 is None else round(q99 * 1e3, 3),
        }
    return out or None


def dominant_stage(summary: dict | None) -> tuple[str, float] | None:
    """(stage, p99_ms) with the largest p99; None without stage
    histograms (tracing off)."""
    if not summary:
        return None
    best = None
    for stage, ent in summary.items():
        p99 = ent.get("p99_ms")
        if p99 is not None and (best is None or p99 > best[1]):
            best = (stage, p99)
    return best
