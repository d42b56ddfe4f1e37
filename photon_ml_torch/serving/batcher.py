"""Deadline-based micro-batcher: concurrent requests → fused batches.

Counterpart of ``photon_ml_tpu/serving/batcher.py``.  Concurrent
requests COALESCE: the
dispatcher thread collects queued requests until the largest bucket
fills or the oldest request has waited ``deadline_s``, then scores them
as ONE padded call.  Batches pad to the closed ``buckets`` set; a
request larger than the biggest bucket splits across several batches
and reassembles here.

Overload: ``submit`` estimates the queue wait from the queued rows and
the rolling (EWMA) batch service time and sheds a request that could
not meet its deadline (``ServerOverloaded``, HTTP 503); a full queue
sheds with ``ServerSaturated`` (429); a queued request whose deadline
passed before dispatch fails with ``DeadlineExceeded`` (503) instead of
spending device time.

Hot swap: the batcher holds no model state — each batch resolves the
current engine through ``engine_fn``, so a swap lands between batches.

Instrumentation: the ``serve.*`` counters (``requests``, ``batches``,
``batch_rows``, ``shed`` and ``shed_<cause>``), the ``serve.queue_depth``
gauge and the ``serve.request_s``, ``serve.batch_s`` and
``serve.batch_fill`` histograms go to the telemetry session; a failed
batch is a ``thread_exception`` event; each batch reports
``monitor.progress("serve", rows)``, where the monitor evaluates its
alert rules.  With request tracing on, each dispatch is one
``BatchTrace`` and each request slot's ``queue_wait`` is taken against
the dispatch moment.  Every hook is one global read when its tier is
off.
"""

from __future__ import annotations

import logging
import math
import queue
import threading
import time

import numpy as np

from photon_ml_torch import telemetry
from photon_ml_torch.serving import tracing
from photon_ml_torch.telemetry import monitor as _mon

logger = logging.getLogger(__name__)

# EWMA weight for the rolling batch service time (admission estimate).
_SERVICE_EWMA = 0.2


class ServerClosing(RuntimeError):
    """Submitted while the server is draining (HTTP 503)."""


class _Shed(RuntimeError):
    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class ServerSaturated(_Shed):
    """The request queue is full (HTTP 429)."""


class ServerOverloaded(_Shed):
    """Admission control: the estimated queue wait exceeds the
    request's deadline (HTTP 503 + Retry-After)."""


class DeadlineExceeded(_Shed):
    """The request's deadline passed while it was queued (HTTP 503)."""


class _Slot:
    """One request piece's result hand-off (condition-guarded)."""

    __slots__ = ("rows", "n", "deadline", "_cv", "_done", "result",
                 "error", "version", "degraded", "t_enq", "queue_wait",
                 "batch")

    def __init__(self, rows, n: int, deadline: float = math.inf):
        self.rows = rows
        self.n = n
        self.deadline = deadline
        self._cv = threading.Condition()
        self._done = False
        self.result = None
        self.error: BaseException | None = None
        self.version: str | None = None
        self.degraded = False
        self.t_enq = time.perf_counter()   # queue-wait basis (tracing)
        self.queue_wait: float | None = None
        self.batch: str | None = None      # linked BatchTrace id

    def finish(self, result=None, error=None, version=None,
               degraded: bool = False) -> None:
        with self._cv:
            self.result = result
            self.error = error
            self.version = version
            self.degraded = degraded
            self._done = True
            self._cv.notify_all()

    def wait(self, timeout: float):
        with self._cv:
            if not self._cv.wait_for(lambda: self._done, timeout):
                raise TimeoutError(
                    f"scoring request timed out after {timeout:g}s "
                    "(server overloaded or wedged)")
        if self.error is not None:
            raise self.error
        return self.result, self.version, self.degraded


class MicroBatcher:
    """The dispatcher thread + request queue.  ``engine_fn()`` returns
    the CURRENT engine (resolved once per batch)."""

    _SENTINEL = object()

    def __init__(self, engine_fn, buckets: list[int],
                 deadline_s: float = 0.002, max_queue: int = 1024,
                 clock=time.monotonic):
        if not buckets or sorted(buckets) != list(buckets):
            raise ValueError("buckets must be non-empty ascending")
        self._engine_fn = engine_fn
        self.buckets = [int(b) for b in buckets]
        self.max_rows = self.buckets[-1]
        self.deadline_s = float(deadline_s)
        self._clock = clock
        # Unbounded queue: max_queue is enforced in submit() under the
        # lock, so submit() and close() can enqueue while holding it and
        # no slot can land behind the drain sentinel.
        self._q: queue.Queue = queue.Queue()
        self.max_queue = int(max_queue)
        self._lock = threading.Lock()
        self._closing = False
        self.batches = 0
        self.rows = 0
        self.padded_rows = 0
        self.shed = 0
        self._queued_rows = 0
        self._service_ewma_s: float | None = None
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="photon-serve-batcher")
        self._thread.start()

    # -- client side ---------------------------------------------------------

    def _estimated_wait_s(self, extra_rows: int) -> float | None:
        """Estimated queue delay for a request enqueued now; None while
        no batch has been timed.  Caller holds the lock."""
        if self._service_ewma_s is None:
            return None
        batches_ahead = math.ceil(
            (self._queued_rows + extra_rows) / self.max_rows)
        return batches_ahead * self._service_ewma_s

    def _shed(self, cause: str) -> None:
        with self._lock:
            self.shed += 1
        telemetry.count("serve.shed")
        telemetry.count(f"serve.shed_{cause}")

    def submit(self, parsed_rows: list, timeout_s: float = 30.0,
               trace=None, t_admit: float | None = None):
        """Block until scored → (margins [n], preds [n], version,
        degraded).  Called from HTTP handler threads.

        ``trace``: the request's ``RequestTrace``.  ``admission`` (from
        ``t_admit``, the route's entry clock, so the parse counts) and
        ``queue_wait`` stamp onto it, and the batch it waited on links
        it to that batch's trace."""
        t0 = time.perf_counter()
        deadline = self._clock() + timeout_s
        slots = []
        shed_exc: Exception | None = None
        shed_cause = None
        with self._lock:
            if self._closing:
                raise ServerClosing("server is draining")
            est = self._estimated_wait_s(len(parsed_rows))
            if est is not None and est > timeout_s:
                self.shed += 1
                shed_exc = ServerOverloaded(
                    f"estimated queue wait {est:.2f}s exceeds the "
                    f"request deadline budget {timeout_s:g}s; retry "
                    "after backoff or raise capacity",
                    retry_after_s=max(1.0, est - timeout_s))
                shed_cause = "overload"
            else:
                for lo in range(0, len(parsed_rows), self.max_rows):
                    piece = parsed_rows[lo: lo + self.max_rows]
                    if self._q.qsize() >= self.max_queue:
                        self.shed += 1
                        shed_exc = ServerSaturated(
                            f"request queue full ({self.max_queue}); "
                            "shed load or raise max_queue",
                            retry_after_s=max(1.0, est or 1.0))
                        shed_cause = "saturated"
                        break
                    slot = _Slot(piece, len(piece), deadline=deadline)
                    self._q.put(slot)
                    self._queued_rows += len(piece)
                    slots.append(slot)
        if trace is not None:
            trace.stamp("admission", time.perf_counter()
                        - (t_admit if t_admit is not None else t0))
        if shed_exc is not None:
            if trace is not None:
                trace.shed = shed_cause
            telemetry.count("serve.shed")
            telemetry.count(f"serve.shed_{shed_cause}")
            raise shed_exc
        telemetry.gauge("serve.queue_depth", self._q.qsize())
        margins, preds, version = [], [], None
        degraded = False
        for slot in slots:
            (m, p), version, deg = slot.wait(timeout_s)
            degraded = degraded or deg
            margins.append(m)
            preds.append(p)
        if trace is not None:
            # A request split over several batches links the one it
            # waited on longest, so the stamp and the link agree.
            slowest = max(
                (s for s in slots if s.queue_wait is not None),
                key=lambda s: s.queue_wait, default=None)
            if slowest is not None:
                trace.stamp("queue_wait", slowest.queue_wait)
                trace.batch = slowest.batch
            elif slots:
                trace.batch = slots[-1].batch
        telemetry.count("serve.requests")
        telemetry.observe("serve.request_s", time.perf_counter() - t0)
        return (np.concatenate(margins), np.concatenate(preds), version,
                degraded)

    # -- dispatcher ----------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_rows

    def _pop_accounted(self, timeout=None):
        """Queue pop that keeps ``_queued_rows`` honest."""
        # photon-lint: disable=eternal-wait (drain contract: close() always enqueues the sentinel under the lock submit() takes, and submit() refuses once _closing is set, so the unbounded get is terminated by shutdown)
        item = self._q.get() if timeout is None \
            else self._q.get(timeout=timeout)
        if item is not self._SENTINEL:
            with self._lock:
                self._queued_rows -= item.n
        return item

    def _expired(self, slot) -> bool:
        if self._clock() <= slot.deadline:
            return False
        self._shed("deadline")
        slot.finish(error=DeadlineExceeded(
            "request deadline passed while queued (server overloaded); "
            "retry after backoff"))
        return True

    def _run(self) -> None:
        carry = None
        while True:
            if carry is not None:
                item, carry = carry, None
            else:
                item = self._pop_accounted()
            if item is self._SENTINEL:
                return
            if self._expired(item):
                continue
            batch = [item]
            total = item.n
            deadline = self._clock() + self.deadline_s
            while total < self.max_rows:
                wait = deadline - self._clock()
                if wait <= 0:
                    break
                try:
                    nxt = self._pop_accounted(timeout=wait)
                except queue.Empty:  # photon-lint: disable=swallowed-exception (the coalescing deadline expiring IS the dispatch signal, not a failure)
                    break
                if nxt is self._SENTINEL:
                    carry = nxt    # dispatch, then exit next loop
                    break
                if self._expired(nxt):
                    continue
                if total + nxt.n > self.max_rows:
                    carry = nxt    # opens the next batch
                    break
                batch.append(nxt)
                total += nxt.n
            self._dispatch(batch, total)

    def _dispatch(self, batch: list, total: int) -> None:
        t0 = time.perf_counter()
        bucket = self._bucket_for(total)
        rec = tracing.active()
        bt = None
        if rec is not None:
            bt = rec.begin_batch(bucket, total, len(batch))
            for slot in batch:
                slot.queue_wait = t0 - slot.t_enq
                slot.batch = bt.batch_id
        try:
            engine = self._engine_fn()   # the hot-swap seam
            rows = [r for slot in batch for r in slot.rows]
            margins, preds, degraded = engine.score_batch(rows, bucket,
                                                          trace=bt)
            if bt is not None:
                # Registered before any member slot wakes: a handler
                # thread finishing its request looks the batch up at once.
                rec.finish_batch(bt)
                bt = None
            lo = 0
            for slot in batch:
                hi = lo + slot.n
                slot.finish(result=(margins[lo:hi], preds[lo:hi]),
                            version=engine.version,
                            degraded=bool(np.any(degraded[lo:hi])))
                lo = hi
        except BaseException as e:
            logger.exception("serve batcher: batch of %d row(s) failed",
                             total)
            telemetry.thread_exception("serve-batcher", e)
            if bt is not None:
                rec.finish_batch(bt)   # failed members still link it
            for slot in batch:
                slot.finish(error=e)
            return
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.batches += 1
                self.rows += total
                self.padded_rows += bucket
                self._service_ewma_s = dt if self._service_ewma_s \
                    is None else ((1 - _SERVICE_EWMA)
                                  * self._service_ewma_s
                                  + _SERVICE_EWMA * dt)
        telemetry.count("serve.batches")
        telemetry.count("serve.batch_rows", total)
        telemetry.observe("serve.batch_fill", total / bucket)
        telemetry.observe("serve.batch_s", time.perf_counter() - t0)
        telemetry.gauge("serve.queue_depth", self._q.qsize())
        _mon.progress("serve", self.rows, unit="rows",
                      batches=self.batches)

    # -- stats / lifecycle ---------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            batches, rows, padded, shed = (self.batches, self.rows,
                                           self.padded_rows, self.shed)
            ewma = self._service_ewma_s
        return {
            "batches": batches, "rows": rows,
            "queue_depth": self._q.qsize(),
            "batch_fill": (round(rows / padded, 4) if padded else None),
            "shed": shed,
            "service_ewma_ms": (None if ewma is None
                                else round(ewma * 1e3, 3)),
            "buckets": list(self.buckets),
            "deadline_ms": round(self.deadline_s * 1e3, 3),
        }

    def close(self) -> None:
        """Drain: refuse new submits, score everything queued, stop."""
        with self._lock:
            if self._closing:
                return
            self._closing = True
            self._q.put(self._SENTINEL)
        self._thread.join(timeout=30.0)
        if self._thread.is_alive():
            logger.warning("serve batcher did not drain within 30s")
