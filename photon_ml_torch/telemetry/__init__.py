"""Pipeline telemetry: spans, metrics, device accounting and trace export.

Counterpart of ``photon_ml_tpu/telemetry/__init__.py``.  The streamed
tiers are multi-threaded pipelines (disk reader and host stager on the
prefetch thread, kernel launches on the consumer's, the sink writer on
its own) whose time is only visible stage by stage.  One session gives:

- **Spans**: nested, thread-aware ``telemetry.span`` records, kept per
  thread and merged at close.  Host wall clock: a span around a CUDA
  launch measures the launch, not the kernel.  While ``torch.profiler``
  records, a span is also the profiler range ``photon::<name>``, so the
  profiler's trace holds the program's spans beside the kernels they
  launched, on one clock (``device.device_s_by_span`` reads the device
  time under each).
- **Device time**: ``device_timed`` records a CUDA event pair on the
  current stream at the edges of a chunk program (no synchronization);
  the pairs are read once, at session close, into the
  ``device.event_s.<program>`` histograms.  The start event is recorded
  on a stream the chunk's fence has just drained, so an interval is the
  stream's time for the chunk: its kernels plus every gap while the
  host enqueues them.  It bounds device time from above and is no
  kernel-busy time; the report labels it so and gives it no roofline
  share.
- **Metrics**: counters, gauges and histograms (bounded reservoirs):
  LRU hits against disk loads, prefetch stall against consumer wait,
  the sweep odometer, line-search trials, sink queue depth, kernel
  builds (``kernels.builds``, bridged from ``kernels._build``), and a
  background RSS sampler.
- **Export**: ``telemetry_summary`` (+ one ``span`` event a span in
  trace mode) through the session's ``utils.run_log.RunLogger`` JSONL,
  and in trace mode a Chrome trace-event ``trace.json``.
- **Report**: ``python -m photon_ml_torch.telemetry report
  <run_log.jsonl>``.

Modes (``TrainingConfig.telemetry`` / ``ScoringConfig.telemetry``):
``off`` (default: the module helpers are one global read and an early
return), ``metrics`` (counters and per-name span statistics), ``trace``
(``metrics`` plus every span and ``trace.json``).

Every shared registry mutates under one lock; per-span state lives on a
``threading.local``; heartbeats and exception events go straight
through the (locked) ``RunLogger``.  Nothing here synchronizes the
device inside a chunk loop.
"""

from __future__ import annotations

import bisect
import contextlib
import logging
import os
import threading
import time

logger = logging.getLogger(__name__)

MODES = ("off", "metrics", "trace")

# Span names that are one full streamed data pass: the basis of the
# prefetcher overlap efficiency (consumer blocked time / pass time).
PASS_SPANS = ("sweep", "per_example_pass", "score_pass", "re_sweep",
              "fused_cycle_pass")

# Bounded reservoirs: when full, decimate to every other sample and
# double the stride (deterministic; no RNG on the telemetry path).
_RESERVOIR_CAP = 1024

# Counter rate() series: samples past the horizon are dropped when the
# series reaches its cap.
_RATE_HORIZON_S = 300.0
_RATE_SERIES_CAP = 4096

# CUDA event pairs kept a program before decimation (read at close).
_EVENT_PAIRS_CAP = 4096


class _NullSpan:
    """The off-path span: a shared, stateless context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def _reservoir_quantile(sorted_reservoir: list, q: float):
    """Nearest-rank quantile of a sorted reservoir."""
    if not sorted_reservoir:
        return None
    idx = min(len(sorted_reservoir) - 1,
              int(round(q * (len(sorted_reservoir) - 1))))
    return sorted_reservoir[idx]


# The active session (None = telemetry off).  Module-global by design:
# the instrumentation sites are deep library code (prefetch threads,
# chunk stores) that cannot thread a handle through every call.
_ACTIVE: "Telemetry | None" = None
_ACTIVE_LOCK = threading.Lock()


def active() -> "Telemetry | None":
    """The active session, or None when telemetry is off."""
    return _ACTIVE


def span(name: str, cat: str = "app", **args):
    """Context manager timing a nested, thread-aware span (host wall
    clock).  A shared no-op when telemetry is off."""
    t = _ACTIVE
    if t is None:
        return _NULL_SPAN
    return _Span(t, name, cat, args or None)


def device_timed(program: str | None, device):
    """Context manager recording a CUDA event pair on ``device``'s
    current stream around a chunk program; read at session close into
    ``device.event_s.<program>``.  A no-op when telemetry is off, when
    ``program`` is None, or when the device is not CUDA."""
    t = _ACTIVE
    if (t is None or program is None
            or getattr(device, "type", device) != "cuda"):
        return _NULL_SPAN
    return _DeviceTimed(t, program, device)


def count(name: str, n=1) -> None:
    """Increment counter ``name`` (int or float increments)."""
    t = _ACTIVE
    if t is not None:
        t.count(name, n)


def gauge(name: str, value) -> None:
    """Set gauge ``name`` (last/min/max retained)."""
    t = _ACTIVE
    if t is not None:
        t.gauge(name, value)


def observe(name: str, value) -> None:
    """Fold ``value`` into histogram ``name`` (count/sum/min/max and a
    bounded reservoir)."""
    t = _ACTIVE
    if t is not None:
        t.observe(name, value)


def heartbeat(stage: str, **fields) -> None:
    """Immediate liveness event from a pipeline thread (a stalled run
    shows which stage stopped)."""
    t = _ACTIVE
    if t is not None:
        t.heartbeat(stage, **fields)


def device_memory(tag: str | None = None) -> None:
    """Sample the device-memory gauge now.  Phase spans sample at open
    and close; call this at extra boundaries (after dataset placement)."""
    t = _ACTIVE
    if t is not None:
        t.sample_device_memory(tag)


def thread_exception(stage: str, error: BaseException, **fields) -> None:
    """Immediate death event from a pipeline thread (written before the
    error rides the queue to the consumer)."""
    t = _ACTIVE
    if t is not None:
        t.thread_exception(stage, error, **fields)


# The prefix of a span's range in a torch.profiler trace.
PROFILER_PREFIX = "photon::"


class _Span:
    """One live span.  Duration on ``time.perf_counter``; the recorded
    ``ts`` is on the session RunLogger's clock, so span timestamps line
    up with the JSONL ``t`` field.  While a profiler records, the span
    is also its range ``photon::<name>``."""

    __slots__ = ("_t", "name", "cat", "args", "ts", "t0", "depth", "_range")

    def __init__(self, t: "Telemetry", name: str, cat: str, args):
        self._t = t
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        tl = self._t._local
        stack = getattr(tl, "stack", None)
        if stack is None:
            stack = tl.stack = []
            self._t._register_thread()
        self.depth = len(stack)
        stack.append(self)
        self.ts = self._t.now()
        self.t0 = time.perf_counter()
        # A phase's device-memory samples are part of its own time, so
        # the spans still account for the wall clock.
        if self.cat == "phase":
            self._t.sample_device_memory(self.name)
        self._range = _profiler_range(self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        if self.cat == "phase":
            self._t.sample_device_memory(self.name)
        dur = time.perf_counter() - self.t0
        self._t._local.stack.pop()
        self._t._finish_span(self, dur, failed=exc_type is not None)
        return False


def _profiler_range(name: str):
    """The open profiler range ``photon::<name>`` while a
    ``torch.profiler`` records, else None."""
    import torch

    if not torch.autograd._profiler_enabled():
        return None
    rf = torch.profiler.record_function(PROFILER_PREFIX + name)
    rf.__enter__()
    return rf


class _DeviceTimed:
    """A CUDA event pair around a chunk program (see ``device_timed``)."""

    __slots__ = ("_t", "program", "device", "start")

    def __init__(self, t: "Telemetry", program: str, device):
        self._t = t
        self.program = program
        self.device = device

    def __enter__(self):
        import torch

        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, exc_type, exc, tb):
        import torch

        if exc_type is None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            self._t._add_event_pair(self.program, self.start, end)
        return False


class _RssSampler:
    """Background RSS sampler: ``/proc/self/status`` VmRSS at a fixed
    period into the ``proc.rss_mb`` gauge and a (ts, mb) series for the
    trace's counter track.  ``Event`` stops the thread."""

    def __init__(self, t: "Telemetry", period_s: float):
        self._t = t
        self._period = period_s
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._samples: list = []
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="photon-telemetry-rss")

    @staticmethod
    def rss_mb() -> float | None:
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        return int(line.split()[1]) / 1024.0
        except OSError:  # photon-lint: disable=swallowed-exception (/proc absent off-Linux; start() then never starts the sampler)
            return None
        return None

    def _run(self) -> None:
        while not self._stop.is_set():
            mb = self.rss_mb()
            if mb is not None:
                self._t.gauge("proc.rss_mb", mb)
                with self._lock:
                    self._samples.append((self._t.now(), mb))
                    if len(self._samples) > _RESERVOIR_CAP:
                        del self._samples[::2]
            self._stop.wait(self._period)

    def start(self) -> None:
        if self.rss_mb() is not None:
            self._thread.start()

    def close(self) -> list:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=max(5.0, self._period * 2))
        with self._lock:
            return list(self._samples)


class Telemetry:
    """One session: tracer, metrics registry and exporters.

    Create through ``start()`` / ``maybe_session()``.  ``close()`` reads
    the CUDA event pairs, merges per-thread spans, writes the
    ``telemetry_summary`` (+ span events and ``trace.json`` in trace
    mode) and deactivates.
    """

    def __init__(self, mode: str, run_logger, telemetry_dir: str | None,
                 heartbeat_s: float = 5.0, rss_period_s: float = 0.25,
                 owns_logger: bool = False, device="cpu"):
        if mode not in ("metrics", "trace"):
            raise ValueError(f"telemetry mode {mode!r} not in "
                             "('metrics', 'trace')")
        self.mode = mode
        self.dir = telemetry_dir
        self.device = device   # the run's: where device memory is read
        self.heartbeat_s = float(heartbeat_s)
        self._rss_period_s = float(rss_period_s)
        self._log = run_logger
        self._owns_logger = owns_logger
        self._lock = threading.Lock()
        self._local = threading.local()
        self._counters: dict = {}
        self._counter_series: dict = {}   # name -> [(ts, cumulative)]
        self._gauges: dict = {}
        self._hists: dict = {}
        self._span_stats: dict = {}
        self._thread_spans: dict = {}     # tid -> [span records]
        self._thread_names: dict = {}     # tid -> thread name
        self._instants: list = []         # (ts, tid, name, cat, args)
        self._device_programs: dict = {}  # name -> cost dict (device.py)
        self._event_pairs: dict = {}      # program -> [(start, end)]
        self._dev_series: list = []       # (ts, bytes_in_use) samples
        self._dev_memory_source: str | None = None
        self._sampler: _RssSampler | None = None
        self._build_listener = None
        self._closed = False

    # -- clock ------------------------------------------------------------

    def now(self) -> float:
        """Seconds on the session RunLogger's monotonic clock."""
        return self._log.now()

    # -- lifecycle --------------------------------------------------------

    def _open(self) -> None:
        from photon_ml_torch.kernels import _build

        self._log.event("telemetry_start", mode=self.mode,
                        **({"dir": self.dir} if self.dir else {}))
        self._sampler = _RssSampler(self, self._rss_period_s)
        self._sampler.start()
        # Kernel builds (one nvcc a source) land as a counter and, in
        # trace mode, an instant on the building thread.
        self._build_listener = self._on_kernel_build
        _build.add_build_listener(self._build_listener)

    def _on_kernel_build(self, name: str) -> None:
        self.count("kernels.builds")
        self._instant("kernel_build", "kernels", {"source": name})

    def close(self) -> None:
        """Read device events, merge, export, deactivate.  Idempotent."""
        global _ACTIVE
        if self._closed:
            return
        self._closed = True
        try:
            rss_series = self._sampler.close() if self._sampler else []
            if self._build_listener is not None:
                from photon_ml_torch.kernels import _build

                _build.remove_build_listener(self._build_listener)
                self._build_listener = None
            self._read_event_pairs()
            summary = self.summary()
            self._log.event("telemetry_summary", **summary)
            if self.mode == "trace":
                self._export_trace(rss_series)
        finally:
            if self._owns_logger:
                self._log.close()
            with _ACTIVE_LOCK:
                if _ACTIVE is self:
                    _ACTIVE = None

    def _export_trace(self, rss_series: list) -> None:
        with self._lock:
            merged = [dict(rec, tid=tid,
                           thread=self._thread_names.get(tid, str(tid)))
                      for tid, recs in self._thread_spans.items()
                      for rec in recs]
        merged.sort(key=lambda r: r["ts"])
        for rec in merged:
            self._log.event("span", **rec)
        if self.dir is None:
            return
        from photon_ml_torch.telemetry.export import write_trace

        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, "trace.json")
        with self._lock:
            names = dict(self._thread_names)
            instants = list(self._instants)
            dev_series = list(self._dev_series)
        write_trace(path, merged, names, instants, rss_series,
                    device_series=dev_series)
        self._log.event("trace_written", path=path, spans=len(merged))

    # -- device events ----------------------------------------------------

    def _add_event_pair(self, program: str, start, end) -> None:
        with self._lock:
            pairs = self._event_pairs.setdefault(program, [])
            pairs.append((start, end))
            if len(pairs) > _EVENT_PAIRS_CAP:
                del pairs[::2]

    def _read_event_pairs(self) -> None:
        """Fold every recorded CUDA event pair into its program's
        ``device.event_s.<program>`` histogram.  The one device wait of
        the session, at close; a pair that cannot be read raises."""
        with self._lock:
            pairs, self._event_pairs = self._event_pairs, {}
        for program, evs in pairs.items():
            if not evs:
                continue
            evs[-1][1].synchronize()
            for start, end in evs:
                end.synchronize()
                self.observe("device.event_s." + program,
                             start.elapsed_time(end) / 1e3)

    # -- metrics ----------------------------------------------------------

    def count(self, name: str, n=1) -> None:
        now = self.now()
        with self._lock:
            v = self._counters.get(name, 0) + n
            self._counters[name] = v
            # The (ts, cumulative) series behind rate(): one append an
            # increment; at the cap one batched drop of stale entries,
            # then every-other decimation keeping the newest sample.
            s = self._counter_series.get(name)
            if s is None:
                s = self._counter_series[name] = []
            s.append((now, v))
            if len(s) >= _RATE_SERIES_CAP:
                cutoff = now - _RATE_HORIZON_S
                k = min(bisect.bisect_left(s, (cutoff,)), len(s) - 2)
                if k > 0:
                    del s[:k]
                if len(s) >= _RATE_SERIES_CAP:
                    del s[1::2]

    def counter(self, name: str, default=0):
        """Current cumulative value of counter ``name``."""
        with self._lock:
            return self._counters.get(name, default)

    def gauge_value(self, name: str) -> dict | None:
        """Snapshot of gauge ``name`` ({last, min, max}) or None."""
        with self._lock:
            g = self._gauges.get(name)
            return None if g is None else dict(g)

    def rate(self, name: str, window_s: float = 30.0,
             now: float | None = None) -> float | None:
        """Rate of counter ``name`` in units a second over the trailing
        ``window_s`` (anchored at ``now`` on the session clock, else at
        the newest sample): Δvalue / Δt between the newest sample and
        the oldest inside the window.  Exact but for decimation under
        the series cap, which moves the interval by at most two sample
        spacings.  None with fewer than two samples."""
        if window_s <= 0:
            raise ValueError(f"window_s must be positive, got {window_s!r}")
        with self._lock:
            s = self._counter_series.get(name)
            if not s or len(s) < 2:
                return None
            anchor = s[-1][0] if now is None else float(now)
            cutoff = anchor - window_s
            base = None
            for ts, v in reversed(s):
                if ts < cutoff:
                    break
                base = (ts, v)
            if base is None or base[0] >= s[-1][0]:
                base = s[-2]
            dt = anchor - base[0]
            if dt <= 0:
                return None
            return (s[-1][1] - base[1]) / dt

    def gauge(self, name: str, value) -> None:
        value = float(value)
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                self._gauges[name] = {"last": value, "min": value,
                                      "max": value}
            else:
                g["last"] = value
                g["min"] = min(g["min"], value)
                g["max"] = max(g["max"], value)

    def observe(self, name: str, value) -> None:
        value = float(value)
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = {
                    "count": 0, "sum": 0.0, "min": value, "max": value,
                    "reservoir": [], "stride": 1}
            h["count"] += 1
            h["sum"] += value
            h["min"] = min(h["min"], value)
            h["max"] = max(h["max"], value)
            if (h["count"] - 1) % h["stride"] == 0:
                h["reservoir"].append(value)
                if len(h["reservoir"]) >= _RESERVOIR_CAP:
                    del h["reservoir"][::2]
                    h["stride"] *= 2

    def histogram_quantiles(self, prefix: str, qs: tuple) -> dict:
        """{name: {count, quantiles}} of every histogram whose name
        starts with ``prefix`` (copied under the lock, sorted outside)."""
        out = {}
        with self._lock:
            matching = [(name, h["count"], list(h["reservoir"]))
                        for name, h in self._hists.items()
                        if name.startswith(prefix)]
        for name, n, res in matching:
            res.sort()
            out[name] = {"count": n,
                         "quantiles": [_reservoir_quantile(res, q)
                                       for q in qs]}
        return out

    def percentile(self, name: str, q: float) -> float | None:
        """Quantile ``q`` in [0, 1] of histogram ``name`` from its
        reservoir: the true quantile of a deterministic subsample of
        size ≥ _RESERVOIR_CAP/2 once the stream exceeds the cap, so the
        rank error is ≤ 1/R of the distribution.  None for an unknown
        name."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q!r} not in [0, 1]")
        with self._lock:
            h = self._hists.get(name)
            if h is None or not h["reservoir"]:
                return None
            res = sorted(h["reservoir"])
        return _reservoir_quantile(res, q)

    # -- device memory ----------------------------------------------------

    def sample_device_memory(self, tag: str | None = None) -> None:
        """Device-memory gauge sample (``telemetry.device.memory_snapshot``)
        at every phase-span boundary; each sample also lands as a
        ``device_memory`` JSONL event carrying ``tag``."""
        from photon_ml_torch.telemetry import device as _device

        snap = _device.memory_snapshot(self.device)
        self.gauge("device.bytes_in_use", snap["bytes_in_use"])
        if "peak_bytes_in_use" in snap:
            self.gauge("device.peak_bytes_in_use",
                       snap["peak_bytes_in_use"])
        with self._lock:
            self._dev_memory_source = snap["source"]
            self._dev_series.append((self.now(), snap["bytes_in_use"]))
            if len(self._dev_series) > _RESERVOIR_CAP:
                del self._dev_series[::2]
        self._log.event("device_memory",
                        **({"tag": tag} if tag else {}), **snap)

    # -- spans ------------------------------------------------------------

    def span(self, name: str, cat: str = "app", **args) -> _Span:
        return _Span(self, name, cat, args or None)

    def _register_thread(self) -> None:
        tid = threading.get_ident()
        with self._lock:
            self._thread_spans.setdefault(tid, [])
            self._thread_names[tid] = threading.current_thread().name

    def _finish_span(self, sp: _Span, dur: float, failed: bool) -> None:
        with self._lock:
            st = self._span_stats.get(sp.name)
            if st is None:
                st = self._span_stats[sp.name] = {
                    "cat": sp.cat, "count": 0, "total_s": 0.0,
                    "min_s": dur, "max_s": dur}
            st["count"] += 1
            st["total_s"] += dur
            st["min_s"] = min(st["min_s"], dur)
            st["max_s"] = max(st["max_s"], dur)
            if self.mode == "trace":
                rec = {"name": sp.name, "cat": sp.cat,
                       "ts": round(sp.ts, 6), "dur": round(dur, 6),
                       "depth": sp.depth}
                if sp.args:
                    rec["args"] = sp.args
                if failed:
                    rec["failed"] = True
                self._thread_spans[threading.get_ident()].append(rec)

    def _instant(self, name: str, cat: str, args=None) -> None:
        if self.mode != "trace":
            return
        with self._lock:
            self._instants.append(
                (self.now(), threading.get_ident(), name, cat, args))
            if len(self._instants) > 4 * _RESERVOIR_CAP:
                del self._instants[::2]

    # -- liveness events --------------------------------------------------

    def heartbeat(self, stage: str, **fields) -> None:
        self._log.event("heartbeat", stage=stage,
                        thread=threading.current_thread().name, **fields)

    def thread_exception(self, stage: str, error: BaseException,
                         **fields) -> None:
        self._log.event("thread_exception", stage=stage,
                        thread=threading.current_thread().name,
                        error=repr(error), **fields)

    # -- summary ----------------------------------------------------------

    @staticmethod
    def _derived(counters: dict, spans: dict) -> dict:
        """Prefetcher overlap efficiency from snapshot dicts: 1 −
        (consumer blocked on the queue / total streamed pass time);
        ~1.0 means the prefetch pipeline hid the disk and staging tier
        under the consumer's compute."""
        out: dict = {}
        blocked = counters.get("prefetch.consumer_wait_s")
        basis = sum(st["total_s"] for name, st in spans.items()
                    if name in PASS_SPANS)
        if blocked is not None and basis > 0:
            frac = min(1.0, float(blocked) / basis)
            out["consumer_blocked_fraction"] = round(frac, 4)
            out["overlap_efficiency"] = round(1.0 - frac, 4)
            out["pass_span_total_s"] = round(basis, 3)
        stall = counters.get("prefetch.producer_stall_s")
        if stall is not None and basis > 0:
            out["producer_stall_fraction"] = round(
                min(1.0, float(stall) / basis), 4)
        return out

    def summary(self) -> dict:
        """JSON-ready snapshot of every registry (the
        ``telemetry_summary`` event body)."""
        with self._lock:
            counters = {k: (round(v, 6) if isinstance(v, float) else v)
                        for k, v in sorted(self._counters.items())}
            gauges = {k: {f: round(x, 3) for f, x in v.items()}
                      for k, v in sorted(self._gauges.items())}
            hists = {}
            for k, h in sorted(self._hists.items()):
                res = sorted(h["reservoir"])

                def pct(q, res=res):
                    v = _reservoir_quantile(res, q)
                    return None if v is None else round(v, 6)

                hists[k] = {"count": h["count"],
                            "sum": round(h["sum"], 6),
                            "min": round(h["min"], 6),
                            "max": round(h["max"], 6),
                            "mean": round(h["sum"] / max(h["count"], 1), 6),
                            "p50": pct(0.50), "p95": pct(0.95),
                            "p99": pct(0.99)}
            spans = {k: {"cat": st["cat"], "count": st["count"],
                         "total_s": round(st["total_s"], 6),
                         "min_s": round(st["min_s"], 6),
                         "max_s": round(st["max_s"], 6)}
                     for k, st in sorted(self._span_stats.items())}
            programs = {k: v for k, v in self._device_programs.items()
                        if v is not None}
            dev_source = self._dev_memory_source
            dev_samples = len(self._dev_series)
        out = {"mode": self.mode, "counters": counters, "gauges": gauges,
               "histograms": hists, "spans": spans,
               "derived": self._derived(counters, spans)}
        if programs or dev_source is not None:
            device = {}
            if programs:
                device["programs"] = programs
            if dev_source is not None:
                device["memory"] = {
                    "source": dev_source, "samples": dev_samples,
                    **{k: gauges[f"device.{k}"]["last"]
                       for k in ("bytes_in_use", "peak_bytes_in_use")
                       if f"device.{k}" in gauges},
                    **{f"{k}_max": gauges[f"device.{k}"]["max"]
                       for k in ("bytes_in_use",)
                       if f"device.{k}" in gauges}}
            out["device"] = device
        return out


def start(mode: str, telemetry_dir: str | None = None, run_logger=None,
          heartbeat_s: float = 5.0, rss_period_s: float = 0.25,
          device=None) -> Telemetry:
    """Activate the process's telemetry session.

    ``run_logger``: the events channel; when None a ``RunLogger`` at
    ``<telemetry_dir>/run_log.jsonl`` (or a stdlib-logging sink when
    ``telemetry_dir`` is None too) is created and closed by the
    session.  ``device``: the run's device, whose memory the session
    samples (``None``: CUDA, as the port's entry points; a CPU device
    samples the host's resident set, labelled so)."""
    global _ACTIVE
    if mode not in MODES:
        raise ValueError(f"telemetry mode {mode!r} not in {MODES}")
    if mode == "off":
        raise ValueError("start() needs an active mode; gate 'off' at "
                         "the caller (see maybe_session)")
    from photon_ml_torch.device import resolve_device

    device = resolve_device(device)
    owns = False
    if run_logger is None:
        from photon_ml_torch.utils.run_log import RunLogger

        path = (os.path.join(telemetry_dir, "run_log.jsonl")
                if telemetry_dir else None)
        run_logger = RunLogger(path, run_info={"telemetry": mode})
        owns = True
    t = Telemetry(mode, run_logger, telemetry_dir,
                  heartbeat_s=heartbeat_s, rss_period_s=rss_period_s,
                  owns_logger=owns, device=device)
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            if owns:
                run_logger.close()
            raise RuntimeError("a telemetry session is already active")
        _ACTIVE = t
    try:
        t._open()
    except BaseException:
        t.close()
        raise
    return t


@contextlib.contextmanager
def maybe_session(mode: str | None, telemetry_dir: str | None = None,
                  run_logger=None, **kw):
    """Session context honouring the config knob: ``off``/None (or a
    session already active: a driver opened one) yields without creating
    anything; otherwise a session spans the block."""
    if mode in (None, "off") or _ACTIVE is not None:
        yield _ACTIVE
        return
    t = start(mode, telemetry_dir, run_logger, **kw)
    try:
        yield t
    finally:
        t.close()
