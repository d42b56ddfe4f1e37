"""Run logging: a structured JSONL event log + phase wall-clock timers.

Counterpart of ``photon_ml_tpu/utils/run_log.py``: one event a line with
a monotonic timestamp, so convergence traces and phase timings are
machine-readable; the same events go to the stdlib logger.  ``event`` is
thread-safe, the file handle has a lifecycle (``close()``, a context
manager, an ``atexit`` flush fallback), and a schema-versioned
``run_header`` (run id, argv, torch and CUDA versions) opens a fresh
file.  It is the telemetry tier's event channel too: ``timed`` phases
are ``cat="phase"`` telemetry spans when a session is active, and with
``profile_dir`` a phase runs under ``torch.profiler`` and leaves its
Chrome trace there.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import logging
import os
import sys
import threading
import time
import uuid

logger = logging.getLogger("photon_ml_torch")

# run_header schema version: bumped when header fields change meaning.
RUN_LOG_SCHEMA = 1

# Drivers flush at most this often (events of _FLUSH_NOW at once).
DEFAULT_FLUSH_EVERY_S = 2.0

# Events a live reader (``telemetry watch``) or a post-mortem must not
# find missing are flushed at once; ``progress`` is already throttled at
# the monitor.
_FLUSH_NOW = frozenset({
    "run_header", "alert", "thread_exception", "progress",
    "phase_start", "phase_end", "telemetry_summary", "monitor_summary",
    "status_server", "done",
})


def _runtime_info() -> dict:
    """Runtime facts for the header: torch's version and CUDA build, and
    the card's name when CUDA is already initialized (a header never
    initializes it)."""
    info = {
        "schema": RUN_LOG_SCHEMA,
        "run_id": uuid.uuid4().hex[:12],
        "argv": list(sys.argv),
        "pid": os.getpid(),
        "host_platform": sys.platform,
    }
    torch = sys.modules.get("torch")
    if torch is not None:
        info["torch"] = getattr(torch, "__version__", None)
        info["cuda"] = getattr(torch.version, "cuda", None)
        if torch.cuda.is_initialized():
            info["device_name"] = torch.cuda.get_device_name()
    return info


def _ends_torn(path: str) -> bool:
    """Whether a non-empty file does not end with a newline."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            if f.tell() == 0:
                return False
            f.seek(-1, os.SEEK_END)
            return f.read(1) != b"\n"
    except OSError:  # photon-lint: disable=swallowed-exception (tail probe is best-effort; the append that follows raises on a file it cannot write, and the worst case is one fused line)
        return False


class RunLogger:
    """JSONL event sink.  Events: ``{"t": <seconds since start>,
    "event": <kind>, ...}``; a ``None`` path logs to the stdlib logger
    only."""

    def __init__(self, path: str | None = None, mode: str = "w",
                 run_info: dict | None = None,
                 header: bool | None = None,
                 flush_every_s: float | None = None):
        """``mode="w"`` makes each run's log self-contained; ``"a"``
        appends (and skips the header unless ``header`` asks for it).
        ``flush_every_s``: None flushes after every event; a positive
        cadence batches flushes."""
        self.path = path
        self._t0 = time.monotonic()
        self._f = None
        if flush_every_s is not None and flush_every_s < 0:
            raise ValueError(
                f"flush_every_s must be >= 0, got {flush_every_s!r}")
        self._flush_every_s = flush_every_s
        self._last_flush = time.monotonic()
        self.run_info = dict(run_info or {})
        self._lock = threading.Lock()
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, mode)
            if mode == "a" and _ends_torn(path):
                # A killed predecessor's unfinished last line: start this
                # run's events on a line of their own.
                self._f.write("\n")
            atexit.register(self.close)
            if header if header is not None else mode == "w":
                self.event("run_header", **_runtime_info(),
                           **self.run_info)

    def now(self) -> float:
        """Seconds on this logger's monotonic clock (the ``t`` field)."""
        return time.monotonic() - self._t0

    def event(self, kind: str, **fields) -> None:
        rec = {"t": round(self.now(), 6), "event": kind}
        rec.update(fields)
        with self._lock:
            if self._f is not None:
                self._f.write(json.dumps(rec) + "\n")
                now_m = time.monotonic()
                if (not self._flush_every_s or kind in _FLUSH_NOW
                        or now_m - self._last_flush
                        >= self._flush_every_s):
                    self._f.flush()
                    self._last_flush = now_m
        logger.info("%s %s", kind, fields)

    def flush(self) -> None:
        """Force buffered events to disk (for a caller handing the file
        to a reader)."""
        with self._lock:
            if self._f is not None:
                self._f.flush()
                self._last_flush = time.monotonic()

    @contextlib.contextmanager
    def timed(self, phase: str, profile_dir: str | None = None, **fields):
        """Log a phase's start, end and duration.  With an active
        telemetry session the phase is also a ``cat="phase"`` span.
        ``profile_dir``: the phase runs under ``torch.profiler`` (the
        CPU, and CUDA when a card is in use) and its Chrome trace is
        written to ``<profile_dir>/<phase>.pt.trace.json``."""
        from photon_ml_torch import telemetry
        from photon_ml_torch.telemetry import monitor as _monitor

        self.event("phase_start", phase=phase, **fields)
        # The live monitor's /status "phase" is the innermost open phase.
        _monitor.phase_begin(phase)
        start = time.monotonic()
        prof = (_profiler(profile_dir, phase) if profile_dir
                else contextlib.nullcontext())
        try:
            with telemetry.span(phase, cat="phase"), prof:
                yield
        finally:
            _monitor.phase_end(phase)
            self.event(
                "phase_end", phase=phase,
                duration_s=round(time.monotonic() - start, 6),
                **({"profile_dir": profile_dir} if profile_dir else {}),
                **fields)

    def close(self) -> None:
        """Flush and release the file handle (idempotent)."""
        with self._lock:
            f, self._f = self._f, None
        if f is not None:
            f.close()
            with contextlib.suppress(Exception):
                atexit.unregister(self.close)

    def __enter__(self) -> "RunLogger":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False


@contextlib.contextmanager
def _profiler(profile_dir: str, phase: str):
    """``torch.profiler.profile`` over the block; its Chrome trace goes
    to ``<profile_dir>/<phase>.pt.trace.json``."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(profile_dir, f"{phase}.pt.trace.json"))


def read_run_log(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
