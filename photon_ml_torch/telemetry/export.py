"""Chrome trace-event export: the session timeline as ``trace.json``.

Counterpart of ``photon_ml_tpu/telemetry/export.py`` (its training
trace; the serving tier's request traces are not ported).  The output
is the Trace Event Format's JSON-object form, ``{"traceEvents": [...],
"displayTimeUnit": "ms"}``: complete ("X") events for spans, instant
("i") events for kernel builds, counter ("C") tracks for RSS and device
memory, and thread-name metadata ("M") so Perfetto /
``chrome://tracing`` label each pipeline thread (the solver loop,
``photon-chunk-prefetch``, ``photon-score-writer``,
``photon-telemetry-rss``).  Timestamps are microseconds on the session
RunLogger's clock, so a span's ``ts``/1e6 equals the matching JSONL
event's ``t``.
"""

from __future__ import annotations

import json
import os


def _us(seconds: float) -> int:
    return int(round(seconds * 1e6))


def trace_events(spans: list[dict], thread_names: dict,
                 instants: list, rss_series: list,
                 device_series: list = (),
                 pid: int | None = None) -> list[dict]:
    """The traceEvents list."""
    pid = os.getpid() if pid is None else pid
    events: list[dict] = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": "photon-ml-torch"}},
    ]
    for tid, name in sorted(thread_names.items()):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": name}})
    for rec in spans:
        ev = {"ph": "X", "name": rec["name"], "cat": rec["cat"],
              "pid": pid, "tid": rec["tid"], "ts": _us(rec["ts"]),
              "dur": max(1, _us(rec["dur"]))}
        args = dict(rec.get("args") or {})
        if rec.get("failed"):
            args["failed"] = True
        if args:
            ev["args"] = args
        events.append(ev)
    for ts, tid, name, cat, args in instants:
        ev = {"ph": "i", "name": name, "cat": cat, "pid": pid,
              "tid": tid, "ts": _us(ts), "s": "t"}
        if args:
            ev["args"] = args
        events.append(ev)
    for ts, mb in rss_series:
        events.append({"ph": "C", "name": "proc.rss_mb", "pid": pid,
                       "tid": 0, "ts": _us(ts),
                       "args": {"rss_mb": round(mb, 1)}})
    for ts, nbytes in device_series:
        # Phase-boundary device-memory samples, in MB beside the RSS.
        events.append({"ph": "C", "name": "device.mem_mb", "pid": pid,
                       "tid": 0, "ts": _us(ts),
                       "args": {"mem_mb": round(nbytes / 1e6, 2)}})
    events.sort(key=lambda e: e.get("ts", 0))
    return events


def write_trace(path: str, spans: list[dict], thread_names: dict,
                instants: list, rss_series: list,
                device_series: list = ()) -> None:
    """Write ``trace.json`` atomically (tmp + rename: a killed run leaves
    the previous trace readable, never a truncated one)."""
    doc = {"traceEvents": trace_events(spans, thread_names, instants,
                                       rss_series, device_series),
           "displayTimeUnit": "ms"}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
