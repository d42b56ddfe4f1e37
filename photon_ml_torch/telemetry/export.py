"""Chrome trace-event export: the session timeline as ``trace.json``.

Counterpart of ``photon_ml_tpu/telemetry/export.py``.  The output is
the Trace Event Format's JSON-object form, ``{"traceEvents": [...],
"displayTimeUnit": "ms"}``: complete ("X") events for spans, instant
("i") events for kernel builds, counter ("C") tracks for RSS and device
memory, and thread-name metadata ("M") so Perfetto /
``chrome://tracing`` label each pipeline thread (the solver loop,
``photon-chunk-prefetch``, ``photon-score-writer``,
``photon-telemetry-rss``).  Timestamps are microseconds on the session
RunLogger's clock, so a span's ``ts``/1e6 equals the matching JSONL
event's ``t``.

Serve traces: ``serve_trace_events`` renders the request-tracing tier's
kept ``request_trace`` / ``batch_trace`` records, one Chrome pid a
serving process, request spans on a "requests" track and the shared
micro-batch spans on a "batcher" track, with FLOW events (``ph: s/f``)
joining a frontend request to the replica request it caused (by trace
id) and a request to its micro-batch (by batch id).  Their timestamps
are each record's ``wall_t``, so processes on one host line up.
"""

from __future__ import annotations

import json
import os

# Request stages laid out from the span START in this order; the tail
# stages anchor to its END (the shared batch work sits in the gap, linked
# by the batch flow arrow).
_REQ_HEAD_STAGES = ("route", "retry", "forward", "admission",
                    "queue_wait")
_REQ_TAIL_STAGES = ("serialize", "write")
_BATCH_STAGES = ("assemble", "store_lookup", "dispatch", "d2h")


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


def serve_trace_events(processes: list[dict]) -> list[dict]:
    """Chrome trace events for serve-trace records.

    ``processes``: ``[{"name", "requests": [request_trace bodies],
    "batches": [batch_trace bodies]}, ...]`` — the JSONL event dicts
    the ``TraceRecorder`` writes.  Process i becomes Chrome pid i+1;
    tid 1 is the request track, tid 2 the batcher track."""
    recs = [r for p in processes for r in p.get("requests", ())]
    recs += [b for p in processes for b in p.get("batches", ())]
    if not recs:
        return []
    t_origin = min(float(r.get("wall_t", 0.0)) for r in recs)

    def ts_us(rec) -> int:
        return _us(float(rec.get("wall_t", 0.0)) - t_origin)

    # Frontend request spans by trace id: the flow-arrow sources.
    frontend: dict = {}
    for i, proc in enumerate(processes):
        for rec in proc.get("requests", ()):
            if rec.get("role") == "frontend":
                frontend.setdefault(rec.get("trace"), (i + 1, ts_us(rec)))

    events: list[dict] = []
    for i, proc in enumerate(processes):
        pid = i + 1
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0,
                       "args": {"name": proc.get("name", f"proc{pid}")}})
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": 1, "args": {"name": "requests"}})
        if proc.get("batches"):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": 2, "args": {"name": "batcher"}})
        for rec in proc.get("requests", ()):
            ts = ts_us(rec)
            dur = max(1, _us(float(rec.get("total_ms", 0.0)) / 1e3))
            trace = rec.get("trace")
            args = {k: v for k, v in rec.items()
                    if k not in ("event", "t", "wall_t")}
            events.append({"ph": "X", "name": "request", "cat": "serve",
                           "pid": pid, "tid": 1, "ts": ts, "dur": dur,
                           "args": args})
            # Stage sub-slices: head stages laid out from the span
            # start, tail stages anchored to its end — the gap is the
            # shared batch work the flow arrow points at.
            stages = rec.get("stages_ms") or {}
            cursor = ts
            for stage in _REQ_HEAD_STAGES:
                if stage in stages:
                    sdur = max(1, _us(stages[stage] / 1e3))
                    events.append({"ph": "X", "name": stage,
                                   "cat": "serve_stage", "pid": pid,
                                   "tid": 1, "ts": cursor, "dur": sdur})
                    cursor += sdur
            tail_cursor = ts + dur
            for stage in reversed(_REQ_TAIL_STAGES):
                if stage in stages:
                    sdur = max(1, _us(stages[stage] / 1e3))
                    tail_cursor -= sdur
                    events.append({"ph": "X", "name": stage,
                                   "cat": "serve_stage", "pid": pid,
                                   "tid": 1,
                                   "ts": max(cursor, tail_cursor),
                                   "dur": sdur})
            role = rec.get("role")
            if role != "frontend" and trace in frontend:
                # The cross-process join: frontend hop → replica work.
                f_pid, f_ts = frontend[trace]
                events.append({"ph": "s", "id": str(trace),
                               "name": "request_flow", "cat": "serve",
                               "pid": f_pid, "tid": 1, "ts": f_ts + 1})
                events.append({"ph": "f", "bp": "e", "id": str(trace),
                               "name": "request_flow", "cat": "serve",
                               "pid": pid, "tid": 1, "ts": ts + 1})
            if role != "frontend" and rec.get("batch") is not None:
                events.append({"ph": "s",
                               "id": f"{trace}:b{rec['batch']}",
                               "name": "batch_flow", "cat": "serve",
                               "pid": pid, "tid": 1, "ts": ts + 2})
        for rec in proc.get("batches", ()):
            ts = ts_us(rec)
            dur = max(1, _us(float(rec.get("total_ms", 0.0)) / 1e3))
            args = {k: v for k, v in rec.items()
                    if k not in ("event", "t", "wall_t")}
            events.append({"ph": "X", "name": f"batch {rec.get('batch')}",
                           "cat": "serve", "pid": pid, "tid": 2,
                           "ts": ts, "dur": dur, "args": args})
            cursor = ts
            stages = rec.get("stages_ms") or {}
            for stage in _BATCH_STAGES:
                if stage in stages:
                    sdur = max(1, _us(stages[stage] / 1e3))
                    events.append({"ph": "X", "name": stage,
                                   "cat": "serve_stage", "pid": pid,
                                   "tid": 2, "ts": cursor, "dur": sdur})
                    cursor += sdur
            # Every member request that linked this batch emitted an
            # "s" with this id; one "f" on the batch span binds them.
            for rq in proc.get("requests", ()):
                if rq.get("batch") == rec.get("batch"):
                    events.append({"ph": "f", "bp": "e",
                                   "id": f"{rq.get('trace')}:"
                                         f"b{rec.get('batch')}",
                                   "name": "batch_flow", "cat": "serve",
                                   "pid": pid, "tid": 2, "ts": ts + 1})
    events.sort(key=lambda e: e.get("ts", 0))
    return events


def write_serve_trace(path: str, processes: list[dict]) -> None:
    """Write the serve-trace Perfetto file atomically (tmp + rename)."""
    doc = {"traceEvents": serve_trace_events(processes),
           "displayTimeUnit": "ms"}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


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
