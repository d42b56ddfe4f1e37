"""Serve-report: the request-latency decomposition of serving run logs.

Counterpart of ``photon_ml_tpu/telemetry/serve_report.py``; either
package's report reads either package's logs.
``python -m photon_ml_torch.telemetry serve-report <logs...>`` joins the
kept request traces BY TRACE ID across processes (a frontend's
``request_trace`` events with its route / forward / retry stages, each
replica's with admission / queue-wait / serialize / write and the
linked ``batch_trace``'s assemble / store-lookup / dispatch / d2h) and
prints:

- **Stage table**: p50/p99/count per stage, each over its own basis
  (frontend stages over frontend records, request stages over replica
  records, batch stages over batch records).
- **Tail attribution**: every kept TAIL request (above the recorder's
  threshold) goes to its DOMINANT stage: its own queue wait, the linked
  batch's shared work, or a frontend's retry cost.
- **Retry cost**: requests with failed forward attempts and what those
  attempts cost.
- **Join check**: the share of replica tail records with a frontend
  record; below ``--join-threshold`` (default 0.99) the report fails.
- ``--trace-out trace.json``: the joined timeline as a Chrome trace with
  flow events (``telemetry.export.serve_trace_events``).

With one server's log (no frontend records), the stage table and the
tail attribution print and the join check is N/A.  The last stdout line
is one JSON object; rc 1 when no trace record is found or the join
check fails.
"""

from __future__ import annotations

import json
import os
import sys

from photon_ml_torch.serving.tracing import (
    ALL_STAGES,
    BATCH_STAGES,
    FRONTEND_STAGES,
    REQUEST_STAGES,
)
from photon_ml_torch.telemetry.report import load_events

DEFAULT_JOIN_THRESHOLD = 0.99


def _percentile(sorted_vals: list, q: float):
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def load_trace_files(paths: list[str]) -> list[dict]:
    """Each path → one process record: ``{name, path, requests,
    batches, roles}``.  Request/batch records are the ``TraceRecorder``
    JSONL event bodies; every segment of a stitched log contributes
    (a restarted replica's traces all count)."""
    processes = []
    for path in paths:
        events = load_events(path)
        requests = [ev for ev in events
                    if ev.get("event") == "request_trace"]
        batches = [ev for ev in events
                   if ev.get("event") == "batch_trace"]
        header = next((ev for ev in events
                       if ev.get("event") == "run_header"), None)
        name = os.path.basename(path)
        roles = sorted({r.get("role", "?") for r in requests})
        processes.append({
            "name": name, "path": path, "requests": requests,
            "batches": batches, "roles": roles,
            "run_id": (header or {}).get("run_id"),
        })
    return processes


def _attribution(rec: dict, batch: dict | None,
                 front: dict | None) -> dict:
    """One replica-side request's full stage attribution (ms): its own
    stages, the linked batch's shared stages, the joined frontend
    record's retry cost, and the residual neither claims."""
    out: dict = {}
    for stage, ms in (rec.get("stages_ms") or {}).items():
        out[stage] = out.get(stage, 0.0) + ms
    if batch is not None:
        for stage, ms in (batch.get("stages_ms") or {}).items():
            out[stage] = out.get(stage, 0.0) + ms
    total = float(rec.get("total_ms", 0.0))
    if front is not None:
        fr = (front.get("stages_ms") or {})
        if fr.get("retry"):
            out["retry"] = out.get("retry", 0.0) + fr["retry"]
        total = float(front.get("total_ms", total))
    residual = total - sum(out.values())
    if residual > 0:
        # Time neither a request stage nor the shared batch claims:
        # network + dispatcher-loop + handler scheduling.  Kept visible
        # so a creeping unattributed gap cannot hide.
        out["other"] = residual
    return out


def analyze(processes: list[dict],
            join_threshold: float = DEFAULT_JOIN_THRESHOLD) -> dict:
    """The decomposition over loaded trace files (pure; the CLI wraps
    it with rendering)."""
    frontend_by_trace: dict = {}
    replica_recs: list[tuple[int, dict]] = []
    frontend_recs: list[dict] = []
    for i, proc in enumerate(processes):
        for rec in proc["requests"]:
            if rec.get("role") == "frontend":
                frontend_recs.append(rec)
                frontend_by_trace.setdefault(rec.get("trace"), rec)
            else:
                replica_recs.append((i, rec))
    batch_by_proc = [
        {b.get("batch"): b for b in proc["batches"]}
        for proc in processes
    ]

    # Stage table: each stage over its natural basis.
    stage_vals: dict[str, list] = {}

    def fold(rec, stages):
        for stage in stages:
            ms = (rec.get("stages_ms") or {}).get(stage)
            if ms is not None:
                stage_vals.setdefault(stage, []).append(ms)

    for rec in frontend_recs:
        fold(rec, FRONTEND_STAGES)
    for _i, rec in replica_recs:
        fold(rec, REQUEST_STAGES)
    for proc in processes:
        for b in proc["batches"]:
            fold(b, BATCH_STAGES)
    stages_out = {}
    for stage in list(ALL_STAGES) + ["other"]:
        vals = sorted(stage_vals.get(stage, []))
        if vals:
            stages_out[stage] = {
                "count": len(vals),
                "p50_ms": round(_percentile(vals, 0.50), 3),
                "p99_ms": round(_percentile(vals, 0.99), 3),
                "max_ms": round(vals[-1], 3),
            }

    # Tail attribution + the cross-process join.
    tail = [(i, rec) for i, rec in replica_recs
            if rec.get("sampled") == "tail"]
    joined = 0
    dominant_counts: dict[str, int] = {}
    slowest: list[dict] = []
    for i, rec in tail:
        front = frontend_by_trace.get(rec.get("trace"))
        if front is not None:
            joined += 1
        batch = (batch_by_proc[i].get(rec.get("batch"))
                 if rec.get("batch") is not None else None)
        attr = _attribution(rec, batch, front)
        dom = max(attr, key=attr.get) if attr else "other"
        dominant_counts[dom] = dominant_counts.get(dom, 0) + 1
        slowest.append({
            "trace": rec.get("trace"),
            "total_ms": round(float((front or rec).get("total_ms", 0.0)),
                              3),
            "dominant": dom,
            "dominant_ms": round(attr.get(dom, 0.0), 3),
            "joined": front is not None,
            **({"retry_ms": round(attr["retry"], 3)}
               if attr.get("retry") else {}),
        })
    slowest.sort(key=lambda r: -r["total_ms"])

    # Retry cost (frontend records with failed forward attempts).
    retried = [r for r in frontend_recs
               if any(str(a.get("outcome", "")).startswith("connect_fail")
                      for a in r.get("attempts", ()))]
    retry_ms = sorted((r.get("stages_ms") or {}).get("retry", 0.0)
                      for r in retried)
    join_fraction = (round(joined / len(tail), 4) if tail
                     and frontend_recs else None)
    sampled_total = len(replica_recs) + len(frontend_recs)
    ok = sampled_total > 0 and (join_fraction is None
                                or join_fraction >= join_threshold)
    dominant = (max(dominant_counts, key=dominant_counts.get)
                if dominant_counts else None)
    return {
        "ok": ok,
        "processes": [{k: p[k] for k in
                       ("name", "run_id", "roles")}
                      | {"requests": len(p["requests"]),
                         "batches": len(p["batches"])}
                      for p in processes],
        "sampled_requests": sampled_total,
        "frontend_requests": len(frontend_recs),
        "replica_requests": len(replica_recs),
        "tail_requests": len(tail),
        "joined": joined,
        "join_fraction": join_fraction,
        "join_threshold": join_threshold,
        "stages": stages_out,
        "dominant_counts": dominant_counts,
        "dominant_stage": dominant,
        "retried_requests": len(retried),
        "retry_cost_ms": {
            "count": len(retry_ms),
            "total": round(sum(retry_ms), 3),
            "max": round(retry_ms[-1], 3) if retry_ms else None,
        },
        "slowest": slowest[:10],
    }


def run_serve_report(paths: list[str],
                     join_threshold: float = DEFAULT_JOIN_THRESHOLD,
                     trace_out: str | None = None, out=None) -> dict:
    """Load → analyze → print (tables + JSON last line); ``ok`` drives
    the exit code."""
    out = out or sys.stdout
    w = lambda s="": print(s, file=out)
    processes = load_trace_files(paths)
    result = analyze(processes, join_threshold=join_threshold)

    w(f"Serve trace report over {len(processes)} process log(s):")
    for p in result["processes"]:
        w(f"  {p['name']}: {p['requests']} request traces "
          f"({'/'.join(p['roles']) or 'none'}), {p['batches']} batch "
          f"traces")
    w()
    if result["sampled_requests"] == 0:
        w("No request_trace events found — tracing off, or the logs "
          "are not serving run logs.")
    if result["stages"]:
        w("Stage latency (sampled requests; batch stages once per "
          "micro-batch):")
        w(f"  {'stage':<14} {'count':>7} {'p50_ms':>9} {'p99_ms':>9} "
          f"{'max_ms':>9}")
        for stage, ent in result["stages"].items():
            w(f"  {stage:<14} {ent['count']:>7} {ent['p50_ms']:>9.3f} "
              f"{ent['p99_ms']:>9.3f} {ent['max_ms']:>9.3f}")
        w()
    if result["tail_requests"]:
        w(f"Tail attribution ({result['tail_requests']} tail "
          f"request(s)):")
        for stage, n in sorted(result["dominant_counts"].items(),
                               key=lambda kv: -kv[1]):
            w(f"  dominant {stage}: {n} "
              f"({n / result['tail_requests']:.0%})")
        for rec in result["slowest"][:5]:
            w(f"  {rec['trace']}: {rec['total_ms']} ms, dominant "
              f"{rec['dominant']} ({rec['dominant_ms']} ms)"
              + (f", retry {rec['retry_ms']} ms"
                 if rec.get("retry_ms") else "")
              + ("" if rec["joined"] else " [unjoined]"))
        w()
    if result["retried_requests"]:
        rc = result["retry_cost_ms"]
        w(f"Retry cost: {result['retried_requests']} request(s) with "
          f"failed forward attempts; {rc['total']} ms total, "
          f"{rc['max']} ms worst.")
        w()
    if result["join_fraction"] is not None:
        ok = result["join_fraction"] >= join_threshold
        w(f"Cross-process join: {result['joined']}/"
          f"{result['tail_requests']} tail requests matched a frontend "
          f"trace ({result['join_fraction']:.1%}) "
          f"{'>=' if ok else '<'} threshold {join_threshold:.0%} "
          f"-> {'PASS' if ok else 'FAIL'}")
        w()
    if trace_out is not None:
        from photon_ml_torch.telemetry.export import write_serve_trace

        write_serve_trace(trace_out, processes)
        result["trace_out"] = trace_out
        w(f"Perfetto flow trace written to {trace_out} (load in "
          "https://ui.perfetto.dev).")
        w()
    print(json.dumps(result), file=out)
    return result
