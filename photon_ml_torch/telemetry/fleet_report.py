"""Fleet report: the per-host join of a multi-host training run.

Counterpart of ``photon_ml_tpu/telemetry/fleet_report.py``.
``python -m photon_ml_torch.telemetry fleet-report <host_logs...>`` joins
each host's ``run_log.jsonl`` (one a ``host_NNN/`` output subdir, from
either package) into the fleet view no single host's log can show:

- **Per-host rows**: chunks streamed, cross-host reductions
  (``fleet.psums``), barrier-wait seconds and their share of the host's
  streamed-pass time, peak RSS when the log carries it, and the host's
  own sweep odometer.
- **Barrier agreement**: every host must have taken the same number of
  reductions (the schedule pads ragged shards with sentinels so that it
  cannot differ); a mismatch means a host skipped or repeated one.
- **Fleet-wide sweep odometer**: solver state is replicated, so the
  hosts' odometers must agree, and each must reconcile on its own (the
  ``telemetry report`` identity).
- **Resume forensics**: hosts whose stitched logs hold several run
  segments (killed and restarted) are flagged with their
  ``fleet.seq_restored`` count.

The JAX package judges each host by its log's last run segment, which
for a restarted host counts only the reductions and sweeps after its
restore; its barrier and odometer checks then fail every resumed fleet.
The port's reducer also records the sequence number it reached (the
``fleet.seq`` gauge), and the barrier agreement compares that where a
log has it (else the reduction count, as the JAX package does); a
restarted host's partial odometer is left out of the agreement (it must
still reconcile on its own).  Logs of fleets that were not resumed get
the JAX package's verdict.

The last stdout line is one JSON object; exit code 1 when no fleet
counters are found, the barrier counts disagree, or the fleet-wide
odometer fails.
"""

from __future__ import annotations

import json
import os
import sys

from photon_ml_torch.telemetry.report import (
    _convergence,
    _phases,
    load_events,
    split_segments,
)


def load_host_logs(paths: list[str]) -> list[dict]:
    """Each path → one host record.  The last run segment is the record
    of record (a restarted host appends with a fresh header); the
    segment count is the restart evidence."""
    hosts = []
    for path in paths:
        segments = split_segments(load_events(path))
        events = segments[-1]
        header = next((e for e in events
                       if e.get("event") == "run_header"), None)
        summary = None
        for ev in events:
            if ev.get("event") == "telemetry_summary":
                summary = ev
        counters = (summary or {}).get("counters", {})
        derived = (summary or {}).get("derived", {})
        gauges = (summary or {}).get("gauges", {})
        host_id = (header or {}).get("fleet_host")
        if host_id is None:
            # A header without the fleet identity: fall back to the
            # host_NNN path convention the driver shards output by.
            for part in reversed(os.path.normpath(path).split(os.sep)):
                if part.startswith("host_") and part[5:].isdigit():
                    host_id = int(part[5:])
                    break
        seq = (gauges.get("fleet.seq") or {}).get("last")
        hosts.append({
            "name": os.path.basename(os.path.dirname(path)) or path,
            "path": path,
            "host": host_id,
            "n_hosts": (header or {}).get("fleet_hosts"),
            "transport": (header or {}).get("fleet_transport"),
            "run_id": (header or {}).get("run_id"),
            "segments": len(segments),
            "counters": counters,
            "derived": derived,
            "final_seq": None if seq is None else int(seq),
            "convergence": _convergence(events, counters),
            "phases": dict(_phases(events)),
            "peak_rss_mb": (gauges.get("proc.rss_mb") or {}).get("max"),
        })
    hosts.sort(key=lambda h: (h["host"] is None, h["host"]))
    return hosts


def _host_row(h: dict) -> dict:
    c = h["counters"]
    wait_s = float(c.get("fleet.barrier_wait_s", 0.0))
    # The barrier wait is measured inside the streamed pass, so the pass
    # spans are its denominator; the fit phase without span telemetry.
    pass_s = float(h["derived"].get("pass_span_total_s", 0.0)) or float(
        h["phases"].get("fit", 0.0))
    conv = h["convergence"] or {}
    reduces = int(c.get("fleet.psums", 0))
    return {
        "host": h["host"],
        "name": h["name"],
        "run_id": h["run_id"],
        "transport": h["transport"],
        "segments": h["segments"],
        "chunks_streamed": int(c.get("fleet.chunks_streamed", 0)),
        "reduces": reduces,
        "final_seq": (h["final_seq"] if h["final_seq"] is not None
                      else reduces),
        "barrier_wait_s": round(wait_s, 3),
        "barrier_wait_fraction": (round(wait_s / pass_s, 4)
                                  if pass_s > 0 else None),
        "seq_restored": int(c.get("fleet.seq_restored", 0)),
        "sweeps": conv.get("sweeps"),
        "passes_per_cycle": conv.get("passes_per_cycle"),
        "odometer_ok": conv.get("ok"),
        "peak_rss_mb": h["peak_rss_mb"],
    }


def analyze(hosts: list[dict]) -> dict:
    """The fleet join over loaded host logs (pure; the CLI renders it)."""
    rows = [_host_row(h) for h in hosts]
    fleet_rows = [r for r in rows if r["reduces"] > 0]
    reduce_counts = sorted({r["reduces"] for r in fleet_rows})
    seqs = sorted({r["final_seq"] for r in fleet_rows})
    barrier_agreement = len(seqs) <= 1
    odometers = sorted({(r["sweeps"], r["passes_per_cycle"])
                        for r in rows
                        if r["sweeps"] is not None and r["segments"] == 1})
    odometer_agreement = len(odometers) <= 1
    odometer_ok = all(r["odometer_ok"] is not False for r in rows)
    restarted = [r["host"] for r in rows if r["segments"] > 1]
    expected = next((h["n_hosts"] for h in hosts
                     if h["n_hosts"] is not None), None)
    ok = (bool(fleet_rows) and barrier_agreement
          and odometer_agreement and odometer_ok
          and (expected is None or len(rows) == expected))
    return {
        "ok": ok,
        "hosts": rows,
        "n_hosts": len(rows),
        "expected_hosts": expected,
        "total_chunks_streamed": sum(r["chunks_streamed"] for r in rows),
        "reduces": seqs[0] if barrier_agreement and seqs else None,
        "barrier_agreement": barrier_agreement,
        "reduce_counts": reduce_counts,
        "odometer_agreement": odometer_agreement,
        "odometer_ok": odometer_ok,
        "fleet_sweeps": odometers[0][0] if odometer_agreement and odometers
        else None,
        "passes_per_cycle": (odometers[0][1]
                             if odometer_agreement and odometers else None),
        "max_barrier_wait_fraction": max(
            (r["barrier_wait_fraction"] or 0.0 for r in rows),
            default=0.0),
        "max_peak_rss_mb": max(
            (r["peak_rss_mb"] for r in rows
             if r["peak_rss_mb"] is not None), default=None),
        "restarted_hosts": restarted,
    }


def run_fleet_report(paths: list[str], out=None) -> dict:
    """Load, analyze, print (a table and the JSON last line); ``ok``
    drives the exit code."""
    out = out or sys.stdout

    def w(s=""):
        print(s, file=out)

    hosts = load_host_logs(paths)
    result = analyze(hosts)

    w(f"Fleet report over {len(hosts)} host log(s):")
    w(f"  {'host':>4} {'chunks':>7} {'reduces':>8} {'wait_s':>8} "
      f"{'wait%':>6} {'sweeps':>7} {'p/cyc':>6} {'rss_mb':>8} "
      f"{'segs':>5}")
    for r in result["hosts"]:
        wf = r["barrier_wait_fraction"]
        host = r["host"] if r["host"] is not None else "?"
        sweeps = r["sweeps"] if r["sweeps"] is not None else "-"
        ppc = (r["passes_per_cycle"] if r["passes_per_cycle"] is not None
               else "-")
        rss = r["peak_rss_mb"] if r["peak_rss_mb"] is not None else "-"
        w(f"  {host:>4} {r['chunks_streamed']:>7} {r['reduces']:>8} "
          f"{r['barrier_wait_s']:>8.3f} "
          f"{(f'{wf:.1%}' if wf is not None else '-'):>6} "
          f"{sweeps:>7} {ppc:>6} {rss:>8} {r['segments']:>5}")
    w()
    if not any(r["reduces"] for r in result["hosts"]):
        w("No fleet counters found: these are not multi-host run logs, "
          "or the fleet never reduced.")
        w()
    if result["restarted_hosts"]:
        seqs = {r["host"]: r["seq_restored"] for r in result["hosts"]
                if r["segments"] > 1}
        w(f"Restarted host(s) {result['restarted_hosts']}: resumed from "
          f"per-host checkpoints (fleet.seq_restored per host: {seqs}) "
          "while peers held the barrier; judged by the sequence reached.")
        w()
    verdict = "PASS" if result["barrier_agreement"] else "FAIL"
    w(f"Barrier agreement: reduce counts {result['reduce_counts']}, "
      f"sequences reached "
      f"{sorted({r['final_seq'] for r in result['hosts']})} across "
      f"hosts -> {verdict}")
    odo = ("PASS" if result["odometer_agreement"] and result["odometer_ok"]
           else "FAIL")
    w("Fleet sweep odometer: "
      + (f"{result['fleet_sweeps']} data passes on every host, "
         f"passes/cycle {result['passes_per_cycle']}"
         if result["odometer_agreement"] else
         "hosts DISAGREE (replicated solver state has drifted)")
      + f" -> {odo}")
    if (result["expected_hosts"] is not None
            and result["expected_hosts"] != result["n_hosts"]):
        w(f"MISSING HOSTS: headers declare {result['expected_hosts']} "
          f"hosts, {result['n_hosts']} log(s) given.")
    w()
    print(json.dumps(result), file=out)
    return result
