"""Telemetry CLI: ``python -m photon_ml_torch.telemetry
<report|history|watch|serve-report|fleet-report>``.

Counterpart of ``photon_ml_tpu/telemetry/__main__.py``.

``report <log>`` prints the phase / stage-span / overlap / convergence /
device / reconciliation report of a run's ``run_log.jsonl`` (see
``telemetry.report``); exit code 1 when the span reconciliation or the
sweep-odometer check fails.

``history <dir-or-files...>`` ingests bench records (``BENCH_r*.json``
wrappers, raw records, ``--history-dir`` envelopes) into per-section
metric trajectories gated against a rolling baseline (see
``telemetry.history``); exit code 1 on a regression or on a round with a
nonzero rc not waived by ``--known-bad``.

``watch <log>`` follows a live run log: phase, per-stage progress and
ETA, loss trajectory, serve stages, reliability counters and alerts,
until the run logs ``done`` (or ``--once`` for one snapshot); exit code
1 when the log holds a ``thread_exception`` (see ``telemetry.watch``).

``serve-report <logs...>`` joins serving run logs' request traces by
trace id into the stage-latency decomposition (p50/p99 a stage, tail
attribution, retry cost), optionally with a Perfetto flow trace
(``--trace-out``); exit code 1 when no trace record is found or the
cross-process join falls below ``--join-threshold`` (see
``telemetry.serve_report``).

``fleet-report <host_logs...>`` joins a multi-host training run's
per-host ``run_log.jsonl`` files into one fleet view: per-host chunk,
reduce and barrier-wait rows, the barrier agreement (every host took the
same reductions) and the fleet-wide sweep odometer; exit code 1 on any
disagreement (see ``telemetry.fleet_report``).

Every subcommand prints one JSON object as its last stdout line.
"""

from __future__ import annotations

import argparse
import sys

from photon_ml_torch.telemetry import fleet_report as fleet_report_mod
from photon_ml_torch.telemetry import serve_report as serve_report_mod
from photon_ml_torch.telemetry import watch as watch_mod
from photon_ml_torch.telemetry.history import (
    DEFAULT_TOLERANCE,
    DEFAULT_WINDOW,
    parse_known_bad,
    run_history,
)
from photon_ml_torch.telemetry.report import report

def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m photon_ml_torch.telemetry",
        description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser(
        "report", help="per-phase wall-clock tables, prefetcher overlap "
                       "efficiency, convergence and device accounting, "
                       "and the reconciliation checks")
    rp.add_argument("log", help="path to a run_log.jsonl")
    rp.add_argument("--threshold", type=float, default=0.9,
                    help="reconciliation pass threshold (default 0.9)")
    hp = sub.add_parser(
        "history", help="bench-record trajectory: aggregate rounds, "
                        "gate regressions against a rolling baseline")
    hp.add_argument("paths", nargs="+",
                    help="history directory or bench JSON files")
    hp.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE,
                    help="relative worsening against the rolling "
                         "baseline that counts as a regression (default "
                         f"{DEFAULT_TOLERANCE})")
    hp.add_argument("--window", type=int, default=DEFAULT_WINDOW,
                    help="rolling-baseline width in preceding rounds "
                         f"(default {DEFAULT_WINDOW})")
    hp.add_argument("--known-bad", action="append", default=[],
                    metavar="ROUND=REASON",
                    help="waive an acknowledged bad round; the reason is "
                         "required and echoed. Repeatable.")
    wp = sub.add_parser(
        "watch", help="follow a live run_log.jsonl: phase, per-stage "
                      "progress/ETA, loss trajectory, alerts; exits "
                      "when the run logs its done event")
    wp.add_argument("log", help="path to a (possibly still-being-"
                                "written) run_log.jsonl")
    wp.add_argument("--once", action="store_true",
                    help="print one snapshot and exit (the JSON last "
                         "line is the snapshot)")
    wp.add_argument("--interval", type=float,
                    default=watch_mod.DEFAULT_INTERVAL_S,
                    help="refresh cadence in seconds (default "
                         f"{watch_mod.DEFAULT_INTERVAL_S})")
    wp.add_argument("--max-wait-s", type=float, default=None,
                    help="stop following after this many seconds "
                         "without a done event")
    sp = sub.add_parser(
        "serve-report",
        help="join request traces by trace id into a stage-latency "
             "decomposition (p50/p99 per stage, retry cost, dominant "
             "stage per tail request)")
    sp.add_argument("logs", nargs="+",
                    help="serving run logs (a frontend's and each "
                         "replica's; one server's log also works, the "
                         "join check is then N/A)")
    sp.add_argument("--join-threshold", type=float,
                    default=serve_report_mod.DEFAULT_JOIN_THRESHOLD,
                    help="minimum share of replica tail requests that "
                         "must match a frontend trace (default "
                         f"{serve_report_mod.DEFAULT_JOIN_THRESHOLD})")
    sp.add_argument("--trace-out", default=None,
                    help="also write a Perfetto-loadable Chrome trace "
                         "with cross-process flow events here")
    fp = sub.add_parser(
        "fleet-report",
        help="join a multi-host training run's per-host run logs into "
             "one fleet view: per-host chunk/reduce/barrier-wait rows, "
             "the barrier-agreement check, and the fleet-wide sweep "
             "odometer")
    fp.add_argument("logs", nargs="+",
                    help="per-host run logs (each host_NNN/ output "
                         "subdir's run_log.jsonl)")
    args = p.parse_args(argv)
    if args.cmd == "fleet-report":
        result = fleet_report_mod.run_fleet_report(args.logs)
        return 0 if result["ok"] else 1
    if args.cmd == "serve-report":
        result = serve_report_mod.run_serve_report(
            args.logs, join_threshold=args.join_threshold,
            trace_out=args.trace_out)
        return 0 if result["ok"] else 1
    if args.cmd == "watch":
        snap = watch_mod.watch(args.log, once=args.once,
                               interval_s=args.interval,
                               max_wait_s=args.max_wait_s)
        return 0 if not snap["thread_exceptions"] else 1
    if args.cmd == "history":
        try:
            waivers = parse_known_bad(args.known_bad)
        except ValueError as e:
            p.error(str(e))
        result = run_history(args.paths, tolerance=args.tolerance,
                             window=args.window, known_bad=waivers)
        return 0 if result["ok"] else 1
    result = report(args.log, threshold=args.threshold)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
