"""Telemetry CLI: ``python -m photon_ml_torch.telemetry <report|history>``.

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

``watch`` (the live monitor, ROADMAP D3), ``serve-report`` (request
tracing, D4) and ``fleet-report`` (multi-host, A7) are not ported: they
exit with an error naming their item.

Every subcommand prints one JSON object as its last stdout line.
"""

from __future__ import annotations

import argparse
import sys

from photon_ml_torch.telemetry.history import (
    DEFAULT_TOLERANCE,
    DEFAULT_WINDOW,
    parse_known_bad,
    run_history,
)
from photon_ml_torch.telemetry.report import report

_NOT_PORTED = {
    "watch": "the live monitor (ROADMAP D3)",
    "serve-report": "request tracing (ROADMAP D4)",
    "fleet-report": "the multi-host fleet (ROADMAP A7)",
}


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
    for cmd, what in _NOT_PORTED.items():
        sp = sub.add_parser(cmd, help=f"not ported: {what}")
        sp.add_argument("rest", nargs="*")
    args = p.parse_args(argv)
    if args.cmd in _NOT_PORTED:
        p.error(f"'{args.cmd}' is {_NOT_PORTED[args.cmd]}, not ported to "
                "photon_ml_torch yet")
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
