"""Bench-history trajectory: ingest, aggregate, regression-gate.

Counterpart of ``photon_ml_tpu/telemetry/history.py``, host code over
JSON ported as it is: the same formats, metrics, baseline and flags.

``BENCH_r*.json`` records accumulate at the repo root — one per driver
round, one of which even recorded ``rc: 124`` — with no aggregation or
regression detection: a rows/s collapse of exactly the kind the bench
sections exist to catch would land silently.  This module turns a
directory (or explicit list) of bench records into a per-section,
per-metric TRAJECTORY and gates it:

- **Formats ingested** (all tolerated in one directory):
  the driver wrapper ``{"n", "cmd", "rc", "tail", "parsed"}`` (the
  repo's ``BENCH_r*.json``), the raw bench JSON-last-line record, and
  the ``--history-dir`` envelope ``{"schema", "kind": "bench_record",
  "argv", "record"}`` bench.py appends per run.  Files sort by name —
  the round order.
- **Metrics**: a fixed spec of (section, dotted path, direction) pairs
  covering the sections' numbers of record — throughput (examples/s,
  rows/s), pass-time and RSS ratios, overlap efficiency, warm-ETL
  speedup, retirement work fraction.  Missing values (older schemas,
  skipped sections) simply leave holes in the trajectory.
- **Regression detection**: each round's value is compared against a
  ROLLING BASELINE — the median of up to ``window`` preceding values —
  and flagged when it is worse (per the metric's direction) by more
  than ``tolerance`` (relative).  Any round whose wrapper recorded a
  nonzero rc is flagged unconditionally: a bench that died has no
  numbers to defend.
- **Output**: a markdown trajectory table + one JSON object as the
  last stdout line (the repo's CLI contract); exit code 1 on any
  regression or nonzero-rc round, 0 on a clean trajectory.
"""

from __future__ import annotations

import json
import os
import statistics

# A 20% worsening must gate (the bench contract test injects exactly
# that), so the default sits below it; host-jitter on the 2-core bench
# box measures ~±10% on pass times, comfortably inside.
DEFAULT_TOLERANCE = 0.15
DEFAULT_WINDOW = 3

# (section, dotted path into the bench record, direction).  Direction
# "higher" = a drop beyond tolerance regresses; "lower" = a rise does.
METRICS: tuple[tuple[str, str, str], ...] = (
    ("overall", "value", "higher"),                 # examples/s (GRR)
    ("overall", "step_ms_grr", "lower"),
    ("overall", "vs_baseline", "higher"),
    ("etl", "etl_grr_s", "lower"),
    ("cached", "cached.warm_speedup", "higher"),
    ("sweep", "sweep.speedup", "higher"),
    ("sweep", "sweep.pass_amortization", "higher"),
    ("stream", "stream.spilled.examples_per_sec", "higher"),
    ("stream", "stream.pass_time_ratio", "lower"),
    ("stream", "stream.spilled.rss_delta_mb", "lower"),
    ("stream", "stream.spilled.telemetry.overlap_efficiency", "higher"),
    ("score", "score.streamed.rows_per_sec", "higher"),
    ("score", "score.pass_time_ratio", "lower"),
    ("re", "re.streamed.rows_per_sec", "higher"),
    ("re", "re.sweep_time_ratio", "lower"),
    ("re", "re.retirement_work_fraction", "lower"),
    # Fused CD super-sweep: one store pass per cycle is THE
    # claim — passes/cycle creeping up, the fused pass slowing against
    # the legacy pass, or fused throughput dropping all gate.
    ("cd_fused", "cd_fused.passes_per_cycle_fused", "lower"),
    ("cd_fused", "cd_fused.pass_time_ratio", "lower"),
    ("cd_fused", "cd_fused.fused.rows_per_sec", "higher"),
    # Online serving: tail latency creeping up, sustained
    # throughput dropping, or micro-batch fill collapsing (the
    # batcher degenerating to single-row dispatches) all gate.
    ("serve", "serve.p99_ms", "lower"),
    ("serve", "serve.rows_per_sec", "higher"),
    ("serve", "serve.batch_fill", "higher"),
    # Resilient fleet: the SIGKILL arm's claims — failed
    # client requests must stay at zero (the retry-once contract) and
    # a killed replica's detect→respawn→re-warm→ready latency must not
    # creep.
    ("serve", "serve.failed_requests", "lower"),
    ("serve", "serve.restart_s", "lower"),
    # Request tracing: the stage medians the tracing tier
    # decomposes the tail into — queue wait creeping up means the
    # batcher is becoming the bottleneck, dispatch creeping up means
    # the device path regressed; both gate like every other metric.
    ("serve", "serve.queue_wait_ms", "lower"),
    ("serve", "serve.dispatch_ms", "lower"),
    # Multi-host out-of-core training: the sharded-streaming
    # claims — fleet throughput dropping, hosts stalling at the chunk
    # barrier, any host's peak RSS creeping toward its budget, or the
    # fleet-wide passes/cycle identity drifting above ~1 all gate.
    ("mesh_stream", "mesh_stream.rows_per_sec", "higher"),
    ("mesh_stream", "mesh_stream.barrier_wait_fraction", "lower"),
    ("mesh_stream", "mesh_stream.max_host_peak_rss_mb", "lower"),
    ("mesh_stream", "mesh_stream.passes_per_cycle", "lower"),
    # Streaming TRON: the second-order claim — total data
    # passes to tolerance creeping up (the pass advantage over
    # streaming L-BFGS eroding), streamed throughput dropping, or the
    # TRON arm's peak RSS growing (the HVP pass must stay as
    # store-bounded as the L-BFGS passes) all gate.
    ("tron", "tron.passes_to_tol", "lower"),
    ("tron", "tron.rows_per_sec", "higher"),
    ("tron", "tron.peak_rss_mb", "lower"),
)


def _dig(record: dict, path: str):
    cur = record
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur if isinstance(cur, (int, float)) else None


def load_round(path: str) -> dict:
    """One history file → ``{name, rc, record, header}``.

    Unreadable/unparseable files become rc-None rounds with no record
    (reported, never fatal — history is a forensic tool)."""
    name = os.path.basename(path)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return {"name": name, "rc": None, "record": None,
                "error": f"{type(e).__name__}: {e}", "header": None}
    if not isinstance(doc, dict):
        return {"name": name, "rc": None, "record": None,
                "error": "not a JSON object", "header": None}
    def _rc(value):
        # A wrapper that recorded "rc": null is the torn-run class
        # (BENCH_r05's cousin): normalize to None, which detect()
        # flags as a failed round instead of crashing the gate.
        if isinstance(value, bool) or not isinstance(value, int):
            return None
        return value

    if doc.get("kind") == "bench_record":        # --history-dir envelope
        header = {k: doc.get(k) for k in ("schema", "argv", "ts")
                  if k in doc}
        return {"name": name, "rc": _rc(doc.get("rc", 0)),
                "record": doc.get("record"), "header": header}
    if "rc" in doc and ("parsed" in doc or "tail" in doc):
        # Driver wrapper (the repo's BENCH_r*.json shape).
        return {"name": name, "rc": _rc(doc.get("rc", 0)),
                "record": doc.get("parsed"), "header": None}
    # Raw bench JSON-last-line record.
    return {"name": name, "rc": 0, "record": doc, "header": None}


def load_rounds(paths: list[str]) -> list[dict]:
    """Expand directories, sort by file name (round order), load."""
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(os.path.join(p, fn) for fn in sorted(os.listdir(p))
                         if fn.endswith(".json"))
        else:
            files.append(p)
    return [load_round(p) for p in files]


def trajectory(rounds: list[dict]) -> dict:
    """``{metric key: [value-or-None per round]}`` over the spec."""
    out: dict = {}
    for section, path, direction in METRICS:
        key = f"{section}:{path}"
        series = [(_dig(r["record"], path) if r["record"] else None)
                  for r in rounds]
        if any(v is not None for v in series):
            out[key] = {"direction": direction, "values": series}
    return out


def parse_known_bad(specs: list[str]) -> dict[str, str]:
    """``--known-bad ROUND=REASON`` flags → ``{round name: reason}``.

    The reason is REQUIRED: a waiver with no recorded "why"
    is how a real regression gets rubber-stamped next quarter — the
    gate echoes the reason in its markdown so the acknowledgment
    travels with every trajectory report."""
    out: dict[str, str] = {}
    for spec in specs:
        round_name, sep, reason = spec.partition("=")
        if not sep or not reason.strip() or not round_name.strip():
            raise ValueError(
                f"--known-bad needs ROUND=REASON (a reason is "
                f"required), got {spec!r}")
        out[round_name.strip()] = reason.strip()
    return out


def detect(rounds: list[dict], tolerance: float = DEFAULT_TOLERANCE,
           window: int = DEFAULT_WINDOW,
           known_bad: dict[str, str] | None = None) -> dict:
    """Regressions + failed rounds over the trajectory.

    A value regresses when it is worse than the rolling baseline (the
    median of up to ``window`` PRECEDING non-null values) by more than
    ``tolerance`` relative; the first valid value of a metric is its
    own baseline (never flagged).  Baselines at or below zero are
    skipped — a relative tolerance has no meaning there.

    ``known_bad`` (``--known-bad ROUND=REASON``): rounds
    whose failure is already acknowledged (BENCH_r05's rc-124 budget
    timeout is the resident case) move from ``failed_rounds``/
    ``regressions`` to ``waived`` and stop failing the gate; the
    waived round's values STILL feed later baselines exactly as
    before — the waiver silences the verdict, not the data."""
    known_bad = known_bad or {}
    traj = trajectory(rounds)
    regressions = []
    for key, ent in traj.items():
        vals = ent["values"]
        higher = ent["direction"] == "higher"
        seen: list[float] = []
        for i, v in enumerate(vals):
            if v is None:
                continue
            if seen:
                base = statistics.median(seen[-window:])
                if base > 0:
                    change = (v - base) / base
                    if (-change if higher else change) > tolerance:
                        regressions.append({
                            "round": rounds[i]["name"],
                            "metric": key,
                            "value": v,
                            "baseline": round(base, 6),
                            "change": round(change, 4),
                            "direction": ent["direction"],
                        })
            seen.append(v)
    failed = [{"round": r["name"], "rc": r["rc"],
               **({"error": r["error"]} if r.get("error") else {})}
              for r in rounds if r["rc"] not in (0,)]
    waived = ([{**f, "reason": known_bad[f["round"]]}
               for f in failed if f["round"] in known_bad]
              + [{**reg, "reason": known_bad[reg["round"]]}
                 for reg in regressions if reg["round"] in known_bad])
    failed = [f for f in failed if f["round"] not in known_bad]
    regressions = [reg for reg in regressions
                   if reg["round"] not in known_bad]
    round_names = {r["name"] for r in rounds}
    unknown_waivers = sorted(set(known_bad) - round_names)
    return {
        "ok": not regressions and not failed,
        "rounds": [r["name"] for r in rounds],
        "trajectory": traj,
        "regressions": regressions,
        "failed_rounds": failed,
        "waived": waived,
        "unknown_waivers": unknown_waivers,
        "tolerance": tolerance,
        "window": window,
    }


def render_markdown(result: dict, out) -> None:
    """The human half of the contract: a per-metric trajectory table
    with the newest round last, regressions and dead rounds called
    out."""
    w = lambda s="": print(s, file=out)
    rounds = result["rounds"]
    w(f"# Bench history ({len(rounds)} rounds, tolerance "
      f"{result['tolerance']:.0%}, window {result['window']})")
    w()
    if rounds:
        w("| metric | dir | " + " | ".join(rounds) + " |")
        w("|---" * (len(rounds) + 2) + "|")
        for key, ent in result["trajectory"].items():
            cells = ["-" if v is None else f"{v:g}"
                     for v in ent["values"]]
            arrow = "↑" if ent["direction"] == "higher" else "↓"
            w(f"| {key} | {arrow} | " + " | ".join(cells) + " |")
        w()
    for fr in result["failed_rounds"]:
        w(f"**FAILED ROUND** {fr['round']}: rc={fr['rc']}"
          + (f" ({fr['error']})" if fr.get("error") else ""))
    for wv in result.get("waived", []):
        what = (f"rc={wv['rc']}" if "rc" in wv
                else f"{wv['metric']}: {wv['value']:g} "
                     f"({wv['change']:+.1%})")
        w(f"**WAIVED** {wv['round']} ({what}) — known bad: "
          f"{wv['reason']}")
    for name in result.get("unknown_waivers", []):
        w(f"**UNKNOWN WAIVER** --known-bad {name} matches no loaded "
          "round (typo, or the round was removed)")
    for reg in result["regressions"]:
        w(f"**REGRESSION** {reg['round']} {reg['metric']}: "
          f"{reg['value']:g} vs baseline {reg['baseline']:g} "
          f"({reg['change']:+.1%}, want "
          f"{'higher' if reg['direction'] == 'higher' else 'lower'})")
    if result["ok"]:
        w("Trajectory clean: no regressions, no failed rounds.")
    w()


def run_history(paths: list[str], tolerance: float = DEFAULT_TOLERANCE,
                window: int = DEFAULT_WINDOW, out=None,
                known_bad: dict[str, str] | None = None) -> dict:
    """Load → detect → print (markdown + JSON last line); returns the
    result dict (``ok`` drives the exit code)."""
    import sys

    out = out or sys.stdout
    rounds = load_rounds(paths)
    result = detect(rounds, tolerance=tolerance, window=window,
                    known_bad=known_bad)
    render_markdown(result, out)
    print(json.dumps(result), file=out)
    return result
