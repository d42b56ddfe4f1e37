"""Live run watch: follow a still-being-written ``run_log.jsonl``.

Counterpart of ``photon_ml_tpu/telemetry/watch.py``.
``python -m photon_ml_torch.telemetry watch <run_log.jsonl>`` renders a
refreshing status view of a RUNNING fit, scoring pass or server from
its log (torn-tail tolerant; the LAST ``run_header`` segment is the
live one):

- **Phase**: the innermost driver phase still open.
- **Progress**: the newest ``progress`` event per stage (done/total,
  unit, rolling rate, ETA); the most recently updated stage leads and
  its ETA is the headline ``eta_s``.
- **Loss trajectory**: recent progress losses per stage and the last
  swept ``convergence_iter``'s per-lane values.
- **Serve stages**: the newest serve progress event's per-stage
  p50/p99 (request tracing) and the dominant stage.
- **Reliability**: heartbeats per stage, ``thread_exception`` events,
  segment and torn-line counts.
- **Alerts**: every ``alert`` event so far (latched per rule × stage).

``--once`` prints one snapshot and exits; either mode ends with one
JSON object as the last stdout line.  Follow mode refreshes every
``--interval`` seconds and exits when the run logs its ``done`` event
(or on Ctrl-C, or after ``--max-wait-s``).
"""

from __future__ import annotations

import json
import sys
import time

from photon_ml_torch.telemetry.report import load_events, split_segments

DEFAULT_INTERVAL_S = 2.0
# Recent-loss trajectory kept per stage (one point per snapshot-cadence
# progress event — minutes of run at the default cadence).
_LOSS_TRAJECTORY_CAP = 32


def snapshot(path: str) -> dict:
    """One JSON-ready snapshot of a (possibly live) run log."""
    all_events = load_events(path)
    segments = split_segments(all_events)
    events = segments[-1]

    header = next((e for e in events if e.get("event") == "run_header"),
                  None)
    open_phases: list[dict] = []
    phases_done: list[dict] = []
    stages: dict[str, dict] = {}
    losses: dict[str, list] = {}
    lanes: dict | None = None
    alerts: list[dict] = []
    beats: dict[str, int] = {}
    deaths: list[dict] = []
    done_event = None
    last_t = 0.0
    for ev in events:
        kind = ev.get("event")
        t = ev.get("t")
        if isinstance(t, (int, float)):
            last_t = max(last_t, float(t))
        if kind == "phase_start":
            open_phases.append({"phase": ev.get("phase", "?"),
                                "t": ev.get("t")})
        elif kind == "phase_end":
            name = ev.get("phase")
            for i in range(len(open_phases) - 1, -1, -1):
                if open_phases[i]["phase"] == name:
                    del open_phases[i]
                    break
            phases_done.append({"phase": name,
                                "duration_s": ev.get("duration_s")})
        elif kind == "progress":
            stage = ev.get("stage", "?")
            stages[stage] = {k: v for k, v in ev.items()
                             if k not in ("event",)}
            if ev.get("loss") is not None:
                traj = losses.setdefault(stage, [])
                traj.append(ev["loss"])
                del traj[:-_LOSS_TRAJECTORY_CAP]
        elif kind == "convergence_iter" and "values" in ev:
            # Swept solve: the per-lane loss vector (telemetry-on runs).
            lanes = {"label": ev.get("label", ""),
                     "iteration": ev.get("iteration"),
                     "values": ev.get("values")}
        elif kind == "alert":
            alerts.append({k: v for k, v in ev.items()
                           if k not in ("event",)})
        elif kind == "heartbeat":
            beats[ev.get("stage", "?")] = beats.get(
                ev.get("stage", "?"), 0) + 1
        elif kind == "thread_exception":
            deaths.append({"stage": ev.get("stage"),
                           "error": ev.get("error"),
                           "thread": ev.get("thread")})
        elif kind == "done":
            done_event = ev

    current = None
    for name, st in stages.items():
        if current is None or (st.get("t") or 0) > (
                stages[current].get("t") or 0):
            current = name
    # The newest serve progress event carries the request-tracing
    # tier's per-stage p50/p99; the dominant stage has the largest p99.
    serve_stages = (stages.get("serve") or {}).get("stages_ms") or None
    dominant = None
    if serve_stages:
        best = max(((s, e.get("p99_ms")) for s, e in serve_stages.items()
                    if e.get("p99_ms") is not None),
                   key=lambda kv: kv[1], default=None)
        if best is not None:
            dominant = {"stage": best[0], "p99_ms": best[1]}
    torn = sum(1 for ev in all_events
               if ev.get("event") == "_malformed_line")
    return {
        "log": path,
        "live": done_event is None,
        "segments": len(segments),
        "run_id": (header or {}).get("run_id"),
        "phase": (open_phases[-1]["phase"] if open_phases else None),
        "phases_done": phases_done,
        "stages": stages,
        "current_stage": current,
        "eta_s": (stages[current].get("eta_s")
                  if current is not None else None),
        "loss": (stages[current].get("loss")
                 if current is not None else None),
        "losses": losses,
        "lanes": lanes,
        "serve_stages": serve_stages,
        "serve_dominant": dominant,
        "alerts": alerts,
        "heartbeats": beats,
        "thread_exceptions": deaths,
        "torn_lines": torn,
        "last_event_t": round(last_t, 3),
        "events": len(events),
    }


def _fmt_eta(eta) -> str:
    if eta is None:
        return "-"
    eta = float(eta)
    if eta >= 3600:
        return f"{eta / 3600:.1f}h"
    if eta >= 60:
        return f"{eta / 60:.1f}m"
    return f"{eta:.0f}s"


def render(snap: dict, out=None) -> None:
    """The human half: one status view of a snapshot."""
    out = out or sys.stdout
    w = lambda s="": print(s, file=out)
    state = "RUNNING" if snap["live"] else "FINISHED"
    head = f"run {snap['run_id'] or '?'} [{state}]"
    if snap["segments"] > 1:
        head += f" (segment {snap['segments']} of a resumed run)"
    w(head)
    w(f"  phase: {snap['phase'] or '-'}   last event t="
      f"{snap['last_event_t']}s   events: {snap['events']}"
      + (f"   torn lines: {snap['torn_lines']}"
         if snap["torn_lines"] else ""))
    if snap["stages"]:
        w("  progress:")
        w(f"    {'stage':<18} {'done':>10} {'total':>10} {'unit':<8} "
          f"{'rate/s':>9} {'eta':>6}  loss")
        for name, st in sorted(snap["stages"].items(),
                               key=lambda kv: -(kv[1].get("t") or 0)):
            total = st.get("total")
            rate = st.get("rate")
            loss = st.get("loss")
            marker = " <- current" if name == snap["current_stage"] else ""
            w(f"    {name:<18} {st.get('done', 0):>10g} "
              f"{(f'{total:g}' if total is not None else '-'):>10} "
              f"{st.get('unit', '?'):<8} "
              f"{(f'{rate:g}' if rate is not None else '-'):>9} "
              f"{_fmt_eta(st.get('eta_s')):>6}  "
              f"{(f'{loss:.6g}' if loss is not None else '-')}"
              f"{marker}")
    for stage, traj in snap["losses"].items():
        if len(traj) > 1:
            w(f"  loss[{stage}]: "
              + " -> ".join(f"{v:.6g}" for v in traj[-6:]))
    if snap["lanes"]:
        vals = snap["lanes"]["values"]
        w(f"  lanes[{snap['lanes']['label'] or 'swept'}] iter "
          f"{snap['lanes']['iteration']}: "
          + " ".join(f"{v:.6g}" for v in vals))
    if snap.get("serve_stages"):
        w("  serve stages (request tracing):")
        w(f"    {'stage':<14} {'count':>7} {'p50_ms':>9} {'p99_ms':>9}")
        for stage, ent in snap["serve_stages"].items():
            p50 = ent.get("p50_ms")
            p99 = ent.get("p99_ms")
            w(f"    {stage:<14} {ent.get('count', 0):>7} "
              f"{(f'{p50:.3f}' if p50 is not None else '-'):>9} "
              f"{(f'{p99:.3f}' if p99 is not None else '-'):>9}")
        dom = snap.get("serve_dominant")
        if dom:
            w(f"    dominant stage: {dom['stage']} "
              f"(p99 {dom['p99_ms']:.3f} ms)")
    if snap["heartbeats"]:
        w("  heartbeats: " + ", ".join(
            f"{s}={n}" for s, n in sorted(snap["heartbeats"].items())))
    for d in snap["thread_exceptions"]:
        w(f"  DIED {d['stage']}: {d['error']} (thread {d['thread']})")
    if snap["alerts"]:
        w("  ALERTS:")
        for a in snap["alerts"]:
            stage = f" ({a['stage']})" if a.get("stage") else ""
            w(f"    [{a.get('severity', 'warn')}] "
              f"{a.get('rule', '?')}{stage}: {a.get('message', '')}")
    else:
        w("  alerts: none")


def watch(path: str, once: bool = False,
          interval_s: float = DEFAULT_INTERVAL_S,
          max_wait_s: float | None = None, out=None) -> dict:
    """Render ``path`` until its run finishes (or ``--once``); the
    returned snapshot is also printed as the JSON last line.

    ``max_wait_s`` bounds follow mode for scripted callers: a log that
    stops growing without a ``done`` event (a killed run) must not
    watch forever."""
    out = out or sys.stdout
    if interval_s <= 0:
        raise ValueError(f"interval_s must be positive, got {interval_s!r}")
    snap = snapshot(path)
    render(snap, out)
    if not once:
        deadline = (time.monotonic() + max_wait_s
                    if max_wait_s is not None else None)
        try:
            while snap["live"]:
                if deadline is not None and time.monotonic() >= deadline:
                    break
                time.sleep(interval_s)
                snap = snapshot(path)
                # ANSI home+clear between refreshes keeps the view in
                # place on a terminal; piped output just accumulates
                # frames (the JSON line is still last).
                if out is sys.stdout and sys.stdout.isatty():
                    print("\x1b[H\x1b[2J", end="", file=out)
                render(snap, out)
        except KeyboardInterrupt:  # photon-lint: disable=swallowed-exception (operator detach: the final JSON line still prints)
            pass
    print(json.dumps(snap), file=out)
    return snap
