"""Telemetry report: per-phase tables, overlap efficiency, convergence
and device accounting, and the reconciliation checks over a
``run_log.jsonl``.

Counterpart of ``photon_ml_tpu/telemetry/report.py``, and it reads that
package's logs as that package's report reads this one's (the run log
is a shared on-disk format).  ``python -m photon_ml_torch.telemetry
report <run_log.jsonl>`` prints:

- **Header**: the ``run_header`` event (run id, argv, torch and CUDA
  versions and the card, or jax's fields in the reference's logs,
  telemetry mode) when present; older logs have none.
- **Phases**: the RunLogger ``phase_start``/``phase_end`` wall-clock
  table.
- **Stage spans**: per-name duration statistics from the
  ``telemetry_summary`` event (count, total, mean, share).
- **Prefetcher**: overlap efficiency (the fraction of streamed pass
  time the consumer was not blocked on the prefetch queue), producer
  stall, and the LRU hit and disk-load counters.
- **Convergence**: per-solver iteration totals from the
  ``convergence_iter``/``convergence_trace`` events, streamed
  random-effect dynamics, and the sweep-odometer identity: every
  streamed data pass is claimed by one bucket (``solver.sweeps ==
  streamed_solves + ls_trials + grad_recovery_sweeps + aux_sweeps +
  hvp_sweeps + fused_cycle_sweeps``); a violated identity fails the
  report.
- **Device**: each captured program's analytic flops and bytes, its
  roofline, and the measured time a chunk beside it, with the clock it
  came from: ``stream_interval`` (the device clock between the CUDA
  events at the edges of each ``chunk_compute``, from a stream the
  chunk's fence has drained: its kernels plus the host's dispatch of
  them) or ``host`` (a host clock: the dispatch histogram or the span
  mean, which on the card time launches, not kernels).  The roofline
  share is given only where the measured time is the work's own: a
  host clock on a CPU program, which runs synchronously.  Neither a
  stream interval nor a launch time on an accelerator is one.
- **Liveness**: heartbeat counts a stage and any ``thread_exception``.
- **Reconciliation**: for each thread with trace spans, the fraction of
  its wall clock (first depth-0 span start → last depth-0 span end)
  covered by depth-0 spans; the check passes when the busiest thread
  covers at least ``--threshold`` (default 0.9).

The last stdout line is one JSON object; the exit code is 1 when the
reconciliation or the odometer check fails.
"""

from __future__ import annotations

import json
import sys


def load_events(path: str) -> list[dict]:
    """Parse a run log, tolerating a torn tail: a killed run (the
    report's primary forensic case) can leave a partial final line —
    malformed lines are skipped, not fatal."""
    out = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                out.append({"event": "_malformed_line"})
    return out


def split_segments(events: list[dict]) -> list[list[dict]]:
    """Split a (possibly stitched) log into per-process segments at
    ``run_header`` events.  A resumed driver run APPENDS to the
    interrupted run's log with a fresh header, and each
    segment's clock restarts at zero — so spans/phases/counters must
    reconcile per segment, never across the stitch."""
    segs: list[list[dict]] = [[]]
    for ev in events:
        if ev.get("event") == "run_header" and segs[-1]:
            segs.append([])
        segs[-1].append(ev)
    return segs


def _convergence(events: list[dict], counters: dict) -> dict | None:
    """Convergence reconciliation: per-solver iteration
    totals and the sweep-odometer identity.

    Every chunk sweep (``solver.sweeps``) is claimed by an accounting
    bucket: the per-solve initial evaluation
    (``solver.streamed_solves``), a line-search/trial-point evaluation
    (``solver.ls_trials``), a gradient-recovery pass
    (``solver.grad_recovery_sweeps``), an auxiliary pass
    (``solver.aux_sweeps`` — Hessian diagonals, variance passes), or a
    TRON CG Hessian-vector pass (``solver.hvp_sweeps``).  The check FAILS
    when the claimed evaluations exceed the data passes (negative
    ``unattributed`` — a solver claiming passes it never streamed is
    impossible accounting, i.e. drift) or, with streamed solves
    present, when the live per-iteration event count disagrees with
    the ``solver.iterations`` counter (a solver iterating without
    emitting, or vice versa — wiring drift).  POSITIVE unattributed
    sweeps stay informational: direct objective evaluations outside
    any solve (benches, notebooks, a final-loss log line) are
    legitimate data passes no solve claims, and the report prints
    their count so a creeping gap is still visible.

    Returns None when the log carries no convergence signal at all
    (older logs, telemetry off)."""
    iters_by_solver: dict = {}
    trust_region: dict = {}
    traces = 0
    re_by_coord: dict = {}
    for ev in events:
        kind = ev.get("event")
        if kind == "convergence_iter":
            key = (ev.get("solver", "?"), ev.get("label", ""))
            iters_by_solver[key] = iters_by_solver.get(key, 0) + 1
            if ev.get("delta") is not None:
                # TRON radius/ratio trajectory: a collapsing
                # δ means rejected steps even when the loss plane looks
                # flat — surfaced per solver in the Convergence section.
                tr = trust_region.setdefault(
                    key, {"delta": [], "rho": [], "rejected": 0})
                tr["delta"].append(float(ev["delta"]))
                if ev.get("rho") is not None:
                    tr["rho"].append(float(ev["rho"]))
                if not ev.get("step_size"):
                    tr["rejected"] += 1
        elif kind == "convergence_trace":
            traces += 1
        elif kind == "re_convergence":
            d = re_by_coord.setdefault(
                ev.get("coordinate", "?"),
                {"sweeps": 0, "solved": [], "retired": 0, "woken": 0})
            d["sweeps"] += 1
            d["solved"].append(ev.get("entities_solved"))
            d["retired"] = max(d["retired"],
                               ev.get("entities_retired") or 0)
            d["woken"] += ev.get("entities_woken", 0)
        elif kind == "re_retirement":
            # Commit-time totals: re_convergence samples as of sweep
            # start, so the LAST commit only appears here.
            d = re_by_coord.setdefault(
                ev.get("coordinate", "?"),
                {"sweeps": 0, "solved": [], "retired": 0, "woken": 0})
            d["retired"] = max(d["retired"],
                               ev.get("entities_retired_total") or 0)
    sweeps = counters.get("solver.sweeps")
    solves = counters.get("solver.streamed_solves", 0)
    resumed = counters.get("solver.resumed_solves", 0)
    ls = counters.get("solver.ls_trials", 0)
    grad_rec = counters.get("solver.grad_recovery_sweeps", 0)
    aux = counters.get("solver.aux_sweeps", 0)
    fused = counters.get("solver.fused_cycle_sweeps", 0)
    hvp = counters.get("solver.hvp_sweeps", 0)
    if (not iters_by_solver and not traces and not re_by_coord
            and sweeps is None):
        return None
    # TRON's CG inner-loop passes claim their own bucket
    # (`solver.hvp_sweeps`); resumed solves claim ZERO passes (the
    # initial evaluation was streamed — and counted — by the
    # interrupted predecessor segment), but they still run iterations,
    # so the iteration/counter cross-check must engage for them too.
    expected = solves + ls + grad_rec + aux + fused + hvp
    unattributed = (sweeps or 0) - expected
    # Data passes per CD cycle: the fused super-sweep's
    # deliverable is this ratio dropping from ~C (coordinates × solver
    # iterations) to ~1 (one fused pass per cycle + the final score
    # pass).  None when the run had no CD loop (plain solver benches).
    cycles = counters.get("cd.cycles", 0)
    passes_per_cycle = (round((sweeps or 0) / cycles, 3) if cycles
                        else None)
    iter_events = sum(iters_by_solver.values())
    ok = unattributed >= 0
    if solves or resumed:
        # The live per-iteration events and the counter must agree —
        # an instrumented solver that iterates without emitting (or
        # vice versa) is wiring drift.  Resume-only segments (mid-CG
        # resume: zero fresh solves) are checked too.
        ok = ok and iter_events == counters.get("solver.iterations", 0)
    # Data passes per (fresh) solve: the TRON-vs-L-BFGS comparison's
    # headline ratio — how many streamed passes one fit cost.
    passes_per_solve = (round((sweeps or 0) / solves, 3) if solves
                        else None)
    return {
        "ok": ok,
        "sweeps": sweeps or 0,
        "streamed_solves": solves,
        "resumed_solves": resumed,
        "ls_trials": ls,
        "grad_recovery_sweeps": grad_rec,
        "aux_sweeps": aux,
        "fused_cycle_sweeps": fused,
        "hvp_sweeps": hvp,
        "unattributed_sweeps": unattributed,
        "cd_cycles": cycles,
        "passes_per_cycle": passes_per_cycle,
        "passes_per_solve": passes_per_solve,
        "trust_region": {f"{s}:{lbl}" if lbl else s: d
                         for (s, lbl), d in sorted(trust_region.items())},
        "iterations": {f"{s}:{lbl}" if lbl else s: n
                       for (s, lbl), n in sorted(iters_by_solver.items())},
        "iteration_events": iter_events,
        "solver_iterations_counter": counters.get("solver.iterations", 0),
        "traces": traces,
        "re": re_by_coord,
    }


def _device(summary: dict | None) -> dict | None:
    """Device-accounting table: captured program costs joined with a
    measured per-chunk time and the clock it came from
    (``measured_source``).

    The first choice is the CUDA-event histogram
    ``device.event_s.<name>`` (``stream_interval``: kernels plus host
    dispatch); then (a CPU run, or the reference's logs) the host
    dispatch histogram ``device.dispatch_s.<name>``, and last the shared
    ``chunk_compute`` span's mean when exactly one captured program
    claims that span (both ``host``).  ``roofline_fraction`` is given
    only for a host time of a CPU program: there the host runs the work
    itself, while on an accelerator neither clock is kernel-busy time."""
    programs = ((summary or {}).get("device") or {}).get("programs")
    if not programs:
        return None
    spans = (summary or {}).get("spans", {})
    hists = (summary or {}).get("histograms", {})
    span_claims: dict = {}
    for cost in programs.values():
        sp = cost.get("span")
        if sp:
            span_claims[sp] = span_claims.get(sp, 0) + 1
    out = {}
    for name, cost in sorted(programs.items()):
        row = dict(cost)
        measured_ms = source = None
        ev = hists.get(f"device.event_s.{name}")
        h = hists.get(f"device.dispatch_s.{name}")
        if ev and ev.get("count"):
            measured_ms, source = 1e3 * ev["mean"], "stream_interval"
            row["measured_chunks"] = ev["count"]
        elif h and h.get("count"):
            measured_ms, source = 1e3 * h["mean"], "host"
        else:
            st = spans.get(cost.get("span", ""), None)
            if (st and st["count"]
                    and span_claims.get(cost.get("span")) == 1):
                measured_ms = 1e3 * st["total_s"] / st["count"]
                source = "host"
        if measured_ms is not None:
            row["measured_span_ms"] = round(measured_ms, 3)
            row["measured_source"] = source
            est = cost.get("roofline_est_ms")
            if (est and measured_ms > 0 and source == "host"
                    and cost.get("platform") == "cpu"):
                row["roofline_fraction"] = round(est / measured_ms, 4)
        out[name] = row
    mem = ((summary or {}).get("device") or {}).get("memory")
    return {"programs": out, **({"memory": mem} if mem else {})}


def _phases(events: list[dict]) -> list[tuple[str, float]]:
    out = []
    for ev in events:
        if ev.get("event") == "phase_end":
            out.append((ev.get("phase", "?"),
                        float(ev.get("duration_s", 0.0))))
    return out


def reconcile(events: list[dict]) -> dict:
    """Per-thread depth-0 span coverage of that thread's wall clock.

    Depth-0 spans on one thread cannot overlap (they come off a stack),
    so covered time is a plain sum; wall clock is last end − first
    start.  Returns ``{threads: {name: {...}}, coverage, thread}``
    where ``coverage`` is the busiest (most covered seconds) thread's
    fraction — the reconciliation number of record."""
    per_tid: dict = {}
    for ev in events:
        if ev.get("event") != "span" or ev.get("depth", 0) != 0:
            continue
        tid = ev.get("tid", 0)
        ts, dur = float(ev["ts"]), float(ev["dur"])
        ent = per_tid.setdefault(
            tid, {"thread": ev.get("thread", str(tid)), "covered_s": 0.0,
                  "start": ts, "end": ts + dur, "spans": 0})
        ent["covered_s"] += dur
        ent["start"] = min(ent["start"], ts)
        ent["end"] = max(ent["end"], ts + dur)
        ent["spans"] += 1
    threads = {}
    best = None
    for tid, ent in per_tid.items():
        wall = max(ent["end"] - ent["start"], 1e-9)
        cov = min(1.0, ent["covered_s"] / wall)
        threads[ent["thread"]] = {
            "spans": ent["spans"],
            "covered_s": round(ent["covered_s"], 3),
            "wall_s": round(wall, 3),
            "coverage": round(cov, 4),
        }
        if best is None or ent["covered_s"] > best[1]:
            best = (ent["thread"], ent["covered_s"], cov)
    return {
        "threads": threads,
        "thread": best[0] if best else None,
        "coverage": round(best[2], 4) if best else None,
    }


def report(path: str, threshold: float = 0.9, out=None) -> dict:
    """Print the report for ``path``; returns the JSON summary dict."""
    out = out or sys.stdout
    all_events = load_events(path)
    segments = split_segments(all_events)
    # The LAST segment is the report of record (a resumed run's own
    # events); earlier segments are the interrupted predecessors — a
    # torn tail there is expected, not a finding.
    events = segments[-1]
    summary = None
    for ev in events:
        if ev.get("event") == "telemetry_summary":
            summary = ev         # last one wins (append-mode logs)

    w = lambda s="": print(s, file=out)
    if len(segments) > 1:
        resumes = sum(1 for ev in events if ev.get("event") == "cd_resume")
        w(f"Stitched log: {len(segments)} run segments (resumed run); "
          f"reporting the last segment"
          + (f", which resumed from a checkpoint" if resumes else "")
          + ".")
        w()
    header = next((e for e in events if e.get("event") == "run_header"),
                  None)
    if header is not None:
        if "torch" in header:
            runtime = (f"torch={header.get('torch', '-')} "
                       f"cuda={header.get('cuda', '-')} "
                       f"device={header.get('device_name', '-')}")
        else:
            runtime = (f"jax={header.get('jax', '-')} "
                       f"platforms={header.get('jax_platforms', '-')}")
        w(f"Run {header.get('run_id', '?')} (schema "
          f"{header.get('schema', '?')}): {runtime} "
          f"telemetry={header.get('telemetry', '-')}")
        argv = header.get("argv")
        if argv:
            w(f"  argv: {' '.join(str(a) for a in argv)}")
        w()

    phases = _phases(events)
    if phases:
        w("Phases (run log):")
        w(f"  {'phase':<28} {'wall_s':>10}")
        for name, dur in phases:
            w(f"  {name:<28} {dur:>10.3f}")
        w()

    spans = (summary or {}).get("spans", {})
    if spans:
        total_all = sum(st["total_s"] for st in spans.values())
        w("Stage spans:")
        w(f"  {'name':<24} {'cat':<8} {'count':>7} {'total_s':>10} "
          f"{'mean_ms':>9} {'share':>7}")
        for name, st in sorted(spans.items(),
                               key=lambda kv: -kv[1]["total_s"]):
            mean_ms = 1e3 * st["total_s"] / max(st["count"], 1)
            share = st["total_s"] / total_all if total_all else 0.0
            w(f"  {name:<24} {st['cat']:<8} {st['count']:>7} "
              f"{st['total_s']:>10.3f} {mean_ms:>9.2f} {share:>6.1%}")
        w()

    derived = (summary or {}).get("derived", {})
    counters = (summary or {}).get("counters", {})
    overlap = derived.get("overlap_efficiency")
    if overlap is not None:
        w("Prefetcher:")
        w(f"  consumer blocked {counters.get('prefetch.consumer_wait_s', 0.0):.3f} s"
          f" of {derived.get('pass_span_total_s', 0.0):.3f} s streamed pass time"
          f" ({derived.get('consumer_blocked_fraction', 0.0):.1%})"
          f" -> overlap efficiency {overlap:.1%}")
        if "producer_stall_fraction" in derived:
            w(f"  producer stalled on a full queue "
            f"{counters.get('prefetch.producer_stall_s', 0.0):.3f} s "
              f"({derived['producer_stall_fraction']:.1%} of pass time)")
        hits = counters.get("store.hits")
        loads = counters.get("store.loads")
        if hits is not None or loads is not None:
            w(f"  chunk source: {hits or 0} LRU window hits, "
              f"{loads or 0} disk loads, "
              f"{counters.get('store.rebuilds', 0)} rebuilds")
        w()

    fleet_reduces = counters.get("fleet.psums")
    if fleet_reduces:
        # One host's view of a multi-host run; `telemetry fleet-report`
        # joins every host's log into the fleet-wide table.
        w("Fleet (this host's shard):")
        w(f"  {counters.get('fleet.chunks_streamed', 0)} chunks "
          f"streamed, {fleet_reduces} cross-host reductions, "
          f"{counters.get('fleet.barrier_wait_s', 0.0):.3f} s waiting "
          "at chunk barriers"
          + (f", {counters.get('fleet.seq_restored')} reduce-seq "
             "restore(s) (resumed host)"
             if counters.get("fleet.seq_restored") else ""))
        w()

    conv = _convergence(events, counters)
    if conv is not None:
        w("Convergence:")
        for key, n in conv["iterations"].items():
            w(f"  {key}: {n} iterations")
        for coord, d in conv["re"].items():
            solved = [s for s in d["solved"] if s is not None]
            w(f"  re '{coord}': {d['sweeps']} sweeps, solved/sweep "
              f"{solved}, retired {d['retired']}, woken {d['woken']}")
        for key, d in conv["trust_region"].items():
            deltas, rhos = d["delta"], d["rho"]
            line = (f"  {key} trust region: δ {deltas[0]:.3g} -> "
                    f"{deltas[-1]:.3g} over {len(deltas)} iters")
            if rhos:
                line += (f", ρ in [{min(rhos):.3g}, {max(rhos):.3g}]"
                         f", {d['rejected']} rejected")
            w(line)
        w(f"  sweep odometer: {conv['sweeps']} data passes = "
          f"{conv['streamed_solves']} solve inits + "
          f"{conv['ls_trials']} ls trials + "
          f"{conv['grad_recovery_sweeps']} grad recoveries + "
          f"{conv['aux_sweeps']} aux + "
          f"{conv['hvp_sweeps']} hvp + "
          f"{conv['fused_cycle_sweeps']} fused cycles + "
          f"{conv['unattributed_sweeps']} unattributed "
          f"-> {'PASS' if conv['ok'] else 'FAIL'}")
        if conv["resumed_solves"]:
            w(f"  resumed solves: {conv['resumed_solves']} (zero-pass "
              "inits — streamed by the interrupted segment)")
        if conv["passes_per_cycle"] is not None:
            w(f"  passes/cycle: {conv['passes_per_cycle']} "
              f"({conv['sweeps']} passes / {conv['cd_cycles']} CD "
              "cycles)")
        if conv["passes_per_solve"] is not None:
            w(f"  passes/solve: {conv['passes_per_solve']} "
              f"({conv['sweeps']} passes / {conv['streamed_solves']} "
              "solves)")
        w()

    device = _device(summary)
    if device is not None:
        w("Device programs (cost analysis; measured ms by its clock):")
        w(f"  {'program':<22} {'GFLOPs':>9} {'MB':>9} {'roof_ms':>8} "
          f"{'meas_ms':>8} {'frac':>6} clock")
        for name, row in device["programs"].items():
            gf = (row.get("flops") or 0.0) / 1e9
            mb = (row.get("bytes_accessed") or 0.0) / 1e6
            est = row.get("roofline_est_ms")
            meas = row.get("measured_span_ms")
            frac = row.get("roofline_fraction")
            w(f"  {name:<22} {gf:>9.3f} {mb:>9.2f} "
              f"{est if est is not None else '-':>8} "
              f"{meas if meas is not None else '-':>8} "
              f"{frac if frac is not None else '-':>6} "
              f"{row.get('measured_source', '-')}")
        mem = device.get("memory")
        if mem:
            w(f"  memory: {mem.get('bytes_in_use', 0)/1e6:.1f} MB in "
              f"use ({mem.get('source')}, {mem.get('samples')} "
              "phase-boundary samples)")
        w()

    torn = sum(1 for ev in all_events
               if ev.get("event") == "_malformed_line")
    if torn:
        w(f"NOTE: {torn} malformed line(s) skipped (torn tail — a "
          "run segment died mid-write).")
        w()

    alerts = [{k: v for k, v in ev.items() if k != "event"}
              for ev in events if ev.get("event") == "alert"]
    if alerts:
        w("Alerts (live monitor):")
        for a in alerts:
            stage = f" ({a['stage']})" if a.get("stage") else ""
            w(f"  [{a.get('severity', 'warn')}] {a.get('rule', '?')}"
              f"{stage} at t={a.get('t', '?')}: {a.get('message', '')}")
        w()

    beats: dict = {}
    deaths = []
    for ev in events:
        if ev.get("event") == "heartbeat":
            beats[ev.get("stage", "?")] = beats.get(
                ev.get("stage", "?"), 0) + 1
        elif ev.get("event") == "thread_exception":
            deaths.append(ev)
    if beats or deaths:
        w("Liveness:")
        for stage, n in sorted(beats.items()):
            w(f"  {stage}: {n} heartbeats")
        for ev in deaths:
            w(f"  DIED {ev.get('stage')}: {ev.get('error')} "
              f"(thread {ev.get('thread')}, t={ev.get('t')})")
        w()

    recon = reconcile(events)
    ok = True
    if recon["coverage"] is not None:
        w("Reconciliation (depth-0 spans vs wall clock, per thread):")
        for name, ent in sorted(recon["threads"].items()):
            w(f"  {name}: {ent['covered_s']:.3f} s covered of "
              f"{ent['wall_s']:.3f} s wall ({ent['coverage']:.1%}, "
              f"{ent['spans']} spans)")
        ok = recon["coverage"] >= threshold
        w(f"  busiest thread '{recon['thread']}' coverage "
          f"{recon['coverage']:.1%} "
          f"{'>=' if ok else '<'} threshold {threshold:.0%} "
          f"-> {'PASS' if ok else 'FAIL'}")
        w()
    elif summary is None:
        w("No telemetry_summary event found (telemetry was off, or the "
          "run died before close).")
        w()

    if conv is not None and not conv["ok"]:
        w("CONVERGENCE FAIL: solver iteration accounting does not "
          "reconcile with the solver.sweeps odometer (see above).")
        w()
        ok = False

    result = {
        "ok": ok,
        "segments": len(segments),
        "run_id": (header or {}).get("run_id"),
        "convergence": conv,
        "device": device,
        "phases": {name: dur for name, dur in phases},
        "overlap_efficiency": overlap,
        "consumer_blocked_fraction": derived.get(
            "consumer_blocked_fraction"),
        "reconciliation": recon["coverage"],
        "reconciliation_thread": recon["thread"],
        "reconciliation_threads": recon["threads"],
        "counters": counters,
        "alerts": alerts,
        "heartbeats": beats,
        "thread_exceptions": len(deaths),
        "mode": (summary or {}).get("mode"),
    }
    print(json.dumps(result), file=out)
    return result
