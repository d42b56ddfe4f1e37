"""Run one cell: set-up, a measured window of fits, the reference check.

``python -m gpubench --workload <cell> --seed <n> --seconds <s> --trace
0|1`` from the root of a checkout, on a machine with the card(s) the
cell asks for.  The last line of standard output is the result: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (and the device's busy and traced seconds, and a
breakdown of the trace).  The numbers that decide ``correct`` are
printed beside their limits as the last lines of standard error and
under ``compared``, the result's last key.

Timeline of a run: the process starts; inputs are generated from the
seed; the entry prepares the port's state (``prepare_s``); one fit warms
every kernel and shape the window uses; set-up ends (``setup_s``).  The
window repeats the fit, each from the same starting coefficients, until
``--seconds`` have passed at the end of a fit; ``fit_s`` is the window
up to the end of its last fit over the fits it completed.  Then the
peak memory is read, the port's state is freed, and the plain reference
fits the same inputs in float64 on the same card.

What a run measures goes into one registry of named sources
(``sources``: the clocks, the window's fits, the trace, the recorded
launches, what the entry adds); every metric, end-to-end or per-layer,
is a reader ``gpubench/metrics/<name>.py`` of that registry, and the
entry module judges its own answers.  A cell, a metric or a kind of job
is added as files of its own.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time

# Read before anything heavy is imported: set-up counts from here when
# the process's own start time cannot be read.
_IMPORTED_AT = time.time()

FORBIDDEN = ("jax", "jaxlib", "flax", "photon_ml_tpu")
PROFILE_S = 1.0       # the traced part of a --trace 1 window, at least


def process_start() -> float:
    """The wall-clock time this process started (Linux ``/proc``), or
    the time this module was imported."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime", encoding="ascii") as f:
            uptime = float(f.read().split()[0])
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.time() - (uptime - started)
    except (OSError, ValueError, IndexError):
        return _IMPORTED_AT


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _sync(device: str) -> None:
    if device != "cpu":
        import torch

        torch.cuda.synchronize()


def repeat_fits(entry, seconds: float, trace: bool, device: str, inst,
                pick: int, port) -> dict:
    """The default window: repeat the fit until ``seconds`` have passed
    at the end of one.

    Keeps what judges the first fit and fit ``pick`` (``entry.keep``;
    the window may end before ``pick``).  With ``trace``: after the first
    fit, three spans of at least ``PROFILE_S`` each: one traced on the
    device alone (kernel times, busy share; launches recorded), one
    traced with the host's operations too (what the host did in the idle
    gaps), and one traced so while the port's telemetry session is open
    (device time by the port's spans; the port's counters); the window
    runs on to ``seconds`` after them.  No session is open in any other
    fit: its host work would read as idle gaps, and as idle device time
    in the device-only span.  Returns the sources it measured."""
    from gpubench.trace import profiler, summarize

    fits, kept = [], {}
    spans = ["device", "host", "session"] if trace else []
    prof = span = session = None
    traced: dict = {}
    out = {"trace": None, "window_s": 0.0, "idle_gaps": None,
           "counters": None, "span_device_s": None, "span_busy_s": None}
    t0 = time.perf_counter()
    try:
        while True:
            if spans and prof is None and fits:
                span = spans.pop(0)
                if span == "session":
                    session = port.open_session(device)
                prof = profiler(with_host=span != "device")
                prof.__enter__()
                _sync(device)
                tp0 = time.perf_counter()
                inst.recording = span == "device"
            record = len(fits) in (0, pick)
            rec = {"span": span if prof is not None else None,
                   "evaluations": None, "eval_bytes": None}
            if inst is not None:
                e0, b0, u0 = inst.evaluations, inst.eval_bytes, inst.uncounted
            rec["start"] = time.perf_counter()
            leaves = entry.fit(record=record)
            _sync(device)
            rec["end"] = time.perf_counter()
            if inst is not None:
                rec["evaluations"] = inst.evaluations - e0
                # A fit with an evaluation of no byte count has none.
                rec["eval_bytes"] = (inst.eval_bytes - b0
                                     if inst.uncounted == u0 else None)
            if record:
                kept[len(fits)] = entry.keep(leaves)
            del leaves
            fits.append(rec)
            if prof is not None and rec["end"] - tp0 >= PROFILE_S:
                inst.recording = False
                _sync(device)
                elapsed = time.perf_counter() - tp0
                prof.__exit__(None, None, None)
                if session is not None:
                    summary = port.close_session(session)
                    session = None
                    n = sum(1 for f in fits if f["span"] == "session")
                    out["counters"] = {k: v / n for k, v
                                       in summary["counters"].items()}
                traced[span] = prof
                if span == "device":
                    out["window_s"] = elapsed
                prof = None
            if rec["end"] - t0 >= seconds and not spans and prof is None:
                break
    finally:
        # A fit that raised leaves no profiler running and no session.
        if prof is not None:
            prof.__exit__(None, None, None)
        if session is not None:
            port.close_session(session)
    out["fit_s"] = (fits[-1]["end"] - t0) / len(fits)
    # The traces are read once the window has closed.
    if "device" in traced:
        out["trace"] = summarize(traced.pop("device").events())
    if "host" in traced:
        out["idle_gaps"] = summarize(traced.pop("host").events())["idle_gaps"]
    if "session" in traced:
        by_span = port.span_device_s(traced.pop("session").events())
        out["span_device_s"] = by_span["spans"]
        out["span_busy_s"] = by_span["busy_s"]
    out.update(fits=fits, kept=kept)
    return out


def read_metrics(names: list, sources: dict) -> dict:
    """Each metric's reader (``gpubench/metrics/<name>.py``) over the
    run's sources; a metric whose reader finds nothing is left out."""
    from gpubench.manifest import metric_module

    out = {}
    for m in names:
        value = importlib.import_module(metric_module(m["name"])).read(sources)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str, started: float, port=None) -> tuple[dict, list]:
    """One run of ``cell`` (``manifest.cell``'s dict) → (result, lines
    compared).  ``port`` defaults to ``gpubench.port``."""
    import numpy as np
    import torch

    from gpubench import bounds, entries
    from gpubench.manifest import ROOT
    from gpubench.traffic.generate import generate

    if port is None:
        port = importlib.import_module("gpubench.port")
    config, traffic = cell["config"], cell["traffic"]
    kind = torch.cuda.get_device_name(0) if device != "cpu" else "cpu"
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
        port.use_build_dir(ROOT)
    data = generate(config, seed)
    module = entries.load(traffic["entry"])
    entry = module.Entry(port, data, config, traffic, device)
    prepare_s = entry.prepare_s
    # One fit, and the copy that keeps one, build and warm every kernel
    # and shape the window runs.
    entry.keep(entry.fit(record=True))
    _sync(device)
    setup_s = time.time() - started

    inst = port.Instruments() if trace else None
    pick = int(np.random.default_rng(seed).integers(1, 16))
    window = getattr(module, "window", repeat_fits)
    try:
        if inst is not None:
            inst.__enter__()
        win = window(entry, seconds, trace, device, inst, pick, port)
    finally:
        if inst is not None:
            inst.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0

    # What is judged read back, the port's state freed, then the reference.
    kept = {i: entry.host(k) for i, k in win.pop("kept").items()}
    sources = {**getattr(entry, "sources", dict)(), **win,
               "config": config, "traffic": traffic, "setup_s": setup_s,
               "prepare_s": prepare_s, "peak_bytes": peak,
               "bytes_per_s": bounds.CARD_PEAK_BYTES_PER_S.get(kind),
               "launches": inst.resolve() if inst is not None else {},
               "kernels": inst.specs if inst is not None else {}}
    entry.release()
    del entry, inst
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    judged = module.judge(kept, data, config, traffic, device)
    limits = {k: float(v) for k, v in cell["limits"].items()}
    worst: dict = {}
    for reading in judged.values():
        for k, v in reading.items():
            worst[k] = max(worst.get(k, v), v)
    compared = {k: {"value": worst[k], "limit": limits[k]} for k in limits}
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    attempted = len(win["fits"])
    failed = sum(1 for reading in judged.values()
                 if any(not v <= limits[k] for k, v in reading.items()
                        if k in limits))

    metrics = read_metrics(cell["per_layer"] if trace else cell["end_to_end"],
                           sources)
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if device != "cpu" else "cpu",
                         "kind": kind, "count": 1,
                         "memory_peak_bytes": int(peak)}}
    if trace and win["trace"] is not None:
        result["device"]["busy_s"] = win["trace"]["busy_s"]
        result["device"]["window_s"] = win["window_s"]
        result["breakdown"] = {"device_ops": win["trace"]["device_ops"],
                               "idle_gaps": win["idle_gaps"] or []}
    result["compared"] = compared
    walls = sorted(f["end"] - f["start"] for f in win["fits"])
    evals = [f["evaluations"] for f in win["fits"]
             if f["evaluations"] is not None]
    lines = [f"fits {len(walls)} wall min {walls[0]!r} median "
             f"{walls[len(walls) // 2]!r} max {walls[-1]!r} s; setup "
             f"{setup_s!r} s (prepare {prepare_s!r} s)"
             + (f"; evaluations a fit {sorted(set(evals))}" if evals else "")]
    # Numbers read but not compared are shown before the compared ones.
    lines += [f"{k} {v!r} (not compared)" for k, v in worst.items()
              if k not in limits]
    return result, lines + [f"{k} {v['value']!r} limit {v['limit']!r}"
                            for k, v in compared.items()]


def main(argv: list | None = None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(prog="python -m gpubench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from gpubench import manifest

    cell = manifest.cell(args.workload)
    import torch

    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available():
        print("gpubench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"gpubench: {args.workload} needs {chips} CUDA devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    from gpubench.bounds import CARD_PEAK_BYTES_PER_S

    kind = torch.cuda.get_device_name(0)
    if kind not in CARD_PEAK_BYTES_PER_S:
        print(f"gpubench: no listed memory peak for {kind!r}",
              file=sys.stderr)
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             "cuda", started)
    bad = forbidden_modules()
    if bad:
        print("gpubench: loaded in this process: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
