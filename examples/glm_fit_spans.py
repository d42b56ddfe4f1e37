"""The ``glm-fit`` cell of ``gpubench`` read through the port's own
telemetry: set-up spans, the resident solver's counters, device time by
span, and what a session costs a fit.

Run from the repository root, on the card::

    python3 examples/glm_fit_spans.py --seed 3000000001

or at a small size off the card::

    python3 examples/glm_fit_spans.py --device cpu --rows 6000 \
        --features 500 --nnz 10

It draws the cell's rows from the seed, opens a ``metrics`` session,
prepares the fit as the benchmark's entry does (set-up spans
``data.from_flat``, ``prepare.rows``, ``prepare.ell``,
``prepare.place``), warms it, then:

1. counts ``--fits`` fits: the ``solver.resident.*`` counters a fit,
   the Xᵀr path counters ``xtr.sorted`` / ``xtr.scatter`` and the
   ``sorted_colsum`` calls, and the objective's calls at its boundary as
   the benchmark counts them;
2. traces one fit with the host's operations under ``torch.profiler``
   (``photon::`` ranges beside the kernels): device seconds by span
   over the device's busy seconds, the idle gaps' labels, and how many
   copies of the ranges the device rows hold, with the host's
   operations traced and without;
3. closes the session and traces one fit again (the idle gaps'
   labels without the ranges, and the scatter's share as the benchmark
   reads it);
4. alternates ``--rounds`` blocks of ``--block`` fits with a session and
   without: the median fit wall of each, and whether a fit's
   coefficients are bitwise the same either way.

The whole result is one JSON line on stdout (and ``--out``).
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from gpubench import entries, manifest, port  # noqa: E402
from gpubench.trace import profiler, summarize  # noqa: E402
from gpubench.traffic.generate import generate  # noqa: E402
from photon_ml_torch import telemetry  # noqa: E402
from photon_ml_torch.ops.kernels import sorted_colsum  # noqa: E402
from photon_ml_torch.telemetry.device import device_s_by_span  # noqa: E402

ETL_SPANS = ("data.from_flat", "prepare.rows", "prepare.ell")
ITERATION_SPANS = ("lbfgs.direction", "lbfgs.line_search",
                   "lbfgs.gradient", "lbfgs.update")
COUNTERS = ("iterations", "ls_trials", "evaluations", "host_reads")
XTR_COUNTERS = ("xtr.sorted", "xtr.scatter")
SCATTER = "indexFunc"     # the device name of index_add_'s kernels


def card(device: str) -> str:
    if device == "cpu":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"{torch.cuda.get_device_name(0)} (nvidia-smi: {e})"


def sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def timed_fits(entry, n: int, device: str) -> tuple[list, object]:
    """``n`` fits → (their walls, the last fit's coefficients)."""
    walls, w = [], None
    for _ in range(n):
        t = time.perf_counter()
        w = entry.fit()["global"][0]
        sync(device)
        walls.append(time.perf_counter() - t)
    return walls, w


def counters(session) -> dict:
    out = {c: session.counter("solver.resident." + c) for c in COUNTERS}
    out.update({c: session.counter(c) for c in XTR_COUNTERS})
    out["sorted_colsum_calls"] = sorted_colsum.launches
    return out


def traced_fit(entry, device: str, with_host: bool) -> dict:
    """One fit under the profiler: its wall and its span readings."""
    prof = profiler(with_host=with_host)
    with prof:
        t = time.perf_counter()
        entry.fit()
        sync(device)
        wall = time.perf_counter() - t
    return {"fit_wall_s": wall, **shares(prof.events())}


def _range_copy(e) -> bool:
    """A device row's copy of a profiler range (``gpu_user_annotation``),
    no device work."""
    return e.device_type != DeviceType.CPU and (
        getattr(e, "is_user_annotation", False)
        or e.name.startswith(telemetry.PROFILER_PREFIX))


def shares(events) -> dict:
    """The span readings of one traced fit (device seconds and % of the
    device's busy seconds); the idle gaps are read with the ranges'
    device copies left out, which would otherwise cover them."""
    by = device_s_by_span(events)
    busy, spans = by["busy_s"], by["spans"]
    summary = summarize([e for e in events if not _range_copy(e)])
    scatter = sum(s for name, s in summary["by_name"].items()
                  if SCATTER in name)
    four = sum(spans.get(n, 0.0) for n in ITERATION_SPANS)
    solve = spans.get("lbfgs.solve", 0.0)
    out = {"busy_s": busy, "unlinked_s": by["unlinked_s"],
           "outside_s": by["outside_s"], "spans_s": spans,
           "innermost_s": by["innermost"],
           "busy_s_with_copies": summarize(events)["busy_s"],
           "idle_gaps": summary["idle_gaps"],
           "idle_s": sum(s for _, s in summary["idle_gaps"]),
           "device_ranges": sum(1 for e in events if _range_copy(e))}
    if busy > 0:
        out["lbfgs_state_share"] = 100.0 * (
            spans.get("lbfgs.direction", 0.0)
            + spans.get("lbfgs.update", 0.0)) / busy
        out["xtr_span_share"] = 100.0 * spans.get("xtr", 0.0) / busy
        out["xtr_share"] = 100.0 * scatter / busy
    if solve > 0:
        out["iteration_spans_of_solve"] = four / solve
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="glm_fit_spans")
    ap.add_argument("--cell", default="glm-fit")
    ap.add_argument("--seed", type=int, default=3000000001)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int)
    ap.add_argument("--features", type=int)
    ap.add_argument("--nnz", type=int)
    ap.add_argument("--fits", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--block", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    cell = manifest.cell(args.cell)
    config, traffic = cell["config"], cell["traffic"]
    for key, value in (("rows", args.rows), ("features", args.features),
                       ("nnz_per_row", args.nnz)):
        if value is not None:
            config[key] = value
    dev = args.device
    if dev != "cpu":
        port.use_build_dir(manifest.ROOT)
    out = {"card": card(dev), "torch": torch.__version__,
           "cuda": torch.version.cuda, "seed": args.seed,
           "rows": config["rows"], "features": config["features"]}
    data = generate(config, args.seed)
    module = entries.load(traffic["entry"])

    session = telemetry.start("metrics", device=dev)
    try:
        entry = module.Entry(port, data, config, traffic, dev)
        spans = session.summary()["spans"]
        out["setup_spans_s"] = {k: v["total_s"] for k, v in spans.items()}
        out["etl_s"] = sum(spans[k]["total_s"] for k in ETL_SPANS
                           if k in spans)
        out["place_s"] = spans.get("prepare.place", {}).get("total_s")
        out["prepare_s"] = entry.prepare_s
        timed_fits(entry, 1, dev)

        # 1. the counters over --fits fits
        c0 = counters(session)
        inst = port.Instruments()
        with inst:
            walls, _ = timed_fits(entry, args.fits, dev)
        d = {k: v - c0[k] for k, v in counters(session).items()}
        out["counted"] = {"fits": args.fits, "walls_s": walls, **d}
        out["ls_trials_per_iter"] = d["ls_trials"] / max(d["iterations"], 1)
        out["host_reads_per_fit"] = d["host_reads"] / args.fits
        out["evaluations_per_fit"] = d["evaluations"] / args.fits
        out["evals_per_fit"] = inst.evaluations / args.fits

        # 2. one fit traced with the ranges, 3. one without a session
        for name, with_host in (("traced_on", True),
                                ("traced_on_device_only", False)):
            out[name] = traced_fit(entry, dev, with_host)
    finally:
        session.close()
    for name, with_host in (("traced_off", True),
                            ("traced_off_device_only", False)):
        out[name] = traced_fit(entry, dev, with_host)

    # 4. what a session costs a fit
    on, off, last_w = [], [], {}
    for r in range(args.rounds):
        for with_session in ((True, False) if r % 2 == 0
                             else (False, True)):
            s = telemetry.start("metrics", device=dev) if with_session \
                else None
            try:
                w, last = timed_fits(entry, args.block, dev)
            finally:
                if s is not None:
                    s.close()
            (on if with_session else off).extend(w)
            last_w[with_session] = last.cpu()
    out["cost"] = {"fit_s_on": on, "fit_s_off": off,
                   "median_on_s": statistics.median(on),
                   "median_off_s": statistics.median(off),
                   "on_over_off": statistics.median(on)
                   / statistics.median(off),
                   "bitwise": bool(torch.equal(last_w[True],
                                               last_w[False]))}
    entry.release()
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
