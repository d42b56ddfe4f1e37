"""The readings that set the limits deciding ``correct``; run on the card.

``python -m gpubench.calibrate --workload <cell> --seeds a,b,... --control-seeds x,y,...``

For every seed, the cell's set-up and one fit of its timed entry at the
cell's own size, through the path a run's window takes; then, with the
port's state freed, the float64 reference and the program's reading of
each number (the entry's ``numbers``).  For every control seed also:
the control (the plain reference computed in bfloat16, the precision
below the configurations' float32, put in the program's place), the
plain reference computed in float32 (the same algorithm at the
program's precision: how far float32 alone lands), and the faults
planted in the reference put in the program's place: a fit that
returns its starting state unchanged; half of the rows left out and the
rest weighted twice (the mean over the rest); the largest coefficient
of each leaf negated (an answer altered where it is produced).  Each is
judged as the program is.  One JSON line a seed, then a summary line:
by number, the program's largest reading and each other answer's
smallest.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import numpy as np


def readings(cell: dict, seed: int, control: bool, device: str,
             port=None) -> dict:
    """One seed's readings (see the module)."""
    import importlib

    import torch

    from gpubench import compare, entries
    from gpubench.manifest import ROOT
    from gpubench.traffic.generate import generate

    if port is None:
        port = importlib.import_module("gpubench.port")
    config, traffic = cell["config"], cell["traffic"]
    if device != "cpu":
        port.use_build_dir(ROOT)
    data = generate(config, seed)
    module = entries.load(traffic["entry"])
    entry = module.Entry(port, data, config, traffic, device)
    answer = entry.host(entry.keep(entry.fit(record=True)))
    entry.release()
    del entry
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    def reference(dtype=torch.float64, weights=None):
        return module.reference_answer(data, config, traffic, dtype, device,
                                       weights=weights)

    ref = reference()
    answers = {"program": answer}
    if control:
        n = len(data["labels"])
        half = np.where(np.arange(n) < n // 2, 2.0, 0.0)
        answers.update(control=reference(torch.bfloat16),
                       float32=reference(torch.float32),
                       unchanged=compare.unchanged(ref),
                       half_rows=reference(weights=half),
                       altered=compare.altered(ref))
    got, _ = module.numbers(list(answers.values()), data, config, traffic,
                            device, reference=ref)
    return {"seed": seed, **dict(zip(answers, got))}


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gpubench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)

    import torch

    from gpubench import manifest

    if not torch.cuda.is_available():
        print("gpubench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    rows = []
    for seed in seeds + [s for s in controls if s not in seeds]:
        row = readings(cell, seed, seed in controls, "cuda")
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows)}
    for number in rows[0]["program"]:
        summary[number] = {"program_max": max(r["program"][number]
                                              for r in rows)}
        for kind in ("control", "float32", "unchanged", "half_rows",
                     "altered"):
            got = [r[kind][number] for r in rows if kind in r]
            if got:
                summary[number][kind + "_min"] = min(got)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
