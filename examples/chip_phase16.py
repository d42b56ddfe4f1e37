"""Phase 16 of ``chip_smoke.py`` (the multi-host training fleet over tcp)
alone, after the kernel build: a short check on one GPU.

Run from the repository root::

    python3 examples/chip_phase16.py

It builds the kernels, then makes phase 16's single-process references
itself (``chip_smoke.fleet_references``: phase 10a's streamed fit and
phase 11b's fused fit on config 5, and phase 10c's uninterrupted driver
run on the config-4 fixture), runs ``chip_smoke.phase_fleet_training``
(two host processes on the card, the coordinator in this process) and
prints each result as one JSON line, then the gates' outcome.  Exit code
1 when a gate failed.
"""
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from photon_ml_torch.kernels import _build  # noqa: E402

if __name__ == "__main__":
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    shutil.rmtree(cs.WORK, ignore_errors=True)
    os.makedirs(cs.WORK)
    _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    t = time.perf_counter()
    ref_10a, ref_11b, ref_10c = cs.fleet_references("cuda")
    print(json.dumps({"references": {
        "s": time.perf_counter() - t, "10a_auc": ref_10a["auc"],
        "10a_wall_s": ref_10a["wall_s"], "11b": ref_11b}}), flush=True)
    t = time.perf_counter()
    out = cs.phase_fleet_training(ref_10a, ref_11b, ref_10c, "cuda")
    out["phase_s"] = time.perf_counter() - t
    out["card"] = card
    print(json.dumps(out, default=str), flush=True)
    print(json.dumps({"failures": out["failures"],
                      "phase_s": out["phase_s"]}))
    shutil.rmtree(cs.WORK, ignore_errors=True)
    sys.exit(1 if out["failures"] else 0)
