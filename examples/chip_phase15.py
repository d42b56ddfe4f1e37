"""Phase 15 of ``chip_smoke.py`` (the supervised replica fleet) alone,
after the kernel build: a short check on one GPU.

Run from the repository root::

    python3 examples/chip_phase15.py

It builds the kernels, saves phase 4's config-5 model (seed 0) and the
second model (seed 1), makes phase 4's rows and both float64
references, runs ``chip_smoke.phase_fleet`` and then
``chip_smoke.fleet_cold_build`` (two replicas that start at once with
no kernel built), and prints each result as one JSON line, then the
gates' outcome.  Exit code 1 when a gate failed.
"""
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402

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
    model, host = cs.make_model(seed=0)
    model_dir = os.path.join(cs.WORK, "model")
    cs.save_game_model(model, cs.TaskType.LOGISTIC_REGRESSION, model_dir)
    rng = np.random.default_rng(2)
    rows = cs.make_rows(rng, host, cs.CLIENTS * cs.REQUESTS * cs.ROWS)
    ref_m, ref_p = cs.reference(host, rows)
    model2, host2 = cs.make_model(seed=1)
    spill = os.path.join(cs.WORK, "spill")
    t = time.perf_counter()
    out = cs.phase_fleet(model_dir, spill, rows, ref_m, ref_p, "cuda",
                         model2, cs.reference(host2, rows))
    out["phase_s"] = time.perf_counter() - t
    out["card"] = card
    print(json.dumps(out, default=str), flush=True)
    t = time.perf_counter()
    cold = cs.fleet_cold_build(model_dir, spill, rows, ref_m, ref_p, "cuda")
    cold["s"] = time.perf_counter() - t
    print(json.dumps({"cold_build": cold}, default=str), flush=True)
    failures = out["failures"] + cold["failures"]
    print(json.dumps({"failures": failures, "phase_s": out["phase_s"]}))
    shutil.rmtree(cs.WORK, ignore_errors=True)
    sys.exit(1 if failures else 0)
