"""Phase 14 of ``chip_smoke.py`` (the serving tiers) alone, after the
kernel build: a short check on one GPU.

Run from the repository root::

    python3 examples/chip_phase14.py

It builds the kernels, saves phase 4's config-5 model (seed 0), makes
phase 4's rows and their float64 reference, runs
``chip_smoke.phase_tiers`` and prints its whole result as one JSON line,
then the gates' outcome, the latency split, the tiers' cost at their
defaults, the fault and the projected model.  Exit code 1 when a gate
failed.
"""
import json
import os
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
    os.makedirs(cs.WORK, exist_ok=True)
    _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    model, host = cs.make_model(seed=0)
    model_dir = os.path.join(cs.WORK, "model")
    cs.save_game_model(model, cs.TaskType.LOGISTIC_REGRESSION, model_dir)
    rng = np.random.default_rng(2)
    rows = cs.make_rows(rng, host, cs.CLIENTS * cs.REQUESTS * cs.ROWS)
    ref_m, ref_p = cs.reference(host, rows)
    t = time.perf_counter()
    out = cs.phase_tiers(model_dir, os.path.join(cs.WORK, "spill"), rows,
                         ref_m, ref_p, "cuda", proj={})
    out["phase_s"] = time.perf_counter() - t
    out["card"] = card
    print(json.dumps(out, default=str))
    print(json.dumps({k: out[k] for k in (
        "failures", "launches", "builds", "latency_ms", "metrics", "sync",
        "serve_report", "split", "phase_s")}, default=str))
    print(json.dumps(out.get("cost"), default=str))
    print(json.dumps(out.get("fault"), default=str))
    print(json.dumps(out.get("projected"), default=str))
    sys.exit(1 if out["failures"] else 0)
