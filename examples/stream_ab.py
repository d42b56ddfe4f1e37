"""Phase 10a's streamed fit and phase 11b's fused cycle of one or more
checkouts, timed on one GPU in one call: an A/B of the single-host
streamed path.

Run from the repository root, naming each checkout in the order to time
it (for example a parent commit unpacked with ``git archive`` under
``build/``, then this tree, this tree, the parent)::

    python3 examples/stream_ab.py build/parent . . build/parent

Each checkout runs in a process of its own, from its own directory, with
its own ``chip_smoke`` helpers and package: it builds its kernels, makes
phase 10a's config-5 data (10^6 rows, seed 7), fits 10a's streamed GAME
model ``FITS_10A`` times (7 chunks of 131,072 rows spilled to disk,
``chip_smoke.stream_config``) and phase 11b's fused cycle once (60
cycles).  It prints one ``AB`` JSON line a run: the fit walls and their
stages, the fused fit's wall and median cycle, the AUCs and a hash of the
fixed effect's coefficients (equal hashes: equal bits).  The last line is
the card's name and power limit.
"""
import hashlib
import json
import os
import subprocess
import sys
import time

FITS_10A = 2


def one() -> dict:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from photon_ml_torch.kernels import _build

    t = time.perf_counter()
    _build.build_all()
    out = {"root": os.getcwd(), "build_s": time.perf_counter() - t}
    os.makedirs(cs.WORK, exist_ok=True)
    data = cs.make_game_data(7, cs.GAME_ROWS, d=cs.D,
                             n_entities=cs.N_ENTITIES)
    n_train = cs.GAME_ROWS - int(cs.GAME_ROWS * cs.TRAIN_HOLDOUT)
    train = data.take(slice(0, n_train))
    valid = data.take(slice(n_train, cs.GAME_ROWS))
    del data
    spill = os.path.join(cs.WORK, "ab_spill")
    fits = []
    for _ in range(FITS_10A):
        fit = cs._stream_fit(cs.stream_config("cuda", spill,
                                              cs.STREAM_CHUNK_ROWS),
                             train, valid)
        s = cs._fit_summary(fit)
        fits.append({"wall_s": fit["wall_s"], "stages": fit["stages"],
                     "launches": fit["launches"], "auc": s["auc"],
                     "w_sha": hashlib.sha256(
                         np.ascontiguousarray(s["w"]).tobytes()
                     ).hexdigest()[:16]})
        del fit
    out["10a"] = fits
    fused = cs._ooc_fit(cs.stream_config(
        "cuda", spill, cs.STREAM_CHUNK_ROWS, cd_fused=True,
        n_iterations=cs.FUSED_CYCLES, validate_per_iteration=False),
        train, valid)
    cyc = [e["duration_s"] * 1e3 for e in fused["events"]
           if e["event"] == "cd_fused_cycle"]
    s = cs._ooc_summary(fused)
    out["11b"] = {"wall_s": fused["wall_s"], "cycles": len(cyc),
                  "cycle_ms_median": float(np.median(cyc)),
                  "cycle_ms_min": float(np.min(cyc)),
                  "launches": fused["launches"], "auc": s["auc"],
                  "w_sha": hashlib.sha256(np.ascontiguousarray(
                      s["w"]).tobytes()).hexdigest()[:16]}
    out["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def main(roots: list) -> int:
    rc = 0
    for i, root in enumerate(roots):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one"],
            cwd=os.path.abspath(root), capture_output=True, text=True,
            timeout=600)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            print(f"run {i} ({root}) rc {proc.returncode}: "
                  f"{proc.stderr[-2000:]}", flush=True)
            rc = 1
            continue
        row = json.loads(lines[-1][3:])
        row.update(run=i, label=root)
        print("AB " + json.dumps(row), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0] if card.stdout else
          "nvidia-smi: no output")
    return rc


if __name__ == "__main__":
    if sys.argv[1:] == ["--one"]:
        print("AB " + json.dumps(one(), default=float), flush=True)
        sys.exit(0)
    if not sys.argv[1:]:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1:]))
