"""Phase 17 of ``chip_smoke.py`` (meshes and multi-device reduction)
alone, after the kernel build: a short check on one GPU.

Run from the repository root::

    python3 examples/chip_phase17.py [17a 17b 17c 17d] [spill]

(the sub-phases to run in order, all four by default; one named twice
runs twice; ``spill`` streams 17c's GRR chunks from disk every pass
instead of keeping them on the card).  It builds the kernels,
then makes those sub-phases' references itself
(``chip_smoke.mesh_references``: phase 6's data, fits and float64
surfaces, phase 7's ELL fit, phase 10a's streamed fit and phase 10c's
uninterrupted driver run), runs 17a-17d and prints each result as one
JSON line, then the gates' outcome.  Exit code 1 when a gate failed.
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
    parts = [a for a in sys.argv[1:] if a != "spill"] or [
        "17a", "17b", "17c", "17d"]
    t = time.perf_counter()
    train, training, ref_7, ref_10a, ref_10c = cs.mesh_references(
        "cuda", parts)
    print(json.dumps({"references": {
        "s": time.perf_counter() - t,
        "6_failures": training and training["failures"], "7": ref_7,
        "10a": ref_10a and {"auc": ref_10a["auc"],
                            "wall_s": ref_10a["wall_s"]}}}), flush=True)
    failures = []
    runs = {
        "17a": lambda: cs.phase_mesh(train, training, "cuda"),
        "17b": lambda: cs.phase_mesh_game(7, cs.GAME_ROWS, "cuda", ref_7),
        "17c": lambda: cs.phase_mesh_stream(ref_10a, "cuda",
                                            spill="spill" in sys.argv),
        "17d": lambda: cs.phase_mesh_driver(ref_10c, failures)}
    for name in parts:              # a sub-phase named twice runs twice
        t = time.perf_counter()
        out = runs[name]()
        out["phase_s"] = time.perf_counter() - t
        out["card"] = card
        if name != "17d":            # 17d appends to ``failures``
            failures += out["failures"]
        print(json.dumps({name: out}, default=str), flush=True)
    print(json.dumps({"failures": failures,
                      "total_s": time.perf_counter() - t0}))
    shutil.rmtree(cs.WORK, ignore_errors=True)
    sys.exit(1 if failures else 0)
