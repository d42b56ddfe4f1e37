"""Phase 6's GRR fit in one or more checkouts, timed on one GPU in one
call: an A/B of how a GRR contraction sums its COO residual.

Run from the repository root, naming each checkout in the order to time
it (for example two earlier commits unpacked with ``git archive`` under
``build/``, then this tree twice, then the two again in reverse)::

    python3 examples/grr_residual_ab.py build/a build/b . . build/b build/a

Each checkout runs in a process of its own, from its own directory, with
its own ``chip_smoke`` helpers and package: it builds its kernels, makes
phase 6's training data and GRR plan (config 1 at config-5 widths, 10^6
rows, seed 3; ``chip_smoke.phase_train_build``), fits it ``FITS`` times
from zero (phase 6's L-BFGS, 20 iterations) and reads:

- each fit's wall, final loss and a hash of its coefficients (equal
  hashes: equal bits; a fit that repeats gives one hash);
- the CUDA-event ms of one ``value_and_gradient`` on the plan and of one
  ``X·w`` and ``Xᵀr`` (``chip_smoke.time_ms``);
- how many distinct results ``REPEATS`` calls of ``X·w`` and of ``Xᵀr``
  give on one input (1: the contraction repeats bitwise);
- the COO residual's entries a direction (``plan_stats``).

It prints one ``AB`` JSON line a run; the last line is the card's name
and power limit.
"""
import hashlib
import json
import os
import subprocess
import sys
import time

FITS = 3
REPEATS = 50


def _sha(t) -> str:
    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(
        t.detach().cpu().numpy()).tobytes()).hexdigest()[:16]


def one() -> dict:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from photon_ml_torch.data.normalization import NormalizationContext
    from photon_ml_torch.kernels import _build
    from photon_ml_torch.ops import losses
    from photon_ml_torch.ops.objective import GLMObjective
    from photon_ml_torch.ops.regularization import RegularizationContext
    from photon_ml_torch.optim.base import OptimizerConfig
    from photon_ml_torch.optim.problem import OptimizationProblem

    t = time.perf_counter()
    _build.build_all()
    out = {"root": os.getcwd(), "build_s": time.perf_counter() - t}
    t = time.perf_counter()
    data = cs.phase_train_build(seed=3, n=cs.TRAIN_ROWS, device="cuda")
    out["data_and_plan_s"] = time.perf_counter() - t
    batch = data["grr"]
    pair = batch.grr
    stats = pair.plan_stats()
    out["coo_entries"] = {k: (None if v is None else v["coo"])
                          for k, v in stats.items() if k != "hot_columns"}
    obj = GLMObjective(losses.LOGISTIC, RegularizationContext.l2(cs.TRAIN_L2),
                       NormalizationContext.identity())
    problem = OptimizationProblem(
        obj, config=OptimizerConfig(max_iters=cs.TRAIN_ITERS))
    dim = batch.dim
    w0 = torch.zeros(dim, device="cuda")
    obj.value_and_gradient(w0, batch)          # first-call costs
    fits = []
    for _ in range(FITS):
        res, fit_s = cs._fit(problem, batch, w0)
        fits.append({"fit_s": fit_s, "loss_final": float(res.value),
                     "iterations": int(res.iterations), "w_sha": _sha(res.w)})
    out["fits"] = fits
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.normal(0, 0.05, dim).astype(np.float32)).cuda()
    r = torch.from_numpy(rng.normal(
        0, 1, batch.labels.shape[0]).astype(np.float32)).cuda()
    out["ms"] = {
        "value_and_gradient": cs.time_ms(
            lambda: obj.value_and_gradient(w, batch), 1),
        "x_dot": cs.time_ms(lambda: pair.dot(w), 1),
        "xt_dot": cs.time_ms(lambda: pair.t_dot(r), 1)}
    out["distinct_of_repeats"] = {
        "x_dot": len({_sha(pair.dot(w)) for _ in range(REPEATS)}),
        "xt_dot": len({_sha(pair.t_dot(r)) for _ in range(REPEATS)}),
        "repeats": REPEATS}
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
