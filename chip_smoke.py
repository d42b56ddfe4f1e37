#!/usr/bin/env python3
"""Smoke run of ``photon_ml_torch`` on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA card (an H100: the kernels are built for ``sm_90a``),
``nvcc`` (``$CUDA_HOME/bin``, ``PATH`` or ``/usr/local/cuda/bin``) and
``g++`` (the host plan builder).  Without a card, or outside a checkout
of the repository, it exits nonzero and prints no result.  Each phase
raises on failure:

1. card: the card's name and power limit, as nvidia-smi prints them;
2. build: every hand-written kernel from ``photon_ml_torch/csrc``, one
   nvcc per source, all started together;
3. kernel check: each kernel against its plain PyTorch version on the
   card, with CUDA-event times (median of 20 samples after 3 warm-ups)
   beside the bound and a library call: ``gather_rowsum`` at the serving
   path's shapes; ``grr_contract_dense`` and ``grr_contract`` at every
   level of the full-width GRR plan that phase 6 trains on (each
   direction, column range and overflow level);
4. serving: the config-5 GAME model (KDD Cup 2012 track 2 widths: a
   sparse fixed effect over 100,000 features plus an intercept, 30
   non-zeros a row; a per-user random effect of 100,000 entities x 2
   features; a per-item one of 100,000 x 1) made from seed 0, saved,
   and served by an in-process ``ModelServer`` on the card to
   concurrent HTTP clients.  Every margin and prediction is held
   against a float64 numpy reference computed from the coefficients.
   The kernels' launch counts are set to 0 just before this phase and
   read just after it.  Then the time of a batch is split by stage of
   ``ScoringEngine.score_batch``, as served and with every entity-store
   chunk held in the host window;
5. CLI: ``python -m photon_ml_torch.serving`` in a subprocess answers
   one request and exits 0 on SIGTERM with a JSON last line;
6. training: config 1 (logistic, L2, L-BFGS) at the config-5
   fixed-effect widths: 10^6 rows made from seed 3 with power-law column
   popularity, 30 non-zeros plus an intercept a row (ELL capacity 32),
   labels from a planted sparse model, 10% held out.  The GRR plan is
   built on the host by the C++ builder (asserted) and moved to the
   card; the launch counts are set to 0, a 20-iteration fit runs through
   the plan, and the counts are read.  The loss must fall, the held-out
   AUC reach 0.70, the objective's value, gradient, Hessian-vector
   product and Hessian diagonal agree with a float64 scipy reference,
   and the same fit on the plain-ELL layout end at the same loss.  Then
   one ``value_and_gradient`` is timed on both layouts beside one
   cuSPARSE product per direction.

The line before the card's and the result's is one JSON object with a
``kernels`` list: per kernel its launches on its path (``gather_rowsum``:
phase 4; the GRR kernels: phase 6's GRR fit), the largest kernel-vs-plain
difference over all checked shapes, and its times and bound (``gather_
rowsum``: at the serving bucket, 64 rows x 32 slots; the GRR kernels:
summed over the plan levels they run, i.e. one X·w plus one Xᵀr);
``shapes`` holds every checked shape.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import dataclasses

import numpy as np
import torch

from photon_ml_torch import native
from photon_ml_torch.config import ServingConfig, config_to_json
from photon_ml_torch.data import grr as grr_mod
from photon_ml_torch.data.batch import make_sparse_batch
from photon_ml_torch.data.normalization import NormalizationContext
from photon_ml_torch.data.sparse_rows import SparseRows
from photon_ml_torch.evaluation.evaluators import auc
from photon_ml_torch.game.dataset import EntityGrouping
from photon_ml_torch.io.model_io import load_game_model, save_game_model
from photon_ml_torch.kernels import _build
from photon_ml_torch.models import (
    Coefficients,
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
    TaskType,
)
from photon_ml_torch.ops import losses
from photon_ml_torch.ops.grr_kernel import (
    grr_contract,
    grr_contract_dense,
    grr_contract_dense_reference,
    grr_contract_reference,
    tile_partials,
)
from photon_ml_torch.ops.kernels import gather_rowsum, gather_rowsum_reference
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.ops.regularization import RegularizationContext
from photon_ml_torch.optim.base import OptimizerConfig
from photon_ml_torch.optim.problem import OptimizationProblem
from photon_ml_torch.serving.engine import ScoringEngine
from photon_ml_torch.serving.server import ModelServer

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "smoke")

# Config 5 at the repository's own widths (examples/kdd_scale.py, bench.py).
D = 100_000                 # sparse fixed-effect features (+ intercept)
NNZ = 30                    # non-zeros a row
ELL_CAP = 32                # ell_row_capacity of the server
N_ENTITIES = 100_000        # per random effect
P_USER, P_ITEM = 2, 1       # user: [1, x]; item: per-entity intercept
BATCH_ROWS = 64             # largest micro-batch bucket
CLIENTS, REQUESTS, ROWS = 4, 8, 8   # client threads x requests x rows

# Kernel vs plain version: float32 sums taken in another order.
RTOL, ATOL = 1e-5, 1e-6
# Served answers vs the float64 reference: float32 arithmetic throughout.
SERVE_ATOL = 1e-4

# One H100 SXM (NVIDIA data sheet): HBM rate and the float32 rate outside
# the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# gather_rowsum's checked shapes (n, k): the serving bucket, an odd tail
# with padding slots and ids at both ends of the table, a scoring chunk.
KERNEL_SHAPES = ((BATCH_ROWS, ELL_CAP), (67, 5), (1 << 20, ELL_CAP))

# Phase 6: config 1 at the config-5 fixed-effect widths (bench.py:83).
TRAIN_ROWS = 1_000_000      # 10% of them held out
TRAIN_HOLDOUT = 0.1
TRAIN_ITERS = 20
TRAIN_L2 = 1.0
TRAIN_AUC_MIN = 0.70
# Objective surfaces vs the float64 reference: value relative error;
# vectors max|Δ| / max|reference|.
F64_VALUE_RTOL, F64_VECTOR_RTOL = 1e-5, 1e-4
# The GRR and the plain-ELL fits: their losses at each of the first
# TRAJECTORY_ITERS iterations, and at the end.  The end is looser: at
# this conditioning (a head column in nearly every row beside columns
# seen a few times; no normalization) L-BFGS amplifies float32 rounding
# differences of the objective over the later iterations.  The phase
# measures that amplification on one layout (the same fit from a start
# perturbed at rounding level) and reports it beside the layouts' gap.
TRAJECTORY_ITERS, TRAJECTORY_RTOL = 10, 1e-4
LAYOUT_LOSS_RTOL = 1e-3
PERTURBATION = 1e-7
# GRR kernels vs their plain versions: rtol, and atol as a multiple of
# the largest |partial| a supertile adds to an output window.  Both
# versions sum each tile's cap terms, then the tiles; float32 rounding
# in those sums scales with these terms (an output window sums up to
# n_gw of them, and near-zero outputs come from their cancellation).
GRR_RTOL, GRR_ATOL_SCALE = 1e-5, 1e-5


# -- the model and its float64 reference -------------------------------------


def _random_effect(rng, n_entities: int, p: int):
    """A grouping of ``n_entities`` ids with power-law example counts in
    two size buckets, and its coefficient blocks."""
    ids = np.sort(rng.choice(3 * n_entities, n_entities, replace=False))
    counts = np.minimum(rng.zipf(1.8, n_entities), 4096).astype(np.int64)
    bucket = (counts > 4).astype(np.int64)
    slot = np.zeros(n_entities, np.int64)
    n_per = []
    for b in (0, 1):
        sel = bucket == b
        slot[sel] = np.arange(int(sel.sum()))
        n_per.append(int(sel.sum()))
    grouping = EntityGrouping(
        n_examples=int(counts.sum()), entity_ids=ids.astype(np.int64),
        entity_counts=counts, entity_bucket=bucket, entity_slot=slot,
        capacities=[4, int(counts.max())], n_entities=n_per,
        example_bucket=np.empty(0, np.int64),
        example_row=np.empty(0, np.int64),
        example_col=np.empty(0, np.int64))
    blocks = [rng.normal(0, 0.3, (n, p)).astype(np.float32) for n in n_per]
    return grouping, blocks


def make_model(seed: int, d: int = D, n_entities: int = N_ENTITIES):
    """(GameModel, host numpy view for the reference) from ``seed``."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.1, d + 1).astype(np.float32)
    models = {"global": FixedEffectModel(
        Coefficients(torch.from_numpy(w)), "global", intercept=True)}
    host = {"w": w, "re": {}}
    for name, shard, key, p in (("per_user", "user", "userId", P_USER),
                                ("per_item", "item", "itemId", P_ITEM)):
        grouping, blocks = _random_effect(rng, n_entities, p)
        models[name] = RandomEffectModel(
            [torch.from_numpy(b) for b in blocks], grouping, shard,
            entity_key=key)
        host["re"][name] = (shard, key, grouping, blocks)
    return GameModel(models), host


def make_rows(rng, host, n: int, d: int = D) -> list[dict]:
    """``n`` request rows: ``NNZ`` non-zeros each; one user in 5 and one
    item in 7 never seen in training."""
    users = host["re"]["per_user"][2].entity_ids
    items = host["re"]["per_item"][2].entity_ids
    rows = []
    for i in range(n):
        cols = rng.choice(d, NNZ, replace=False)
        vals = rng.random(NNZ)
        uid = int(users[rng.integers(len(users))]) if i % 5 else -1 - i
        iid = int(items[rng.integers(len(items))]) if i % 7 else -1 - i
        rows.append({
            "features": {
                "global": [[int(c), float(v)] for c, v in zip(cols, vals)],
                "user": [1.0, float(rng.normal())],
                "item": [1.0],
            },
            "ids": {"userId": uid, "itemId": iid},
            "offset": float(rng.normal(0, 0.3)),
        })
    return rows


def reference(host, rows) -> tuple[np.ndarray, np.ndarray]:
    """float64 margins and logistic predictions straight from the
    coefficients; unseen entities contribute nothing."""
    w = host["w"].astype(np.float64)
    margins = np.empty(len(rows))
    for i, r in enumerate(rows):
        cv = np.asarray(r["features"]["global"], np.float64)
        m = r["offset"] + w[-1] + float(cv[:, 1] @ w[cv[:, 0].astype(int)])
        for shard, key, g, blocks in host["re"].values():
            j = int(np.searchsorted(g.entity_ids, r["ids"][key]))
            if j < len(g.entity_ids) and g.entity_ids[j] == r["ids"][key]:
                coef = blocks[g.entity_bucket[j]][g.entity_slot[j]]
                m += float(coef.astype(np.float64)
                           @ np.asarray(r["features"][shard], np.float64))
        margins[i] = m
    return margins, 1.0 / (1.0 + np.exp(-margins))


# -- phase 3: kernels against their plain versions ----------------------------


def kernel_inputs(rng, table: torch.Tensor, n: int, k: int):
    """(vals [n,k] f32, ids [n,k] i32) on ``table``'s device, at the
    served model's scales (feature values U(0, 1)).  Serving-width rows
    hold ``NNZ`` values and pad the rest (id 0, val 0); the odd tail pads
    a random 30% and pins ids 0 and L-1 on real slots."""
    L = table.numel()
    vals = rng.random((n, k), dtype=np.float32)
    ids = rng.integers(0, L, (n, k), dtype=np.int32)
    if k == ELL_CAP:
        pad = np.zeros((n, k), bool)
        pad[:, NNZ:] = True
    else:
        pad = rng.random((n, k)) < 0.3
    ids[pad] = 0
    vals[pad] = 0.0
    ids[1, 0], vals[1, 0] = 0, 0.5
    ids[-1, -1], vals[-1, -1] = L - 1, 0.25
    dev = table.device
    return (torch.from_numpy(vals).to(dev), torch.from_numpy(ids).to(dev))


def check_gather_rowsum(table: torch.Tensor, vals, ids) -> float:
    """Max |kernel − plain| on these inputs; raises past the tolerance."""
    got = gather_rowsum(table, vals, ids)
    if got.is_cuda:
        torch.cuda.synchronize()
    want = gather_rowsum_reference(table, vals, ids)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if not np.isfinite(got).all():
        raise AssertionError("gather_rowsum returned non-finite values")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    return float(np.max(np.abs(got - want))) if got.size else 0.0


def time_ms(fn, reps: int) -> float:
    """Median over 20 samples of CUDA-event time per call, each sample
    ``reps`` back-to-back calls, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return float(np.median(samples))


def gather_rowsum_bound_ms(table, vals, ids) -> tuple[float, str]:
    """Least time on one H100 for these inputs: vals and ids read once,
    the table entries these ids touch read once, out written once; 2
    float32 operations a slot."""
    n, k = vals.shape
    touched = int(torch.unique(ids).numel())
    nbytes = n * k * (4 + 4) + touched * 4 + n * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * n * k / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(table: torch.Tensor, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    column = table[:, None]
    shapes = []
    for n, k in KERNEL_SHAPES:
        vals, ids = kernel_inputs(rng, table, n, k)
        err = check_gather_rowsum(table, vals, ids)
        library = torch.nn.functional.embedding_bag(
            ids, column, per_sample_weights=vals, mode="sum")[:, 0]
        lib_err = float((library - gather_rowsum_reference(
            table, vals, ids)).abs().max())
        reps = 100 if n * k < 1 << 20 else 5
        bound, bound_by = gather_rowsum_bound_ms(table, vals, ids)
        shapes.append({
            "n": n, "k": k, "max_abs_err": err,
            "ms": time_ms(lambda: gather_rowsum(table, vals, ids), reps),
            "plain_ms": time_ms(
                lambda: gather_rowsum_reference(table, vals, ids), reps),
            "library_ms": time_ms(
                lambda: torch.nn.functional.embedding_bag(
                    ids, column, per_sample_weights=vals, mode="sum"),
                reps),
            "library_max_abs_err": lib_err,
            "bound_ms": bound, "bound_by": bound_by,
        })
        print(f"  gather_rowsum {n}x{k}: " + json.dumps(shapes[-1]))
    main = shapes[0]
    return {
        "name": "gather_rowsum", "route": "cuda",
        "source": "photon_ml_torch/csrc/gather_rowsum.cu",
        "replaces": "photon_ml_tpu/ops/kernels.py:65",
        "launches": None,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library_call": "torch.nn.functional.embedding_bag(mode='sum')",
        "shape": [main["n"], main["k"]],
        "shapes": shapes,
    }


# -- phases 4 and 5: serving ------------------------------------------------


def _post(port: int, rows: list, timeout: float = 60.0) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/score",
        data=json.dumps({"rows": rows}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _check_answer(out: dict, ref_m, ref_p) -> float:
    m = np.asarray(out["margins"], np.float64)
    p = np.asarray(out["predictions"], np.float64)
    if m.shape != ref_m.shape or p.shape != ref_p.shape:
        raise AssertionError(f"answer shape {m.shape} != {ref_m.shape}")
    if not (np.isfinite(m).all() and np.isfinite(p).all()):
        raise AssertionError("non-finite scores")
    err = float(max(np.abs(m - ref_m).max(), np.abs(p - ref_p).max()))
    if err > SERVE_ATOL:
        raise AssertionError(f"served scores differ from the float64 "
                             f"reference by {err:g} > {SERVE_ATOL:g}")
    return err


def serving_config(model_dir: str, spill_dir: str, device: str
                   ) -> ServingConfig:
    return ServingConfig(model_dir=model_dir, port=0, batch_rows=BATCH_ROWS,
                         ell_row_capacity=ELL_CAP, spill_dir=spill_dir,
                         hot_swap_poll_s=0.0, device=device)


def phase_serving(cfg: ServingConfig, rows: list, ref_m, ref_p) -> dict:
    """In-process server; ``CLIENTS`` threads each send ``REQUESTS``
    requests of ``ROWS`` rows over HTTP."""
    t0 = time.perf_counter()
    srv = ModelServer(cfg)
    try:
        srv.start()
        ready_s = time.perf_counter() - t0
        results: dict = {}
        latencies: list = []
        errors: list = []
        lock = threading.Lock()

        def client(c: int) -> None:
            try:
                for r in range(REQUESTS):
                    lo = (c * REQUESTS + r) * ROWS
                    t = time.perf_counter()
                    out = _post(srv.port, rows[lo: lo + ROWS])
                    with lock:
                        latencies.append(time.perf_counter() - t)
                        results[lo] = out
            except Exception as e:   # noqa: BLE001 - re-raised below
                with lock:
                    errors.append(e)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(CLIENTS)]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t1
        if any(t.is_alive() for t in threads):
            raise TimeoutError("serving clients did not finish in 300 s")
        if errors:
            raise errors[0]
        status = srv.serving_status()
    finally:
        srv.stop()
    if len(results) != CLIENTS * REQUESTS:
        raise AssertionError(f"{len(results)} answers for "
                             f"{CLIENTS * REQUESTS} requests")
    err = 0.0
    for lo, out in results.items():
        err = max(err, _check_answer(out, ref_m[lo: lo + ROWS],
                                     ref_p[lo: lo + ROWS]))
    if status["model"]["device"] != cfg.device:
        raise AssertionError(f"served on {status['model']['device']}, "
                             f"not {cfg.device}")
    lat_ms = np.asarray(latencies) * 1e3
    return {
        "requests": len(results), "rows": len(results) * ROWS,
        "max_abs_err": err,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "rows_per_s": len(results) * ROWS / wall,
        "ready_s": ready_s,
        "batches": status["batcher"]["batches"],
        "batch_fill": status["batcher"]["batch_fill"],
        "warmed_buckets": len(status["model"]["buckets"]),
        "device": status["model"]["device"],
    }


def stage_breakdown(engine: ScoringEngine, rows: list,
                    bucket: int = 2 * ROWS) -> dict:
    """Median ms a batch of ``bucket`` rows spends in each stage of
    ``ScoringEngine.score_batch`` (host clock; the score stage ends in
    the copy back, so it waits for the card): parse, the random-effect
    lookups alone, host staging (ELL + mini-tables, lookups included),
    and the whole call."""
    times: dict = {"parse": [], "lookup": [], "stage": [], "score": []}
    for lo in range(0, len(rows) - bucket + 1, bucket):
        t0 = time.perf_counter()
        parsed = engine.parse_rows(rows[lo: lo + bucket])
        t1 = time.perf_counter()
        for _name, _shard, key, store in engine._re:
            store.lookup(np.array([r.ids[key] for r in parsed]))
        t2 = time.perf_counter()
        engine._build_chunk(parsed, bucket)
        t3 = time.perf_counter()
        engine.score_batch(parsed, bucket)
        t4 = time.perf_counter()
        for k, dt in zip(times, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            times[k].append(dt * 1e3)
    return {f"{k}_ms": float(np.median(v)) for k, v in times.items()}


def phase_breakdown(cfg: ServingConfig, rows: list) -> dict:
    """``stage_breakdown`` on the served configuration, and on the same
    model with every entity-store chunk held in the host window."""
    model, task = load_game_model(cfg.model_dir)
    all_chunks = max(-(-len(m.grouping.entity_ids) // cfg.entity_chunk)
                     for m in model.models.values()
                     if isinstance(m, RandomEffectModel))
    out = {}
    for label, resident in (("served", cfg.host_max_resident),
                            ("window_all_chunks", all_chunks)):
        engine = ScoringEngine(
            model, task, ell_row_capacity=cfg.ell_row_capacity,
            spill_dir=cfg.spill_dir, entity_chunk=cfg.entity_chunk,
            host_max_resident=resident, device=cfg.device)
        engine.warm(cfg.buckets())
        out[label] = {"host_max_resident": resident,
                      **stage_breakdown(engine, rows)}
        engine.close()
    return out


def phase_cli(cfg: ServingConfig, rows: list, ref_m, ref_p) -> dict:
    """``python -m photon_ml_torch.serving`` in a subprocess: ready,
    one answered request, SIGTERM, rc 0 and a JSON last line."""
    cfg_path = os.path.join(WORK, "serve.json")
    info = os.path.join(WORK, "info.json")
    with open(cfg_path, "w") as f:
        f.write(config_to_json(cfg))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    with open(os.path.join(WORK, "cli.out"), "w+") as out, \
            open(os.path.join(WORK, "cli.err"), "w+") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "photon_ml_torch.serving", "--config",
             cfg_path, "--info-file", info],
            cwd=REPO, env=env, stdout=out, stderr=err, text=True)
        try:
            port = None
            deadline = time.monotonic() + 300
            while True:
                if proc.poll() is not None:
                    err.seek(0)
                    raise RuntimeError(f"server exited rc {proc.returncode}"
                                       f" before ready:\n{err.read()}")
                if time.monotonic() > deadline:
                    raise TimeoutError("CLI server not ready in 300 s")
                if port is None and os.path.exists(info):
                    with open(info) as f:
                        port = json.load(f)["port"]
                if port is not None:
                    try:
                        with urllib.request.urlopen(
                                f"http://127.0.0.1:{port}/healthz",
                                timeout=5) as r:
                            if r.status == 200:
                                break
                    except OSError:
                        pass
                time.sleep(0.2)
            ready_s = time.perf_counter() - t0
            answer = _post(port, rows)
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out.seek(0)
        lines = out.read().strip().splitlines()
        err.seek(0)
        stderr = err.read()
    if rc != 0:
        raise RuntimeError(f"CLI server exited rc {rc}:\n{stderr}")
    last = json.loads(lines[-1])
    if last.get("rc") != 0:
        raise AssertionError(f"CLI last line reports rc {last.get('rc')}")
    return {"ready_s": ready_s, "rc": rc,
            "max_abs_err": _check_answer(answer, ref_m, ref_p),
            "rows": last["serving"]["batcher"]["rows"]}


# -- phase 6 (built before phase 3): data, the GRR plan, its levels ----------


def make_training_data(seed: int, n: int, d: int = D, k: int = NNZ):
    """Config-5 fixed-effect rows (the generator of examples/kdd_scale.py):
    power-law column popularity, ``k`` distinct columns a row, values 1.0,
    labels from a planted sparse ``w_true``; then an intercept column
    ``d``.  Returns (SparseRows [n, d + 1], labels)."""
    rng = np.random.default_rng(seed)
    cols = np.sort(((d - k) * rng.random((n, k)) ** 2.2).astype(np.int64),
                   axis=1)
    for j in range(1, k):
        bump = cols[:, j] <= cols[:, j - 1]
        cols[bump, j] = cols[bump, j - 1] + 1
    rows = SparseRows.from_flat(np.arange(n + 1, dtype=np.int64) * k,
                                cols.reshape(-1), np.ones(n * k, np.float32))
    w_true = np.zeros(d)
    n_active = max(d // 20, 200)
    active = rng.choice(d, size=n_active, replace=False)
    w_true[active] = rng.normal(0, 1.2, n_active)
    margins = rows.dot_dense(w_true).astype(np.float64) - 1.0
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-margins))).astype(np.float32)
    return rows.with_constant_col(d), y


def phase_train_build(seed: int, n: int, device: str) -> dict:
    """Training data; the GRR plan built on the host (the C++ builder
    must be loaded) and placed on ``device``; the plain-ELL view of the
    same batch; the held-out batch."""
    if not native.native_available():
        raise RuntimeError("the native GRR plan builder did not load "
                           "(g++ missing?); the numpy fallback would take "
                           "hours at these widths")
    t = time.perf_counter()
    rows, y = make_training_data(seed, n)
    data_s = time.perf_counter() - t
    n_train = n - int(n * TRAIN_HOLDOUT)
    dim = D + 1
    t = time.perf_counter()
    batch = make_sparse_batch(rows[:n_train], dim, y[:n_train],
                              row_capacity=ELL_CAP, grr=True, device=device)
    build_s = time.perf_counter() - t
    phases = dict(grr_mod.last_build_phases)
    test = make_sparse_batch(rows[n_train:], dim, y[n_train:],
                             row_capacity=ELL_CAP, device=device)
    return {
        "grr": batch, "ell": dataclasses.replace(batch, grr=None),
        "test": test, "rows": rows[:n_train], "labels": y[:n_train],
        "info": {
            "rows": n, "train_rows": n_train, "dim": dim,
            "slots_a_row": int(rows.max_nnz), "ell_capacity": ELL_CAP,
            "positives": float(y.mean()), "data_s": data_s,
            "builder": f"native C++ ({os.path.relpath(native.library_path(), REPO)})",
            "make_batch_s": build_s, "plan_build_phases": phases,
        },
    }


def plan_levels(pair) -> list:
    """(name, GrrDirection) for every level the pair runs: each
    direction, column range and overflow level."""
    out = []

    def walk(name, node):
        if isinstance(node, grr_mod.GrrRangeSplit):
            for i, p in enumerate(node.parts):
                walk(f"{name}.part{i}", p)
            return
        level = 0
        while node is not None:
            out.append((f"{name}.level{level}", node))
            node, level = node.overflow, level + 1

    walk("row", pair.row_dir)
    walk("col", pair.col_dir)
    if pair.col_mid is not None:
        walk("mid", pair.col_mid)
    return out


def _windows(d, table: torch.Tensor) -> torch.Tensor:
    pad = d.n_gw * grr_mod.WIN - d.table_len
    return torch.nn.functional.pad(table, (0, pad)).view(d.n_gw, 128, 128)


def level_csr(d) -> torch.Tensor:
    """The level's entries as a CSR matrix [n_segments, table_len], read
    off the plan: routing a table of float indices gives each slot's
    index, its final position gives its segment."""
    dev = d.vals.device
    n_st, group = d.n_supertiles, 128 // d.cap
    if d.dense_grid:
        t = torch.arange(n_st, device=dev)
        gw, ow = t // d.n_ow_padded, t % d.n_ow_padded
    else:
        gw, ow = d.gw_of_st.long(), d.ow_of_st.long()
    index_t = torch.arange(d.n_gw * grr_mod.WIN, dtype=torch.float32,
                           device=dev).view(d.n_gw, 128, 128)
    x1 = torch.gather(index_t[gw], 2, d.g1.long())
    x2t = torch.gather(x1.transpose(1, 2), 2, d.g2.long())
    idx = torch.gather(x2t.transpose(1, 2), 2, d.g3.long()).long()
    r = torch.arange(128, device=dev)
    seg = (ow[:, None, None] * (grr_mod.WIN // d.cap)
           + (r % group)[None, :, None] * 128 + r[None, None, :])
    real = d.vals != 0
    coo = torch.sparse_coo_tensor(
        torch.stack([seg.expand_as(idx)[real], idx[real]]), d.vals[real],
        (d.n_segments, d.table_len))
    return coo.coalesce().to_sparse_csr()


def grr_level_bound_ms(d) -> tuple[float, str]:
    """Least time on one H100 for one level: the planes (vals f32 +
    g1/g2/g3 i8 a slot) and tile maps read once, each table window read
    once, the output written once; 2 float32 operations a real entry."""
    slots = d.n_supertiles * grr_mod.SLOTS
    n_out = (d.n_ow_padded if d.dense_grid else d.n_ow) * grr_mod.SLOTS // d.cap
    maps = d.gw_of_st.numel() + d.ow_of_st.numel()
    nbytes = slots * 7 + maps * 4 + d.n_gw * grr_mod.WIN * 4 + n_out * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * int(torch.count_nonzero(d.vals)) / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_grr_level(name: str, d, rng, time_it: bool = True) -> dict:
    """One plan level: its kernel against its plain version and a
    cuSPARSE product of the same entries; times and bound."""
    table = torch.from_numpy(
        rng.uniform(-1, 1, d.table_len).astype(np.float32)).to(d.vals.device)
    tt = _windows(d, table)
    if d.dense_grid:
        kernel = "grr_contract_dense"

        def run():
            return grr_contract_dense(tt, d.g1, d.g2, d.g3, d.vals,
                                      d.gw_of_st, d.n_ow_padded, d.cap)

        def plain():
            return grr_contract_dense_reference(tt, d.g1, d.g2, d.g3, d.vals,
                                                d.n_ow_padded, d.cap)
    else:
        kernel = "grr_contract"

        def run():
            return grr_contract(tt, d.g1, d.g2, d.g3, d.vals, d.gw_of_st,
                                d.ow_of_st, d.first_of_ow, d.n_ow, d.cap)

        def plain():
            return grr_contract_reference(tt, d.g1, d.g2, d.g3, d.vals,
                                          d.gw_of_st, d.ow_of_st, d.n_ow,
                                          d.cap)
    got = run()
    if got.is_cuda:
        torch.cuda.synchronize()
    want = plain()
    got_h, want_h = got.cpu().numpy(), want.cpu().numpy()
    if not np.isfinite(got_h).all():
        raise AssertionError(f"{kernel} returned non-finite values at {name}")
    gw_of_tile = (torch.arange(d.n_gw, device=tt.device)
                  .repeat_interleave(d.n_ow_padded) if d.dense_grid
                  else d.gw_of_st)
    max_partial = float(tile_partials(tt, gw_of_tile, d.g1, d.g2, d.g3,
                                      d.vals, d.cap).abs().max())
    max_term = float(table.abs().max()) * float(d.vals.abs().max())
    atol = GRR_ATOL_SCALE * max_partial
    np.testing.assert_allclose(got_h, want_h, rtol=GRR_RTOL, atol=atol,
                               err_msg=f"{kernel} at {name}")
    csr = level_csr(d)
    library = torch.sparse.mm(csr, table[:, None])[:, 0]
    flat = got.reshape(-1)[: d.n_segments]
    bound, bound_by = grr_level_bound_ms(d)
    out = {
        "level": name, "kernel": kernel, "cap": d.cap,
        "supertiles": d.n_supertiles, "entries": int(csr.values().numel()),
        "n_segments": d.n_segments, "table_len": d.table_len,
        "max_abs_err": float(np.abs(got_h - want_h).max()),
        "atol": atol, "max_tile_partial": max_partial,
        "max_abs_err_over_max_term": float(
            np.abs(got_h - want_h).max()) / max_term,
        "library_max_abs_err": float((library - flat).abs().max()),
        "bound_ms": bound, "bound_by": bound_by,
    }
    if time_it:
        out["ms"] = time_ms(run, 10)
        out["plain_ms"] = time_ms(plain, 2)
        out["library_ms"] = time_ms(
            lambda: torch.sparse.mm(csr, table[:, None]), 10)
    del csr
    return out


def phase_kernels_grr(pair, seed: int, time_it: bool = True) -> list:
    """B2 and B3 at every level of the training plan → their kernel
    entries, times and bounds summed over the levels each runs."""
    rng = np.random.default_rng(seed)
    levels = []
    for name, d in plan_levels(pair):
        levels.append(check_grr_level(name, d, rng, time_it))
        print(f"  {levels[-1]['kernel']} {name}: " + json.dumps(levels[-1]))
    entries = []
    for kernel, replaces in (
            ("grr_contract_dense", "photon_ml_tpu/ops/grr_kernel.py:121"),
            ("grr_contract", "photon_ml_tpu/ops/grr_kernel.py:52")):
        mine = [lv for lv in levels if lv["kernel"] == kernel]
        if not mine:
            raise AssertionError(f"no level of the training plan runs "
                                 f"{kernel}")
        entry = {
            "name": kernel, "route": "cuda",
            "source": "photon_ml_torch/csrc/grr_contract.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": max(lv["max_abs_err"] for lv in mine),
            "bound_by": ("bytes" if all(lv["bound_by"] == "bytes"
                                        for lv in mine) else "operations"),
            "library_call": "torch.sparse.mm(CSR of the level, table)",
            "levels": len(mine), "shapes": mine,
        }
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            entry[key] = (sum(lv[key] for lv in mine)
                          if key in mine[0] else None)
        entries.append(entry)
    return entries


# -- phase 6: training -----------------------------------------------------------


def f64_surfaces(X, y, w, v, l2: float) -> dict:
    """Logistic + L2 value, gradient, HVP and Hessian diagonal in float64
    with scipy.sparse (X is CSR)."""
    m = X @ w
    s = 1.0 / (1.0 + np.exp(-m))
    d2 = s * (1.0 - s)
    X2 = X.copy()
    X2.data = X2.data ** 2
    return {
        "value": float(np.sum(np.logaddexp(0.0, m) - y * m)
                       + 0.5 * l2 * w @ w),
        "gradient": X.T @ (s - y) + l2 * w,
        "hessian_vector": X.T @ (d2 * (X @ v)) + l2 * v,
        "hessian_diagonal": X2.T @ d2 + l2,
    }


def _fit(problem, batch, w0) -> tuple:
    t = time.perf_counter()
    res = problem.run(batch, w0)
    if w0.is_cuda:
        torch.cuda.synchronize()
    return res, time.perf_counter() - t


def phase_training(data: dict, time_it: bool = True) -> dict:
    """The GRR fit (its launch counts) and the plain-ELL fit; the loss,
    AUC, float64 and layout gates; the per-evaluation times.  Every
    result is printed before a failed gate raises."""
    import scipy.sparse as sp

    batch, ell, test = data["grr"], data["ell"], data["test"]
    dev, dim = batch.labels.device, batch.dim
    obj = GLMObjective(losses.LOGISTIC, RegularizationContext.l2(TRAIN_L2),
                       NormalizationContext.identity())
    problem = OptimizationProblem(obj,
                                  config=OptimizerConfig(max_iters=TRAIN_ITERS))
    w0 = torch.zeros(dim, device=dev)
    for b in (batch, ell):     # first-call costs (cuBLAS handles) not timed
        obj.value_and_gradient(w0, b)

    grr_contract_dense.launches = grr_contract.launches = 0
    gather_rowsum.launches = 0
    res, fit_s = _fit(problem, batch, w0)
    launches = {"grr_contract_dense": grr_contract_dense.launches,
                "grr_contract": grr_contract.launches,
                "gather_rowsum": gather_rowsum.launches}
    gather_rowsum.launches = 0
    res_ell, fit_ell_s = _fit(problem, ell, w0)
    ell_launches = gather_rowsum.launches
    w0_perturbed = PERTURBATION * torch.from_numpy(
        np.random.default_rng(6).normal(size=dim).astype(np.float32)).to(dev)
    res_perturbed, _ = _fit(problem, batch, w0_perturbed)

    def trajectory(r):
        t = r.tracker
        return {"loss": t.values[: t.count].tolist(),
                "ls_trials": t.ls_trials[1: t.count].tolist()}

    traj = {"grr": trajectory(res), "ell": trajectory(res_ell)}
    test_auc = float(auc(test.margins(res.w), test.labels, mask=test.mask))

    def gap(a, b):
        return abs(float(a) - float(b)) / abs(float(b))

    loss_gap = gap(res_ell.value, res.value)
    self_gap = gap(res_perturbed.value, res.value)
    early_gap = max(gap(a, b) for a, b in zip(
        traj["ell"]["loss"][: TRAJECTORY_ITERS + 1],
        traj["grr"]["loss"][: TRAJECTORY_ITERS + 1]))

    rows, y = data["rows"], data["labels"].astype(np.float64)
    X = sp.csr_matrix((rows.vals.astype(np.float64), rows.cols, rows.indptr),
                      shape=(len(rows), dim))
    rng = np.random.default_rng(4)
    w = rng.normal(0, 0.05, dim)
    v = rng.normal(0, 1.0, dim)
    ref = f64_surfaces(X, y, w, v, TRAIN_L2)
    w_t = torch.from_numpy(w.astype(np.float32)).to(dev)
    v_t = torch.from_numpy(v.astype(np.float32)).to(dev)
    errors = {}
    for layout, b in (("grr", batch), ("ell", ell)):
        val, grad = obj.value_and_gradient(w_t, b)
        got = {"gradient": grad,
               "hessian_vector": obj.hessian_vector(w_t, v_t, b),
               "hessian_diagonal": obj.hessian_diagonal(w_t, b)}
        errors[layout] = {"value": abs(float(val) - ref["value"])
                          / abs(ref["value"])}
        for key, g in got.items():
            g = g.double().cpu().numpy()
            errors[layout][key] = float(np.abs(g - ref[key]).max()
                                        / np.abs(ref[key]).max())
    out = {
        "iterations": res.iterations, "converged": res.converged,
        "loss_first": traj["grr"]["loss"][0], "loss_final": float(res.value),
        "loss_final_ell": float(res_ell.value), "loss_gap_rel": loss_gap,
        "early_loss_gap_rel": early_gap,
        "loss_final_perturbed_start": float(res_perturbed.value),
        "perturbed_start_gap_rel": self_gap,
        "test_auc": test_auc, "f64_errors": errors,
        "launches": launches, "ell_gather_rowsum_launches": ell_launches,
        "value_evaluations": int(sum(traj["grr"]["ls_trials"])),
        "gradient_evaluations": res.iterations + 1,
        "fit_s": fit_s, "fit_ell_s": fit_ell_s, "trajectories": traj,
    }
    if time_it:
        out.update(time_evaluations(obj, batch, ell, X, w_t))

    failures = []
    if not traj["grr"]["loss"][-1] < traj["grr"]["loss"][0]:
        failures.append("the GRR fit's loss did not fall")
    if test_auc < TRAIN_AUC_MIN:
        failures.append(f"held-out AUC {test_auc:.4f} < {TRAIN_AUC_MIN}")
    for layout, errs in errors.items():
        for key, err in errs.items():
            limit = F64_VALUE_RTOL if key == "value" else F64_VECTOR_RTOL
            if not err <= limit:
                failures.append(f"{layout} {key} differs from the float64 "
                                f"reference by {err:g} > {limit:g}")
    if not early_gap <= TRAJECTORY_RTOL:
        failures.append(f"GRR and ELL losses over the first "
                        f"{TRAJECTORY_ITERS} iterations differ by "
                        f"{early_gap:g} (relative) > {TRAJECTORY_RTOL:g}")
    if not loss_gap <= LAYOUT_LOSS_RTOL:
        failures.append(f"GRR and ELL fits end {loss_gap:g} apart "
                        f"(relative) > {LAYOUT_LOSS_RTOL:g}")
    out["failures"] = failures
    return out


def time_evaluations(obj, batch, ell, X, w_t) -> dict:
    """CUDA-event ms of one ``value_and_gradient`` on each layout, of one
    cuSPARSE CSR product per direction, and of the GRR evaluation's
    parts: the row and column contractions (B2/B3 levels, overflow and
    spill), the hot-side matmuls and the spill ``index_add_`` alone."""
    dev = w_t.device
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(X.indptr.astype(np.int64)),
        torch.from_numpy(X.indices.astype(np.int64)),
        torch.from_numpy(X.data.astype(np.float32)), X.shape).to(dev)
    Xt = X.T.tocsr()
    csr_t = torch.sparse_csr_tensor(
        torch.from_numpy(Xt.indptr.astype(np.int64)),
        torch.from_numpy(Xt.indices.astype(np.int64)),
        torch.from_numpy(Xt.data.astype(np.float32)), Xt.shape).to(dev)
    r = torch.rand(X.shape[0], device=dev) - 0.5
    pair = batch.grr
    hot = pair.hot_ids
    spills = [(d, torch.rand(d.table_len, device=dev))
              for _, d in plan_levels(pair) if d.n_spill]
    out = {
        "vg_grr_ms": time_ms(lambda: obj.value_and_gradient(w_t, batch), 5),
        "vg_ell_ms": time_ms(lambda: obj.value_and_gradient(w_t, ell), 5),
        "library_xw_ms": time_ms(lambda: torch.sparse.mm(csr, w_t[:, None]),
                                 5),
        "library_xtr_ms": time_ms(
            lambda: torch.sparse.mm(csr_t, r[:, None]), 5),
        "row_contract_ms": time_ms(lambda: pair.row_dir.contract(w_t), 5),
        "col_contract_ms": time_ms(lambda: pair.col_dir.contract(r), 5),
        "mid_contract_ms": (time_ms(lambda: pair.col_mid.contract(r), 5)
                            if pair.col_mid is not None else 0.0),
        "hot_matmul_ms": time_ms(
            lambda: (torch.matmul(pair.x_hot, w_t[hot]),
                     torch.matmul(pair.x_hot.T, r)), 5),
        "spill_index_add_ms": sum(
            time_ms(lambda d=d, t=t: torch.zeros(d.n_segments, device=dev)
                    .index_add_(0, d.spill_seg, d.spill_val * t[d.spill_idx]),
                    5) for d, t in spills),
    }
    out["library_ms"] = out["library_xw_ms"] + out["library_xtr_ms"]
    return out


# -- main ---------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the GPU",
              file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} "
          f"sm_{''.join(map(str, torch.cuda.get_device_capability(0)))}")
    # Full float32 products: TF32 off for both matmul and cuDNN.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        t = time.perf_counter()
        libs = _build.build_all()
        print(f"phase 2 build: {len(libs)} kernel(s) in "
              f"{time.perf_counter() - t:.2f} s: "
              + ", ".join(os.path.relpath(p, REPO) for p in libs))

        t = time.perf_counter()
        train = phase_train_build(seed=3, n=TRAIN_ROWS, device="cuda")
        train["info"]["plan_stats"] = train["grr"].grr.plan_stats()
        train["info"]["card"] = card
        print(f"phase 6 build ({time.perf_counter() - t:.1f} s): "
              + json.dumps({"train_build": train["info"]}))

        model, host = make_model(seed=0)
        table = torch.from_numpy(host["w"]).cuda()
        t = time.perf_counter()
        kernels = [phase_kernels(table, seed=1)]
        kernels += phase_kernels_grr(train["grr"].grr, seed=5)
        print(f"phase 3 kernel check: ok in {time.perf_counter() - t:.2f} s")

        model_dir = os.path.join(WORK, "model")
        save_game_model(model, TaskType.LOGISTIC_REGRESSION, model_dir)
        rng = np.random.default_rng(2)
        rows = make_rows(rng, host, CLIENTS * REQUESTS * ROWS)
        ref_m, ref_p = reference(host, rows)
        cfg = serving_config(model_dir, os.path.join(WORK, "spill"), "cuda")
        gather_rowsum.launches = 0
        serving = phase_serving(cfg, rows, ref_m, ref_p)
        kernels[0]["launches"] = gather_rowsum.launches
        if kernels[0]["launches"] < max(1, serving["batches"]):
            raise AssertionError(
                f"gather_rowsum launched {kernels[0]['launches']} time(s) "
                f"for {serving['batches']} served batches")
        serving["card"] = card
        print("phase 4 serving: " + json.dumps({"serving": serving}))
        print("phase 4 breakdown: " + json.dumps(
            {"breakdown": phase_breakdown(cfg, rows)}))

        cli_rows = make_rows(rng, host, ROWS)
        cli_m, cli_p = reference(host, cli_rows)
        cli = phase_cli(cfg, cli_rows, cli_m, cli_p)
        print("phase 5 cli: " + json.dumps({"cli": cli}))

        t = time.perf_counter()
        training = phase_training(train)
        training["card"] = card
        print(f"phase 6 training ({time.perf_counter() - t:.1f} s): "
              + json.dumps({"training": training}))
        if training["failures"]:
            raise AssertionError("phase 6: " + "; ".join(
                training["failures"]))
        for k in kernels[1:]:
            k["launches"] = training["launches"][k["name"]]
            if k["launches"] < 1:
                raise AssertionError(f"{k['name']} was not launched by "
                                     "the GRR fit")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
