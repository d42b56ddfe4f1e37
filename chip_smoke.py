#!/usr/bin/env python3
"""Smoke run of ``photon_ml_torch`` on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA card (an H100: the kernels are built for ``sm_90a``)
and ``nvcc`` (``$CUDA_HOME/bin``, ``PATH`` or ``/usr/local/cuda/bin``).
Without a card, or outside a checkout of the repository, it exits
nonzero and prints no result.  Each phase raises on failure:

1. card: the card's name and power limit, as nvidia-smi prints them;
2. build: every hand-written kernel from ``photon_ml_torch/csrc``, one
   nvcc per source, all started together;
3. kernel check: each kernel against its plain PyTorch version on the
   card, at the serving path's shapes, with CUDA-event times (median of
   20 samples after 3 warm-ups) beside the bound and a library call;
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
   one request and exits 0 on SIGTERM with a JSON last line.

The line before the card's and the result's is one JSON object with a
``kernels`` list: per kernel its launches in phase 4, the largest
kernel-vs-plain difference over all checked shapes, and its times and
bound at the serving bucket's shape (64 rows x 32 slots); ``shapes``
holds every checked shape.  The last line is
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

import numpy as np
import torch

from photon_ml_torch.config import ServingConfig, config_to_json
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
from photon_ml_torch.ops.kernels import gather_rowsum, gather_rowsum_reference
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

        model, host = make_model(seed=0)
        table = torch.from_numpy(host["w"]).cuda()
        t = time.perf_counter()
        kernels = [phase_kernels(table, seed=1)]
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
        for k in kernels:
            if k["launches"] < max(1, serving["batches"]):
                raise AssertionError(
                    f"{k['name']} launched {k['launches']} time(s) for "
                    f"{serving['batches']} served batches")
        serving["card"] = card
        print("phase 4 serving: " + json.dumps({"serving": serving}))
        print("phase 4 breakdown: " + json.dumps(
            {"breakdown": phase_breakdown(cfg, rows)}))

        cli_rows = make_rows(rng, host, ROWS)
        cli_m, cli_p = reference(host, cli_rows)
        cli = phase_cli(cfg, cli_rows, cli_m, cli_p)
        print("phase 5 cli: " + json.dumps({"cli": cli}))
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
