"""The port's checkpoint/resume and fault seams against the JAX package.

Mirrors the checkpoint and streaming-tier cases of
``tests/test_reliability.py`` (less the streamed random effects and the
sinks, ROADMAP A5b, and the telemetry report, A8b), the port on the CPU:

- the state-tree codec and ``RunCheckpointer`` round trips (CD
  snapshots, partials, the corrupt-newest fallback, the legacy format,
  the directory claim, solver and stage snapshots);
- mid-solve resume of the streaming solvers, bitwise on the CPU
  (L-BFGS, swept L-BFGS, TRON inside CG), and mid-sweep CD resume;
- the store and prefetch fault matrix: every injected fault ends in a
  bounded retry, a documented degradation or one actionable error;
- the training driver's swept streamed resume and a SIGKILL e2e;
- the tuner's restored rounds and its replayed proposal stream.

Where the reference reads telemetry counters, these read the store's
own counters, the injector's record and the solvers' calls.  Two
cross-package tests: a run checkpointed mid-solve by one package
resumes in the other to the first package's uninterrupted coefficients
within 1e-3.
"""

from __future__ import annotations

import glob
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from photon_ml_torch.config import (
    CoordinateConfig,
    CoordinateKind,
    OptimizerSettings,
    TrainingConfig,
    TuningConfig,
)
from photon_ml_torch.data.batch import make_dense_batch
from photon_ml_torch.data.chunk_store import (
    ChunkStoreSpillError,
    probe_spill_dir,
)
from photon_ml_torch.data.chunked_batch import build_chunked_batch
from photon_ml_torch.data.normalization import NormalizationContext
from photon_ml_torch.data.sparse_rows import SparseRows
from photon_ml_torch.estimators.game_estimator import GameEstimator
from photon_ml_torch.evaluation.evaluators import EvaluatorType
from photon_ml_torch.game.coordinate_descent import run_coordinate_descent
from photon_ml_torch.game.coordinates import FixedEffectCoordinate
from photon_ml_torch.game.dataset import GameDataset
from photon_ml_torch.models.glm import TaskType
from photon_ml_torch.ops import losses
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.ops.regularization import RegularizationContext
from photon_ml_torch.optim.base import OptimizerConfig
from photon_ml_torch.optim.problem import OptimizationProblem
from photon_ml_torch.optim.streaming import (
    ChunkedGLMObjective,
    ChunkPrefetcher,
    streaming_lbfgs_solve,
    streaming_lbfgs_solve_swept,
    streaming_tron_solve,
)
from photon_ml_torch.reliability import checkpoint as ckpt
from photon_ml_torch.reliability import faults
from photon_ml_torch.reliability import retry as retry_mod
from photon_ml_torch.reliability.checkpoint import RunCheckpointer
from photon_ml_torch.reliability.faults import Fault, FaultInjector
from photon_ml_torch.utils.run_log import RunLogger, read_run_log
from test_torch_training import (  # noqa: F401  (C1, C5)
    jax_c1,
    jax_fresh_caches,
)

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROSS_ATOL = 1e-3


@pytest.fixture
def rng():
    return np.random.default_rng(77)


# -- the codec and the checkpointer ------------------------------------------------


def test_tree_codec_roundtrip():
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "torch": torch.ones(4),
            "nested": {"lists": [1, 2.5, "s", None, True,
                                 np.zeros(2, bool)]},
            "scalar": np.float32(3.5), "empty": {}}
    meta, arrays = ckpt.flatten_tree(tree)
    json.dumps(meta)
    back = ckpt.unflatten_tree(meta, arrays)
    np.testing.assert_array_equal(back["w"], tree["w"])
    np.testing.assert_array_equal(back["torch"], np.ones(4))
    assert back["nested"]["lists"][:5] == [1, 2.5, "s", None, True]
    np.testing.assert_array_equal(back["nested"]["lists"][5],
                                  np.zeros(2, bool))
    assert float(back["scalar"]) == 3.5 and back["empty"] == {}


def test_checkpointer_cd_roundtrip_partial_and_corrupt_fallback(tmp_path):
    ck = RunCheckpointer(str(tmp_path), every_solver_iters=1)
    coefs = {"a": torch.arange(4, dtype=torch.float32),
             "re": [torch.ones((2, 3)), torch.zeros((1, 3))]}
    scores = {"a": torch.ones(5), "__cd_total__": torch.full((5,), 2.0)}
    ck.save_cd(1, coefs, scores, re_state={"re": {"x": np.arange(3)}},
               extra={"prev_values": {"a": 1.5}})
    st = ck.load_latest_cd()
    assert (st["iteration"], st["coord_pos"]) == (1, 0)
    np.testing.assert_array_equal(st["coefs"]["a"], [0, 1, 2, 3])
    assert len(st["coefs"]["re"]) == 2
    np.testing.assert_array_equal(st["scores"]["__cd_total__"],
                                  np.full(5, 2.0))
    np.testing.assert_array_equal(st["re_state"]["re"]["x"], np.arange(3))
    assert st["extra"]["prev_values"] == {"a": 1.5}
    ck.save_cd_partial(1, 2, coefs, scores)
    st = ck.load_latest_cd()
    assert (st["iteration"], st["coord_pos"]) == (1, 2)
    ck.save_cd(2, coefs, scores)
    assert not os.path.exists(tmp_path / "cd_partial.npz")
    assert (ck.load_latest_cd()["iteration"]) == 2
    with open(tmp_path / "cd_iter_2.npz", "wb") as f:
        f.write(b"garbage")
    st = ck.load_latest_cd()
    assert (st["iteration"], st["coord_pos"]) == (1, 0)


def test_checkpointer_utils_compat(tmp_path):
    """The CD snapshot stays readable by the legacy loader, the port's
    and the reference's."""
    from photon_ml_tpu.utils.checkpoint import (
        load_latest_checkpoint as jload,
    )

    from photon_ml_torch.utils.checkpoint import load_latest_checkpoint

    ck = RunCheckpointer(str(tmp_path))
    ck.save_cd(3, {"a": torch.arange(2, dtype=torch.float32)},
               {"a": torch.ones(4)}, re_state={"z": np.ones(2)})
    for load in (load_latest_checkpoint, jload):
        it, coefs, scores = load(str(tmp_path))
        assert it == 3
        np.testing.assert_array_equal(np.asarray(coefs["a"]), [0, 1])
        np.testing.assert_array_equal(np.asarray(scores["a"]), np.ones(4))


def test_solver_checkpoint_cadence_scope_and_clear(tmp_path):
    ck = RunCheckpointer(str(tmp_path), every_solver_iters=2, resume=True)
    with ck.scope("it1", "coord"):
        label = ck.solver_label("lbfgs")
        assert label == "it1/coord/lbfgs"
        assert not ck.maybe_save_solver(label, 1, {"w": np.ones(2)})
        assert ck.maybe_save_solver(label, 2, {"w": np.ones(2)})
        assert ck.load_solver(label)["it"] == 2
        assert ck.load_solver("it2/coord/lbfgs") is None
        ck.clear_solver(label)
        assert ck.load_solver(label) is None
    ck.maybe_save_solver("it1/x/lbfgs", 2, {"w": np.zeros(1)})
    ck.save_cd(1, {}, {})
    assert glob.glob(str(tmp_path / "solver_*.npz")) == []


def test_stage_roundtrip(tmp_path):
    ck = RunCheckpointer(str(tmp_path))
    ck.save_stage("swept", {"W": np.ones((2, 3)), "sweep": 1,
                            "lams": [1.0, 0.1]})
    st = ck.load_stage("swept")
    assert st["sweep"] == 1 and st["lams"] == [1.0, 0.1]
    assert ck.load_stage("other") is None
    ck.clear_stage("swept")
    assert ck.load_stage("swept") is None


# -- mid-solve resume ----------------------------------------------------------------


class _Interrupt(Exception):
    pass


def _quadratic(rng, n=300, d=10):
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ rng.normal(size=d) + 0.1 * rng.normal(size=n)).astype(
        np.float32)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)

    def vg(w):
        r = Xt @ w - yt
        return 0.5 * (r * r).mean(), Xt.T @ r / n

    def vgs(W):
        R = W @ Xt.T - yt
        return 0.5 * (R * R).mean(-1), R @ Xt / n

    def vs(W):
        R = W @ Xt.T - yt
        return 0.5 * (R * R).mean(-1)

    return d, vg, vgs, vs, X, y


def _flaky(fn, fail_after: int):
    calls = {"n": 0}

    def wrapped(*a):
        calls["n"] += 1
        if calls["n"] > fail_after:
            raise _Interrupt()
        return fn(*a)

    return wrapped


def _counting(fn):
    def wrapped(*a):
        wrapped.calls += 1
        return fn(*a)

    wrapped.calls = 0
    return wrapped


def test_streaming_solver_mid_solve_resume_is_bitwise(rng, tmp_path):
    d, vg, *_ = _quadratic(rng)
    cfg = OptimizerConfig(max_iters=40, tolerance=1e-9)
    ref = streaming_lbfgs_solve(vg, torch.zeros(d), cfg, label="q")
    ck = RunCheckpointer(str(tmp_path), every_solver_iters=1, resume=True)
    with ckpt.session(ck), ck.scope("it1", "q"):
        with pytest.raises(_Interrupt):
            streaming_lbfgs_solve(_flaky(vg, 6), torch.zeros(d), cfg,
                                  label="q")
        assert glob.glob(str(tmp_path / "solver_*.npz"))
        res = streaming_lbfgs_solve(vg, torch.zeros(d), cfg, label="q")
    np.testing.assert_array_equal(res.w.numpy(), ref.w.numpy())
    assert res.iterations == ref.iterations
    assert glob.glob(str(tmp_path / "solver_*.npz")) == []


def test_streaming_swept_solver_mid_solve_resume_is_bitwise(rng, tmp_path):
    d, _, vgs, vs, *_ = _quadratic(rng)
    cfg = OptimizerConfig(max_iters=40, tolerance=1e-9)
    W0 = torch.zeros((3, d))
    ref = streaming_lbfgs_solve_swept(vgs, vs, W0, cfg, label="s")
    ck = RunCheckpointer(str(tmp_path), every_solver_iters=1, resume=True)
    with ckpt.session(ck), ck.scope("sweep1"):
        with pytest.raises(_Interrupt):
            streaming_lbfgs_solve_swept(_flaky(vgs, 4), vs, W0, cfg,
                                        label="s")
        res = streaming_lbfgs_solve_swept(vgs, vs, W0, cfg, label="s")
    np.testing.assert_array_equal(res.w.numpy(), ref.w.numpy())
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  ref.iterations.numpy())


def test_resumed_solver_odometer_counts_resume_not_solve(rng, tmp_path):
    """A resumed solve does not repay the initial evaluation: it makes
    fewer evaluations than the interrupted run had left, and the
    uninterrupted run's count is the sum."""
    d, vg, *_ = _quadratic(rng)
    cfg = OptimizerConfig(max_iters=40, tolerance=1e-9)
    full = _counting(vg)
    streaming_lbfgs_solve(full, torch.zeros(d), cfg, label="q")
    ck = RunCheckpointer(str(tmp_path), every_solver_iters=1, resume=True)
    with ckpt.session(ck), ck.scope("it1", "q"):
        with pytest.raises(_Interrupt):
            streaming_lbfgs_solve(_flaky(vg, 6), torch.zeros(d), cfg,
                                  label="q")
        resumed = _counting(vg)
        streaming_lbfgs_solve(resumed, torch.zeros(d), cfg, label="q")
    # 6 evaluations ran before the interruption (the 7th raised); each
    # iteration here costs one, so the resume pays the rest only.
    assert resumed.calls == full.calls - 6


def _quadratic_newton(rng, n=300, d=10):
    X = (rng.normal(size=(n, d)).astype(np.float32)
         * np.logspace(0, -2, d).astype(np.float32))
    y = (X @ rng.normal(size=d) + 0.1 * rng.normal(size=n)).astype(
        np.float32)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)

    def vg(w):
        r = Xt @ w - yt
        return 0.5 * (r * r).mean(), Xt.T @ r / n

    def hvp(w, v):
        return Xt.T @ (Xt @ v) / n

    def diag(w):
        return (Xt * Xt).mean(0)

    return d, vg, hvp, diag


def test_streaming_tron_mid_cg_resume_is_bitwise(rng, tmp_path, caplog):
    """Interrupted inside Steihaug CG, the resume re-enters at the exact
    Hessian-vector boundary (outer point, radius, frozen
    preconditioner, CG vectors) and ends bitwise where the
    uninterrupted fit does, without repaying the preconditioner."""
    d, vg, hvp, diag = _quadratic_newton(rng)
    cfg = OptimizerConfig(max_iters=40, tolerance=1e-9)
    ref = streaming_tron_solve(vg, hvp, torch.zeros(d), cfg,
                               hessian_diag=diag, label="q")
    ck = RunCheckpointer(str(tmp_path), every_solver_iters=1, resume=True)
    caplog.set_level("INFO", logger="photon_ml_torch.optim.streaming")
    with ckpt.session(ck), ck.scope("it1", "q"):
        with pytest.raises(_Interrupt):
            streaming_tron_solve(vg, _flaky(hvp, 3), torch.zeros(d), cfg,
                                 hessian_diag=diag, label="q")
        assert glob.glob(str(tmp_path / "solver_*.npz"))
        diag_calls = _counting(diag)
        res = streaming_tron_solve(vg, hvp, torch.zeros(d), cfg,
                                   hessian_diag=diag_calls, label="q")
    assert "mid-CG" in caplog.text
    np.testing.assert_array_equal(res.w.numpy(), ref.w.numpy())
    assert res.iterations == ref.iterations
    assert diag_calls.calls == 0
    assert glob.glob(str(tmp_path / "solver_*.npz")) == []


# -- CD-level resume -------------------------------------------------------------------


def _two_coordinate_cd(rng, n=400):
    x1 = rng.normal(size=(n, 5)).astype(np.float32)
    x2 = rng.normal(size=(n, 3)).astype(np.float32)
    labels = (rng.uniform(size=n) < 0.5).astype(np.float32)

    def coord(name, x):
        return FixedEffectCoordinate(
            name=name, batch=make_dense_batch(x, labels, device=CPU),
            problem=OptimizationProblem(
                objective=GLMObjective(
                    loss=losses.LOGISTIC,
                    reg=RegularizationContext.l2(0.5),
                    norm=NormalizationContext.identity()),
                config=OptimizerConfig(max_iters=30)))

    return {"a": coord("a", x1), "b": coord("b", x2)}


class _FailingCoordinate:
    """A coordinate whose ``train`` raises at a planned call."""

    def __init__(self, inner, fail_at_call: int):
        self._inner = inner
        self._fail_at = fail_at_call
        self._calls = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def train(self, *a, **kw):
        self._calls += 1
        if self._calls == self._fail_at:
            raise _Interrupt()
        return self._inner.train(*a, **kw)


def test_cd_mid_sweep_resume_parity(tmp_path):
    """Interrupted in sweep 2's second coordinate, the resume completes
    it and matches the uninterrupted run (restored scores make the
    offsets bitwise)."""
    ref = run_coordinate_descent(
        _two_coordinate_cd(np.random.default_rng(5)), ["a", "b"], 3)
    ck_dir = str(tmp_path / "ck")
    coords = _two_coordinate_cd(np.random.default_rng(5))
    ck = RunCheckpointer(ck_dir, every_solver_iters=1)
    failing = dict(coords)
    failing["b"] = _FailingCoordinate(coords["b"], 2)
    with pytest.raises(_Interrupt):
        run_coordinate_descent(failing, ["a", "b"], 3, checkpointer=ck)
    st = ck.load_latest_cd()
    assert (st["iteration"], st["coord_pos"]) == (1, 1)
    res = run_coordinate_descent(
        _two_coordinate_cd(np.random.default_rng(5)), ["a", "b"], 3,
        checkpointer=RunCheckpointer(ck_dir, every_solver_iters=1,
                                     resume=True), resume=True)
    for name in ("a", "b"):
        np.testing.assert_allclose(res.coefficients[name].numpy(),
                                   ref.coefficients[name].numpy(),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res.total_scores.numpy(),
                               ref.total_scores.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert len(res.history) == 3
    assert set(res.history[1]) == {"a", "b"}
    for result in (res, ref):
        for entry in result.history:
            assert all(isinstance(d, dict) for d in entry.values())


# -- the fault matrix ------------------------------------------------------------------


def _sparse_problem(rng, n=1200, d=300, k=6):
    cols = np.stack([np.sort(rng.choice(d, k, replace=False))
                     for _ in range(n)]).astype(np.int32)
    vals = rng.normal(0, 1, (n, k)).astype(np.float32)
    labels = (rng.uniform(size=n) < 0.5).astype(np.float32)
    indptr = np.arange(n + 1, dtype=np.int64) * k
    rows = SparseRows.from_flat(indptr, cols.reshape(-1).astype(np.int64),
                                vals.reshape(-1))
    return rows, labels, d


def _spilled_objective(rng, spill_dir, n_chunks=6, window=2):
    rows, labels, d = _sparse_problem(rng)
    cb = build_chunked_batch(rows, d, labels, n_chunks=n_chunks,
                             spill_dir=spill_dir, host_max_resident=window)
    obj = GLMObjective(loss=losses.LOGISTIC,
                       reg=RegularizationContext.l2(0.7),
                       norm=NormalizationContext.identity())
    return cb, ChunkedGLMObjective(obj, cb, max_resident=0,
                                   prefetch_depth=2, device=CPU), d


@pytest.mark.parametrize("kind", ["corrupt_file", "delete_file", "slow"])
def test_fault_matrix_degradations_preserve_the_run(rng, tmp_path, kind):
    """A corrupt or deleted chunk rebuilds from lineage, a slow read is
    waited out: the sweep's value is unchanged, and the rebuilt file
    makes the next sweep clean."""
    cb, cobj, d = _spilled_objective(rng, str(tmp_path / "spill"))
    w = torch.from_numpy(rng.normal(0, 0.2, d).astype(np.float32))
    clean = float(cobj.value(w))
    inj = FaultInjector([Fault(site="store.load", kind=kind, at=1,
                               delay_s=0.2)])
    loads = cb.store.loads
    with faults.injected(inj):
        val = float(cobj.value(w))
    assert val == pytest.approx(clean, rel=1e-6)
    assert inj.fired and inj.fired[0][:2] == ("store.load", kind)
    assert cb.store.loads > loads
    rebuilt = cb.store.rebuilds
    assert rebuilt == (0 if kind == "slow" else 1)
    assert float(cobj.value(w)) == pytest.approx(clean, rel=1e-6)
    assert cb.store.rebuilds == rebuilt


def _retry_warnings(caplog) -> list:
    return [r for r in caplog.records
            if r.name == retry_mod.logger.name and "retrying" in r.message]


def test_fault_matrix_transient_read_error_retries(rng, tmp_path,
                                                   monkeypatch, caplog):
    monkeypatch.setattr(retry_mod, "IO_BASE_DELAY_S", 0.01)
    cb, cobj, d = _spilled_objective(rng, str(tmp_path / "spill"))
    w = torch.from_numpy(rng.normal(0, 0.2, d).astype(np.float32))
    clean = float(cobj.value(w))
    inj = FaultInjector([Fault(site="store.load", kind="io_error", at=1)])
    caplog.set_level("WARNING")
    with faults.injected(inj):
        val = float(cobj.value(w))
    assert val == pytest.approx(clean, rel=1e-6)
    assert len(_retry_warnings(caplog)) == 1      # one backoff retry won
    assert cb.store.rebuilds == 0


def test_fault_matrix_persistent_read_error_gives_up_then_rebuilds(
        rng, tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(retry_mod, "IO_BASE_DELAY_S", 0.01)
    cb, cobj, d = _spilled_objective(rng, str(tmp_path / "spill"))
    w = torch.from_numpy(rng.normal(0, 0.2, d).astype(np.float32))
    clean = float(cobj.value(w))
    inj = FaultInjector([Fault(site="store.load", kind="io_error", at=1,
                               count=3)])
    caplog.set_level("WARNING")
    with faults.injected(inj):
        val = float(cobj.value(w))
    assert val == pytest.approx(clean, rel=1e-6)
    assert len(_retry_warnings(caplog)) == 2
    assert any("giving up" in r.message for r in caplog.records)
    assert cb.store.rebuilds == 1


def test_fault_matrix_enospc_is_one_actionable_error(rng, tmp_path):
    rows, labels, d = _sparse_problem(rng)
    inj = FaultInjector([Fault(site="store.spill", kind="enospc", at=0,
                               count=100)])
    spill = str(tmp_path / "spill")
    with faults.injected(inj):
        with pytest.raises(ChunkStoreSpillError) as ei:
            build_chunked_batch(rows, d, labels, n_chunks=6,
                                spill_dir=spill)
    msg = str(ei.value)
    assert spill in msg and "MB" in msg and "out of space" in msg
    assert ei.value.bytes_needed > 0


@pytest.mark.parametrize("site", ["prefetch.load", "prefetch.place"])
def test_fault_matrix_prefetch_thread_death_is_in_band(rng, tmp_path,
                                                       site):
    """A dead prefetcher (disk read or copy stage) is the one injected
    error on the consumer's thread; the store quiesces and the pipeline
    runs again."""
    cb, cobj, d = _spilled_objective(rng, str(tmp_path / "spill"))
    w = torch.from_numpy(rng.normal(0, 0.2, d).astype(np.float32))
    inj = FaultInjector([Fault(site=site, kind="error", at=2)])
    with faults.injected(inj):
        with pytest.raises(faults.InjectedFault):
            cobj.value(w)
    cb.store.assert_quiesced()
    assert np.isfinite(float(cobj.value(w)))


def test_fault_matrix_wedged_pipeline_times_out_not_hangs():
    block = threading.Event()

    def load(i):
        block.wait(30)
        return i

    pf = ChunkPrefetcher(load, lambda h: h, depth=2, stall_timeout_s=0.3)
    pf.start(range(2))
    try:
        with pytest.raises(TimeoutError, match="stalled"):
            pf.next(0)
        pf.close(join_timeout_s=0.2)
        assert pf._thread is None
    finally:
        block.set()


def test_fault_matrix_dead_producer_is_actionable():
    pf = ChunkPrefetcher(lambda i: i, lambda h: h, depth=1,
                         stall_timeout_s=5.0)
    pf.start(range(1))
    assert pf.next(0) == 0
    pf._thread.join(timeout=5)
    with pytest.raises(RuntimeError, match="died without delivering"):
        pf.next(1)
    pf.close()


def test_fault_matrix_unwritable_spill_dir_degrades_resident(rng,
                                                             tmp_path):
    blocker = tmp_path / "blocked"
    blocker.write_text("a file, not a dir")
    spill = str(blocker / "spill")
    assert probe_spill_dir(spill) is None
    rows, labels, d = _sparse_problem(rng)
    cb = build_chunked_batch(rows, d, labels, n_chunks=4, spill_dir=spill)
    assert cb.store is None and cb.n_chunks == 4


def test_fault_matrix_seeded_plan_is_deterministic():
    """The same seed gives the same plan, in either package."""
    from photon_ml_tpu.reliability import faults as jfaults

    plans = [mod.seeded_plan(7, {"store.load": "io_error",
                                 "store.spill": "enospc"})
             for mod in (faults, faults, jfaults)]
    ats = [sorted((f.site, f.kind, f.at)
                  for fs in p._by_site.values() for f in fs) for p in plans]
    assert ats[0] == ats[1] == ats[2]


# -- the driver: swept streamed resume, SIGKILL ------------------------------------------


def _driver_config(tmp_path, out, n_iterations=2, resume=False):
    return {
        "task_type": "LOGISTIC_REGRESSION",
        "coordinates": [{
            "name": "global", "kind": "FIXED_EFFECT",
            "feature_shard": "global",
            "optimizer": {"optimizer": "LBFGS", "max_iters": 40,
                          "tolerance": 1e-8}}],
        "update_sequence": ["global"],
        "input_path": str(tmp_path / "train.jsonl"),
        "validation_fraction": 0.25,
        "output_dir": str(tmp_path / out),
        "n_iterations": n_iterations,
        "reg_weight_grid": {"global": [2.0, 0.5, 0.1]},
        "chunk_rows": 128,
        "spill_dir": str(tmp_path / "spill"),
        "checkpoint_dir": str(tmp_path / "ck"),
        "checkpoint_every_solver_iters": 1,
        "resume": resume,
        "seed": 3,
        "device": CPU,
    }


def _fixed_coefs(model_dir) -> np.ndarray:
    from photon_ml_torch.io.model_io import load_game_model

    model, _ = load_game_model(str(model_dir))
    return model.models["global"].coefficients.means.numpy()


def _headers(log_path) -> int:
    n = 0
    with open(log_path) as f:
        for line in f:
            try:
                n += json.loads(line)["event"] == "run_header"
            except ValueError:   # a killed writer's unfinished line
                continue
    return n


def _write(tmp_path, name, cfg) -> str:
    path = str(tmp_path / f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def test_driver_swept_streamed_resume_parity(tmp_path):
    """A swept streamed grid fit that completed sweep 1 of 2 resumes
    through the driver and lands on the uninterrupted run's
    coefficients; the run log holds both runs."""
    from photon_ml_torch.cli import game_training_driver

    from test_drivers import _write_jsonl_fixture

    _write_jsonl_fixture(str(tmp_path / "train.jsonl"), n_users=10,
                         n_obs=800, seed=9)
    cfg = _driver_config(tmp_path, "out_full")
    cfg["checkpoint_dir"] = str(tmp_path / "ck_full")
    summary_full = game_training_driver.main(
        ["--config", _write(tmp_path, "full", cfg)])
    game_training_driver.main(["--config", _write(
        tmp_path, "one", _driver_config(tmp_path, "out_res",
                                        n_iterations=1))])
    assert os.path.exists(tmp_path / "ck" / "stage_swept.npz")
    summary_res = game_training_driver.main(["--config", _write(
        tmp_path, "two", _driver_config(tmp_path, "out_res",
                                        n_iterations=2, resume=True))])
    assert summary_res["best_index"] == summary_full["best_index"]
    np.testing.assert_allclose(_fixed_coefs(tmp_path / "out_res" / "model"),
                               _fixed_coefs(tmp_path / "out_full" / "model"),
                               rtol=1e-5, atol=1e-6)
    assert _headers(tmp_path / "out_res" / "run_log.jsonl") == 2


def test_driver_sigkill_then_resume_e2e(tmp_path):
    """SIGKILL a driver subprocess mid-solve once a solver snapshot
    lands, rerun with ``--resume``: the coefficients match an
    uninterrupted run's and the stitched run log holds both runs."""
    from test_drivers import _write_jsonl_fixture

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    _write_jsonl_fixture(str(tmp_path / "train.jsonl"), n_users=12,
                         n_obs=3000, seed=11)

    def cfg(out, ck, resume):
        c = _driver_config(tmp_path, out, n_iterations=2, resume=resume)
        c["checkpoint_dir"] = str(tmp_path / ck)
        c["coordinates"][0]["optimizer"]["max_iters"] = 150
        c["coordinates"][0]["optimizer"]["tolerance"] = 1e-12
        return c

    def run(name, config, wait=True):
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "photon_ml_torch.cli.game_training_driver",
             "--config", _write(tmp_path, name, config)],
            cwd=REPO, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
        if wait:
            assert proc.wait(timeout=600) == 0
        return proc

    run("full", cfg("out_full", "ck_full", False))
    proc = run("victim", cfg("out_res", "ck", False), wait=False)
    ck_dir = str(tmp_path / "ck")
    deadline = time.monotonic() + 300
    try:
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                pytest.fail("the driver finished before a mid-solve "
                            "checkpoint appeared")
            if glob.glob(os.path.join(ck_dir, "solver_*.npz")):
                break
            time.sleep(0.1)
        else:
            pytest.fail("no solver checkpoint appeared in time")
        time.sleep(0.3)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    run("resume", cfg("out_res", "ck", True))
    np.testing.assert_allclose(_fixed_coefs(tmp_path / "out_res" / "model"),
                               _fixed_coefs(tmp_path / "out_full" / "model"),
                               rtol=1e-4, atol=1e-5)
    assert _headers(tmp_path / "out_res" / "run_log.jsonl") == 2


# -- the tuner, the directory claim, the legacy format --------------------------------


def test_tuned_swept_checkpoint_restores_history_and_models(tmp_path):
    """A resumed swept tuning run replays its checkpointed rounds as
    observations and rebuilds their models from the saved lane
    matrices, without retraining."""
    rng = np.random.default_rng(3)
    rows, labels, d = _sparse_problem(rng, n=800, d=60, k=4)
    train = GameDataset(labels=labels, features={"global": rows},
                        entity_ids={}, feature_dims={"global": d})
    rows_v, labels_v, _ = _sparse_problem(rng, n=300, d=60, k=4)
    valid = GameDataset(labels=labels_v, features={"global": rows_v},
                        entity_ids={}, feature_dims={"global": d})

    def config(resume):
        return TrainingConfig(
            task_type=TaskType.LOGISTIC_REGRESSION,
            coordinates=[CoordinateConfig(
                name="global", kind=CoordinateKind.FIXED_EFFECT,
                feature_shard="global",
                optimizer=OptimizerSettings(max_iters=25))],
            update_sequence=["global"], evaluators=[EvaluatorType.AUC],
            tuning=TuningConfig(n_trials=4, mode="RANDOM", trial_batch=2,
                                seed=1, reg_weight_ranges={
                                    "global": {"low": 0.01, "high": 10.0}}),
            checkpoint_dir=str(tmp_path / "ck"),
            output_dir=str(tmp_path / "out"), resume=resume, seed=0,
            device=CPU)

    res1 = GameEstimator(config(False)).fit_tuned(train, valid)
    assert os.path.exists(tmp_path / "ck" / "stage_tuner_hist_0.npz")
    assert os.path.exists(tmp_path / "ck" / "stage_tuner_hist_1.npz")
    res2 = GameEstimator(config(True)).fit_tuned(train, valid)
    assert len(res2) == len(res1) == 4
    for a, b in zip(res1, res2):
        assert a.reg_weights == b.reg_weights
        assert a.evaluations == b.evaluations
        assert a.validation_history == b.validation_history
        assert len(b.validation_history) > 0
        np.testing.assert_allclose(
            a.model.models["global"].coefficients.means.numpy(),
            b.model.models["global"].coefficients.means.numpy(),
            rtol=1e-6, atol=1e-7)


def test_fresh_run_claims_dir_so_resume_never_jumps_runs(tmp_path):
    old = RunCheckpointer(str(tmp_path), every_solver_iters=1)
    old.save_cd(5, {"a": torch.full((3,), 9.0)}, {})
    old.save_stage("swept", {"sweep": 5, "lams": [1.0]})
    assert old.maybe_save_solver("it5/a/lbfgs", 1, {"w": np.ones(2)})
    fresh = RunCheckpointer(str(tmp_path))
    fresh.save_cd(1, {"a": torch.arange(3, dtype=torch.float32)}, {})
    assert not os.path.exists(tmp_path / "cd_iter_5.npz")
    assert not os.path.exists(tmp_path / "stage_swept.npz")
    assert glob.glob(str(tmp_path / "solver_*.npz")) == []
    resumed = RunCheckpointer(str(tmp_path), resume=True)
    st = resumed.load_latest_cd()
    assert st["iteration"] == 1
    np.testing.assert_array_equal(st["coefs"]["a"], [0, 1, 2])
    resumed.save_cd(2, {"a": torch.zeros(3)}, {})
    assert os.path.exists(tmp_path / "cd_iter_1.npz")


def test_legacy_format_checkpoint_resumes(tmp_path):
    """A directory in the legacy ``utils.checkpoint`` format (written by
    either package) restores the run."""
    from photon_ml_tpu.utils.checkpoint import save_checkpoint as jsave

    from photon_ml_torch.utils.checkpoint import save_checkpoint

    for save, sub in ((save_checkpoint, "torch"), (jsave, "jax")):
        d = str(tmp_path / sub)
        save(d, 4, {"a": np.arange(3, dtype=np.float32),
                    "re": [np.ones((2, 2), np.float32)]},
             {"a": np.ones(5, np.float32)})
        ck = RunCheckpointer(d, resume=True)
        st = ck.load_latest_cd()
        assert (st["iteration"], st["coord_pos"]) == (4, 0)
        np.testing.assert_array_equal(st["coefs"]["a"], [0, 1, 2])
        np.testing.assert_array_equal(st["coefs"]["re"][0], np.ones((2, 2)))
        np.testing.assert_array_equal(st["scores"]["a"], np.ones(5))
        assert st["re_state"] == {} and st["extra"] == {}
        ck.save_cd(5, {"a": torch.zeros(3)}, {})
        assert ck.load_latest_cd()["iteration"] == 5


def test_resumed_random_search_continues_the_proposal_stream():
    from photon_ml_torch.hyperparameter.search import ParamRange, SearchSpace
    from photon_ml_torch.hyperparameter.tuner import (
        HyperparameterTuner,
        TunerMode,
    )

    def make():
        return HyperparameterTuner(SearchSpace([ParamRange("lam", 0.01,
                                                           10.0)]),
                                   mode=TunerMode.RANDOM, seed=7)

    proposed: list = []

    def evaluate(configs):
        proposed.append([dict(c) for c in configs])
        return [(float(c["lam"]), None) for c in configs]

    trials = make().run_batched(evaluate, 6, batch_size=2)
    rounds_full = list(proposed)
    assert len(rounds_full) == 3
    proposed.clear()
    restored = [(t.config, t.metric, t.payload) for t in trials[:2]]
    trials2 = make().run_batched(evaluate, 6, batch_size=2,
                                 restored=restored)
    assert proposed == rounds_full[1:]
    assert [t.config for t in trials2] == [t.config for t in trials]


def test_swept_stage_checkpoint_honors_sweep_cadence(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    rows, labels, d = _sparse_problem(rng, n=600, d=40, k=4)
    train = GameDataset(labels=labels, features={"global": rows},
                        entity_ids={}, feature_dims={"global": d})
    saves: list = []
    orig = RunCheckpointer.save_stage

    def spy(self, name, tree):
        saves.append((name, tree.get("sweep")))
        return orig(self, name, tree)

    monkeypatch.setattr(RunCheckpointer, "save_stage", spy)
    GameEstimator(TrainingConfig(
        task_type=TaskType.LOGISTIC_REGRESSION,
        coordinates=[CoordinateConfig(
            name="global", kind=CoordinateKind.FIXED_EFFECT,
            feature_shard="global",
            optimizer=OptimizerSettings(max_iters=15))],
        update_sequence=["global"], reg_weight_grid={"global": [2.0, 0.5]},
        n_iterations=3, checkpoint_dir=str(tmp_path / "ck"),
        checkpoint_every_sweeps=2, output_dir=str(tmp_path / "out"),
        seed=0, device=CPU)).fit(train)
    assert [s for s in saves if s[0] == "swept"] == [("swept", 2),
                                                     ("swept", 3)]


def test_fresh_run_never_adopts_stale_solver_state(rng, tmp_path):
    d, vg, *_ = _quadratic(rng)
    cfg = OptimizerConfig(max_iters=40, tolerance=1e-9)
    crashed = RunCheckpointer(str(tmp_path), every_solver_iters=1,
                              resume=True)
    with ckpt.session(crashed), crashed.scope("it1", "q"):
        with pytest.raises(_Interrupt):
            streaming_lbfgs_solve(_flaky(vg, 6), torch.zeros(d), cfg,
                                  label="q")
    assert glob.glob(str(tmp_path / "solver_*.npz"))
    fresh = RunCheckpointer(str(tmp_path), every_solver_iters=1)
    assert fresh.load_solver("it1/q/streaming_lbfgs:q") is None
    full = _counting(vg)
    streaming_lbfgs_solve(full, torch.zeros(d), cfg, label="q")
    counted = _counting(vg)
    with ckpt.session(fresh), fresh.scope("it1", "q"):
        streaming_lbfgs_solve(counted, torch.zeros(d), cfg, label="q")
    assert counted.calls == full.calls     # a whole solve, not a resume


def test_solver_snapshot_rejected_on_objective_change(rng, tmp_path):
    """A snapshot whose warm start differs is rejected: the resumed run
    solves from scratch."""
    d, vg, *_ = _quadratic(rng)
    cfg = OptimizerConfig(max_iters=40, tolerance=1e-9)
    crashed = RunCheckpointer(str(tmp_path), every_solver_iters=1,
                              resume=True)
    with ckpt.session(crashed), crashed.scope("it1", "q"):
        with pytest.raises(_Interrupt):
            streaming_lbfgs_solve(_flaky(vg, 6), torch.zeros(d), cfg,
                                  label="q")
    full = _counting(vg)
    streaming_lbfgs_solve(full, torch.ones(d), cfg, label="q")
    resumed = RunCheckpointer(str(tmp_path), every_solver_iters=1,
                              resume=True)
    counted = _counting(vg)
    with ckpt.session(resumed), resumed.scope("it1", "q"):
        streaming_lbfgs_solve(counted, torch.ones(d), cfg, label="q")
    assert counted.calls == full.calls


def test_run_logger_append_to_empty_file_is_clean(tmp_path):
    path = str(tmp_path / "run_log.jsonl")
    open(path, "w").close()
    with RunLogger(path, mode="a", header=True,
                   run_info={"resume": True}) as log:
        log.event("x")
    assert [e["event"] for e in read_run_log(path)] == ["run_header", "x"]
    # A predecessor killed mid-line: the appended run starts on its own
    # line.
    with open(path, "a") as f:
        f.write('{"t": 1, "event": "tor')
    with RunLogger(path, mode="a", header=True) as log:
        log.event("y")
    with open(path) as f:
        tail = f.read().splitlines()[-2:]
    assert [json.loads(line)["event"] for line in tail] == ["run_header",
                                                            "y"]


# -- checkpoints across the packages ---------------------------------------------------


def _jax_quadratic(jax, X, y):
    jnp = jax.numpy
    n = X.shape[0]

    def vg(w):
        r = X @ jnp.asarray(w, jnp.float32) - y
        return 0.5 * jnp.mean(r * r), X.T @ r / n

    return vg


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_mid_solve_checkpoint_resumes_across_packages(rng, tmp_path,
                                                      first):
    """A streaming L-BFGS interrupted mid-solve under one package's
    checkpointer resumes under the other's (the same label, fingerprint
    and state tree) and ends at the first package's uninterrupted
    coefficients within 1e-3, without repaying the solve."""
    import jax

    from photon_ml_tpu.optim.base import OptimizerConfig as JCfg
    from photon_ml_tpu.optim.streaming import streaming_lbfgs_solve as jsolve
    from photon_ml_tpu.reliability import checkpoint as jckpt

    d, vg, _, _, X, y = _quadratic(rng)
    jvg = _jax_quadratic(jax, X, y)
    jnp = jax.numpy
    cfg, jcfg = (OptimizerConfig(max_iters=40, tolerance=1e-9),
                 JCfg(max_iters=40, tolerance=1e-9))
    jz = jnp.zeros(d, jnp.float32)

    def run(pkg, fn, label_ck):
        if pkg == "jax":
            ck = jckpt.RunCheckpointer(str(tmp_path), every_solver_iters=1,
                                       resume=True)
            with jckpt.session(ck), ck.scope("it1", "q"):
                return jsolve(fn, jz, jcfg, label="q")
        ck = RunCheckpointer(str(tmp_path), every_solver_iters=1,
                             resume=True)
        with ckpt.session(ck), ck.scope("it1", "q"):
            return streaming_lbfgs_solve(fn, torch.zeros(d), cfg, label="q")

    if first == "jax":
        ref = np.asarray(jsolve(jvg, jz, jcfg, label="q").w)
        with pytest.raises(_Interrupt):
            run("jax", _flaky(jvg, 6), None)
        assert glob.glob(str(tmp_path / "solver_*.npz"))
        counted = _counting(vg)
        w = run("torch", counted, None).w.numpy()
    else:
        full = _counting(vg)
        ref = streaming_lbfgs_solve(full, torch.zeros(d), cfg).w.numpy()
        with pytest.raises(_Interrupt):
            run("torch", _flaky(vg, 6), None)
        assert glob.glob(str(tmp_path / "solver_*.npz"))
        counted = _counting(jvg)
        w = np.asarray(run("jax", counted, None).w)
    assert counted.calls < 40     # resumed, not solved again
    np.testing.assert_allclose(w, ref, rtol=0, atol=CROSS_ATOL)
    assert glob.glob(str(tmp_path / "solver_*.npz")) == []


# -- the streamed random effect's state and the fused cycle across packages ----


def _re_dataset(rng, pkg="torch", n=600):
    ids = rng.integers(0, 40, n)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    labels = (rng.uniform(size=n) < 0.5).astype(np.float32)
    if pkg == "jax":
        from photon_ml_tpu.game.dataset import GameDataset as D
    else:
        D = GameDataset
    return D(labels=labels, features={"re": x}, entity_ids={"user": ids},
             feature_dims={"re": 3})


def test_streamed_re_runtime_state_roundtrip(rng, tmp_path):
    """The streamed random effect's retirement state through a CD
    snapshot: a fresh coordinate restores it, its blocks pass the
    warm-start identity check (the retired set and the cached scores
    survive) and its next sweep matches the uninterrupted coordinate's;
    the same snapshot loads in the JAX package's checkpointer and
    restores into its streamed coordinate with the same retired set."""
    from photon_ml_tpu.reliability.checkpoint import RunCheckpointer as JCk

    from photon_ml_torch.game.coordinates import (
        build_streamed_random_effect_coordinate,
    )

    ds = _re_dataset(rng)
    obj = GLMObjective(loss=losses.LOGISTIC,
                       reg=RegularizationContext.l2(1.0),
                       norm=NormalizationContext.identity())

    def build():
        return build_streamed_random_effect_coordinate(
            "user", ds, "re", obj, spill_dir=str(tmp_path / "spill"),
            chunk_entities=8, config=OptimizerConfig(max_iters=25),
            retirement=True, device=CPU)

    offsets = torch.from_numpy(rng.normal(0, 0.1, ds.n).astype(np.float32))
    c1 = build()
    blocks1, _ = c1.train(offsets)
    blocks1, _ = c1.train(offsets, warm_start=blocks1)
    c1.retire_converged()
    retired = c1.entities_retired
    assert retired > 0
    ck = RunCheckpointer(str(tmp_path / "ck"))
    ck.save_cd(1, {"user": blocks1}, scores={"user": c1.score(blocks1)},
               re_state={"user": c1.runtime_state()})
    state = RunCheckpointer(str(tmp_path / "ck"),
                            resume=True).load_latest_cd()["re_state"]["user"]
    c2 = build()
    blocks2, cached = c2.restore_runtime_state(state)
    assert c2.entities_retired == retired
    np.testing.assert_array_equal(c2.score(blocks2).numpy(), cached.numpy())
    b_next_1, diag1 = c1.train(offsets, warm_start=blocks1)
    b_next_2, diag2 = c2.train(offsets, warm_start=blocks2)
    assert diag2["entities_retired"] == diag1["entities_retired"]
    assert diag2["entities_solved"] == diag1["entities_solved"] \
        < c1.grouping.n_total_entities
    for w1, w2 in zip(b_next_1, b_next_2):
        np.testing.assert_array_equal(w1.numpy(), w2.numpy())
    jstate = JCk(str(tmp_path / "ck"),
                 resume=True).load_latest_cd()["re_state"]["user"]
    assert [np.asarray(a).sum() for a in jstate["active"]] == \
        [a.sum() for a in state["active"]]


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_fused_resume_across_packages(jax_c1, first, tmp_path):
    """A fused fit checkpointed for 3 cycles by one package and resumed
    to 8 by the other (the engine's fingerprint, step scale and
    retirement state under ``re_state["__cd_fused__"]``) ends where the
    resuming package's uninterrupted 8-cycle fit ends."""
    from photon_ml_tpu.config import training_config_from_json as jcfg
    from photon_ml_tpu.estimators.game_estimator import GameEstimator as JE

    from test_torch_fused_cd import _arrays, _cfg_dict, _dataset

    a = _arrays(np.random.default_rng(5))
    ck = str(tmp_path / "ck")

    def fit(pkg, iters, **kw):
        cfg = json.dumps(_cfg_dict(True, iters, tolerance=1e-4, **kw))
        if pkg == "jax":
            res = JE(jcfg(cfg)).fit(_dataset(a, "jax"))[0]
        else:
            from photon_ml_torch.config import training_config_from_json

            res = GameEstimator(training_config_from_json(
                cfg[:-1] + ', "device": "cpu"}')).fit(_dataset(a))[0]
        m = res.model.models
        return (np.asarray(m["global"].coefficients.means),
                [np.asarray(b) for b in m["per_u"].coefficient_blocks])

    second = "torch" if first == "jax" else "jax"
    full = fit(second, 8)
    fit(first, 3, checkpoint_dir=ck)
    resumed = fit(second, 8, checkpoint_dir=ck, resume=True)
    np.testing.assert_allclose(resumed[0], full[0], rtol=0, atol=CROSS_ATOL)
    for r, f in zip(resumed[1], full[1]):
        np.testing.assert_allclose(r, f, rtol=0, atol=CROSS_ATOL)
