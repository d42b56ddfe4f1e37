"""The resident solvers and the fixed-effect set-up seen from inside the
port: the ``solver.resident.*`` counters against each solve's own
record, the spans as ``photon::`` ranges of a ``torch.profiler`` trace
(and nothing of them without a session), coefficients bitwise the same
with telemetry off and on, the set-up and random-effect bucket spans,
device time by span on synthetic events, and the benchmark's untraced
run opening no session.

This file imports no JAX: its ``cuda`` test runs on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_solver_tracing.py
"""

from __future__ import annotations

import importlib.util
import json
import os
import time
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from photon_ml_torch import telemetry
from photon_ml_torch.analysis.guards import no_implicit_transfers
from photon_ml_torch.data.batch import make_sparse_batch
from photon_ml_torch.data.normalization import NormalizationContext
from photon_ml_torch.data.sparse_rows import SparseRows
from photon_ml_torch.ops import losses
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.ops.regularization import RegularizationContext
from photon_ml_torch.optim.base import OptimizerConfig
from photon_ml_torch.optim.lbfgs import lbfgs_solve
from photon_ml_torch.optim.tron import tron_solve
from photon_ml_torch.telemetry.__main__ import main as telemetry_main
from photon_ml_torch.telemetry.device import device_s_by_span
from photon_ml_torch.utils.run_log import read_run_log

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, K, N = 61, 5, 600
ITERATION_SPANS = ("lbfgs.direction", "lbfgs.line_search",
                   "lbfgs.gradient", "lbfgs.update")
# (solver, max_iters, tolerance): capped at max_iters, or converged first.
SOLVES = {"lbfgs_capped": ("lbfgs", 6, 1e-9),
          "lbfgs_converged": ("lbfgs", 200, 1e-2),
          "owlqn_capped": ("owlqn", 6, 1e-9),
          "tron_capped": ("tron", 3, 1e-9),
          "tron_converged": ("tron", 200, 1e-3)}


@pytest.fixture(autouse=True)
def _no_leaked_session():
    assert telemetry.active() is None
    yield
    assert telemetry.active() is None


def _flat(seed=5):
    rng = np.random.default_rng(seed)
    cols = np.stack([np.sort(rng.choice(D, K, replace=False))
                     for _ in range(N)]).reshape(-1)
    vals = rng.normal(size=N * K).astype(np.float32)
    labels = (rng.uniform(size=N) < 0.4).astype(np.float32)
    return np.arange(N + 1, dtype=np.int64) * K, cols, vals, labels


def _batch(device="cpu"):
    indptr, cols, vals, labels = _flat()
    return make_sparse_batch(SparseRows.from_flat(indptr, cols, vals), D,
                             labels, device=device)


def _objective():
    return GLMObjective(loss=losses.LOGISTIC,
                        reg=RegularizationContext.l2(1.0),
                        norm=NormalizationContext.identity())


class _Counted:
    """The objective's calls a solver makes, counted at its boundary."""

    def __init__(self, obj, batch):
        self.obj, self.batch, self.calls = obj, batch, 0

    def value_and_grad(self, w):
        self.calls += 1
        return self.obj.value_and_gradient(w, self.batch)

    def value(self, w):
        self.calls += 1
        return self.obj.value(w, self.batch)

    def hvp(self, w, v):
        return self.obj.hessian_vector(w, v, self.batch)


def _solve(kind: str, device="cpu", batch=None):
    """One solve of ``SOLVES[kind]`` → (result, objective calls)."""
    solver, max_iters, tol = SOLVES[kind]
    f = _Counted(_objective(), _batch(device) if batch is None else batch)
    cfg = OptimizerConfig(max_iters=max_iters, tolerance=tol)
    w0 = torch.zeros(D, device=device)
    if solver == "tron":
        res = tron_solve(f.value_and_grad, f.hvp, w0, cfg)
    else:
        l1 = 0.05 if solver == "owlqn" else None
        res = lbfgs_solve(f.value_and_grad, w0, cfg, l1_weight=l1,
                          value=f.value)
    return res, f.calls


def _per_iteration(res) -> list:
    """The tracker's trials (TRON: CG steps) of each iteration."""
    t = res.tracker.ls_trials.cpu().numpy()
    return [int(x) for x in t[1:res.tracker.count]]


@pytest.mark.parametrize("kind", sorted(SOLVES))
def test_solver_counters_match_the_solve(kind):
    """Iterations as the result says; L-BFGS trials as its tracker says
    and one evaluation a trial and a gradient; each loop read counted,
    plus the three of the one-lane result: reads = evaluations + 2 for
    a solve capped at max_iters, + 3 for one that converged first."""
    solver, max_iters, _ = SOLVES[kind]
    t = telemetry.start("metrics", device="cpu")
    try:
        res, calls = _solve(kind)
        c = t.summary()["counters"]
    finally:
        t.close()
    iters, steps = res.iterations, _per_iteration(res)
    assert c["solver.resident.iterations"] == iters == len(steps)
    stopped_early = int(iters < max_iters)
    assert stopped_early == int(kind.endswith("converged"))
    if solver == "tron":
        cg_max = OptimizerConfig().cg_max_iters
        cg_reads = sum(min(s + 1, cg_max) for s in steps)
        assert c["solver.resident.host_reads"] == (
            cg_reads + iters + stopped_early + 3)
        assert "solver.resident.ls_trials" not in c
        return
    assert c["solver.resident.ls_trials"] == sum(steps)
    assert c["solver.resident.evaluations"] == calls == 1 + sum(steps) + iters
    assert c["solver.resident.host_reads"] == calls + 2 + stopped_early
    # The streamed solver's odometer counters stay the streamed solver's.
    assert "solver.ls_trials" not in c and "solver.iterations" not in c


def _photon(events) -> list:
    return [e for e in events if e.name.startswith(telemetry.PROFILER_PREFIX)]


def _ancestors(e) -> list:
    out, p = [], e.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


def test_spans_are_profiler_ranges_in_a_session():
    """Under ``torch.profiler`` with a session: the four iteration ranges
    once an iteration inside ``photon::lbfgs.solve``; every ``photon::xtr``
    inside the solve, all but the first evaluation's inside
    ``photon::lbfgs.gradient``."""
    batch = _batch()
    t = telemetry.start("metrics", device="cpu")
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            res, _ = _solve("lbfgs_capped", batch=batch)
    finally:
        t.close()
    ranges = _photon(prof.events())
    names = [e.name for e in ranges]
    assert names.count("photon::lbfgs.solve") == 1
    for span in ITERATION_SPANS:
        assert names.count("photon::" + span) == res.iterations
    for e in ranges:
        if e.name != "photon::lbfgs.solve":
            assert "photon::lbfgs.solve" in _ancestors(e), e.name
    xtr = [_ancestors(e) for e in ranges if e.name == "photon::xtr"]
    assert len(xtr) == res.iterations + 1
    assert sum("photon::lbfgs.gradient" in a for a in xtr) == res.iterations


def test_no_session_no_ranges_and_no_range_without_a_profiler(monkeypatch):
    """Without a session a profiled solve holds no ``photon::`` range;
    with a session and no profiler no range is opened at all."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _solve("lbfgs_capped")
    assert _photon(prof.events()) == []
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or real(name))
    t = telemetry.start("metrics", device="cpu")
    try:
        _solve("lbfgs_capped")
        assert t.summary()["spans"]["lbfgs.solve"]["count"] == 1
    finally:
        t.close()
    assert opened == []


@pytest.mark.parametrize("kind", sorted(SOLVES))
def test_coefficients_bitwise_with_telemetry_off_and_on(kind, tmp_path):
    """Off, a metrics session, and a trace session under the profiler:
    the same coefficients, bit for bit."""
    out = {}
    for mode in ("off", "metrics", "trace"):
        t = (telemetry.start(mode, telemetry_dir=str(tmp_path / mode),
                             device="cpu") if mode != "off" else None)
        try:
            if mode == "trace":
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CPU]):
                    res, _ = _solve(kind)
            else:
                res, _ = _solve(kind)
        finally:
            if t is not None:
                t.close()
        out[mode] = res.w
    assert torch.equal(out["metrics"], out["off"])
    assert torch.equal(out["trace"], out["off"])


def test_setup_spans_of_rows_and_batch():
    """``from_flat`` and both row paths of ``make_sparse_batch`` record
    their set-up spans, once a call."""
    indptr, cols, vals, labels = _flat()
    t = telemetry.start("metrics", device="cpu")
    try:
        rows = SparseRows.from_flat(indptr, cols, vals)
        make_sparse_batch(rows, D, labels, device="cpu")
        make_sparse_batch(list(rows), D, labels, device="cpu")
        spans = t.summary()["spans"]
    finally:
        t.close()
    assert spans["data.from_flat"]["count"] == 1
    assert spans["prepare.ell"]["count"] == 2
    assert spans["prepare.place"]["count"] == 2
    assert all(spans[s]["cat"] == "setup"
               for s in ("data.from_flat", "prepare.ell", "prepare.place"))


def test_game_fit_records_setup_and_bucket_spans(tmp_path, capsys):
    """A resident GAME fit (fixed effect and one random effect) in trace
    mode: the fixed effect's set-up spans, one ``re.bucket_solve`` a
    bucket and sweep with its lanes and rows, the resident counters, and
    a report that still exits 0 (the streamed odometer untouched)."""
    from photon_ml_torch.config import (
        CoordinateConfig,
        CoordinateKind,
        OptimizerSettings,
        TrainingConfig,
    )
    from photon_ml_torch.estimators.game_estimator import GameEstimator
    from photon_ml_torch.game.dataset import GameDataset
    from photon_ml_torch.models.glm import TaskType

    indptr, cols, vals, labels = _flat(9)
    rng = np.random.default_rng(9)
    train = GameDataset(
        labels=labels,
        features={"global": SparseRows.from_flat(indptr, cols, vals),
                  "re": rng.normal(size=(N, 3)).astype(np.float32)},
        entity_ids={"u": rng.integers(0, 25, N)},
        feature_dims={"global": D})
    cfg = TrainingConfig(
        task_type=TaskType.LOGISTIC_REGRESSION,
        coordinates=[
            CoordinateConfig(name="global", kind=CoordinateKind.FIXED_EFFECT,
                             feature_shard="global",
                             optimizer=OptimizerSettings(max_iters=5)),
            CoordinateConfig(name="u", kind=CoordinateKind.RANDOM_EFFECT,
                             feature_shard="re", entity_key="u",
                             optimizer=OptimizerSettings(max_iters=5))],
        update_sequence=["global", "u"], n_iterations=2, evaluators=[],
        telemetry="trace", telemetry_dir=str(tmp_path / "tel"),
        output_dir=str(tmp_path / "out"), device="cpu")
    GameEstimator(cfg).fit(train)
    log_path = str(tmp_path / "tel" / "run_log.jsonl")
    events = read_run_log(log_path)
    spans = [e for e in events if e["event"] == "span"]
    names = {e["name"] for e in spans}
    assert {"prepare.rows", "prepare.ell", "prepare.place", "lbfgs.solve",
            "xtr", *ITERATION_SPANS} <= names
    buckets = [e for e in spans if e["name"] == "re.bucket_solve"]
    assert buckets and len(buckets) % cfg.n_iterations == 0
    assert all(e["cat"] == "solver" and e["args"]["lanes"] >= 1
               and e["args"]["rows"] >= 1 for e in buckets)
    summary = next(e for e in events if e["event"] == "telemetry_summary")
    c = summary["counters"]
    # One solve a sweep of the fixed effect, one a bucket and sweep.
    assert summary["spans"]["lbfgs.solve"]["count"] == (
        cfg.n_iterations + len(buckets))
    assert c["solver.resident.iterations"] > 0
    assert c["solver.resident.host_reads"] > c["solver.resident.iterations"]
    assert telemetry_main(["report", log_path]) == 0
    capsys.readouterr()


def _cpu(name, parent=None, id=0):
    return types.SimpleNamespace(name=name, device_type=DeviceType.CPU,
                                 cpu_parent=parent, id=id)


def _dev(name, start, end, id=0, annotation=False):
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA, id=id,
        is_user_annotation=annotation,
        time_range=types.SimpleNamespace(start=start, end=end))


def test_device_s_by_span_on_synthetic_events():
    """Each device activity goes through the CUDA call that launched it
    (same id; an operation's id may repeat one) to that call's enclosing
    ranges (nested spans included, a repeated name once), its innermost
    range, or outside; an activity with no launch is unlinked; busy time
    is the union of device work, the device's copies of the ranges left
    out."""
    solve = _cpu("photon::lbfgs.solve", id=1)
    grad = _cpu("photon::lbfgs.gradient", solve, id=2)
    xtr = _cpu("photon::xtr", grad, id=3)
    inner = _cpu("photon::xtr", xtr, id=4)                  # the same name
    direction = _cpu("photon::lbfgs.direction", solve, id=5)
    index_add = _cpu("aten::index_add_", inner, id=11)      # shares an id
    mul = _cpu("aten::mul", direction, id=6)
    events = [
        solve, grad, xtr, inner, direction, index_add, mul,
        _cpu("cudaLaunchKernel", index_add, id=11),
        _cpu("cudaLaunchKernel", xtr, id=12),          # B1 through ctypes
        _cpu("cudaLaunchKernel", mul, id=13),
        _cpu("cudaMemsetAsync", solve, id=14),
        _cpu("cudaLaunchKernel", None, id=15),
        _dev("indexFuncLargeIndex", 0, 30, id=11),
        _dev("gather_rowsum_kernel", 30, 34, id=12),
        _dev("elementwise_kernel", 32, 42, id=13),
        _dev("Memset (Device)", 50, 55, id=14),
        _dev("reduce_kernel", 60, 62, id=15),
        _dev("elementwise_kernel", 70, 71, id=99),
        _dev("photon::lbfgs.solve", 0, 100, id=1),
        _dev("gpu_user_annotation", 0, 90, id=2, annotation=True),
    ]
    got = device_s_by_span(events)
    us = 1e-6
    assert got["busy_s"] == pytest.approx(50 * us)
    assert got["outside_s"] == pytest.approx(2 * us)
    assert got["unlinked_s"] == pytest.approx(1 * us)
    assert got["spans"] == pytest.approx({
        "xtr": 34 * us, "lbfgs.gradient": 34 * us,
        "lbfgs.direction": 10 * us, "lbfgs.solve": 49 * us})
    assert got["innermost"] == pytest.approx({
        "xtr": 34 * us, "lbfgs.direction": 10 * us, "lbfgs.solve": 5 * us})
    assert device_s_by_span([]) == {"busy_s": 0.0, "spans": {},
                                    "innermost": {}, "outside_s": 0.0,
                                    "unlinked_s": 0.0}


def test_untraced_benchmark_run_opens_no_session(monkeypatch):
    """The benchmark's ``--trace 0`` run of the fixed-effect cell, cut to
    a tiny size: no telemetry session is open during any fit."""
    from gpubench import manifest, port, run

    cell = manifest.cell("glm-fit")
    cell["config"].update(rows=3000, features=300, nnz_per_row=8)
    seen = []
    solve = port.fixed_effect_solve

    def watched(coord, w0):
        seen.append(telemetry.active())
        return solve(coord, w0)

    monkeypatch.setattr(port, "fixed_effect_solve", watched)
    result, _ = run.run_cell(cell, 2 ** 31 + 7, 0.2, False, "cpu",
                             time.time(), port=port)
    assert result["correct"] and len(seen) >= 2
    assert seen == [None] * len(seen)


def test_glm_fit_spans_script_on_cpu(tmp_path, capsys):
    """``examples/glm_fit_spans.py`` at a tiny size on the CPU: the
    in-program evaluation count equals the benchmark's wrapper count,
    the set-up spans are read, and a session leaves the fit bitwise."""
    spec = importlib.util.spec_from_file_location(
        "glm_fit_spans", os.path.join(REPO, "examples", "glm_fit_spans.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = tmp_path / "spans.json"
    assert script.main(["--device", "cpu", "--rows", "3000", "--features",
                        "300", "--nnz", "8", "--fits", "2", "--rounds", "1",
                        "--block", "1", "--out", str(out)]) == 0
    capsys.readouterr()
    got = json.loads(out.read_text())
    assert got["evaluations_per_fit"] == got["evals_per_fit"] > 0
    assert got["host_reads_per_fit"] >= got["evaluations_per_fit"] + 2
    assert got["ls_trials_per_iter"] >= 1
    assert got["etl_s"] > 0 and got["place_s"] > 0
    assert set(got["setup_spans_s"]) == {
        "data.from_flat", "prepare.rows", "prepare.ell", "prepare.place"}
    assert got["cost"]["bitwise"] is True


@pytest.mark.cuda
def test_resident_solve_syncs_are_its_counted_reads():
    """On the card: a one-lane L-BFGS solve blocks the host as often
    with a metrics session as without one, and as often as its
    ``solver.resident.host_reads`` counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda")
    batch = _batch(dev)
    _solve("lbfgs_capped", dev, batch)           # builds, warms
    torch.cuda.synchronize()
    counts, reads, out = {}, None, {}
    for mode in ("off", "metrics"):
        t = telemetry.start(mode, device=dev) if mode != "off" else None
        try:
            with no_implicit_transfers("log", dev) as log:
                res, _ = _solve("lbfgs_capped", dev, batch)
            if t is not None:
                reads = t.counter("solver.resident.host_reads")
        finally:
            if t is not None:
                t.close()
        counts[mode] = log.count
        out[mode] = res.w.cpu()
    assert counts["metrics"] == counts["off"] == reads, (counts, reads)
    assert torch.equal(out["metrics"], out["off"])
