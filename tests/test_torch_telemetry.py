"""The port's telemetry tier against ``tests/test_telemetry.py`` and
against the JAX package.

Each case of the reference's telemetry tests is ported to
``photon_ml_torch.telemetry`` on the CPU (sessions, counters, Chrome
export, the report and its odometer, liveness events, the estimator and
the drivers, device accounting, convergence, history).  Where the JAX
package runs the same thing, the port is held against it on the same
numpy-seeded data:

- the odometer counters (``solver.*``, ``re.*``), ``store.loads`` and
  ``prefetch.chunks_produced``/``consumed`` are equal on fits whose
  iteration counts match (asserted first);
- ``re_convergence`` solved and retired counts are equal;
- each package's ``report`` on the other's log gives the same verdict,
  the same odometer and a coverage within 1e-9 of its own reading;
- ``history`` gives the same trajectory and flags;
- ``utils.synthetic`` gives bitwise the same arrays.

Telemetry changes no result: coefficients are bitwise equal with it off,
in metrics mode and in trace mode.  Every reference session a test
starts is closed in a ``finally`` (an open one would keep
``jax.log_compiles`` on for the reference's compile-budget tests on the
same worker); an autouse fixture asserts that neither package's session
is left active.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from photon_ml_torch import telemetry
from photon_ml_torch.analysis.guards import count_compiles
from photon_ml_torch.data.chunked_batch import build_chunked_batch
from photon_ml_torch.data.normalization import NormalizationContext
from photon_ml_torch.data.sparse_rows import SparseRows
from photon_ml_torch.kernels import _build
from photon_ml_torch.ops import losses
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.ops.regularization import (
    RegularizationContext,
    SweptRegularization,
)
from photon_ml_torch.optim.base import OptimizerConfig
from photon_ml_torch.optim.streaming import (
    ChunkedGLMObjective,
    ChunkPrefetcher,
    streaming_lbfgs_solve,
    streaming_lbfgs_solve_swept,
    streaming_tron_solve,
)
from photon_ml_torch.telemetry.__main__ import main as telemetry_main
from photon_ml_torch.utils.run_log import RunLogger, read_run_log
from test_torch_training import (  # noqa: F401  (C1, C5)
    jax_c1,
    jax_fresh_caches,
)

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 89            # not the reference tests' 83: their compile budgets
K = 4
CHUNK_ROWS = 200
N_CHUNKS = 6
# Coverage of one log read by both packages' reports.
COVERAGE_ATOL = 1e-9


@pytest.fixture(autouse=True)
def _no_leaked_session():
    """Every test leaves both packages' sessions closed."""
    import photon_ml_tpu.telemetry as jtel

    assert telemetry.active() is None and jtel.active() is None
    yield
    leaked = [t for t in (telemetry.active(), jtel.active()) if t is not None]
    for t in leaked:
        t.close()
    assert not leaked, "test leaked an active telemetry session"


# -- data ---------------------------------------------------------------------


def _problem(seed=7):
    rng = np.random.default_rng(seed)
    n = CHUNK_ROWS * N_CHUNKS
    cols = np.stack([np.sort(rng.choice(D, K, replace=False))
                     for _ in range(n)]).astype(np.int64)
    vals = rng.normal(size=(n, K)).astype(np.float32)
    labels = (rng.uniform(size=n) < 0.5).astype(np.float32)
    indptr = np.arange(n + 1, dtype=np.int64) * K
    return indptr, cols.reshape(-1), vals.reshape(-1), labels


def _spilled_objective(tmp_path, seed=7, name="spill"):
    indptr, cols, vals, labels = _problem(seed)
    rows = SparseRows.from_flat(indptr, cols, vals)
    obj = GLMObjective(loss=losses.LOGISTIC,
                       reg=RegularizationContext.l2(1.0),
                       norm=NormalizationContext.identity())
    cb = build_chunked_batch(rows, D, labels, n_chunks=N_CHUNKS,
                             layout="ell", spill_dir=str(tmp_path / name),
                             host_max_resident=2)
    return ChunkedGLMObjective(obj, cb, max_resident=0, prefetch_depth=2,
                               device=CPU)


def _ref_spilled_objective(tmp_path, seed=7):
    from photon_ml_tpu.data.chunked_batch import build_chunked_batch as jb
    from photon_ml_tpu.data.normalization import NormalizationContext as JN
    from photon_ml_tpu.data.sparse_rows import SparseRows as JR
    from photon_ml_tpu.ops import losses as jl
    from photon_ml_tpu.ops.objective import GLMObjective as JO
    from photon_ml_tpu.ops.regularization import RegularizationContext as JRC
    from photon_ml_tpu.optim.streaming import ChunkedGLMObjective as JC

    indptr, cols, vals, labels = _problem(seed)
    rows = JR.from_flat(indptr, cols, vals)
    obj = JO(loss=jl.LOGISTIC, reg=JRC.l2(1.0), norm=JN.identity())
    cb = jb(rows, D, labels, n_chunks=N_CHUNKS, layout="ell",
            spill_dir=str(tmp_path / "ref_spill"), host_max_resident=2)
    return JC(obj, cb, max_resident=0, prefetch_depth=2)


LAMS = (3.0, 1.0, 0.3)


def _fit(cobj, kind="lbfgs", max_iters=4):
    """A streamed solve of the port: L-BFGS, TRON with the Jacobi
    preconditioner, or the swept λ grid."""
    cfg = OptimizerConfig(max_iters=max_iters, tolerance=1e-9)
    if kind == "tron":
        return streaming_tron_solve(
            cobj.value_and_gradient, cobj.hvp_pass, torch.zeros(D), cfg,
            hessian_diag=cobj.hessian_diagonal, label="t")
    if kind == "swept":
        reg = SweptRegularization(l1_weights=torch.zeros(len(LAMS)),
                                  l2_weights=torch.tensor(LAMS))
        return streaming_lbfgs_solve_swept(
            lambda W: cobj.value_and_gradient_swept(W, reg),
            lambda W: cobj.value_swept(W, reg),
            torch.zeros(len(LAMS), D), cfg, label="global")
    return streaming_lbfgs_solve(cobj.value_and_gradient, torch.zeros(D),
                                 cfg, value_fn=cobj.value)


def _ref_fit(cobj, kind="lbfgs", max_iters=4):
    import jax.numpy as jnp

    from photon_ml_tpu.ops.regularization import SweptRegularization as JS
    from photon_ml_tpu.optim import OptimizerConfig as JCfg
    from photon_ml_tpu.optim import streaming as js

    cfg = JCfg(max_iters=max_iters, tolerance=1e-9)
    if kind == "tron":
        return js.streaming_tron_solve(
            cobj.value_and_gradient, cobj.hvp_pass,
            jnp.zeros(D, jnp.float32), cfg,
            hessian_diag=cobj.hessian_diagonal, label="t")
    if kind == "swept":
        reg = JS(l1_weights=jnp.zeros(len(LAMS), jnp.float32),
                 l2_weights=jnp.asarray(LAMS, jnp.float32))
        return js.streaming_lbfgs_solve_swept(
            lambda W: cobj.value_and_gradient_swept(W, reg),
            lambda W: cobj.value_swept(W, reg),
            jnp.zeros((len(LAMS), D), jnp.float32), cfg, label="global")
    return js.streaming_lbfgs_solve(cobj.value_and_gradient,
                                    jnp.zeros(D, jnp.float32), cfg,
                                    value_fn=cobj.value)


def _session_fit(tmp_path, mode="metrics", kind="lbfgs", phase=True):
    """A port fit inside a session of ``mode`` over a ``fit`` phase;
    returns (log path, summary, result, objective)."""
    cobj = _spilled_objective(tmp_path)
    log_path = str(tmp_path / "run_log.jsonl")
    log = RunLogger(log_path)
    t = telemetry.start(mode, telemetry_dir=str(tmp_path), run_logger=log,
                        device="cpu")
    try:
        if phase:
            with log.timed("fit"):
                res = _fit(cobj, kind)
        else:
            res = _fit(cobj, kind)
        summary = t.summary()
    finally:
        t.close()
        log.close()
    return log_path, summary, res, cobj


def _ref_session_fit(tmp_path, mode="metrics", kind="lbfgs"):
    from photon_ml_tpu import telemetry as jtel
    from photon_ml_tpu.utils.run_log import RunLogger as JLog

    cobj = _ref_spilled_objective(tmp_path)
    log_path = str(tmp_path / "ref_run_log.jsonl")
    log = JLog(log_path)
    t = jtel.start(mode, telemetry_dir=str(tmp_path / "ref"),
                   run_logger=log)
    try:
        with log.timed("fit"):
            res = _ref_fit(cobj, kind)
        summary = t.summary()
    finally:
        t.close()
        log.close()
    return log_path, summary, res, cobj


def _tail(capsys) -> tuple[str, dict]:
    out = capsys.readouterr().out
    return out, json.loads(out.strip().splitlines()[-1])


def _threads(name: str) -> list:
    return [th for th in threading.enumerate() if th.name == name]


# -- the off path -------------------------------------------------------------


def test_off_is_noop_and_emits_nothing(tmp_path):
    """No session: the helpers are no-ops, an instrumented streamed fit
    writes no telemetry event, and no telemetry thread starts."""
    assert telemetry.active() is None
    with telemetry.span("anything", cat="x", k=1) as sp:
        assert sp.__class__.__name__ == "_NullSpan"
    assert telemetry.device_timed("p", torch.device("cuda")) is sp
    telemetry.count("c", 5)
    telemetry.gauge("g", 1.0)
    telemetry.observe("h", 0.5)
    telemetry.heartbeat("stage")
    telemetry.device_memory("x")

    log = RunLogger(str(tmp_path / "log.jsonl"))
    cobj = _spilled_objective(tmp_path)
    _fit(cobj, max_iters=2)
    log.close()
    events = read_run_log(str(tmp_path / "log.jsonl"))
    assert [e["event"] for e in events] == ["run_header"]
    assert not _threads("photon-telemetry-rss")


def test_maybe_session_off_and_nested(tmp_path):
    with telemetry.maybe_session("off") as t:
        assert t is None
    with telemetry.maybe_session(None) as t:
        assert t is None
    with telemetry.maybe_session("metrics", str(tmp_path),
                                device="cpu") as outer:
        assert telemetry.active() is outer
        with telemetry.maybe_session("trace", str(tmp_path),
                                    device="cpu") as inner:
            assert inner is outer
        assert telemetry.active() is outer
    assert telemetry.active() is None
    assert not _threads("photon-telemetry-rss")


def test_double_start_rejected(tmp_path):
    t = telemetry.start("metrics", device="cpu")
    try:
        with pytest.raises(RuntimeError, match="already active"):
            telemetry.start("metrics", device="cpu")
        with pytest.raises(ValueError, match="mode"):
            telemetry.Telemetry("off", None, None)
    finally:
        t.close()
    assert telemetry.active() is None
    with pytest.raises(ValueError, match="active mode"):
        telemetry.start("off")


def test_config_validation(tmp_path):
    """``telemetry`` and ``profile_dir`` validate as in the reference;
    the monitor's knobs and serving telemetry validate as there."""
    from photon_ml_torch.config import ScoringConfig, ServingConfig

    cfg = ScoringConfig(input_path="x", model_dir="m", telemetry="trace")
    cfg.validate()
    cfg.telemetry = "verbose"
    with pytest.raises(ValueError, match="telemetry"):
        cfg.validate()
    cfg.telemetry, cfg.monitor = "metrics", "on"
    cfg.validate()
    tc = _dense_config(tmp_path, telemetry="trace", profile_dir="prof")
    tc.validate()
    tc.telemetry = "loud"
    with pytest.raises(ValueError, match="telemetry"):
        tc.validate()
    tc.telemetry = "metrics"
    tc.status_port = 0
    tc.validate()
    tc.status_port = -1
    with pytest.raises(ValueError, match="status_port"):
        tc.validate()
    ServingConfig(model_dir="m", telemetry="metrics").validate()
    with pytest.raises(ValueError, match="telemetry"):
        ServingConfig(model_dir="m", telemetry="loud").validate()


# -- metrics against ground truth ------------------------------------------------


def test_metrics_match_ground_truth_on_streamed_fit(tmp_path):
    """Store hits and loads, the sweep odometer, the prefetcher's chunk
    counts and the kernel-build count match the subsystems' own
    records on a small spilled fit."""
    cobj = _spilled_objective(tmp_path)
    log = RunLogger(str(tmp_path / "run_log.jsonl"))
    t = telemetry.start("metrics", run_logger=log, device="cpu")
    try:
        with count_compiles() as cc:
            _fit(cobj)
        summary = t.summary()
    finally:
        t.close()
        log.close()
    c = summary["counters"]
    store = cobj.batch.store
    assert c["solver.sweeps"] == cobj.sweeps > 0
    assert c["store.hits"] == store.hits
    assert c["store.loads"] == store.loads > 0
    # The port's pipeline reads every spill file memory-mapped.
    assert c["store.mmap_loads"] == store.loads
    assert c.get("kernels.builds", 0) == cc.count == 0   # nothing built
    assert c["prefetch.chunks_consumed"] == cobj.sweeps * N_CHUNKS
    assert c["prefetch.chunks_produced"] == cobj.sweeps * N_CHUNKS
    assert c["prefetch.consumer_wait_s"] == pytest.approx(
        cobj.stats["consumer_wait_s"], abs=1e-5)
    assert c["solver.iterations"] >= 1
    assert c["solver.ls_trials"] >= c["solver.iterations"]
    d = summary["derived"]
    assert 0.0 <= d["overlap_efficiency"] <= 1.0
    assert 0.0 <= d["consumer_blocked_fraction"] <= 1.0
    events = read_run_log(str(tmp_path / "run_log.jsonl"))
    summ = [e for e in events if e["event"] == "telemetry_summary"]
    assert len(summ) == 1
    assert summ[0]["counters"]["solver.sweeps"] == cobj.sweeps
    assert summ[0]["spans"]["sweep"]["count"] == cobj.sweeps
    assert not [e for e in events if e["event"] == "span"]


def test_kernel_builds_bridge_into_the_session(tmp_path):
    """A kernel build (the listener ``kernels._build`` notifies after
    each nvcc) is a ``kernels.builds`` count, a ``count_compiles``
    entry, and in trace mode a ``kernel_build`` instant."""
    t = telemetry.start("trace", telemetry_dir=str(tmp_path), device="cpu")
    try:
        with count_compiles() as cc:
            _build._notify_build("gather_rowsum")
        summary = t.summary()
    finally:
        t.close()
    assert cc.programs == ["gather_rowsum"]
    assert summary["counters"]["kernels.builds"] == 1
    with open(tmp_path / "trace.json") as f:
        doc = json.load(f)
    inst = [e for e in doc["traceEvents"] if e["ph"] == "i"]
    assert [e["name"] for e in inst] == ["kernel_build"]
    assert inst[0]["args"] == {"source": "gather_rowsum"}
    assert not _build._BUILD_LISTENERS      # both listeners removed


# -- trace export ----------------------------------------------------------------


def _check_nesting(spans_by_tid):
    """Spans on one thread nest: a depth-d span lies inside its
    depth-(d-1) parent (5 ms slack)."""
    eps = 5e-3
    for spans in spans_by_tid.values():
        spans = sorted(spans, key=lambda s: (s["ts"], -s["dur"]))
        stack = []
        for s in spans:
            while stack and stack[-1]["depth"] >= s["depth"]:
                stack.pop()
            if s["depth"] > 0:
                assert stack, f"depth-{s['depth']} span with no parent"
                parent = stack[-1]
                assert parent["depth"] == s["depth"] - 1
                assert s["ts"] >= parent["ts"] - eps
                assert (s["ts"] + s["dur"]
                        <= parent["ts"] + parent["dur"] + eps)
            stack.append(s)


def test_trace_export_valid_chrome_json_and_nesting(tmp_path):
    log_path, _, _, _ = _session_fit(tmp_path, "trace")
    with open(tmp_path / "trace.json") as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    assert isinstance(events, list) and events
    assert {"X", "M", "C"} <= {e["ph"] for e in events}
    for e in events:
        assert {"ph", "name", "pid", "tid"} <= set(e)
        if e["ph"] == "X":
            assert e["dur"] >= 1 and e["ts"] >= 0
    names = {e["args"]["name"] for e in events
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert "photon-chunk-prefetch" in names
    assert any("MainThread" in n for n in names)
    tracks = {e["name"] for e in events if e["ph"] == "C"}
    assert "device.mem_mb" in tracks
    evs = read_run_log(log_path)
    spans = [e for e in evs if e["event"] == "span"]
    by_tid: dict = {}
    for s in spans:
        by_tid.setdefault(s["tid"], []).append(s)
    assert len(by_tid) >= 2          # main + prefetch thread
    _check_nesting(by_tid)
    assert {"fit", "sweep", "chunk_compute", "prefetch_load",
            "prefetch_place"} <= {s["name"] for s in spans}
    loads = [s for s in spans if s["name"] == "prefetch_load"]
    assert all(s["thread"] == "photon-chunk-prefetch"
               and "chunk" in s["args"] for s in loads)
    computes = [s for s in spans if s["name"] == "chunk_compute"]
    assert all(s["thread"] == "MainThread" for s in computes)


# -- the report ------------------------------------------------------------------


def test_report_cli_reconciles_and_reports_overlap(tmp_path, capsys):
    log_path, _, _, _ = _session_fit(tmp_path, "trace")
    rc = telemetry_main(["report", log_path])
    out, tail = _tail(capsys)
    assert rc == 0 and tail["ok"] is True
    assert tail["reconciliation"] >= 0.9
    assert 0.0 <= tail["overlap_efficiency"] <= 1.0
    assert tail["phases"]["fit"] > 0
    assert "Reconciliation" in out and "overlap efficiency" in out
    assert "torch=" in out            # the port's run header


def test_report_tolerates_torn_tail(tmp_path, capsys):
    log_path = str(tmp_path / "run_log.jsonl")
    log = RunLogger(log_path)
    t = telemetry.start("metrics", run_logger=log, heartbeat_s=0.01,
                        device="cpu")
    try:
        t.heartbeat("prefetch-producer", chunk=3)
    finally:
        t.close()
        log.close()
    with open(log_path, "a") as f:
        f.write('{"t": 1.0, "event": "hea')     # torn mid-write
    rc = telemetry_main(["report", log_path])
    out, tail = _tail(capsys)
    assert rc == 0
    assert "malformed line(s) skipped" in out
    assert tail["heartbeats"]["prefetch-producer"] == 1


def test_report_cli_fails_below_threshold(tmp_path, capsys):
    log_path = str(tmp_path / "run_log.jsonl")
    log = RunLogger(log_path)
    t = telemetry.start("trace", run_logger=log, device="cpu")
    try:
        with telemetry.span("a", cat="x"):
            time.sleep(0.02)
        time.sleep(0.2)            # unattributed wall clock
        with telemetry.span("b", cat="x"):
            time.sleep(0.02)
    finally:
        t.close()
        log.close()
    rc = telemetry_main(["report", log_path])
    _, tail = _tail(capsys)
    assert rc == 1 and tail["ok"] is False
    assert tail["reconciliation"] < 0.9


def test_report_reads_stitched_segments(tmp_path, capsys):
    """A resumed run appends a second segment: the report reads the last
    one and says how many it found."""
    log_path = str(tmp_path / "run_log.jsonl")
    for mode in ("w", "a"):
        log = RunLogger(log_path, mode=mode, header=True)
        t = telemetry.start("trace", run_logger=log, device="cpu")
        try:
            with telemetry.span("fit", cat="phase"):
                time.sleep(0.01)
        finally:
            t.close()
            log.close()
    with open(log_path) as f:
        first = f.readline()
    with open(log_path, "a") as f:
        f.write(first[:20])          # the second segment's torn tail
    rc = telemetry_main(["report", log_path])
    out, tail = _tail(capsys)
    assert rc == 0 and tail["segments"] == 2
    assert "Stitched log: 2 run segments" in out


def test_unported_subcommands_name_their_items(capsys):
    """Every subcommand is ported now: ``fleet-report`` (A7a; its parity
    is in ``test_torch_fleet.py``), ``watch`` and ``serve-report``
    (``test_torch_monitor.py``, ``test_torch_serve_trace.py``)."""
    for cmd in ("fleet-report", "watch", "serve-report"):
        with pytest.raises(SystemExit) as e:
            telemetry_main([cmd, "--help"])
        assert e.value.code == 0
        assert "not ported" not in capsys.readouterr().out


# -- liveness: heartbeats and thread death ---------------------------------------


def test_prefetcher_death_emits_exception_event(tmp_path):
    log_path = str(tmp_path / "run_log.jsonl")
    log = RunLogger(log_path)
    t = telemetry.start("metrics", run_logger=log, heartbeat_s=0.05,
                        device="cpu")

    def load(i):
        if i >= 2:
            raise RuntimeError("disk on fire")
        return np.zeros(4)

    pf = ChunkPrefetcher(load, lambda h: h, depth=2)
    pf.start(range(5))
    try:
        with pytest.raises(RuntimeError, match="disk on fire"):
            for i in range(5):
                pf.next(i)
    finally:
        pf.close()
        t.close()
        log.close()
    deaths = [e for e in read_run_log(log_path)
              if e["event"] == "thread_exception"]
    assert len(deaths) == 1
    assert deaths[0]["stage"] == "prefetch-producer"
    assert "disk on fire" in deaths[0]["error"]
    assert deaths[0]["thread"] == "photon-chunk-prefetch"


def test_starved_consumer_emits_heartbeats(tmp_path):
    log_path = str(tmp_path / "run_log.jsonl")
    log = RunLogger(log_path)
    t = telemetry.start("metrics", run_logger=log, heartbeat_s=0.05,
                        device="cpu")

    def slow_load(i):
        time.sleep(0.4 if i == 1 else 0.0)
        return np.zeros(4)

    pf = ChunkPrefetcher(slow_load, lambda h: h, depth=1)
    pf.start(range(3))
    try:
        for i in range(3):
            pf.next(i)
    finally:
        pf.close()
        t.close()
        log.close()
    beats = [e for e in read_run_log(log_path) if e["event"] == "heartbeat"]
    consumer = [e for e in beats if e["stage"] == "prefetch-consumer"]
    assert consumer, beats
    assert consumer[0]["state"] == "queue_empty"
    assert consumer[0]["waiting_s"] > 0


def test_sink_writer_death_emits_exception_event(tmp_path):
    from photon_ml_torch.estimators.streaming_scorer import _SinkWriter

    log_path = str(tmp_path / "run_log.jsonl")
    log = RunLogger(log_path)
    t = telemetry.start("metrics", run_logger=log, heartbeat_s=0.05,
                        device="cpu")

    class BadSink:
        def write(self, *a, **kw):
            raise OSError("disk full")

        def abort(self):
            pass

    w = _SinkWriter([BadSink()])
    try:
        w.put(0, 4, np.zeros(4), np.zeros(4), np.zeros(4), {})
        with pytest.raises(OSError, match="disk full"):
            w.close()
    finally:
        t.close()
        log.close()
    assert not w._thread.is_alive()
    deaths = [e for e in read_run_log(log_path)
              if e["event"] == "thread_exception"]
    assert len(deaths) == 1
    assert deaths[0]["stage"] == "sink-writer"
    assert "disk full" in deaths[0]["error"]
    assert deaths[0]["thread"] == "photon-score-writer"


def test_idle_sink_writer_heartbeats(tmp_path):
    from photon_ml_torch.estimators.streaming_scorer import _SinkWriter

    log_path = str(tmp_path / "run_log.jsonl")
    log = RunLogger(log_path)
    t = telemetry.start("metrics", run_logger=log, heartbeat_s=0.05,
                        device="cpu")

    class NullSink:
        def write(self, *a, **kw):
            pass

    w = _SinkWriter([NullSink()])
    try:
        time.sleep(0.25)     # a starved writer beats while it waits
        w.close()
    finally:
        t.close()
        log.close()
    assert not w._thread.is_alive()
    beats = [e for e in read_run_log(log_path)
             if e["event"] == "heartbeat" and e["stage"] == "sink-writer"]
    assert beats and beats[0]["state"] == "queue_empty"


# -- the estimator and the drivers ------------------------------------------------


def _dense_config(tmp_path, **over):
    from photon_ml_torch.config import (
        CoordinateConfig,
        CoordinateKind,
        OptimizerSettings,
        TrainingConfig,
    )
    from photon_ml_torch.models.glm import TaskType

    return TrainingConfig(
        task_type=TaskType.LOGISTIC_REGRESSION,
        coordinates=[CoordinateConfig(
            name="global", kind=CoordinateKind.FIXED_EFFECT,
            feature_shard="global",
            optimizer=OptimizerSettings(max_iters=10))],
        update_sequence=["global"], n_iterations=1, evaluators=[],
        output_dir=str(tmp_path / "out"), device=CPU, **over)


def _dense_train():
    from photon_ml_torch.game.dataset import GameDataset

    rng = np.random.default_rng(11)
    n, d = 400, 13
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    return GameDataset(labels=y, features={"global": x}, entity_ids={})


def test_estimator_fit_honors_telemetry_config(tmp_path):
    """A programmatic fit with telemetry='trace' writes run_log.jsonl and
    trace.json to telemetry_dir with no driver."""
    from photon_ml_torch.estimators.game_estimator import GameEstimator

    cfg = _dense_config(tmp_path, telemetry="trace",
                        telemetry_dir=str(tmp_path / "tel"))
    GameEstimator(cfg).fit(_dense_train())
    assert telemetry.active() is None
    tel_dir = tmp_path / "tel"
    assert (tel_dir / "trace.json").exists()
    events = read_run_log(str(tel_dir / "run_log.jsonl"))
    assert events[0]["event"] == "run_header"
    assert events[0]["telemetry"] == "trace"
    kinds = {e["event"] for e in events}
    assert {"telemetry_start", "telemetry_summary", "span",
            "trace_written", "device_memory"} <= kinds
    spans = {s["name"] for s in events if s["event"] == "span"}
    assert {"estimator_fit", "cd_coordinate"} <= spans
    tags = {e.get("tag") for e in events if e["event"] == "device_memory"}
    assert {"estimator_fit", "datasets_placed"} <= tags


def test_profile_dir_writes_torch_profiler_trace(tmp_path):
    """``TrainingConfig.profile_dir`` runs the driver's fit phase under
    ``torch.profiler``; its Chrome trace lands there."""
    from photon_ml_torch.cli import game_training_driver
    from photon_ml_torch.config import config_to_json

    prof = tmp_path / "prof"
    cfg = _dense_config(tmp_path, profile_dir=str(prof),
                        input_path=_a1a_file(tmp_path, 300))
    cfg.coordinates[0].feature_shard = "features"
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(config_to_json(cfg))
    with _quiet():
        game_training_driver.main(["--config", str(cfg_path)])
    path = prof / "fit.pt.trace.json"
    with open(path) as f:
        doc = json.load(f)
    assert doc["traceEvents"]
    ends = [e for e in read_run_log(str(tmp_path / "out" / "run_log.jsonl"))
            if e["event"] == "phase_end" and e["phase"] == "fit"]
    assert ends[0]["profile_dir"] == str(prof)


class _quiet:
    """Keeps a driver's JSON summary off the test's captured stdout."""

    def __enter__(self):
        import contextlib

        self._cm = contextlib.redirect_stdout(io.StringIO())
        return self._cm.__enter__()

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)


def _a1a_file(tmp_path, n, seed=5) -> str:
    from photon_ml_torch.io.libsvm import write_libsvm
    from photon_ml_torch.utils.synthetic import make_a1a_like

    rows, labels, _ = make_a1a_like(n=n, seed=seed)
    path = str(tmp_path / f"a1a_{n}_{seed}.libsvm")
    write_libsvm(path, rows, np.where(labels > 0, 1, -1))
    return path


def _swept_driver_config(tmp_path, mode: str) -> str:
    config = {
        "task_type": "LOGISTIC_REGRESSION",
        "coordinates": [{
            "name": "global", "kind": "FIXED_EFFECT",
            "feature_shard": "features",
            "optimizer": {"optimizer": "LBFGS", "reg_weight": 1.0,
                          "max_iters": 12},
        }],
        "update_sequence": ["global"],
        "input_path": _a1a_file(tmp_path, 1200),
        "validation_fraction": 0.2,
        "output_dir": str(tmp_path / "out"),
        "evaluators": ["AUC"],
        "reg_weight_grid": {"global": list(LAMS)},
        "chunk_rows": 200,
        "spill_dir": str(tmp_path / "spill"),
        "host_max_resident": 2,
        "telemetry": mode,
        "device": CPU,
    }
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    return cfg_path


def test_e2e_streamed_swept_fit_trace_acceptance(tmp_path, capsys):
    """A streamed swept fit through the training driver with
    ``--telemetry trace``: the report reconciles stage spans to ≥ 90 %
    of the wall clock and reports the prefetcher's overlap."""
    from photon_ml_torch.cli import game_training_driver

    cfg_path = _swept_driver_config(tmp_path, "off")
    with _quiet():
        game_training_driver.main(["--config", cfg_path,
                                   "--telemetry", "trace"])
    assert telemetry.active() is None
    out_dir = tmp_path / "out"
    log_path = str(out_dir / "run_log.jsonl")
    assert (out_dir / "trace.json").exists()
    events = read_run_log(log_path)
    assert events[0]["telemetry"] == "trace"
    names = {e["name"] for e in events if e["event"] == "span"}
    assert {"fit", "sweep", "swept_train", "prefetch_load",
            "chunk_compute"} <= names
    rc = telemetry_main(["report", log_path])
    _, tail = _tail(capsys)
    assert rc == 0 and tail["ok"] is True
    assert tail["reconciliation"] >= 0.9
    assert tail["overlap_efficiency"] is not None
    assert tail["counters"]["solver.sweeps"] > 0
    assert tail["counters"]["store.loads"] > 0
    assert tail["device"]["programs"]["chunk_vg_swept"]["flops"] > 0


def test_e2e_swept_streamed_fit_metrics_convergence(tmp_path, capsys):
    """The driver with telemetry=metrics: per-lane convergence events
    reconcile with the sweep odometer in the report."""
    from photon_ml_torch.cli import game_training_driver

    with _quiet():
        game_training_driver.main(
            ["--config", _swept_driver_config(tmp_path, "metrics")])
    assert telemetry.active() is None
    log_path = str(tmp_path / "out" / "run_log.jsonl")
    events = read_run_log(log_path)
    assert events[0]["event"] == "run_header"
    assert events[0]["schema"] == 1
    assert events[0]["telemetry"] == "metrics"
    assert "torch" in events[0] and "jax" not in events[0]
    iters = [e for e in events if e["event"] == "convergence_iter"]
    assert iters and all(e["solver"] == "streaming_lbfgs_swept"
                         and e["label"] == "global" for e in iters)
    assert all(len(e["values"]) == len(LAMS) for e in iters)
    traces = [e for e in events if e["event"] == "convergence_trace"]
    assert len(traces) == 1 and traces[0]["lanes"] == len(LAMS)
    rc = telemetry_main(["report", log_path])
    _, tail = _tail(capsys)
    assert rc == 0 and tail["ok"] is True
    conv = tail["convergence"]
    assert conv["ok"] is True and conv["sweeps"] > 0
    assert conv["unattributed_sweeps"] == 0
    assert conv["iterations"]["streaming_lbfgs_swept:global"] == len(iters)
    assert tail["run_id"] == events[0]["run_id"]


def test_scoring_driver_trace_mode_report(tmp_path, capsys):
    """``telemetry report`` over the streamed scoring driver's
    trace-mode log: spans reconcile, one score pass, the sinks' and the
    scorer's counters."""
    from photon_ml_torch.cli import game_scoring_driver, game_training_driver

    n = 3000
    train_path = _a1a_file(tmp_path, n, seed=7)
    out_dir = str(tmp_path / "out")
    config = {
        "task_type": "LOGISTIC_REGRESSION",
        "coordinates": [{
            "name": "global", "kind": "FIXED_EFFECT",
            "feature_shard": "features",
            "optimizer": {"reg_weight": 1.0, "max_iters": 10},
        }],
        "update_sequence": ["global"], "input_path": train_path,
        "output_dir": out_dir, "evaluators": [], "device": CPU,
    }
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    with _quiet():
        game_training_driver.main(["--config", cfg_path])
    score_dir = tmp_path / "scored"
    sc = {"input_path": train_path,
          "model_dir": os.path.join(out_dir, "model"),
          "output_path": str(score_dir / "scores.avro"),
          "evaluators": ["AUC"], "score_chunk_rows": 256,
          "spill_dir": str(tmp_path / "spill_sc"), "host_max_resident": 2,
          "device": CPU}
    sc_path = str(tmp_path / "sc.json")
    with open(sc_path, "w") as f:
        json.dump(sc, f)
    with _quiet():
        game_scoring_driver.main(["--config", sc_path,
                                  "--telemetry", "trace"])
    assert telemetry.active() is None
    assert not _threads("photon-score-writer")
    log_path = str(score_dir / "scoring_log.jsonl")
    assert (score_dir / "trace.json").exists()
    events = read_run_log(log_path)
    assert events[0]["driver"] == "game_scoring"
    assert events[0]["telemetry"] == "trace"
    names = {e["name"] for e in events if e["event"] == "span"}
    assert {"transform_streamed", "score_pass", "chunk_compute",
            "chunk_drain", "sink_write", "prefetch_load"} <= names
    rc = telemetry_main(["report", log_path])
    _, tail = _tail(capsys)
    assert rc == 0 and tail["ok"] is True
    assert tail["reconciliation"] >= 0.9
    assert tail["phases"]["transform_streamed"] > 0
    c = tail["counters"]
    n_chunks = -(-n // 256)
    assert c["score.passes"] == 1
    assert c["sink.rows_written"] == n
    assert c["sink.avro_blocks"] == n_chunks
    assert c["sink.bytes_written"] > 0
    assert c["prefetch.chunks_consumed"] == n_chunks
    assert tail["device"]["programs"]["score_chunk"]["bytes_accessed"] > 0


# -- the run log ---------------------------------------------------------------------


def test_runlogger_context_manager_and_thread_safety(tmp_path):
    path = str(tmp_path / "log.jsonl")
    with RunLogger(path) as log:
        log.event("hello", x=1)
        assert log._f is not None
    assert log._f is None
    log.close()                          # idempotent
    events = read_run_log(path)
    assert [e["event"] for e in events] == ["run_header", "hello"]
    assert events[0]["schema"] == 1 and events[0]["run_id"]
    assert isinstance(events[0]["argv"], list)
    with RunLogger(path) as log:
        threads = [threading.Thread(
            target=lambda j=j: [log.event("t", j=j, i=i)
                                for i in range(50)])
            for j in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)
    assert len(read_run_log(path)) == 201


def test_runlogger_atexit_flush_fallback(tmp_path):
    path = str(tmp_path / "leak.jsonl")
    code = (
        "from photon_ml_torch.utils.run_log import RunLogger\n"
        f"log = RunLogger({path!r})\n"
        "log.event('abandoned', x=1)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert [e["event"] for e in read_run_log(path)] == ["run_header",
                                                        "abandoned"]


# -- histograms ----------------------------------------------------------------------


def test_histogram_percentile_bounded_error():
    """Reservoir quantiles within the documented rank error once the
    stream (10,000) far exceeds the cap (1024)."""
    n = 10_000
    shuffled = np.random.default_rng(17).permutation(n).astype(float)
    t = telemetry.start("metrics", device="cpu")
    try:
        for v in shuffled:
            t.observe("test.shuffled", v)
        for v in range(n):
            t.observe("test.ordered", float(v))
        for q in (0.5, 0.95, 0.99):
            truth = q * (n - 1)
            assert abs(t.percentile("test.ordered", q) - truth) <= 0.01 * n
            assert abs(t.percentile("test.shuffled", q) - truth) <= 0.05 * n
        assert t.percentile("no.such.metric", 0.5) is None
        with pytest.raises(ValueError, match="quantile"):
            t.percentile("test.ordered", 1.5)
        h = t.summary()["histograms"]["test.ordered"]
        assert h["p50"] <= h["p95"] <= h["p99"] <= h["max"]
        for i in range(3):
            t.count("test.rate", 10)
        assert t.rate("test.rate") is not None and t.rate("nope") is None
    finally:
        t.close()


# -- device accounting ----------------------------------------------------------------


def _chunk_leaves(cobj):
    from photon_ml_torch.optim.streaming import _LEAVES

    placed = cobj._place(cobj.batch.chunk(0)).batch
    return [getattr(placed, leaf) for leaf in _LEAVES]


def test_device_cost_captured_on_streamed_fit(tmp_path):
    """A metrics-mode fit captures each chunk program's analytic cost
    once (bytes = every input read once plus every output written once,
    flops = 2 · slots a sparse product), and phase boundaries sample the
    memory gauge under a label that says it is a host figure."""
    log_path, summary, _, cobj = _session_fit(tmp_path)
    programs = summary["device"]["programs"]
    assert {"chunk_vg", "chunk_value"} <= set(programs)
    leaves = _chunk_leaves(cobj)
    leaf_bytes = sum(t.numel() * t.element_size() for t in leaves)
    slots = leaves[0].numel()
    want = {"chunk_value": (leaf_bytes + 4 * D + 4, 2.0 * slots),
            "chunk_vg": (leaf_bytes + 4 * D + 4 + 4 * D, 4.0 * slots)}
    for name, (byts, flops) in want.items():
        cost = programs[name]
        assert cost["bytes_accessed"] == byts
        assert cost["flops"] == flops
        assert cost["cost_source"] == "analytic"
        assert cost["platform"] == "cpu" and "nominal" in cost["peak_source"]
        assert cost["roofline_est_ms"] > 0
        assert cost["span"] == "chunk_compute"
    mem = summary["device"]["memory"]
    assert mem["source"].startswith("host_rss")
    assert mem["samples"] >= 2
    events = read_run_log(log_path)
    costs = [e for e in events if e["event"] == "device_cost"]
    assert sorted(e["program"] for e in costs) == ["chunk_value",
                                                   "chunk_vg"]
    mems = [e for e in events if e["event"] == "device_memory"]
    assert mems and all(e["tag"] == "fit" for e in mems)


def test_device_capture_builds_nothing(tmp_path):
    """The capture is arithmetic on shapes: no kernel build, no
    ``kernels.builds``."""
    cobj = _spilled_objective(tmp_path)
    _fit(cobj, max_iters=2)
    t = telemetry.start("metrics", device="cpu")
    try:
        with count_compiles() as cc:
            _fit(cobj, max_iters=1)
        summary = t.summary()
    finally:
        t.close()
    assert cc.count == 0
    assert summary["counters"].get("kernels.builds", 0) == 0
    assert summary["device"]["programs"]["chunk_vg"]["flops"] > 0


def test_report_shows_device_section(tmp_path, capsys):
    """The roofline is joined with a measured time and its clock: on the
    CPU the host dispatch histogram, never a device figure."""
    log_path, summary, _, _ = _session_fit(tmp_path, "trace")
    assert not any(k.startswith("device.event_s.")
                   for k in summary["histograms"])
    rc = telemetry_main(["report", log_path])
    out, tail = _tail(capsys)
    assert rc == 0
    assert "Device programs" in out
    dev = tail["device"]["programs"]["chunk_vg"]
    assert dev["bytes_accessed"] > 0
    assert dev["measured_span_ms"] > 0
    assert dev["measured_source"] == "host"
    assert dev["roofline_fraction"] is not None


@pytest.mark.parametrize("platform,hist,source,share", [
    ("gpu", "device.event_s", "stream_interval", False),
    ("gpu", "device.dispatch_s", "host", False),
    ("cpu", "device.dispatch_s", "host", True),
])
def test_device_section_shares_only_a_work_time(platform, hist, source,
                                                share):
    """The roofline share is taken only from a time that is the work's
    own: a host time of a CPU program.  A CUDA-event interval from a
    drained stream holds the host's dispatch (``stream_interval``), and
    a host time on a card is a launch time: neither gets one."""
    from photon_ml_torch.telemetry.report import _device

    summary = {"device": {"programs": {"chunk_vg": {
        "bytes_accessed": 1e6, "roofline_est_ms": 0.3, "platform": platform,
        "span": "chunk_compute"}}},
        "histograms": {f"{hist}.chunk_vg": {"count": 4, "mean": 2e-3}}}
    row = _device(summary)["programs"]["chunk_vg"]
    assert row["measured_source"] == source
    assert row["measured_span_ms"] == 2.0
    assert ("roofline_fraction" in row) is share
    if share:
        assert row["roofline_fraction"] == 0.15


def test_memory_snapshot_follows_the_run_device():
    """The memory source is the run's device, not whether the host has a
    card: a CPU run samples the host's resident set, labelled so."""
    from photon_ml_torch.telemetry.device import memory_snapshot

    snap = memory_snapshot("cpu")
    assert snap["source"] == "host_rss (CPU device)"
    assert snap["bytes_in_use"] > 0
    t = telemetry.start("metrics", device="cpu")
    try:
        assert t.device == torch.device("cpu")
        telemetry.device_memory("probe")
        summary = t.summary()
    finally:
        t.close()
    assert summary["device"]["memory"]["source"] == "host_rss (CPU device)"


# -- convergence and the sweep odometer -----------------------------------------------


def _odometer(c: dict) -> int:
    return (c.get("solver.streamed_solves", 0) + c.get("solver.ls_trials", 0)
            + c.get("solver.grad_recovery_sweeps", 0)
            + c.get("solver.aux_sweeps", 0) + c.get("solver.hvp_sweeps", 0)
            + c.get("solver.fused_cycle_sweeps", 0))


def test_convergence_events_reconcile_with_odometer(tmp_path, capsys):
    log_path, summary, _, _ = _session_fit(tmp_path, phase=False)
    c = summary["counters"]
    events = read_run_log(log_path)
    iters = [e for e in events if e["event"] == "convergence_iter"]
    traces = [e for e in events if e["event"] == "convergence_trace"]
    assert len(iters) == c["solver.iterations"] == c["conv.iterations"]
    assert len(traces) == 1
    tr = traces[0]
    assert tr["solver"] == "streaming_lbfgs" and tr["iterations"] >= 1
    assert len(tr["values"]) == tr["iterations"] + 1
    assert len(tr["step_sizes"]) == tr["iterations"] + 1
    assert all("step_size" in e and e["ls_trials"] >= 1 for e in iters)
    assert c["solver.sweeps"] == _odometer(c)
    rc = telemetry_main(["report", log_path])
    out, tail = _tail(capsys)
    assert rc == 0 and "sweep odometer" in out and "PASS" in out
    conv = tail["convergence"]
    assert conv["ok"] is True and conv["unattributed_sweeps"] == 0
    assert conv["iterations"]["streaming_lbfgs"] == len(iters)


def test_tron_convergence_reconciles_with_hvp_odometer(tmp_path, capsys):
    """TRON closes the odometer through ``hvp_sweeps`` (CG passes),
    ``aux_sweeps`` (the Jacobi diagonal) and ``ls_trials`` (one trial
    point an iteration); each iteration event carries δ and ρ."""
    log_path, summary, _, _ = _session_fit(tmp_path, kind="tron",
                                           phase=False)
    c = summary["counters"]
    assert c["solver.hvp_sweeps"] > 0 and c["solver.aux_sweeps"] == 1
    assert c["solver.sweeps"] == _odometer(c)
    iters = [e for e in read_run_log(log_path)
             if e["event"] == "convergence_iter"]
    assert len(iters) == c["solver.iterations"]
    assert all(e.get("delta", 0) > 0 and "rho" in e for e in iters)
    rc = telemetry_main(["report", log_path])
    out, tail = _tail(capsys)
    assert rc == 0
    conv = tail["convergence"]
    assert conv["ok"] is True and conv["unattributed_sweeps"] == 0
    assert conv["hvp_sweeps"] == c["solver.hvp_sweeps"]
    assert conv["passes_per_solve"] == c["solver.sweeps"]
    assert len(conv["trust_region"]["streaming_tron:t"]["delta"]) == len(
        iters)
    assert "trust region" in out and "hvp" in out


def test_direct_evaluations_stay_informational(tmp_path, capsys):
    """A pass outside any solve is a positive unattributed sweep and
    keeps rc 0."""
    cobj = _spilled_objective(tmp_path)
    log_path = str(tmp_path / "run_log.jsonl")
    log = RunLogger(log_path)
    t = telemetry.start("metrics", run_logger=log, device="cpu")
    try:
        res = _fit(cobj)
        cobj.value(res.w)                      # the unclaimed pass
    finally:
        t.close()
        log.close()
    rc = telemetry_main(["report", log_path])
    _, tail = _tail(capsys)
    assert rc == 0 and tail["ok"] is True
    assert tail["convergence"]["unattributed_sweeps"] == 1


def test_report_fails_on_odometer_drift(tmp_path, capsys):
    log_path = str(tmp_path / "drift.jsonl")
    events = [
        {"t": 0.0, "event": "run_header", "schema": 1, "run_id": "x"},
        {"t": 1.0, "event": "telemetry_summary", "mode": "metrics",
         "counters": {"solver.sweeps": 3, "solver.streamed_solves": 1,
                      "solver.ls_trials": 4, "solver.iterations": 4},
         "gauges": {}, "histograms": {}, "spans": {}, "derived": {}},
    ]
    with open(log_path, "w") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")
    rc = telemetry_main(["report", log_path])
    out, tail = _tail(capsys)
    assert rc == 1 and "CONVERGENCE FAIL" in out
    assert tail["ok"] is False and tail["convergence"]["ok"] is False
    assert tail["convergence"]["unattributed_sweeps"] == -2


def test_streamed_re_emits_convergence_dynamics(tmp_path):
    """The streamed random effect writes one re_convergence event a
    sweep and a re_retirement event at each commit, counts ``re.*``, and
    captures its chunk program's cost."""
    from photon_ml_torch.game.coordinates import (
        build_streamed_random_effect_coordinate,
    )

    ds, obj, n, E = _re_data()
    coord = build_streamed_random_effect_coordinate(
        "u", ds, "re", obj,
        config=OptimizerConfig(max_iters=30, tolerance=1e-4),
        spill_dir=str(tmp_path / "spill_re"), chunk_entities=8,
        host_max_resident=2, prefetch_depth=1, retirement=True,
        device=CPU)
    log_path = str(tmp_path / "run_log.jsonl")
    log = RunLogger(log_path)
    t = telemetry.start("metrics", run_logger=log, device="cpu")
    try:
        off = torch.zeros(n)
        w, diag = coord.train(off, None)
        coord.retire_converged()
        w, diag = coord.train(off, w)
        newly = coord.retire_converged()
        w, diag = coord.train(off, w)
        summary = t.summary()
    finally:
        t.close()
        log.close()
    events = read_run_log(log_path)
    res = [e for e in events if e["event"] == "re_convergence"]
    assert len(res) == 3 and res[0]["coordinate"] == "u"
    assert res[0]["entities_solved"] == E
    assert res[2]["entities_retired"] == newly > 0
    commits = [e for e in events if e["event"] == "re_retirement"]
    assert [e["entities_newly_retired"] for e in commits] == [newly]
    c = summary["counters"]
    assert c["conv.re_sweeps"] == c["re.sweeps"] == 3
    assert c["re.chunks_streamed"] == sum(e["chunks_streamed"] for e in res)
    assert c["re.entities_solved"] == sum(e["entities_solved"] for e in res)
    assert any(k.startswith("re_chunk_train.b")
               for k in summary["device"]["programs"])


def _re_data(pkg="torch"):
    rng = np.random.default_rng(3)
    n, p, E = 600, 4, 24
    ids = rng.integers(0, E, n)
    x = rng.normal(size=(n, p)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    if pkg == "jax":
        from photon_ml_tpu.data.normalization import NormalizationContext as N
        from photon_ml_tpu.game.dataset import GameDataset as DS
        from photon_ml_tpu.ops import losses as jl
        from photon_ml_tpu.ops.objective import GLMObjective as O
        from photon_ml_tpu.ops.regularization import RegularizationContext as R

        obj = O(loss=jl.LOGISTIC, reg=R.l2(1.0), norm=N.identity())
    else:
        from photon_ml_torch.game.dataset import GameDataset as DS

        obj = GLMObjective(loss=losses.LOGISTIC,
                           reg=RegularizationContext.l2(1.0),
                           norm=NormalizationContext.identity())
    ds = DS(labels=y, features={"re": x}, entity_ids={"u": ids})
    return ds, obj, n, E


# -- parity with the JAX package -----------------------------------------------------

_PARITY_COUNTERS = ("solver.sweeps", "solver.streamed_solves",
                    "solver.ls_trials", "solver.grad_recovery_sweeps",
                    "solver.aux_sweeps", "solver.hvp_sweeps",
                    "solver.iterations", "solver.resumed_solves",
                    "conv.iterations", "conv.solves",
                    "conv.solver_iterations", "store.loads", "store.hits",
                    "prefetch.chunks_produced", "prefetch.chunks_consumed")


def _iterations(res) -> list:
    it = res.iterations
    it = it.cpu().numpy() if isinstance(it, torch.Tensor) else np.asarray(it)
    return np.asarray(it).reshape(-1).tolist()


@pytest.mark.parametrize("kind", ["lbfgs", "tron", "swept"])
def test_odometer_counters_match_reference(jax_c1, tmp_path, kind):
    """The same spilled problem through both packages' streamed solvers
    in metrics sessions: the iteration counts match, then every odometer,
    store and prefetch counter is equal."""
    _, mine, res, _ = _session_fit(tmp_path, kind=kind, phase=False)
    _, ref, jres, _ = _ref_session_fit(tmp_path, kind=kind)
    assert _iterations(res) == _iterations(jres)
    for name in _PARITY_COUNTERS:
        assert (mine["counters"].get(name, 0)
                == ref["counters"].get(name, 0)), name
    assert mine["spans"]["sweep"]["count"] == ref["spans"]["sweep"]["count"]


def test_re_convergence_counts_match_reference(jax_c1, tmp_path):
    """Both packages' streamed random effects under sessions, on offsets
    that drift past the solver tolerance and inside a looser retirement
    tolerance: equal solved and retired counts a sweep, equal ``re.*``
    counters."""
    import jax.numpy as jnp

    from photon_ml_torch.game.coordinates import (
        build_streamed_random_effect_coordinate as build,
    )
    from photon_ml_tpu import telemetry as jtel
    from photon_ml_tpu.game.coordinates import (
        build_streamed_random_effect_coordinate as jbuild,
    )
    from photon_ml_tpu.optim import OptimizerConfig as JCfg
    from photon_ml_tpu.utils.run_log import RunLogger as JLog

    rng = np.random.default_rng(5)
    ds, obj, n, _ = _re_data()
    jds, jobj, _, _ = _re_data("jax")
    base = rng.normal(0, 0.3, n).astype(np.float32)
    drift = rng.normal(0, 1e-4, n).astype(np.float32)
    mine = build("u", ds, "re", obj, spill_dir=str(tmp_path / "t"),
                 chunk_entities=6, device=CPU,
                 config=OptimizerConfig(max_iters=50, tolerance=1e-6))
    ref = jbuild("u", jds, "re", jobj, spill_dir=str(tmp_path / "j"),
                 chunk_entities=6, config=JCfg(max_iters=50,
                                               tolerance=1e-6))
    got = {}
    for name, coord, pkg, logger_cls, arr, kw in (
            ("torch", mine, telemetry, RunLogger, torch.from_numpy,
             {"device": "cpu"}),
            ("jax", ref, jtel, JLog, jnp.asarray, {})):
        coord.retire_tolerance = 1e-2
        log_path = str(tmp_path / f"{name}.jsonl")
        log = logger_cls(log_path)
        t = pkg.start("metrics", run_logger=log, **kw)
        try:
            w = None
            for k in range(4):
                w, _ = coord.train(arr(base + k * drift), w)
                coord.retire_converged()
            summary = t.summary()
        finally:
            t.close()
            log.close()
        events = read_run_log(log_path)
        got[name] = {
            "re": [(e["entities_solved"], e["entities_retired"])
                   for e in events if e["event"] == "re_convergence"],
            "commits": [e["entities_retired_total"] for e in events
                        if e["event"] == "re_retirement"],
            "counters": {k: v for k, v in summary["counters"].items()
                         if k.startswith(("re.", "conv.re_"))}}
    assert got["torch"] == got["jax"]
    assert got["torch"]["commits"]          # something retired


def _both_reports(log_path: str) -> tuple[dict, dict]:
    from photon_ml_torch.telemetry.report import report as port_report
    from photon_ml_tpu.telemetry.report import report as ref_report

    return (port_report(log_path, out=io.StringIO()),
            ref_report(log_path, out=io.StringIO()))


_ODOMETER_KEYS = ("ok", "sweeps", "streamed_solves", "resumed_solves",
                  "ls_trials", "grad_recovery_sweeps", "aux_sweeps",
                  "fused_cycle_sweeps", "hvp_sweeps", "unattributed_sweeps",
                  "iterations", "iteration_events")


@pytest.mark.parametrize("kind", ["lbfgs", "tron"])
def test_reports_read_each_others_logs(jax_c1, tmp_path, kind):
    """Each package's ``report`` on the other's trace-mode log gives the
    same verdict, the same odometer and a coverage within 1e-9 of the
    writer's own reading (the run log is a shared format)."""
    port_log, _, _, _ = _session_fit(tmp_path, "trace", kind=kind)
    ref_log, _, _, _ = _ref_session_fit(tmp_path, "trace", kind=kind)
    for log_path in (port_log, ref_log):
        mine, ref = _both_reports(log_path)
        assert mine["ok"] is ref["ok"] is True
        assert abs(mine["reconciliation"] - ref["reconciliation"]) \
            <= COVERAGE_ATOL
        assert mine["segments"] == ref["segments"] == 1
        for key in _ODOMETER_KEYS:
            assert mine["convergence"][key] == ref["convergence"][key], key
        assert mine["overlap_efficiency"] == ref["overlap_efficiency"]
        assert set(mine["device"]["programs"]) == set(
            ref["device"]["programs"])


def test_reports_agree_on_a_failing_log(jax_c1, tmp_path):
    """The failing verdicts agree too: a below-threshold trace."""
    log_path = str(tmp_path / "run_log.jsonl")
    log = RunLogger(log_path)
    t = telemetry.start("trace", run_logger=log, device="cpu")
    try:
        with telemetry.span("a", cat="x"):
            time.sleep(0.01)
        time.sleep(0.1)
        with telemetry.span("b", cat="x"):
            time.sleep(0.01)
    finally:
        t.close()
        log.close()
    mine, ref = _both_reports(log_path)
    assert mine["ok"] is ref["ok"] is False
    assert abs(mine["reconciliation"] - ref["reconciliation"]) \
        <= COVERAGE_ATOL


# -- telemetry changes no result -------------------------------------------------------


@pytest.mark.parametrize("kind", ["lbfgs", "tron", "swept"])
def test_telemetry_leaves_coefficients_bitwise(tmp_path, kind):
    """The same streamed fit with telemetry off, metrics and trace:
    bitwise the same coefficients and values."""
    out = {}
    for mode in ("off", "metrics", "trace"):
        d = tmp_path / mode
        d.mkdir()
        cobj = _spilled_objective(d)
        if mode == "off":
            res = _fit(cobj, kind)
        else:
            t = telemetry.start(mode, telemetry_dir=str(d), device="cpu")
            try:
                res = _fit(cobj, kind)
            finally:
                t.close()
        out[mode] = (res.w.clone(), res.value.clone())
    for mode in ("metrics", "trace"):
        assert torch.equal(out[mode][0], out["off"][0]), mode
        assert torch.equal(out[mode][1], out["off"][1]), mode


def test_telemetry_leaves_game_fit_bitwise(tmp_path):
    """A GAME fit with a chunked, spilled fixed effect and a streamed
    random effect through the estimator: bitwise the same model with
    telemetry off, metrics and trace."""
    from photon_ml_torch.config import (
        CoordinateConfig,
        CoordinateKind,
        OptimizerSettings,
        TrainingConfig,
    )
    from photon_ml_torch.estimators.game_estimator import GameEstimator
    from photon_ml_torch.game.dataset import GameDataset
    from photon_ml_torch.models.glm import TaskType

    rng = np.random.default_rng(13)
    n = 900
    indptr, cols, vals, y = _problem(13)
    xr = rng.normal(size=(len(y), 3)).astype(np.float32)
    ids = rng.integers(0, 30, len(y))
    train = GameDataset(
        labels=y, features={"global": SparseRows.from_flat(indptr, cols,
                                                           vals),
                            "re": xr},
        entity_ids={"u": ids}, feature_dims={"global": D})
    models = {}
    for mode in ("off", "metrics", "trace"):
        cfg = TrainingConfig(
            task_type=TaskType.LOGISTIC_REGRESSION,
            coordinates=[
                CoordinateConfig(
                    name="global", kind=CoordinateKind.FIXED_EFFECT,
                    feature_shard="global",
                    optimizer=OptimizerSettings(max_iters=8)),
                CoordinateConfig(
                    name="u", kind=CoordinateKind.RANDOM_EFFECT,
                    feature_shard="re", entity_key="u",
                    optimizer=OptimizerSettings(max_iters=8))],
            update_sequence=["global", "u"], n_iterations=2,
            evaluators=[], chunk_rows=300,
            spill_dir=str(tmp_path / f"spill_{mode}"),
            re_chunk_entities=8, telemetry=mode,
            telemetry_dir=str(tmp_path / f"tel_{mode}"),
            output_dir=str(tmp_path / f"out_{mode}"), device=CPU)
        res = GameEstimator(cfg).fit(train)[0]
        models[mode] = res.model.models
    for mode in ("metrics", "trace"):
        assert torch.equal(
            models[mode]["global"].coefficients.means,
            models["off"]["global"].coefficients.means), mode
        for a, b in zip(models[mode]["u"].coefficient_blocks,
                        models["off"]["u"].coefficient_blocks):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    log = read_run_log(str(tmp_path / "tel_trace" / "run_log.jsonl"))
    assert any(e["event"] == "re_convergence" for e in log)


# -- history ---------------------------------------------------------------------------


def _write_round(path, record, rc=0, wrapper=False):
    with open(path, "w") as f:
        if wrapper:
            json.dump({"n": 1, "cmd": "bench", "rc": rc, "tail": "",
                       "parsed": record}, f)
        else:
            json.dump({"schema": 1, "kind": "bench_record",
                       "argv": ["--section", "stream"], "rc": rc,
                       "record": record}, f)


def _stream_record(rows_per_sec, ratio=1.0):
    return {"stream": {"spilled": {"examples_per_sec": rows_per_sec},
                       "pass_time_ratio": ratio}}


def test_history_clean_then_regressed(tmp_path, capsys):
    hist = tmp_path / "hist"
    hist.mkdir()
    _write_round(str(hist / "r01.json"), _stream_record(1000.0))
    _write_round(str(hist / "r02.json"), _stream_record(1040.0))
    rc = telemetry_main(["history", str(hist)])
    _, tail = _tail(capsys)
    assert rc == 0 and tail["ok"] is True
    assert tail["trajectory"]["stream:stream.spilled.examples_per_sec"][
        "values"] == [1000.0, 1040.0]
    _write_round(str(hist / "r03.json"), _stream_record(816.0))
    rc = telemetry_main(["history", str(hist)])
    out, tail = _tail(capsys)
    assert rc == 1 and tail["ok"] is False
    regs = tail["regressions"]
    assert len(regs) == 1 and regs[0]["round"] == "r03.json"
    assert regs[0]["metric"] == "stream:stream.spilled.examples_per_sec"
    assert "REGRESSION" in out


def test_history_flags_nonzero_rc_round(tmp_path, capsys):
    hist = tmp_path / "hist"
    hist.mkdir()
    _write_round(str(hist / "r01.json"), _stream_record(1000.0),
                 wrapper=True)
    _write_round(str(hist / "r02.json"), None, rc=124, wrapper=True)
    _write_round(str(hist / "r03.json"), None, rc=None, wrapper=True)
    rc = telemetry_main(["history", str(hist)])
    out, tail = _tail(capsys)
    assert rc == 1 and tail["ok"] is False
    assert {(f["round"], f["rc"]) for f in tail["failed_rounds"]} == {
        ("r02.json", 124), ("r03.json", None)}
    assert "FAILED ROUND" in out
    rc = telemetry_main(["history", str(hist), "--known-bad",
                         "r02.json=budget timeout", "--known-bad",
                         "r03.json=torn wrapper"])
    out, tail = _tail(capsys)
    assert rc == 0 and "WAIVED" in out


def test_history_over_repo_bench_records(tmp_path, capsys):
    import shutil

    repo_rounds = [os.path.join(REPO, f"BENCH_r0{i}.json")
                   for i in range(1, 6)]
    assert all(os.path.exists(p) for p in repo_rounds)
    rc = telemetry_main(["history", *repo_rounds[:4]])
    _, tail = _tail(capsys)
    assert rc == 0 and tail["ok"] is True
    hist = tmp_path / "hist"
    hist.mkdir()
    for p in repo_rounds:
        shutil.copy(p, str(hist / os.path.basename(p)))
    _write_round(str(hist / "BENCH_r99.json"),
                 {"value": 206592425.1 * 0.6, "step_ms_grr": 4.84})
    rc = telemetry_main(["history", str(hist)])
    _, tail = _tail(capsys)
    assert rc == 1 and tail["ok"] is False
    assert any(r["metric"] == "overall:value"
               and r["round"] == "BENCH_r99.json"
               for r in tail["regressions"])
    assert any(fr["rc"] == 124 for fr in tail["failed_rounds"])


def test_history_tolerates_garbage_files(tmp_path, capsys):
    hist = tmp_path / "hist"
    hist.mkdir()
    (hist / "bad.json").write_text("{not json")
    _write_round(str(hist / "ok.json"), _stream_record(1000.0))
    rc = telemetry_main(["history", str(hist)])
    _, tail = _tail(capsys)
    assert rc == 1
    assert tail["failed_rounds"][0]["round"] == "bad.json"
    assert "error" in tail["failed_rounds"][0]


def test_history_matches_reference(tmp_path):
    """Both packages' ``history`` over the repo's rounds plus a
    regressed one: the same trajectory, regressions and failed rounds."""
    from photon_ml_torch.telemetry.history import run_history
    from photon_ml_tpu.telemetry.history import run_history as jrun

    paths = [os.path.join(REPO, f"BENCH_r0{i}.json") for i in range(1, 6)]
    extra = str(tmp_path / "BENCH_r99.json")
    _write_round(extra, {"value": 1.0e8, "step_ms_grr": 9.0})
    mine = run_history(paths + [extra], out=io.StringIO())
    ref = jrun(paths + [extra], out=io.StringIO())
    for key in ("ok", "rounds", "trajectory", "regressions",
                "failed_rounds", "waived"):
        assert mine[key] == ref[key], key


def test_synthetic_arrays_match_reference():
    from photon_ml_torch.utils import synthetic as mine
    from photon_ml_tpu.utils import synthetic as ref

    rows, labels, w = mine.make_a1a_like(n=300, seed=9)
    jrows, jlabels, jw = ref.make_a1a_like(n=300, seed=9)
    assert np.array_equal(labels, jlabels) and np.array_equal(w, jw)
    for (c, v), (jc, jv) in zip(rows, jrows, strict=True):
        assert np.array_equal(c, jc) and np.array_equal(v, jv)
    got = mine.make_movielens_like(n_obs=500, seed=4)
    want = ref.make_movielens_like(n_obs=500, seed=4)
    assert got.keys() == want.keys()
    for k in got:
        assert np.array_equal(got[k], want[k]), k
