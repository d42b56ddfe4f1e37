"""The port's request tracing held against ``photon_ml_tpu.serving.tracing``.

Both packages' trace contexts, recorders, HTTP cores, servers, Chrome
flow export and ``serve-report`` run on the same inputs: the same
synthetic request durations, the same GAME model (``test_torch_serving``'s,
made from a numpy seed) and the same seeded requests, the port with
``device="cpu"``.  Held: header parsing and echo equal in form on 200,
400, 503 and 500 answers; the ``request_trace`` / ``batch_trace`` /
``serve_trace_summary`` events equal in keys; each package's
``serve-report`` on the other's trace log gives the same table of stages
and counts, with shares within 1e-9; the flow export equal; a traced
server builds no kernel and its margins are bitwise its untraced ones.
"""

from __future__ import annotations

import io
import json
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from photon_ml_tpu import telemetry as j_telemetry
from photon_ml_tpu.io import model_io as jio
from photon_ml_tpu.models.glm import TaskType as JTask
from photon_ml_tpu.serving import http as j_http
from photon_ml_tpu.serving import tracing as j_tracing
from photon_ml_tpu.telemetry import export as j_export
from photon_ml_tpu.telemetry import monitor as j_monitor
from photon_ml_tpu.telemetry import serve_report as j_serve_report
from photon_ml_tpu.telemetry.__main__ import main as j_telemetry_main
from photon_ml_tpu.utils import run_log as j_run_log
from photon_ml_torch import telemetry as t_telemetry
from photon_ml_torch.analysis.guards import count_compiles
from photon_ml_torch.serving import http as t_http
from photon_ml_torch.serving import tracing as t_tracing
from photon_ml_torch.telemetry import export as t_export
from photon_ml_torch.telemetry import monitor as t_monitor
from photon_ml_torch.telemetry import serve_report as t_serve_report
from photon_ml_torch.telemetry.__main__ import main as t_telemetry_main
from photon_ml_torch.utils import run_log as t_run_log
from test_torch_serving import (
    _faults,
    _jax_model,
    _requests,
    _server,
)
from test_torch_training import jax_fresh_caches  # noqa: F401  (C5)

PKGS = {
    "jax": types.SimpleNamespace(
        tracing=j_tracing, telemetry=j_telemetry, monitor=j_monitor,
        http=j_http, export=j_export, serve_report=j_serve_report,
        run_log=j_run_log, main=j_telemetry_main),
    "port": types.SimpleNamespace(
        tracing=t_tracing, telemetry=t_telemetry, monitor=t_monitor,
        http=t_http, export=t_export, serve_report=t_serve_report,
        run_log=t_run_log, main=t_telemetry_main),
}
SHARE_TOL = 1e-9


@pytest.fixture(autouse=True)
def _no_leaked_sessions():
    """Every test leaves both packages' sessions closed."""
    for m in PKGS.values():
        assert m.tracing.active() is None
        assert m.telemetry.active() is None and m.monitor.active() is None
    yield
    leaked = []
    for name, m in PKGS.items():
        for kind, mod in (("tracing", m.tracing), ("monitor", m.monitor),
                          ("telemetry", m.telemetry)):
            if mod.active() is not None:
                mod.active().close()
                leaked.append(f"{name}.{kind}")
    assert not leaked, f"leaked sessions: {leaked}"


# ---------------------------------------------------------------------------
# trace context + header parsing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_trace_context_mint_parse_round_trip(pkg):
    tracing = PKGS[pkg].tracing
    ctx = tracing.mint()
    assert len(ctx.trace_id) == 20 and ctx.hop == 0
    assert tracing.mint().trace_id != ctx.trace_id
    assert ctx.trace_id.startswith(tracing._MINT_PREFIX)
    back = tracing.parse_trace_header(ctx.header_value())
    assert (back.trace_id, back.hop) == (ctx.trace_id, 0)
    child = tracing.parse_trace_header(ctx.child_header())
    assert (child.trace_id, child.hop) == (ctx.trace_id, 1)


HEADERS = [None, "", "bad id with spaces/1", "x" * 100 + "/1",
           "abc/notanint", "abc123", "abc123/-4", "cafe01/2", "a.b_c-9/7",
           "x" * 64, "x" * 65]


@pytest.mark.parametrize("value", HEADERS)
def test_trace_header_parsing_matches_jax(value):
    j, t = (PKGS[p].tracing.parse_trace_header(value)
            for p in ("jax", "port"))
    assert (t is None) == (j is None)
    if t is not None:
        assert (t.trace_id, t.hop) == (j.trace_id, j.hop)


@pytest.mark.parametrize("headers", [
    {"X-Photon-Trace": "cafe01/2"},
    {"X-Photon-Request-Id": "client-7"},
    {"X-Photon-Trace": "bad id/1", "X-Photon-Request-Id": "client-8"},
    {"X-Photon-Trace": "feed/3", "X-Photon-Request-Id": "client-9"},
])
def test_from_headers_adoption_matches_jax(headers):
    j = j_tracing.from_headers(headers)
    t = t_tracing.from_headers(headers)
    assert (t.trace_id, t.hop) == (j.trace_id, j.hop)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_from_headers_mints_on_garbage(pkg):
    tracing = PKGS[pkg].tracing
    ctx = tracing.from_headers({"X-Photon-Request-Id": "bad id!"})
    assert ctx.trace_id != "bad id!" and len(ctx.trace_id) == 20
    assert tracing.from_headers({}).hop == 0


# ---------------------------------------------------------------------------
# recorder: tail sampling, floor, ring bounds, batch linking
# ---------------------------------------------------------------------------


def _finish_with_duration(tracing, rec, dur_s: float,
                          stages: dict | None = None,
                          batch: str | None = None) -> None:
    """One request through the recorder with a synthetic duration (t0
    moved back; no sleeps)."""
    rt = rec.begin()
    tracing.take_attached()
    rt.t0 -= dur_s
    for k, v in (stages or {}).items():
        rt.stamp(k, v)
    rt.batch = batch
    rec.finish(rt, status=200)


def _recorder_log(pkg, path, threshold_s, sample_every, durations,
                  batch_stages=None):
    """Drive ``pkg``'s recorder through ``durations`` (one shared batch
    when ``batch_stages``) → (events, snapshot)."""
    m = PKGS[pkg]
    log = m.run_log.RunLogger(str(path))
    rec = m.tracing.TraceRecorder(threshold_s=threshold_s,
                                  sample_every=sample_every, cap=64,
                                  run_logger=log)
    bid = None
    if batch_stages is not None:
        bt = rec.begin_batch(bucket=8, rows=6, requests=len(durations))
        for k, v in batch_stages.items():
            bt.stamp(k, v)
        rec.finish_batch(bt)
        bid = bt.batch_id
    for d in durations:
        _finish_with_duration(m.tracing, rec, d,
                              stages={"queue_wait": d / 2,
                                      "serialize": 1e-4}, batch=bid)
    snap = rec.snapshot()
    rec.close()
    log.close()
    return m.run_log.read_run_log(str(path)), snap


def test_tail_sampling_matches_jax(tmp_path):
    """Every request at or above the threshold is kept and exported;
    both packages keep the same ones, with events equal in keys."""
    durations = [0.050 if i % 2 else 0.001 for i in range(40)]
    out = {p: _recorder_log(p, tmp_path / f"{p}.jsonl", 0.010, 0,
                            durations) for p in PKGS}
    traces = {p: [e for e in ev if e["event"] == "request_trace"]
              for p, (ev, _) in out.items()}
    assert len(traces["port"]) == len(traces["jax"]) == 20
    assert all(t["sampled"] == "tail" for t in traces["port"])
    assert [sorted(t) for t in traces["port"]] == \
        [sorted(t) for t in traces["jax"]]
    assert [t["stages_ms"] for t in traces["port"]] == \
        [t["stages_ms"] for t in traces["jax"]]
    assert out["port"][1] == out["jax"][1]
    summaries = {p: [e for e in ev if e["event"] == "serve_trace_summary"]
                 for p, (ev, _) in out.items()}
    assert sorted(summaries["port"][0]) == sorted(summaries["jax"][0])
    assert summaries["port"][0]["sampled_tail"] == 20


def test_floor_sampling_matches_jax(tmp_path):
    """An unreachable threshold: the deterministic 1-in-N floor keeps
    requests 0, 10, 20, 30 in both packages."""
    out = {p: _recorder_log(p, tmp_path / f"{p}.jsonl", 10.0, 10,
                            [0.001] * 35) for p in PKGS}
    assert out["port"][1] == out["jax"][1]
    assert out["port"][1]["sampled_floor"] == 4
    kept = [e for e in out["port"][0] if e["event"] == "request_trace"]
    assert [e["sampled"] for e in kept] == ["floor"] * 4


def test_batch_trace_emitted_once_matches_jax(tmp_path):
    """The shared batch is one ``batch_trace`` however many members are
    kept; its events equal the JAX package's in keys and stages."""
    out = {p: _recorder_log(p, tmp_path / f"{p}.jsonl", 0.0, 0,
                            [0.02] * 3, batch_stages={"assemble": 0.001,
                                                      "dispatch": 0.004})
           for p in PKGS}
    batches = {p: [e for e in ev if e["event"] == "batch_trace"]
               for p, (ev, _) in out.items()}
    assert len(batches["port"]) == len(batches["jax"]) == 1
    assert sorted(batches["port"][0]) == sorted(batches["jax"][0])
    assert batches["port"][0]["stages_ms"] == \
        batches["jax"][0]["stages_ms"] == {"assemble": 1.0,
                                           "dispatch": 4.0}
    traces = [e for e in out["port"][0] if e["event"] == "request_trace"]
    assert {t["batch"] for t in traces} == {batches["port"][0]["batch"]}


def test_ring_bounded_under_concurrent_load(tmp_path):
    """8 threads x 100 kept requests: the ring stays at its cap, the
    pending-batch window stays bounded, and every request reaches the
    log."""
    log = t_run_log.RunLogger(str(tmp_path / "log.jsonl"))
    rec = t_tracing.TraceRecorder(threshold_s=0.0, sample_every=0,
                                  cap=32, run_logger=log)

    def worker():
        for _ in range(100):
            bt = rec.begin_batch(bucket=8, rows=4, requests=1)
            bt.stamp("dispatch", 0.002)
            rec.finish_batch(bt)
            _finish_with_duration(t_tracing, rec, 0.005,
                                  stages={"queue_wait": 0.001},
                                  batch=bt.batch_id)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    snap = rec.snapshot()
    assert snap["requests"] == snap["sampled_tail"] == 800
    assert snap["buffered"] <= 32
    assert len(rec._pending) <= t_tracing._PENDING_BATCH_CAP
    rec.close()
    log.close()
    traces = [e for e in t_run_log.read_run_log(str(tmp_path / "log.jsonl"))
              if e["event"] == "request_trace"]
    assert len(traces) == 800 and len({t["trace"] for t in traces}) == 800


def test_batch_ids_unique_across_recorder_incarnations(tmp_path):
    """A restarted server appending to the same log gets new batch ids,
    so serve-report joins each request to its own batch."""
    path = tmp_path / "replica.jsonl"
    ids = []
    for inc in range(2):
        log = t_run_log.RunLogger(str(path), mode="w" if inc == 0 else "a",
                                  header=True)
        rec = t_tracing.TraceRecorder(threshold_s=0.0, sample_every=0,
                                      cap=16, run_logger=log)
        bt = rec.begin_batch(bucket=8, rows=4, requests=1)
        bt.stamp("dispatch", 0.001 * (inc + 1))
        rec.finish_batch(bt)
        ids.append(bt.batch_id)
        _finish_with_duration(t_tracing, rec, 0.020, batch=bt.batch_id)
        rec.close()
        log.close()
    assert ids[0] != ids[1]
    for m in PKGS.values():
        result = m.serve_report.analyze(
            m.serve_report.load_trace_files([str(path)]))
        assert result["stages"]["dispatch"]["count"] == 2
        assert result["tail_requests"] == 2


class _EchoEngine:
    version = "echo-1"

    def score_batch(self, rows, bucket, trace=None):
        vals = np.asarray(rows, np.float32)
        return vals, vals * 2.0, np.zeros(len(rows), bool)


def test_batch_registered_before_members_finish():
    """The batcher registers a batch before waking its members, so every
    kept request's batch is emitted."""
    from photon_ml_torch.serving.batcher import MicroBatcher

    rec = t_tracing.start(threshold_s=0.0, sample_every=0, cap=64)
    batcher = None
    try:
        engine = _EchoEngine()
        batcher = MicroBatcher(lambda: engine, [4, 8], deadline_s=0.001)
        rts = []
        for _ in range(6):
            rt = rec.begin()
            t_tracing.take_attached()
            batcher.submit([1.0, 2.0], trace=rt)
            rec.finish(rt, status=200)
            rts.append(rt)
        assert all(rt.batch is not None for rt in rts)
        assert all({"admission", "queue_wait"} <= set(rt.stages)
                   for rt in rts)
        with rec._lock:
            emitted = {bt.batch_id for bt in rec._batch_ring}
        assert {rt.batch for rt in rts} <= emitted
    finally:
        if batcher is not None:
            batcher.close()
        rec.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_stage_histograms_fold_for_dropped_requests(pkg):
    """Dropped requests still fold into ``serve.stage.*``:
    ``stage_summary`` and ``dominant_stage`` see the full stream."""
    m = PKGS[pkg]
    tel = m.telemetry.start("metrics", **({"device": "cpu"}
                                          if pkg == "port" else {}))
    try:
        rec = m.tracing.TraceRecorder(threshold_s=10.0, sample_every=0,
                                      cap=8)
        for _ in range(12):
            _finish_with_duration(m.tracing, rec, 0.001,
                                  stages={"queue_wait": 0.002,
                                          "serialize": 0.0005})
        rec.close()
        assert rec.snapshot()["sampled_tail"] == 0
        summary = m.tracing.stage_summary()
        assert summary == {
            "queue_wait": {"count": 12, "p50_ms": 2.0, "p99_ms": 2.0},
            "serialize": {"count": 12, "p50_ms": 0.5, "p99_ms": 0.5}}
        assert m.tracing.dominant_stage(summary) == ("queue_wait", 2.0)
        assert tel.counter("serve.trace.requests") == 0
    finally:
        tel.close()


# ---------------------------------------------------------------------------
# HTTP core: the trace headers on every answer
# ---------------------------------------------------------------------------


def _raw(port: int, path: str, headers: dict | None = None,
         data: bytes | None = None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers=headers or {}, data=data)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def _endpoint_answers(m) -> list:
    http = m.http

    def shed(body):
        raise http.HttpError(503, headers={"Retry-After": "1"},
                             error="overloaded")

    def boom(body):
        raise RuntimeError("route bug")

    seen = []

    def probe(body):
        ctx = m.tracing.context()
        seen.append((ctx.trace_id, ctx.hop))
        return 200, "ok", "text/plain"

    ep = http.HttpEndpoint({("GET", "/ok"): probe, ("GET", "/shed"): shed,
                            ("GET", "/boom"): boom})
    ep.start()
    out = []
    try:
        for path, hdrs in (("/ok", {"X-Photon-Trace": "feedface01/3"}),
                           ("/ok", {"X-Photon-Request-Id": "my-req-1"}),
                           ("/ok", {}), ("/shed", {}), ("/boom", {}),
                           ("/nope", {}), ("/healthz", {})):
            code, headers, _ = _raw(ep.port, path, hdrs)
            rid = headers.get("X-Photon-Request-Id")
            trace = headers.get("X-Photon-Trace", "")
            out.append((path, code, bool(rid), trace.startswith(f"{rid}/"),
                        rid if hdrs else len(rid), trace.split("/")[1],
                        headers.get("Retry-After")))
    finally:
        ep.close()
    return out, seen


def test_http_core_trace_headers_match_jax():
    """Every answer (200, 503 shed, 500, 404, /healthz) echoes the
    request id and trace headers, adopted from the client's or minted,
    in the same form in both packages; routes see the context."""
    j, j_seen = _endpoint_answers(PKGS["jax"])
    t, t_seen = _endpoint_answers(PKGS["port"])
    assert t == j
    assert [a[1] for a in t] == [200, 200, 200, 503, 500, 404, 200]
    assert t_seen[:2] == j_seen[:2] == [("feedface01", 3), ("my-req-1", 0)]


# ---------------------------------------------------------------------------
# flow export + serve-report
# ---------------------------------------------------------------------------


def _request_rec(trace, role, wall_t, total_ms, stages=None, batch=None,
                 **extra):
    return {"event": "request_trace", "trace": trace, "hop": 0,
            "role": role, "wall_t": wall_t, "total_ms": total_ms,
            "stages_ms": stages or {}, "sampled": "tail",
            **({"batch": batch} if batch is not None else {}), **extra}


def _processes():
    """A frontend and one replica sharing two trace ids and one batch."""
    frontend = {"name": "frontend", "requests": [
        _request_rec("t1", "frontend", 100.000, 80.0,
                     {"route": 1.0, "forward": 70.0}),
        _request_rec("t2", "frontend", 100.010, 60.0,
                     {"route": 0.5, "retry": 20.0, "forward": 30.0},
                     attempts=[{"replica": 0, "ms": 20.0,
                                "outcome": "connect_fail:OSError"},
                               {"replica": 1, "ms": 30.0,
                                "outcome": 200}]),
    ], "batches": []}
    replica = {"name": "replica_0", "requests": [
        _request_rec("t1", "replica", 100.002, 70.0,
                     {"admission": 1.0, "queue_wait": 40.0,
                      "serialize": 0.5, "write": 1.0}, batch="b.7"),
        _request_rec("t2", "replica", 100.032, 28.0,
                     {"admission": 0.5, "queue_wait": 5.0,
                      "serialize": 0.4, "write": 0.8}, batch="b.7"),
    ], "batches": [
        {"event": "batch_trace", "batch": "b.7", "wall_t": 100.045,
         "total_ms": 12.0, "bucket": 8, "rows": 4, "requests": 2,
         "stages_ms": {"assemble": 1.0, "store_lookup": 2.0,
                       "dispatch": 6.0, "d2h": 3.0}},
    ]}
    return [frontend, replica]


def test_flow_export_matches_jax():
    """The Chrome flow export equals the JAX package's event for event;
    every flow start has its finish and request flows cross pids."""
    t = t_export.serve_trace_events(_processes())
    assert t == j_export.serve_trace_events(_processes())
    starts = {e["id"]: e for e in t if e["ph"] == "s"}
    finishes = {e["id"]: e for e in t if e["ph"] == "f"}
    assert set(starts) == set(finishes)
    for trace in ("t1", "t2"):
        assert starts[trace]["pid"] != finishes[trace]["pid"]
        assert finishes[f"{trace}:bb.7"]["tid"] == 2


def _write_log(m, path, records):
    log = m.run_log.RunLogger(str(path))
    for rec in records:
        rec = dict(rec)
        kind = rec.pop("event")
        log.event(kind, **rec)
    log.close()


def _same_report(a: dict, b: dict) -> None:
    """Two serve-report results agree: stages and counts exactly, every
    share within 1e-9."""
    for key in ("ok", "stages", "dominant_counts", "dominant_stage",
                "tail_requests", "joined", "sampled_requests",
                "frontend_requests", "replica_requests",
                "retried_requests", "retry_cost_ms", "slowest"):
        assert a[key] == b[key], key
    for key in ("join_fraction",):
        if a[key] is None:
            assert b[key] is None
        else:
            assert abs(a[key] - b[key]) <= SHARE_TOL


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_serve_report_reads_either_packages_logs(tmp_path, writer):
    """Logs written by either package: both reports give the same table,
    join and retry cost, and the same Perfetto flow file."""
    w = PKGS[writer]
    procs = _processes()
    _write_log(w, tmp_path / "frontend.jsonl", procs[0]["requests"])
    _write_log(w, tmp_path / "replica.jsonl",
               procs[1]["requests"] + procs[1]["batches"])
    paths = [str(tmp_path / "frontend.jsonl"),
             str(tmp_path / "replica.jsonl")]
    res = {}
    for p, m in PKGS.items():
        res[p] = m.serve_report.run_serve_report(
            paths, trace_out=str(tmp_path / f"{p}.flow.json"),
            out=io.StringIO())
    _same_report(res["port"], res["jax"])
    assert res["port"]["join_fraction"] == 1.0
    assert res["port"]["retry_cost_ms"]["total"] == pytest.approx(20.0)
    t1 = next(r for r in res["port"]["slowest"] if r["trace"] == "t1")
    assert t1["dominant"] == "queue_wait"
    flows = [json.load(open(tmp_path / f"{p}.flow.json")) for p in PKGS]
    assert flows[0] == flows[1]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_serve_report_cli_rc(tmp_path, pkg):
    """rc 1 when the join breaks or no trace exists; rc 0 on one
    server's log (join N/A)."""
    m = PKGS[pkg]
    procs = _processes()
    _write_log(m, tmp_path / "frontend.jsonl",
               [dict(r, trace=f"other-{i}")
                for i, r in enumerate(procs[0]["requests"])])
    _write_log(m, tmp_path / "replica.jsonl",
               procs[1]["requests"] + procs[1]["batches"])
    _write_log(m, tmp_path / "empty.jsonl", [])
    assert m.main(["serve-report", str(tmp_path / "frontend.jsonl"),
                   str(tmp_path / "replica.jsonl")]) == 1
    assert m.main(["serve-report", str(tmp_path / "replica.jsonl")]) == 0
    assert m.main(["serve-report", str(tmp_path / "empty.jsonl")]) == 1


# ---------------------------------------------------------------------------
# end to end through both packages' servers
# ---------------------------------------------------------------------------


def _post(port, rows, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/score",
        data=json.dumps({"rows": rows}).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read()), dict(r.headers)


def _traced_run(pkg, tmp_path, mdir, rows) -> dict:
    """Serve ``rows`` in 4-row requests through ``pkg``'s server (every
    tier on, threshold 0) → the log path, answers and /status."""
    m = PKGS[pkg]
    log_path = str(tmp_path / f"{pkg}_run_log.jsonl")
    log = m.run_log.RunLogger(log_path)
    srv = _server(pkg, mdir, tmp_path / pkg, run_logger=log,
                  trace_threshold_ms=0.0)
    answers = {}
    try:
        code, hdrs, _ = _raw(srv.port, "/v1/score", data=b"{}",
                             headers={"X-Photon-Request-Id": "warm-1"})
        answers[503] = (code, hdrs.get("X-Photon-Request-Id"))
        srv.start()
        out, hdrs = _post(srv.port, rows[:4],
                          headers={"X-Photon-Trace": "cafebabe1234/1"})
        answers[200] = (200, hdrs.get("X-Photon-Request-Id"),
                        hdrs.get("X-Photon-Trace"))
        margins = [out["margins"]]
        for lo in range(4, len(rows), 4):
            margins.append(_post(srv.port, rows[lo: lo + 4])[0]["margins"])
        code, hdrs, _ = _raw(srv.port, "/v1/score", data=b"{not json",
                             headers={"X-Photon-Request-Id": "bad-1"})
        answers[400] = (code, hdrs.get("X-Photon-Request-Id"))
        faults = _faults(pkg)
        with faults.injected(faults.FaultInjector([faults.Fault(
                site="serve.dispatch", kind="error", at=0)])):
            code, hdrs, _ = _raw(
                srv.port, "/v1/score",
                data=json.dumps({"rows": rows[:1]}).encode(),
                headers={"X-Photon-Request-Id": "boom-1"})
        answers[500] = (code, hdrs.get("X-Photon-Request-Id"))
        n_req = len(rows) // 4 + 2    # the 200s, the 400 and the 500
        # The trace finishes after the reply is sent: poll /status.
        deadline = time.monotonic() + 10.0
        while True:
            status = json.loads(_raw(srv.port, "/status")[2])
            if (status["serving"]["tracing"]["requests"] >= n_req
                    or time.monotonic() > deadline):
                break
            time.sleep(0.02)
    finally:
        srv.stop()
        log.close()
    return {"log": log_path, "answers": answers, "status": status,
            "margins": np.concatenate(margins)}


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Both packages' servers on one model and the same 16 requests."""
    tmp = tmp_path_factory.mktemp("traced")
    jm = _jax_model()
    mdir = str(tmp / "model")
    jio.save_game_model(jm, JTask.LOGISTIC_REGRESSION, mdir)
    rows = _requests(jm, n=16)
    return {p: _traced_run(p, tmp, mdir, rows) for p in PKGS}


def test_served_trace_headers_match_jax(traced):
    """200, 400, 503 and 500 answers carry the client's request id (or
    the adopted trace) in both packages alike."""
    t, j = traced["port"]["answers"], traced["jax"]["answers"]
    assert t == j
    assert t[200] == (200, "cafebabe1234", "cafebabe1234/1")
    assert t[400] == (400, "bad-1") and t[503] == (503, "warm-1")
    assert t[500] == (500, "boom-1")


def test_served_trace_events_match_jax_in_keys(traced):
    """The servers' ``request_trace`` / ``batch_trace`` /
    ``serve_trace_summary`` events have the same keys and stages; the
    adopted trace id keeps its hop."""
    ev = {p: t_run_log.read_run_log(traced[p]["log"]) for p in PKGS}

    def keys(events, kind):
        return {tuple(sorted(e)) for e in events if e["event"] == kind}

    def stages(events, kind):
        return {tuple(sorted(e["stages_ms"])) for e in events
                if e["event"] == kind}

    for kind in ("request_trace", "batch_trace"):
        assert keys(ev["port"], kind) == keys(ev["jax"], kind), kind
        assert stages(ev["port"], kind) == stages(ev["jax"], kind), kind
    assert keys(ev["port"], "serve_trace_summary") == \
        keys(ev["jax"], "serve_trace_summary")
    adopted = [e for e in ev["port"] if e["event"] == "request_trace"
               and e["trace"] == "cafebabe1234"]
    assert len(adopted) == 1 and adopted[0]["hop"] == 1
    statuses = sorted(e.get("status") for e in ev["port"]
                      if e["event"] == "request_trace")
    assert statuses == sorted(e.get("status") for e in ev["jax"]
                              if e["event"] == "request_trace")
    # The 503 came before start(), when no recorder was active.
    assert set(statuses) == {200, 400, 500}


def test_served_status_matches_jax(traced):
    """/status: the tracer's snapshot, the stage table's stages and the
    monitor's sections are the JAX server's."""
    t, j = traced["port"]["status"], traced["jax"]["status"]
    assert sorted(t) == sorted(j)
    tt, jt = t["serving"]["tracing"], j["serving"]["tracing"]
    assert tt == jt
    assert sorted(t["serving"]["stages"]) == sorted(j["serving"]["stages"])
    for stage in ("admission", "queue_wait", "assemble", "store_lookup",
                  "dispatch", "d2h", "serialize", "write"):
        assert stage in t["serving"]["stages"], stage


def test_served_margins_with_tracing_match_jax(traced):
    np.testing.assert_allclose(traced["port"]["margins"],
                               traced["jax"]["margins"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("log_of", ["jax", "port"])
def test_serve_report_on_server_logs_matches_jax(traced, log_of):
    """Each package's serve-report on the other's server log: the same
    stages with the same counts, tail requests and shares."""
    path = traced[log_of]["log"]
    res = {p: m.serve_report.run_serve_report([path], out=io.StringIO())
           for p, m in PKGS.items()}
    _same_report(res["port"], res["jax"])
    assert res["port"]["ok"] and res["port"]["join_fraction"] is None
    n = sum(1 for e in t_run_log.read_run_log(path)
            if e["event"] == "request_trace")
    assert res["port"]["tail_requests"] == n
    assert {"queue_wait", "dispatch", "d2h"} <= set(res["port"]["stages"])


def test_traced_server_builds_nothing_and_is_bitwise(tmp_path):
    """A warm traced server builds no kernel, and its margins are the
    untraced server's to the bit."""
    jm = _jax_model()
    mdir = str(tmp_path / "model")
    jio.save_game_model(jm, JTask.LOGISTIC_REGRESSION, mdir)
    rows = _requests(jm, n=8)
    got = {}
    for trace in ("off", "on"):
        srv = _server("port", mdir, tmp_path, telemetry="off",
                      monitor="off", trace=trace,
                      trace_threshold_ms=0.0).start()
        try:
            _post(srv.port, rows[:4])
            with count_compiles() as builds:
                got[trace] = [_post(srv.port, rows[lo: lo + 4])[0]
                              ["margins"] for lo in (0, 4)]
            assert builds.count == 0
            if trace == "on":
                assert t_tracing.active().snapshot()["batches"] >= 3
            else:
                assert t_tracing.active() is None
        finally:
            srv.stop()
    assert got["on"] == got["off"]
