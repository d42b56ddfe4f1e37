"""The port's live monitor and ``watch`` held against the JAX package's.

Every scenario drives both packages' ``Monitor`` with the same synthetic
stream (a fake clock, a raw telemetry registry, an event sink) and must
give the same ``progress`` and ``alert`` events, event for event, with
exactly the expected rules latched.  Then the status endpoint, the
Prometheus text of one registry, ``watch --once`` on each package's
logs, both packages' servers under the same traffic (``/metrics``
families, label sets and counter values), an injected slow dispatch
that latches one ``serve_tail_latency`` alert in each, and
``RunLogger.timed`` phases on ``/status``.
"""

from __future__ import annotations

import json
import math
import time
import types
import urllib.error
import urllib.request

import pytest

from photon_ml_tpu import telemetry as j_telemetry
from photon_ml_tpu.io import model_io as jio
from photon_ml_tpu.models.glm import TaskType as JTask
from photon_ml_tpu.telemetry import monitor as j_monitor
from photon_ml_tpu.telemetry.__main__ import main as j_telemetry_main
from photon_ml_tpu.utils import run_log as j_run_log
from photon_ml_torch import telemetry as t_telemetry
from photon_ml_torch.telemetry import monitor as t_monitor
from photon_ml_torch.telemetry import watch as t_watch
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
    "jax": types.SimpleNamespace(telemetry=j_telemetry, monitor=j_monitor,
                                 run_log=j_run_log, main=j_telemetry_main),
    "port": types.SimpleNamespace(telemetry=t_telemetry, monitor=t_monitor,
                                  run_log=t_run_log, main=t_telemetry_main),
}


@pytest.fixture(autouse=True)
def _no_leaked_sessions():
    for m in PKGS.values():
        assert m.monitor.active() is None and m.telemetry.active() is None
    yield
    leaked = []
    for name, m in PKGS.items():
        for kind, mod in (("monitor", m.monitor),
                          ("telemetry", m.telemetry)):
            if mod.active() is not None:
                mod.active().close()
                leaked.append(f"{name}.{kind}")
    assert not leaked, f"leaked sessions: {leaked}"


class _FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def tick(self, dt: float) -> float:
        self.t += dt
        return self.t


class _EventSink:
    """RunLogger stand-in collecting events."""

    def __init__(self, clock):
        self.events: list = []
        self._clock = clock

    def now(self) -> float:
        return self._clock()

    def event(self, kind: str, **fields) -> None:
        self.events.append({"event": kind, **fields})

    def close(self) -> None:
        pass

    def of(self, kind: str) -> list:
        return [e for e in self.events if e["event"] == kind]


def _monitor(pkg, every_s=0.0, **kw):
    """``pkg``'s Monitor on a fake clock with a raw registry, not
    activated as the module global."""
    m = PKGS[pkg]
    clock = _FakeClock()
    reg = m.telemetry.Telemetry("metrics", _EventSink(clock), None)
    sink = _EventSink(clock)
    mon = m.monitor.Monitor(run_logger=sink, every_s=every_s, clock=clock,
                            telemetry_session=reg, **kw)
    return mon, sink, clock, reg


# ---------------------------------------------------------------------------
# scenarios: (drive, expected rules); each runs on both packages
# ---------------------------------------------------------------------------


def _healthy(m, clock, reg):
    loss = 100.0
    for i in range(60):
        clock.tick(0.5)
        loss *= 0.98
        m.progress("solver", i + 1, 100, unit="iters", loss=loss)


def _nonfinite(m, clock, reg):
    for i in range(10):
        clock.tick(0.5)
        m.progress("solver", i + 1, 100, loss=float("nan"))


def _diverging(m, clock, reg):
    for i, loss in enumerate([100.0, 80.0, 60.0, 50.0, 70.0, 90.0,
                              150.0, 400.0, 900.0]):
        clock.tick(0.5)
        m.progress("solver", i + 1, 20, loss=loss)


def _collapse(m, clock, reg):
    done = 0
    for _ in range(8):
        clock.tick(0.5)
        done += 10
        m.progress("sweep", done, 10_000, unit="chunks")
    for _ in range(40):
        clock.tick(5.0)
        done += 1
        m.progress("sweep", done, 10_000, unit="chunks")


def _retry_rate(m, clock, reg):
    for i in range(20):
        clock.tick(0.5)
        reg.count("store.retries")
        m.progress("sweep", i + 1, 100)


def _gave_up(m, clock, reg):
    reg.count("store.gave_up")
    clock.tick(0.5)
    m.progress("sweep", 1, 100)


def _stall_timeout(m, clock, reg):
    reg.count("prefetch.stall_timeouts")
    clock.tick(0.5)
    m.progress("sweep", 1, 100)


def _stall_wait(m, clock, reg):
    for i in range(10):
        clock.tick(0.5)
        reg.count("prefetch.consumer_wait_s", 0.45)
        m.progress("sweep", i + 1, 100)


def _sink_streak(m, clock, reg):
    for i, depth in enumerate([4.0, 1.0, 4.0, 4.0]):
        reg.gauge("sink.queue_depth", depth)
        clock.tick(0.5)
        m.progress("score", i + 1, 100)


def _memory_growth(m, clock, reg):
    for i, b in enumerate([1e9, 1.4e9, 2.1e9]):
        reg.gauge("device.bytes_in_use", b)
        clock.tick(0.5)
        m.progress("sweep", i + 1, 100)


def _serve_tail(m, clock, reg):
    for _ in range(30):
        reg.count("serve.requests")
        reg.observe("serve.request_s", 0.9)
        reg.observe("serve.stage.d2h_s", 0.7)
        reg.observe("serve.stage.queue_wait_s", 0.1)
    for n in (30, 60):
        clock.tick(0.5)
        m.progress("serve", n, unit="requests")


def _serve_fast(m, clock, reg):
    for _ in range(200):
        reg.count("serve.requests")
        reg.observe("serve.request_s", 0.005)
    clock.tick(0.5)
    m.progress("serve", 200, unit="requests")


def _serve_slow_few(m, clock, reg):
    for _ in range(5):
        reg.count("serve.requests")
        reg.observe("serve.request_s", 2.0)
    clock.tick(0.5)
    m.progress("serve", 5, unit="requests")


def _serve_queue_wait(m, clock, reg):
    for _ in range(30):
        reg.count("serve.requests")
        reg.observe("serve.request_s", 0.100)
        reg.observe("serve.stage.queue_wait_s", 0.080)
    for n in (30, 60):
        clock.tick(0.5)
        m.progress("serve", n, unit="requests")


def _serve_shed(m, clock, reg):
    for _ in range(10):
        clock.tick(0.1)
        reg.count("serve.requests")
        reg.count("serve.shed")
    clock.tick(0.1)
    m.progress("serve", 10, unit="requests")
    clock.tick(0.5)
    reg.count("serve.shed")
    m.progress("serve", 11, unit="requests")


def _serve_shed_low(m, clock, reg):
    for i in range(40):
        clock.tick(0.1)
        reg.count("serve.requests")
        if i == 0:
            reg.count("serve.shed")
    clock.tick(0.1)
    m.progress("serve", 40, unit="requests")


def _restarts(m, clock, reg):
    reg.count("fleet.replica_restarts")
    for n in (1, 2):
        clock.tick(0.5)
        m.progress("serve", n, unit="requests")
        reg.count("fleet.replica_restarts", 3)


def _throttled(m, clock, reg):
    for i in range(300):
        clock.tick(0.01)
        m.progress("hot", i + 1, 300, unit="chunks")


SCENARIOS = {
    "healthy": (_healthy, [], {}),
    "loss_nonfinite": (_nonfinite, [("loss_nonfinite", "solver")], {}),
    "loss_diverging": (_diverging, [("loss_diverging", "solver")], {}),
    "throughput_collapse": (_collapse, [("throughput_collapse", "sweep")],
                            {}),
    "retry_rate": (_retry_rate, [("retry_storm", None)], {}),
    "retry_gave_up": (_gave_up, [("retry_storm", None)], {}),
    "stall_timeout": (_stall_timeout, [("prefetch_stall", None)], {}),
    "stall_wait": (_stall_wait, [("prefetch_stall", None)], {}),
    "sink_streak": (_sink_streak, [("sink_saturation", None)], {}),
    "memory_growth": (_memory_growth, [("device_memory_growth", None)], {}),
    "serve_tail": (_serve_tail, [("serve_tail_latency", "serve")], {}),
    "serve_fast": (_serve_fast, [], {}),
    "serve_slow_few": (_serve_slow_few, [], {}),
    "serve_queue_wait": (_serve_queue_wait, [("serve_queue_wait",
                                              "serve")], {}),
    "serve_shed": (_serve_shed, [("serve_shed_rate", "serve")], {}),
    "serve_shed_low": (_serve_shed_low, [], {}),
    "replica_restarts": (_restarts, [("replica_restarts", None)], {}),
    "alerts_off": (_nonfinite, [], {"alerts": False}),
    "throttled": (_throttled, [], {"every_s": 1.0}),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_jax(name):
    """Both packages' monitors emit the same progress and alert events
    on the same stream, and latch exactly the expected rules."""
    drive, rules, kw = SCENARIOS[name]
    out = {}
    for pkg in PKGS:
        mon, sink, clock, reg = _monitor(pkg, **kw)
        drive(mon, clock, reg)
        status = mon.status()
        mon.close()
        out[pkg] = (sink.events, status)
    (t_events, t_status), (j_events, j_status) = out["port"], out["jax"]
    # Through JSON, so a NaN loss compares equal to itself.
    assert json.dumps(t_events) == json.dumps(j_events)
    assert json.dumps(t_status) == json.dumps(j_status)
    got = [(e["rule"], e.get("stage")) for e in t_events
           if e["event"] == "alert"]
    assert sorted(got, key=str) == sorted(rules, key=str)
    assert len(t_status["alerts"]) == len(rules)
    if name == "serve_tail":
        alert = [e for e in t_events if e["event"] == "alert"][0]
        assert alert["dominant_stage"] == "d2h"
        prog = [e for e in t_events if e["event"] == "progress"][0]
        assert prog["stages_ms"]["d2h"]["count"] == 30
    if name == "throttled":
        assert 3 <= len([e for e in t_events
                         if e["event"] == "progress"]) <= 6


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_lifecycle_gating_and_phases(pkg):
    mon = PKGS[pkg].monitor
    mon.progress("stage", 1, 10, loss=float("nan"))      # off: a no-op
    m = mon.start()
    try:
        with pytest.raises(RuntimeError, match="already active"):
            mon.start()
        assert mon.active() is m
        m.phase_begin("fit")
        m.phase_begin("sweep")
        m.phase_end("no_such_phase")
        assert m.status()["phase"] == "sweep"
        m.phase_end("sweep")
        assert m.status()["phase"] == "fit"
    finally:
        m.close()
    assert mon.active() is None
    with mon.maybe_monitor(False) as m:
        assert m is None
    with mon.maybe_monitor(False, status_port=0) as m:
        assert m.status_port > 0
    with pytest.raises(ValueError, match="unknown alert thresholds"):
        mon.Monitor(thresholds={"no_such_knob": 1})
    assert mon.DEFAULT_THRESHOLDS == j_monitor.DEFAULT_THRESHOLDS


def test_run_logger_phases_reach_status(tmp_path):
    """``RunLogger.timed`` phases are the monitor's ``/status`` phase,
    and ``progress``/``alert`` events flush at once."""
    log = t_run_log.RunLogger(str(tmp_path / "run_log.jsonl"),
                              flush_every_s=60.0)
    m = t_monitor.start(run_logger=log, every_s=0.0)
    try:
        with log.timed("fit"):
            with log.timed("sweep"):
                assert m.status()["phase"] == "sweep"
                t_monitor.progress("solver", 1, 2, loss=float("inf"))
                lines = open(tmp_path / "run_log.jsonl").read()
                assert '"alert"' in lines and '"progress"' in lines
            assert m.status()["phase"] == "fit"
        assert m.status()["phase"] is None
    finally:
        m.close()
        log.close()


def _http_get(port, route):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                    timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_status_endpoint_routes(pkg):
    """/healthz warming → ready, /status, /metrics and 404 on the
    monitor's own endpoint, alike in both packages."""
    mon = PKGS[pkg].monitor
    m = mon.start(status_port=0)
    try:
        port = m.status_port
        assert _http_get(port, "/healthz")[0] == 503
        mon.progress("sweep", 3, 12, unit="chunks")
        code, ctype, body = _http_get(port, "/status")
        assert code == 200 and ctype == "application/json"
        st = json.loads(body)
        assert st["stages"]["sweep"]["done"] == 3.0 and st["alerts"] == []
        code, ctype, body = _http_get(port, "/metrics")
        assert code == 200 and "version=0.0.4" in ctype
        assert 'photon_monitor_progress_done{stage="sweep"} 3.0' in body
        assert _http_get(port, "/healthz")[0] == 200
        code, _, body = _http_get(port, "/no_such")
        assert code == 404 and "/status" in body
    finally:
        m.close()


def _registry_text(pkg) -> str:
    m = PKGS[pkg]
    clock = _FakeClock()
    reg = m.telemetry.Telemetry("metrics", _EventSink(clock), None)
    reg.count("store.loads", 7)
    reg.count("serve.requests", 3)
    reg.gauge("sink.queue_depth", 2.0)
    for v in range(100):
        reg.observe("sink.write_s", float(v))
        reg.observe("serve.stage.queue_wait_s", v / 1e3)
        reg.observe("serve.stage.d2h_s", v / 2e3)
    mon = m.monitor.Monitor(run_logger=_EventSink(clock), every_s=0.0,
                            clock=clock, telemetry_session=reg)
    mon.progress("score", 5, 10, unit="rows")
    text = m.monitor.prometheus_text(mon, session=reg)
    mon.close()
    return text


def test_prometheus_text_matches_jax():
    """The same registry and monitor state expose the same text, with
    the stage histograms as one labelled family."""
    t = _registry_text("port")
    assert t == _registry_text("jax")
    lines = t.splitlines()
    assert lines.count("# TYPE photon_serve_stage_seconds summary") == 1
    assert 'photon_serve_stage_seconds_count{stage="d2h"} 100' in lines
    assert "photon_serve_requests_total 3" in lines
    assert 'photon_monitor_progress_total{stage="score"} 10.0' in lines


# ---------------------------------------------------------------------------
# watch
# ---------------------------------------------------------------------------


def _write_live_log(m, path, segments=1, done=False, alerts=0,
                    serve=False, death=False):
    for seg in range(segments):
        log = m.run_log.RunLogger(path, mode="w" if seg == 0 else "a",
                                  header=True, run_info={"driver": "test"})
        log.event("phase_start", phase="fit")
        for i in range(5):
            log.event("progress", stage="solver", done=float(i + 1),
                      total=20.0, unit="iters", rate=2.0, eta_s=7.5,
                      loss=100.0 * (0.9 ** i), phase="fit")
        if serve:
            log.event("progress", stage="serve", done=100.0, unit="rows",
                      stages_ms={"queue_wait": {"count": 40, "p50_ms": 2.1,
                                                "p99_ms": 9.5},
                                 "d2h": {"count": 12, "p50_ms": 3.3,
                                         "p99_ms": 6.2}})
        final = seg == segments - 1
        for _ in range(alerts if final else 0):
            log.event("alert", rule="loss_diverging", severity="error",
                      stage="solver", message="loss 900 is 18x best")
        if death and final:
            log.event("thread_exception", stage="prefetch", error="boom",
                      thread="chunk-prefetch")
        if done or not final:
            log.event("phase_end", phase="fit", duration_s=2.5)
            if done and final:
                log.event("done", best_index=0)
        log.close()


def _strip(snap: dict) -> dict:
    """A snapshot without what differs by file (path, run id, event
    times)."""
    out = {k: v for k, v in snap.items()
           if k not in ("log", "run_id", "last_event_t")}
    out["stages"] = {s: {k: v for k, v in st.items() if k != "t"}
                     for s, st in out["stages"].items()}
    out["alerts"] = [{k: v for k, v in a.items() if k != "t"}
                     for a in out["alerts"]]
    return out


@pytest.mark.parametrize("case", [
    {}, {"segments": 2, "done": True}, {"alerts": 1, "death": True},
    {"serve": True, "done": True}, {"torn": True}])
def test_watch_once_matches_jax(tmp_path, capsys, case):
    """``watch --once`` of either package on either package's log gives
    the same snapshot and exit code."""
    case = dict(case)
    torn = case.pop("torn", False)
    snaps, rcs = [], []
    for writer in PKGS:
        path = str(tmp_path / f"{writer}.jsonl")
        _write_live_log(PKGS[writer], path, **case)
        if torn:
            with open(path, "a") as f:
                f.write('{"event": "progress", "stage": "solver", "done": 6')
        for reader in PKGS.values():
            rcs.append(reader.main(["watch", path, "--once"]))
            out = capsys.readouterr().out
            snaps.append(_strip(json.loads(out.strip().splitlines()[-1])))
    assert all(s == snaps[0] for s in snaps[1:])
    assert len(set(rcs)) == 1
    snap = snaps[0]
    assert snap["stages"]["solver"]["done"] == 5.0
    assert rcs[0] == (1 if case.get("death") else 0)
    if torn:
        assert snap["torn_lines"] == 1 and snap["live"] is True
    if case.get("serve"):
        assert snap["serve_dominant"] == {"stage": "queue_wait",
                                          "p99_ms": 9.5}
    if case.get("segments"):
        assert snap["segments"] == 2 and snap["live"] is False


def test_watch_follow_bounded_and_rejects_bad_interval(tmp_path, capsys):
    path = str(tmp_path / "run_log.jsonl")
    _write_live_log(PKGS["port"], path)
    rc = t_telemetry_main(["watch", path, "--interval", "0.05",
                           "--max-wait-s", "0.2"])
    snap = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and snap["live"] is True
    with pytest.raises(ValueError, match="interval_s"):
        t_watch.watch(path, interval_s=0.0)


# ---------------------------------------------------------------------------
# both servers: /metrics after the same traffic, a fault's one alert
# ---------------------------------------------------------------------------


def _prom(text: str) -> dict:
    """Prometheus text → {family: type}, {series: value}."""
    types_, values = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            types_[name] = kind
        elif line and not line.startswith("#"):
            series, value = line.rsplit(" ", 1)
            values[series] = float(value)
    return {"types": types_, "values": values}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both packages' servers (every tier on) after the same 8
    sequential 2-row requests → their /metrics, /status and alerts."""
    tmp = tmp_path_factory.mktemp("served")
    jm = _jax_model()
    mdir = str(tmp / "model")
    jio.save_game_model(jm, JTask.LOGISTIC_REGRESSION, mdir)
    rows = _requests(jm, n=16)
    out = {}
    for pkg in PKGS:
        srv = _server(pkg, mdir, tmp / pkg, monitor_every_s=0.01,
                      batch_deadline_ms=0.0).start()
        try:
            for lo in range(0, 16, 2):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{srv.port}/v1/score",
                    data=json.dumps({"rows": rows[lo: lo + 2]}).encode())
                with urllib.request.urlopen(req, timeout=30) as r:
                    r.read()
            deadline = time.monotonic() + 10.0
            while True:
                metrics = _prom(_http_get(srv.port, "/metrics")[2])
                if (metrics["values"].get("photon_serve_requests_total")
                        == 8 or time.monotonic() > deadline):
                    break
                time.sleep(0.02)
            status = json.loads(_http_get(srv.port, "/status")[2])
        finally:
            srv.stop()
        out[pkg] = {"metrics": metrics, "status": status}
    return out


def _serve_families(m: dict) -> dict:
    return {k: v for k, v in m["types"].items()
            if k.startswith(("photon_serve_", "photon_monitor_"))}


def test_metrics_families_and_counters_match_jax(served):
    t, j = served["port"]["metrics"], served["jax"]["metrics"]
    assert _serve_families(t) == _serve_families(j)
    assert "photon_serve_stage_seconds" in _serve_families(t)

    def labels(m):
        return {s.split("{")[0] + "{" + ",".join(
            p for p in s.split("{")[1].rstrip("}").split(",")
            if not p.startswith("quantile")) + "}"
            for s in m["values"] if "{" in s
            and s.startswith(("photon_serve_", "photon_monitor_"))}

    assert labels(t) == labels(j)
    for name in ("photon_serve_requests_total", "photon_serve_batches_total",
                 "photon_serve_batch_rows_total"):
        assert t["values"][name] == j["values"][name], name
    assert t["values"]["photon_serve_requests_total"] == 8
    assert t["values"]["photon_serve_batch_rows_total"] == 16
    for name in ("photon_serve_shed_total",):
        assert t["values"].get(name) == j["values"].get(name)


def test_status_sections_match_jax(served):
    t, j = served["port"]["status"], served["jax"]["status"]
    assert sorted(t) == sorted(j)
    assert sorted(t["serving"]) == sorted(j["serving"])
    assert t["stages"]["serve"]["done"] == j["stages"]["serve"]["done"] == 16
    assert t["phase"] is j["phase"] is None


def _slow_dispatch_alerts(pkg, tmp_path) -> list:
    """21 fast requests, then one whose dispatch a ``slow`` fault holds
    past the p99 threshold, then more until an alert shows: the alerts.
    The test's own monitor (the server adopts it) turns the
    throughput-collapse and queue-wait rules off, so only the rule
    under test can fire on a loaded machine."""
    jm = _jax_model()
    mdir = str(tmp_path / pkg / "model")
    jio.save_game_model(jm, JTask.LOGISTIC_REGRESSION, mdir)
    rows = _requests(jm, n=2)
    faults = _faults(pkg)
    mon = PKGS[pkg].monitor.start(every_s=0.01, thresholds={
        "collapse_fraction": 0.0, "queue_wait_fraction": 1e9,
        "serve_p99_s": 0.2})
    srv = None
    try:
        srv = _server(pkg, mdir, tmp_path / pkg).start()

        def post():
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/v1/score",
                data=json.dumps({"rows": rows}).encode())
            with urllib.request.urlopen(req, timeout=30) as r:
                r.read()

        for _ in range(21):
            post()
        assert mon.status()["alerts"] == []
        inj = faults.FaultInjector([faults.Fault(
            site="serve.dispatch", kind="slow", at=0, delay_s=0.3)])
        with faults.injected(inj):
            post()
        deadline = time.monotonic() + 10.0
        while not mon.status()["alerts"] and time.monotonic() < deadline:
            time.sleep(0.02)
            post()
        for _ in range(3):
            time.sleep(0.02)
            post()
        alerts = mon.status()["alerts"]
    finally:
        if srv is not None:
            srv.stop()
        mon.close()
    return alerts


def test_slow_dispatch_fault_latches_one_alert_as_jax(tmp_path):
    """One injected slow dispatch: exactly one ``serve_tail_latency``
    alert on stage ``serve`` in each package, latched."""
    got = {pkg: _slow_dispatch_alerts(pkg, tmp_path) for pkg in PKGS}
    for pkg, alerts in got.items():
        assert [(a["rule"], a["stage"]) for a in alerts] == \
            [("serve_tail_latency", "serve")], (pkg, alerts)
        assert alerts[0]["p99_ms"] > 200.0
    assert sorted(got["port"][0]) == sorted(got["jax"][0])
    assert not math.isnan(got["port"][0]["p99_ms"])
