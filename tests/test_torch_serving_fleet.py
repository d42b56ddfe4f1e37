"""The port's replica fleet and frontend held against
``photon_ml_tpu.serving.fleet`` / ``.frontend``.

The supervisor matrix mirrors the reference's own
(``tests/test_serving_fleet.py``): in-process stub replicas (the HTTP
core with a score echo, killable, born dead on demand) behind a stub
launcher, ``_step()`` driven on a fake clock.  Every scripted case runs
twice, once on each package's ``FleetSupervisor`` with the same stub
script and a fresh clock, and holds that the replica states and
``status()`` (pids and urls left out) after every step, the ``fleet_*``
run-log events and the ``fleet.*`` counters are equal.  The frontend
cases run the same way over real sockets, each package's
``FleetFrontend`` in front of the stubs, and hold their answers, headers
and counters equal.

Then the port alone: a fleet process with a CUDA config touches no
``torch.cuda`` call; one real replica (``SubprocessReplicaLauncher``,
``device="cpu"``) answers within 1e-5 of the JAX server; and, marked
``slow`` as in the reference, two real replicas with one SIGKILLed under
client traffic.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from photon_ml_tpu import telemetry as j_telemetry
from photon_ml_tpu.config import ServingConfig as JServingConfig
from photon_ml_tpu.io import model_io as jio
from photon_ml_tpu.models.glm import TaskType as JTask
from photon_ml_tpu.reliability import faults as j_faults
from photon_ml_tpu.serving import fleet as j_fleet
from photon_ml_tpu.serving import frontend as j_frontend
from photon_ml_tpu.serving import tracing as j_tracing
from photon_ml_tpu.telemetry import monitor as j_monitor
from photon_ml_torch import telemetry as t_telemetry
from photon_ml_torch.config import ServingConfig, load_serving_config
from photon_ml_torch.reliability import faults as t_faults
from photon_ml_torch.serving import fleet as t_fleet
from photon_ml_torch.serving import frontend as t_frontend
from photon_ml_torch.serving import tracing as t_tracing
from photon_ml_torch.serving.http import (
    READY,
    HttpEndpoint,
    HttpError,
    Readiness,
)
from photon_ml_torch.telemetry import monitor as t_monitor
from photon_ml_torch.utils.run_log import RunLogger, read_run_log
from test_torch_serving import K, _jax_model, _jserve_cfg, _requests
from test_torch_training import jax_fresh_caches  # noqa: F401  (C5)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5

PKGS = {
    "jax": types.SimpleNamespace(
        fleet=j_fleet, frontend=j_frontend, config=JServingConfig,
        telemetry=j_telemetry, monitor=j_monitor, tracing=j_tracing,
        faults=j_faults, start_telemetry=lambda: j_telemetry.start(
            "metrics")),
    "port": types.SimpleNamespace(
        fleet=t_fleet, frontend=t_frontend, config=ServingConfig,
        telemetry=t_telemetry, monitor=t_monitor, tracing=t_tracing,
        faults=t_faults, start_telemetry=lambda: t_telemetry.start(
            "metrics", device="cpu")),
}
COUNTERS = ("fleet.replica_restarts", "fleet.replica_recycles",
            "fleet.replica_failures", "fleet.replica_wedged",
            "fleet.breaker_opened", "fleet.swaps", "fleet.swap_aborts",
            "serve.frontend_retries", "serve.frontend_failed", "serve.shed",
            "serve.shed_no_replica", "serve.shed_replica", "serve.requests")


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
                leaked.append(f"{name} {kind}")
    assert not leaked, f"leaked sessions: {leaked}"


class _FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt


class StubReplica:
    """In-process fake replica: the port's HTTP core with a score echo,
    controllable readiness, killable.  It records the trace context each
    request arrived with."""

    def __init__(self, version: str = "v1"):
        self.version = version
        self.readiness = Readiness(READY)
        self.rc: int | None = None
        self.scored = 0
        self.seen: list = []
        self._ep = HttpEndpoint({("POST", "/v1/score"): self._score},
                                readiness=self.readiness, port=0)
        self._ep.start()
        self.url = f"http://127.0.0.1:{self._ep.port}"

    def _score(self, body: bytes):
        rows = json.loads(body)["rows"]
        self.scored += 1
        ctx = t_tracing.context()
        self.seen.append((ctx.trace_id, ctx.hop))
        return 200, json.dumps({
            "margins": [float(r) for r in rows],
            "predictions": [2.0 * float(r) for r in rows],
            "model_version": self.version, "n": len(rows),
        }), "application/json"

    def kill(self, rc: int = -9) -> None:
        if self.rc is None:
            self.rc = rc
            self._ep.close()


class StubHandle(t_fleet.ReplicaHandle):
    def __init__(self, replica: StubReplica | None, rc: int = 1):
        self.replica = replica       # None: born dead (a failed start)
        self._dead_rc = rc

    def poll(self):
        return self._dead_rc if self.replica is None else self.replica.rc

    def url(self):
        return self.replica.url if self.replica is not None else None

    def terminate(self):
        self.kill()

    def kill(self):
        if self.replica is not None:
            self.replica.kill()

    def wait(self, timeout_s):
        return self.poll()


class StubLauncher:
    def __init__(self):
        self.launches: list[tuple[int, StubHandle]] = []
        self.dead_launches: dict[int, int] = {}   # idx -> born-dead count
        self.version = "v1"

    def launch(self, idx: int) -> StubHandle:
        if self.dead_launches.get(idx, 0) > 0:
            self.dead_launches[idx] -= 1
            h = StubHandle(None)
        else:
            h = StubHandle(StubReplica(self.version))
        self.launches.append((idx, h))
        return h

    def stub(self, idx: int) -> StubReplica:
        """The latest live stub launched for replica ``idx``."""
        for i, h in reversed(self.launches):
            if i == idx and h.replica is not None:
                return h.replica
        raise AssertionError(f"no live stub for replica {idx}")

    def launch_count(self, idx: int | None = None) -> int:
        return len([1 for i, _h in self.launches
                    if idx is None or i == idx])

    def close(self):
        for _i, h in self.launches:
            h.kill()


class EventLog:
    """A run logger that keeps its events."""

    def __init__(self):
        self.events: list = []

    def event(self, kind: str, **fields) -> None:
        self.events.append((kind, fields))


def _cfg(cls, model_dir, **kw):
    kw.setdefault("replicas", 2)
    kw.setdefault("probe_every_s", 0.05)
    kw.setdefault("probe_timeout_s", 1.0)
    kw.setdefault("unhealthy_after", 3)
    kw.setdefault("restart_backoff_s", 1.0)
    kw.setdefault("restart_backoff_max_s", 8.0)
    kw.setdefault("breaker_threshold", 3)
    kw.setdefault("breaker_window_s", 100.0)
    kw.setdefault("breaker_reset_s", 50.0)
    kw.setdefault("replica_ready_timeout_s", 30.0)
    kw.setdefault("request_timeout_s", 10.0)
    kw.setdefault("telemetry", "off")
    kw.setdefault("monitor", "off")
    return cls(model_dir=str(model_dir), port=0, **kw)


def _snapshot(sup) -> dict:
    """``status()`` without pids and urls, with each replica's backoff."""
    st = sup.status()
    for r, rec in zip(st["replicas"], sup.replicas):
        r.pop("pid")
        r.pop("url")
        r["backoff_s"] = rec.backoff_s
    return st


class Run:
    """One package's supervisor on stubs and a fake clock; ``step()``
    records the state after every step."""

    def __init__(self, pkg: str, tmp_path, watch_manifest=False,
                 frontend=False, **kw):
        self.pkg = PKGS[pkg]
        self.model_dir = tmp_path / pkg / "mdl"
        self.launcher = StubLauncher()
        self.clock = _FakeClock()
        self.log = EventLog()
        self.sup = self.pkg.fleet.FleetSupervisor(
            _cfg(self.pkg.config, self.model_dir, **kw),
            launcher=self.launcher, clock=self.clock, run_logger=self.log,
            workdir=str(tmp_path / pkg / "fleet"),
            watch_manifest=watch_manifest)
        self.fe = None
        if frontend:
            self.fe = self.pkg.frontend.FleetFrontend(self.sup.config,
                                                      self.sup)
            self.fe.start()
        self.trace: list = []

    def publish(self, content: str) -> None:
        self.model_dir.mkdir(parents=True, exist_ok=True)
        (self.model_dir / "metadata.json").write_text(content)

    def spawn_all(self) -> None:
        self.sup.spawn_all()
        self.trace.append(_snapshot(self.sup))

    def step(self) -> None:
        self.sup._step()
        self.trace.append(_snapshot(self.sup))

    def states(self) -> list:
        return [r.state for r in self.sup.replicas]

    def close(self) -> None:
        if self.fe is not None:
            self.fe.close()
        self.sup.stop()
        self.launcher.close()

    def fleet_events(self) -> list:
        out = []
        for kind, fields in self.log.events:
            if not kind.startswith("fleet_"):
                continue
            fields = dict(fields)
            fields.pop("pid", None)
            if "signature" in fields:      # (path, mtime_ns, size)
                fields["signature"] = fields["signature"][2]
            out.append((kind, fields))
        return out


def both(tmp_path, script, telemetry: bool = False, **kw) -> dict:
    """``script(run)`` on each package's supervisor; the per-step
    snapshots, the ``fleet_*`` events and the counters must be equal.
    Returns {pkg: (run, script's result)}."""
    seen = {}
    for name in ("jax", "port"):
        run = Run(name, tmp_path, **kw)
        tel = run.pkg.start_telemetry() if telemetry else None
        try:
            result = script(run)
        finally:
            run.close()
            counters = ({c: tel.counter(c) for c in COUNTERS}
                        if tel is not None else None)
            if tel is not None:
                tel.close()
        seen[name] = (run, result, counters)
    (jr, _, jc), (tr, _, tc) = seen["jax"], seen["port"]
    assert len(tr.trace) == len(jr.trace)
    for i, (a, b) in enumerate(zip(jr.trace, tr.trace)):
        assert b == a, f"step {i}"
    assert tr.fleet_events() == jr.fleet_events()
    assert tc == jc
    return {name: (run, result, counters)
            for name, (run, result, counters) in seen.items()}


# ---------------------------------------------------------------------------
# supervisor: spawn, probe, restart, breaker
# ---------------------------------------------------------------------------


def test_supervisor_spawns_probes_and_reports_ready(tmp_path):
    def script(run):
        run.spawn_all()
        assert run.states() == [t_fleet.STARTING] * 2
        run.step()
        assert run.states() == [t_fleet.READY] * 2
        st = run.sup.status()
        assert st["ready"] == 2 and st["size"] == 2 and st["restarts"] == 0
        assert all(r["url"] for r in st["replicas"])

    both(tmp_path, script)


def test_supervisor_restarts_crashed_replica_with_backoff(tmp_path):
    """Crash → DOWN for the backoff, restarted after it, READY again
    with its restart latency and the restart counter."""
    def script(run):
        run.spawn_all()
        run.step()
        run.launcher.stub(0).kill()
        run.step()                       # death seen
        assert run.sup.replicas[0].state == t_fleet.DOWN
        assert run.sup.ready_count() == 1
        run.step()                       # backoff (1 s) not over
        assert run.sup.replicas[0].state == t_fleet.DOWN
        assert run.launcher.launch_count(0) == 1
        run.clock.tick(1.1)
        run.step()                       # respawn
        assert run.sup.replicas[0].state == t_fleet.STARTING
        run.step()                       # probe → ready
        assert run.sup.replicas[0].state == t_fleet.READY
        assert run.sup.replicas[0].restarts == 1
        assert run.sup.replicas[0].last_restart_s == pytest.approx(
            1.1, abs=0.01)
        assert run.sup.status()["last_restart_s"] == pytest.approx(
            1.1, abs=0.01)

    out = both(tmp_path, script, telemetry=True)
    assert out["port"][2]["fleet.replica_restarts"] == 1


def test_supervisor_backoff_doubles_until_ready_resets(tmp_path):
    def script(run):
        run.spawn_all()
        run.step()
        backoffs = []
        run.launcher.dead_launches[0] = 2     # the next two born dead
        run.launcher.stub(0).kill()
        run.step()                            # death → backoff 1
        backoffs.append(run.sup.replicas[0].backoff_s)
        for _ in range(2):
            run.clock.tick(run.sup.replicas[0].backoff_s + 0.01)
            run.step()                        # respawn (born dead)
            run.step()                        # death → doubled
            backoffs.append(run.sup.replicas[0].backoff_s)
        assert backoffs == [1.0, 2.0, 4.0]
        run.clock.tick(run.sup.replicas[0].backoff_s + 0.01)
        run.step()                            # respawn (live)
        run.step()                            # ready
        assert run.sup.replicas[0].state == t_fleet.READY
        assert run.sup.replicas[0].backoff_s == 0.0

    both(tmp_path, script, replicas=1, breaker_threshold=100)


def test_supervisor_wedge_via_healthz_fault_seam(tmp_path):
    """``serve.replica_healthz``: ``unhealthy_after`` consecutive failed
    probes of a live process kill and restart it."""
    def script(run):
        f = run.pkg.faults
        run.spawn_all()
        run.step()
        assert run.sup.replicas[0].state == t_fleet.READY
        inj = f.FaultInjector([f.Fault(site="serve.replica_healthz",
                                       kind="error", at=0, count=3)])
        with f.injected(inj):
            run.step()
            run.step()
            assert run.sup.replicas[0].state == t_fleet.READY
            run.step()                    # the third failure: wedged
        assert len(inj.fired) == 3
        assert run.sup.replicas[0].state == t_fleet.DOWN
        assert "wedged" in run.sup.replicas[0].last_error
        run.clock.tick(1.1)
        run.step()
        run.step()
        assert run.sup.replicas[0].state == t_fleet.READY
        assert run.sup.replicas[0].restarts == 1

    out = both(tmp_path, script, telemetry=True, replicas=1)
    assert out["port"][2]["fleet.replica_wedged"] == 1


def test_circuit_breaker_opens_then_half_open_closes(tmp_path):
    def script(run):
        run.spawn_all()
        run.step()
        run.launcher.dead_launches[0] = 99    # every start fails now
        run.launcher.stub(0).kill()
        for _ in range(8):
            run.clock.tick(0.01)
            run.step()
            if run.sup.replicas[0].state == t_fleet.BROKEN:
                break
        assert run.sup.replicas[0].state == t_fleet.BROKEN
        spawns_at_open = run.launcher.launch_count(0)
        for _ in range(5):                    # open: no restarts
            run.clock.tick(5.0)
            if run.clock.t - 1000.0 > 45.0:
                break
            run.step()
            assert run.launcher.launch_count(0) == spawns_at_open
        run.launcher.dead_launches[0] = 0     # healthy again
        run.clock.tick(60.0)
        run.step()                            # the half-open spawn
        assert run.launcher.launch_count(0) == spawns_at_open + 1
        run.step()                            # ready: the breaker closes
        assert run.sup.replicas[0].state == t_fleet.READY
        assert run.sup.replicas[0].restart_times == []
        assert not run.sup.replicas[0].half_open

    out = both(tmp_path, script, telemetry=True, replicas=1,
               restart_backoff_s=0.0, restart_backoff_max_s=0.0,
               breaker_threshold=3, breaker_reset_s=50.0)
    assert out["port"][2]["fleet.breaker_opened"] == 1


def test_circuit_breaker_failed_half_open_reopens(tmp_path):
    def script(run):
        run.spawn_all()
        run.step()
        run.launcher.dead_launches[0] = 99
        run.launcher.stub(0).kill()
        for _ in range(6):
            run.clock.tick(0.01)
            run.step()
            if run.sup.replicas[0].state == t_fleet.BROKEN:
                break
        assert run.sup.replicas[0].state == t_fleet.BROKEN
        run.clock.tick(11.0)
        run.step()                            # half-open (born dead)
        run.step()                            # death → open again
        assert run.sup.replicas[0].state == t_fleet.BROKEN

    out = both(tmp_path, script, telemetry=True, replicas=1,
               restart_backoff_s=0.0, restart_backoff_max_s=0.0,
               breaker_threshold=2, breaker_reset_s=10.0)
    assert out["port"][2]["fleet.breaker_opened"] == 2


def test_launch_failure_goes_through_the_restart_policy(tmp_path):
    """A launcher that raises is a failed start: DOWN with a backoff and
    the error kept, then a normal start."""
    def script(run):
        real = run.launcher.launch
        calls = {"n": 0}

        def flaky(idx):
            calls["n"] += 1
            if calls["n"] == 1:
                raise OSError("exec failed")
            return real(idx)

        run.launcher.launch = flaky
        run.spawn_all()
        assert run.sup.replicas[0].state == t_fleet.DOWN
        assert run.sup.replicas[0].last_error == "launch failed"
        run.clock.tick(1.1)
        run.step()
        run.step()
        assert run.sup.replicas[0].state == t_fleet.READY

    both(tmp_path, script, replicas=1)


# ---------------------------------------------------------------------------
# rolling hot swap
# ---------------------------------------------------------------------------


def test_rolling_swap_recycles_one_replica_at_a_time(tmp_path):
    """A new manifest rolls the fleet one replica at a time: never below
    N−1 ready, both replicas on fresh processes, no crash restart."""
    def script(run):
        run.publish("model-v1")
        run.spawn_all()
        run.step()
        assert run.sup.ready_count() == 2
        run.launcher.version = "v2"
        run.publish("model-v2-longer")        # the signature moves
        min_ready = 2
        for _ in range(20):
            run.clock.tick(0.1)
            run.step()
            min_ready = min(min_ready, run.sup.ready_count())
            if run.sup.swaps == 1:
                break
        assert run.sup.swaps == 1 and run.sup.swap_aborts == 0
        assert min_ready == 1
        assert run.sup.ready_count() == 2
        assert run.launcher.launch_count() == 4
        assert run.sup.status()["restarts"] == 0
        assert all(r.last_restart_s is not None for r in run.sup.replicas)

    out = both(tmp_path, script, telemetry=True, watch_manifest=True)
    assert out["port"][2]["fleet.replica_recycles"] == 2
    assert out["port"][2]["fleet.swaps"] == 1


def test_rolling_swap_waits_for_draining_requests(tmp_path):
    def script(run):
        run.publish("model-v1")
        run.spawn_all()
        run.step()
        r0 = run.sup.acquire_replica()        # an outstanding request
        assert r0.idx == 0
        run.publish("model-v2-longer")
        run.clock.tick(0.1)
        run.step()                            # the swap cordons 0
        assert run.sup.replicas[0].state == t_fleet.DRAINING
        run.clock.tick(0.1)
        run.step()                            # still 1 outstanding
        assert run.sup.replicas[0].state == t_fleet.DRAINING
        assert run.launcher.stub(0).rc is None
        run.sup.release_replica(r0)
        run.clock.tick(0.1)
        run.step()                            # drained → terminated
        assert run.launcher.launches[0][1].replica.rc is not None
        for _ in range(10):
            run.clock.tick(0.1)
            run.step()
            if run.sup.swaps == 1:
                break
        assert run.sup.swaps == 1

    both(tmp_path, script, watch_manifest=True)


def test_rolling_swap_drain_times_out(tmp_path):
    """A request that never finishes does not hold the swap: the drain
    ends at its deadline and the replica is recycled all the same."""
    def script(run):
        run.publish("model-v1")
        run.spawn_all()
        run.step()
        run.sup.acquire_replica()             # never released
        run.publish("model-v2-longer")
        run.clock.tick(0.1)
        run.step()
        assert run.sup.replicas[0].state == t_fleet.DRAINING
        run.clock.tick(t_fleet.DRAIN_TIMEOUT_S + 1.0)
        run.step()                            # deadline: terminated
        assert run.launcher.launches[0][1].replica.rc is not None
        for _ in range(10):
            run.clock.tick(0.1)
            run.step()
            if run.sup.swaps == 1:
                break
        assert run.sup.swaps == 1

    assert t_fleet.DRAIN_TIMEOUT_S == j_fleet.DRAIN_TIMEOUT_S
    assert t_fleet.EXIT_TIMEOUT_S == j_fleet.EXIT_TIMEOUT_S
    both(tmp_path, script, watch_manifest=True)


def _post(port, rows, timeout=10, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/score",
        data=json.dumps({"rows": rows}).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_rolling_swap_aborts_on_corrupt_publish_under_load(tmp_path):
    """The first recycled replica cannot come up on the new manifest: the
    swap aborts, the other replica keeps the previous model, clients see
    no failure, and the aborted signature is not swapped again."""
    def script(run):
        run.publish("model-v1")
        run.spawn_all()
        run.step()
        run.launcher.dead_launches[0] = 99    # replica 0 reborn dead
        run.publish("model-v2-corrupt")
        for _ in range(30):
            run.clock.tick(0.1)
            run.step()
            assert _post(run.fe.port, [3.0])["margins"] == [3.0]
            if run.sup.swap_aborts == 1:
                break
        assert run.sup.swap_aborts == 1
        assert run.sup.last_swap_error is not None
        assert run.sup.replicas[1].state == t_fleet.READY
        assert run.fe.stats()["failed"] == 0
        run.clock.tick(0.5)
        run.step()
        assert run.sup.status()["swap_in_progress"] is False

    out = both(tmp_path, script, telemetry=True, watch_manifest=True,
               frontend=True, restart_backoff_s=0.0,
               restart_backoff_max_s=0.0, breaker_threshold=3)
    assert out["port"][2]["fleet.swap_aborts"] == 1


def test_dead_replica_during_rolling_swap_pauses_then_completes(tmp_path):
    """The other replica dying mid-swap pauses the roll (a cordon would
    leave none ready); the restart revives it and the swap completes."""
    def script(run):
        run.publish("model-v1")
        run.spawn_all()
        run.step()
        run.publish("model-v2-longer")
        run.launcher.stub(1).kill()
        run.clock.tick(0.1)
        run.step()
        assert run.sup.replicas[0].state == t_fleet.READY
        assert run.sup.status()["swap_in_progress"] is True
        run.clock.tick(0.1)
        run.step()
        assert run.sup.replicas[0].state == t_fleet.READY
        run.clock.tick(1.1)
        for _ in range(20):
            run.clock.tick(0.1)
            run.step()
            if run.sup.swaps == 1:
                break
        assert run.sup.swaps == 1
        assert run.sup.ready_count() == 2
        assert run.sup.replicas[1].restarts == 1

    both(tmp_path, script, watch_manifest=True, restart_backoff_s=1.0)


# ---------------------------------------------------------------------------
# frontend: routing, one retry, shedding, the fleet view
# ---------------------------------------------------------------------------


def fronted(tmp_path, scenario, telemetry: bool = False, **kw) -> dict:
    """``scenario(run)`` against each package's frontend (spawned and
    stepped once); the outcomes must be equal.  Returns the port's."""
    outs = {}

    def script(run):
        run.spawn_all()
        run.step()
        return scenario(run)

    for name, (_run, result, counters) in both(
            tmp_path, script, telemetry=telemetry, frontend=True,
            **kw).items():
        outs[name] = (result, counters)
    assert outs["port"] == outs["jax"]
    return outs["port"][0]


def _stats(fe) -> dict:
    st = fe.stats()
    st.pop("uptime_s")
    return st


def _error(port, rows) -> tuple:
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(port, rows)
    e = err.value
    return (e.code, e.headers.get("Retry-After"),
            json.loads(e.read().decode()).get("error"))


def test_frontend_routes_and_balances(tmp_path):
    def scenario(run):
        answers = [_post(run.fe.port, [float(i)])["margins"]
                   for i in range(8)]
        return {"answers": answers, "stats": _stats(run.fe),
                "scored": [run.launcher.stub(i).scored for i in (0, 1)]}

    out = fronted(tmp_path, scenario, telemetry=True)
    assert out["answers"] == [[float(i)] for i in range(8)]
    assert out["scored"] == [4, 4]
    assert out["stats"]["requests"] == 8 and out["stats"]["retries"] == 0


def test_frontend_healthz_follows_fleet(tmp_path):
    def scenario(run):
        url = f"http://127.0.0.1:{run.fe.port}/healthz"
        with urllib.request.urlopen(url, timeout=10) as r:
            before = json.loads(r.read())["state"]
        run.launcher.stub(0).kill()
        run.launcher.stub(1).kill()
        run.step()                            # both dead: 0 ready
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(url, timeout=10)
        return before, err.value.code, json.loads(err.value.read())

    before, code, body = fronted(tmp_path, scenario)
    assert (before, code, body["state"]) == ("ready", 503, "warming")


def test_frontend_retries_exactly_once_on_dead_replica(tmp_path):
    """A connection failure retries once on another replica: one answer,
    one retry counted, the failure fed back to the supervisor."""
    def scenario(run):
        run.launcher.stub(0).kill()           # the supervisor not told
        out = _post(run.fe.port, [7.0])
        return {"margins": out["margins"], "stats": _stats(run.fe),
                "probe_failures": run.sup.replicas[0].probe_failures}

    out = fronted(tmp_path, scenario, telemetry=True)
    assert out["margins"] == [7.0]
    assert out["stats"] == {"requests": 1, "retries": 1, "failed": 0,
                            "shed": 0}
    assert out["probe_failures"] >= 1


def test_frontend_sheds_503_with_retry_after_when_fleet_down(tmp_path):
    def scenario(run):
        run.launcher.stub(0).kill()
        run.launcher.stub(1).kill()
        run.step()
        return _error(run.fe.port, [1.0]), _stats(run.fe)

    (code, retry_after, error), stats = fronted(tmp_path, scenario,
                                                telemetry=True)
    assert (code, retry_after) == (503, "1")
    assert "no ready replica" in error
    assert stats["shed"] == 1


def test_frontend_retry_exhausted_is_502_not_hang(tmp_path):
    """Both sockets dead, the supervisor not told: the attempt and its
    one retry fail, and the client gets an answered 502."""
    def scenario(run):
        run.launcher.stub(0).kill()
        run.launcher.stub(1).kill()
        code, _ra, error = _error(run.fe.port, [1.0])
        return code, error.split(":")[0], _stats(run.fe)

    code, error, stats = fronted(tmp_path, scenario, telemetry=True)
    assert code == 502
    assert error == "replica connection failed after 2 attempt(s)"
    assert stats == {"requests": 0, "retries": 1, "failed": 1, "shed": 0}


def test_frontend_forwards_replica_sheds_verbatim(tmp_path):
    """A replica's 503 is its verdict: forwarded with its Retry-After,
    counted as a shed, never retried."""
    def scenario(run):
        def shedding(body):
            raise HttpError(503, headers={"Retry-After": "9"},
                            error="estimated queue wait exceeds deadline")

        run.launcher.stub(0)._ep.routes[("POST", "/v1/score")] = shedding
        return _error(run.fe.port, [1.0]), _stats(run.fe)

    (code, retry_after, error), stats = fronted(
        tmp_path, scenario, telemetry=True, replicas=1)
    assert (code, retry_after) == (503, "9")
    assert error == "estimated queue wait exceeds deadline"
    assert stats["shed"] == 1 and stats["retries"] == 0


def test_frontend_status_and_metrics_aggregate_fleet_view(tmp_path):
    def scenario(run):
        _post(run.fe.port, [1.0])
        base = f"http://127.0.0.1:{run.fe.port}"
        with urllib.request.urlopen(base + "/status", timeout=10) as r:
            st = json.loads(r.read())
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            text = r.read().decode()
        st["frontend"].pop("uptime_s")
        for rep in st["fleet"]["replicas"]:
            rep.pop("url")
        fleet_lines = [ln for ln in text.splitlines()
                       if "fleet" in ln or "frontend" in ln]
        return st, fleet_lines

    st, lines = fronted(tmp_path, scenario)
    assert st["state"] == "ready" and st["fleet"]["ready"] == 2
    assert len(st["fleet"]["replicas"]) == 2
    assert st["frontend"]["requests"] == 1
    assert "photon_fleet_ready_replicas 2" in lines
    assert "photon_frontend_requests_total 1" in lines


def test_frontend_propagates_the_trace_one_hop(tmp_path):
    """With a frontend recorder: the replica sees the client's request id
    one hop deeper, and the kept frontend trace holds route and forward
    (and retry after a dead replica) with its attempts."""
    def scenario(run):
        rec = run.pkg.tracing.start(role="frontend", threshold_s=0.0,
                                    sample_every=1)
        try:
            run.launcher.stub(0).kill()
            _post(run.fe.port, [2.0],
                  headers={"X-Photon-Request-Id": "req-7"})
            deadline = time.monotonic() + 10.0
            while rec.snapshot()["requests"] < 1:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            kept = rec.retained()
            return {"seen": run.launcher.stub(1).seen,
                    "role": rec.snapshot()["role"],
                    "stages": sorted(kept[0].stages),
                    "outcomes": [a["outcome"] for a in kept[0].attempts]}
        finally:
            rec.close()

    out = fronted(tmp_path, scenario)
    assert out["seen"] == [("req-7", 1)]
    assert out["role"] == "frontend"
    assert out["stages"] == ["forward", "retry", "route", "write"]
    assert out["outcomes"][-1] == 200


# ---------------------------------------------------------------------------
# the port alone: no CUDA in the fleet process, a real replica, the e2e
# ---------------------------------------------------------------------------


_CUDA_CALLS = ("_lazy_init", "init", "is_available", "device_count",
               "current_device", "memory_stats", "current_stream", "Event",
               "synchronize", "get_device_name", "set_sync_debug_mode")


def test_fleet_process_makes_no_cuda_call(tmp_path, monkeypatch):
    """A CUDA fleet's supervisor and frontend, with telemetry, monitor and
    tracing on, serve, report and stop without one ``torch.cuda`` call:
    that process holds no CUDA context."""
    calls = []
    for name in _CUDA_CALLS:
        monkeypatch.setattr(torch.cuda, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    cfg = _cfg(ServingConfig, tmp_path / "mdl", telemetry="metrics",
               monitor="on", trace="on", monitor_every_s=0.05,
               trace_sample_every=1, device="cuda")
    launcher = StubLauncher()
    log_path = str(tmp_path / "fleet.jsonl")
    log = RunLogger(log_path, run_info={"driver": "serving"})
    server = t_fleet.FleetServer(cfg, run_logger=log, launcher=launcher,
                                 workdir=str(tmp_path / "fleet"))
    try:
        server.start()
        assert server.supervisor.wait_ready(2, timeout_s=20.0)
        for i in range(6):
            assert _post(server.port, [float(i)])["margins"] == [float(i)]
        base = f"http://127.0.0.1:{server.port}"
        for route in ("/status", "/metrics"):
            with urllib.request.urlopen(base + route, timeout=10) as r:
                assert r.status == 200
        time.sleep(0.2)                     # a monitor tick or more
    finally:
        server.stop()
        launcher.close()
        log.close()
    assert calls == []
    kinds = {e["event"] for e in read_run_log(log_path)}
    assert {"fleet_started", "fleet_replica_spawned",
            "fleet_replica_ready", "fleet_stopped"} <= kinds


def test_replica_config_keeps_the_device_and_clears_the_fleet(tmp_path):
    cfg = ServingConfig(model_dir="m", replicas=3, port=8123,
                        hot_swap_poll_s=2.0, device="cpu",
                        batch_rows=16)
    launcher = t_fleet.SubprocessReplicaLauncher(cfg, str(tmp_path))
    rc = load_serving_config(launcher._replica_config_path(1))
    assert (rc.replicas, rc.port, rc.hot_swap_poll_s, rc.device,
            rc.batch_rows) == (1, 0, 0.0, "cpu", 16)
    assert rc.log_path == str(tmp_path / "replica_1.jsonl")


def _jax_server_scores(mdir, tmp_path, rows):
    from photon_ml_tpu.serving.server import ModelServer as JServer

    srv = JServer(_jserve_cfg(mdir, tmp_path, telemetry="off",
                              monitor="off", trace="off")).start()
    try:
        return _post(srv.port, rows, timeout=60)["margins"]
    finally:
        srv.stop()


def test_real_replica_answers_like_the_jax_server(tmp_path, monkeypatch):
    """One real port replica (``SubprocessReplicaLauncher``,
    ``device="cpu"``) under the supervisor: ready within 60 s, its answer
    within 1e-5 of the JAX server's, terminated on stop."""
    jm = _jax_model()
    mdir = str(tmp_path / "model")
    jio.save_game_model(jm, JTask.LOGISTIC_REGRESSION, mdir)
    rows = _requests(jm, n=6)
    monkeypatch.chdir(REPO)
    monkeypatch.setenv("PYTHONPATH", REPO)
    cfg = ServingConfig(
        model_dir=mdir, port=0, replicas=1, batch_rows=8,
        batch_deadline_ms=1.0, ell_row_capacity=K,
        spill_dir=str(tmp_path / "spill"), entity_chunk=4,
        probe_every_s=0.1, device="cpu")
    workdir = str(tmp_path / "fleet")
    sup = t_fleet.FleetSupervisor(
        cfg, launcher=t_fleet.SubprocessReplicaLauncher(cfg, workdir),
        workdir=workdir, watch_manifest=False)
    try:
        sup.start()
        ready = sup.wait_ready(1, timeout_s=60.0)
        if not ready:
            with open(os.path.join(workdir, "replica_0.err")) as f:
                pytest.fail(f"replica not ready: {sup.status()}\n{f.read()}")
        rep = sup.status()["replicas"][0]
        assert rep["pid"] != os.getpid()
        got = _post(int(rep["url"].rsplit(":", 1)[1]), rows)["margins"]
    finally:
        sup.stop()
    handle = sup.replicas[0].handle
    assert handle.poll() is not None
    want = _jax_server_scores(mdir, tmp_path, rows)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.slow   # two replica subprocesses, a kill and a restart
def test_fleet_sigkill_e2e_zero_client_failures(tmp_path, monkeypatch):
    """SIGKILL one of two real replicas under client traffic: no client
    request fails (the one retry), the replica is restarted and back in
    rotation, and the fleet reports the restart."""
    jm = _jax_model()
    mdir = str(tmp_path / "model")
    jio.save_game_model(jm, JTask.LOGISTIC_REGRESSION, mdir)
    reqs = _requests(jm, n=8)
    monkeypatch.chdir(REPO)
    monkeypatch.setenv("PYTHONPATH", REPO)
    cfg = ServingConfig(
        model_dir=mdir, port=0, replicas=2, batch_rows=8,
        batch_deadline_ms=1.0, ell_row_capacity=K,
        spill_dir=str(tmp_path / "spill"), entity_chunk=4,
        probe_every_s=0.2, probe_timeout_s=2.0, restart_backoff_s=0.2,
        telemetry="off", monitor="off", device="cpu")
    server = t_fleet.FleetServer(cfg, workdir=str(tmp_path / "fleet"))
    try:
        server.start()
        assert server.supervisor.wait_ready(2, timeout_s=240.0), \
            server.supervisor.status()
        stop = threading.Event()
        errors: list = []
        ok = [0]
        lock = threading.Lock()

        def hammer():
            while not stop.is_set():
                try:
                    out = _post(server.port, reqs, timeout=30)
                    assert len(out["margins"]) == 8
                    with lock:
                        ok[0] += 1
                except Exception as e:   # noqa: BLE001 - collected
                    with lock:
                        errors.append(f"{type(e).__name__}: {e}")

        threads = [threading.Thread(target=hammer) for _ in range(4)]
        for th in threads:
            th.start()
        time.sleep(1.0)
        victim = next(r for r in server.supervisor.status()["replicas"]
                      if r["state"] == "ready" and r["pid"])
        os.kill(victim["pid"], signal.SIGKILL)
        deadline = time.time() + 180.0
        while time.time() < deadline:
            st = server.supervisor.status()
            if st["restarts"] >= 1 and st["ready"] == 2:
                break
            time.sleep(0.3)
        time.sleep(1.0)
        stop.set()
        for th in threads:
            th.join(timeout=60)
        st = server.supervisor.status()
        assert not errors, errors[:5]
        assert ok[0] > 50
        assert st["restarts"] >= 1 and st["ready"] == 2
        assert st["last_restart_s"] is not None and st["last_restart_s"] > 0
        assert len(_post(server.port, reqs, timeout=30)["margins"]) == 8
        assert server.frontend.stats()["failed"] == 0
    finally:
        server.stop()
