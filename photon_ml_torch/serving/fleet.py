"""Supervised replica fleet.

Counterpart of ``photon_ml_tpu/serving/fleet.py``.  One ``ModelServer``
process is one point of failure: a wedged handler, a corrupt map or an
out-of-memory kill takes the scoring path down.  The fleet runs
``config.replicas`` replica ``ModelServer`` subprocesses behind one
health-routed frontend (``serving.frontend``):

- **Spawn**: ``FleetSupervisor`` launches each replica
  (``python -m photon_ml_torch.serving``) on an ephemeral port, found
  through the ``--info-file`` contract.  A replica runs with its own
  hot-swap watcher off: the supervisor owns the swap (below).
- **Probe**: each replica's ``/healthz`` is polled every
  ``probe_every_s`` (the ``serve.replica_healthz`` fault seam).  A
  process that exited, or a live one failing ``unhealthy_after``
  consecutive probes (wedged), is killed and restarted.
- **Restart policy**: exponential backoff per replica
  (``restart_backoff_s`` doubling up to ``restart_backoff_max_s``) and
  a circuit breaker: ``breaker_threshold`` restarts inside
  ``breaker_window_s`` open it for ``breaker_reset_s`` (state
  ``broken``, no restarts), then one half-open attempt closes it
  (ready) or opens it again.
- **Rolling hot swap**: a newly published manifest recycles the
  replicas one at a time (cordon, drain, SIGTERM, respawn, wait ready),
  and a recycle starts only when every other replica is ready, so the
  fleet never has fewer than N−1 ready.  A replica that cannot come up
  on the new manifest aborts the swap; the others keep the previous
  model.

On the card every replica is a CUDA process of its own, each with its
own engine and kernel launches; the supervisor and the frontend only
route HTTP, place no tensor and hold no CUDA context (their telemetry
session is told the CPU, so it samples the host's memory, never
``torch.cuda``).

Observable through the existing tiers: ``fleet.*`` counters and gauges
(``fleet.replica_restarts`` feeds the monitor's ``replica_restarts``
rule), ``fleet_*`` run-log events, and the fleet view of the frontend's
``/status``.  The ``launcher=``, ``clock=`` and ``watch_manifest=``
seams let the tests drive ``_step()`` against in-process stub replicas
on a fake clock.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

from photon_ml_torch import telemetry
from photon_ml_torch.config import ServingConfig, config_to_json
from photon_ml_torch.reliability import faults
from photon_ml_torch.serving import tracing as _tracing
from photon_ml_torch.serving.server import _manifest_signature

logger = logging.getLogger(__name__)

# Replica states (the frontend routes to READY replicas only).
STARTING = "starting"     # spawned, warming (or info file pending)
READY = "ready"           # probed healthy; in rotation
DRAINING = "draining"     # cordoned for a rolling swap
DOWN = "down"             # dead or wedged; restart scheduled (backoff)
BROKEN = "broken"         # circuit breaker open; no restarts

# Rolling-swap drain and exit budgets (seconds on the supervisor clock).
DRAIN_TIMEOUT_S = 30.0
EXIT_TIMEOUT_S = 10.0


class Replica:
    """One replica's supervised record.  Every mutable field is guarded
    by the supervisor's lock; the control thread is the only writer of
    state, the frontend only moves ``outstanding`` and ``served``."""

    def __init__(self, idx: int):
        self.idx = idx
        self.handle: "ReplicaHandle | None" = None
        self.state = DOWN
        self.url: str | None = None
        self.outstanding = 0          # in-flight frontend requests
        self.served = 0               # requests routed here
        self.restarts = 0             # restarts after a failure
        self.probe_failures = 0       # consecutive
        self.restart_times: list[float] = []   # the breaker's window
        self.backoff_s = 0.0          # next restart delay
        self.restart_at: float | None = None   # scheduled restart time
        self.breaker_open_until: float | None = None
        self.half_open = False
        self.recycling = False        # down for a rolling swap, not a crash
        self.down_since: float | None = None
        self.spawned_at: float | None = None
        self.last_restart_s: float | None = None
        self.last_error: str | None = None

    def snapshot(self) -> dict:
        return {
            "idx": self.idx,
            "state": self.state,
            "url": self.url,
            "pid": self.handle.pid() if self.handle else None,
            "outstanding": self.outstanding,
            "served": self.served,
            "restarts": self.restarts,
            "probe_failures": self.probe_failures,
            "last_restart_s": self.last_restart_s,
            **({"last_error": self.last_error}
               if self.last_error else {}),
        }


class ReplicaHandle:
    """What the supervisor needs of a replica process.
    ``SubprocessReplicaHandle`` is the real one; the tests stub it with
    in-process endpoints."""

    def poll(self) -> int | None:          # None: alive
        raise NotImplementedError

    def url(self) -> str | None:           # None until discovered
        raise NotImplementedError

    def pid(self) -> int | None:
        return None

    def terminate(self) -> None:           # graceful (SIGTERM)
        raise NotImplementedError

    def kill(self) -> None:                # hard (SIGKILL)
        raise NotImplementedError

    def wait(self, timeout_s: float) -> int | None:
        raise NotImplementedError


class SubprocessReplicaHandle(ReplicaHandle):
    def __init__(self, proc: subprocess.Popen, info_path: str):
        self._proc = proc
        self._info_path = info_path
        self._url: str | None = None

    def poll(self) -> int | None:
        return self._proc.poll()

    def url(self) -> str | None:
        if self._url is None:
            try:
                with open(self._info_path) as f:
                    self._url = json.load(f)["url"]
            except (OSError, ValueError, KeyError):  # photon-lint: disable=swallowed-exception (the info file simply has not been written yet; the caller treats None as still-starting)
                return None
        return self._url

    def pid(self) -> int | None:
        return self._proc.pid

    def terminate(self) -> None:
        if self._proc.poll() is None:
            self._proc.terminate()

    def kill(self) -> None:
        if self._proc.poll() is None:
            self._proc.kill()

    def wait(self, timeout_s: float) -> int | None:
        try:
            return self._proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:  # photon-lint: disable=swallowed-exception (the timeout IS the result: None tells the caller the process is still alive and escalation — SIGKILL — is its decision)
            return None


class SubprocessReplicaLauncher:
    """Launches real replica processes: a single-replica config each
    (ephemeral port, no own swap watcher, its own run log), stdout and
    stderr to files under the fleet workdir, the port found through
    ``--info-file``.

    The replica keeps the fleet's ``device``: a replica of a CUDA fleet
    resolves CUDA and raises without it (a failed start for the restart
    policy), never falling back to the CPU.  The child inherits this
    process's environment unchanged (``CUDA_VISIBLE_DEVICES`` included).
    The reference pins ``JAX_PLATFORMS`` here so that a replica does not
    probe every jax plugin at start-up; the port imports no jax, so
    there is nothing to pin."""

    def __init__(self, config: ServingConfig, workdir: str):
        self.config = config
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)

    def _replica_config_path(self, idx: int) -> str:
        cfg = dataclasses.replace(
            self.config, replicas=1, port=0, hot_swap_poll_s=0.0,
            log_path=os.path.join(self.workdir, f"replica_{idx}.jsonl"))
        path = os.path.join(self.workdir, f"replica_{idx}.json")
        with open(path, "w") as f:
            f.write(config_to_json(cfg))
        return path

    def launch(self, idx: int) -> ReplicaHandle:
        cfg_path = self._replica_config_path(idx)
        info_path = os.path.join(self.workdir, f"replica_{idx}.info")
        # A stale info file of the previous incarnation would hand the
        # supervisor a dead port.
        if os.path.exists(info_path):
            os.remove(info_path)
        out = open(os.path.join(self.workdir, f"replica_{idx}.out"), "ab")
        err = open(os.path.join(self.workdir, f"replica_{idx}.err"), "ab")
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", "photon_ml_torch.serving",
                 "--config", cfg_path, "--info-file", info_path],
                stdout=out, stderr=err)
        finally:
            out.close()
            err.close()
        logger.info("fleet: launched replica %d (pid %d)", idx, proc.pid)
        return SubprocessReplicaHandle(proc, info_path)


class FleetSupervisor:
    """The control loop: spawn, probe, restart, breaker, rolling swap.

    The thread ``start()`` opens calls ``_step()`` every
    ``probe_every_s``; tests call ``_step()`` directly with a fake clock
    and a stub launcher.  One lock guards every replica record; network
    probes run outside it.
    """

    def __init__(self, config: ServingConfig, launcher=None,
                 run_logger=None, workdir: str | None = None,
                 clock=time.monotonic, watch_manifest: bool = True):
        config.validate()
        self.config = config
        self.workdir = workdir or tempfile.mkdtemp(prefix="photon-fleet-")
        self.launcher = launcher if launcher is not None else \
            SubprocessReplicaLauncher(config, self.workdir)
        self._log = run_logger
        self._clock = clock
        self._lock = threading.Lock()
        self.replicas = [Replica(i) for i in range(config.replicas)]
        self._watch_manifest = watch_manifest
        self._last_sig: tuple | None = None
        self._pending_sig: tuple | None = None
        self._swap: dict | None = None
        self.swaps = 0
        self.swap_aborts = 0
        self.last_swap_error: str | None = None
        self._frontend = None
        self._stop_evt = threading.Event()
        self._stopped = False
        self._thread: threading.Thread | None = None

    # -- wiring --------------------------------------------------------------

    def attach_frontend(self, frontend) -> None:
        """The frontend's readiness follows the fleet's ready count
        (updated at the end of every step)."""
        with self._lock:
            self._frontend = frontend

    def _event(self, kind: str, **fields) -> None:
        if self._log is not None:
            self._log.event(kind, **fields)

    # -- lifecycle -----------------------------------------------------------

    def spawn_all(self) -> None:
        if self._watch_manifest:
            sig = _manifest_signature(self.config.model_dir)
            with self._lock:
                self._last_sig = sig
        now = self._clock()
        for r in self.replicas:
            self._spawn(r, now)

    def start(self) -> "FleetSupervisor":
        self.spawn_all()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="photon-fleet-supervisor")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop_evt.wait(self.config.probe_every_s):
            try:
                self._step()
            except Exception as e:
                # The control loop outlives its own bugs: a failed step
                # is logged and the next tick tries again.
                telemetry.count("fleet.supervisor_errors")
                logger.exception("fleet supervisor step failed: %r", e)

    def stop(self) -> None:
        """Terminate every replica (SIGTERM, grace, SIGKILL) and stop
        the control loop.  Idempotent."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        with self._lock:
            handles = [r.handle for r in self.replicas
                       if r.handle is not None]
            for r in self.replicas:
                r.state = DOWN
        for h in handles:
            h.terminate()
        deadline = time.monotonic() + 15.0
        for h in handles:
            if h.wait(max(0.1, deadline - time.monotonic())) is None:
                h.kill()
                h.wait(5.0)
        self._event("fleet_stopped",
                    restarts=sum(r.restarts for r in self.replicas),
                    swaps=self.swaps)

    # -- spawn and restart policy --------------------------------------------

    def _spawn(self, r: Replica, now: float) -> None:
        try:
            handle = self.launcher.launch(r.idx)
        except Exception as e:
            # A failed exec is a failed start: the next attempt goes
            # through the same backoff and breaker.
            with self._lock:
                r.last_error = f"launch failed: {type(e).__name__}: {e}"
            logger.warning("fleet: replica %d launch failed (%r)", r.idx, e)
            self._schedule_restart(r, now, reason="launch failed")
            return
        with self._lock:
            r.handle = handle
            r.state = STARTING
            r.url = None
            r.probe_failures = 0
            r.spawned_at = now
            r.restart_at = None
        self._event("fleet_replica_spawned", replica=r.idx,
                    pid=handle.pid())

    def _schedule_restart(self, r: Replica, now: float, reason: str) -> None:
        """A replica failed (exit, wedge, failed start): kill what is
        left, open the breaker if it is flapping, else schedule the
        restart after the current backoff."""
        if r.handle is not None:
            r.handle.kill()
        with self._lock:
            r.state = DOWN
            r.url = None
            if r.down_since is None:
                r.down_since = now
            r.last_error = reason
            window = self.config.breaker_window_s
            r.restart_times = [t for t in r.restart_times
                               if now - t <= window]
            r.restart_times.append(now)
            flapping = len(r.restart_times) >= self.config.breaker_threshold
            if r.half_open or flapping:
                # A failed half-open attempt re-opens; a flapping
                # replica opens: no restarts until the reset passes.
                r.state = BROKEN
                r.breaker_open_until = now + self.config.breaker_reset_s
                r.half_open = False
                r.restart_at = None
                opened = True
            else:
                r.backoff_s = min(
                    max(self.config.restart_backoff_s, r.backoff_s * 2),
                    self.config.restart_backoff_max_s)
                r.restart_at = now + r.backoff_s
                opened = False
        telemetry.count("fleet.replica_failures")
        if opened:
            telemetry.count("fleet.breaker_opened")
            self._event("fleet_breaker_opened", replica=r.idx,
                        reason=reason, reset_s=self.config.breaker_reset_s)
            logger.warning("fleet: replica %d circuit breaker OPEN (%s); "
                           "no restarts for %.1fs", r.idx, reason,
                           self.config.breaker_reset_s)
        else:
            self._event("fleet_replica_down", replica=r.idx, reason=reason,
                        restart_in_s=round(r.backoff_s, 3))
            logger.warning("fleet: replica %d down (%s); restart in %.2fs",
                           r.idx, reason, r.backoff_s)

    def _mark_ready(self, r: Replica, now: float) -> None:
        with self._lock:
            was_down = r.down_since is not None
            recycled = r.recycling
            restart_s = (now - r.down_since) if was_down else None
            r.state = READY
            r.probe_failures = 0
            r.backoff_s = 0.0
            r.down_since = None
            r.recycling = False
            r.last_error = None
            closed = r.half_open
            if closed:
                r.half_open = False
                r.restart_times = []
            if was_down:
                # A rolling-swap recycle is a deliberate bounce: its
                # latency is kept, but it is no crash restart (the
                # replica_restarts alert must not fire on a deploy).
                if not recycled:
                    r.restarts += 1
                r.last_restart_s = round(restart_s, 3)
        if closed:
            self._event("fleet_breaker_closed", replica=r.idx)
            logger.info("fleet: replica %d circuit breaker closed", r.idx)
        if was_down:
            telemetry.count("fleet.replica_recycles" if recycled
                            else "fleet.replica_restarts")
            telemetry.observe("fleet.restart_s", restart_s)
            self._event("fleet_replica_ready", replica=r.idx,
                        restart_s=round(restart_s, 3), recycled=recycled)
            logger.info("fleet: replica %d %s and ready in %.2fs", r.idx,
                        "recycled" if recycled else "restarted", restart_s)
        else:
            self._event("fleet_replica_ready", replica=r.idx)

    # -- probing -------------------------------------------------------------

    def _probe(self, r: Replica) -> str:
        """One ``/healthz`` probe → "ready" | "warming" | "error" (the
        ``serve.replica_healthz`` fault seam fires once a probe)."""
        url = r.url
        if url is None:
            return "warming"      # info file not found yet
        try:
            faults.fire("serve.replica_healthz", replica=r.idx)
            with urllib.request.urlopen(
                    url + "/healthz",
                    timeout=self.config.probe_timeout_s) as resp:
                state = json.loads(resp.read()).get("state")
                return "ready" if state == "ready" else "warming"
        except urllib.error.HTTPError as e:
            try:
                state = json.loads(e.read()).get("state")
            except Exception:
                state = None      # a non-JSON 5xx: an unhealthy probe
            return "warming" if state == "warming" else "error"
        except Exception:  # photon-lint: disable=swallowed-exception (any transport failure IS the probe result; the caller counts consecutive failures toward the wedge threshold)
            return "error"

    def note_failure(self, idx: int) -> None:
        """Frontend feedback: a connection-level failure against a
        replica counts as a failed probe, so a wedge is seen at request
        rate, not only at probe cadence."""
        r = self.replicas[idx]
        with self._lock:
            r.probe_failures += 1

    # -- the control step ----------------------------------------------------

    def _step(self) -> None:
        now = self._clock()
        self._step_swap_detect()
        with self._lock:
            swap = self._swap
            frontend = self._frontend
        swap_active, swap_phase = None, None
        if swap is not None:
            # Only this (control) thread mutates the swap dict; the lock
            # above guards the hand-off of the reference.
            swap_active = swap.get("active")
            swap_phase = swap.get("phase")
        for r in self.replicas:
            if r.idx == swap_active and swap_phase in ("drain", "exit"):
                continue   # the swap owns this replica
            self._step_replica(r, now)
        self._step_swap(now)
        ready = self.ready_count()
        telemetry.gauge("fleet.ready_replicas", ready)
        if frontend is not None:
            frontend.update_readiness(ready)

    def _step_replica(self, r: Replica, now: float) -> None:
        with self._lock:
            state = r.state
            handle = r.handle
        if state == BROKEN:
            if now >= (r.breaker_open_until or 0.0):
                with self._lock:
                    r.half_open = True
                self._event("fleet_breaker_half_open", replica=r.idx)
                self._spawn(r, now)
            return
        if state == DOWN:
            if r.restart_at is not None and now >= r.restart_at:
                self._spawn(r, now)
            return
        if handle is None:
            return
        rc = handle.poll()
        if rc is not None:
            self._schedule_restart(r, now, reason=f"exited rc={rc}")
            return
        if r.url is None:
            url = handle.url()
            if url is not None:
                with self._lock:
                    r.url = url
        result = self._probe(r)
        if result == "ready":
            if state in (STARTING, READY):
                if state == STARTING or r.down_since is not None:
                    self._mark_ready(r, now)
                else:
                    with self._lock:
                        r.probe_failures = 0
            return
        if state == STARTING:
            # Warming, or failing while warming: only the ready timeout
            # kills a starting replica (a cold start can be slow).
            if (r.spawned_at is not None
                    and now - r.spawned_at
                    > self.config.replica_ready_timeout_s):
                self._schedule_restart(
                    r, now, reason="never became ready "
                    f"(> {self.config.replica_ready_timeout_s:g}s)")
            return
        if state == READY:
            # Any answer but ready from a replica in rotation (transport
            # error, 5xx, a "warming" regression) counts toward a wedge.
            with self._lock:
                r.probe_failures += 1
                failures = r.probe_failures
            if failures >= self.config.unhealthy_after:
                telemetry.count("fleet.replica_wedged")
                self._event("fleet_replica_wedged", replica=r.idx,
                            probe_failures=failures)
                self._schedule_restart(
                    r, now, reason=f"wedged ({failures} consecutive "
                    "failed probes)")

    # -- rolling swap --------------------------------------------------------

    def _step_swap_detect(self) -> None:
        with self._lock:
            watching = self._watch_manifest and self._swap is None
            last = self._last_sig
        if not watching:
            return
        sig = _manifest_signature(self.config.model_dir)
        if sig is None or sig == last:
            return
        with self._lock:
            self._pending_sig = sig
            self._swap = {"queue": [r.idx for r in self.replicas],
                          "active": None, "phase": None}
        self._event("fleet_swap_started", signature=list(sig))
        logger.info("fleet: new manifest detected; rolling swap over %d "
                    "replica(s)", len(self.replicas))

    def _swap_abort(self, reason: str) -> None:
        with self._lock:
            self.swap_aborts += 1
            self.last_swap_error = reason
            for r in self.replicas:
                # What happens to the failed replica from here on is a
                # crash restart, not a deploy bounce.
                r.recycling = False
            # Adopt the signature anyway, so a corrupt publish does not
            # start the same doomed swap every step: the next publish
            # swaps normally.
            self._last_sig = self._pending_sig
            self._swap = None
        telemetry.count("fleet.swap_aborts")
        self._event("fleet_swap_aborted", reason=reason)
        logger.warning("fleet: rolling swap ABORTED (%s); the other "
                       "replicas keep the previous model", reason)

    def _step_swap(self, now: float) -> None:
        with self._lock:
            s = self._swap
        if s is None:
            return
        if s["active"] is None:
            if not s["queue"]:
                with self._lock:
                    self._last_sig = self._pending_sig
                    self._swap = None
                    self.swaps += 1
                telemetry.count("fleet.swaps")
                self._event("fleet_swap_done")
                logger.info("fleet: rolling swap complete")
                return
            nxt = self.replicas[s["queue"][0]]
            with self._lock:
                others_ready = all(x.state == READY for x in self.replicas
                                   if x.idx != nxt.idx)
                if others_ready:
                    # Cordon: the frontend stops routing here; the fleet
                    # keeps N−1 ready through the recycle.
                    s["queue"].pop(0)
                    s["active"] = nxt.idx
                    s["phase"] = "drain"
                    s["deadline"] = now + DRAIN_TIMEOUT_S
                    nxt.state = DRAINING
            if s["active"] is not None:
                self._event("fleet_swap_recycling", replica=s["active"])
            return
        r = self.replicas[s["active"]]
        if s["phase"] == "drain":
            with self._lock:
                drained = r.outstanding == 0
            if drained or now > s["deadline"]:
                if r.handle is not None:
                    r.handle.terminate()
                s["phase"] = "exit"
                s["deadline"] = now + EXIT_TIMEOUT_S
            return
        if s["phase"] == "exit":
            if r.handle is None or r.handle.poll() is not None:
                with self._lock:
                    r.down_since = now     # restart latency = the recycle
                    r.recycling = True
                self._spawn(r, now)
                s["phase"] = "warm"
                s["deadline"] = now + self.config.replica_ready_timeout_s
            elif now > s["deadline"]:
                r.handle.kill()
            return
        if s["phase"] == "warm":
            # The probe and restart machinery owns the replica here; the
            # swap only watches the outcome.
            with self._lock:
                state = r.state
            if state == READY:
                s["active"] = None
                s["phase"] = None
                return
            if state == BROKEN or now > s["deadline"]:
                self._swap_abort(
                    f"replica {r.idx} failed to come up on the new "
                    f"manifest (state {state})")

    # -- frontend-facing reads ------------------------------------------------

    def ready_count(self) -> int:
        with self._lock:
            return sum(1 for r in self.replicas if r.state == READY)

    def acquire_replica(self, exclude: set[int] = frozenset()
                        ) -> Replica | None:
        """The ready replica (outside ``exclude``) with the fewest
        outstanding requests, its count raised; ``release_replica`` it
        when done."""
        with self._lock:
            ready = [r for r in self.replicas
                     if r.state == READY and r.idx not in exclude
                     and r.url is not None]
            if not ready:
                return None
            # Ties go to the fewest served: under sequential load (all
            # at 0 outstanding) requests still spread.
            r = min(ready, key=lambda x: (x.outstanding, x.served, x.idx))
            r.outstanding += 1
            r.served += 1
            return r

    def release_replica(self, r: Replica) -> None:
        with self._lock:
            r.outstanding = max(0, r.outstanding - 1)

    def wait_ready(self, count: int | None = None,
                   timeout_s: float = 300.0) -> bool:
        """Block (wall clock) until ``count`` replicas are ready (default:
        the whole fleet).  Driven by the control thread, so only
        meaningful after ``start()``."""
        want = count if count is not None else len(self.replicas)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.ready_count() >= want:
                return True
            time.sleep(0.05)
        return False

    def status(self) -> dict:
        with self._lock:
            replicas = [r.snapshot() for r in self.replicas]
            swaps, aborts = self.swaps, self.swap_aborts
            swapping = self._swap is not None
            swap_err = self.last_swap_error
        last_restart = max((r["last_restart_s"] for r in replicas
                            if r["last_restart_s"] is not None),
                           default=None)
        return {
            "replicas": replicas,
            "ready": sum(1 for r in replicas if r["state"] == READY),
            "size": len(replicas),
            "restarts": sum(r["restarts"] for r in replicas),
            "last_restart_s": last_restart,
            "swaps": swaps,
            "swap_aborts": aborts,
            "swap_in_progress": swapping,
            **({"last_swap_error": swap_err} if swap_err else {}),
        }


class FleetServer:
    """The CLI's fleet: supervisor, frontend and the telemetry, monitor
    and trace sessions, with ``ModelServer``'s lifecycle (``start()``,
    ``serve_forever()``, ``stop()``), so ``__main__`` runs
    ``replicas > 1`` in its place.  This process holds no CUDA context:
    its telemetry session is on the CPU device."""

    def __init__(self, config: ServingConfig, run_logger=None,
                 launcher=None, workdir: str | None = None):
        from photon_ml_torch.serving.frontend import FleetFrontend

        config.validate()
        self.config = config
        self._log = run_logger
        self._monitor = None
        self._telemetry = None
        self._tracer = None
        self._stop_evt = threading.Event()
        self._stop_lock = threading.Lock()
        self._stopped = False
        self.supervisor = FleetSupervisor(
            config, launcher=launcher, run_logger=run_logger,
            workdir=workdir)
        # Bind first, as ModelServer does: a probe gets an honest 503
        # "warming" from the frontend while the replicas come up.
        self.frontend = FleetFrontend(config, self.supervisor,
                                      run_logger=run_logger)
        self.frontend.start()
        self.port = self.frontend.port

    def start(self) -> "FleetServer":
        from photon_ml_torch.telemetry import monitor as _mon

        cfg = self.config
        if cfg.telemetry != "off" and telemetry.active() is None:
            self._telemetry = telemetry.start(
                cfg.telemetry, run_logger=self._log, device="cpu")
        if cfg.monitor == "on" and _mon.active() is None:
            self._monitor = _mon.start(
                run_logger=self._log, every_s=cfg.monitor_every_s)
        if cfg.trace == "on" and _tracing.active() is None:
            # The frontend's records (route, forward, retry) join the
            # replicas' by trace id in serve-report.
            self._tracer = _tracing.start(
                role="frontend",
                threshold_s=cfg.trace_threshold_ms / 1e3,
                sample_every=cfg.trace_sample_every,
                cap=cfg.trace_buffer, run_logger=self._log)
        self.supervisor.start()
        if self._log is not None:
            self._log.event("fleet_started", port=self.port,
                            replicas=cfg.replicas)
        logger.info("fleet frontend bound on http://%s:%d (%d replicas "
                    "warming)", cfg.host, self.port, cfg.replicas)
        return self

    def serve_forever(self) -> None:
        self._stop_evt.wait()

    def stop(self) -> None:
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
        self._stop_evt.set()
        self.supervisor.stop()
        self.frontend.close()
        for session in (self._tracer, self._monitor, self._telemetry):
            if session is not None:
                session.close()

    def serving_status(self) -> dict:
        return {
            "state": self.frontend.readiness.state,
            "frontend": self.frontend.stats(),
            "fleet": self.supervisor.status(),
        }
