"""Deterministic fault injection at the streaming tier's seams.

Counterpart of ``photon_ml_tpu/reliability/faults.py``, with the same
sites, kinds and occurrence semantics.  The fault matrix holds that
every failure the out-of-core pipeline can meet (corrupt chunk, deleted
chunk, slow read, transient read error, ENOSPC on spill, prefetcher
thread death, a failed host-to-device copy) ends in a bounded retry, a
documented degradation, or ONE actionable error: never a hang.  The
seams the port fires:

- ``store.load``: in ``ChunkStore._load``, per read attempt;
- ``store.spill``: in ``ChunkStore.put``, per write attempt;
- ``prefetch.load`` / ``prefetch.place``: on the prefetch thread,
  around the disk read and the host-to-device copy.

The serving fault matrix adds the request path's seams:

- ``serve.store_load``: in ``EntityServeStore`` per chunk read attempt
  on the scoring path (a slow store, transient or persistent I/O
  errors: retries, then fixed-effect-only degradation);
- ``serve.dispatch``: in ``ScoringEngine.score_batch`` before the batch
  is placed on the device (a failing or wedged dispatch: an answered
  error for the whole batch, never a hang);
- ``serve.manifest_load``: in ``ModelServer._load_engine`` with the
  manifest's path (a corrupt or torn swap keeps the previous model).
- ``serve.replica_healthz``: in the fleet supervisor's probe of each
  replica's ``/healthz`` (a flaky or wedged probe: the unhealthy-replica
  restart policy).

The training fleet adds:

- ``fleet.reduce``: in ``parallel.fleet.FleetReducer.reduce`` before
  each cross-host reduction, with the sequence number (the ``kill``
  kind is the killed-host drill: the host dies there and its restart
  replays the reduce sequence from its checkpoint).

A ``FaultInjector`` holds ``Fault`` specs, each targeting a site's Nth
occurrence (per-site counters under one lock); ``seeded_plan`` draws
the occurrences from a seed.  With no injector installed a seam is one
module-global ``None`` check.
"""

from __future__ import annotations

import contextlib
import dataclasses
import errno
import logging
import os
import signal
import threading
import time

from photon_ml_torch import telemetry

logger = logging.getLogger(__name__)

KINDS = ("error", "io_error", "enospc", "slow", "corrupt_file",
         "delete_file", "kill")


class InjectedFault(RuntimeError):
    """A deliberately injected hard failure (thread-death class)."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One planned fault: site × occurrence window × effect.

    ``at`` is the 0-based occurrence of ``site`` at which the fault
    first fires; ``count`` consecutive occurrences fire.  ``delay_s``
    applies to ``slow``; ``message`` rides in raised errors."""

    site: str
    kind: str
    at: int = 0
    count: int = 1
    delay_s: float = 0.05
    message: str = "injected fault"

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"fault kind {self.kind!r} not in {KINDS}")


class FaultInjector:
    """Executes a fault plan at ``fire`` call sites."""

    def __init__(self, faults: list[Fault]):
        self._by_site: dict[str, list[Fault]] = {}
        for f in faults:
            self._by_site.setdefault(f.site, []).append(f)
        self._lock = threading.Lock()
        self._hits: dict[str, int] = {}
        self.fired: list[tuple[str, str, int]] = []  # (site, kind, occ)

    def occurrences(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)

    def fire(self, site: str, path: str | None = None, **ctx) -> None:
        faults = self._by_site.get(site)
        with self._lock:
            n = self._hits.get(site, 0)
            self._hits[site] = n + 1
        if not faults:
            return
        for f in faults:
            if not f.at <= n < f.at + f.count:
                continue
            with self._lock:
                self.fired.append((site, f.kind, n))
            telemetry.count("reliability.faults_injected")
            logger.info("fault injected: %s/%s at occurrence %d (%s)",
                        site, f.kind, n, ctx or path or "")
            self._apply(f, site, path)

    @staticmethod
    def _apply(f: Fault, site: str, path: str | None) -> None:
        if f.kind == "slow":
            time.sleep(f.delay_s)
        elif f.kind == "error":
            raise InjectedFault(f"{f.message} [site={site}]")
        elif f.kind == "io_error":
            raise OSError(errno.EIO, f"{f.message} [site={site}]", path)
        elif f.kind == "enospc":
            raise OSError(errno.ENOSPC,
                          f"No space left on device ({f.message})", path)
        elif f.kind == "corrupt_file":
            if path and os.path.exists(path):
                with open(path, "r+b") as fh:
                    fh.write(b"CORRUPTED-BY-FAULT-PLAN")
        elif f.kind == "delete_file":
            if path and os.path.exists(path):
                os.remove(path)
        elif f.kind == "kill":
            # A host dying without flushing or unwinding.
            os.kill(os.getpid(), signal.SIGKILL)


def seeded_plan(seed: int, site_kinds: dict[str, str],
                horizon: int = 32) -> FaultInjector:
    """One fault per (site, kind) entry at an occurrence drawn in
    [0, horizon) from ``seed``: same seed, same plan."""
    import numpy as np

    rng = np.random.default_rng(seed)
    faults = [Fault(site=site, kind=kind,
                    at=int(rng.integers(0, max(1, horizon))))
              for site, kind in sorted(site_kinds.items())]
    return FaultInjector(faults)


_INJECTOR: FaultInjector | None = None


def fire(site: str, path: str | None = None, **ctx) -> None:
    """The seam call: a no-op unless an injector is installed."""
    inj = _INJECTOR
    if inj is not None:
        inj.fire(site, path=path, **ctx)


def install(inj: FaultInjector | None) -> None:
    global _INJECTOR
    _INJECTOR = inj


@contextlib.contextmanager
def injected(inj: FaultInjector):
    """Install ``inj`` for the block."""
    install(inj)
    try:
        yield inj
    finally:
        install(None)
