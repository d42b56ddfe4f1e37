"""Runtime guards: kernel-build and synchronization budgets.

Counterpart of ``photon_ml_tpu/analysis/guards.py``:

- ``count_compiles()``: every kernel build (one ``nvcc`` a source, see
  ``kernels._build``) inside the scope, through the same listener as
  telemetry's ``kernels.builds``; a warm re-fit builds nothing.  The
  port compiles nothing else (eager PyTorch has no jit cache).
- ``no_implicit_transfers(level, device)``: over the scope, the
  implicit synchronizations through ``torch.cuda.set_sync_debug_mode``
  (``"disallow"`` makes one raise, ``"log"`` lets it through and counts
  it) and, at either level, the explicit fences
  (``torch.cuda.synchronize``, ``Event.synchronize``,
  ``Stream.synchronize``), which the debug mode does not see; both land
  in the yielded ``SyncLog``.  Like the reference's guard on the CPU
  backend, it is a no-op for a CPU device.

The reference's ``tracer_leak_guard`` has no counterpart: eager PyTorch
has no tracers to leak.
"""

from __future__ import annotations

import warnings
from contextlib import contextmanager

import torch

from photon_ml_torch.device import resolve_device
from photon_ml_torch.kernels import _build

_SYNC_LEVELS = {"disallow": "error", "log": "warn"}


class CompileLog:
    """The kernel builds of one ``count_compiles`` scope."""

    def __init__(self):
        self.programs: list[str] = []

    @property
    def count(self) -> int:
        return len(self.programs)

    def named(self, *names: str) -> list[str]:
        return [p for p in self.programs if p in names]

    def __repr__(self) -> str:
        return f"CompileLog(count={self.count}, programs={self.programs})"


@contextmanager
def count_compiles():
    """Count kernel builds in the scope (yields a ``CompileLog``)."""
    log = CompileLog()
    listener = log.programs.append
    _build.add_build_listener(listener)
    try:
        yield log
    finally:
        _build.remove_build_listener(listener)


class SyncLog:
    """Synchronizing CUDA calls seen by one ``no_implicit_transfers``
    scope: ``messages`` are the implicit ones (at level ``"log"``),
    ``fences`` the explicit ones by name; ``active`` is False where the
    guard is a no-op (a CPU device)."""

    def __init__(self, active: bool):
        self.active = active
        self.messages: list[str] = []
        self.fences: list[str] = []

    @property
    def count(self) -> int:
        return len(self.messages) + len(self.fences)


def _fence_sites():
    """(owner, attribute, name) of every explicit host-device fence."""
    return ((torch.cuda, "synchronize", "torch.cuda.synchronize"),
            (torch.cuda.Event, "synchronize", "Event.synchronize"),
            (torch.cuda.Stream, "synchronize", "Stream.synchronize"))


@contextmanager
def _counting_fences(log: SyncLog):
    """Wrap each fence so that a call appends its name to ``log.fences``
    (from any thread) before it waits."""
    saved = []
    for owner, attr, name in _fence_sites():
        orig = getattr(owner, attr)

        def counted(*args, _orig=orig, _name=name, **kwargs):
            log.fences.append(_name)
            return _orig(*args, **kwargs)

        saved.append((owner, attr, orig))
        setattr(owner, attr, counted)
    try:
        yield
    finally:
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)


@contextmanager
def no_implicit_transfers(level: str = "disallow", device=None):
    """Forbid (``"disallow"``) or count (``"log"``) implicit
    synchronizing CUDA calls in the scope, and count its explicit fences
    at either level; yields a ``SyncLog``.  ``device`` is the run's
    device (``None``: CUDA, as the port's entry points); for a CPU
    device the guard is a no-op.  Both the mode and the fence counting
    are process-wide, so calls from other threads (the prefetch thread)
    count too."""
    if level not in _SYNC_LEVELS:
        raise ValueError(f"level {level!r} not in {tuple(_SYNC_LEVELS)}")
    if resolve_device(device).type != "cuda":
        yield SyncLog(active=False)
        return
    log = SyncLog(active=True)
    old = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(_SYNC_LEVELS[level])
        try:
            with _counting_fences(log):
                yield log
        finally:
            torch.cuda.set_sync_debug_mode(old)
    # Only the per-call warnings count, not the mode's one-time notice.
    log.messages.extend(str(w.message) for w in caught
                        if "called a synchronizing" in str(w.message))
