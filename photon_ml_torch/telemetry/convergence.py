"""Solver convergence traces.

Counterpart of ``photon_ml_tpu/telemetry/convergence.py``:

- ``iteration(...)``: one ``convergence_iter`` event a host-driven
  (streaming) solver iteration, written live, so a killed run's log
  keeps the partial trajectory.
- ``solve_trace(...)``: one ``convergence_trace`` event a finished
  solve, from its ``StatesTracker`` planes (values, gradient norms, step
  sizes, line-search trials; lane by lane for a swept solve).
- ``re_sweep(...)`` / ``re_retirement(...)``: a streamed random-effect
  sweep's solved/converged/retired/woken entity counts, and each
  retirement commit.

Every entry point is one global read when telemetry is off.  The
counters kept here (``conv.iterations``, ``conv.solves``,
``conv.solver_iterations``, ``conv.re_sweeps``) are what ``telemetry
report`` holds against the ``solver.sweeps`` odometer.  Tensors are
read only at solver-iteration and solve boundaries, where the solvers
already read them.
"""

from __future__ import annotations

import numpy as np
import torch

from photon_ml_torch import telemetry


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _round_list(arr, ndigits: int = 8) -> list:
    """A host list with bounded precision; NaN → None, so the line stays
    strict JSON."""
    a = np.asarray(_np(arr), np.float64)
    return [None if x != x else round(x, ndigits)
            for x in a.reshape(-1).tolist()]


def iteration(solver: str, label: str, it: int, value, grad_norm,
              step_size=None, ls_trials=None, lanes_active=None,
              lanes_done=None, delta=None, rho=None) -> None:
    """One host-driven solver iteration.  ``value``/``grad_norm`` are
    scalars or lane vectors (swept solves); ``delta``/``rho`` are TRON's
    trust-region radius and actual/predicted reduction ratio."""
    t = telemetry.active()
    if t is None:
        return
    t.count("conv.iterations")
    fields = {"solver": solver, "label": label, "iteration": int(it)}
    v = np.asarray(_np(value), np.float64).reshape(-1)
    g = np.asarray(_np(grad_norm), np.float64).reshape(-1)
    if v.size == 1:
        fields["value"] = round(float(v[0]), 8)
        fields["grad_norm"] = float(g[0])
    else:
        fields["values"] = _round_list(v)
        fields["grad_norms"] = _round_list(g)
    if step_size is not None:
        fields["step_size"] = float(_np(step_size).reshape(-1)[0])
    if ls_trials is not None:
        fields["ls_trials"] = int(ls_trials)
    if lanes_active is not None:
        fields["lanes_active"] = int(lanes_active)
    if lanes_done is not None:
        fields["lanes_done"] = int(lanes_done)
    if delta is not None:
        fields["delta"] = float(delta)
    if rho is not None:
        r = float(rho)
        fields["rho"] = None if r != r else round(r, 6)
    t._log.event("convergence_iter", **fields)


def solve_trace(solver: str, label: str, result) -> None:
    """One finished solve's trajectory from its tracker planes;
    ``result`` is an ``OptimizationResult``, one lane or lane-batched."""
    t = telemetry.active()
    if t is None:
        return
    iters = np.asarray(_np(result.iterations)).reshape(-1)
    t.count("conv.solves")
    t.count("conv.solver_iterations", int(iters.sum()))
    fields = {"solver": solver, "label": label}
    conv = np.asarray(_np(result.converged)).reshape(-1)
    if iters.size == 1:
        fields["iterations"] = int(iters[0])
        fields["converged"] = bool(conv[0])
    else:
        fields["lanes"] = int(iters.size)
        fields["iterations"] = [int(x) for x in iters.tolist()]
        fields["converged"] = [bool(x) for x in conv.tolist()]
    tracker = getattr(result, "tracker", None)
    if tracker is not None:
        count = np.asarray(_np(tracker.count)).reshape(-1)
        c = int(count.max()) if count.size else 0
        if c > 0:
            fields["values"] = _round_list(_np(tracker.values)[..., :c])
            fields["grad_norms"] = _round_list(
                _np(tracker.grad_norms)[..., :c])
            if tracker.step_sizes is not None:
                fields["step_sizes"] = _round_list(
                    _np(tracker.step_sizes)[..., :c], 6)
            if tracker.ls_trials is not None:
                fields["ls_trials"] = _round_list(
                    _np(tracker.ls_trials)[..., :c], 1)
    t._log.event("convergence_trace", **fields)


def re_retirement(coordinate: str, newly: int, total: int) -> None:
    """A retirement commit (between CD sweeps): ``re_sweep`` events see
    the retired set as of sweep start, so the last sweep's commit shows
    only here."""
    t = telemetry.active()
    if t is None:
        return
    t._log.event("re_retirement", coordinate=coordinate,
                 entities_newly_retired=int(newly),
                 entities_retired_total=int(total))


def re_sweep(coordinate: str, diag: dict) -> None:
    """One streamed random-effect sweep's entity dynamics."""
    t = telemetry.active()
    if t is None:
        return
    t.count("conv.re_sweeps")
    keep = ("entities", "entities_solved", "entities_converged",
            "entities_retired", "entities_woken",
            "max_solver_iterations", "chunks_streamed")
    fields = {k: int(diag[k]) for k in keep if k in diag}
    t._log.event("re_convergence", coordinate=coordinate, **fields)
