"""Coordinate descent: the GAME outer loop.

Counterpart of the resident branch of
``photon_ml_tpu/game/coordinate_descent.py``, with Photon-ML's
semantics:

    for iteration 1..N:
      for coordinate in update_sequence:
        offsets = total_scores − coordinate_scores[coordinate]
        coefs   = coordinate.train(offsets, warm start = previous coefs)
        scores  = coordinate.score(coefs)
        total   = offsets + scores
      (validation once a sweep)

The loop is host Python; scores and offsets stay on the device for the
whole descent.  Checkpoint/resume (ROADMAP A8a) and the fused streamed
cycle (ROADMAP A5) are not ported and raise.
"""

from __future__ import annotations

import dataclasses
import inspect
import logging
import time

import numpy as np
import torch

from photon_ml_torch.game.coordinates import Coordinate

logger = logging.getLogger(__name__)


def _diag_fields(diag) -> dict:
    """Scalar convergence fields of a coordinate's train diagnostics: an
    ``OptimizationResult`` (fixed effect) or a per-bucket list of
    lane-batched results (random effect, reduced on the device and read
    back once)."""
    if hasattr(diag, "value") and diag.value.dim() == 0:
        out = {"value": float(diag.value), "grad_norm": float(diag.grad_norm),
               "solver_iterations": int(diag.iterations),
               "converged": bool(diag.converged)}
        tracker = getattr(diag, "tracker", None)
        if tracker is not None and int(tracker.count) > 0:
            c = int(tracker.count)
            out["states"] = {
                "values": np.round(tracker.values[:c].double().cpu().numpy(),
                                   8).tolist(),
                "grad_norms": np.round(
                    tracker.grad_norms[:c].double().cpu().numpy(),
                    8).tolist()}
        return out
    if isinstance(diag, (list, tuple)) and diag and hasattr(diag[0], "value"):
        n = sum(int(r.value.shape[0]) for r in diag)
        conv = sum(r.converged.sum() for r in diag)
        iters = torch.stack([r.iterations.max() for r in diag]).max()
        conv, iters = torch.stack([conv.to(iters.dtype), iters]).tolist()
        return {"entities": n, "entities_converged": int(conv),
                "max_solver_iterations": int(iters)}
    return {}


def _call_validator(validator, coefs, total):
    """A validator is ``(coefficients, total_scores)``, or the older
    one-positional ``(total_scores)`` form (decided by its signature's
    positional count, never by catching a TypeError)."""
    try:
        params = list(inspect.signature(validator).parameters.values())
    except (TypeError, ValueError):
        return validator(coefs, total)
    positional = [p for p in params
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    var_pos = any(p.kind is p.VAR_POSITIONAL for p in params)
    if len(positional) == 1 and not var_pos:
        return validator(total)
    return validator(coefs, total)


@dataclasses.dataclass
class CoordinateDescentResult:
    """Trained coefficients per coordinate + the per-sweep history.

    ``last_offsets`` and ``last_results`` hold, per trained coordinate,
    the offsets its last solve saw and that solve's raw diagnostics (a
    result, or per-bucket lane-batched results): enough to re-check a
    final solve against an independent solver."""

    coefficients: dict
    scores: dict
    total_scores: torch.Tensor
    history: list
    validation_history: list
    last_offsets: dict = dataclasses.field(default_factory=dict)
    last_results: dict = dataclasses.field(default_factory=dict)


def run_coordinate_descent(
    coordinates: dict[str, Coordinate],
    update_sequence: list[str],
    n_iterations: int,
    validator=None,
    locked_coordinates: dict | None = None,
    initial_coefficients: dict | None = None,
    checkpoint_dir: str | None = None,
    resume: bool = False,
    run_logger=None,
    checkpointer=None,
    fused_engine=None,
) -> CoordinateDescentResult:
    """Run GAME coordinate descent.

    Args:
      coordinates: name → Coordinate.
      update_sequence: the update order.
      n_iterations: full sweeps over the sequence.
      validator: optional ``(coefficients, total_scores) → float | dict``
        run once a sweep; its results form ``validation_history``.
      locked_coordinates: name → fixed coefficients: scored once, never
        trained (partial retraining).
      initial_coefficients: name → starting coefficients (warm start):
        the coordinate starts scored at them instead of at zero.
      run_logger: optional ``utils.run_log.RunLogger`` for per-coordinate
        and per-sweep events.
      checkpoint_dir, resume, checkpointer: ROADMAP A8a, not ported.
      fused_engine: the fused streamed cycle, ROADMAP A5, not ported.
    """
    if checkpoint_dir or resume or checkpointer is not None:
        raise NotImplementedError(
            "coordinate-descent checkpoints and resume are not ported yet "
            "(ROADMAP A8a)")
    if fused_engine is not None:
        raise NotImplementedError(
            "the fused streamed CD cycle is not ported yet (ROADMAP A5)")
    locked_coordinates = locked_coordinates or {}
    initial_coefficients = dict(initial_coefficients or {})
    for name in update_sequence:
        if name not in coordinates and name not in locked_coordinates:
            raise ValueError(f"coordinate '{name}' has no trainable unit "
                             "and is not locked")

    coefs: dict = {}
    scores: dict = {}
    for name, locked in locked_coordinates.items():
        coefs[name] = locked
        scores[name] = coordinates[name].score(locked)
    for name in update_sequence:
        if name in locked_coordinates:
            continue
        if name in initial_coefficients:
            coefs[name] = initial_coefficients[name]
            scores[name] = coordinates[name].score(coefs[name])
        else:
            s = coordinates[name].score(
                coordinates[name].initial_coefficients())
            scores[name] = torch.zeros_like(s)
    total = None
    for s in scores.values():
        total = s if total is None else total + s

    history: list = []
    validation_history: list = []
    prev_values: dict = {}
    last_offsets: dict = {}
    last_results: dict = {}
    for it in range(n_iterations):
        iter_diag = {}
        for name in update_sequence:
            if name in locked_coordinates:
                continue
            coord = coordinates[name]
            t0 = time.perf_counter()
            offsets = total - scores[name]
            w, diag = coord.train(offsets, coefs.get(name))
            new_scores = coord.score(w)
            total = offsets + new_scores
            scores[name] = new_scores
            coefs[name] = w
            last_offsets[name] = offsets
            last_results[name] = diag
            fields = _diag_fields(diag)
            iter_diag[name] = fields
            elapsed = time.perf_counter() - t0
            extra = {}
            if "value" in fields:
                if name in prev_values:
                    extra["value_delta"] = round(
                        prev_values[name] - fields["value"], 8)
                prev_values[name] = fields["value"]
            logger.info("CD iter %d coordinate %s trained in %.2fs",
                        it + 1, name, elapsed)
            if run_logger is not None:
                run_logger.event("cd_coordinate", iteration=it + 1,
                                 coordinate=name,
                                 duration_s=round(elapsed, 4), **fields,
                                 **extra)
        history.append(iter_diag)
        if validator is not None:
            metric = _call_validator(validator, coefs, total)
            validation_history.append(metric)
            out = ({str(getattr(k, "value", k)): float(v)
                    for k, v in metric.items()}
                   if isinstance(metric, dict) else {"metric": float(metric)})
            logger.info("CD iter %d validation %s", it + 1, out)
            if run_logger is not None:
                run_logger.event("cd_validation", iteration=it + 1, **out)
    return CoordinateDescentResult(
        coefficients=coefs, scores=scores, total_scores=total,
        history=history, validation_history=validation_history,
        last_offsets=last_offsets, last_results=last_results)
