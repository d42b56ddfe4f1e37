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
whole descent.  With a ``reliability.checkpoint.RunCheckpointer`` the
run snapshots at sweep boundaries (and, with solver-iteration
checkpoints on, after every coordinate), the checkpointer is the active
session for the streaming solvers' mid-solve snapshots, and ``resume``
re-enters at the most advanced (iteration, coordinate) with the score
planes restored, so the resumed offsets are bitwise the uninterrupted
run's.  A streamed random effect's retirement state rides the snapshots'
``re_state``, and its retirement is committed after each of its updates
(``Coordinate.retire_converged``).

With a ``game.fused_sweep.FusedCycleEngine`` every iteration is one
streamed pass that accumulates every coordinate's statistics, then one
Jacobi Newton step a coordinate against the cycle-start offsets
(``_run_fused_cycles``); its state rides ``re_state["__cd_fused__"]``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import logging
import time

import numpy as np
import torch

from photon_ml_torch import telemetry
from photon_ml_torch.evaluation.evaluators import EvaluatorType
from photon_ml_torch.game.coordinates import Coordinate
from photon_ml_torch.parallel import fleet as _fleet
from photon_ml_torch.reliability import checkpoint as _ckpt
from photon_ml_torch.telemetry import convergence as _conv
from photon_ml_torch.telemetry import monitor as _mon

logger = logging.getLogger(__name__)


def _serialize_history(history: list) -> list:
    """Per-iteration diagnostics → checkpoint-tree form (entries already
    in it pass through)."""
    return [{name: (diag if isinstance(diag, dict) else _diag_fields(diag))
             for name, diag in iter_diag.items()} for iter_diag in history]


def _serialize_validation(entries: list) -> list:
    out = []
    for e in entries:
        if isinstance(e, dict):
            out.append({str(getattr(k, "value", k)): float(v)
                        for k, v in e.items()})
        else:
            out.append(float(e))
    return out


def _revive_validation(entries: list) -> list:
    """Inverse of ``_serialize_validation``: keys come back as
    ``EvaluatorType`` where they parse."""
    out = []
    for e in entries or []:
        if isinstance(e, dict):
            revived = {}
            for k, v in e.items():
                try:
                    revived[EvaluatorType(k)] = v
                except ValueError:
                    revived[k] = v
            out.append(revived)
        else:
            out.append(e)
    return out


def _coord_device(coord) -> torch.device:
    ic = coord.initial_coefficients()
    return (ic[0] if isinstance(ic, (list, tuple)) else ic).device


def _on_device(value, device):
    """A restored coefficient (tensor, array, or per-bucket list) on
    ``device``."""
    if isinstance(value, (list, tuple)):
        return [_on_device(v, device) for v in value]
    return torch.as_tensor(np.asarray(value)).to(device=device,
                                                 dtype=torch.float32)


def _diag_fields(diag) -> dict:
    """Scalar convergence fields of a coordinate's train diagnostics: an
    ``OptimizationResult`` (fixed effect) or a per-bucket list of
    lane-batched results (random effect, reduced on the device and read
    back once)."""
    if isinstance(diag, dict):
        return dict(diag)
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
      checkpoint_dir: snapshot the run after every sweep through a
        ``RunCheckpointer`` built with default cadence (the format is a
        superset of ``utils.checkpoint``'s).
      resume: resume from the most advanced snapshot (it overrides
        ``initial_coefficients`` for the names it holds).
      checkpointer: a configured ``RunCheckpointer`` (cadence from
        ``TrainingConfig``); while the loop runs it is the active
        session the streaming solvers snapshot under, scoped by
        (iteration, coordinate).
      fused_engine: a ``game.fused_sweep.FusedCycleEngine``: each
        iteration is one streamed pass plus the Jacobi solves, every
        coordinate updated against the cycle-start offsets (so the
        validator's ``total_scores`` are the cycle-start scores).
        Locked coordinates are refused on this path.
    """
    if fused_engine is not None and locked_coordinates:
        raise ValueError("fused CD does not support locked coordinates")
    locked_coordinates = locked_coordinates or {}
    initial_coefficients = dict(initial_coefficients or {})
    for name in update_sequence:
        if name not in coordinates and name not in locked_coordinates:
            raise ValueError(f"coordinate '{name}' has no trainable unit "
                             "and is not locked")

    if checkpointer is None and checkpoint_dir:
        checkpointer = _ckpt.RunCheckpointer(checkpoint_dir,
                                             run_logger=run_logger,
                                             resume=resume)
    start_iteration = start_pos = 0
    ckpt_scores: dict = {}
    restored_extra: dict = {}
    fused_state: dict | None = None
    if resume:
        if checkpointer is None:
            raise ValueError("resume=True requires checkpoint_dir")
        loaded = checkpointer.load_latest_cd()
        if loaded is not None:
            re_state = loaded["re_state"] or {}
            fused_state = re_state.get("__cd_fused__")
            if fused_state is not None and fused_engine is None:
                # A fused snapshot pairs post-step coefficients with
                # cycle-start score planes: the per-coordinate loop
                # would train against offsets one Jacobi step stale.
                raise ValueError(
                    "checkpoint was written by a fused run (cd_fused); "
                    "resume with cd_fused=true or start a fresh "
                    "checkpoint_dir")
            if fused_state is None and fused_engine is not None:
                # Its iteration count budgets full inner solves: a fused
                # run adopting it would end under-converged, silently.
                raise ValueError(
                    "checkpoint was written by a per-coordinate run; "
                    "resume with cd_fused=false or start a fresh "
                    "checkpoint_dir")
            start_iteration = loaded["iteration"]
            start_pos = loaded["coord_pos"]
            for name, value in loaded["coefs"].items():
                if name in coordinates:
                    initial_coefficients[name] = _on_device(
                        value, _coord_device(coordinates[name]))
            restored_extra = loaded["extra"]
            # A fleet host replays its reduce sequence from this
            # boundary (answered from the coordinator's cache).
            _fleet.restore_seq(restored_extra.get("fleet_seq"))
            if fused_engine is None:
                # The fused loop composes margins from coefficients and
                # never reads these planes back.
                device = _coord_device(next(iter(coordinates.values())))
                ckpt_scores = {k: torch.as_tensor(np.asarray(v)).to(device)
                               for k, v in loaded["scores"].items()}
            # A streamed random effect's blocks come back with its
            # retirement state; installed as the warm start, they are
            # recognized as its own and the state is kept.
            for name, st in re_state.items():
                coord = coordinates.get(name)
                if coord is not None and hasattr(coord,
                                                 "restore_runtime_state"):
                    blocks, cached = coord.restore_runtime_state(st)
                    initial_coefficients[name] = blocks
                    ckpt_scores.setdefault(name, cached)
            if run_logger is not None:
                run_logger.event("cd_resume", iteration=start_iteration,
                                 coord_pos=start_pos)

    if fused_engine is not None:
        return _run_fused_cycles(
            fused_engine, coordinates, update_sequence, n_iterations,
            validator, initial_coefficients, checkpointer, run_logger,
            start_iteration, restored_extra, fused_state)

    coefs: dict = {}
    scores: dict = {}
    for name, locked in locked_coordinates.items():
        coefs[name] = locked
        scores[name] = coordinates[name].score(locked)
    for name in update_sequence:
        if name in locked_coordinates:
            continue
        if name in ckpt_scores and name in initial_coefficients:
            # Restored score state: bitwise what the uninterrupted loop
            # carried here.
            coefs[name] = initial_coefficients[name]
            scores[name] = ckpt_scores[name]
        elif name in initial_coefficients:
            coefs[name] = initial_coefficients[name]
            scores[name] = coordinates[name].score(coefs[name])
        else:
            s = coordinates[name].score(
                coordinates[name].initial_coefficients())
            scores[name] = torch.zeros_like(s)
    if "__cd_total__" in ckpt_scores:
        total = ckpt_scores["__cd_total__"]
    else:
        total = None
        for s in scores.values():
            total = s if total is None else total + s

    history = _serialize_history(restored_extra.get("history") or [])
    validation_history = _revive_validation(
        restored_extra.get("validation_history"))
    prev_values: dict = dict(restored_extra.get("prev_values") or {})
    last_offsets: dict = {}
    last_results: dict = {}

    def re_states() -> dict:
        return {name: coord.runtime_state()
                for name, coord in coordinates.items()
                if hasattr(coord, "runtime_state")
                and name not in locked_coordinates}

    def extra() -> dict:
        return {"history": _serialize_history(history),
                "validation_history": _serialize_validation(
                    validation_history),
                "prev_values": dict(prev_values),
                "fleet_seq": _fleet.seq()}

    # Re-entering a partial sweep: the coordinates it skips trained
    # before the interruption, and their diagnostics ride in the
    # partial snapshot.
    partial_diag = dict(restored_extra.get("partial_iter_diag") or {})
    with _ckpt.session(checkpointer):
        for it in range(start_iteration, n_iterations):
            iter_diag = dict(partial_diag if it == start_iteration else {})
            for pos, name in enumerate(update_sequence):
                if name in locked_coordinates:
                    continue
                if it == start_iteration and pos < start_pos:
                    continue   # trained before the interruption
                coord = coordinates[name]
                t0 = time.perf_counter()
                scope = (checkpointer.scope(f"it{it + 1}", name)
                         if checkpointer is not None
                         else contextlib.nullcontext())
                # One coordinate's train and score in a sweep is one
                # block on the timeline.
                with scope, telemetry.span("cd_coordinate", cat="cd",
                                           coordinate=name,
                                           iteration=it + 1):
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
                # Retirement is committed after the new scores are in
                # the totals: the next sweep packs only active entities.
                newly_retired = coord.retire_converged()
                if newly_retired:
                    telemetry.count("cd.entities_retired", newly_retired)
                # Coordinate updates done against the descent's plan:
                # the live monitor's top-level ETA.
                _mon.progress("cd", it * len(update_sequence) + pos + 1,
                              n_iterations * len(update_sequence),
                              unit="updates", iteration=it + 1,
                              coordinate=name)
                telemetry.count("cd.coordinate_updates")
                extra_fields = ({} if newly_retired is None
                                else {"entities_newly_retired":
                                      newly_retired})
                if "value" in fields:
                    if name in prev_values:
                        delta = prev_values[name] - fields["value"]
                        extra_fields["value_delta"] = round(delta, 8)
                        telemetry.observe("cd.objective_delta", delta)
                    prev_values[name] = fields["value"]
                    if (not coord.traces_convergence
                            and hasattr(diag, "value")
                            and diag.value.dim() == 0):
                        _conv.solve_trace("resident", name, diag)
                logger.info("CD iter %d coordinate %s trained in %.2fs",
                            it + 1, name, elapsed)
                if run_logger is not None:
                    run_logger.event("cd_coordinate", iteration=it + 1,
                                     coordinate=name,
                                     duration_s=round(elapsed, 4),
                                     **fields, **extra_fields)
                if checkpointer is not None and \
                        checkpointer.mid_sweep_enabled:
                    # ``pos + 1`` entries of sweep ``it + 1`` are done.
                    checkpointer.save_cd_partial(
                        it, pos + 1, coefs,
                        scores={**scores, "__cd_total__": total},
                        re_state=re_states(),
                        extra={**extra(), "partial_iter_diag":
                               _serialize_history([iter_diag])[0]})
            # A completed cycle: the report's passes-a-cycle divides
            # the sweep odometer by this.
            telemetry.count("cd.cycles")
            history.append(iter_diag)
            if validator is not None:
                _record_validation(validator, coefs, total, it,
                                   validation_history, run_logger)
            if checkpointer is not None:
                checkpointer.maybe_save_cd(
                    it + 1, coefs,
                    scores={**scores, "__cd_total__": total},
                    re_state=re_states(), extra=extra(),
                    final=(it + 1 == n_iterations))
    return CoordinateDescentResult(
        coefficients=coefs, scores=scores, total_scores=total,
        history=history, validation_history=validation_history,
        last_offsets=last_offsets, last_results=last_results)


def _record_validation(validator, coefs, total, it, validation_history,
                       run_logger) -> None:
    with telemetry.span("cd_validation", cat="cd", iteration=it + 1):
        metric = _call_validator(validator, coefs, total)
    validation_history.append(metric)
    out = ({str(getattr(k, "value", k)): float(v) for k, v in metric.items()}
           if isinstance(metric, dict) else {"metric": float(metric)})
    logger.info("CD iter %d validation %s", it + 1, out)
    if run_logger is not None:
        run_logger.event("cd_validation", iteration=it + 1, **out)


def _run_fused_cycles(engine, coordinates, update_sequence, n_iterations,
                      validator, initial_coefficients, checkpointer,
                      run_logger, start_iteration, restored_extra,
                      fused_state) -> CoordinateDescentResult:
    """The fused loop: one streamed pass and the Jacobi solves an
    iteration.  Snapshots land at cycle boundaries with the engine's
    state (step scale, retirement masks, offset baselines) under
    ``re_state["__cd_fused__"]``, so a resumed run steps as the
    uninterrupted one; one last pass brings the score planes to the
    final coefficients (the last accepted point's when the last step
    rose)."""
    engine.restore_runtime_state(fused_state)
    trainable = list(dict.fromkeys(update_sequence))
    coefs = {name: initial_coefficients.get(
        name, coordinates[name].initial_coefficients())
        for name in trainable}
    history = _serialize_history(restored_extra.get("history") or [])
    validation_history = _revive_validation(
        restored_extra.get("validation_history"))

    def extra() -> dict:
        return {"history": _serialize_history(history),
                "validation_history": _serialize_validation(
                    validation_history),
                "fleet_seq": _fleet.seq()}

    with _ckpt.session(checkpointer):
        for it in range(start_iteration, n_iterations):
            t0 = time.perf_counter()
            with telemetry.span("cd_fused_cycle", cat="cd",
                                iteration=it + 1):
                coefs, scores, total, iter_diag = engine.run_cycle(coefs)
            elapsed = time.perf_counter() - t0
            telemetry.count("cd.cycles")
            telemetry.count("cd.coordinate_updates", len(trainable))
            history.append(iter_diag)
            # Cycle progress (the engine reports its chunks as
            # ``train.cd_fused``).
            _mon.progress("cd", it + 1, n_iterations, unit="cycles",
                          iteration=it + 1)
            fe_diag = iter_diag.get(engine.fe_name, {})
            logger.info("CD fused cycle %d in %.2fs (value %s, alpha %s)",
                        it + 1, elapsed, fe_diag.get("value"),
                        fe_diag.get("alpha"))
            if run_logger is not None:
                run_logger.event(
                    "cd_fused_cycle", iteration=it + 1,
                    duration_s=round(elapsed, 4),
                    value=fe_diag.get("value"),
                    grad_norm=fe_diag.get("grad_norm"),
                    alpha=fe_diag.get("alpha"),
                    rejected=fe_diag.get("rejected", False),
                    entities_retired=sum(
                        d.get("entities_retired", 0)
                        for d in iter_diag.values()))
            if validator is not None:
                # ``total`` holds the cycle-start scores (Jacobi).
                _record_validation(validator, coefs, total, it,
                                   validation_history, run_logger)
            if checkpointer is not None:
                checkpointer.maybe_save_cd(
                    it + 1, coefs,
                    scores={**scores, "__cd_total__": total},
                    re_state={"__cd_fused__": engine.runtime_state()},
                    extra=extra(), final=(it + 1 == n_iterations))
    coefs, scores, total = engine.score_pass(coefs)
    return CoordinateDescentResult(
        coefficients=coefs, scores=scores, total_scores=total,
        history=history, validation_history=validation_history)
