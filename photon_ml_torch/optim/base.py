"""Optimizer substrate: config, result, convergence tests, state tracking.

Counterpart of ``photon_ml_tpu/optim/base.py``.  There every solver is a
``lax.while_loop``; here it is a host loop over device tensors with a
leading lane axis (one lane for a single problem), with the same
stopping rules, lane by lane: relative gradient norm ``‖g‖ ≤
tol·max(1, ‖g₀‖)`` and, when set, relative loss change.
``StatesTracker`` keeps the per-iteration history as [E, max_iters + 1]
planes on the solver's device, written in place (no host sync per
write).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable

import torch

Tensor = torch.Tensor

# Objective callables: value_and_grad(w) -> (f, g);  hvp(w, v) -> Hv.
ValueAndGrad = Callable[[Tensor], tuple[Tensor, Tensor]]
Hvp = Callable[[Tensor, Tensor], Tensor]


class OptimizerType(str, enum.Enum):
    """LBFGS / TRON; OWL-QN is chosen when L1 is present."""

    LBFGS = "LBFGS"
    TRON = "TRON"


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Solver hyperparameters (the JAX package's, same defaults)."""

    max_iters: int = 100
    # ‖g‖₂ ≤ tolerance · max(1, ‖g₀‖₂).
    tolerance: float = 1e-7
    # |f_k − f_{k−1}| ≤ rel_tolerance · max(1, |f_k|); 0 turns it off.
    rel_tolerance: float = 0.0
    lbfgs_memory: int = 10
    # Backtracking line search: shrink factor / Armijo c1 / max halvings.
    ls_shrink: float = 0.5
    ls_c1: float = 1e-4
    ls_max_steps: int = 30
    # TRON inner CG: max iterations and forcing tolerance ‖r‖ ≤ cg_tol·‖g‖.
    cg_max_iters: int = 50
    cg_tolerance: float = 0.1
    track_states: bool = True


@dataclasses.dataclass
class StatesTracker:
    """Per-iteration history of a solve over E lanes: slot i of a lane's
    row holds its state after iteration i (slot 0 = initial point);
    ``count`` [E] valid slots a lane; unwritten slots are NaN.
    ``step_sizes``/``ls_trials`` hold the accepted line-search step and
    the objective trials of each iteration (TRON: the step's norm and
    its CG iterations).  ``lane(e)`` is one lane's history, with [T]
    planes and an int count."""

    values: Tensor      # [E, max_iters + 1] f32
    grad_norms: Tensor  # [E, max_iters + 1] f32
    count: Tensor       # [E] int32 (int for one lane)
    step_sizes: Tensor  # [E, max_iters + 1] f32
    ls_trials: Tensor   # [E, max_iters + 1] f32

    @staticmethod
    def create(lanes: int, max_iters: int, device) -> "StatesTracker":
        def nan():
            return torch.full((lanes, max_iters + 1), float("nan"),
                              dtype=torch.float32, device=device)
        return StatesTracker(
            values=nan(), grad_norms=nan(),
            count=torch.zeros(lanes, dtype=torch.int32, device=device),
            step_sizes=nan(), ls_trials=nan())

    def record(self, i: int, active: Tensor, value: Tensor,
               grad_norm: Tensor, step_size=None, ls_trials=None) -> None:
        """Slot ``i`` of the lanes where ``active`` holds."""
        def put(plane, x):
            x = torch.as_tensor(x, dtype=torch.float32, device=plane.device)
            plane[:, i] = torch.where(active, x.expand(active.shape),
                                      plane[:, i])
        put(self.values, value)
        put(self.grad_norms, grad_norm)
        if step_size is not None:
            put(self.step_sizes, step_size)
        if ls_trials is not None:
            put(self.ls_trials, ls_trials)
        self.count = torch.where(active, torch.full_like(self.count, i + 1),
                                 self.count)

    def lane(self, e: int) -> "StatesTracker":
        """Lane ``e``'s history."""
        return StatesTracker(
            values=self.values[e], grad_norms=self.grad_norms[e],
            count=int(self.count[e]), step_sizes=self.step_sizes[e],
            ls_trials=self.ls_trials[e])


@dataclasses.dataclass
class OptimizationResult:
    """A solve's final state plus its tracker."""

    w: Tensor            # [dim] solution ([E, dim] lane-batched)
    value: Tensor        # final objective value ([E])
    grad_norm: Tensor    # final ‖g‖₂ (OWL-QN: of the pseudo-gradient)
    iterations: int      # lane-batched: an int32 tensor [E]
    converged: bool      # tolerance met (vs iteration-capped); [E] bool
    tracker: StatesTracker


def grad_converged(g_norm: Tensor, g0_norm: Tensor,
                   tolerance: float) -> Tensor:
    """‖g‖ ≤ tol·max(1, ‖g₀‖), lane by lane ([E] → [E] bool)."""
    return g_norm <= tolerance * torch.clamp(g0_norm, min=1.0)


def loss_converged(f_new: Tensor, f_old: Tensor,
                   rel_tolerance: float) -> Tensor:
    """|f_k − f_{k−1}| ≤ rel_tol·max(1, |f_k|), lane by lane; never with
    rel_tolerance 0."""
    if rel_tolerance <= 0.0:
        return torch.zeros(f_new.shape, dtype=torch.bool,
                           device=f_new.device)
    return (f_new - f_old).abs() <= rel_tolerance * torch.clamp(
        f_new.abs(), min=1.0)
