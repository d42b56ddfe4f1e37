"""Optimizer substrate: config, result, convergence tests, state tracking.

Counterpart of ``photon_ml_tpu/optim/base.py``.  There every solver is a
``lax.while_loop``; here it is a host loop over device tensors, with the
same stopping rules: relative gradient norm ``‖g‖ ≤ tol·max(1, ‖g₀‖)``
and, when set, relative loss change.  ``StatesTracker`` keeps the
per-iteration history as [max_iters + 1] planes on the solver's device,
written in place (no host sync per write).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable

import torch

Tensor = torch.Tensor

# The objective callable: value_and_grad(w) -> (f, g).
ValueAndGrad = Callable[[Tensor], tuple[Tensor, Tensor]]


class OptimizerType(str, enum.Enum):
    """LBFGS / TRON; OWL-QN is chosen when L1 is present."""

    LBFGS = "LBFGS"
    TRON = "TRON"


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Solver hyperparameters (the JAX package's, same defaults; TRON's
    inner-CG settings come with TRON, ROADMAP A2)."""

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
    track_states: bool = True


@dataclasses.dataclass
class StatesTracker:
    """Per-iteration history: slot i holds the state after iteration i
    (slot 0 = initial point); ``count`` valid slots; unwritten slots are
    NaN.  ``step_sizes``/``ls_trials`` hold the accepted line-search step
    and the objective trials of each iteration."""

    values: Tensor      # [max_iters + 1] f32
    grad_norms: Tensor  # [max_iters + 1] f32
    count: int
    step_sizes: Tensor  # [max_iters + 1] f32
    ls_trials: Tensor   # [max_iters + 1] f32

    @staticmethod
    def create(max_iters: int, device) -> "StatesTracker":
        def nan():
            return torch.full((max_iters + 1,), float("nan"),
                              dtype=torch.float32, device=device)
        return StatesTracker(values=nan(), grad_norms=nan(), count=0,
                             step_sizes=nan(), ls_trials=nan())

    def record(self, i: int, value: Tensor, grad_norm: Tensor,
               step_size=None, ls_trials=None) -> None:
        self.values[i] = value
        self.grad_norms[i] = grad_norm
        if step_size is not None:
            self.step_sizes[i] = step_size
        if ls_trials is not None:
            self.ls_trials[i] = ls_trials
        self.count = max(self.count, i + 1)


@dataclasses.dataclass
class OptimizationResult:
    """A solve's final state plus its tracker."""

    w: Tensor            # [dim] solution
    value: Tensor        # final objective value
    grad_norm: Tensor    # final ‖g‖₂ (OWL-QN: of the pseudo-gradient)
    iterations: int
    converged: bool      # tolerance met (vs iteration-capped)
    tracker: StatesTracker


def grad_converged(g_norm: float, g0_norm: float, tolerance: float) -> bool:
    return g_norm <= tolerance * max(1.0, g0_norm)


def loss_converged(f_new: float, f_old: float, rel_tolerance: float) -> bool:
    if rel_tolerance <= 0.0:
        return False
    return abs(f_new - f_old) <= rel_tolerance * max(abs(f_new), 1.0)
