"""Optimization problems: bind (objective, optimizer, config).

Counterpart of ``photon_ml_tpu/optim/problem.py``.  ``run`` solves one
batch from one starting point on the starting point's device: L-BFGS,
or OWL-QN when the objective carries an L1 weight, or TRON.
``solve_batched`` solves E same-shape problems stacked on a leading
lane axis (the reference's ``jax.vmap(problem.run)``), each lane on its
own criteria.
"""

from __future__ import annotations

import dataclasses

import torch

from photon_ml_torch.data.batch import Batch, DenseBatch
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.optim.base import (
    OptimizationResult,
    OptimizerConfig,
    OptimizerType,
)
from photon_ml_torch.optim.lbfgs import lbfgs_solve, lbfgs_solve_batched
from photon_ml_torch.optim.tron import tron_solve, tron_solve_batched

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class OptimizationProblem:
    """(objective, optimizer type, config) — the solvable unit."""

    objective: GLMObjective
    optimizer: OptimizerType = OptimizerType.LBFGS
    config: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)

    def has_l1(self) -> bool:
        """L1 presence: routes L-BFGS → OWL-QN."""
        return float(self.objective.reg.l1_weight) != 0.0

    def _l1_vector(self, w0: Tensor) -> Tensor:
        reg = self.objective.reg
        vec = torch.full_like(w0, float(reg.l1_weight))
        return vec if reg.reg_mask is None else vec * reg.reg_mask

    def run(self, batch: Batch, w0: Tensor) -> OptimizationResult:
        obj = self.objective
        if self.optimizer == OptimizerType.TRON:
            if self.has_l1():
                raise ValueError(
                    "TRON requires a smooth objective; use LBFGS (OWL-QN) "
                    "for L1/elastic-net problems")
            return tron_solve(
                lambda w: obj.value_and_gradient(w, batch),
                lambda w, v: obj.hessian_vector(w, v, batch), w0,
                self.config)
        return lbfgs_solve(
            lambda w: obj.value_and_gradient(w, batch), w0, self.config,
            l1_weight=self._l1_vector(w0) if self.has_l1() else None,
            value=lambda w: obj.value(w, batch))


def solve_batched(problem: OptimizationProblem, batches: DenseBatch,
                  w0s: Tensor) -> OptimizationResult:
    """Solve E stacked problems: ``batches`` holds E same-shape blocks
    (``x`` [E, c, p], the rest [E, c]) and ``w0s`` is [E, p].  Each lane
    gives what ``problem.run`` on its own block would (to float32
    rounding); the result has a leading lane axis."""
    obj = problem.objective
    if problem.optimizer == OptimizerType.TRON:
        if problem.has_l1():
            raise ValueError(
                "TRON requires a smooth objective; use LBFGS (OWL-QN) "
                "for L1/elastic-net problems")
        return tron_solve_batched(
            lambda w: obj.value_and_gradient(w, batches),
            lambda w, v: obj.hessian_vector(w, v, batches), w0s,
            problem.config)
    return lbfgs_solve_batched(
        lambda w: obj.value_and_gradient(w, batches), w0s,
        problem.config,
        l1_weight=problem._l1_vector(w0s[0]) if problem.has_l1() else None,
        value=lambda w: obj.value(w, batches))
