"""Optimization problems: bind (objective, optimizer, config).

Counterpart of ``photon_ml_tpu/optim/problem.py``.  ``run`` solves one
batch from one starting point on the starting point's device: L-BFGS,
or OWL-QN when the objective carries an L1 weight.  TRON is ROADMAP A2.
"""

from __future__ import annotations

import dataclasses

import torch

from photon_ml_torch.data.batch import Batch
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.optim.base import (
    OptimizationResult,
    OptimizerConfig,
    OptimizerType,
)
from photon_ml_torch.optim.lbfgs import lbfgs_solve

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
            raise NotImplementedError(
                "TRON is not ported yet (ROADMAP A2); use LBFGS")
        return lbfgs_solve(
            lambda w: obj.value_and_gradient(w, batch), w0, self.config,
            l1_weight=self._l1_vector(w0) if self.has_l1() else None,
            value=lambda w: obj.value(w, batch))
