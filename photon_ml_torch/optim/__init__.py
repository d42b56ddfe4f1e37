"""Optimizers: L-BFGS / OWL-QN / TRON, resident, lane-batched and
streamed (counterpart of ``photon_ml_tpu/optim``)."""

from photon_ml_torch.optim.base import (
    OptimizationResult,
    OptimizerConfig,
    OptimizerType,
    StatesTracker,
)
from photon_ml_torch.optim.lbfgs import (
    lbfgs_solve,
    lbfgs_solve_swept,
    owlqn_solve,
    owlqn_solve_swept,
)
from photon_ml_torch.optim.problem import OptimizationProblem, solve_batched
from photon_ml_torch.optim.streaming import (
    ChunkedGLMObjective,
    streaming_lbfgs_solve,
    streaming_lbfgs_solve_swept,
)
from photon_ml_torch.optim.tron import tron_solve

__all__ = [
    "OptimizationResult",
    "OptimizerConfig",
    "OptimizerType",
    "StatesTracker",
    "lbfgs_solve",
    "lbfgs_solve_swept",
    "owlqn_solve",
    "owlqn_solve_swept",
    "tron_solve",
    "OptimizationProblem",
    "solve_batched",
    "ChunkedGLMObjective",
    "streaming_lbfgs_solve",
    "streaming_lbfgs_solve_swept",
]
