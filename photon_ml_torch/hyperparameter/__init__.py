"""Hyperparameter tuning: GP regression + Expected Improvement.

Counterpart of ``photon_ml_tpu/hyperparameter/``: the same search
spaces, strategies and tuner, with torch in place of ``jnp``.  The GP
runs on the CPU (a tuning history is a few dozen points), and the
proposal streams are the reference's ``numpy.random.default_rng(seed)``
ones, so proposals match it draw for draw.
"""

from photon_ml_torch.hyperparameter.gp import GaussianProcessModel, fit_gp
from photon_ml_torch.hyperparameter.kernels import KernelType
from photon_ml_torch.hyperparameter.search import (
    GaussianProcessSearch,
    ParamRange,
    ParamScale,
    RandomSearch,
    SearchSpace,
    expected_improvement,
)
from photon_ml_torch.hyperparameter.tuner import (
    HyperparameterTuner,
    TrialResult,
    TunerMode,
)

__all__ = [
    "GaussianProcessModel", "fit_gp", "KernelType",
    "GaussianProcessSearch", "ParamRange", "ParamScale", "RandomSearch",
    "SearchSpace", "expected_improvement",
    "HyperparameterTuner", "TrialResult", "TunerMode",
]
