"""Model containers: Coefficients, task types, GLMs, GAME models."""

from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.models.game import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_ml_torch.models.glm import GeneralizedLinearModel, TaskType

__all__ = [
    "Coefficients",
    "FixedEffectModel",
    "GameModel",
    "GeneralizedLinearModel",
    "RandomEffectModel",
    "TaskType",
]
