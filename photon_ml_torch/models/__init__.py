"""Model containers: Coefficients, task types, GAME models."""

from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.models.game import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_ml_torch.models.glm import TaskType

__all__ = [
    "Coefficients",
    "FixedEffectModel",
    "GameModel",
    "RandomEffectModel",
    "TaskType",
]
