"""Generalized linear models: task types and per-task scoring.

Counterpart of ``photon_ml_tpu/models/glm.py``.  The task selects the
pointwise loss, and with it the mean function scoring applies;
``GeneralizedLinearModel.compute_score`` is the margin.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.ops.losses import PointwiseLoss, get_loss


class TaskType(str, enum.Enum):
    """Reference ``TaskType`` enum."""

    LOGISTIC_REGRESSION = "LOGISTIC_REGRESSION"
    LINEAR_REGRESSION = "LINEAR_REGRESSION"
    POISSON_REGRESSION = "POISSON_REGRESSION"
    SMOOTHED_HINGE_LOSS_LINEAR_SVM = "SMOOTHED_HINGE_LOSS_LINEAR_SVM"

    @property
    def loss(self) -> PointwiseLoss:
        return get_loss(self.value)


@dataclasses.dataclass(frozen=True)
class GeneralizedLinearModel:
    """A trained GLM: coefficients + task type."""

    coefficients: Coefficients
    task: TaskType

    def compute_score(self, batch) -> torch.Tensor:
        """Margins x·w + offset, on the batch's device."""
        return batch.margins(self.coefficients.means)

    def compute_mean(self, batch) -> torch.Tensor:
        """Mean-space prediction: link(margin), sigmoid / identity /
        exp."""
        return self.task.loss.mean(self.compute_score(batch))
