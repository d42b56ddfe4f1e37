"""GLM task types.

Counterpart of ``photon_ml_tpu/models/glm.py``.  Only ``TaskType`` is
here so far: the task selects the pointwise loss, and with it the mean
function scoring applies.  ``GeneralizedLinearModel`` comes with the
training path.
"""

from __future__ import annotations

import enum

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
