"""Regularization contexts (L1 / L2 / elastic net).

Counterpart of ``photon_ml_tpu/ops/regularization.py``.  The L2 part is
smooth and folds into the objective's value, gradient and Hessian; the
L1 part is left to the optimizer (OWL-QN).  Elastic net splits a weight
λ as l1 = α·λ, l2 = (1 − α)·λ.  ``reg_mask`` (optional, [dim]) exempts
coordinates, e.g. the intercept (``exclude_intercept_mask``).
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from photon_ml_torch.device import resolve_device

Tensor = torch.Tensor


class RegularizationType(str, enum.Enum):
    NONE = "NONE"
    L1 = "L1"
    L2 = "L2"
    ELASTIC_NET = "ELASTIC_NET"


@dataclasses.dataclass(frozen=True)
class RegularizationContext:
    """Split of the regularization weight into l1 and l2 parts."""

    l1_weight: float
    l2_weight: float
    reg_mask: Tensor | None = None  # [dim] or None (regularize everything)

    @staticmethod
    def none() -> "RegularizationContext":
        return RegularizationContext(0.0, 0.0)

    @staticmethod
    def l2(weight: float, reg_mask: Tensor | None = None
           ) -> "RegularizationContext":
        return RegularizationContext(0.0, float(weight), reg_mask)

    @staticmethod
    def l1(weight: float, reg_mask: Tensor | None = None
           ) -> "RegularizationContext":
        return RegularizationContext(float(weight), 0.0, reg_mask)

    @staticmethod
    def elastic_net(weight: float, alpha: float,
                    reg_mask: Tensor | None = None
                    ) -> "RegularizationContext":
        """l1 = α·λ, l2 = (1 − α)·λ."""
        return RegularizationContext(float(alpha * weight),
                                     float((1.0 - alpha) * weight), reg_mask)

    # -- smooth (L2) part ---------------------------------------------------

    def _masked(self, w: Tensor) -> Tensor:
        return w if self.reg_mask is None else w * self.reg_mask

    def l2_value(self, w: Tensor) -> Tensor:
        wm = self._masked(w)
        return 0.5 * self.l2_weight * torch.dot(wm, wm)

    def l2_gradient(self, w: Tensor) -> Tensor:
        return self.l2_weight * self._masked(w)

    def l2_hessian_vector(self, v: Tensor) -> Tensor:
        return self.l2_weight * self._masked(v)

    def l2_hessian_diagonal(self, w: Tensor) -> Tensor:
        return self.l2_weight * self._masked(torch.ones_like(w))


def exclude_intercept_mask(dim: int, intercept_index: int | None,
                           device=None) -> Tensor | None:
    """[dim] mask that exempts the intercept coordinate, or None; on
    ``device`` (default CUDA; ``"cpu"`` when asked)."""
    if intercept_index is None:
        return None
    mask = torch.ones(dim, dtype=torch.float32,
                      device=resolve_device(device))
    mask[intercept_index] = 0.0
    return mask
