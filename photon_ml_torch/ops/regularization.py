"""Regularization contexts (L1 / L2 / elastic net).

Counterpart of ``photon_ml_tpu/ops/regularization.py``.  The L2 part is
smooth and folds into the objective's value, gradient and Hessian; the
L1 part is left to the optimizer (OWL-QN).  Elastic net splits a weight
λ as l1 = α·λ, l2 = (1 − α)·λ.  ``reg_mask`` (optional, [dim]) exempts
coordinates, e.g. the intercept (``exclude_intercept_mask``).
``l2_weight`` may be a tensor [L] with coefficients W [L, d]: a λ sweep,
one L2 weight a lane (``SweptRegularization`` holds a grid's splits).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from photon_ml_torch.device import resolve_device

Tensor = torch.Tensor


class RegularizationType(str, enum.Enum):
    NONE = "NONE"
    L1 = "L1"
    L2 = "L2"
    ELASTIC_NET = "ELASTIC_NET"


def split_weight(regularization: "RegularizationType | str", weight,
                 alpha: float = 0.5) -> tuple:
    """(l1, l2) parts of a weight λ, a float or a tensor of λ-lanes: L2 →
    (0, λ); L1 → (λ, 0); elastic net → (α·λ, (1 − α)·λ); none → (0, 0)."""
    reg = RegularizationType(regularization)
    zero = weight * 0.0
    if reg == RegularizationType.L2:
        return zero, weight
    if reg == RegularizationType.L1:
        return weight, zero
    if reg == RegularizationType.ELASTIC_NET:
        return alpha * weight, (1.0 - alpha) * weight
    return zero, zero


@dataclasses.dataclass(frozen=True)
class RegularizationContext:
    """Split of the regularization weight into l1 and l2 parts."""

    l1_weight: float
    l2_weight: float | Tensor       # a tensor [L]: one weight a λ-lane
    reg_mask: Tensor | None = None  # [dim] or None (regularize everything)

    @staticmethod
    def none() -> "RegularizationContext":
        return RegularizationContext(0.0, 0.0)

    @staticmethod
    def of(regularization: "RegularizationType | str", weight: float,
           alpha: float = 0.5, reg_mask: Tensor | None = None
           ) -> "RegularizationContext":
        """The context of ``regularization`` at weight λ (``split_weight``)."""
        l1, l2 = split_weight(regularization, float(weight), alpha)
        return RegularizationContext(l1, l2, reg_mask)

    @staticmethod
    def l2(weight: float, reg_mask: Tensor | None = None
           ) -> "RegularizationContext":
        return RegularizationContext.of(RegularizationType.L2, weight,
                                        reg_mask=reg_mask)

    @staticmethod
    def l1(weight: float, reg_mask: Tensor | None = None
           ) -> "RegularizationContext":
        return RegularizationContext.of(RegularizationType.L1, weight,
                                        reg_mask=reg_mask)

    @staticmethod
    def elastic_net(weight: float, alpha: float,
                    reg_mask: Tensor | None = None
                    ) -> "RegularizationContext":
        """l1 = α·λ, l2 = (1 − α)·λ."""
        return RegularizationContext.of(RegularizationType.ELASTIC_NET,
                                        weight, alpha, reg_mask)

    # -- smooth (L2) part ---------------------------------------------------

    def _masked(self, w: Tensor) -> Tensor:
        return w if self.reg_mask is None else w * self.reg_mask

    def _l2_column(self):
        """The L2 weight shaped to scale [L, d] lanes ([L, 1])."""
        lam = self.l2_weight
        return lam[:, None] if isinstance(lam, Tensor) and lam.dim() else lam

    def l2_value(self, w: Tensor) -> Tensor:
        wm = self._masked(w)
        return 0.5 * self.l2_weight * (wm * wm).sum(-1)

    def l2_gradient(self, w: Tensor) -> Tensor:
        return self._l2_column() * self._masked(w)

    def l2_hessian_vector(self, v: Tensor) -> Tensor:
        return self._l2_column() * self._masked(v)

    def l2_hessian_diagonal(self, w: Tensor) -> Tensor:
        return self._l2_column() * self._masked(torch.ones_like(w))

    # -- non-smooth (L1) part: optimizer-facing ------------------------------

    def l1_value(self, w: Tensor) -> Tensor:
        return self.l1_weight * self._masked(w).abs().sum()


@dataclasses.dataclass(frozen=True)
class SweptRegularization:
    """Per-lane regularization weights of a batched λ sweep.

    One lane a grid point: ``l1_weights[l]`` / ``l2_weights[l]`` split
    the lane's λ as ``RegularizationContext`` does (``split_weight``).  The shared ``reg_mask``
    (the intercept exemption) stays on the base context: lanes differ
    only in weight.  The weights are float32 CPU tensors; the swept
    solve moves them to its device."""

    l1_weights: Tensor  # [L]
    l2_weights: Tensor  # [L]

    @staticmethod
    def from_grid(regularization: "RegularizationType | str", weights,
                  elastic_net_alpha: float = 0.5) -> "SweptRegularization":
        """λ grid [L] → per-lane (l1, l2) splits (``split_weight``)."""
        lam = torch.from_numpy(np.asarray(weights, np.float32))
        l1, l2 = split_weight(regularization, lam, elastic_net_alpha)
        return SweptRegularization(l1_weights=l1, l2_weights=l2)

    @property
    def n_lanes(self) -> int:
        return self.l1_weights.shape[0]

    def has_l1(self) -> bool:
        """Whether any lane has an L1 weight: then every lane runs
        OWL-QN (a zero-λ lane with an all-zero L1 vector)."""
        return bool((self.l1_weights != 0.0).any())

    def l1_vectors(self, dim: int, reg_mask: Tensor | None) -> Tensor:
        """Per-lane [L, dim] OWL-QN weight vectors (mask applied), on
        the mask's device (the CPU without one)."""
        dev = reg_mask.device if reg_mask is not None else None
        vecs = self.l1_weights.to(dev)[:, None].expand(self.n_lanes, dim)
        return vecs if reg_mask is None else vecs * reg_mask


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
