"""Gaussian prior toward a previous model (incremental training).

Counterpart of ``photon_ml_tpu/ops/prior.py``: the objective adds

    0.5 · λ_prior · Σ_j (w_j − μ_j)² / σ_j²

with gradient λ_prior·(w − μ)/σ², HVP λ_prior·v/σ² and Hessian
diagonal λ_prior/σ².
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GaussianPrior:
    """Diagonal Gaussian prior N(means, diag(variances))."""

    means: Tensor        # [dim]
    precisions: Tensor   # [dim] = 1/σ²
    weight: float        # λ_prior

    @staticmethod
    def from_model(means: Tensor, variances: Tensor, weight: float = 1.0,
                   min_variance: float = 1e-12) -> "GaussianPrior":
        v = torch.as_tensor(variances, dtype=torch.float32).clamp(
            min=min_variance)
        return GaussianPrior(
            means=torch.as_tensor(means, dtype=torch.float32).to(v.device),
            precisions=1.0 / v, weight=float(weight))

    def value(self, w: Tensor) -> Tensor:
        d = w - self.means
        return 0.5 * self.weight * torch.dot(d, self.precisions * d)

    def gradient(self, w: Tensor) -> Tensor:
        return self.weight * self.precisions * (w - self.means)

    def hessian_vector(self, v: Tensor) -> Tensor:
        return self.weight * self.precisions * v

    def hessian_diagonal(self) -> Tensor:
        return self.weight * self.precisions
