"""Coefficients: means (+ optional variances) of a linear model.

Counterpart of ``photon_ml_tpu/models/coefficients.py``; the arrays are
torch tensors.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Coefficients:
    """means [.., dim] and optional variances [.., dim]."""

    means: torch.Tensor
    variances: torch.Tensor | None = None

    @staticmethod
    def zeros(dim: int, dtype=torch.float32, device=None) -> "Coefficients":
        return Coefficients(means=torch.zeros((dim,), dtype=dtype,
                                              device=device))

    @property
    def dim(self) -> int:
        return self.means.shape[-1]

    def norm(self) -> torch.Tensor:
        return torch.linalg.vector_norm(self.means, dim=-1)
