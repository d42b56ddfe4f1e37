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
