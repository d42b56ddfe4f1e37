"""Feature normalization applied as algebra on the coefficients.

Counterpart of ``photon_ml_tpu/data/normalization.py``.  With
``x' = (x − shift) ⊙ factor`` the normalized margin is

    margin(x, f ⊙ w) − dot(s ⊙ f, w)

so the batch stays raw and sparse; the gradient gets the chain rule on
the way out.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

Tensor = torch.Tensor


class NormalizationType(str, enum.Enum):
    NONE = "NONE"
    SCALE_WITH_STANDARD_DEVIATION = "SCALE_WITH_STANDARD_DEVIATION"
    SCALE_WITH_MAX_MAGNITUDE = "SCALE_WITH_MAX_MAGNITUDE"
    STANDARDIZATION = "STANDARDIZATION"


@dataclasses.dataclass(frozen=True)
class NormalizationContext:
    """factors/shifts over the feature space; identity when both None."""

    factors: Tensor | None = None  # [dim] or None (≡ ones)
    shifts: Tensor | None = None   # [dim] or None (≡ zeros)

    @staticmethod
    def identity() -> "NormalizationContext":
        return NormalizationContext()

    @property
    def is_identity(self) -> bool:
        return self.factors is None and self.shifts is None

    def model_to_raw(self, w: Tensor) -> Tensor:
        """Normalized-space coefficients → the vector to dot raw x with."""
        return w if self.factors is None else w * self.factors

    def raw_to_model(self, w_raw: Tensor) -> Tensor:
        """Inverse of ``model_to_raw`` (warm-starting from a saved
        raw-space model; the intercept's margin-correction fold is
        undone by the caller, which knows the intercept index)."""
        return w_raw if self.factors is None else w_raw / self.factors

    def margin_correction(self, w: Tensor) -> Tensor:
        """Scalar subtracted from every margin: dot(shifts ⊙ factors, w)
        (one a lane for W [L, d])."""
        if self.shifts is None:
            return torch.zeros(w.shape[:-1], dtype=w.dtype, device=w.device)
        f = self.factors if self.factors is not None else torch.ones_like(w)
        if w.dim() == 1:
            return torch.dot(self.shifts * f, w)
        return (self.shifts * f * w).sum(-1)

    def grad_to_model(self, g_raw: Tensor, r_sum: Tensor) -> Tensor:
        """g_model = f ⊙ g_raw − (Σ_i r_i)·(f ⊙ s) (a lane's Σ_i r_i
        for G [L, d])."""
        if self.is_identity:
            return g_raw
        f = (self.factors if self.factors is not None
             else torch.ones_like(g_raw))
        g = g_raw * f
        if self.shifts is not None:
            g = g - r_sum[..., None] * (f * self.shifts)
        return g


def compute_normalization(stats_mean: Tensor, stats_std: Tensor,
                          stats_max_abs: Tensor,
                          norm_type: NormalizationType,
                          intercept_index: int | None = None
                          ) -> NormalizationContext:
    """A context from feature statistics: 1/σ (σ == 0 → 1), 1/max|x|, or
    1/σ plus a mean shift; the intercept is never scaled or shifted."""
    if norm_type == NormalizationType.NONE:
        return NormalizationContext.identity()

    def safe(a):
        return torch.where(a > 0.0, a, torch.ones_like(a))

    if norm_type == NormalizationType.SCALE_WITH_STANDARD_DEVIATION:
        factors, shifts = 1.0 / safe(stats_std), None
    elif norm_type == NormalizationType.SCALE_WITH_MAX_MAGNITUDE:
        factors, shifts = 1.0 / safe(stats_max_abs), None
    elif norm_type == NormalizationType.STANDARDIZATION:
        factors, shifts = 1.0 / safe(stats_std), stats_mean.clone()
    else:
        raise ValueError(f"Unknown normalization type {norm_type}")
    if intercept_index is not None:
        factors[intercept_index] = 1.0
        if shifts is not None:
            shifts[intercept_index] = 0.0
    return NormalizationContext(factors=factors, shifts=shifts)
