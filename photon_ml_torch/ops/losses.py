"""Pointwise GLM loss functions on torch tensors.

Counterpart of ``photon_ml_tpu/ops/losses.py``: each loss is a stateless
namespace of elementwise functions of the margin ``z`` and label ``y``:

- ``loss(z, y)`` — per-example loss value
- ``d1(z, y)``   — ∂loss/∂z
- ``d2(z, y)``   — ∂²loss/∂z²
- ``mean(z)``    — the link from margin to prediction (sigmoid /
  identity / soft exp), used at scoring time.

Numerics follow the JAX package exactly: the logistic loss uses the
``log1p(exp(-|z|))`` form, and the Poisson mean is the softened
exponential ``_soft_exp`` (exp up to z = 30, a quadratic extension
beyond), not ``exp``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PointwiseLoss:
    """A GLM pointwise loss: value + first/second margin-derivatives + link."""

    name: str
    loss: Callable[[Tensor, Tensor], Tensor]
    d1: Callable[[Tensor, Tensor], Tensor]
    d2: Callable[[Tensor, Tensor], Tensor]
    mean: Callable[[Tensor], Tensor]

    def __hash__(self) -> int:
        return hash(self.name)

    def __eq__(self, other) -> bool:
        return isinstance(other, PointwiseLoss) and other.name == self.name


# Logistic: loss = log(1 + e^z) − y·z, labels y ∈ {0, 1}.

def _logistic_loss(z: Tensor, y: Tensor) -> Tensor:
    return torch.clamp(z, min=0.0) + torch.log1p(torch.exp(-z.abs())) - y * z


def _logistic_d1(z: Tensor, y: Tensor) -> Tensor:
    return torch.sigmoid(z) - y


def _logistic_d2(z: Tensor, y: Tensor) -> Tensor:
    s = torch.sigmoid(z)
    return s * (1.0 - s)


LOGISTIC = PointwiseLoss(
    name="logistic",
    loss=_logistic_loss,
    d1=_logistic_d1,
    d2=_logistic_d2,
    mean=torch.sigmoid,
)


# Squared (linear regression): loss = ½ (z − y)².

def _squared_loss(z: Tensor, y: Tensor) -> Tensor:
    d = z - y
    return 0.5 * d * d


def _identity(z: Tensor) -> Tensor:
    return z


SQUARED = PointwiseLoss(
    name="squared",
    loss=_squared_loss,
    d1=lambda z, y: z - y,
    d2=lambda z, y: torch.ones_like(z),
    mean=_identity,
)


# Poisson: loss = ẽ(z) − y·z with ẽ the softened exponential below.

_MAX_EXP_ARG = 30.0
_EXP_CAP = math.exp(_MAX_EXP_ARG)


def _soft_exp(z: Tensor) -> Tensor:
    """ẽ(z): exp for z ≤ M, e^M·(1 + t + t²/2), t = z − M, beyond."""
    t = z - _MAX_EXP_ARG
    return torch.where(z <= _MAX_EXP_ARG,
                       torch.exp(torch.clamp(z, max=_MAX_EXP_ARG)),
                       _EXP_CAP * (1.0 + t + 0.5 * t * t))


def _soft_exp_d1(z: Tensor) -> Tensor:
    t = z - _MAX_EXP_ARG
    return torch.where(z <= _MAX_EXP_ARG,
                       torch.exp(torch.clamp(z, max=_MAX_EXP_ARG)),
                       _EXP_CAP * (1.0 + t))


def _soft_exp_d2(z: Tensor) -> Tensor:
    return torch.where(z <= _MAX_EXP_ARG,
                       torch.exp(torch.clamp(z, max=_MAX_EXP_ARG)),
                       torch.full_like(z, _EXP_CAP))


POISSON = PointwiseLoss(
    name="poisson",
    loss=lambda z, y: _soft_exp(z) - y * z,
    d1=lambda z, y: _soft_exp_d1(z) - y,
    d2=lambda z, y: _soft_exp_d2(z),
    mean=_soft_exp,
)


# Smoothed hinge (linear SVM surrogate): s = 2y − 1, t = s·z;
# 0 for t ≥ 1, ½ − t for t ≤ 0, ½ (1 − t)² between.

def _hinge_t(z: Tensor, y: Tensor) -> Tensor:
    return (2.0 * y - 1.0) * z


def _smoothed_hinge_loss(z: Tensor, y: Tensor) -> Tensor:
    t = _hinge_t(z, y)
    return torch.where(
        t >= 1.0, torch.zeros_like(t),
        torch.where(t <= 0.0, 0.5 - t, 0.5 * (1.0 - t) * (1.0 - t)))


def _smoothed_hinge_d1(z: Tensor, y: Tensor) -> Tensor:
    s = 2.0 * y - 1.0
    t = s * z
    dt = torch.where(t >= 1.0, torch.zeros_like(t),
                     torch.where(t <= 0.0, -torch.ones_like(t), t - 1.0))
    return s * dt


def _smoothed_hinge_d2(z: Tensor, y: Tensor) -> Tensor:
    t = _hinge_t(z, y)
    return ((t > 0.0) & (t < 1.0)).to(z.dtype)


SMOOTHED_HINGE = PointwiseLoss(
    name="smoothed_hinge",
    loss=_smoothed_hinge_loss,
    d1=_smoothed_hinge_d1,
    d2=_smoothed_hinge_d2,
    mean=_identity,
)


_BY_NAME = {
    l.name: l for l in (LOGISTIC, SQUARED, POISSON, SMOOTHED_HINGE)
}
_BY_NAME.update({
    "logistic_regression": LOGISTIC,
    "linear_regression": SQUARED,
    "poisson_regression": POISSON,
    "smoothed_hinge_loss_linear_svm": SMOOTHED_HINGE,
})


def get_loss(name: str) -> PointwiseLoss:
    """Look up a loss by name or reference TaskType alias."""
    key = name.lower()
    if key not in _BY_NAME:
        raise ValueError(
            f"Unknown loss '{name}'. Available: {sorted(_BY_NAME)}")
    return _BY_NAME[key]
