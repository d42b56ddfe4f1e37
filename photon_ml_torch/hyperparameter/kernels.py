"""Stationary GP kernels: RBF and Matérn-5/2.

Counterpart of ``photon_ml_tpu/hyperparameter/kernels.py``: functions
over [n, d] point sets in the rescaled [0, 1]^d search space, with the
hyperparameters (amplitude, isotropic lengthscale) as arguments.
"""

from __future__ import annotations

import dataclasses
import enum
import math

import torch

Tensor = torch.Tensor


class KernelType(str, enum.Enum):
    RBF = "RBF"
    MATERN52 = "MATERN52"


@dataclasses.dataclass(frozen=True)
class KernelParams:
    amplitude: float = 1.0       # signal variance σ_f²  (stored as σ_f)
    lengthscale: float = 0.25    # isotropic ℓ in the rescaled space
    noise: float = 1e-4          # observation noise σ_n² (stored as σ_n)


def _sq_dists(x1: Tensor, x2: Tensor, lengthscale) -> Tensor:
    """Pairwise squared distances of ℓ-scaled points: [n1, n2]."""
    a = x1 / lengthscale
    b = x2 / lengthscale
    aa = (a * a).sum(-1)[:, None]
    bb = (b * b).sum(-1)[None, :]
    return torch.clamp(aa + bb - 2.0 * (a @ b.T), min=0.0)


def rbf(x1: Tensor, x2: Tensor, amplitude, lengthscale) -> Tensor:
    r2 = _sq_dists(x1, x2, lengthscale)
    return amplitude**2 * torch.exp(-0.5 * r2)


def matern52(x1: Tensor, x2: Tensor, amplitude, lengthscale) -> Tensor:
    r2 = _sq_dists(x1, x2, lengthscale)
    r = torch.sqrt(r2 + 1e-12)
    s5r = math.sqrt(5.0) * r
    return amplitude**2 * (1.0 + s5r + 5.0 * r2 / 3.0) * torch.exp(-s5r)


def kernel_fn(kind: KernelType):
    return rbf if kind == KernelType.RBF else matern52
